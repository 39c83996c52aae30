"""Two gloo ranks sharing one card (cuda:0) against the same two ranks on
the CPU, at 32x32: the sharded general step (K1 and K3 per rank), the
sharded grid step (K4 and K3 per rank) and the collective checkpoint round
trips with their payloads staged through host memory. Needs a CUDA card;
skips without one. Runs without JAX:

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA card" -m gpu \\
        tests/test_torch_gpu_sharded.py
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORKER = os.path.join(ROOT, "scripts", "torch_multiprocess_worker.py")
CASES = ("sharded_32", "grid_sym0")
TIMEOUT = 300

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(path):
    """The two cases' inputs from the port itself (no JAX on the card's
    machine): the general 32x32 cloth and the 32x32 grid cloth."""
    from precond_tpu_torch.io import sharded as shio
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.solver import compute_sort_maps

    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_multiprocess_worker", WORKER)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    rng = np.random.default_rng(0)
    mesh = cloth.make_grid(32, 32, z_wave=0.02, mass=0.01)
    ell = cloth.assemble_system(mesh, device="cpu")
    maps = compute_sort_maps(torch.as_tensor(mesh.positions))
    np.savez(os.path.join(path, "sharded_32_w2.npz"), **{k: v.numpy() for k, v in zip(
        ("diag", "idx", "blocks", "mask"), ell)}, s2o=maps.sorted_to_orig.numpy(),
        o2s=maps.orig_to_sorted.numpy(), b=rng.standard_normal((1024, 3)).astype(np.float32),
        max_iters=100, symv_kernel="auto")
    mesh = cloth.make_grid(32, 32, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    ssys = cloth.assemble_system_stencil(mesh, device="cpu")
    dg, dr, full = cloth.assemble_system_grid(mesh, device="cpu")
    np.savez(os.path.join(path, "grid_sym0_w2.npz"), diag_t=ssys.diag_t.numpy(),
             dirs_t=ssys.dirs_t.numpy(), offsets=np.asarray(ssys.offsets), diag_rows=dg.numpy(),
             dirs_rows=dr.numpy(), full_offsets=np.asarray(full),
             b=rng.standard_normal((1024, 3)).astype(np.float32), k=5, sym=False, tol=1e-5,
             max_iters=300, symv_kernel="auto")
    # the one-rank save the card's ranks load: prepared on the card, as they prepare
    shio.save_solver_sharded(os.path.join(path, "ckpt_w1"), worker.dcp_solver("cuda"),
                             x=torch.as_tensor(worker.dcp_x(1.0)))


def _run(device, inputs, out, cases):
    from precond_tpu_torch.parallel import hosts

    hosts.launch_local_ranks([sys.executable, WORKER, "--inputs", inputs, "--out", out,
                              "--device", device, "--cases", ",".join(cases)], 2, TIMEOUT,
                             os.path.join(out, "logs"))
    return {case: [np.load(os.path.join(out, f"{case}_w2_r{r}.npz")) for r in range(2)]
            for case in cases}


@pytest.fixture(scope="module")
def runs(card, tmp_path_factory):
    inputs = str(tmp_path_factory.mktemp("inputs"))
    _inputs(inputs)
    out = str(tmp_path_factory.mktemp("out"))
    return (_run("cpu", inputs, os.path.join(out, "cpu"), CASES),
            _run("cuda", inputs, os.path.join(out, "cuda"), CASES + ("dcp",)))


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_on_the_card_match_the_cpu(runs, case):
    cpu, gpu = runs
    scale = max(np.abs(r["x"]).max() for r in cpu[case])
    for rc, rg in zip(cpu[case], gpu[case]):
        assert abs(int(rc["iterations"]) - int(rg["iterations"])) <= 3
        assert float(rg["rel_residual"]) <= (1e-5 if case.startswith("grid") else 1e-4)
        np.testing.assert_allclose(rg["x"], rc["x"], rtol=5e-3, atol=5e-4 * scale)


def test_checkpoints_on_the_card(runs):
    _, gpu = runs
    for flags in gpu["dcp"]:
        assert bool(flags["dcp_from_one"]) and bool(flags["dcp_roundtrip"])
