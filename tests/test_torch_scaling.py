"""The port's twins of the north-star scripts against the JAX ones, on the CPU
at 64^2 (and 128^2 for the comm model):

  * scripts/torch_scaling_model.py: every mode and byte column of
    scripts/scaling_model.measure, integer for integer;
  * scripts/torch_scaling_capacity.py --grid 64 --path both --max-iters 12:
    scripts/scaling_capacity.py --grid 64 (run as a subprocess: it forces 8
    virtual devices) gives the same iteration counts, and rel_residual within
    1e-4 relative (the paths round differently only in the order of their
    sums), at world 1 and on 2 gloo ranks;
  * scripts/torch_pod_solve.py at world 1 and on 2 gloo ranks, through
    scripts/torch_run_pod.sh: pod_solve.py's fields, the 1-rank halo solve's
    iterations, and the JAX halo solve of the same Morton-sorted system
    within the multi-rank tests' band (3 iterations).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from precond_tpu.config import SchwarzConfig as JCfg
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import blockcsr as jblockcsr
from precond_tpu.parallel import halo as jhalo
from precond_tpu.solver import compute_sort_maps as jsort_maps
from precond_tpu.solver import prepare_preconditioner as jprepare

from precond_tpu_torch import SchwarzConfig
from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse
from precond_tpu_torch.parallel import hosts
from precond_tpu_torch.parallel.comm import Group

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
RANK_TIMEOUT = 240
REL_RTOL = 1e-4
POD_FIELDS = ("grid", "num_verts", "ndev", "processes", "iterations", "rel_residual",
              "solve_wall_s", "iter_ms", "nnz_per_s_G")

torch.set_num_threads(2)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# ---- the comm-volume model ------------------------------------------------

@pytest.mark.parametrize("grid", [64, 128])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_scaling_model_rows_match_jax(grid, shards):
    ref = _script("scaling_model").measure(grid, shards, JCfg())
    got = _script("torch_scaling_model").measure(grid, shards, SchwarzConfig())
    for key in ("grid", "num_verts", "shards", "mode", "spmv_exchange_bytes",
                "coarse_psum_bytes", "coarse_psum_bytes_worst", "local_hbm_bytes_per_shard",
                "packed_inverse"):
        assert got[key] == ref[key], key
    # no overlap credited: the faster link gives the higher efficiency
    assert 0 < got["eff_ib"] < got["eff_nvlink"] < 1


def test_scaling_model_names_its_data_sheet_rates():
    mod = _script("torch_scaling_model")
    assert (mod.HBM_GBPS, mod.NVLINK_GBPS, mod.IB_GBPS) == (3350.0, 450.0, 50.0)
    assert mod.GRIDS == ((1024, (8, 16)), (2048, (8, 16, 32)))


# ---- the capacity run -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_capacity():
    """scripts/scaling_capacity.py --grid 64 --path both: its stage lines."""
    out = subprocess.run([sys.executable, os.path.join(SCRIPTS, "scaling_capacity.py"),
                          "--grid", "64", "--path", "both"], capture_output=True, text=True,
                         env=_env(), timeout=RANK_TIMEOUT, check=True)
    return {d["stage"]: d for d in _json_lines(out.stdout)}


@pytest.fixture(scope="module")
def port_capacity():
    """The port's run at world 1 (this process) and on 2 gloo ranks."""
    mod = _script("torch_scaling_capacity")
    args = mod.parse(["--grid", "64", "--path", "both", "--device", "cpu"])
    runs = {1: mod.run(Group.single("cpu"), args)}
    out = subprocess.run([sys.executable, os.path.join(SCRIPTS, "torch_scaling_capacity.py"),
                          "--grid", "64", "--path", "both", "--device", "cpu", "--world", "2",
                          "--backend", "gloo", "--timeout", str(RANK_TIMEOUT)],
                         capture_output=True, text=True, env=_env(), timeout=RANK_TIMEOUT,
                         check=True)
    runs[2] = _json_lines(out.stdout)
    return runs


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("stage", ["gspmd_done", "halo_done"])
def test_capacity_run_matches_jax(jax_capacity, port_capacity, world, stage):
    ref = jax_capacity[stage]
    lines = [d for d in port_capacity[world] if d["stage"] == stage]
    assert sorted(d["rank"] for d in lines) == list(range(world))
    for d in lines:
        assert d["num_verts"] == ref["num_verts"] == 4096 and d["ndev"] == world
        assert d["iterations"] == ref["iterations"] == 12
        assert d["finite"] and ref["finite"]
        assert abs(d["rel_residual"] - ref["rel_residual"]) <= REL_RTOL * ref["rel_residual"]
        assert d["peak_gb"] == 0.0 and d["rss_gb"] > 0
    # every rank reports the group's residual
    assert len({d["rel_residual"] for d in lines}) == 1


def test_capacity_stages_are_the_jax_scripts(jax_capacity, port_capacity):
    stages = [d["stage"] for d in port_capacity[1]]
    assert stages == ["mesh", "assembled", "gspmd_done", "prepared", "halo_done"]
    assert set(stages) == set(jax_capacity)
    # 133 blocks at 64^2: the fine table stays dense under "auto", as JAX's "dense"
    assert not port_capacity[1][-1]["packed_apply"]


# ---- the pod solve --------------------------------------------------------

@pytest.fixture(scope="module")
def pod_runs():
    """torch_run_pod.sh on one rank (POD_AUTO=0) and on 2 torchrun ranks
    (POD_AUTO=1), and pod_solve at world 1 in this process."""
    sh = os.path.join(SCRIPTS, "torch_run_pod.sh")
    env = dict(_env(), POD_GRID="64")
    def run(**extra):
        return subprocess.run([sh, "--device", "cpu"], capture_output=True, text=True,
                              timeout=RANK_TIMEOUT, check=True, env=dict(env, **extra))

    one = run(POD_AUTO="0", POD_COORDINATOR=f"127.0.0.1:{hosts.free_port()}", POD_NPROC="1",
              POD_PID="0")
    two = run(POD_AUTO="1", POD_NPROC_PER_NODE="2")
    here = _script("torch_pod_solve").pod_solve(Group.single("cpu"), 64)
    return {"sh1": _json_lines(one.stdout), "sh2": _json_lines(two.stdout), "here": here}


@pytest.mark.parametrize("run,world", [("sh1", 1), ("sh2", 2)])
def test_pod_solve_prints_pod_solve_fields(pod_runs, run, world):
    lines = pod_runs[run]
    assert len(lines) == 1, "rank 0 alone prints"
    out = lines[0]
    for key in POD_FIELDS:
        assert key in out, key
    assert out["grid"] == 64 and out["num_verts"] == 4096
    assert out["ndev"] == out["processes"] == world
    assert out["backend"] == (None if world == 1 else "gloo")
    assert len(out["peak_gb_per_rank"]) == world
    assert out["rel_residual"] <= 1e-4 and out["nnz_per_s_G"] > 0
    # the iterations of the 1-rank halo solve, within the multi-rank band
    assert abs(out["iterations"] - pod_runs["here"]["iterations"]) <= 3


def test_pod_solve_matches_the_jax_halo_solve(pod_runs):
    """pod_solve.py's solve on the same system: Morton sort of the
    positions, prepare, the halo PCG over 8 JAX devices (its nnz line is
    bench.py's count here, since 64^2 prepares a dense table)."""
    mesh = jcloth.make_grid(64, 64, z_wave=0.02, mass=0.001)
    n = mesh.num_verts
    cfg = JCfg()
    ell = jcloth.assemble_system(mesh)
    maps = jsort_maps(jnp.asarray(mesh.positions))
    state = jprepare(ell, maps, cfg)
    ell_sorted = jblockcsr.permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    b = jnp.asarray(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32))
    dmesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    ref = jhalo.solve_sorted(dmesh, cfg, jhalo.build_halo_system(ell_sorted, 8),
                             jhalo.split_apply_state(state, cfg, n, num_shards=8), b,
                             tol=1e-4, max_iters=400)
    here = pod_runs["here"]
    assert abs(here["iterations"] - int(ref.iterations)) <= 3
    assert here["rel_residual"] <= 1e-4
    nnz = 9 * (n + int(np.asarray(ell.mask).sum())) + state.inv96.shape[0] * 96 * 96
    assert here["nnz_per_iter"] == nnz


def test_pod_nnz_counts_a_packed_table_as_bench_does():
    """pod_solve.py's `inv_fine.shape[0] * 96 * 96` raises on a packed
    table; the twin counts 4704 floats per block, as bench.py does."""
    mod = _script("torch_pod_solve")

    class Ell:
        num_verts = 64
        mask = torch.ones((64, 6), dtype=torch.bool)

    packed = PackedInverse(f=torch.zeros((48, 96, 8)), dg=torch.zeros((96, 8)), nb=5)
    assert mod.nnz_per_iteration(Ell, packed) == 9 * (64 + 384) + 5 * 4704
    assert mod.nnz_per_iteration(Ell, torch.zeros((5, 96, 96))) == 9 * (64 + 384) + 5 * 9216


def test_initialize_hosts_reads_torchrun_variables(monkeypatch):
    """Under torchrun (env://) WORLD_SIZE and RANK name the group."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(hosts.free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    group = hosts.initialize_hosts(backend="gloo", device="cpu")
    try:
        assert (group.rank, group.world, group.backend) == (0, 1, "gloo")
        assert torch.equal(group.all_reduce_sum(torch.ones(3)), torch.ones(3))
    finally:
        hosts.shutdown_hosts()
    assert hosts.initialize_hosts(device="cpu").backend is None   # one rank: no group


def test_chip_smoke_north_star_gates():
    """chip_smoke.py holds the 2048 bench rows to nnz and convergence only
    (no JAX run converged at 2048^2) and the capped halo run to BASELINE.md's
    record; its nnz records are the JAX host structure's, counted as
    bench.py counts them (checked here at 64 with the same formula)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.bench_bands("cloth", 2048) is None
    assert chip_smoke.JAX_RECORD_NORTH_STAR_HALO == (8, 0.2318)
    row = {"config": "cloth", "grid": 2048, "value": 400.0, "schwarz_rel": 5e-5,
           "jacobi_rel": 9e-5, "schwarz_iters": 104, "jacobi_iters": 544,
           "nnz_spmv": 490364964, "nnz_apply": 657666240}
    assert chip_smoke.bench_row_faults(row) == []
    assert len(chip_smoke.bench_row_faults({**row, "nnz_spmv": 1, "schwarz_rel": 2e-4})) == 2
    assert chip_smoke.JAX_RECORD_BENCH_NNZ[("general", 2048)] == (490364964, 657666240)
    mesh = jcloth.make_grid(64, 64, z_wave=0.02, mass=0.001)
    _, mask, _ = jcloth.ell_structure_from_springs(mesh.num_verts, mesh.springs)
    ell = jcloth.assemble_system(mesh)
    assert int(mask.sum()) == int(np.asarray(ell.mask).sum())
    assert JCfg().num_blocks(2048 * 2048) * 4704 == 657666240
