"""Entry points of the PyTorch port (the twin of __graft_entry__.py).

entry(device=None)  -> (fn, example_args): prepare the multilevel Schwarz
                       preconditioner and PCG-solve one cloth implicit step
                       (parallel.sharded.solve_step) on one device; fn(*args)
                       is the call (there is no jit).
dryrun_multichip(n) -> run one solve step over n ranks at tiny shapes, as
                       n processes of this file joined by torch.distributed,
                       and return each rank's lines.

Both run on the card unless the caller passes device="cpu". Imports torch,
numpy and precond_tpu_torch only.

    python3 graft_entry_torch.py [n]     # entry() on the card, then dryrun_multichip(n)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# time limit of one dryrun's ranks (each imports torch and opens its device)
DRYRUN_TIMEOUT_S = 600


def _build_problem(nx, ny, seed=0, device=None):
    """A z-waved nx x ny cloth as (BlockEll, SortMaps, b) on `device` (the
    card unless the caller asks for the CPU); b is seed `seed`'s standard
    normal."""
    import torch

    from precond_tpu_torch.device import resolve_device
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.solver import compute_sort_maps

    dev = resolve_device(device)
    mesh = cloth.make_grid(nx, ny, z_wave=0.02)
    ell = cloth.assemble_system(mesh, device=dev)
    maps = compute_sort_maps(torch.as_tensor(mesh.positions, device=dev))
    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal((mesh.num_verts, 3)).astype(np.float32), device=dev)
    return ell, maps, b


def entry(device=None):
    """The single-device forward step on the flagship cloth model (32 x 32):
    returns (fn, (ell, maps, b)) with fn(*args) -> PcgResult."""
    from precond_tpu_torch.config import SchwarzConfig
    from precond_tpu_torch.device import resolve_device
    from precond_tpu_torch.parallel.sharded import solve_step

    dev = resolve_device(device)
    cfg = SchwarzConfig()
    ell, maps, b = _build_problem(32, 32, device=dev)

    def fn(ell, maps, b):
        return solve_step(ell, maps, b, cfg, tol=1e-4, max_iters=100, device=dev)

    return fn, (ell, maps, b)


def dryrun_multichip(n_devices: int, device=None, backend=None) -> list:
    """Run one solve step of each path over `n_devices` ranks and return
    each rank's lines, rank by rank.

    The ranks are processes of this file (parallel/hosts.launch_local_ranks,
    one launch for both steps). Each runs, at the JAX dryrun's shapes:
    sharded.sharded_solve_step on a 32 x 8 cloth (tol 1e-4, 50 iterations
    at most) and gridsharded.sharded_grid_solve_step on the 2^k cloth (k =
    DRYRUN_K, default 5; mass 1e-3, dt 1/60, tol 1e-4, 150 iterations at
    most), and prints one line per step in the JAX format
    ("dryrun_multichip(n): iters=... rel_residual=...", "... grid path:
    ..."), each followed by a line of the step's kernel launches. The
    port's sharded_solve_step is the halo path (parallel/halo.solve_sorted),
    so this dryrun runs the halo PCG, which the JAX dryrun never reaches.

    `device` None puts every rank on the card: gloo ranks (the default
    backend) share cuda:0; backend="nccl" runs one rank per visible card
    and refuses more ranks than cards. device="cpu" runs gloo ranks on the
    CPU. Raises RuntimeError when a rank fails or a residual is not finite.
    """
    import torch

    from precond_tpu_torch.device import resolve_device
    from precond_tpu_torch.parallel import hosts

    dev = resolve_device(device)
    backend = backend or "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs the card")
        if n_devices > torch.cuda.device_count():
            raise ValueError(f"nccl: {n_devices} ranks for {torch.cuda.device_count()} cards")
        rank_device = "cuda"
    else:
        rank_device = "cpu" if dev.type == "cpu" else "cuda:0"
    argv = [sys.executable, os.path.abspath(__file__), "--rank-worker", "--device", rank_device,
            "--backend", backend]
    with tempfile.TemporaryDirectory() as logs:
        outs = hosts.launch_local_ranks(argv, n_devices, DRYRUN_TIMEOUT_S, logs)
    lines = [ln for out in outs for ln in out.splitlines() if ln.startswith("dryrun_multichip(")]
    res = [ln for ln in lines if "rel_residual=" in ln]
    if len(res) != 2 * n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): {len(res)} result lines, "
                           f"expected {2 * n_devices}")
    for ln in res:
        if not math.isfinite(float(ln.rsplit("rel_residual=", 1)[1])):
            raise RuntimeError(f"dryrun_multichip({n_devices}): residual not finite: {ln}")
    return lines


def _rank_worker(argv) -> int:
    """One rank of dryrun_multichip: join the group, run both steps, print."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank-worker", action="store_true")
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from precond_tpu_torch.config import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.parallel import hosts
    from precond_tpu_torch.parallel.gridsharded import sharded_grid_solve_step
    from precond_tpu_torch.parallel.sharded import sharded_solve_step

    n = args.world
    group = hosts.initialize_hosts(args.init, n, args.rank, backend=args.backend,
                                   device=args.device)
    dev = group.device
    cfg = SchwarzConfig()

    def launches():
        return json.dumps({k: v for k, v in _lib.launch_counts.items() if v})

    try:
        ell, maps, b = _build_problem(32, 8, device=dev)
        _lib.reset_launch_counts()
        res = sharded_solve_step(group, cfg, tol=1e-4, max_iters=50, device=dev)(ell, maps, b)
        print(f"dryrun_multichip({n}): iters={int(res.iterations)} "
              f"rel_residual={float(res.rel_residual):.3e}")
        print(f"dryrun_multichip({n}) launches: {launches()}", flush=True)

        k = int(os.environ.get("DRYRUN_K", "5"))
        mesh_c = cloth.make_grid(1 << k, 1 << k, z_wave=0.02, mass=0.001, dt=1 / 60)
        ssys = cloth.assemble_system_stencil(mesh_c, device=dev)
        dgr, drr, full_off = cloth.assemble_system_grid(mesh_c, device=dev)
        bg = np.random.default_rng(0).standard_normal((mesh_c.num_verts, 3)).astype(np.float32)
        # sym=False (the default stencil system): the port's `offsets` are
        # the system's full +/- planes, the JAX dryrun's full_off
        _lib.reset_launch_counts()
        gres = sharded_grid_solve_step(group, cfg, full_off, k, tol=1e-4, max_iters=150,
                                       device=dev)(ssys, dgr, drr, bg)
        print(f"dryrun_multichip({n}) grid path: iters={int(gres.iterations)} "
              f"rel_residual={float(gres.rel_residual):.3e}")
        print(f"dryrun_multichip({n}) grid path launches: {launches()}", flush=True)
    finally:
        hosts.shutdown_hosts()
    return 0


def main(argv) -> int:
    if "--rank-worker" in argv:
        return _rank_worker(argv)
    fn, args = entry()
    out = fn(*args)
    print("entry: iters", int(out.iterations), "rel", float(out.rel_residual))
    # 2 ranks by default, not the JAX file's 8: the card's machine has one
    # card, and every gloo rank opens its own CUDA context on it
    for line in dryrun_multichip(int(argv[0]) if argv else 2):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
