#!/usr/bin/env python3
"""Multi-host halo solve of the 4M-vertex north star (BASELINE.json:11) on
CUDA cards: the twin of scripts/pod_solve.py, in precond_tpu_torch.

One rank per card. Start it through scripts/torch_run_pod.sh on every host
(torchrun: --nnodes hosts, --nproc_per_node the host's cards), or on one
host with
    torchrun --standalone --nproc_per_node=<cards> scripts/torch_pod_solve.py --grid 2048
The process group comes from parallel/hosts.initialize_hosts:
  POD_AUTO=1 (default)  env:// (torchrun's MASTER_ADDR, WORLD_SIZE, RANK;
                        the card from LOCAL_RANK); no torchrun: one rank
  POD_AUTO=0            tcp://POD_COORDINATOR, POD_NPROC ranks in all,
                        this process rank POD_PID
NCCL on cards (--backend to choose another), gloo on the CPU (--device cpu).

Every rank builds the (deterministic) system, sorts it by Morton code of
the positions, prepares the preconditioner redundantly, builds the halo
tables and the fine/coarse split for the group, then runs the halo PCG
twice (a warm solve and a timed one, max_iters 400). Rank 0 prints one
JSON line with pod_solve.py's fields (grid, num_verts, ndev, processes,
iterations, rel_residual, solve_wall_s, iter_ms, nnz_per_s_G), then the
prepare wall, its collectives in the timed solve, every rank's peak device
memory and every rank's kernel launches (ops/cuda/_lib.launch_counts).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def nnz_per_iteration(ell, inv96) -> int:
    """Scalar nonzeros one PCG iteration touches, counted as bench.py and
    bench_torch.py count them: 9 per stored 3x3 block of H, plus the
    inverse table's stored floats (4704 per block packed, 96*96 dense).
    pod_solve.py counts the fine table as inv_fine.shape[0] * 96 * 96,
    which raises on the PackedInverse that the default config prepares at
    >= 4096 blocks; this count does not copy it."""
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse

    nnz_apply = inv96.nb * 4704 if isinstance(inv96, PackedInverse) else inv96.shape[0] * 96 * 96
    return int(9 * (ell.num_verts + int(ell.mask.sum())) + nnz_apply)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pod_solve(group, grid: int, tol: float = 1e-4, max_iters: int = 400, mesh_c=None,
              ell=None) -> dict:
    """pod_solve.py's body on this rank; returns its fields (every rank
    computes the same numbers but its own peak memory). A caller that holds
    the grid's mesh and assembled system on the group's device may pass
    them (`mesh_c`, `ell`)."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.parallel import halo
    from precond_tpu_torch.solver import compute_sort_maps, prepare_with_system

    dev, ndev = group.device, group.world
    cfg = SchwarzConfig()
    if mesh_c is None:
        mesh_c = cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001)
    n = mesh_c.num_verts
    if n % (ndev * 32):
        raise ValueError(f"{n} vertices do not split into {ndev} bank-aligned shards; "
                         "pad the grid")
    if ell is None:
        ell = cloth.assemble_system(mesh_c, device=dev)
    maps = compute_sort_maps(torch.as_tensor(mesh_c.positions, device=dev))
    _sync(dev)
    t0 = time.perf_counter()
    state, ell_sorted = prepare_with_system(ell, maps, cfg)
    _sync(dev)
    prepare_s = time.perf_counter() - t0
    nnz = nnz_per_iteration(ell, state.inv96)
    del ell
    hsys = halo.build_halo_system(ell_sorted, ndev)
    # num_shards pads and interleaves a packed fine table for this group
    sap = halo.split_apply_state(state, cfg, n, num_shards=ndev)
    del state, ell_sorted
    b_sorted = torch.as_tensor(
        np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32), device=dev)

    def solve():
        return halo.solve_sorted(group, cfg, hsys, sap, b_sorted, tol=tol, max_iters=max_iters)

    res = solve()   # warm: first calls, the kernels' build
    _sync(dev)
    group.barrier()
    group.stats.reset()
    t0 = time.perf_counter()
    res = solve()
    _sync(dev)
    wall = time.perf_counter() - t0
    comm = group.stats
    iters = int(res.iterations)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    peaks = group.all_gather_rows(torch.tensor([[peak]], dtype=torch.float64, device=dev))
    # each rank's kernel launches since the process started (prepare, both solves)
    names = sorted(_lib.launch_counts)
    mine = torch.tensor([[_lib.launch_counts[k] for k in names]], dtype=torch.float64, device=dev)
    launches = group.all_gather_rows(mine).cpu().tolist()
    return {
        "grid": grid,
        "num_verts": n,
        "ndev": ndev,
        # one process per card: torch.distributed ranks are processes
        "processes": ndev,
        "iterations": iters,
        "rel_residual": float(res.rel_residual),
        "solve_wall_s": round(wall, 3),
        "iter_ms": round(wall / max(iters, 1) * 1e3, 3),
        "nnz_per_s_G": round(nnz * iters / wall / 1e9, 2),
        "nnz_per_iter": nnz,
        "halo_mode": int(hsys.halo),
        "prepare_ms": round(prepare_s * 1e3, 3),
        "backend": group.backend,
        # rank 0's collectives in the timed solve: calls, the bytes it put in
        # (comm.CommStats) and host ms inside them
        "comm_calls": comm.calls,
        "comm_bytes_per_iter": comm.bytes // max(iters, 1),
        "comm_host_ms": round(comm.seconds * 1e3, 3),
        "peak_gb_per_rank": [round(float(p), 3) for p in peaks.reshape(-1).cpu()],
        "launches_per_rank": [{k: int(v) for k, v in zip(names, row)} for row in launches],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: NCCL on cards, gloo on the CPU)")
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the card; cpu runs the plain versions)")
    # a rank started by parallel/hosts.launch_local_ranks
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from precond_tpu_torch.parallel import hosts

    if args.init:
        where = (args.init, args.world, args.rank)
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // max(args.world, 1)))
    elif os.environ.get("POD_AUTO", "1") == "1":
        where = (None, None, None)     # env://, torchrun's variables
    else:
        where = (os.environ["POD_COORDINATOR"], int(os.environ["POD_NPROC"]),
                 int(os.environ["POD_PID"]))
    group = hosts.initialize_hosts(*where, backend=args.backend, device=args.device)
    try:
        out = pod_solve(group, args.grid, args.tol)
        if group.rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        hosts.shutdown_hosts()
    return 0


if __name__ == "__main__":
    sys.exit(main())
