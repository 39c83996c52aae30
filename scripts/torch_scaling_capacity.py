#!/usr/bin/env python3
"""4M-vertex capacity and correctness run of the port's multi-rank solves.

The twin of scripts/scaling_capacity.py, in precond_tpu_torch: the
BASELINE.json:11 problem (a 2048^2 cloth, 4,194,304 vertices) through the
two multi-rank programs at full size —

  * gspmd: parallel/gridsharded.sharded_grid_solve_step on
    assemble_system_stencil / assemble_system_grid (dense inverses, the
    row-major grid apply, the stencil SpMV kernel on each rank's slab);
  * halo: solver.prepare_with_system on the analytic tile order
    (gridmorton.sort_maps), halo.build_halo_system,
    split_apply_state(num_shards=world) and halo.solve_sorted (the packed
    fine table through the packed symv kernel when the config packs it);

with the JAX script's mesh (make_grid(g, g, z_wave=0.02, mass=0.001)), rhs
(default_rng(0) standard normal, f32) and cap, so a capped run compares
number for number. --tol 1e-4 --max-iters 2000 solves to convergence.

One JSON line per stage and rank (mesh, assembled, gspmd_done, prepared,
halo_done) with the host's peak RSS (rss_gb), the device's peak allocation
(peak_gb, torch.cuda.max_memory_allocated; 0 on the CPU) and the wall
since the start; halo_done adds the rank's kernel launches since it
started (ops/cuda/_lib.launch_counts). Runs on the card unless --device cpu. --world W > 1
starts W ranks of this script on this host (parallel/hosts.
launch_local_ranks) and prints their lines; the backend is NCCL on cards
unless --backend says otherwise (several ranks on one card need gloo).

    python3 scripts/torch_scaling_capacity.py [--grid 2048] [--path gspmd|halo|both]
        [--max-iters 12] [--tol 1e-4] [--symv auto|dense|packed]
        [--world 1] [--backend nccl|gloo] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def peak_gb(dev: torch.device) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rhs(n: int) -> np.ndarray:
    """The JAX script's right-hand side: default_rng(0) standard normal, f32."""
    return np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)


def mesh_of(grid: int):
    from precond_tpu_torch.models import cloth

    return cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001)


def _finite(group, x: torch.Tensor) -> bool:
    """True when every rank's rows of x are finite."""
    bad = (~torch.isfinite(x)).sum().to(torch.float32)
    return float(group.all_reduce_sum(bad)) == 0.0


def gspmd_solve(group, mesh_c, cfg, tol: float, max_iters: int, stage) -> dict:
    """sharded_grid_solve_step on the whole system; returns gspmd_done."""
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.parallel.gridsharded import sharded_grid_solve_step

    dev, n = group.device, mesh_c.num_verts
    k = mesh_c.grid[0].bit_length() - 1
    ssys = cloth.assemble_system_stencil(mesh_c, device=dev)
    dgr, drr, _ = cloth.assemble_system_grid(mesh_c, device=dev)
    b = torch.as_tensor(rhs(n), device=dev)
    stage("assembled")
    step = sharded_grid_solve_step(group, cfg, ssys.offsets, k, tol=tol, max_iters=max_iters,
                                   device=dev)
    sync(dev)
    t0 = time.perf_counter()
    res = step(ssys, dgr, drr, b)
    sync(dev)
    wall = time.perf_counter() - t0
    return stage("gspmd_done", num_verts=n, ndev=group.world, iterations=int(res.iterations),
                 rel_residual=float(res.rel_residual), finite=_finite(group, res.x),
                 step_ms=round(wall * 1e3, 3))


def halo_prepare(group, mesh_c, cfg, ell=None) -> dict:
    """The halo path's prepared state on the group's device: the sorted
    system's halo tables, the fine/coarse split for world shards and the
    sorted rhs, with the prepare's wall (ms, ending in a device sync). A
    caller that holds the assembled system may pass it (`ell`)."""
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse
    from precond_tpu_torch.parallel import halo
    from precond_tpu_torch.solver import SortMaps, prepare_with_system
    from precond_tpu_torch.utils import gridmorton as gm

    dev, n = group.device, mesh_c.num_verts
    k = mesh_c.grid[0].bit_length() - 1
    if ell is None:
        ell = cloth.assemble_system(mesh_c, device=dev)
    maps = SortMaps(*(torch.as_tensor(m, device=dev) for m in gm.sort_maps(k)))
    sync(dev)
    t0 = time.perf_counter()
    state, ell_sorted = prepare_with_system(ell, maps, cfg)
    sync(dev)
    prepare_ms = (time.perf_counter() - t0) * 1e3
    del ell
    hsys = halo.build_halo_system(ell_sorted, group.world)
    sap = halo.split_apply_state(state, cfg, n, num_shards=group.world)
    packed = isinstance(state.inv96, PackedInverse)
    del state, ell_sorted
    return dict(n=n, hsys=hsys, sap=sap, b=torch.as_tensor(rhs(n), device=dev),
                prepare_ms=prepare_ms, packed=packed)


def halo_solve(group, cfg, prep: dict, tol: float, max_iters: int) -> dict:
    """halo.solve_sorted on a prepared state; the halo_done fields."""
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse
    from precond_tpu_torch.parallel import halo

    dev = group.device
    sync(dev)
    t0 = time.perf_counter()
    res = halo.solve_sorted(group, cfg, prep["hsys"], prep["sap"], prep["b"], tol=tol,
                            max_iters=max_iters)
    sync(dev)
    wall = time.perf_counter() - t0
    iters = int(res.iterations)
    return dict(num_verts=prep["n"], ndev=group.world, halo_mode=int(prep["hsys"].halo),
                iterations=iters, rel_residual=float(res.rel_residual),
                finite=_finite(group, res.x),
                packed_apply=isinstance(prep["sap"].inv_fine, PackedInverse),
                solve_ms=round(wall * 1e3, 3), iter_ms=round(wall * 1e3 / max(iters, 1), 4))


def run(group, args) -> list:
    """The stages of one rank; prints each as a JSON line, returns them."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.ops.cuda import _lib

    dev = group.device
    cfg = SchwarzConfig(symv_kernel=args.symv)
    t0 = time.perf_counter()
    lines = []

    def stage(name, **fields):
        out = {"stage": name, **fields, "rank": group.rank, "rss_gb": round(rss_gb(), 1),
               "peak_gb": round(peak_gb(dev), 3), "t_s": round(time.perf_counter() - t0, 1)}
        print(json.dumps(out), flush=True)
        lines.append(out)
        return out

    mesh_c = mesh_of(args.grid)
    stage("mesh", num_verts=mesh_c.num_verts)
    if args.path in ("gspmd", "both"):
        gspmd_solve(group, mesh_c, cfg, args.tol, args.max_iters, stage)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.path in ("halo", "both"):
        prep = halo_prepare(group, mesh_c, cfg)
        stage("prepared", packed=prep["packed"], prepare_ms=round(prep["prepare_ms"], 3))
        stage("halo_done", **halo_solve(group, cfg, prep, args.tol, args.max_iters),
              launches=dict(_lib.launch_counts))
    return lines


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--path", default="gspmd", choices=["gspmd", "halo", "both"])
    ap.add_argument("--max-iters", type=int, default=12)
    ap.add_argument("--tol", type=float, default=1e-4)
    # "auto" packs the fine table at >= 4096 blocks: the halo apply then runs
    # the packed symv kernel (the JAX script pins dense, since interpret-mode
    # Pallas is too slow on a CPU); the gspmd step pins dense either way
    ap.add_argument("--symv", default="auto", choices=["dense", "auto", "packed"])
    ap.add_argument("--world", type=int, default=1, help="ranks on this host")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: NCCL on cards, gloo on the CPU; "
                         "no process group at one rank)")
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the card; cpu runs the plain versions)")
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds the ranks of --world > 1 may take")
    # one rank of a --world > 1 run (the script starts these itself)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from precond_tpu_torch.device import resolve_device
    from precond_tpu_torch.parallel import hosts

    dev = resolve_device(args.device)
    if args.world > 1 and args.rank is None:
        import tempfile

        argv_ = [sys.executable, os.path.abspath(__file__), "--grid", str(args.grid),
                 "--path", args.path, "--max-iters", str(args.max_iters), "--tol", str(args.tol),
                 "--symv", args.symv, "--device", str(dev)]
        if args.backend:
            argv_ += ["--backend", args.backend]
        with tempfile.TemporaryDirectory() as tmp:
            logs = hosts.launch_local_ranks(argv_, args.world, args.timeout, tmp)
        for text in logs:
            for line in text.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
        return 0
    if args.world > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // args.world))
    group = hosts.initialize_hosts(args.init, args.world, args.rank, backend=args.backend,
                                   device=dev)
    try:
        run(group, args)
    finally:
        hosts.shutdown_hosts()
    return 0


if __name__ == "__main__":
    sys.exit(main())
