#!/usr/bin/env python3
"""JAX package record for bf16 inverse storage (inverse_dtype="bfloat16").

Runs the JAX package's solves that chip_smoke.py's bf16 phases run on the
card, with the same settings (the JAX bench's cloth meshes, z_wave 0.02,
mass 1e-3, dt 1/60; rhs from seed 0's standard normal; tol 1e-4; every
iteration tested; max_iters 2000), and records for each the Schwarz
iteration count and whether tol was reached:

  * general <grid>: the arbitrary-mesh contract (allocate -> prepare ->
    PCG with the block-ELL SpMV), isotropic and per_axis Morton sorts,
    each in f32 and bf16 (bf16 takes the dense table: packed is f32 only);
  * cloth <grid>: the static grid path (prepare_grid -> comp-major PCG with
    spmv_t; a bf16 DenseInverseCM), f32 and bf16. The grid path has no
    Morton sort, so the normalization does not apply;
  * general 24 per_axis with tests/test_precond_oracle.py:107-129's rhs
    (seed 6) and cap (1000), f32 and bf16: the JAX test's case, which
    converges in bf16.

BASELINE.md records a CG stall at cond ~1e7 with bf16 inverses, so a bf16
solve may end at the cap without reaching tol; that outcome is the record.
Prints one JSON line per solve. Runs the JAX package on the CPU; the PyTorch
port never imports it.

    JAX_PLATFORMS=cpu python3 scripts/jax_bf16_record.py [--general 256] [--cloth 256 512] [--no-oracle]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from precond_tpu.config import SchwarzConfig  # noqa: E402
from precond_tpu.models import cloth  # noqa: E402
from precond_tpu.ops import blockcsr, gridstencil  # noqa: E402
from precond_tpu.ops.gridapply import precondition_grid_cm  # noqa: E402
from precond_tpu.parallel.pcg import pcg  # noqa: E402
from precond_tpu.solver import SchwarzPreconditioner, prepare_grid  # noqa: E402
from precond_tpu.utils import gridmorton as gm  # noqa: E402

TOL, MAX_ITERS = 1e-4, 2000


def _mesh(grid: int):
    return cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)


def _rhs(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)


def _emit(path: str, grid: int, cfg: SchwarzConfig, res, t0: float) -> None:
    rel = float(res.rel_residual)
    out = {"path": path, "grid": grid, "inverse_dtype": cfg.inverse_dtype,
           "morton_normalization": cfg.morton_normalization if path == "general" else None,
           "iterations": int(res.iterations), "rel_residual": rel,
           "converged": bool(rel <= TOL), "seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out), flush=True)


def general(grid: int, dtype: str, norm: str, seed: int = 0, max_iters: int = MAX_ITERS) -> None:
    t0 = time.perf_counter()
    mesh = _mesh(grid)
    ell = cloth.assemble_system(mesh)
    cfg = SchwarzConfig(inverse_dtype=dtype, morton_normalization=norm)
    pre = SchwarzPreconditioner(cfg)
    pre.allocate(mesh.positions)
    pre.prepare(ell)
    res = pcg(lambda x: blockcsr.spmv(ell, x), pre.apply,
              jax.numpy.asarray(_rhs(mesh.num_verts, seed)), tol=TOL, max_iters=max_iters)
    _emit("general", grid, cfg, res, t0)


def grid_path(grid: int, dtype: str) -> None:
    t0 = time.perf_counter()
    k = grid.bit_length() - 1
    mesh = _mesh(grid)
    ssys = cloth.assemble_system_stencil(mesh)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh)
    cfg = SchwarzConfig(inverse_dtype=dtype)
    inv = jax.jit(lambda a, b: prepare_grid(a, b, offsets, k, cfg))(dgr, drr)

    @jax.jit
    def solve(inv, bt):
        return pcg(lambda p: gridstencil.spmv_t(ssys, p),
                   lambda r: gm.morton_to_grid_cm(
                       precondition_grid_cm(inv, gm.grid_to_morton_cm(r, k), cfg), k),
                   bt, tol=TOL, max_iters=MAX_ITERS)

    res = solve(inv, jax.numpy.asarray(_rhs(mesh.num_verts).T))
    _emit("cloth", grid, cfg, res, t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--general", type=int, nargs="*", default=[256])
    # 1024 (the bench's size) needs ~15 GB and ~25 minutes on a CPU; the JAX
    # grid path stalls at 256 and 512 alike
    ap.add_argument("--cloth", type=int, nargs="*", default=[256, 512])
    ap.add_argument("--no-oracle", action="store_true", help="skip the 24x24 test case")
    args = ap.parse_args(argv)
    if not args.no_oracle:
        for dtype in ("float32", "bfloat16"):
            general(24, dtype, "per_axis", seed=6, max_iters=1000)
    for grid in args.general:
        for norm in ("isotropic", "per_axis"):
            for dtype in ("float32", "bfloat16"):
                general(grid, dtype, norm)
    for grid in args.cloth:
        for dtype in ("float32", "bfloat16"):
            grid_path(grid, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
