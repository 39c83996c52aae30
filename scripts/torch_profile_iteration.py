#!/usr/bin/env python3
"""Composed-iteration dissection: the twin of scripts/profile_iteration.py,
in precond_tpu_torch. Times the bench PCG loop with stages selectively
stubbed, all INSIDE the loop (standalone stage timings sum to ~55% of the
composed iteration, so attribution must happen in composition).

Variants (all K iterations of the same loop skeleton, row-major [N,3]):
  full            SpMV + crossings + apply + dots   (the bench iteration)
  no-apply        pre_op = identity                  -> apply cost = full - this
  symv-only       pre_op = crossings + symv, no transfers
  no-cross        pre_op = transfers + symv in Morton order (no grid<->Morton)
  transfers-only  pre_op = crossings + restrict + prolong, no symv
  no-spmv         q = p                               -> SpMV cost
  dots-only       q = p, pre_op = identity            -> loop/dot floor

The SpMV is gridstencil.spmv (the stencil kernel, K4, behind the
transposes); the apply is gridapply.precondition_grid on the row-major
inverse: the dense symv kernel (K3) at 256^2 (2,185 blocks), the packed
one (K2) from packed_symv_min_blocks up. The JAX script predates the
comp-major default: from 32^2 up its prepare_grid returns a comp-major
table, which precondition_grid refuses. The twin asks for the row-major
layout the script was written for (solve_layout="rows"); below 32^2 the
two are the same. The K iterations run eagerly with no host sync inside;
each line adds the chain's device busy share (torch_dissect_common).

Env: BENCH_GRID (default 256), PROF_K (default 50), BENCH_SYMV.

    python3 scripts/torch_profile_iteration.py [--device cpu]
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_dissect_common as dc  # noqa: E402


def setup(grid: int, dev: torch.device, symv: str = "auto") -> SimpleNamespace:
    """The JAX script's inputs on `dev`: the stencil system, the row-major
    inverse from prepare_grid and the [N,3] rhs (default_rng(0))."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.hierarchy import BANK
    from precond_tpu_torch.solver import prepare_grid

    k = grid.bit_length() - 1
    cfg = SchwarzConfig(symv_kernel=symv, solve_layout="rows")
    mesh = cloth.make_grid(grid, grid, **dc.MESH_KW)
    n = mesh.num_verts
    ssys = cloth.assemble_system_stencil(mesh, device=dev)
    dgr, drr, goffsets = cloth.assemble_system_grid(mesh, device=dev)
    inv96 = prepare_grid(dgr, drr, goffsets, k, cfg)
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32), device=dev)
    return SimpleNamespace(grid=grid, k=k, n=n, cfg=cfg, ssys=ssys, inv=inv96, b=b, dev=dev,
                           btot=cfg.total_capacity(n) // BANK)


def pre_full(s, r):
    from precond_tpu_torch.ops.gridapply import precondition_grid
    from precond_tpu_torch.utils import gridmorton as gm

    rs = gm.grid_to_morton(r, s.k)
    return gm.morton_to_grid(precondition_grid(s.inv, rs, s.cfg), s.k)


def _symv(inv, rhs):
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse, packed_symv
    from precond_tpu_torch.ops.cuda.symv import batched_symv

    if isinstance(inv, PackedInverse):
        return packed_symv(inv, rhs)
    return batched_symv(inv, rhs)


def pre_symv_only(s, r):
    # NOTE: applies ALL Btot blocks (incl. coarse) to the fine vector
    # reshaped - op mix attribution only, numerically meaningless
    from precond_tpu_torch.ops.hierarchy import BANK
    from precond_tpu_torch.utils import gridmorton as gm

    rs = gm.grid_to_morton(r, s.k)
    pad = rs.new_zeros((s.btot * BANK - s.n, 3))
    z = _symv(s.inv, torch.cat([rs, pad]).reshape(-1, 3 * BANK)).reshape(-1, 3)
    return gm.morton_to_grid(z[: s.n], s.k)


def pre_no_cross(s, r):
    # r is grid-ordered; treat it as Morton-ordered (numerically different,
    # identical op mix minus the crossings)
    from precond_tpu_torch.ops.gridapply import precondition_grid

    return precondition_grid(s.inv, r, s.cfg)


def pre_transfers_only(s, r):
    from precond_tpu_torch.ops.gridapply import prolong_and_collect_grid, restrict_residual_grid
    from precond_tpu_torch.utils import gridmorton as gm

    rs = gm.grid_to_morton(r, s.k)
    mr = restrict_residual_grid(rs, s.cfg, s.n)
    z = prolong_and_collect_grid(mr[: s.cfg.total_capacity(s.n)], s.cfg, s.n)
    return gm.morton_to_grid(z, s.k)


VARIANTS = {
    "full": (True, pre_full),
    "no-apply": (True, None),
    "symv-only": (True, pre_symv_only),
    "no-cross": (True, pre_no_cross),
    "transfers-only": (True, pre_transfers_only),
    "no-spmv": (False, pre_full),
    "dots-only": (False, None),
}


def k_iterations(s, use_spmv: bool, pre_op, k: int) -> torch.Tensor:
    """K iterations of the script's PCG skeleton from x = 0; returns x [N,3]."""
    from precond_tpu_torch.ops import gridstencil

    b = s.b
    z0 = pre_op(s, b) if pre_op is not None else b
    x, r, p, rz = torch.zeros_like(b), b, z0, torch.sum(b * z0)
    for _ in range(k):
        q = gridstencil.spmv(s.ssys, p) if use_spmv else p * 1.000001
        alpha = rz / torch.sum(p * q)
        x = x + alpha * p
        r = r - alpha * q
        z = pre_op(s, r) if pre_op is not None else r * 1.000001
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def run_variants(s, k: int, log=dc.log) -> dict:
    """Times every variant (ms per iteration, min of 3 after a warm call)
    and prints the script's line for each; returns {name: Timing}."""
    out, base = {}, None
    for name, (use_spmv, pre_op) in VARIANTS.items():
        t = dc.measure(lambda: k_iterations(s, use_spmv, pre_op, k), s.dev)
        ms = t["ms"] = t["best_s"] / k * 1e3
        if name == "full":
            base = ms
        log(f"{name:16s} {ms:8.3f} ms/iter"
            + (f"   (delta vs full {base - ms:+.3f})" if base and name != "full" else "")
            + t.note())
        out[name] = t
    return out


def main(argv=None) -> int:
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse

    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    k = dc.env_int("PROF_K", 50)
    s = setup(dc.env_int("BENCH_GRID", 256), dev, os.environ.get("BENCH_SYMV", "auto"))
    dc.header(f"grid={s.grid} n={s.n} K={k} blocks={s.btot} "
              f"packed={isinstance(s.inv, PackedInverse)}", dev)
    run_variants(s, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
