#!/usr/bin/env python3
"""Composed-iteration dissection for the COMP-MAJOR solve path: the twin of
scripts/profile_iteration_cm.py, in precond_tpu_torch.

Same stub-in-the-loop method as torch_profile_iteration.py (standalone
stage timings don't attribute composed cost): every variant runs K
iterations of the same PCG skeleton with one stage replaced by a
near-noop, all on [3,N] carries.

  full            spmv_t + cm crossings + cm apply + dots
  no-apply        pre = identity
  crossings-only  pre = g2m_cm . m2g_cm (no apply work)
  symv-only       pre = crossings + packed/dense symv on the fine level
  no-spmv         q = p * 1.000001
  dots-only       both stubbed (loop floor)

The SpMV is gridstencil.spmv_t (the stencil kernel, K4); the apply is
gridapply.precondition_grid_cm: the packed symv kernel (K2) above
packed_symv_min_blocks (1024^2), the dense one (K3) below. The K
iterations run eagerly with no host sync inside (rz stays a device
scalar); each line adds the chain's device busy share
(torch_dissect_common).

Env: BENCH_GRID (default 1024), PROF_K (default 50), BENCH_SYMV.

    python3 scripts/torch_profile_iteration_cm.py [--device cpu]
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
    """The JAX script's inputs on `dev`: the stencil system, the comp-major
    inverse from prepare_grid and the [3,N] rhs (default_rng(0))."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.cuda.packed_symv import DenseInverseCM, PackedInverseCM
    from precond_tpu_torch.solver import prepare_grid

    k = grid.bit_length() - 1
    cfg = SchwarzConfig(symv_kernel=symv)
    mesh = cloth.make_grid(grid, grid, **dc.MESH_KW)
    n = mesh.num_verts
    ssys = cloth.assemble_system_stencil(mesh, device=dev)
    dgr, drr, goffsets = cloth.assemble_system_grid(mesh, device=dev)
    inv = prepare_grid(dgr, drr, goffsets, k, cfg)
    if not isinstance(inv, (PackedInverseCM, DenseInverseCM)):
        raise TypeError(f"prepare_grid gave {type(inv).__name__}, not a comp-major inverse "
                        "(the comp-major path needs a grid of at least 32x32)")
    rng = np.random.default_rng(0)
    bt = torch.as_tensor(rng.standard_normal((3, n)).astype(np.float32), device=dev)
    return SimpleNamespace(grid=grid, k=k, n=n, cfg=cfg, ssys=ssys, inv=inv, bt=bt, dev=dev)


def pre_full(s, r):
    from precond_tpu_torch.ops.gridapply import precondition_grid_cm
    from precond_tpu_torch.utils import gridmorton as gm

    rs = gm.grid_to_morton_cm(r, s.k)
    return gm.morton_to_grid_cm(precondition_grid_cm(s.inv, rs, s.cfg), s.k)


def pre_crossings(s, r):
    from precond_tpu_torch.utils import gridmorton as gm

    return gm.morton_to_grid_cm(gm.grid_to_morton_cm(r, s.k), s.k) * 1.000001


def pre_symv_only(s, r):
    # fine-level-only symv on the crossed vector (op-mix attribution)
    from precond_tpu_torch.ops.cuda.packed_symv import (
        DenseInverseCM, dense_symv_cm, packed_symv_cm,
    )
    from precond_tpu_torch.ops.hierarchy import BANK
    from precond_tpu_torch.utils import gridmorton as gm

    rs = gm.grid_to_morton_cm(r, s.k).reshape(3, s.n // BANK, BANK)
    if isinstance(s.inv, DenseInverseCM):
        z = dense_symv_cm(DenseInverseCM(m=s.inv.m[: rs.shape[1]]), rs)
    else:
        # packed_symv_cm pads the rhs to the table's Bp and cuts it back
        z = packed_symv_cm(s.inv, rs)
    return gm.morton_to_grid_cm(z.reshape(3, s.n), s.k)


VARIANTS = {
    "full": (True, pre_full),
    "no-apply": (True, None),
    "crossings-only": (True, pre_crossings),
    "symv-only": (True, pre_symv_only),
    "no-spmv": (False, pre_full),
    "dots-only": (False, None),
}


def k_iterations(s, use_spmv: bool, pre_op, k: int) -> torch.Tensor:
    """K iterations of the script's PCG skeleton from x = 0; returns x [3,N]."""
    from precond_tpu_torch.ops import gridstencil

    b = s.bt
    z0 = pre_op(s, b) if pre_op is not None else b
    x, r, p, rz = torch.zeros_like(b), b, z0, torch.sum(b * z0)
    for _ in range(k):
        q = gridstencil.spmv_t(s.ssys, p) if use_spmv else p * 1.000001
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
    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    k = dc.env_int("PROF_K", 50)
    s = setup(dc.env_int("BENCH_GRID", 1024), dev, os.environ.get("BENCH_SYMV", "auto"))
    dc.header(f"grid={s.grid} n={s.n} K={k} inv={type(s.inv).__name__}", dev)
    run_variants(s, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
