#!/usr/bin/env python3
"""Composed-crossing A/B: the twin of scripts/probe_crossing_fix.py, in
precond_tpu_torch. Streaming against patch-Morton crossings inside the
production-shaped PCG loop, all bit-identical permutations of the same
vectors:

  stream      grid_to_morton / morton_to_grid (the row-major solve's pair)
  patch       grid_to_morton_patch / morton_to_grid_patch (the patch
              factorization's index, the one the comp-major crossings use)
  comp-major  [3,N] carries: spmv_t, the comp-major crossings and
              precondition_grid_cm

Each line is ms per iteration of K iterations with no host sync inside (the
least of 3 calls after a warm one) and its device busy share
(torch_dissect_common.measure). The row-major loop applies the row-major
inverse (solve_layout="rows": K2's row-major entry from 4,096 blocks up,
K3 below), the comp-major loop the comp-major one (the "auto" layout:
K2's comp-major entry, or K3 through dense_symv_cm). The JAX script
prepares with the default "auto" layout, which from 32^2 up returns a
comp-major inverse, and then hands it to pack_sym96_cm, which wants an
array (its line 116 faults); asking for each layout where it is used is
what probe_crossing_fix.py:107-116 meant.

The JAX script's "+bar" variants wrap each crossing in XLA's
optimization_barrier to pin its scheduling inside the compiled loop.
Eager PyTorch runs every op where it is written, so it has no counterpart,
and the twin says so on one line instead of timing a copy of `stream`.

Every row-major variant's x must equal the first one's bit for bit, and
the comp-major loop's first entry must match it to 1e-6 relative (the
script's check, probe_crossing_fix.py:156-168).

Env: BENCH_GRID (default 1024), PROF_K (default 50), BENCH_SYMV.

    python3 scripts/torch_probe_crossing_fix.py [--device cpu]
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_dissect_common as dc  # noqa: E402

#: the comp-major loop's first entry against the row-major one's (relative)
CM_RTOL = 1e-6
BARRIER_NOTE = ("stream+bar / patch+bar: XLA's optimization_barrier pins a compiled "
                "loop's scheduling; eager PyTorch has no counterpart (not timed)")


def setup(grid: int, dev: torch.device, symv: str = "auto") -> SimpleNamespace:
    """The JAX script's inputs on `dev`: the stencil system, the row-major
    and the comp-major inverses from prepare_grid and the [N,3] rhs
    (default_rng(0))."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.solver import prepare_grid

    k = grid.bit_length() - 1
    cfg = SchwarzConfig(symv_kernel=symv)
    cfg_rows = SchwarzConfig(symv_kernel=symv, solve_layout="rows")
    mesh = cloth.make_grid(grid, grid, **dc.MESH_KW)
    n = mesh.num_verts
    ssys = cloth.assemble_system_stencil(mesh, device=dev)
    dgr, drr, goffsets = cloth.assemble_system_grid(mesh, device=dev)
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32), device=dev)
    return SimpleNamespace(grid=grid, k=k, n=n, cfg=cfg, ssys=ssys, dev=dev, b=b,
                           inv=prepare_grid(dgr, drr, goffsets, k, cfg_rows),
                           inv_cm=prepare_grid(dgr, drr, goffsets, k, cfg))


def make_pre(g2m, m2g):
    def pre(s, r):
        from precond_tpu_torch.ops.gridapply import precondition_grid

        return m2g(precondition_grid(s.inv, g2m(r, s.k), s.cfg), s.k)

    return pre


def _variants():
    from precond_tpu_torch.utils import gridmorton as gm

    return {"stream": make_pre(gm.grid_to_morton, gm.morton_to_grid),
            "patch": make_pre(gm.grid_to_morton_patch, gm.morton_to_grid_patch)}


def k_iterations(s, pre_op, k: int) -> torch.Tensor:
    """K iterations of the script's row-major loop; returns x [N,3]."""
    from precond_tpu_torch.ops import gridstencil

    b = s.b
    z0 = pre_op(s, b)
    x, r, p, rz = torch.zeros_like(b), b, z0, torch.sum(b * z0)
    for _ in range(k):
        q = gridstencil.spmv(s.ssys, p)
        alpha = rz / torch.sum(p * q)
        x = x + alpha * p
        r = r - alpha * q
        z = pre_op(s, r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def k_iterations_cm(s, k: int) -> torch.Tensor:
    """K iterations of the script's comp-major loop; returns x^T [3,N]."""
    from precond_tpu_torch.ops import gridstencil
    from precond_tpu_torch.ops.gridapply import precondition_grid_cm
    from precond_tpu_torch.utils import gridmorton as gm

    def pre(r):
        return gm.morton_to_grid_cm(precondition_grid_cm(s.inv_cm, gm.grid_to_morton_cm(r, s.k),
                                                         s.cfg), s.k)

    bt = s.b.T.contiguous()
    z0 = pre(bt)
    x, r, p, rz = torch.zeros_like(bt), bt, z0, torch.sum(bt * z0)
    for _ in range(k):
        q = gridstencil.spmv_t(s.ssys, p)
        alpha = rz / torch.sum(p * q)
        x = x + alpha * p
        r = r - alpha * q
        z = pre(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def run(s, k: int, log=dc.log) -> dict:
    """Times every variant; returns {name: Timing with "ms" per iteration
    and "same": its agreement with the first variant}."""
    out, ref = {}, None
    for name, pre_op in _variants().items():
        t = out[name] = dc.measure(lambda: k_iterations(s, pre_op, k), s.dev)
        if ref is None:
            ref = t["out"]
        t["same"] = torch.equal(t["out"], ref)
        t["ms"] = t["best_s"] / k * 1e3
        tag = "" if t["same"] else (f"  VALUE DRIFT {float(t['out'][0, 0])} vs {float(ref[0, 0])}")
        log(f"{name:12s} {t['ms']:8.3f} ms/iter{tag}{t.note()}")
    log(BARRIER_NOTE)
    t = out["comp-major"] = dc.measure(lambda: k_iterations_cm(s, k), s.dev)
    v, r0 = float(t["out"][0, 0]), float(ref[0, 0])
    t["same"] = abs(v - r0) < CM_RTOL * max(abs(r0), 1e-9)
    t["ms"] = t["best_s"] / k * 1e3
    tag = "" if t["same"] else f"  value {v} vs {r0}"
    log(f"{'comp-major':12s} {t['ms']:8.3f} ms/iter{tag}{t.note()}")
    return out


def main(argv=None) -> int:
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse

    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    k = dc.env_int("PROF_K", 50)
    s = setup(dc.env_int("BENCH_GRID", 1024), dev, os.environ.get("BENCH_SYMV", "auto"))
    dc.header(f"grid={s.grid} n={s.n} K={k} packed={isinstance(s.inv, PackedInverse)}", dev)
    run(s, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
