#!/usr/bin/env python3
"""JAX package record for the folded self-colliding sheet on the general M.

Builds the JAX bench's `collide` sheet (bench.py:220-270: a grid x grid
cloth, z_wave 0, mass 1e-3, dt 1/60, the right half folded onto the left at
a gap of 0.5 h; VF/EE/EF detection at threshold 0.75 h, stiffness 1e3, a
budget of n // 4 per set and a cap of 2, every query in one chunk so the
detection runs op by op; the valid stencils kept and padded to a multiple
of 8), then solves it the way ClothSim's general branch does
(precond_tpu/models/simulator.py:530, 622-645): the position Morton sort,
prepare_with_system with the stencils (contact pairs in the clustering,
collision terms in the assembly), and PCG in sorted space on the block-ELL
SpMV plus the rank-1 stencil contact SpMV, to tol 1e-4, checking every
iteration. Block-Jacobi runs on the same operator with the contact diagonal
added. The rhs is seed 0's standard normal, as in the bench.

Prints the live VF/EE/EF/stencil counts and the Schwarz and Jacobi
iteration counts, then one JSON line. Runs the JAX package on the CPU; the
PyTorch port never imports it.

    JAX_PLATFORMS=cpu python3 scripts/jax_collide_general_record.py [--grid 256]
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
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from precond_tpu.config import SchwarzConfig  # noqa: E402
from precond_tpu.models import cloth  # noqa: E402
from precond_tpu.models import collision as coll  # noqa: E402
from precond_tpu.ops import blockcsr  # noqa: E402
from precond_tpu.ops.apply import precondition_sorted  # noqa: E402
from precond_tpu.ops.contact import contact_diag, stencil_contact_spmv  # noqa: E402
from precond_tpu.ops.stencils import build_stencils  # noqa: E402
from precond_tpu.parallel.pcg import jacobi_preconditioner, pcg  # noqa: E402
from precond_tpu.solver import compute_sort_maps, prepare_with_system  # noqa: E402


def folded_sheet(grid: int):
    """The bench's folded sheet: (mesh, positions, h)."""
    mesh = cloth.make_grid(grid, grid, z_wave=0.0, mass=1e-3, dt=1.0 / 60.0)
    h = 1.0 / max(grid - 1, 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0]).astype(np.float32)
    return mesh, p.astype(np.float32), h


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=256)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    mesh, positions, h = folded_sheet(args.grid)
    n = mesh.num_verts
    thresh, stiff, budget, cap = 0.75 * h, 1e3, n // 4, 2
    pj = jnp.asarray(positions)
    fj, ej = jnp.asarray(mesh.faces), jnp.asarray(mesh.edges)
    # One chunk of queries: above `chunk` queries detect_*_grid compile their
    # body as a lax.map, and XLA rounds that compiled body differently from
    # the same ops called one by one. The fold's contacts tie exactly, so the
    # last bit decides which ones a budget keeps; op by op, the sets are the
    # ones the PyTorch port reproduces bit for bit.
    chunk = max(n, len(mesh.edges))
    vf, i1 = coll.detect_vf_grid(pj, fj, thresh, stiff, budget, per_vertex_cap=cap, chunk=chunk)
    ee, i2 = coll.detect_ee_grid(pj, ej, thresh, stiff, budget, per_edge_cap=cap, chunk=chunk)
    ef, i3 = coll.detect_ef_grid(pj, ej, fj, thresh, stiff, budget, per_edge_cap=cap, chunk=chunk)
    live = {"vf": int((np.asarray(vf.v_id) >= 0).sum()),
            "ee": int((np.asarray(ee.e_id0) >= 0).sum()),
            "ef": int((np.asarray(ef.e_id) >= 0).sum())}
    stencils = build_stencils(ej, fj, ef=ef, ee=ee, vf=vf)
    keep = np.flatnonzero(np.asarray(stencils.valid))
    live["stencils"] = int(keep.size)
    pad8 = (-keep.size) % 8
    keep = np.concatenate([keep, np.zeros(pad8, np.int64)])
    stencils = type(stencils)(*(jnp.asarray(np.asarray(f)[keep]) for f in stencils))
    if pad8:
        stencils = stencils._replace(valid=stencils.valid.at[-pad8:].set(False))
    info = {"truncated": bool(i1.truncated | i2.truncated | i3.truncated),
            "dropped": int(i1.dropped + i2.dropped + i3.dropped)}
    print(f"[record] grid {args.grid}: N={n} live {live} detection {info} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    cfg = SchwarzConfig(coarse_damping=0.25)
    ell = cloth.assemble_system(mesh, positions=positions)
    maps = compute_sort_maps(pj)
    state, ells = prepare_with_system(ell, maps, cfg, stencils)
    mapped = stencils._replace(
        idx=jnp.take(maps.orig_to_sorted, jnp.clip(stencils.idx, 0, n - 1)))
    b = jnp.asarray(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32))
    b_sorted = jnp.take(b, maps.sorted_to_orig, axis=0)

    @jax.jit
    def schwarz(state, ells, mapped, bs):
        return pcg(lambda p: blockcsr.spmv(ells, p) + stencil_contact_spmv(mapped, p),
                   lambda r: precondition_sorted(state, r, cfg), bs, tol=1e-4, max_iters=2000)

    @jax.jit
    def jacobi(ells, mapped, bs):
        dg = ells.diag + contact_diag(mapped, n)
        return pcg(lambda p: blockcsr.spmv(ells, p) + stencil_contact_spmv(mapped, p),
                   jacobi_preconditioner(dg), bs, tol=1e-4, max_iters=20000)

    t1 = time.perf_counter()
    rs = schwarz(state, ells, mapped, b_sorted)
    rj = jacobi(ells, mapped, b_sorted)
    out = {"grid": args.grid, "n": n, "live": live, **info,
           "schwarz_iters": int(rs.iterations), "schwarz_rel": float(rs.rel_residual),
           "jacobi_iters": int(rj.iterations), "jacobi_rel": float(rj.rel_residual),
           "levels": cfg.num_levels(n), "overflow": bool(state.overflow)}
    print(f"[record] schwarz {out['schwarz_iters']} (rel {out['schwarz_rel']:.3e}), "
          f"jacobi {out['jacobi_iters']} (rel {out['jacobi_rel']:.3e}) "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
