#!/usr/bin/env python3
"""JAX package record for the folded self-colliding sheet on the grid path.

Builds the JAX bench's `collide` sheet exactly as scripts/
jax_collide_general_record.py does (bench.py:220-270: a grid x grid cloth,
z_wave 0, mass 1e-3, dt 1/60, the right half folded onto the left at a gap
of 0.5 h; VF/EE/EF detection at threshold 0.75 h, stiffness 1e3, a budget of
n // 4 per set and a cap of 2, every query in one chunk so the detection
runs op by op; the valid stencils kept and padded to a multiple of 8), then
solves it with the bench's default build,
BENCH_COLLIDE_M=static (bench.py:299-317, 389-414, 570-587): the analytic
tile order, assemble_system_grid / assemble_system_stencil at the folded
positions, prepare_grid with the stencils and the grid->tile map
(coarse_damping 0.25; comp-major, DenseInverseCM at 256), and PCG on [3,N]
carries with spmv_t plus the slot contact SpMV, to tol 1e-4, testing every
iteration (the bench tests every 8th). Block-Jacobi runs on the same
operator with the contact ELL's diagonal added (kc 32). The rhs is seed 0's
standard normal, as in the bench.

Prints the live stencil count and the Schwarz and Jacobi iteration counts,
then one JSON line. Runs the JAX package on the CPU; the PyTorch port never
imports it.

    JAX_PLATFORMS=cpu python3 scripts/jax_collide_grid_record.py [--grid 256]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jax_collide_general_record import folded_sheet  # noqa: E402
from precond_tpu.config import SchwarzConfig  # noqa: E402
from precond_tpu.models import cloth  # noqa: E402
from precond_tpu.models import collision as coll  # noqa: E402
from precond_tpu.ops import gridstencil  # noqa: E402
from precond_tpu.ops.contact import build_contact_ell, build_contact_slots, slot_contact_spmv_t  # noqa: E402
from precond_tpu.ops.gridapply import precondition_grid_cm  # noqa: E402
from precond_tpu.ops.pallas.packed_symv import DenseInverseCM  # noqa: E402
from precond_tpu.ops.stencils import build_stencils  # noqa: E402
from precond_tpu.parallel.pcg import pcg  # noqa: E402
from precond_tpu.solver import prepare_grid  # noqa: E402
from precond_tpu.utils import gridmorton as gm  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=256)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    mesh, positions, h = folded_sheet(args.grid)
    n = mesh.num_verts
    k = args.grid.bit_length() - 1
    thresh, stiff, budget, cap = 0.75 * h, 1e3, n // 4, 2
    pj = jnp.asarray(positions)
    fj, ej = jnp.asarray(mesh.faces), jnp.asarray(mesh.edges)
    # One chunk of queries: above `chunk` queries detect_*_grid compile their
    # body as a lax.map, and XLA rounds that compiled body differently from
    # the same ops called one by one. The fold's contacts tie exactly, so the
    # last bit decides which ones a budget keeps; op by op, the sets are the
    # ones the PyTorch port reproduces bit for bit.
    chunk = max(n, len(mesh.edges))
    vf, _ = coll.detect_vf_grid(pj, fj, thresh, stiff, budget, per_vertex_cap=cap, chunk=chunk)
    ee, _ = coll.detect_ee_grid(pj, ej, thresh, stiff, budget, per_edge_cap=cap, chunk=chunk)
    ef, _ = coll.detect_ef_grid(pj, ej, fj, thresh, stiff, budget, per_edge_cap=cap, chunk=chunk)
    stencils = build_stencils(ej, fj, ef=ef, ee=ee, vf=vf)
    keep = np.flatnonzero(np.asarray(stencils.valid))
    live = int(keep.size)
    pad8 = (-keep.size) % 8
    keep = np.concatenate([keep, np.zeros(pad8, np.int64)])
    stencils = type(stencils)(*(jnp.asarray(np.asarray(f)[keep]) for f in stencils))
    if pad8:
        stencils = stencils._replace(valid=stencils.valid.at[-pad8:].set(False))
    print(f"[record] grid {args.grid}: N={n} live stencils {live} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    cfg = SchwarzConfig(coarse_damping=0.25)
    s2o, o2s = gm.sort_maps(k)
    ell = cloth.assemble_system(mesh, positions=positions)
    ssys = cloth.assemble_system_stencil(mesh, positions=positions)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, positions=positions)
    inv = jax.jit(lambda a, b, s, o: prepare_grid(a, b, offsets, k, cfg, s, o))(
        dgr, drr, stencils, jnp.asarray(o2s))
    if not isinstance(inv, DenseInverseCM):
        raise SystemExit(f"expected DenseInverseCM, got {type(inv).__name__}")
    slots = jax.jit(build_contact_slots, static_argnums=1)(stencils, n)
    contact = jax.jit(lambda s: build_contact_ell(s, n, kc=32))(stencils)
    bt = jnp.asarray(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)).T

    def spmv(p):
        return gridstencil.spmv_t(ssys, p) + slot_contact_spmv_t(slots, p)

    @jax.jit
    def schwarz(inv, bt):
        return pcg(spmv, lambda r: gm.morton_to_grid_cm(
            precondition_grid_cm(inv, gm.grid_to_morton_cm(r, k), cfg), k),
            bt, tol=1e-4, max_iters=2000)

    @jax.jit
    def jacobi(dinv, bt):
        return pcg(spmv, lambda r: jnp.einsum("nij,jn->in", dinv, r), bt, tol=1e-4,
                   max_iters=20000)

    t1 = time.perf_counter()
    rs = schwarz(inv, bt)
    rj = jacobi(jnp.linalg.inv(ell.diag + contact.diag), bt)
    out = {"grid": args.grid, "n": n, "live_stencils": live,
           "schwarz_iters": int(rs.iterations), "schwarz_rel": float(rs.rel_residual),
           "jacobi_iters": int(rj.iterations), "jacobi_rel": float(rj.rel_residual),
           "contact_dropped": int(contact.dropped), "levels": cfg.num_levels(n)}
    print(f"[record] schwarz {out['schwarz_iters']} (rel {out['schwarz_rel']:.3e}), "
          f"jacobi {out['jacobi_iters']} (rel {out['jacobi_rel']:.3e}) "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
