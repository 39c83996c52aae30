#!/usr/bin/env python3
"""JAX package records for the contact-regime probes (scripts/probe_*.py).

The port's twins (scripts/torch_probe_*.py) are held to these counts. Every
number is an iteration count of PCG to 1e-4 (check_every=8) on the folded
sheet of scripts/jax_collide_general_record.py, computed with the JAX
package's functions in the JAX scripts' own way (each solve a jax.jit of a
closure over the system, as the scripts write it):

  --scans G: for each --stiff, the folded sheet detected at stiffness 1.0
      and scaled per row (probe_stiff.py:51-64), then
      * probe_stiff.py's static grid M, general M on the position sort
        and block-Jacobi (`static`, `general`, `jacobi`);
      * probe_damping.py's damped static apply at theta 1, 0.5, 0.25,
        0.125 (`damped`, its own precondition_grid_damped);
      * probe_isosort.py's general M on compute_sort_maps(pos, "per_axis")
        and on its iso_maps (`per_axis`, `iso`). The JAX script's line 85
        calls compute_sort_maps(pj), which has defaulted to "isotropic"
        since that became the package default, so its "axis" column equals
        its "iso" column; "per_axis" is what that line meant.
  --contact G: probe_contact.py's section 3 at stiffness 1e3 detected
      directly (`static`, `general`: the static grid M and the general M on
      the tile maps, solve_layout="rows", max_iters 2000). The JAX script
      faults before it, at line 143 (it reads ContactSlots.w, which is
      w5).

Detection runs every query in one chunk, op by op (at 128 and below the
scripts' own default chunk does so too; at 256 a compiled lax.map body
would round differently, ROADMAP Queue C item 7). Prints one JSON line per
part. Runs the JAX package on the CPU; the PyTorch port never imports it.

    JAX_PLATFORMS=cpu python3 scripts/jax_probe_record.py --scans 128 --stiff 1e3 1e4
    JAX_PLATFORMS=cpu python3 scripts/jax_probe_record.py --contact 256
"""

from __future__ import annotations

import argparse
import dataclasses
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
from precond_tpu.ops.apply import precondition_sorted  # noqa: E402
from precond_tpu.ops.contact import build_contact_slots, contact_diag, slot_contact_spmv  # noqa: E402
from precond_tpu.ops.gridapply import precondition_grid  # noqa: E402
from precond_tpu.ops.stencils import build_stencils  # noqa: E402
from precond_tpu.parallel.pcg import pcg  # noqa: E402
from precond_tpu.solver import SortMaps, compute_sort_maps, prepare_grid, prepare_with_system  # noqa: E402
from precond_tpu.utils import gridmorton as gm  # noqa: E402
from probe_damping import precondition_grid_damped  # noqa: E402
from probe_isosort import iso_maps  # noqa: E402

THETAS = (1.0, 0.5, 0.25, 0.125)


def sheet(grid: int, stiffness: float):
    """The scripts' folded sheet, stencils detected at `stiffness` (kept,
    padded to 8), its systems, the tile maps and the seed-0 rhs."""
    mesh, positions, h = folded_sheet(grid)
    n = mesh.num_verts
    pj = jnp.asarray(positions)
    fj, ej = jnp.asarray(mesh.faces), jnp.asarray(mesh.edges)
    kw = dict(chunk=max(n, len(mesh.edges)))
    thresh, budget, cap = 0.75 * h, n // 4, 2
    vf, _ = coll.detect_vf_grid(pj, fj, thresh, stiffness, budget, per_vertex_cap=cap, **kw)
    ee, _ = coll.detect_ee_grid(pj, ej, thresh, stiffness, budget, per_edge_cap=cap, **kw)
    ef, _ = coll.detect_ef_grid(pj, ej, fj, thresh, stiffness, budget, per_edge_cap=cap, **kw)
    st = build_stencils(ej, fj, ef=ef, ee=ee, vf=vf)
    keep = np.flatnonzero(np.asarray(st.valid))
    live = int(keep.size)
    pad8 = (-keep.size) % 8
    keep = np.concatenate([keep, np.zeros(pad8, np.int64)])
    st = type(st)(*(jnp.asarray(np.asarray(f)[keep]) for f in st))
    if pad8:
        st = st._replace(valid=st.valid.at[-pad8:].set(False))
    k = grid.bit_length() - 1
    s2o, o2s = gm.sort_maps(k)
    return dict(mesh=mesh, positions=positions, pj=pj, n=n, k=k, st=st, live=live,
                ssys=cloth.assemble_system_stencil(mesh, positions=positions),
                ell=cloth.assemble_system(mesh, positions=positions),
                grid_sys=cloth.assemble_system_grid(mesh, positions=positions),
                maps=SortMaps(jnp.asarray(s2o), jnp.asarray(o2s)),
                b=jnp.asarray(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)))


def _iters(spmv, pre, b, max_iters: int = 20000) -> int:
    res = jax.jit(lambda bb: pcg(spmv, pre, bb, tol=1e-4, max_iters=max_iters,
                                 check_every=8))(b)
    return int(res.iterations)


def _general_pre(ell, maps, cfg, st):
    gs, _ = jax.jit(lambda e, m, s: prepare_with_system(e, m, cfg, s))(ell, maps, st)

    def pre(r):
        zs = precondition_sorted(gs, jnp.take(r, gs.sorted_to_orig, axis=0), cfg)
        return jnp.take(zs, gs.orig_to_sorted, axis=0)

    return pre


def scans(grid: int, stiffs) -> dict:
    s = sheet(grid, 1.0)
    n, k, ssys, ell, b = s["n"], s["k"], s["ssys"], s["ell"], s["b"]
    dgr, drr, goffsets = s["grid_sys"]
    o2s = s["maps"].orig_to_sorted
    cfg = dataclasses.replace(SchwarzConfig(), solve_layout="rows")          # probe_stiff
    cfg_d = dataclasses.replace(cfg, symv_kernel="dense")                   # damping, isosort
    pmaps = compute_sort_maps(s["pj"])
    axis_maps = compute_sort_maps(s["pj"], "per_axis")
    iso = iso_maps(s["pj"])
    out = {"grid": grid, "n": n, "live_stencils": s["live"], "stiff": {}}
    for stiff in stiffs:
        t0 = time.perf_counter()
        st = s["st"]._replace(stiff=s["st"].stiff * stiff)
        cs = jax.jit(build_contact_slots, static_argnums=1)(st, n)

        def spmv(v, st=st, cs=cs):
            return gridstencil.spmv(ssys, v) + slot_contact_spmv(st, cs, v)

        row = {}
        for name, c in (("static", cfg), ("damped", cfg_d)):
            inv = jax.jit(lambda dg, dr, st_, o, c=c: prepare_grid(dg, dr, goffsets, k, c, st_, o)
                          )(dgr, drr, st, o2s)
            if name == "static":
                row["static"] = _iters(spmv, lambda r: gm.morton_to_grid(
                    precondition_grid(inv, gm.grid_to_morton(r, k), cfg), k), b)
            else:
                row["damped"] = [_iters(spmv, lambda r, th=th: gm.morton_to_grid(
                    precondition_grid_damped(inv, gm.grid_to_morton(r, k), cfg_d, th), k), b)
                    for th in THETAS]
        row["general"] = _iters(spmv, _general_pre(ell, pmaps, cfg, st), b)
        row["per_axis"] = _iters(spmv, _general_pre(ell, axis_maps, cfg_d, st), b)
        row["iso"] = _iters(spmv, _general_pre(ell, iso, cfg_d, st), b)
        dinv = jnp.linalg.inv(ell.diag + contact_diag(st, n))
        row["jacobi"] = _iters(spmv, lambda r: jnp.einsum("nij,nj->ni", dinv, r), b)
        out["stiff"][f"{stiff:g}"] = row
        print(f"[record] scans {grid} stiff {stiff:g}: {row} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return out


def contact(grid: int) -> dict:
    s = sheet(grid, 1e3)
    n, k, ssys, ell, b, st = s["n"], s["k"], s["ssys"], s["ell"], s["b"], s["st"]
    dgr, drr, goffsets = s["grid_sys"]
    cfg = dataclasses.replace(SchwarzConfig(), solve_layout="rows")
    cs = jax.jit(build_contact_slots, static_argnums=1)(st, n)

    def spmv(v):
        return gridstencil.spmv(ssys, v) + slot_contact_spmv(st, cs, v)

    inv = jax.jit(lambda dg, dr, st_, o: prepare_grid(dg, dr, goffsets, k, cfg, st_, o))(
        dgr, drr, st, s["maps"].orig_to_sorted)
    static = _iters(spmv, lambda r: gm.morton_to_grid(
        precondition_grid(inv, gm.grid_to_morton(r, k), cfg), k), b, 2000)
    general = _iters(spmv, _general_pre(ell, s["maps"], cfg, st), b, 2000)
    return {"grid": grid, "n": n, "live_stencils": s["live"], "static": static,
            "general": general}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, help="side of the stiffness / damping / sort scans")
    ap.add_argument("--stiff", type=float, nargs="+", default=[1e3, 1e4])
    ap.add_argument("--contact", type=int, help="side of probe_contact's section 3")
    args = ap.parse_args(argv)
    if args.scans:
        print(json.dumps(scans(args.scans, args.stiff)), flush=True)
    if args.contact:
        print(json.dumps(contact(args.contact)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
