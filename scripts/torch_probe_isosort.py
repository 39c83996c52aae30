#!/usr/bin/env python3
"""Isotropic against per-axis Morton normalization on the folded contact
sheet: the twin of scripts/probe_isosort.py, in precond_tpu_torch.

The reference normalizes each axis independently into the unit cube
(FillSortingData, cpp:225-231). On a near-flat sheet this stretches the
thin axis to unit scale: the fold's contact pairs sit h/2 apart in real
space but land in opposite halves of the sort, so no level-0 / level-1
bank holds a contact pair and the preconditioner resolves the stiff
constraints only through coarse compensation. Isotropic normalization
(divide by the largest extent; the port's and the JAX package's default)
keeps true distances, so contact pairs sort together and their rank-1
Hessians land inside fine blocks.

For each stiffness the general M (prepare_with_system with the stencils,
row-major, dense symv K3) is built on both sorts, beside block-Jacobi:

  axis    compute_sort_maps(pos, "per_axis"). The JAX script's line 85
          labels compute_sort_maps(pj) "per-axis (reference behavior)",
          but that call has defaulted to "isotropic" since it became the
          package default (precond_tpu/solver.py:38-39), so the JAX
          script's two columns are the same sort. "per_axis" is what that
          line meant, and what this column is.
  iso     compute_sort_maps(pos, "isotropic"), the JAX script's iso_maps
          (the same arithmetic, with a guard for a zero extent).
  jacobi  block-Jacobi on the ELL diagonal plus the contact diagonal.

A second line gives each solve's wall and ms per iteration.

    python3 scripts/torch_probe_isosort.py [grid] [--stiff 1e3 1e4 ...] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch_dissect_common as dc  # noqa: E402
import torch_probe_common as pc  # noqa: E402

#: column name -> Morton normalization
SORTS = {"axis": "per_axis", "iso": "isotropic"}


def config():
    """probe_isosort.py:55's config: row-major, dense symv."""
    from precond_tpu_torch import SchwarzConfig

    return dataclasses.replace(SchwarzConfig(), solve_layout="rows", symv_kernel="dense")


def run(s, stiffs, log=dc.log) -> dict:
    """The scan on setup()'s sheet: {stiffness: {"axis" | "iso" | "jacobi":
    solve dict}}, printing the JAX script's line for each stiffness and a
    line of walls."""
    from precond_tpu_torch.solver import compute_sort_maps

    cfg = config()
    maps = {name: compute_sort_maps(s.pos, norm) for name, norm in SORTS.items()}
    out = {}
    for stiff in stiffs:
        st = pc.with_stiffness(s.st, stiff)
        spmv = pc.contact_spmv(s, st)
        row = {name: pc.solve(s, spmv, pc.general_pre(s, st, m, cfg)) for name, m in maps.items()}
        row["jacobi"] = pc.solve(s, spmv, pc.jacobi_pre(s, st))
        log("  ".join([f"stiff={stiff:8.0e} "] + [f"{k}={v['iters']}" for k, v in row.items()]))
        log("  walls: " + "  ".join(pc.wall_note(k, v) for k, v in row.items()))
        out[stiff] = row
    return out


def main(argv=None) -> int:
    dev, args = dc.parse_args(__doc__.splitlines()[0], argv, pc.add_scan_args(128))
    s = pc.setup(args.grid, dev)
    dc.header(f"n={s.n} stencils={s.live}", dev)
    run(s, args.stiff)
    return 0


if __name__ == "__main__":
    sys.exit(main())
