#!/usr/bin/env python3
"""Contact-stiffness regime scan: the twin of scripts/probe_stiff.py, in
precond_tpu_torch. Schwarz against block-Jacobi PCG iterations on the
folded sheet (torch_probe_common) as the contact stiffness grows.

The collide bench's penalty stiffness (1e3) is softer than the cloth
springs it opposes (1e4): not the penetration-enforcing regime. For each
stiffness the scan reports the iterations to 1e-4 (max_iters 20000,
check_every 8) of three solvers on the same operator, the grid stencil
SpMV (K4) plus the slot contact SpMV:

  static   the static grid M: row-major prepare_grid with the stencils on
           the tile maps (K1; the dense symv K3 up to 4,095 blocks)
  general  the general M on the position Morton sort (compute_sort_maps,
           isotropic): prepare_with_system with the stencils, whose contact
           pairs join the clustering (BuildCollisionConnection, cpp:514-563)
  jacobi   block-Jacobi on the ELL diagonal plus the contact diagonal

and, on a second line, each solve's wall (host clock ending in a device
sync) and ms per iteration.

    python3 scripts/torch_probe_stiff.py [grid] [--stiff 1e3 1e4 ...] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch_dissect_common as dc  # noqa: E402
import torch_probe_common as pc  # noqa: E402

SOLVERS = ("static", "general", "jacobi")


def config():
    """probe_stiff.py:42's config: the defaults, row-major."""
    from precond_tpu_torch import SchwarzConfig

    return dataclasses.replace(SchwarzConfig(), solve_layout="rows")


def run(s, stiffs, log=dc.log) -> dict:
    """The scan on setup()'s sheet: {stiffness: {solver: solve dict}},
    printing the JAX script's line for each stiffness and a line of walls."""
    from precond_tpu_torch.solver import compute_sort_maps

    cfg = config()
    pmaps = compute_sort_maps(s.pos)
    out = {}
    for stiff in stiffs:
        st = pc.with_stiffness(s.st, stiff)
        spmv = pc.contact_spmv(s, st)
        row = {"static": pc.solve(s, spmv, pc.static_pre(s, st, cfg)),
               "general": pc.solve(s, spmv, pc.general_pre(s, st, pmaps, cfg)),
               "jacobi": pc.solve(s, spmv, pc.jacobi_pre(s, st))}
        si, gi, ji = (row[k]["iters"] for k in SOLVERS)
        log(f"stiff={stiff:8.0e}  static={si:6d}  general={gi:6d}  "
            f"jacobi={ji:6d}  j/static={ji / max(si, 1):.2f} "
            f"j/general={ji / max(gi, 1):.2f}")
        log("  walls: " + "  ".join(pc.wall_note(k, row[k]) for k in SOLVERS))
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
