#!/usr/bin/env python3
"""Coarse-level damping scan: the twin of scripts/probe_damping.py, in
precond_tpu_torch. PCG iterations over (stiffness x theta) on the folded
sheet (torch_probe_common).

The additive multilevel apply over-corrects along directions that several
levels represent; damped additive Schwarz, z = z0 + theta * sum_{l>=1} z_l,
is the textbook remedy. The bench's collide config runs theta = 0.25
(bench.py:87-95: "376 -> 320 Schwarz iters"), and so does ClothSim.

For each stiffness the static grid M (row-major prepare_grid with the
stencils on the tile maps, dense table) is applied through the script's
own `precondition_grid_damped` (probe_damping.py:40-67), ported as written:
every coarse level's correction scaled by theta on its way down.
`gridapply.precondition_grid` with `SchwarzConfig.coarse_damping = theta`
computes the same z (it scales the coarse sum once, at level 0); the tests
hold the two together. The dense symv is K3 on the card (the port's one
dense kernel stands for the JAX script's XLA einsum). Block-Jacobi closes
each row; a second line gives each solve's wall and ms per iteration.

    python3 scripts/torch_probe_damping.py [grid] [--stiff 1e3 1e4 ...] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch_dissect_common as dc  # noqa: E402
import torch_probe_common as pc  # noqa: E402

THETAS = (1.0, 0.5, 0.25, 0.125)


def config():
    """probe_damping.py:69's config: row-major, dense symv."""
    from precond_tpu_torch import SchwarzConfig

    return dataclasses.replace(SchwarzConfig(), solve_layout="rows", symv_kernel="dense")


def precondition_grid_damped(inv96, r_sorted: torch.Tensor, cfg, theta: float) -> torch.Tensor:
    """precondition_grid with coarse corrections scaled by theta."""
    from precond_tpu_torch.ops.cuda.symv import batched_symv
    from precond_tpu_torch.ops.hierarchy import BANK

    n = r_sorted.shape[0]
    offs = cfg.level_offsets(n)
    levels = cfg.num_levels(n)
    parts = [r_sorted]
    cur = r_sorted
    for l in range(levels - 1):
        s = cur.reshape(-1, BANK, 3).sum(dim=1)
        cap_next = offs[l + 2] - offs[l + 1]
        cur = F.pad(s, (0, 0, 0, cap_next - s.shape[0]))
        parts.append(cur)
    mr = torch.cat(parts, dim=0)
    z96 = batched_symv(inv96, mr.reshape(-1, 3 * BANK))
    z = z96.reshape(-1, 3)
    top = min(levels, cfg.max_applied_levels)
    pz = z[offs[top - 1]: offs[top]] * theta
    for l in range(top - 2, -1, -1):
        curz = z[offs[l]: offs[l + 1]] * (theta if l > 0 else 1.0)
        nb = (offs[l + 1] - offs[l]) // BANK
        pz = curz + torch.repeat_interleave(pz[:nb], BANK, dim=0)
    return pz[:n]


def run(s, stiffs, log=dc.log) -> dict:
    """The scan on setup()'s sheet: {stiffness: {theta or "jacobi": solve
    dict}}, printing the JAX script's line for each stiffness and a line of
    walls."""
    from precond_tpu_torch.solver import prepare_grid
    from precond_tpu_torch.utils import gridmorton as gm

    cfg = config()
    out = {}
    for stiff in stiffs:
        st = pc.with_stiffness(s.st, stiff)
        spmv = pc.contact_spmv(s, st)
        inv = prepare_grid(s.dgr, s.drr, s.offsets, s.k, cfg, st, s.maps.orig_to_sorted)
        row = {}
        for theta in THETAS:
            def pre(r, th=theta):
                return gm.morton_to_grid(
                    precondition_grid_damped(inv, gm.grid_to_morton(r, s.k), cfg, th), s.k)

            row[theta] = pc.solve(s, spmv, pre)
        row["jacobi"] = pc.solve(s, spmv, pc.jacobi_pre(s, st))
        log("  ".join([f"stiff={stiff:8.0e} "]
                      + [f"th{th}={row[th]['iters']}" for th in THETAS]
                      + [f"jacobi={row['jacobi']['iters']}"]))
        log("  walls: " + "  ".join(pc.wall_note(f"th{k}" if k != "jacobi" else k, v)
                                    for k, v in row.items()))
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
