#!/usr/bin/env python3
"""Sub-component timings of assemble_banked_hessian: the twin of
scripts/profile_assembly.py, in precond_tpu_torch.

Each component runs K times, each call on an input nudged by 1e-30 *
mean(last output), eagerly with no host sync inside the chain; the line is
the least of 3 reps after a warm call, in ms per op, with the chain's
device busy share (torch_dissect_common).

  floor (scaled copy)      x * 1.000001 on the sorted diagonal
  anc table                assembly.node_ancestor_table
  otanc gather [N,K,L]     every neighbour's ancestor chain
  assemble full            assembly.assemble_banked_hessian (ancestor-table form)
  _level_rows l=<l>        one level's 288-wide row contributions, every level
  _row_scatter level-1     N rows placed at their level-1 ancestors, through
                           utils/scatter.accumulate_rows as the port places them

The JAX script calls `_level_rows` with an older signature (the
neighbour ids and the ancestor columns) and raises there; the twin passes
what assemble_banked_hessian passes now (the climbed neighbour lanes, the
merge levels, the own lanes at the level), derived as it derives them.

Env: BENCH_GRID (default 256), PROF_K (default 30).

    python3 scripts/torch_profile_assembly.py [--device cpu]
"""

from __future__ import annotations

import functools
import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_dissect_common as dc  # noqa: E402
from torch_profile_prepare import chain  # noqa: E402


def setup(grid: int, dev: torch.device) -> SimpleNamespace:
    """The JAX script's sorted system and hierarchy on `dev`, and the
    ancestor-table terms assemble_banked_hessian derives from them."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops import assembly as asm
    from precond_tpu_torch.ops import hierarchy as hi
    from precond_tpu_torch.ops.blockcsr import permute
    from precond_tpu_torch.ops.hierarchy import BANK
    from precond_tpu_torch.solver import compute_sort_maps

    cfg = SchwarzConfig()
    mesh = cloth.make_grid(grid, grid, **dc.MESH_KW)
    n = mesh.num_verts
    ell = cloth.assemble_system(mesh, device=dev)
    maps = compute_sort_maps(torch.as_tensor(mesh.positions, device=dev))
    ells = permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    hier = hi.build_hierarchy(ells.idx, ells.mask, cfg, None)
    levels, total = cfg.num_levels(n), cfg.total_capacity(n)
    gn = hier.going_next
    anc = asm.node_ancestor_table(gn, levels, total)
    myanc = anc[:n]
    otanc = anc[ells.idx]
    eq = torch.div(myanc[:, None, :], BANK, rounding_mode="floor") == torch.div(
        otanc, BANK, rounding_mode="floor")
    lam = torch.argmax(eq.to(torch.uint8), dim=-1)
    ok = eq.any(dim=-1) & ells.mask
    lane_ot = torch.gather(otanc, 2, lam[:, :, None])[:, :, 0] % BANK
    return SimpleNamespace(
        grid=grid, n=n, cfg=cfg, levels=levels, total=total, ells=ells, hier=hier, gn=gn,
        anc=anc, myanc=myanc, lam=lam.to(torch.int32), ok=ok, lane_ot=lane_ot,
        blk9=ells.blocks.reshape(n, -1, 9), dself9=ells.diag.reshape(n, 9), dev=dev,
        vals1=torch.ones((n, asm.ROW), dtype=torch.float32, device=dev),
        hb0=torch.zeros((total + 1, asm.ROW), dtype=torch.float32, device=dev))


# the components, (x, *rest) -> y as the JAX script's lambdas

def floor(s, x):
    return x * 1.000001


def anc_table(s, gf):
    from precond_tpu_torch.ops import assembly as asm

    return asm.node_ancestor_table(gf.to(torch.int32), s.levels, s.total).to(torch.float32)


def otanc_gather(s, xf, a, idx):
    return a[idx].to(torch.float32).sum(-1) + 0 * xf[..., :1]


def assemble_full(s, d, e, h):
    from precond_tpu_torch.ops import assembly as asm

    return asm.assemble_banked_hessian(e._replace(diag=d), h, s.cfg, None)[:, 0, :]


def level_rows(s, level, d9, lane_ot, lam, ok, blk9, lane_my):
    from precond_tpu_torch.ops import assembly as asm

    return asm._level_rows(lane_ot, lam, ok, blk9, lane_my, d9, level)


def row_scatter(s, v, hb, rows):
    from precond_tpu_torch.ops import assembly as asm

    out = hb.clone()
    asm._row_scatter(out, rows, v, rows < s.total, s.total)
    return out[: s.n]


def lines(s) -> list:
    """(line name, op (x, *rest) -> y, its arguments) in the script's order."""
    from precond_tpu_torch.ops.hierarchy import BANK

    def op(fn, *bound):
        return functools.partial(fn, s, *bound)

    out = [("floor (scaled copy)", op(floor), (s.ells.diag,)),
           ("anc table", op(anc_table), (s.gn.to(torch.float32),)),
           ("otanc gather [N,K,L]", op(otanc_gather),
            (s.ells.idx.to(torch.float32), s.anc, s.ells.idx)),
           ("assemble full", op(assemble_full), (s.ells.diag, s.ells, s.hier))]
    for level in range(s.levels):
        out.append((f"_level_rows l={level}", op(level_rows, level),
                    (s.dself9, s.lane_ot, s.lam, s.ok, s.blk9, s.myanc[:, level] % BANK)))
    out.append(("_row_scatter level-1", op(row_scatter), (s.vals1, s.hb0, s.myanc[:, 1])))
    return out


def run_lines(s, k: int, log=dc.log) -> dict:
    """Times every line (ms per op) and prints the script's line for each;
    returns {name: Timing}."""
    out = {}
    for name, op, args in lines(s):
        run = chain(op, k)
        t = dc.measure(lambda: run(*args), s.dev)
        t["ms"] = t["best_s"] / k * 1e3
        log(f"{name:34s} {t['ms']:9.3f} ms/op" + t.note())
        out[name] = t
    return out


def main(argv=None) -> int:
    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    k = dc.env_int("PROF_K", 30)
    s = setup(dc.env_int("BENCH_GRID", 256), dev)
    dc.header(f"grid={s.grid} n={s.n} total={s.total} K={k} levels={s.levels} "
              f"K_ell={s.ells.idx.shape[1]}", dev)
    run_lines(s, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
