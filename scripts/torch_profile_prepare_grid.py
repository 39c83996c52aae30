#!/usr/bin/env python3
"""Dissect the grid-path prepare (static assembly + the inverse): the twin
of scripts/profile_prepare_grid.py, in precond_tpu_torch.

Each line chains its op k times, each call's input scaled by (1 + 0 *
the last output's first element), eagerly with no host sync inside the
chain, at k = K and 3K (least of 3 reps after a warm call each), and
prints the difference per op: (t(3K) - t(K)) / 2K ms, which cancels
whatever the chain pays once. Beside it, the device busy share of the 3K
chain (torch_dissect_common).

  assemble_grid_hessian      gridassembly.assemble_grid_hessian
  invert_spd_blocks_panel    the batched 96x96 SPD inverse kernel (K1)
  prepare_grid (asm+inv)     both, as solver.prepare_grid runs them

Env: BENCH_GRID (default 256), PROF_K (default 8).

    python3 scripts/torch_profile_prepare_grid.py [--device cpu]
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


def setup(grid: int, dev: torch.device) -> SimpleNamespace:
    """The JAX script's grid blocks on `dev` and their assembled h96."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.gridassembly import assemble_grid_hessian

    k = grid.bit_length() - 1
    cfg = SchwarzConfig()
    mesh = cloth.make_grid(grid, grid, **dc.MESH_KW)
    dgr, drr, goffsets = cloth.assemble_system_grid(mesh, device=dev)
    h96 = assemble_grid_hessian(dgr, drr, goffsets, k, cfg, None)
    return SimpleNamespace(grid=grid, k=k, n=mesh.num_verts, cfg=cfg, dgr=dgr, drr=drr,
                           goffsets=goffsets, h96=h96, dev=dev)


def chained(op, k: int):
    """Run op k times, each dependent on the last via a scalar tap."""

    def run(*args):
        x, tap = args[0], torch.zeros((), dtype=torch.float32, device=args[0].device)
        for _ in range(k):
            y = op(x * (1.0 + 0.0 * tap), *args[1:])
            tap = y.reshape(-1)[0].to(torch.float32)
        return tap

    return run


def assemble(s, dg, dr):
    from precond_tpu_torch.ops.gridassembly import assemble_grid_hessian

    return assemble_grid_hessian(dg, dr, s.goffsets, s.k, s.cfg, None)


def invert(s, h):
    from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse

    return spd_inverse(h)


def prepare_grid(s, dg, dr):
    return invert(s, assemble(s, dg, dr))


#: (line name, op, its arguments as fields of the setup)
LINES = (
    ("assemble_grid_hessian", assemble, ("dgr", "drr")),
    ("invert_spd_blocks_panel", invert, ("h96",)),
    ("prepare_grid (asm+inv)", prepare_grid, ("dgr", "drr")),
)


def run_lines(s, k: int, log=dc.log) -> dict:
    """Times every line (differenced ms per op) and prints the script's
    line for each; returns {name: Timing of the 3K chain, with "ms"}."""
    out = {}
    for name, fn, names in LINES:
        op, args = functools.partial(fn, s), [getattr(s, a) for a in names]
        short, long_ = chained(op, k), chained(op, 3 * k)
        _, t_k, _ = dc.best_wall(lambda: short(*args), s.dev)
        t = dc.measure(lambda: long_(*args), s.dev)
        t["ms"] = (t["best_s"] - t_k) / (2 * k) * 1e3
        log(f"{name:34s} {t['ms']:9.3f} ms/op" + t.note())
        out[name] = t
    return out


def main(argv=None) -> int:
    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    k = dc.env_int("PROF_K", 8)
    s = setup(dc.env_int("BENCH_GRID", 256), dev)
    dc.header(f"grid={s.grid} n={s.n} blocks={s.h96.shape[0]} K={k}", dev)
    run_lines(s, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
