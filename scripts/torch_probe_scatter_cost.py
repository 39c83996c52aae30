#!/usr/bin/env python3
"""Micro-probe of the placement primitives: the twin of
scripts/probe_scatter_cost.py, in precond_tpu_torch. P = 2^20 payload rows
into an M = 2^21 + 2^17-slot table (the scale of grid_collision_terms on
the collide sheet), through the port's own primitives:

  * utils/scatter.accumulate_rows (the port's one float scatter-add:
    index_put_ with accumulate=True under deterministic algorithms) on
    [P,9] and [P,1], random and sorted targets: is it priced per row or per
    element, and does sorting the targets change it?
  * a row gather of [P,9] (payload reorder);
  * torch.cumsum over [P,9] (9-minor) and over [9,P] (P-minor);
  * torch.argsort on the [P] int32 targets (the sorted-cumsum plan);
  * torch.searchsorted with M queries (the boundary-table plan);
  * index_add_ on [P,9] (an atomic add on the card). The port never uses
    it (its sum order changes from run to run, ROADMAP "Determinism"); its
    line prices the deterministic placement against it.

Where the process's deterministic-algorithms setting makes an op raise on
the card, its line prints the reason instead of a time; the setting is not
switched off here. Each op is timed directly, the least wall of 3 calls
after a warm one, each ending in a device sync, with its device busy share
(torch_dissect_common.measure); the JAX script's k-against-3k differencing
measures nothing where every call ends in a sync.

    python3 scripts/torch_probe_scatter_cost.py [--p 1048576] [--m 2228224] [--device cpu]
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

P = 1 << 20            # ~1M payload rows
M = 1 << 21 | 131072   # ~2.2M target slots


def setup(p: int, m: int, dev: torch.device) -> SimpleNamespace:
    """The script's inputs (default_rng(0)): targets in [0, m), sorted
    targets, [p,9] payloads and their first column."""
    rng = np.random.default_rng(0)
    tgt = torch.as_tensor(rng.integers(0, m, p).astype(np.int32), device=dev)
    val9 = torch.as_tensor(rng.standard_normal((p, 9)).astype(np.float32), device=dev)
    return SimpleNamespace(p=p, m=m, dev=dev, tgt=tgt, tgt_sorted=torch.sort(tgt).values,
                           val9=val9, val1=val9[:, :1].contiguous())


def _place(s, width: int, sorted_: bool) -> torch.Tensor:
    from precond_tpu_torch.utils.scatter import accumulate_rows

    out = torch.zeros((s.m, width), dtype=torch.float32, device=s.dev)
    accumulate_rows(out, s.tgt_sorted if sorted_ else s.tgt, s.val9 if width == 9 else s.val1)
    return out


#: line name -> op on setup()'s inputs
OPS = {
    "accumulate_rows [P,9] random": lambda s: _place(s, 9, False),
    "accumulate_rows [P,9] sorted": lambda s: _place(s, 9, True),
    "accumulate_rows [P,1] random": lambda s: _place(s, 1, False),
    "accumulate_rows [P,1] sorted": lambda s: _place(s, 1, True),
    "gather [P,9] rows": lambda s: s.val9[(s.tgt % s.p).long()],
    "cumsum [P,9] (9-minor)": lambda s: torch.cumsum(s.val9, dim=0),
    "cumsum [9,P] (P-minor)": lambda s: torch.cumsum(s.val9.reshape(9, -1), dim=1),
    "argsort [P] i32": lambda s: torch.argsort(s.tgt),
    "searchsorted M queries": lambda s: torch.searchsorted(
        s.tgt_sorted, torch.arange(s.m, dtype=torch.int32, device=s.dev)),
    "index_add_ [P,9] random (atomic)": lambda s: torch.zeros(
        (s.m, 9), dtype=torch.float32, device=s.dev).index_add_(0, s.tgt, s.val9),
}


def run(s, log=dc.log) -> dict:
    """Times every op; returns {name: Timing with "ms"} for the ops that
    ran and {name: reason} for the ones the deterministic setting refused."""
    out = {}
    for name, op in OPS.items():
        try:
            t = dc.measure(lambda: op(s), s.dev)
        except RuntimeError as e:
            if "deterministic" not in str(e):
                raise
            out[name] = str(e).splitlines()[0]
            log(f"{name:44s}  raises under deterministic algorithms: {out[name]}")
            continue
        t["ms"] = t["best_s"] * 1e3
        out[name] = t
        log(f"{name:44s} {t['ms']:9.3f} ms{t.note()}")
    return out


def main(argv=None) -> int:
    def add(ap):
        ap.add_argument("--p", type=int, default=P, help="payload rows")
        ap.add_argument("--m", type=int, default=M, help="target slots")

    dev, args = dc.parse_args(__doc__.splitlines()[0], argv, add)
    s = setup(args.p, args.m, dev)
    dc.header(f"P={s.p} M={s.m} deterministic={torch.are_deterministic_algorithms_enabled()}", dev)
    run(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
