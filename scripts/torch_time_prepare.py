#!/usr/bin/env python3
"""Quick prepare-phase timer (min of 5) for A/B testing assembly changes:
the twin of scripts/time_prepare.py, in precond_tpu_torch.

One warm solver.prepare_with_system on the Morton-sorted cloth, then the
least wall of 5 more, each ending in a device sync, with the device busy
share of one more under torch.profiler (torch_dissect_common). The warm
call's wall is printed too: the first prepare in the process.

Env: BENCH_GRID (default 256).

    python3 scripts/torch_time_prepare.py [--device cpu]
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch_dissect_common as dc  # noqa: E402
from torch_profile_prepare import prepare, setup  # noqa: E402


def time_prepare(s) -> dc.Timing:
    """Min of 5 prepares (after a warm one) on the setup's system."""
    return dc.measure(lambda: dc.first_value(prepare(s, s.ell, s.maps)[0].inv96), s.dev, reps=5)


def main(argv=None) -> int:
    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    s = setup(dc.env_int("BENCH_GRID", 256), dev)
    dc.log(dc.card_line(dev))
    t = time_prepare(s)
    dc.log(f"prepare min-of-5: {t['best_s'] * 1e3:.2f} ms (grid={s.grid}, n={s.n})"
           f"; first call {t['first_s'] * 1e3:.2f} ms" + t.note())
    return 0


if __name__ == "__main__":
    sys.exit(main())
