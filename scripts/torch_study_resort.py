#!/usr/bin/env python3
"""Re-sort cadence study: the twin of scripts/study_resort.py, in
precond_tpu_torch. How fast does a stale Morton sort degrade PCG
convergence as the cloth deforms?

The reference re-sorts every 17 frames (cpp:49). Here a cloth pinned
along its top edge drops under gravity on the general float-Morton path
(a grid side that is not a power of two, so the sort is real), through
models.simulator.ClothSim, and the Schwarz-PCG iteration count is recorded
per frame for three cadences: every frame, every 17 and never. A frame
whose positions are not finite ends the run ("DIVERGED at frame f"). Each
cadence's line adds the mean frame wall (host clock; it includes the
iterations' host syncs).

Env: STUDY_GRID (default 48), STUDY_FRAMES (default 40).

    python3 scripts/torch_study_resort.py [--device cpu]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_dissect_common as dc  # noqa: E402

CADENCES = {1: "every frame", 17: "every 17 (reference)", 10 ** 9: "never"}


def run(resort_every: int, grid: int, frames: int, dev: torch.device, log=dc.log) -> dict:
    """Per-frame iterations of one cadence, and the mean frame wall (ms)."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.models.simulator import ClothSim

    mesh = cloth.make_grid(grid, grid, z_wave=0.01, mass=0.005, dt=1.0 / 60.0)
    pinned = np.arange(grid)                        # whole top edge pinned
    sim = ClothSim(mesh, SchwarzConfig(resort_every=resort_every), pinned=pinned,
                   max_iters=2000, device=dev)
    iters, walls = [], []
    for f in range(frames):
        t0 = time.perf_counter()
        sim.step()
        dc.sync(dev)
        walls.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(sim.state.positions).all()):
            log(f"  DIVERGED at frame {f}")
            break
        iters.append(int(sim.last_solve.iterations))
    return {"iters": iters, "frame_ms": 1e3 * float(np.mean(walls))}


def main(argv=None) -> int:
    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    grid, frames = dc.env_int("STUDY_GRID", 48), dc.env_int("STUDY_FRAMES", 40)
    dc.header(f"grid={grid} frames={frames}", dev)
    for cadence, label in CADENCES.items():
        out = run(cadence, grid, frames, dev)
        it = out["iters"]
        dc.log(f"resort {label:22s}: mean {np.mean(it):6.1f}  max {max(it):4d}  "
               f"last10 {np.mean(it[-10:]):6.1f}  iters={it}; {out['frame_ms']:.1f} ms/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
