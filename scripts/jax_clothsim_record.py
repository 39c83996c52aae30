#!/usr/bin/env python3
"""JAX package record of ClothSim on the folded self-colliding sheet.

The JAX bench's `collide` sheet (bench.py:220-227: a grid x grid cloth,
z_wave 0, mass 1e-3, dt 1/60, the right half folded onto the left at a gap
of 0.5 h), taken as the rest shape of a ClothSim with
SchwarzConfig(coarse_damping=0.25, max_collision_per_vert=2), collision
stiffness 1e3, threshold 0.75 h, a budget of n // 4 per set, a cell cap of
8, max_iters 2000, default gravity and no pins. Steps `--frames` frames
(each: detection, the static grid prepare with the stencils, comp-major
PCG to 1e-4 testing every iteration) and records each frame's iterations,
relative residual and detection flags.

The frames run under jax.disable_jit(), op by op. The sheet's contacts tie
exactly (every upper vertex sits 0.5 h above a lower one), so which of them
a budget keeps is decided by the last bit of each distance, and XLA rounds a
compiled (jitted, or lax.map-chunked) detection differently from the same
ops run one by one. Run op by op, the JAX package computes the detection the
PyTorch port reproduces bit for bit, so the record and the port solve the
same contact sets.

It also writes the positions each later frame starts from (`--starts`,
float32 arrays x1, x2, ...: the sheet's contacts tie exactly, so a frame's
contact sets, and its iterations, follow the last bit of its start state;
chip_smoke.py runs each frame from these). Each frame's start velocity is
(x_f - x_(f-1)) / dt in float32, which the script checks bit for bit.

Prints one line per frame, then one JSON line. Runs the JAX package on the
CPU; the PyTorch port never imports it.

    JAX_PLATFORMS=cpu python3 scripts/jax_clothsim_record.py [--grid 256] [--frames 3]
        [--starts scripts/jax_clothsim_record_256.npz]
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
import numpy as np  # noqa: E402

from jax_collide_general_record import folded_sheet  # noqa: E402
from precond_tpu.config import SchwarzConfig  # noqa: E402
from precond_tpu.models.simulator import ClothSim  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--starts", default=None,
                    help="npz for the frames' start positions (default: next to this script)")
    args = ap.parse_args(argv)
    starts = args.starts or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         f"jax_clothsim_record_{args.grid}.npz")
    mesh, positions, h = folded_sheet(args.grid)
    n = mesh.num_verts
    sim = ClothSim(mesh._replace(positions=positions),
                   SchwarzConfig(coarse_damping=0.25, max_collision_per_vert=2),
                   collision_stiffness=1e3, collision_threshold=0.75 * h,
                   collision_budget=n // 4, collision_cell_cap=8, max_iters=2000)
    frames, xs = [], [np.asarray(sim.state.positions)]
    for f in range(args.frames):
        t0 = time.perf_counter()
        with jax.disable_jit():
            st = sim.step()
        pos = np.asarray(st.positions)
        rec = {"frame": f, "iters": int(sim.last_solve.iterations),
               "rel": float(sim.last_solve.rel_residual),
               "truncated": bool(sim.last_detect_info.truncated),
               "dropped": int(sim.last_detect_info.dropped),
               "finite": bool(np.isfinite(pos).all()), "z_mean": float(pos[:, 2].mean())}
        frames.append(rec)
        v = np.asarray(st.velocities)
        if not np.array_equal(v, (pos - xs[-1]) / np.float32(mesh.dt)):
            raise SystemExit(f"frame {f}: the velocity is not (x_new - x) / dt in float32")
        xs.append(pos)
        print(f"[record] frame {f}: iters {rec['iters']} rel {rec['rel']:.3e} "
              f"dropped {rec['dropped']} ({time.perf_counter() - t0:.1f} s)", flush=True)
    np.savez(starts, **{f"x{f}": xs[f] for f in range(1, args.frames)})
    print(f"[record] wrote the start positions of frames 1-{args.frames - 1} to {starts}", flush=True)
    print(json.dumps({"grid": args.grid, "n": n, "frames": frames}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
