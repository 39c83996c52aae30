"""The one traffic generator: a traffic mix's JSON file and a seed -> the
episode a cell replays.

An episode starts at the sheet's rest positions with a gust: a velocity
normal to the sheet (along z) made of the mix's low-frequency modes
w cos(pi (kx x + ky y) + phase), scaled so that its fastest vertex moves at
`speed`. The modes, weights and phases are the mix's; the seed moves each
phase by up to `phase_jitter` radians, so every seed gets its own inputs
but the same work (iterations per frame). The seed also draws which frames
of the first episode the comparison checks (frame 0 always: on the general
path it is the re-sort frame).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class Scene(NamedTuple):
    x0: np.ndarray          # f32[N,3]
    v0: np.ndarray          # f32[N,3]
    pinned: np.ndarray      # i64[P]
    gravity: Tuple[float, float, float]
    tol: float
    max_iters: int
    episode_frames: int
    warm_frames: int
    checked: Tuple[int, ...]   # frames of the first episode the comparison checks
    traced: Tuple[int, ...]    # frames of the first episode traced on the card alone
    labelled: Tuple[int, ...]  # frames traced on host and card, for the idle-gap labels


def _pinned(pin: dict, pos: np.ndarray, spacing: float) -> np.ndarray:
    coord = pos[:, int(pin["axis"])].astype(np.float64)
    reach = float(pin["within_spacings"]) * spacing
    if pin["side"] == "max":
        return np.flatnonzero(coord >= coord.max() - reach)
    return np.flatnonzero(coord <= coord.min() + reach)


def make(traffic: dict, mesh: dict, seed: int) -> Scene:
    rng = np.random.default_rng(seed)
    pos = np.asarray(mesh["positions"], np.float32)
    pinned = _pinned(traffic["pin"], pos, float(mesh["spacing"]))

    gust = traffic["gust"]
    modes = np.asarray(gust["modes"], np.float64)
    jitter = float(gust["phase_jitter"])
    phases = np.asarray(gust["phases"], np.float64) + rng.uniform(-jitter, jitter, len(modes))
    x, y = pos[:, 0].astype(np.float64), pos[:, 1].astype(np.float64)
    vz = np.zeros(len(pos))
    for (kx, ky), w, ph in zip(modes, gust["weights"], phases):
        vz += float(w) * np.cos(np.pi * (kx * x + ky * y) + ph)
    vz[pinned] = 0.0
    vz *= float(gust["speed"]) / np.abs(vz).max()
    v0 = np.zeros_like(pos)
    v0[:, 2] = vz

    frames = int(traffic["episode_frames"])
    extra = rng.choice(np.arange(1, frames), int(traffic["checked_frames"]) - 1, replace=False)
    first, last = traffic["traced_frames"]
    lfirst, llast = traffic["labelled_frames"]
    return Scene(
        x0=pos, v0=v0, pinned=pinned, gravity=tuple(float(g) for g in traffic["gravity"]),
        tol=float(traffic["tol"]), max_iters=int(traffic["max_iters"]), episode_frames=frames,
        warm_frames=int(traffic["warm_frames"]), checked=tuple(sorted({0, *map(int, extra)})),
        traced=tuple(range(int(first), int(last) + 1)),
        labelled=tuple(range(int(lfirst), int(llast) + 1)),
    )
