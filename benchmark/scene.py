"""The one traffic generator: a traffic mix's JSON file and a seed -> the
episode a cell replays.

An episode starts at the rest positions the simulator is built with: the
sheet's own, or with a `fold` block the folded sheet. A `gust` block gives
it a velocity normal to the sheet (along z) made of the mix's
low-frequency modes w cos(pi (kx x + ky y) + phase), scaled so that its
fastest vertex moves at `speed`. The modes, weights and phases are the
mix's; the seed moves each phase by up to `phase_jitter` radians, so every
seed gets its own inputs but the same work (iterations per frame).

A `fold` block folds the last `columns` grid columns back over the
`columns` beside them: each folded vertex lies over the vertex it is
folded onto, moved by `shift_spacings` spacings along x and along y, and
`gap_spacings` spacings above (in z) the sheet there; then it is jittered
by up to `jitter_spacings` spacings on each axis from the seed, so that no
two contact candidates tie (a sewn hem).
A `contact` block turns on the simulator's self-contact; its distances are
in grid spacings and its budget in contacts a vertex, each set (VF, EE, EF)
having that budget.

The seed also draws which frames of the first episode the comparison
checks (frame 0 always: on the general path it is the re-sort frame).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class Contact(NamedTuple):
    stiffness: float
    threshold: float        # detection distance
    rest_gap: float         # the penalties push apart up to this gap
    cell_cap: int           # the broad phase's primitives a grid cell
    budget: int             # contacts kept of each set (VF, EE, EF)
    per_primitive_cap: int  # nearest contacts a vertex or edge keeps


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
    rest: np.ndarray        # f32[N,3] the rest positions the simulator is built with
    contact: Optional[Contact] = None


def _pinned(pin: dict, pos: np.ndarray, spacing: float) -> np.ndarray:
    coord = pos[:, int(pin["axis"])].astype(np.float64)
    reach = float(pin["within_spacings"]) * spacing
    if pin["side"] == "max":
        return np.flatnonzero(coord >= coord.max() - reach)
    return np.flatnonzero(coord <= coord.min() + reach)


def _fold(fold: dict, mesh: dict, rng) -> np.ndarray:
    """Rest positions of a grid sheet whose last columns are folded back."""
    nx, ny = (int(g) for g in mesh["grid"])
    cols = int(fold["columns"])
    if not 0 < cols <= nx // 2:
        raise ValueError(f"a fold of {cols} columns on a {nx}-column grid")
    h = float(mesh["spacing"])
    pos = np.asarray(mesh["positions"], np.float64).reshape(nx, ny, 3)
    out = pos.copy()
    # column i >= nx - cols lies on column u = 2 (nx - cols) - 1 - i, moved
    # by s spacings along x and y: onto the point of u's quad diagonal
    # (u, j) - (u + 1, j + 1) at s, whose height is the diagonal's (the
    # last row's diagonal continued past the edge)
    under = 2 * (nx - cols) - 1 - np.arange(nx - cols, nx)
    s = float(fold["shift_spacings"])
    z = np.concatenate([pos[:, :, 2], 2 * pos[:, -1:, 2] - pos[:, -2:-1, 2]], axis=1)
    zs = (1 - s) * z[under, :ny] + s * z[under + 1, 1:]
    out[nx - cols:] = pos[under] + np.array([s * h, s * h, 0.0])
    out[nx - cols:, :, 2] = zs + float(fold["gap_spacings"]) * h
    jitter = float(fold["jitter_spacings"]) * h
    out[nx - cols:] += rng.uniform(-jitter, jitter, (cols, ny, 3))
    return out.reshape(-1, 3).astype(np.float32)


def make(traffic: dict, mesh: dict, seed: int) -> Scene:
    rng = np.random.default_rng(seed)
    pos = np.asarray(mesh["positions"], np.float32)
    v0 = np.zeros_like(pos)
    spacing = float(mesh["spacing"])

    rest = pos
    if "fold" in traffic:
        rest = _fold(traffic["fold"], mesh, rng)
    pinned = _pinned(traffic["pin"], rest, spacing)
    gust = traffic.get("gust")
    if gust is not None:
        modes = np.asarray(gust["modes"], np.float64)
        jitter = float(gust["phase_jitter"])
        phases = np.asarray(gust["phases"], np.float64) + rng.uniform(-jitter, jitter, len(modes))
        x, y = rest[:, 0].astype(np.float64), rest[:, 1].astype(np.float64)
        vz = np.zeros(len(rest))
        for (kx, ky), w, ph in zip(modes, gust["weights"], phases):
            vz += float(w) * np.cos(np.pi * (kx * x + ky * y) + ph)
        vz[pinned] = 0.0
        vz *= float(gust["speed"]) / np.abs(vz).max()
        v0[:, 2] = vz

    contact = None
    if "contact" in traffic:
        c = traffic["contact"]
        contact = Contact(
            stiffness=float(c["stiffness"]), threshold=float(c["threshold_spacings"]) * spacing,
            rest_gap=float(c["rest_gap_spacings"]) * spacing, cell_cap=int(c["cell_cap"]),
            budget=int(round(float(c["budget_per_vertex"]) * len(pos))),
            per_primitive_cap=int(c["per_primitive_cap"]))

    frames = int(traffic["episode_frames"])
    extra = rng.choice(np.arange(1, frames), int(traffic["checked_frames"]) - 1, replace=False)
    first, last = traffic["traced_frames"]
    lfirst, llast = traffic["labelled_frames"]
    return Scene(
        x0=rest, v0=v0, pinned=pinned, gravity=tuple(float(g) for g in traffic["gravity"]),
        tol=float(traffic["tol"]), max_iters=int(traffic["max_iters"]), episode_frames=frames,
        warm_frames=int(traffic["warm_frames"]), checked=tuple(sorted({0, *map(int, extra)})),
        traced=tuple(range(int(first), int(last) + 1)),
        labelled=tuple(range(int(lfirst), int(llast) + 1)),
        rest=rest, contact=contact,
    )
