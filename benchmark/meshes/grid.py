"""Structured cloth sheet: a frozen copy of the port's ``models.cloth.make_grid``.

An nx x ny lattice in the XY plane with z = z_wave sin(7.3 x) cos(5.1 y),
two triangles per quad, the unique edges with their opposite vertices, and
structural, shear and bending springs. The benchmark builds the arrays
itself so that a change to the program cannot move its inputs.
"""

from __future__ import annotations

import numpy as np


def _edges(faces: np.ndarray, n: int) -> np.ndarray:
    """Unique edges [lo, hi, opposite, opposite-or-(-1)] of a triangle list."""
    he0 = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    he1 = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    hopp = np.concatenate([faces[:, 2], faces[:, 0], faces[:, 1]])
    lo = np.minimum(he0, he1).astype(np.int64)
    hi = np.maximum(he0, he1).astype(np.int64)
    key = lo * n + hi
    order = np.argsort(key, kind="stable")
    key_s, lo_s, hi_s, opp_s = key[order], lo[order], hi[order], hopp[order]
    first = np.empty(len(key_s), bool)
    first[:1] = True
    first[1:] = key_s[1:] != key_s[:-1]
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, len(key_s)))
    opp1 = np.where(counts > 1, opp_s[np.minimum(starts + 1, len(key_s) - 1)], -1)
    return np.stack([lo_s[starts], hi_s[starts], opp_s[starts], opp1], 1).astype(np.int32)


def build(p: dict) -> dict:
    """Arrays of the sheet described by the configuration's `mesh` entry."""
    nx = ny = int(p["side"])
    size = float(p.get("size", 1.0))
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    scale = size / max(nx - 1, 1)
    pos = np.stack([xs * scale, ys * scale, np.zeros_like(xs, np.float64)], -1).reshape(-1, 3)
    z_wave = float(p.get("z_wave", 0.0))
    if z_wave:
        pos[:, 2] = z_wave * np.sin(pos[:, 0] * 7.3) * np.cos(pos[:, 1] * 5.1)

    gi, gj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (gi * ny + gj).reshape(-1)
    b = ((gi + 1) * ny + gj).reshape(-1)
    c = ((gi + 1) * ny + gj + 1).reshape(-1)
    d = (gi * ny + gj + 1).reshape(-1)
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)]).astype(np.int32)
    edges = _edges(faces, nx * ny)

    def lattice_springs(di, dj):
        ii, jj = np.meshgrid(np.arange(nx - di), np.arange(ny - dj), indexing="ij")
        return np.stack([(ii * ny + jj).reshape(-1), ((ii + di) * ny + jj + dj).reshape(-1)], 1)

    ii, jj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    shear = np.concatenate([
        np.stack([(ii * ny + jj).reshape(-1), ((ii + 1) * ny + jj + 1).reshape(-1)], 1),
        np.stack([((ii + 1) * ny + jj).reshape(-1), (ii * ny + jj + 1).reshape(-1)], 1)])
    groups = [
        (lattice_springs(1, 0), p["k_struct"]),
        (lattice_springs(0, 1), p["k_struct"]),
        (shear, p["k_shear"]),
        (lattice_springs(2, 0), p["k_bend"]),
        (lattice_springs(0, 2), p["k_bend"]),
    ]
    return dict(
        positions=pos.astype(np.float32),
        edges=edges,
        faces=faces,
        springs=np.concatenate([g for g, _ in groups]).astype(np.int32),
        stiffness=np.concatenate([np.full(len(g), k, np.float32) for g, k in groups]),
        spacing=np.float64(scale),
        grid=np.array([nx, ny], np.int64),
    )
