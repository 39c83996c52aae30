#!/usr/bin/env python3
"""Irregular Delaunay cloth: the arrays of an unstructured mesh for both packages.

The recipe (numpy and scipy only, so the JAX package's record and the
PyTorch port read bit-identical arrays; each package builds its own
``ClothMesh(..., grid=None)`` from them):

  * points: an s x s lattice, each point jittered uniformly by +-0.35 of
    the spacing (``numpy.random.default_rng(seed)``), scaled to the unit
    square (shifted to the origin and divided by the larger extent), with
    ``z = 0.02 sin(7.3 x) cos(5.1 y)`` as make_grid's z_wave;
  * the hub variant: every point within ``hub_radius`` spacings of the
    centre point (lattice index (s // 2, s // 2)) is taken out, except the
    centre itself, and the points of the next spacing (hub_radius <= d <
    hub_radius + 1) are moved along their ray onto the circle of radius
    hub_radius. Every one of them then meets the centre, which gets about
    2 pi hub_radius mesh neighbours (~120 at 19 spacings, ~40 at 6.5).
    Without the move the jittered rim shadows itself: the centre met 37
    points at 19 spacings and 88 at 65;
  * triangles: ``scipy.spatial.Delaunay``, each rotated to start at its
    smallest vertex (orientation kept) and the list sorted, so the arrays
    do not depend on Qhull's output order;
  * edges: the unique edges with their opposite vertices (-1 on the
    boundary), computed as make_grid computes them;
  * springs: every mesh edge at k_struct = 1e4, then each interior edge's
    pair of opposite vertices as a bend spring at k_bend = 1e2, pairs that
    are already springs dropped (at most one spring joins two vertices);
    mass 1e-3 and dt 1/60, the JAX bench's general config.

    python3 scripts/torch_irregular_mesh.py 256 --hub-radius 19
prints the mesh's size, degrees and digest.
"""

from __future__ import annotations

import argparse
import hashlib
import sys

import numpy as np

JITTER = 0.35
Z_WAVE = 0.02
K_STRUCT, K_BEND = 1e4, 1e2
MASS, DT = 1e-3, 1.0 / 60.0


def _points(side: int, seed: int, hub_radius: float):
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    lattice = np.stack([ii, jj], -1).reshape(-1, 2).astype(np.float64)
    rng = np.random.default_rng(seed)
    xy = lattice + rng.uniform(-JITTER, JITTER, lattice.shape)
    if hub_radius:
        centre = (side // 2) * side + side // 2
        d = np.linalg.norm(xy - xy[centre], axis=1)
        rim = (d >= hub_radius) & (d < hub_radius + 1.0)
        xy[rim] = xy[centre] + (xy[rim] - xy[centre]) * (hub_radius / d[rim])[:, None]
        xy = xy[(d >= hub_radius) | (np.arange(len(xy)) == centre)]
    lo = xy.min(axis=0)
    xy = (xy - lo) / (xy.max(axis=0) - lo).max()
    z = Z_WAVE * np.sin(xy[:, 0] * 7.3) * np.cos(xy[:, 1] * 5.1)
    return np.concatenate([xy, z[:, None]], 1)


def _faces(xy: np.ndarray) -> np.ndarray:
    from scipy.spatial import Delaunay

    f = Delaunay(xy).simplices.astype(np.int64)
    roll = np.argmin(f, axis=1)
    f = np.take_along_axis(f, (roll[:, None] + np.arange(3)) % 3, axis=1)
    return f[np.lexsort(f.T[::-1])].astype(np.int32)


def _edges(faces: np.ndarray, n: int) -> np.ndarray:
    """Unique edges with their opposite vertices, as make_grid builds them."""
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


def _springs(edges: np.ndarray, n: int):
    struct = edges[:, :2].astype(np.int64)
    inner = edges[edges[:, 3] >= 0]
    a, b = inner[:, 2].astype(np.int64), inner[:, 3].astype(np.int64)
    bend_key = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
    bend_key = bend_key[~np.isin(bend_key, struct[:, 0] * n + struct[:, 1])]
    bend = np.stack([bend_key // n, bend_key % n], 1)
    springs = np.concatenate([struct, bend]).astype(np.int32)
    stiffness = np.concatenate([np.full(len(struct), K_STRUCT, np.float32),
                                np.full(len(bend), K_BEND, np.float32)])
    return springs, stiffness


def irregular_cloth(side: int, hub_radius: float = 0.0, seed: int = 0) -> dict:
    """The arrays of a ClothMesh (grid=None) by the recipe above: positions
    f32[N,3], edges i32[E,4], faces i32[F,3], springs i32[S,2], stiffness
    f32[S], mass and dt. `hub_radius` in lattice spacings (0: no hub)."""
    pos = _points(side, seed, hub_radius)
    faces = _faces(pos[:, :2])
    n = len(pos)
    edges = _edges(faces, n)
    springs, stiffness = _springs(edges, n)
    return dict(positions=pos.astype(np.float32), edges=edges, faces=faces, springs=springs,
                stiffness=stiffness, mass=MASS, dt=DT, grid=None)


def hub_vertex(mesh: dict) -> int:
    """The vertex with the most mesh edges (the hub's centre on a hub mesh)."""
    return int(np.argmax(mesh_degrees(mesh)))


def degrees(mesh: dict) -> np.ndarray:
    """Spring partners per vertex (the ELL row lengths)."""
    return np.bincount(mesh["springs"].reshape(-1), minlength=len(mesh["positions"]))


def mesh_degrees(mesh: dict) -> np.ndarray:
    """Mesh neighbours per vertex (edges of the triangulation)."""
    return np.bincount(mesh["edges"][:, :2].reshape(-1), minlength=len(mesh["positions"]))


def digest(mesh: dict) -> str:
    """sha256 of the positions, springs and stiffness (first 16 hex digits):
    equal digests mean equal systems."""
    h = hashlib.sha256()
    for k in ("positions", "springs", "stiffness"):
        h.update(np.ascontiguousarray(mesh[k]).tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", type=int)
    ap.add_argument("--hub-radius", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    m = irregular_cloth(args.side, args.hub_radius, args.seed)
    deg = degrees(m)
    hub = hub_vertex(m)
    mesh_deg = mesh_degrees(m)
    print(f"N={len(deg)} faces={len(m['faces'])} edges={len(m['edges'])} "
          f"springs={len(m['springs'])} mesh degree {mesh_deg.min()}-{mesh_deg.max()} "
          f"(mean {mesh_deg.mean():.2f}, hub {hub}: {mesh_deg[hub]}) ELL width {deg.max()} "
          f"digest {digest(m)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
