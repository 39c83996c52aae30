"""Irregular Delaunay cloth: a frozen copy of ``scripts/torch_irregular_mesh.py``'s recipe.

An s x s lattice jittered uniformly by +-`jitter` spacings
(``numpy.random.default_rng(mesh_seed)``), scaled to the unit square by the
larger extent, z = z_wave sin(7.3 x) cos(5.1 y); ``scipy.spatial.Delaunay``
triangles, each rotated to start at its smallest vertex and the list
sorted (independent of Qhull's output order); every mesh edge a spring at
k_struct, and each interior edge's pair of opposite vertices a bend spring
at k_bend unless the pair is already a spring. The hub variant of the
recipe is not used by any configuration and is left out.
"""

from __future__ import annotations

import numpy as np

from .grid import _edges


def build(p: dict) -> dict:
    side = int(p["side"])
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    lattice = np.stack([ii, jj], -1).reshape(-1, 2).astype(np.float64)
    rng = np.random.default_rng(int(p["mesh_seed"]))
    jitter = float(p["jitter"])
    xy = lattice + rng.uniform(-jitter, jitter, lattice.shape)
    lo = xy.min(axis=0)
    extent = (xy.max(axis=0) - lo).max()
    xy = (xy - lo) / extent
    z = float(p["z_wave"]) * np.sin(xy[:, 0] * 7.3) * np.cos(xy[:, 1] * 5.1)
    pos = np.concatenate([xy, z[:, None]], 1)

    from scipy.spatial import Delaunay

    f = Delaunay(xy).simplices.astype(np.int64)
    roll = np.argmin(f, axis=1)
    f = np.take_along_axis(f, (roll[:, None] + np.arange(3)) % 3, axis=1)
    faces = f[np.lexsort(f.T[::-1])].astype(np.int32)
    n = len(pos)
    edges = _edges(faces, n)

    struct = edges[:, :2].astype(np.int64)
    inner = edges[edges[:, 3] >= 0]
    a, b = inner[:, 2].astype(np.int64), inner[:, 3].astype(np.int64)
    bend_key = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
    bend_key = bend_key[~np.isin(bend_key, struct[:, 0] * n + struct[:, 1])]
    bend = np.stack([bend_key // n, bend_key % n], 1)
    return dict(
        positions=pos.astype(np.float32),
        edges=edges,
        faces=faces,
        springs=np.concatenate([struct, bend]).astype(np.int32),
        stiffness=np.concatenate([np.full(len(struct), p["k_struct"], np.float32),
                                  np.full(len(bend), p["k_bend"], np.float32)]),
        spacing=np.float64(1.0 / extent),
        grid=np.zeros(0, np.int64),
    )
