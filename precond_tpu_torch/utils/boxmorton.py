"""Analytic spatial sort for power-of-two vertex boxes (port of ``precond_tpu/utils/boxmorton.py``).

3-D sibling of utils/gridmorton.py: a bank is a 4x4x2 vertex tile (= 32
nodes) and tiles are ranked by a round-robin bit interleave of their
(ti, tj, tk) coordinates, so every 32-rank group at every level is a
product of dyadic intervals — a contiguous box. The 5-tet cube
decomposition (models/tetmesh.py) contains all 12 cube edges, so axis
neighbours are always adjacent and every box of vertices is connected:
every bank at every level is one cluster and the hierarchy is the
arithmetic one (ops/gridapply.py).

The maps are built on the host with NumPy, as the JAX package builds them
(bitwise equal int32 maps). The JAX package crosses between box order and
sorted order with reshapes, a transpose and a tile gather; here each
crossing is one gather with a precomputed index, the same values bit for
bit.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

TILE = (4, 4, 2)  # (i, j, k) extents; 32 vertices = one Schwarz bank


def _is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def supported(nx: int, ny: int, nz: int) -> bool:
    """True when the analytic order applies (power-of-two sides of at least a tile)."""
    return (all(_is_pow2(d) for d in (nx, ny, nz))
            and nx >= TILE[0] and ny >= TILE[1] and nz >= TILE[2])


def _tile_rank(dims_t) -> np.ndarray:
    """Round-robin bit interleave of tile coords -> rank, row-major input.

    In round r, the r-th bit of each dimension that still has bits is
    appended (order i, j, k). Any fixed interleave gives nested dyadic
    boxes; round-robin keeps them near-cubical.
    """
    nti, ntj, ntk = dims_t
    ti, tj, tk = np.meshgrid(np.arange(nti), np.arange(ntj), np.arange(ntk), indexing="ij")
    bits = [nti.bit_length() - 1, ntj.bit_length() - 1, ntk.bit_length() - 1]
    coords = [ti.astype(np.uint64), tj.astype(np.uint64), tk.astype(np.uint64)]
    rank = np.zeros_like(coords[0])
    out_bit = 0
    for r in range(max(bits) if bits else 0):
        for d in range(3):
            if r < bits[d]:
                rank |= ((coords[d] >> np.uint64(r)) & np.uint64(1)) << np.uint64(out_bit)
                out_bit += 1
    return rank.reshape(-1).astype(np.int64)  # row-major tile index -> rank


@functools.lru_cache(maxsize=8)
def _sort_maps_cached(nx: int, ny: int, nz: int) -> Tuple[np.ndarray, np.ndarray]:
    if not supported(nx, ny, nz):
        raise ValueError(f"no analytic tile order for a {(nx, ny, nz)} box")
    t = (nx // TILE[0], ny // TILE[1], nz // TILE[2])
    rank = _tile_rank(t)
    r2t = np.empty_like(rank)
    r2t[rank] = np.arange(rank.size)
    ti = r2t // (t[1] * t[2])
    tj = (r2t // t[2]) % t[1]
    tk = r2t % t[2]
    wi, wj, wk = np.meshgrid(np.arange(TILE[0]), np.arange(TILE[1]), np.arange(TILE[2]),
                             indexing="ij")
    i = ti[:, None, None, None] * TILE[0] + wi[None]
    j = tj[:, None, None, None] * TILE[1] + wj[None]
    k = tk[:, None, None, None] * TILE[2] + wk[None]
    s2o = ((i * ny + j) * nz + k).reshape(-1).astype(np.int32)
    o2s = np.empty_like(s2o)
    o2s[s2o] = np.arange(s2o.size, dtype=np.int32)
    s2o.flags.writeable = False
    o2s.flags.writeable = False
    return s2o, o2s


def sort_maps(nx: int, ny: int, nz: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted_to_orig, orig_to_sorted) np.int32 for an (nx, ny, nz) box."""
    s2o, o2s = _sort_maps_cached(nx, ny, nz)
    return s2o.copy(), o2s.copy()


@functools.lru_cache(maxsize=16)
def _index_on(inverse: bool, dims: Tuple[int, int, int], device: str) -> torch.Tensor:
    """One crossing's int64 gather index, uploaded once per device."""
    host = _sort_maps_cached(*dims)[1 if inverse else 0]
    return torch.as_tensor(np.asarray(host, np.int64), device=device)


def sort_index(dims, inverse: bool = False, device=None) -> torch.Tensor:
    """The crossing's gather index as an int64 tensor on `device` (the card
    unless the caller asks for the CPU): sorted_to_orig, or orig_to_sorted
    with inverse=True."""
    dims = tuple(int(v) for v in dims)
    return _index_on(inverse, dims, str(resolve_device(device))).clone()


def _cross(x: torch.Tensor, dims, inverse: bool) -> torch.Tensor:
    dims = tuple(int(v) for v in dims)
    if x.shape[0] != dims[0] * dims[1] * dims[2]:
        raise ValueError(f"crossing of a {dims} box needs {np.prod(dims)} rows, "
                         f"got shape {tuple(x.shape)}")
    return x[_index_on(inverse, dims, str(x.device))]


def box_to_morton(x: torch.Tensor, nx: int, ny: int, nz: int) -> torch.Tensor:
    """[N, ...] row-major box order -> tile order (one gather)."""
    return _cross(x, (nx, ny, nz), inverse=False)


def morton_to_box(x: torch.Tensor, nx: int, ny: int, nz: int) -> torch.Tensor:
    """Inverse of box_to_morton."""
    return _cross(x, (nx, ny, nz), inverse=True)
