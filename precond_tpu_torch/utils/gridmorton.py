"""Analytic spatial sort for power-of-two square grids (port of ``precond_tpu/utils/gridmorton.py``).

For a 2^k x 2^k grid the order is defined analytically:

    bank   = Morton rank of the vertex's 8x4 grid tile
    lane   = row-major index within the tile

so every 32-vertex bank is one compact tile and the Schwarz hierarchy over
it is arithmetic (ops/gridapply.py). The maps are built on the host with
NumPy, exactly as the JAX package builds them (bitwise equal int32 maps).

Each crossing between grid order and sorted order is a fixed permutation.
The JAX package spells it as reshapes, transposes and a bank gather (rows)
or a patch transpose, a patch gather and a one-hot [1024,1024] selector
matmul (component-major); here every crossing is ONE gather with a
precomputed index, the same values bit for bit. The comp-major index is
derived from the patch factorization itself, so the factorization is
checked against the JAX functions too. The JAX package's selector-matmul
forms (`grid_to_morton_mm`, `morton_to_grid_mm`) are TPU alternates that
its `crossing_pair` never picks; they are not ported.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

TILE_I, TILE_J = 8, 4  # 32 vertices per tile = one Schwarz bank
_PATCH = 32            # 4x8 tiles = 32 banks = 1024 vertices per patch


def _is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def supported(nx: int, ny: int) -> bool:
    """True when the analytic order applies (square power-of-two, >= 8x4)."""
    return nx == ny and _is_pow2(nx) and nx >= TILE_I


def _tile_rank(k: int) -> np.ndarray:
    """Morton-style rank of each 8x4 tile, row-major tile index -> rank.

    Tiles form a (2^(k-3), 2^(k-2)) grid: interleave ti with the high bits
    of tj and keep tj's lowest bit as the LSB (pairs of horizontally
    adjacent tiles stay together -> 8x8 supertiles, then Z-curve).
    """
    nti, ntj = 1 << (k - 3), 1 << (k - 2)
    ti, tj = np.meshgrid(np.arange(nti), np.arange(ntj), indexing="ij")
    hi = tj >> 1

    def spread(b):
        out = np.zeros_like(b, dtype=np.uint64)
        for t in range(k - 3):
            out |= ((b.astype(np.uint64) >> t) & 1) << (2 * t)
        return out

    rank = ((2 * spread(ti) + spread(hi)) << 1) | (tj & 1).astype(np.uint64)
    return rank.reshape(-1).astype(np.int64)          # [T]


def _rank_to_tile(k: int) -> np.ndarray:
    rank = _tile_rank(k)
    out = np.empty_like(rank)
    out[rank] = np.arange(rank.size)
    return out                                        # [T] rank -> tile


@functools.lru_cache(maxsize=8)
def _sort_maps_cached(k: int) -> Tuple[np.ndarray, np.ndarray]:
    n = 1 << k
    r2t = _rank_to_tile(k)                            # [T]
    ti, tj = r2t // (n // TILE_J), r2t % (n // TILE_J)
    wi, wj = np.meshgrid(np.arange(TILE_I), np.arange(TILE_J), indexing="ij")
    i = ti[:, None, None] * TILE_I + wi[None]
    j = tj[:, None, None] * TILE_J + wj[None]
    s2o = (i * n + j).reshape(-1).astype(np.int32)
    o2s = np.empty_like(s2o)
    o2s[s2o] = np.arange(s2o.size, dtype=np.int32)
    s2o.flags.writeable = False
    o2s.flags.writeable = False
    return s2o, o2s


def sort_maps(k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted_to_orig, orig_to_sorted) np.int32 for a 2^k square grid."""
    s2o, o2s = _sort_maps_cached(k)
    return s2o.copy(), o2s.copy()


# ---- patch factorization --------------------------------------------------
# The analytic order factors exactly as "Morton over 32x32 grid patches,
# fixed 1024-permutation within each patch" (see the JAX module): a patch
# transpose, a gather of N/1024 patch rows and one fixed in-patch
# permutation. The JAX package applies the last one as a one-hot selector
# matmul; here the three compose into the crossing's gather index.

@functools.lru_cache(maxsize=1)
def _patch_perm() -> np.ndarray:
    """perm[1024]: bank-flat position p holds patch-local grid index perm[p]."""
    i, j = np.meshgrid(np.arange(_PATCH), np.arange(_PATCH), indexing="ij")
    ti, tj = i >> 3, j >> 2
    lane = (i & 7) * TILE_J + (j & 3)
    sp2 = lambda t: (t & 1) + ((t >> 1) & 1) * 4  # noqa: E731
    bank = ((2 * sp2(ti) + sp2(tj >> 1)) << 1) | (tj & 1)
    perm = np.empty(_PATCH * _PATCH, np.int64)
    perm[(bank * 32 + lane).ravel()] = (i * _PATCH + j).ravel()
    return perm


@functools.lru_cache(maxsize=8)
def _patch_rank(k: int) -> np.ndarray:
    """Morton rank of each 32x32 patch, row-major patch index -> rank."""
    m = 1 << (k - 5)
    a, b = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")

    def spread(t):
        out = np.zeros_like(t, dtype=np.uint64)
        for q in range(max(k - 5, 1)):
            out |= ((t.astype(np.uint64) >> q) & 1) << (2 * q)
        return out

    return (2 * spread(a) + spread(b)).reshape(-1).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _rank_to_patch(k: int) -> np.ndarray:
    r = _patch_rank(k)
    out = np.empty_like(r)
    out[r] = np.arange(r.size)
    return out


@functools.lru_cache(maxsize=8)
def _patch_index(k: int) -> np.ndarray:
    """Grid-flat source of each sorted slot, through the patch factorization:
    patch transpose -> patch gather by rank -> in-patch permutation."""
    if k < 5:
        raise ValueError("the patch crossing needs a >= 32x32 grid")
    n = 1 << k
    m = n // _PATCH
    tiles = (
        np.arange(4**k, dtype=np.int64)
        .reshape(m, _PATCH, m, _PATCH)
        .transpose(0, 2, 1, 3)
        .reshape(m * m, _PATCH * _PATCH)
    )
    return tiles[_rank_to_patch(k)][:, _patch_perm()].reshape(-1)


# ---- crossings: one gather each -----------------------------------------

@functools.lru_cache(maxsize=16)
def _index_on(kind: str, k: int, device: str) -> torch.Tensor:
    """One crossing's int64 gather index, uploaded once per device."""
    if kind == "g2m":
        host = _sort_maps_cached(k)[0]
    elif kind == "m2g":
        host = _sort_maps_cached(k)[1]
    elif kind == "g2m_patch":
        host = _patch_index(k)
    else:  # "m2g_patch": the inverse permutation
        fwd = _patch_index(k)
        host = np.empty_like(fwd)
        host[fwd] = np.arange(fwd.size)
    return torch.as_tensor(np.asarray(host, np.int64), device=device)


def _index(kind: str, k: int, device) -> torch.Tensor:
    return _index_on(kind, k, str(device))


def sort_index(k: int, inverse: bool = False, device=None) -> torch.Tensor:
    """The crossing's gather index as an int64 tensor on `device` (the card
    unless the caller asks for the CPU): sorted_to_orig, or orig_to_sorted
    with inverse=True."""
    return _index("m2g" if inverse else "g2m", k, resolve_device(device)).clone()


def _check_rows(x: torch.Tensor, k: int, axis: int) -> None:
    if x.shape[axis] != 4**k:
        raise ValueError(f"crossing at k={k} needs {4**k} vertices on axis {axis}, "
                         f"got shape {tuple(x.shape)}")


def grid_to_morton(x: torch.Tensor, k: int) -> torch.Tensor:
    """[4^k, ...] row-major -> analytic sorted order."""
    _check_rows(x, k, 0)
    return x[_index("g2m", k, x.device)]


def morton_to_grid(x: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of grid_to_morton."""
    _check_rows(x, k, 0)
    return x[_index("m2g", k, x.device)]


def crossing_pair(k: int):
    """(grid_to_morton, morton_to_grid) for iteration vectors at 2^k.

    The JAX package's selector-matmul pair is switched off
    (``_MM_MAX_K = -1``), so this is always the streaming pair."""
    return grid_to_morton, morton_to_grid


def grid_to_morton_patch(x: torch.Tensor, k: int) -> torch.Tensor:
    """grid_to_morton through the patch factorization (the same values)."""
    _check_rows(x, k, 0)
    return x[_index("g2m_patch", k, x.device)]


def morton_to_grid_patch(x: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of grid_to_morton_patch."""
    _check_rows(x, k, 0)
    return x[_index("m2g_patch", k, x.device)]


def grid_to_morton_cm(xt: torch.Tensor, k: int) -> torch.Tensor:
    """Component-major crossing: [w, 4^k] grid-flat -> [w, 4^k] sorted.

    The comp-major solve path's crossing; the index is the patch
    factorization's (k >= 5)."""
    _check_rows(xt, k, 1)
    return xt[:, _index("g2m_patch", k, xt.device)]


def morton_to_grid_cm(xt: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of grid_to_morton_cm."""
    _check_rows(xt, k, 1)
    return xt[:, _index("m2g_patch", k, xt.device)]
