"""ctypes bridge to the native host graph builder (native/graph_builder.cpp).

The port's own copy of ``precond_tpu/native.py``: it builds
``native/libprecond_host.so`` the same way (``make -C native``) on first use
and falls back to vectorized NumPy when the toolchain is unavailable. This
is host-side setup (COO->ELL packing, element adjacency, the host Morton
argsort), not device work.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libprecond_host.so")
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        # make no-ops when the .so is newer than the source and rebuilds
        # when graph_builder.cpp changed: a stale binary never shadows it.
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.CalledProcessError):
        return None
    i32p = ctypes.POINTER(ctypes.c_int)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    lib.coo_to_ell.restype = ctypes.c_int
    lib.coo_to_ell.argtypes = [ctypes.c_int, ctypes.c_longlong, i32p, i32p, f32p,
                               ctypes.c_int, i32p, f32p, u8p]
    lib.pairs_to_adjacency_ell.restype = ctypes.c_int
    lib.pairs_to_adjacency_ell.argtypes = [ctypes.c_int, ctypes.c_longlong, i32p, i32p,
                                           ctypes.c_int, i32p, u8p]
    lib.morton_argsort.restype = None
    lib.morton_argsort.argtypes = [ctypes.c_int, f32p, i32p]
    lib.elements_to_pairs.restype = ctypes.c_longlong
    lib.elements_to_pairs.argtypes = [ctypes.c_longlong, ctypes.c_int, i32p,
                                      ctypes.c_longlong, i32p, i32p]
    _lib = lib
    return _lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def have_native() -> bool:
    """Whether the native library built and loaded."""
    return _load() is not None


def coo_to_ell(
    n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    max_degree: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO 3x3 blocks -> (idx i32[n,K], blocks f32[n,K,3,3], mask bool[n,K])."""
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32).reshape(-1, 9)
    m = len(rows)

    # width estimate: exact unique count per row (vectorized)
    key = rows.astype(np.int64) * n + cols
    k_needed = int(np.bincount(np.unique(key) // n, minlength=n).max()) if m else 1
    k = max(max_degree if max_degree is not None else k_needed, k_needed, 1)

    lib = _load()
    if lib is not None:
        idx = np.empty((n, k), np.int32)
        blocks = np.empty((n, k, 9), np.float32)
        mask = np.empty((n, k), np.uint8)
        w = lib.coo_to_ell(n, m, _ptr(rows, ctypes.c_int), _ptr(cols, ctypes.c_int),
                           _ptr(vals, ctypes.c_float), k, _ptr(idx, ctypes.c_int),
                           _ptr(blocks, ctypes.c_float), _ptr(mask, ctypes.c_ubyte))
        if w < 0:
            raise RuntimeError("ELL width overflow")
        return idx, blocks.reshape(n, k, 3, 3), mask.astype(bool)

    # NumPy fallback (vectorized): coalesce then slot by rank within row.
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_mask = np.empty(m, bool)
    uniq_mask[:1] = True
    uniq_mask[1:] = key_s[1:] != key_s[:-1]
    starts = np.flatnonzero(uniq_mask)
    summed = np.add.reduceat(vals[order], starts, axis=0) if m else vals
    ukey = key_s[starts]
    urows = (ukey // n).astype(np.int64)
    ucols = (ukey % n).astype(np.int32)
    slot = np.arange(len(ukey)) - np.searchsorted(urows, urows, side="left")

    idx = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
    blocks = np.zeros((n, k, 9), np.float32)
    mask = np.zeros((n, k), bool)
    idx[urows, slot] = ucols
    blocks[urows, slot] = summed
    mask[urows, slot] = True
    return idx, blocks.reshape(n, k, 3, 3), mask


def morton_argsort(positions: np.ndarray) -> np.ndarray:
    """Host 63-bit Morton argsort of f32[N,3] positions, each axis scaled to
    the unit interval by its own extent (native; NumPy fallback). -> i32[N]."""
    positions = np.ascontiguousarray(positions, np.float32)
    n = len(positions)
    lib = _load()
    if lib is not None:
        perm = np.empty(n, np.int32)
        lib.morton_argsort(n, _ptr(positions, ctypes.c_float), _ptr(perm, ctypes.c_int))
        return perm
    from .utils.morton import encode_np

    lo = positions.min(0)
    ext = np.where(np.ptp(positions, 0) > 0, np.ptp(positions, 0), 1.0)
    return np.argsort(encode_np((positions - lo) / ext), kind="stable").astype(np.int32)


def elements_to_adjacency_ell(n: int, elems: np.ndarray,
                              max_degree: Optional[int] = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Element list i32[M,V] -> ELL adjacency (idx, mask), self excluded."""
    elems = np.ascontiguousarray(elems, np.int32)
    m, v = elems.shape
    lib = _load()
    if lib is not None:
        cap = m * v * (v - 1) // 2 + 1
        a = np.empty(cap, np.int32)
        b = np.empty(cap, np.int32)
        np_ = lib.elements_to_pairs(m, v, _ptr(elems, ctypes.c_int), cap,
                                    _ptr(a, ctypes.c_int), _ptr(b, ctypes.c_int))
        if np_ < 0:
            raise RuntimeError("element pair buffer overflow")
        a, b = a[:np_], b[:np_]
        deg = np.bincount(np.concatenate([a, b]), minlength=n)
        k = max(int(deg.max()) if np_ else 1, max_degree or 1, 1)
        idx = np.empty((n, k), np.int32)
        mask = np.empty((n, k), np.uint8)
        w = lib.pairs_to_adjacency_ell(n, np_, _ptr(a, ctypes.c_int), _ptr(b, ctypes.c_int),
                                       k, _ptr(idx, ctypes.c_int), _ptr(mask, ctypes.c_ubyte))
        if w < 0:
            raise RuntimeError("ELL width overflow")
        return idx, mask.astype(bool)

    ii = np.repeat(np.arange(v), v)
    jj = np.tile(np.arange(v), v)
    sel = ii != jj
    a = elems[:, ii[sel]].ravel()
    b = elems[:, jj[sel]].ravel()
    key = np.unique(a.astype(np.int64) * n + b)
    urows = (key // n).astype(np.int64)
    ucols = (key % n).astype(np.int32)
    slot = np.arange(len(key)) - np.searchsorted(urows, urows, side="left")
    k = max(int(slot.max()) + 1 if len(key) else 1, max_degree or 1, 1)
    idx = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
    mask = np.zeros((n, k), bool)
    idx[urows, slot] = ucols
    mask[urows, slot] = True
    return idx, mask
