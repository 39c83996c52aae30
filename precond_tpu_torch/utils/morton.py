"""63-bit Morton (Z-order) encoding and spatial sort (port of ``precond_tpu/utils/morton.py``).

Reproduces the reference bit-interleave exactly (SeMorton64::Encode /
ExpandBits, SeMorton.h:75-101): each axis is clamped to [0, 2^21-1] after
scaling by 2^21, expanded by inserting two zeros after every bit, and
interleaved as (x<<2) + (y<<1) + z. The 63-bit key fits one int64, so one
stable sort gives the order the JAX package gets from its two-pass
(hi, lo) uint32 sort. ``encode_np`` gives the same keys as uint64 for
NumPy input (host setup and the native bridge's fallback).
"""

from __future__ import annotations

import numpy as np
import torch

PRECISION_BITS = 21  # per axis; 3*21 = 63-bit keys (SeMorton.h:59)

# ExpandBits masks (SeMorton.h:94-101) restricted to the low 63 bits: the
# expanded 21-bit value never reaches bit 63, and int64 cannot hold it.
_LOW63 = (1 << 63) - 1
_MASKS = tuple(
    m & _LOW63
    for m in (0xFFFF00000000FFFF, 0x00FF0000FF0000FF, 0xF00F00F00F00F00F,
              0x30C30C30C30C30C3, 0x9249249249249249)
)


def _expand_bits(bits: torch.Tensor) -> torch.Tensor:
    """Insert two zeros after each of the low 21 bits of an int64 tensor."""
    for shift, mask in zip((32, 16, 8, 4, 2), _MASKS):
        bits = (bits | (bits << shift)) & mask
    return bits


def encode(unit_pos: torch.Tensor) -> torch.Tensor:
    """Morton keys (int64) for points in the unit cube. f32[N,3] -> i64[N].

    The f32 scale, clip and truncation follow the JAX encoder's order
    (morton.py:77-78), so the keys agree bit for bit."""
    scale = float(1 << PRECISION_BITS)
    q = torch.clamp(unit_pos * scale, 0.0, scale - 1.0).to(torch.int64)
    xx = _expand_bits(q[..., 0])
    yy = _expand_bits(q[..., 1])
    zz = _expand_bits(q[..., 2])
    return (xx << 2) + (yy << 1) + zz


def encode_np(unit_pos: np.ndarray) -> np.ndarray:
    """``encode`` for a NumPy array, on the host, as uint64. [N,3] -> [N]."""
    return encode(torch.from_numpy(np.ascontiguousarray(unit_pos))).numpy().astype(np.uint64)


def argsort_morton(unit_pos: torch.Tensor) -> torch.Tensor:
    """Permutation sorting vertices by Morton key (stable), on the tensor's device."""
    return torch.sort(encode(unit_pos), stable=True).indices


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """original->sorted map from sorted->original map (cpp:245-255)."""
    n = perm.shape[0]
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return inv
