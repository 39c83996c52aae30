"""3x3-block sparse system matrix in ELL layout (port of ``precond_tpu/ops/blockcsr.py``).

The reference consumes a 3x3-block CSR (SeSchwarzPreconditioner.h:51,59);
the port keeps the JAX package's ELL form, every row padded to the max
degree K:

    idx    i32[N, K]        column (vertex) index per slot; padded slots -> own row
    blocks f32[N, K, 3, 3]  off-diagonal 3x3 blocks; padded slots -> 0
    diag   f32[N, 3, 3]     diagonal blocks
    mask   bool[N, K]       valid-slot mask

SpMV y = H x: on the card the hand-written kernel (ops/cuda/ell_spmv.py),
which reads only the valid slots; on the CPU its plain version, one row
gather plus two batched contractions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils.scatter import accumulate_rows


class BlockEll(NamedTuple):
    """Block-sparse symmetric system matrix H (3N x 3N), ELL layout."""

    diag: torch.Tensor    # f32[N, 3, 3]
    idx: torch.Tensor     # i32[N, K]
    blocks: torch.Tensor  # f32[N, K, 3, 3]
    mask: torch.Tensor    # bool[N, K]

    @property
    def num_verts(self) -> int:
        return self.diag.shape[0]

    @property
    def max_degree(self) -> int:
        return self.idx.shape[1]

    @property
    def nnz_blocks(self) -> torch.Tensor:
        """Number of stored 3x3 blocks (diagonal + valid off-diagonals)."""
        return self.num_verts + self.mask.sum()

    def to(self, device) -> "BlockEll":
        return BlockEll(*(t.to(device) for t in self))


def from_coo(
    num_verts: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    diag: np.ndarray,
    max_degree: Optional[int] = None,
    device=None,
) -> BlockEll:
    """Host-side packer: COO off-diagonal 3x3 blocks -> BlockEll on `device`.

    Duplicate (row, col) entries are summed. Rows/cols are the block (vertex)
    indices; `vals` is [M,3,3]; `diag` is [N,3,3].
    """
    from .. import native

    dev = resolve_device(device)
    idx, blocks, mask = native.coo_to_ell(
        num_verts, np.asarray(rows), np.asarray(cols), np.asarray(vals, np.float32), max_degree
    )
    return BlockEll(
        diag=torch.as_tensor(np.asarray(diag, np.float32), device=dev),
        idx=torch.as_tensor(idx, device=dev),
        blocks=torch.as_tensor(blocks, device=dev),
        mask=torch.as_tensor(mask, device=dev),
    )


def scatter_accumulate(size: int, tgt: torch.Tensor, vals: torch.Tensor,
                       unique: bool = False) -> torch.Tensor:
    """out[tgt[e]] += vals[e] into a zero [size, ...] array, as the JAX
    package's ``.at[tgt].add(mode="drop")``: a target in [-size, 0) counts
    from the end, any other target outside [0, size) is dropped. The
    placement is ``accumulate_rows`` (deterministic, never an atomic float
    add), with the dropped entries removed before it. `unique` is JAX's
    hint that no target repeats; it changes no result."""
    del unique
    vals = vals.reshape((-1,) + vals.shape[tgt.dim():])
    tgt = tgt.reshape(-1).long()
    tgt = torch.where(tgt < 0, tgt + size, tgt)
    out = vals.new_zeros((size,) + vals.shape[1:])
    accumulate_rows(out, tgt, vals, valid=torch.ones_like(tgt, dtype=torch.bool))
    return out


def spmv(h: BlockEll, x: torch.Tensor) -> torch.Tensor:
    """y = H x with x, y of shape [N, 3]: the kernel on CUDA tensors
    (launched or raising), the plain version on CPU tensors."""
    from .cuda.ell_spmv import ell_spmv

    return ell_spmv(h, x.contiguous())


def spmv_plain(h: BlockEll, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the ELL SpMV kernel: every slot, padded ones
    included, through a gather and two einsums."""
    xg = x[h.idx]                                               # [N, K, 3]
    off = torch.einsum("nkij,nkj->ni", h.blocks, xg)            # [N, 3]
    dia = torch.einsum("nij,nj->ni", h.diag, x)                 # [N, 3]
    return dia + off


def to_dense(h: BlockEll) -> torch.Tensor:
    """Dense 3N x 3N matrix (test oracle only)."""
    n, k = h.idx.shape
    ar = torch.arange(n, device=h.diag.device)
    dense = torch.zeros((n, n, 3, 3), dtype=h.diag.dtype, device=h.diag.device)
    dense[ar, ar] = h.diag
    vals = torch.where(h.mask[:, :, None, None], h.blocks, torch.zeros_like(h.blocks))
    dense.index_put_(
        (ar.repeat_interleave(k), h.idx.reshape(-1).long()), vals.reshape(-1, 3, 3),
        accumulate=True,
    )
    return dense.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)


def permute(h: BlockEll, sorted_to_orig: torch.Tensor, orig_to_sorted: torch.Tensor) -> BlockEll:
    """Symmetric permutation P H P^T into Morton-sorted vertex order.

    Mirrors MapHessianTable (cpp:258-285): row r of the result is original
    row sorted_to_orig[r] with column ids remapped through orig_to_sorted.
    """
    diag = h.diag[sorted_to_orig]
    idx = orig_to_sorted[h.idx[sorted_to_orig]]
    blocks = h.blocks[sorted_to_orig]
    mask = h.mask[sorted_to_orig]
    # Padded slots must keep pointing at their own (new) row.
    own = torch.arange(idx.shape[0], dtype=idx.dtype, device=idx.device)[:, None].expand_as(idx)
    idx = torch.where(mask, idx, own)
    return BlockEll(diag=diag, idx=idx, blocks=blocks, mask=mask)
