"""Stencil-form block SpMV for structured 3-D boxes (port of ``precond_tpu/ops/boxstencil.py``).

3-D sibling of ops/gridstencil.py: on a structured tet box every nonzero
block sits at one of 26 constant (di, dj, dk) offsets, so H x needs no
gathers — one padded copy of x and a static window slice per direction.
The planes are extracted from an assembled block-ELL in one streaming pass
(ELL column ids differ from the row id by a constant row-major stride per
direction), so any ELL producer gets the stencil SpMV.

Plain PyTorch on every device: the JAX package computes it with XLA
einsums, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .blockcsr import BlockEll
from .gridstencil import _bmv


class BoxStencilSystem:
    """y^T = diag_t . x^T + sum_d dirs_t[d] . shifted(x)^T, vertex-minor."""

    def __init__(self, diag_t: torch.Tensor, dirs_t: torch.Tensor,
                 offsets: Tuple[Tuple[int, int, int], ...], dims: Tuple[int, int, int]):
        self.diag_t = diag_t    # f32[3,3,N]
        self.dirs_t = dirs_t    # f32[D,3,3,N]
        self.offsets = tuple(tuple(int(v) for v in o) for o in offsets)
        self.dims = tuple(int(v) for v in dims)

    @property
    def num_verts(self) -> int:
        return self.diag_t.shape[-1]

    @property
    def diag(self) -> torch.Tensor:
        """[N,3,3] view."""
        return self.diag_t.permute(2, 0, 1)


BOX_OFFSETS: Tuple[Tuple[int, int, int], ...] = tuple(
    (di, dj, dk)
    for di in (-1, 0, 1) for dj in (-1, 0, 1) for dk in (-1, 0, 1)
    if (di, dj, dk) != (0, 0, 0)
)


def planes_from_ell(ell: BlockEll, dims: Tuple[int, int, int],
                    offsets: Tuple[Tuple[int, int, int], ...] = BOX_OFFSETS):
    """Extract row-major direction planes from a block-ELL on a box.

    plane_d[v] = sum_k blocks[v,k] where idx[v,k] - v equals the constant
    row-major stride of offset d — one masked reduce per direction (zero
    where the neighbour is absent or off-box; clamped ids can alias a stride
    across a j/k wrap, so validity is re-checked against true coordinates).
    Returns (diag f32[N,3,3], dirs f32[D,N,3,3]).
    """
    nx, ny, nz = dims
    n = nx * ny * nz
    if ell.num_verts != n:
        raise ValueError(f"a {tuple(dims)} box has {n} vertices, the system {ell.num_verts}")
    vid = torch.arange(n, dtype=torch.int32, device=ell.idx.device)
    vi = torch.div(vid, ny * nz, rounding_mode="floor")
    vj = torch.div(vid, nz, rounding_mode="floor") % ny
    vk = vid % nz
    delta = ell.idx.to(torch.int32) - vid[:, None]          # [N,K]
    planes = []
    for di, dj, dk in offsets:
        stride = di * ny * nz + dj * nz + dk
        inb = ((vi + di >= 0) & (vi + di < nx) & (vj + dj >= 0) & (vj + dj < ny)
               & (vk + dk >= 0) & (vk + dk < nz))
        sel = ell.mask & (delta == stride) & inb[:, None]
        planes.append(torch.sum(ell.blocks * sel[:, :, None, None].to(ell.blocks.dtype), dim=1))
    return ell.diag, torch.stack(planes)                    # [N,3,3], [D,N,3,3]


def from_ell(ell: BlockEll, dims: Tuple[int, int, int],
             offsets: Tuple[Tuple[int, int, int], ...] = BOX_OFFSETS) -> BoxStencilSystem:
    """Stencil system (vertex-minor layout for the SpMV) from a block-ELL."""
    n = dims[0] * dims[1] * dims[2]
    diag, dirs = planes_from_ell(ell, dims, offsets)
    diag_t = diag.reshape(n, 9).T.contiguous().reshape(3, 3, n)
    dirs_t = dirs.reshape(-1, n, 9).permute(0, 2, 1).contiguous().reshape(-1, 3, 3, n)
    return BoxStencilSystem(diag_t, dirs_t, offsets, dims)


def spmv(sys: BoxStencilSystem, x: torch.Tensor) -> torch.Tensor:
    """y = H x for x f32[N,3] in row-major box vertex order."""
    nx, ny, nz = sys.dims
    xt = x.T.contiguous()                                   # [3,N]
    xp = F.pad(xt.reshape(3, nx, ny, nz), (1, 1, 1, 1, 1, 1))
    yt = _bmv(sys.diag_t, xt)
    for d, (di, dj, dk) in enumerate(sys.offsets):
        w = xp[:, 1 + di: 1 + di + nx, 1 + dj: 1 + dj + ny, 1 + dk: 1 + dk + nz].reshape(3, -1)
        yt = yt + _bmv(sys.dirs_t[d], w)
    return yt.T
