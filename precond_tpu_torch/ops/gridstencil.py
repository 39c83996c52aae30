"""Stencil-form block SpMV for structured grids (port of ``precond_tpu/ops/gridstencil.py``).

On a structured cloth grid every nonzero block of H lies at one of a dozen
constant (di, dj) grid offsets, so y = H x needs no index arrays: each
direction is a shifted window of x times a plane of 3x3 blocks. Blocks are
stored VERTEX-MINOR (diag_t [3,3,N], dirs_t [D,3,3,N]) as in the JAX
package, so the planes are read with unit stride.

On the card the full-plane product is one hand-written kernel, K4
(ops/cuda/stencil_spmv.py); `spmv_t_plain` is its plain version, which the
CPU takes. The symmetric half-storage form (sym=True) is plain PyTorch on
every device, as the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


class StencilSystem:
    """Block system matrix of a structured (nx, ny) grid in stencil form.

    y^T = diag_t . x^T + sum_d dirs_t[d] . shifted(x)^T, everything
    vertex-minor. ``offsets`` are grid displacements (di, dj);
    ``dirs_t[d,:,:,v]`` is zero where v + offset_d falls off the grid.

    ``sym=True`` stores only the canonical half of the directions (one
    plane per spring class); each block is symmetric and H[u,v] = H[v,u],
    so the SpMV applies a plane to both endpoints.
    """

    def __init__(self, diag_t: torch.Tensor, dirs_t: torch.Tensor,
                 offsets: Tuple[Tuple[int, int], ...], grid: Tuple[int, int],
                 sym: bool = False):
        self.diag_t = diag_t    # f32[3,3,N]
        self.dirs_t = dirs_t    # f32[D,3,3,N]
        self.offsets = tuple(tuple(int(v) for v in o) for o in offsets)
        self.grid = tuple(int(v) for v in grid)
        self.sym = bool(sym)

    @property
    def num_verts(self) -> int:
        return self.diag_t.shape[-1]

    @property
    def diag(self) -> torch.Tensor:
        """[N,3,3] view (compat accessor for tests/tools)."""
        return self.diag_t.permute(2, 0, 1)

    @property
    def device(self) -> torch.device:
        return self.diag_t.device

    def to(self, device) -> "StencilSystem":
        return StencilSystem(self.diag_t.to(device), self.dirs_t.to(device), self.offsets,
                             self.grid, sym=self.sym)


def _pad_width(offsets) -> int:
    return max(max(abs(di), abs(dj)) for di, dj in offsets) if offsets else 0


def _bmv(blocks: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-vertex 3x3 matvec over vertex-minor planes: [3,3,N], [3,N] -> [3,N]."""
    return (blocks * v[None, :, :]).sum(dim=1)


def spmv(sys: StencilSystem, x: torch.Tensor) -> torch.Tensor:
    """y = H x for x f32[N,3] in grid (row-major) vertex order.

    The [N,3] <-> [3,N] transposes stay outside the product, as in the JAX
    package's spmv_system."""
    return spmv_t(sys, x.T.contiguous()).T


def spmv_t(sys: StencilSystem, xt: torch.Tensor) -> torch.Tensor:
    """y^T = H x for x^T f32[3,N]: the component-major core of spmv.

    Full-plane systems: K4 on CUDA tensors (launched or raising), the plain
    version on CPU tensors. sym=True: plain PyTorch everywhere."""
    if not sys.sym:
        from .cuda.stencil_spmv import stencil_spmv

        return stencil_spmv(sys.diag_t, sys.dirs_t, xt, sys.offsets, sys.grid)
    return _spmv_t_sym(sys, xt)


def spmv_t_plain(diag_t: torch.Tensor, dirs_t: torch.Tensor, xt: torch.Tensor,
                 offsets, grid) -> torch.Tensor:
    """Plain version of K4: the full-plane branch of the JAX spmv_t.

    x is zero-padded in 2-D, so an off-grid neighbour contributes nothing
    whatever its direction block holds."""
    nx, ny = grid
    pad = _pad_width(offsets)
    xp = F.pad(xt.reshape(3, nx, ny), (pad, pad, pad, pad))
    yt = _bmv(diag_t, xt)
    for d, (di, dj) in enumerate(offsets):
        w = xp[:, pad + di: pad + di + nx, pad + dj: pad + dj + ny].reshape(3, -1)
        yt = yt + _bmv(dirs_t[d], w)
    return yt


def _spmv_t_sym(sys: StencilSystem, xt: torch.Tensor) -> torch.Tensor:
    """Symmetric half-storage: per canonical plane S_d apply both couplings,
    y[v] += S_d[v] x[v+d] and y[v+d] += S_d[v] x[v]."""
    nx, ny = sys.grid
    pad = _pad_width(sys.offsets)
    xp = F.pad(xt.reshape(3, nx, ny), (pad, pad, pad, pad))
    yt = _bmv(sys.diag_t, xt)
    for d, (di, dj) in enumerate(sys.offsets):
        w = xp[:, pad + di: pad + di + nx, pad + dj: pad + dj + ny].reshape(3, -1)
        yt = yt + _bmv(sys.dirs_t[d], w)
        tp = F.pad(_bmv(sys.dirs_t[d], xt).reshape(3, nx, ny), (pad, pad, pad, pad))
        yt = yt + tp[:, pad - di: pad - di + nx, pad - dj: pad - dj + ny].reshape(3, -1)
    return yt


def pin_vertices(sys: StencilSystem, pinned: torch.Tensor, big_diag: float) -> StencilSystem:
    """Decouple pinned rows/columns, exactly like the ELL path's pinning:
    zero every direction block with a pinned endpoint, set a big SPD mass
    diagonal on pinned vertices."""
    nx, ny = sys.grid
    pad = _pad_width(sys.offsets)
    pinned = pinned.to(device=sys.device, dtype=torch.bool)
    pg = F.pad(pinned.reshape(1, nx, ny).to(torch.uint8), (pad, pad, pad, pad))[0].bool()
    masks = []
    for di, dj in sys.offsets:
        src = pg[pad + di: pad + di + nx, pad + dj: pad + dj + ny].reshape(-1)
        masks.append(~(pinned | src))
    dirs_t = sys.dirs_t * torch.stack(masks).to(sys.dirs_t.dtype)[:, None, None, :]
    eye = torch.eye(3, dtype=sys.diag_t.dtype, device=sys.device)
    diag_t = torch.where(pinned[None, None, :], big_diag * eye[:, :, None], sys.diag_t)
    return StencilSystem(diag_t, dirs_t, sys.offsets, sys.grid, sym=sys.sym)
