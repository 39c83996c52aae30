"""Fused stencil SpMV of a structured grid on the card (kernel ``csrc/stencil_spmv.cu``, K4).

Replaces the JAX package's Pallas ``spmv_pallas`` / ``spmv_system``
(ops/pallas/stencil_spmv.py): y = diag.x + sum_d dirs_d.x[v + offset_d]
over the vertex-minor planes of a full-plane ``StencilSystem``, x and y
component-major [3,N]. The plain version is
``ops.gridstencil.spmv_t_plain``: the wrapper takes it for CPU tensors
only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..gridstencil import spmv_t_plain
from . import _lib

MAX_OFFSETS = 32  # offsets travel by value in the kernel's parameters


def stencil_spmv(diag_t: torch.Tensor, dirs_t: torch.Tensor, xt: torch.Tensor,
                 offsets, grid) -> torch.Tensor:
    """y^T = H x^T: diag_t [3,3,N], dirs_t [D,3,3,N], xt [3,N] -> [3,N]."""
    if diag_t.device.type == "cpu":
        return spmv_t_plain(diag_t, dirs_t, xt, offsets, grid)
    nx, ny = (int(v) for v in grid)
    n, nd = nx * ny, len(offsets)
    if nd > MAX_OFFSETS:
        raise ValueError(f"stencil_spmv: at most {MAX_OFFSETS} offsets, got {nd}")
    dev = diag_t.device
    _lib.check_operand("stencil_spmv", diag_t, (3, 3, n), "diag_t", dev)
    _lib.check_operand("stencil_spmv", dirs_t, (nd, 3, 3, n), "dirs_t", dev)
    _lib.check_operand("stencil_spmv", xt, (3, n), "xt", dev)
    flat = [int(v) for o in offsets for v in o]
    offs = (ctypes.c_int * max(len(flat), 1))(*flat)
    y = torch.empty_like(xt)
    _lib.launch("stencil_spmv", dev, diag_t.data_ptr(), dirs_t.data_ptr(), xt.data_ptr(),
                y.data_ptr(), nx, ny, nd, offs)
    return y


def spmv_fused(diag_t: torch.Tensor, dirs_t: torch.Tensor, x: torch.Tensor,
               offsets, grid) -> torch.Tensor:
    """Counterpart of ``spmv_pallas``: x f32[N,3] in grid order -> y f32[N,3],
    the transposes outside the kernel."""
    return stencil_spmv(diag_t, dirs_t, x.T.contiguous(), offsets, grid).T


def spmv_system(sys, x: torch.Tensor) -> torch.Tensor:
    """Counterpart of ``spmv_system``: drop-in for gridstencil.spmv on
    full-plane systems (sym=False)."""
    if sys.sym:
        raise ValueError("the fused stencil SpMV implements the full-plane form (sym=False)")
    return spmv_fused(sys.diag_t, sys.dirs_t, x, sys.offsets, sys.grid)
