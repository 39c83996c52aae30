"""Block-ELL SpMV of the general path on the card (kernel ``csrc/ell_spmv.cu``).

y = diag.x + sum over the valid slots of blocks.x[idx], reading only the
stored 3x3 blocks. It replaces no TPU kernel: the JAX package's ``spmv``
(ops/blockcsr.py) is a gather plus einsum. The plain version is
``ops.blockcsr.spmv_plain``: the wrapper takes it for CPU tensors only; for
a CUDA tensor it launches the kernel or raises.

The kernel skips masked slots, so what a padded slot's block and column id
hold never reaches y (the plain version multiplies the zero block that every
producer leaves there). The column id of every valid slot must lie in [0, N).
"""

from __future__ import annotations

import torch

from ..blockcsr import BlockEll, spmv_plain
from . import _lib


def ell_spmv(h: BlockEll, x: torch.Tensor) -> torch.Tensor:
    """y = H x for the BlockEll `h` and x f32[N,3] -> y f32[N,3]."""
    if h.diag.device.type == "cpu" and x.device.type == "cpu":
        return spmv_plain(h, x)
    n, k = h.idx.shape
    dev = h.diag.device if h.diag.device.type == "cuda" else x.device
    _lib.check_operand("ell_spmv", h.diag, (n, 3, 3), "diag", dev)
    _lib.check_operand("ell_spmv", h.idx, (n, k), "idx", dev, torch.int32)
    _lib.check_operand("ell_spmv", h.blocks, (n, k, 3, 3), "blocks", dev)
    _lib.check_operand("ell_spmv", h.mask, (n, k), "mask", dev, torch.bool)
    _lib.check_operand("ell_spmv", x, (n, 3), "x", dev)
    y = torch.empty_like(x)
    _lib.launch("ell_spmv", dev, h.diag.data_ptr(), h.idx.data_ptr(), h.blocks.data_ptr(),
                h.mask.data_ptr(), x.data_ptr(), y.data_ptr(), n, k)
    return y
