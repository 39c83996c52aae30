"""Batched 96x96 SPD inverse on the card (kernel ``csrc/spd_inverse.cu``).

Replaces the JAX package's Pallas ``invert_spd_blocks_chol_panel`` and
``invert_spd_blocks_chol`` (ops/pallas/chol_inverse.py), with the repair
of non-finite blocks that the JAX solver runs after them fused into the
kernel's epilogue. The plain version beside it is
``ops.batched_inverse.invert_spd_blocks_panel`` (which repairs through
``_repair_nonfinite``): the wrapper takes it for CPU tensors only; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..batched_inverse import invert_spd_blocks_panel
from . import _lib

DOF = 96


def spd_inverse(h96: torch.Tensor, repair: bool = True) -> torch.Tensor:
    """[B,96,96] SPD -> [B,96,96] bitwise-symmetric PSD inverses.

    repair=True replaces a block whose inverse holds a non-finite value
    with the identity (on the card inside the kernel, one launch);
    debug prepares turn it off.
    """
    if h96.device.type == "cpu":
        return invert_spd_blocks_panel(h96, repair=repair)
    b = h96.shape[0]
    _lib.check_operand("spd_inverse96", h96, (b, DOF, DOF), "h96", h96.device)
    if h96.data_ptr() % 16:
        raise ValueError("spd_inverse96: h96 must start on a 16-byte boundary")
    out = torch.empty_like(h96)
    _lib.launch("spd_inverse96", h96.device, h96.data_ptr(), out.data_ptr(), b, int(bool(repair)))
    return out


def occupancy(device=None) -> tuple:
    """(dynamic shared memory bytes per block, blocks per SM) of the kernel
    on `device`, as the CUDA runtime fits it; launches nothing."""
    lib = _lib.load()
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        code = lib.spd_inverse96_occupancy(ctypes.byref(smem), ctypes.byref(blocks))
    if code != 0:
        raise RuntimeError(f"spd_inverse96_occupancy failed: cudaError_t {code}")
    return smem.value, blocks.value
