"""Dense batched 96x96 matvec on the card (kernels ``csrc/symv.cu``,
``csrc/symv_bf16.cu``).

Replaces the JAX package's Pallas ``batched_symv`` (ops/pallas/symv.py)
and, for a bf16 table (``SchwarzConfig.inverse_dtype="bfloat16"``), its
dense bf16 einsum (``apply_block_inverse`` / ``dense_symv_cm``): an f32
table launches ``symv96``, a bf16 table ``symv96_bf16``, which rounds the
rhs to bf16 and accumulates in f32. The plain version is
``ops.batched_inverse.apply_block_inverse`` (an einsum): the wrapper takes
it for CPU tensors only; for a CUDA tensor it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..batched_inverse import apply_block_inverse
from . import _lib

DOF = 96
_KERNEL_OF = {torch.float32: "symv96", torch.bfloat16: "symv96_bf16"}


def batched_symv(inv96: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """[B,96,96] f32 or bf16, [B,96] f32 -> [B,96] f32.

    A bf16 table must be symmetric, bit for bit: ``symv96_bf16`` reads only
    its lower triangle and diagonal, so what lies above the diagonal is
    never used. Every bf16 table the port makes is so (``_factorize``'s
    rounding of a symmetric inverse, ``cm_permute96``, ``convert`` and the
    checkpoint loaders); ``utils.guards.validate_apply_state`` flags an
    asymmetric one under ``debug_checks``. Its base must be 16-byte aligned
    (the kernel copies 16-byte chunks), else ValueError.
    """
    if inv96.device.type == "cpu" and rhs.device.type == "cpu":
        return apply_block_inverse(inv96, rhs)
    name = _KERNEL_OF.get(inv96.dtype)
    if name is None:
        raise ValueError(f"batched_symv: no kernel for a {inv96.dtype} table "
                         "(float32 or bfloat16)")
    b = inv96.shape[0]
    _lib.check_operand(name, inv96, (b, DOF, DOF), "inv96", inv96.device, inv96.dtype)
    _lib.check_operand(name, rhs, (b, DOF), "rhs", inv96.device)
    if name == "symv96_bf16" and inv96.data_ptr() % 16:
        raise ValueError(f"{name}: inv96 must be 16-byte aligned (the kernel copies "
                         "16-byte chunks of each row)")
    z = torch.empty_like(rhs)
    _lib.launch(name, inv96.device, inv96.data_ptr(), rhs.data_ptr(), z.data_ptr(), b)
    return z


def bf16_grid(device=None) -> tuple:
    """(thread blocks, blocks per SM) of ``symv96_bf16``'s persistent grid on
    `device`: each thread block takes one table at a time, so B = blocks
    fills one round. Launches nothing."""
    lib = _lib.load()
    grid, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        code = lib.symv96_bf16_grid(ctypes.byref(grid), ctypes.byref(per_sm))
    if code != 0:
        raise RuntimeError(f"symv96_bf16_grid failed: cudaError_t {code}")
    return grid.value, per_sm.value
