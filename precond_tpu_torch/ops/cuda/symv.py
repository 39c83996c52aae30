"""Dense batched 96x96 matvec on the card (kernel ``csrc/symv.cu``).

Replaces the JAX package's Pallas ``batched_symv`` (ops/pallas/symv.py)
and, for a bf16 table (``SchwarzConfig.inverse_dtype="bfloat16"``), its
dense bf16 einsum (``apply_block_inverse`` / ``dense_symv_cm``): an f32
table launches ``symv96``, a bf16 table ``symv96_bf16``, which rounds the
rhs to bf16 and accumulates in f32. The plain version is
``ops.batched_inverse.apply_block_inverse`` (an einsum): the wrapper takes
it for CPU tensors only; for a CUDA tensor it launches a kernel or raises.
"""

from __future__ import annotations

import torch

from ..batched_inverse import apply_block_inverse
from . import _lib

DOF = 96
_KERNEL_OF = {torch.float32: "symv96", torch.bfloat16: "symv96_bf16"}


def batched_symv(inv96: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """[B,96,96] f32 or bf16, [B,96] f32 -> [B,96] f32."""
    if inv96.device.type == "cpu" and rhs.device.type == "cpu":
        return apply_block_inverse(inv96, rhs)
    name = _KERNEL_OF.get(inv96.dtype)
    if name is None:
        raise ValueError(f"batched_symv: no kernel for a {inv96.dtype} table "
                         "(float32 or bfloat16)")
    b = inv96.shape[0]
    _lib.check_operand(name, inv96, (b, DOF, DOF), "inv96", inv96.device, inv96.dtype)
    _lib.check_operand(name, rhs, (b, DOF), "rhs", inv96.device)
    if inv96.data_ptr() % 4:
        raise ValueError(f"{name}: inv96 must be 4-byte aligned (the kernel reads element pairs)")
    z = torch.empty_like(rhs)
    _lib.launch(name, inv96.device, inv96.data_ptr(), rhs.data_ptr(), z.data_ptr(), b)
    return z
