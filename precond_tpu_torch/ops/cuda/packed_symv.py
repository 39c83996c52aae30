"""Packed-symmetric batched 96x96 symv (kernel ``csrc/packed_symv.cu``).

Replaces the JAX package's Pallas ``packed_symv_t`` (ops/pallas/packed_symv.py).
The reference stores each 96x96 domain inverse as 4704 packed floats and
applies it with a two-sided symv, every stored element used for both
A[i,j] and A[j,i] (LDLtInverse512 packing cpp:165,1349; SchwarzLocalXSym
cpp:1600-1696). The layout is the JAX package's PackedInverse, per block b:

  split A into 48x48 blocks  A = [[A11, A21^T], [A21, A22]]  (A11/A22 sym)

  F  f32[48, 96, Bp]  batch-minor:  F[i, c, b] =
      c < 48, i > c :  A11[i, c]        (strict lower of A11)
      c < 48, i < c :  A22[c, i]        (strict lower of A22, transposed up)
      c >= 48       :  A21[i, c - 48]   (the full off-diagonal block)
  dg f32[96, Bp]      the diagonal of A

  -> 48*96 + 96 = 4704 floats per block, the reference's exact count.

Batch-minor storage also suits the card: the kernel views F as a
[4608, Bp] matrix and streams boxes of 32 consecutive blocks b by TMA,
which needs Bp to be a multiple of 4 (a 16-byte pitch).

The plain version is ``packed_symv_ref`` (unpack to dense, einsum): the
kernel wrapper takes it for CPU tensors only; for a CUDA tensor it launches
the kernel or raises.

Component-major entry points (the grid path's comp-major solve,
ops/gridapply.precondition_grid_cm): the bank's 96 DOFs renumbered c*32+l
instead of l*3+c, so a [3,B,32] stack of component planes is the kernel's
native [96,Bp] rhs after one transpose. ``PackedInverseCM`` runs through
the same K2 kernel; ``DenseInverseCM`` stores the comp-major-permuted
[B,96,96] table and runs through K3 (ops/cuda/symv.py). The JAX package
keeps the dense table batch-minor [3,32,3,32,B] for a TPU's on-chip
memory; the function is the same. Both are types of their own, so a
comp-major table can never reach a row-major apply.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib
from .symv import batched_symv

DOF, HALF = 96, 48


class PackedInverse(NamedTuple):
    """Packed symmetric [B,96,96] batch, batch-minor (see module doc)."""

    f: torch.Tensor   # f32[48, 96, Bp]
    dg: torch.Tensor  # f32[96, Bp]
    nb: int           # true (unpadded) block count


class PackedInverseCM(NamedTuple):
    """PackedInverse of the comp-major-permuted blocks (DOF c*32+l)."""

    f: torch.Tensor   # f32[48, 96, Bp]
    dg: torch.Tensor  # f32[96, Bp]
    nb: int


class DenseInverseCM(NamedTuple):
    """Dense inverses in the comp-major DOF convention (DOF c*32+l)."""

    m: torch.Tensor   # f32[B, 96, 96]


def _tri_masks(device):
    i = torch.arange(HALF, device=device)[:, None]
    c = torch.arange(HALF, device=device)[None, :]
    return i > c, i < c


def pack_sym96(inv96: torch.Tensor, block_b: int = 256) -> PackedInverse:
    """[B,96,96] symmetric -> PackedInverse (B padded up to block_b)."""
    b = inv96.shape[0]
    bp = -(-b // block_b) * block_b
    a11 = inv96[:, :HALF, :HALF]
    a22 = inv96[:, HALF:, HALF:]
    a21 = inv96[:, HALF:, :HALF]
    low, up = _tri_masks(inv96.device)
    zero = torch.zeros((), dtype=inv96.dtype, device=inv96.device)
    t = torch.where(low[None], a11, torch.where(up[None], a22.transpose(1, 2), zero))
    f = torch.zeros((HALF, DOF, bp), dtype=inv96.dtype, device=inv96.device)
    f[:, :HALF, :b] = t.permute(1, 2, 0)
    f[:, HALF:, :b] = a21.permute(1, 2, 0)
    dg = torch.zeros((DOF, bp), dtype=inv96.dtype, device=inv96.device)
    dg[:, :b] = torch.diagonal(inv96, dim1=1, dim2=2).T
    return PackedInverse(f=f, dg=dg, nb=b)


def unpack_sym96(packed: PackedInverse, b: int) -> torch.Tensor:
    """The first b blocks of a PackedInverse as dense [b,96,96]."""
    f = packed.f.permute(2, 0, 1)                       # [Bp,48,96]
    dg = packed.dg.T                                    # [Bp,96]
    t, g = f[:b, :, :HALF], f[:b, :, HALF:]
    low, up = _tri_masks(f.device)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    a11 = torch.where(low[None], t, zero)
    a11 = a11 + a11.transpose(1, 2)
    sl22 = torch.where(up[None], t, zero).transpose(1, 2)
    a22 = sl22 + sl22.transpose(1, 2)
    top = torch.cat([a11, g.transpose(1, 2)], dim=2)
    bot = torch.cat([g, a22], dim=2)
    return torch.cat([top, bot], dim=1) + torch.diag_embed(dg[:b])


def packed_symv_ref(packed: PackedInverse, rhs: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack to dense and einsum. rhs [B,96] -> [B,96]."""
    return torch.einsum("bij,bj->bi", unpack_sym96(packed, rhs.shape[0]), rhs)


def packed_symv_t(packed: PackedInverse, xt: torch.Tensor) -> torch.Tensor:
    """z = A x per block from packed storage; [96,Bp] in, [96,Bp] out."""
    f, dg = packed.f, packed.dg
    bp = f.shape[2]
    if f.device.type == "cpu":
        return packed_symv_ref(packed, xt.T).T.contiguous()
    _lib.check_operand("packed_symv96", f, (HALF, DOF, bp), "f", f.device)
    _lib.check_operand("packed_symv96", dg, (DOF, bp), "dg", f.device)
    _lib.check_operand("packed_symv96", xt, (DOF, bp), "xt", f.device)
    # the kernel reads F, dg and x by TMA: 16-byte-aligned bases and pitches
    if bp % 4:
        raise ValueError(f"packed_symv96: Bp = {bp} must be a multiple of 4 "
                         "(pack_sym96 pads to its block_b)")
    for t, what in ((f, "f"), (dg, "dg"), (xt, "xt")):
        if t.data_ptr() % 16:
            raise ValueError(f"packed_symv96: {what} must start on a 16-byte boundary")
    z = torch.empty_like(xt)
    _lib.launch("packed_symv96", f.device, f.data_ptr(), dg.data_ptr(), xt.data_ptr(),
                z.data_ptr(), bp)
    return z


def packed_symv(packed: PackedInverse, rhs: torch.Tensor) -> torch.Tensor:
    """Drop-in for apply_block_inverse on packed storage: [B,96] -> [B,96].

    Transposes the rhs to batch-minor around the kernel."""
    b = rhs.shape[0]
    bp = packed.f.shape[2]
    xt = torch.zeros((DOF, bp), dtype=rhs.dtype, device=rhs.device)
    xt[:, :b] = rhs.T
    return packed_symv_t(packed, xt)[:, :b].T


def cm_permute96(inv96: torch.Tensor) -> torch.Tensor:
    """[B,96,96] lane-major (DOF l*3+c) -> comp-major (DOF c*32+l) rows and
    columns: a pure reshape-transpose, since 96 = 32 lanes x 3 components."""
    b = inv96.shape[0]
    return inv96.reshape(b, 32, 3, 32, 3).permute(0, 2, 1, 4, 3).reshape(b, DOF, DOF)


def pack_sym96_cm(inv96: torch.Tensor, block_b: int = 256) -> PackedInverseCM:
    """pack_sym96 of the comp-major-permuted blocks."""
    return PackedInverseCM(*pack_sym96(cm_permute96(inv96), block_b=block_b))


def packed_symv_cm(packed: PackedInverseCM, rs3: torch.Tensor) -> torch.Tensor:
    """[3,B,32] comp-plane bank vectors -> [3,B,32] through K2.

    The kernel's [96,Bp] rhs is the three [32,B] planes stacked: one
    transpose each way around the launch."""
    if not isinstance(packed, PackedInverseCM):
        raise TypeError("packed_symv_cm needs a PackedInverseCM (pack_sym96_cm)")
    b = rs3.shape[1]
    bp = packed.f.shape[2]
    xt = rs3.new_zeros((DOF, bp))
    xt[:, :b] = rs3.permute(0, 2, 1).reshape(DOF, b)
    zt = packed_symv_t(packed, xt)
    return zt[:, :b].reshape(3, 32, b).permute(0, 2, 1)


def dense_cm(inv96: torch.Tensor) -> DenseInverseCM:
    """[B,96,96] lane-major dense -> DenseInverseCM."""
    return DenseInverseCM(m=cm_permute96(inv96).contiguous())


def dense_symv_cm(inv: DenseInverseCM, rs3: torch.Tensor) -> torch.Tensor:
    """[3,B,32] -> [3,B,32] dense comp-plane symv through K3 on the
    [B,96] = rs3.permute(1,0,2) rhs."""
    if not isinstance(inv, DenseInverseCM):
        raise TypeError("dense_symv_cm needs a DenseInverseCM (dense_cm)")
    b = rs3.shape[1]
    rhs = rs3.permute(1, 0, 2).reshape(b, DOF)
    return batched_symv(inv.m, rhs).reshape(b, 3, 32).permute(1, 0, 2)
