"""The yardstick's table of peaks and the work of each kernel, counted from
the problem's shapes (blocks, vertices, stencil planes), never from what an
implementation happens to read: each input byte read once, each output
byte written once.

Peaks: NVIDIA's H100 SXM data sheet at its 700 W limit, HBM at 3.35 TB/s
and 67 TFLOP/s in float32 outside the tensor cores (the counts of
``chip_smoke.py``'s kernel table, frozen here).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card needs for the work: bytes or operations."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def k1_work(blocks: int):
    """K1, the 96x96 SPD inverse: read each domain matrix, write its
    inverse; ~96^3 operations a block (Cholesky, triangular inverse and the
    L^-T L^-1 product, a third each)."""
    return 2 * blocks * 96 * 96 * F32, blocks * 96 ** 3


def k2_work(blocks: int):
    """K2, the symmetric 96x96 matvec of every block: the inverse's distinct
    entries (96 * 97 / 2), the rhs in and z out; 2 * 96^2 operations."""
    return (96 * 97 // 2 + 2 * 96) * F32 * blocks, 2 * 96 * 96 * blocks


def k4_work(n: int, planes: int):
    """K4, the stencil SpMV: the 3x3 diagonal and one 3x3 block per
    direction plane at every vertex, x in and y out; a multiply-add per
    block entry."""
    return (9 + 9 * planes) * F32 * n + 2 * 3 * F32 * n, 2 * 9 * (planes + 1) * n


def nnz_spmv(n: int, offdiag_blocks: int) -> int:
    """Stored entries of H: the diagonal blocks and the off-diagonal ones
    (``bench_torch.py``'s count)."""
    return 9 * (n + offdiag_blocks)


def nnz_apply(blocks: int) -> int:
    """Entries of the dense domain inverses the apply reads (96 x 96 a block)."""
    return blocks * 96 * 96
