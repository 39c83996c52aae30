"""Solver configuration (PyTorch port of ``precond_tpu/config.py``).

The JAX package's fields that the general-mesh and grid paths read, with
the same defaults, checks and static level geometry, so a configuration
means the same hierarchy in both. The TPU-only kernel switches
(use_pallas_symv, pallas_inverse_group, and inverse_kernel="pallas", whose
function the "panel" kernel computes) are absent rather than silently
ignored.
The reference hard-codes these as compile-time constants:
  - bank (domain) size 32        -> SeSchwarzPreconditioner.cpp:139
  - 32x coarsening per level     -> cpp:124-131
  - over-allocation ratio 1.5    -> cpp:114
  - applied-hierarchy cap of 4   -> SeSchwarzPreconditioner.h:96, cpp:1710
  - spatial re-sort cadence 17   -> cpp:49
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class SchwarzConfig:
    """Static configuration of the multilevel additive Schwarz preconditioner."""

    # Domain (bank) width: nodes per dense sub-block; keeps the dense block
    # at 96x96 (=32*3 DOF).
    bank_size: int = 32

    # Target coarsening factor between levels (reference: 32, cpp:124-131).
    coarsen_factor: int = 32

    # Static per-level capacity headroom over the ideal size/coarsen_factor
    # shrink (the reference over-allocates 1.5x globally, cpp:114).
    level_headroom: float = 2.0

    # Additive apply uses at most this many levels (cpp:1708-1717).
    max_applied_levels: int = 4

    # Morton re-sort cadence in frames (reference: every 17th, cpp:49).
    resort_every: int = 17

    # Collision stencil budget per vertex (reference: 32, cpp:187-188): the
    # per-vertex / per-edge cap of the hash-grid detectors.
    max_collision_per_vert: int = 32

    # Rounds of C |= C @ C for the in-bank transitive closure; the reachable
    # set doubles per round, so ceil(log2(bank)) is exact.
    closure_iters: int = 5

    # Batched 96x96 factorization:
    #   "panel"  — the default. On the card: the hand-written LDL^T + Gram
    #              kernel (ops/cuda/spd_inverse.py); on the CPU its plain
    #              version ops/batched_inverse.invert_spd_blocks_panel.
    #   "xla"    — Cholesky + triangular solves in plain torch (oracle).
    inverse_kernel: str = "panel"

    # Apply-phase inverse storage + symv kernel:
    #   "dense"  — explicit [B,96,96] inverses (ops/cuda/symv.py).
    #   "packed" — 4704 floats/block (the reference's packed count, cpp:165),
    #              batch-minor triangular packing applied by a two-sided symv
    #              that reads each element once (ops/cuda/packed_symv.py).
    #   "auto"   — packed iff num_blocks(n) >= packed_symv_min_blocks.
    symv_kernel: str = "auto"
    packed_symv_min_blocks: int = 4096
    packed_symv_block_b: int = 256

    def use_packed_symv(self, num_verts: int) -> bool:
        if self.symv_kernel == "dense" or self.inverse_dtype != "float32":
            return False
        if self.symv_kernel == "packed":
            return True
        return self.num_blocks(num_verts) >= self.packed_symv_min_blocks

    # Component-major solve layout of the static 2-D grid path: carries are
    # [3,N] planes, the SpMV is gridstencil.spmv_t, the crossings are
    # gridmorton.grid_to_morton_cm / morton_to_grid_cm and the apply is
    # ops/gridapply.precondition_grid_cm on a comp-major inverse (packed
    # above packed_symv_min_blocks, dense below).
    #   "auto" — comp-major wherever the path supports it (2-D grid
    #            prepares, >= 32x32; the general path pins rows)
    #   "cm" / "rows" — force
    solve_layout: str = "auto"

    def use_cm(self, num_verts: int) -> bool:
        return self.solve_layout != "rows"

    # One-hot (batched-matmul) forms of the restriction and prolongation
    # transfer ops instead of the scatter/gather forms.
    use_onehot_transfer: bool = True

    # Debug-mode numerical guards after every prepare() (utils/guards.py);
    # PRECOND_DEBUG_CHECKS=1 turns them on without touching code.
    debug_checks: bool = False

    # Morton-sort normalization: "isotropic" divides by the max AABB extent
    # (a deliberate deviation, PARITY.md); "per_axis" is reference-exact
    # (FillSortingData, cpp:225-231).
    morton_normalization: str = "isotropic"

    # Coarse-level correction damping: z = z_0 + coarse_damping * sum z_l.
    # 1.0 is the reference's plain additive sum (cpp:1708-1717).
    coarse_damping: float = 1.0

    # Storage dtype of the factorized domain inverses: "float32" or
    # "bfloat16". bf16 halves the apply's table traffic; the symv rounds the
    # rhs to bf16 and accumulates in f32 (ops/cuda/symv.py). Rounding a
    # symmetric matrix entrywise keeps it symmetric, so CG stays valid, but
    # at cloth-stiff conditioning (~1e7) the rounded M can lose positive
    # definiteness and stall CG: f32 is the default. Packed storage is f32
    # only, so bf16 takes the dense tables.
    inverse_dtype: str = "float32"

    def __post_init__(self):
        if self.bank_size != 32:
            raise ValueError("bank_size is pinned to 32 (uint32 masks / 96x96 blocks)")
        if self.closure_iters < math.ceil(math.log2(self.bank_size)):
            raise ValueError(f"closure_iters={self.closure_iters} is too few for a 32-wide bank")
        if self.symv_kernel not in ("auto", "dense", "packed"):
            raise ValueError(self.symv_kernel)
        if self.solve_layout not in ("auto", "rows", "cm"):
            raise ValueError(self.solve_layout)
        if self.morton_normalization not in ("isotropic", "per_axis"):
            raise ValueError(self.morton_normalization)
        if not 0.0 < self.coarse_damping <= 1.0:
            raise ValueError(f"coarse_damping={self.coarse_damping}")
        if self.inverse_kernel not in ("panel", "xla"):
            raise ValueError(self.inverse_kernel)
        if self.inverse_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"inverse_dtype={self.inverse_dtype!r} (float32 or bfloat16)")
        if self.max_collision_per_vert < 1:
            raise ValueError(f"max_collision_per_vert={self.max_collision_per_vert} must be >= 1")

    # ---- static level geometry ------------------------------------------

    def num_levels(self, num_verts: int) -> int:
        """Level count for an N-vertex mesh (reference ComputeLevelNums, cpp:112-135)."""
        n_level = 1
        level_sz = ceil_to(max(num_verts, 1), self.bank_size)
        while level_sz > self.bank_size:
            level_sz = ceil_to(level_sz // self.coarsen_factor, self.bank_size)
            n_level += 1
        return n_level

    def level_capacities(self, num_verts: int) -> Tuple[int, ...]:
        """Static per-level node capacities (multiples of bank_size).

        Level 0 capacity is exact (ceil32(N)); coarser levels get
        ceil32(headroom * prev/coarsen_factor), floored at one bank. If real
        clustering exceeds a capacity the builder reports overflow.
        """
        caps = [ceil_to(max(num_verts, 1), self.bank_size)]
        for _ in range(1, self.num_levels(num_verts)):
            ideal = caps[-1] / self.coarsen_factor
            caps.append(max(self.bank_size, ceil_to(int(math.ceil(ideal * self.level_headroom)), self.bank_size)))
        return tuple(caps)

    def level_offsets(self, num_verts: int) -> Tuple[int, ...]:
        """Static begin offset of each level in the concatenated node space."""
        caps = self.level_capacities(num_verts)
        offs = [0]
        for c in caps:
            offs.append(offs[-1] + c)
        return tuple(offs)  # length num_levels+1; last entry == total_capacity

    def total_capacity(self, num_verts: int) -> int:
        return self.level_offsets(num_verts)[-1]

    def num_blocks(self, num_verts: int) -> int:
        return self.total_capacity(num_verts) // self.bank_size
