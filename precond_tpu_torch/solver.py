"""High-level 3-phase preconditioner API (port of ``precond_tpu/solver.py``, general path).

Mirrors the reference contract (SeSchwarzPreconditioner.h:56-63):
  AllocatePrecoditioner  -> allocate(): the Morton sort maps (re-sorted on
                            a cadence)
  PreparePreconditioner  -> prepare(): ELL permute + hierarchy + assembly +
                            factorization (hand-written inverse kernel)
  Preconditioning        -> apply(): z = M^-1 r (hand-written symv kernel)

Collision stencils (ops/stencils.py) enter the general prepare: their
cross-primitive pairs join the clustering and their rank-1 Hessian terms
the banked assembly. The structured 2-D grid prepare (prepare_grid: static
assembly over the analytic tile order, no sort, permute or hierarchy build)
feeds the grid apply (ops/gridapply.py). The box prepare and contact on the
grid path arrive with later slices of the port.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import NamedTuple, Optional

import torch

from .config import SchwarzConfig
from .device import resolve_device
from .ops import hierarchy as hi
from .ops.apply import ApplyState, precondition
from .ops.assembly import assemble_banked_hessian
from .ops.batched_inverse import invert_spd_blocks
from .ops.blockcsr import BlockEll, permute
from .ops.gridapply import analytic_hierarchy
from .ops.gridassembly import assemble_grid_hessian
from .ops.cuda.packed_symv import dense_cm, pack_sym96, pack_sym96_cm
from .ops.cuda.spd_inverse import spd_inverse
from .ops.stencils import Stencils, collision_terms, map_stencils, stencil_pairs
from .utils import aabb, morton


class SortMaps(NamedTuple):
    sorted_to_orig: torch.Tensor  # i32[N] (m_MapperSortedGetOriginal)
    orig_to_sorted: torch.Tensor  # i32[N] (m_mapperOriginalGetSorted)


def compute_sort_maps(positions: torch.Tensor, normalization: str = "isotropic") -> SortMaps:
    """Morton spatial sort (AllocatePrecoditioner's reorder, cpp:54-63).

    "isotropic" (default) divides by the MAX AABB extent so the sort
    preserves true spatial proximity; "per_axis" reproduces the reference's
    per-axis unit-cube stretch (FillSortingData, cpp:225-231). The f32
    operations follow the JAX package's order, so the maps agree bit for bit.
    """
    box = aabb.compute_aabb(positions)
    if normalization == "isotropic":
        ext = torch.max(box.upper - box.lower)
        unit = (positions - box.lower) / torch.where(ext > 0, ext, torch.ones_like(ext))
    else:
        unit = aabb.to_unit_cube(positions, box)
    perm = morton.argsort_morton(unit).to(torch.int32)
    return SortMaps(perm, morton.inverse_permutation(perm))


def _debug_enabled(cfg: SchwarzConfig) -> bool:
    return bool(cfg.debug_checks or os.environ.get("PRECOND_DEBUG_CHECKS"))


def _factorize(h96: torch.Tensor, cfg: SchwarzConfig, n: int, allow_cm: bool = False):
    """Batched 96x96 SPD factorization tail shared by the prepares.

    Returns dense f32[B,96,96] inverses, or — when cfg.use_packed_symv(n) —
    the packed-symmetric PackedInverse form (4704 floats/block, the
    reference's LDLtInverse512 packed count, cpp:165,1349). A prepare that
    supports the comp-major solve (allow_cm: the >= 32x32 2-D grid path)
    returns the comp-major forms instead when cfg.use_cm(n): PackedInverseCM
    above the packed threshold, DenseInverseCM below it.
    """
    if cfg.solve_layout == "cm" and not allow_cm:
        warnings.warn(
            "solve_layout='cm' was forced but this prepare path pins the "
            "row-major layout (only >=32x32 2-D grid prepares honor cm); "
            "proceeding row-major"
        )
    if cfg.inverse_kernel == "xla":
        inv96 = invert_spd_blocks(h96)
    else:
        # "panel": the hand-written kernel on the card, its plain version on
        # the CPU. Debug mode disables the silent identity
        # repair so a genuine factorization bug reaches assert_healthy.
        inv96 = spd_inverse(h96, repair=not _debug_enabled(cfg))
    cm = allow_cm and cfg.use_cm(n)
    if cfg.use_packed_symv(n):
        pack = pack_sym96_cm if cm else pack_sym96
        return pack(inv96, block_b=cfg.packed_symv_block_b)
    return dense_cm(inv96) if cm else inv96


def prepare_with_system(
    ell: BlockEll,
    maps: SortMaps,
    cfg: SchwarzConfig,
    stencils: Optional[Stencils] = None,
    analytic_hier: bool = False,
):
    """prepare_preconditioner that also returns the Morton-sorted system.

    Returns (ApplyState, BlockEll): the sorted ELL is the matrix PCG should
    iterate on — solving P H P^T (P x) = P b in sorted space drops the two
    N-row permutes per iteration that `precondition` pays. `stencils` carry
    ORIGINAL vertex ids; the system's contact fill-in is the caller's
    (ops/contact.py), as in the reference.
    """
    n = ell.num_verts
    ell_sorted = permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    pairs = terms = None
    if stencils is not None:
        mapped = map_stencils(stencils, maps.orig_to_sorted)
        pairs = stencil_pairs(mapped)
        terms = collision_terms(mapped)
    if analytic_hier:
        # The caller's ordering guarantees single-cluster banks at every
        # level (the analytic tile order): the hierarchy is arithmetic, so
        # build_hierarchy is skipped (ops/gridapply.analytic_hierarchy).
        hier, merge_map = analytic_hierarchy(n, cfg, ell.diag.device), None
    else:
        hier, merge_map = hi.build_hierarchy(
            ell_sorted.idx, ell_sorted.mask, cfg, pairs, with_merge_map=True
        )
    h96 = assemble_banked_hessian(ell_sorted, hier, cfg, terms, merge_map=merge_map)
    inv96 = _factorize(h96, cfg, n)
    state = ApplyState(
        sorted_to_orig=maps.sorted_to_orig,
        orig_to_sorted=maps.orig_to_sorted,
        going_next=hier.going_next,
        ancestors=hi.ancestor_node_ids(hier, cfg, n),
        inv96=inv96,
        overflow=hier.overflow,
        restrict_onehot=hier.onehot,
        restrict_pos=hier.pos,
        restrict_pb=hier.pb,
    )
    return state, ell_sorted


def prepare_grid(
    diag_rows: torch.Tensor,   # f32[N,3,3] grid vertex order
    dirs_rows: torch.Tensor,   # f32[D,N,3,3] grid order
    offsets,                   # tuple of (di, dj), one per plane of dirs_rows
    k: int,                    # the grid is 2^k x 2^k
    cfg: SchwarzConfig,
    stencils=None,
    o2s=None,
):
    """Structured-grid prepare: static assembly + factorization -> inverses.

    For tile-ordered power-of-two grids the hierarchy is arithmetic
    (ops/gridapply.py) and assembly is static placement
    (ops/gridassembly.py), so prepare needs no Morton sort, no ELL
    permutation and no hierarchy build: the whole phase is the banked
    assembly plus the inverse kernel. Runs on the inputs' device. Apply
    with ops.gridapply.precondition_grid (dense / PackedInverse) or
    precondition_grid_cm (the comp-major forms, chosen by cfg.use_cm on
    grids of at least 32x32).
    """
    if stencils is not None or o2s is not None:
        raise NotImplementedError(
            "collision stencils: contact on the grid path is not ported yet (ROADMAP.md Queue A item 3)")
    h96 = assemble_grid_hessian(diag_rows, dirs_rows, offsets, k, cfg)
    return _factorize(h96, cfg, diag_rows.shape[0], allow_cm=k >= 5)


def prepare_preconditioner(
    ell: BlockEll,
    maps: SortMaps,
    cfg: SchwarzConfig,
    stencils: Optional[Stencils] = None,
) -> ApplyState:
    """Build hierarchy, assemble banked Hessians, factorize.

    `ell` is the system matrix in ORIGINAL vertex order; the vertex
    adjacency is read off the same ELL sparsity.
    """
    return prepare_with_system(ell, maps, cfg, stencils)[0]


class SchwarzPreconditioner:
    """Stateful wrapper over the functional phases.

    Runs on the card (device=None) unless the caller passes device="cpu";
    without a card and without device="cpu" it raises RuntimeError.
    """

    #: retries of prepare() with doubled level_headroom on capacity overflow
    MAX_OVERFLOW_RETRIES = 4

    def __init__(self, cfg: SchwarzConfig = SchwarzConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # cfg actually used to build the current state; grows level_headroom
        # on overflow recovery. apply() must use this one (level offsets!).
        self.cfg_effective = cfg
        self.frame_index = 0
        self.maps: Optional[SortMaps] = None
        self.state: Optional[ApplyState] = None

    def allocate(self, positions) -> None:
        """Per-frame entry; re-sorts space on the configured cadence
        (reference: every 17th frame, cpp:49)."""
        if self.maps is None or self.frame_index % self.cfg.resort_every == 0:
            pos = torch.as_tensor(positions, dtype=torch.float32, device=self.device)
            self.maps = compute_sort_maps(pos, self.cfg.morton_normalization)
        self.frame_index += 1

    def prepare(self, ell: BlockEll, stencils: Optional[Stencils] = None) -> None:
        """Hierarchy + assembly + factorization, with overflow recovery.

        `stencils` (ORIGINAL vertex ids) add contact connectivity and
        collision Hessian terms to the preconditioner.

        If clustering exceeds a level's static capacity the builder clamps
        cluster ids and raises `state.overflow`; rebuild with doubled
        level_headroom until it fits. Reading the flag is one host sync.
        """
        if self.maps is None:
            raise RuntimeError("call allocate() first")
        ell = ell.to(self.device)
        if stencils is not None:
            stencils = stencils.to(self.device)
        cfg = self.cfg_effective
        debug = _debug_enabled(self.cfg)
        if debug:
            from .utils.guards import assert_system_finite

            assert_system_finite(ell)
        for _ in range(self.MAX_OVERFLOW_RETRIES + 1):
            state = prepare_preconditioner(ell, self.maps, cfg, stencils)
            if not bool(state.overflow):
                break
            grown = dataclasses.replace(cfg, level_headroom=cfg.level_headroom * 2.0)
            warnings.warn(
                "hierarchy level capacity overflow; rebuilding with "
                f"level_headroom={grown.level_headroom} (was {cfg.level_headroom})"
            )
            cfg = grown
        self.cfg_effective = cfg
        self.state = state
        if debug:
            from .utils.guards import assert_healthy

            assert_healthy(state)

    def apply(self, r) -> torch.Tensor:
        if self.state is None:
            raise RuntimeError("call prepare() first")
        r = torch.as_tensor(r, dtype=torch.float32, device=self.device)
        return precondition(self.state, r, self.cfg_effective)
