"""Preconditioner application  z = M^-1 r  (port of ``precond_tpu/ops/apply.py``).

Reference: Preconditioning (cpp:100-110) =
  BuildResidualHierarchy (cpp:1548-1598)  restriction child -> parent
  SchwarzLocalXSym (cpp:1600-1696)        per-block symmetric matvec
  CollectFinalZ (cpp:1698-1719)           additive prolongation over at most
                                          4 levels + scatter to original ids

The per-block symv is a hand-written kernel on the card: the packed
two-sided form (ops/cuda/packed_symv.py) when the state holds a
PackedInverse, the dense form (ops/cuda/symv.py) otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SchwarzConfig
from ..utils.gather import take_fill
from ..utils.scatter import accumulate_rows
from .cuda.packed_symv import PackedInverse, packed_symv
from .cuda.symv import batched_symv
from .hierarchy import BANK


class ApplyState(NamedTuple):
    """Everything Preconditioning needs, produced once per prepare()."""

    sorted_to_orig: torch.Tensor  # i32[N]
    orig_to_sorted: torch.Tensor  # i32[N]
    going_next: torch.Tensor      # i32[total+1]
    ancestors: torch.Tensor       # i32[N, L-1] node ids of each vertex's ancestors
    inv96: object                 # f32[B,96,96] tensor or a PackedInverse
    overflow: torch.Tensor        # bool[]
    # onehot[b, lc, i] = 1 iff in-bank node i of bank b belongs to the
    # bank's lc-th cluster; zero rows for the top level.
    restrict_onehot: torch.Tensor  # f32[total//32, 32, 32]
    # For each coarse node p (offset by cap0): flat index offs[l] + b*32+lc
    # of its slot in the child level's per-bank cluster-sum layout; -1 for
    # padded/inactive nodes.
    restrict_pos: torch.Tensor     # i32[total - cap0]
    # Per-bank smallest parent node id; `total` for fully inactive banks.
    restrict_pb: torch.Tensor      # i32[total//32]


def restrict_residual_scatter(
    r_sorted: torch.Tensor,
    going_next: torch.Tensor,
    cfg: SchwarzConfig,
    n: int,
) -> torch.Tensor:
    """Scatter-form residual restriction (oracle form).

    Level-by-level child->parent accumulation; inactive/padded/top nodes
    have going_next == total (sentinel) so their adds fall in a dump row.
    """
    levels = cfg.num_levels(n)
    offs = cfg.level_offsets(n)
    total = offs[-1]
    mr = r_sorted.new_zeros((total + 1, 3))
    mr[:n] = r_sorted
    for l in range(levels - 1):
        seg = slice(offs[l], offs[l + 1])
        accumulate_rows(mr, going_next[seg], mr[seg].clone())
    return mr[:total]


def restrict_residual_onehot(
    r_sorted: torch.Tensor,
    state: ApplyState,
    cfg: SchwarzConfig,
    n: int,
) -> torch.Tensor:
    """Build the residual hierarchy: f32[N,3] (sorted order) -> f32[total,3].

    Clusters never span a 32-node bank and a bank's cluster ids are
    consecutive, so each level's child->parent reduction is a per-bank
    batched matmul with the [32,32] membership one-hot, followed by one
    small gather that compacts per-bank cluster sums into the next level's
    node numbering.
    """
    levels = cfg.num_levels(n)
    offs = cfg.level_offsets(n)
    cap0 = offs[1]
    first = r_sorted.new_zeros((cap0, 3))
    first[:n] = r_sorted
    parts = [first]
    for l in range(levels - 1):
        rb = parts[l].reshape(-1, BANK, 3)
        oh = state.restrict_onehot[offs[l] // BANK: offs[l + 1] // BANK]
        part = torch.bmm(oh, rb)                                   # [W,32,3]
        pos = state.restrict_pos[offs[l + 1] - cap0: offs[l + 2] - cap0]
        parts.append(take_fill(part.reshape(-1, 3), pos - offs[l]))  # [cap_{l+1}, 3]
    return torch.cat(parts, dim=0)


def _presum_coarse(mz: torch.Tensor, going_next: torch.Tensor, cfg: SchwarzConfig,
                   n: int, top: int) -> torch.Tensor:
    """Top-down pre-sum over the applied coarse levels: each node of levels
    top-2 .. 1 accumulates its parent's z."""
    offs = cfg.level_offsets(n)
    pz = mz.clone()
    for l in range(top - 2, 0, -1):
        seg = slice(offs[l], offs[l + 1])
        pz[seg] += take_fill(pz, going_next[seg])
    return pz


def prolong_and_collect_gather(
    mz: torch.Tensor,
    ancestors: torch.Tensor,
    going_next: torch.Tensor,
    cfg: SchwarzConfig,
    n: int,
) -> torch.Tensor:
    """Gather-form additive prolongation (oracle form).

    Starting at the highest applied level (the reference caps application
    at 4 levels, h:96), each node accumulates its parent's z, so the fine
    sum needs one gather from the level-1 region (CollectFinalZ, cpp:1698-1719).
    """
    top = min(cfg.num_levels(n), cfg.max_applied_levels)  # apply levels 0..top-1
    z = mz[:n]
    if top > 1:
        pz = _presum_coarse(mz, going_next, cfg, n, top)
        coarse = pz[ancestors[:, 0]]
        if cfg.coarse_damping != 1.0:
            coarse = coarse * cfg.coarse_damping
        z = z + coarse
    return z


def prolong_and_collect_onehot(
    mz: torch.Tensor,
    state: ApplyState,
    cfg: SchwarzConfig,
    n: int,
) -> torch.Tensor:
    """Additive multi-level sum (CollectFinalZ, cpp:1698-1719), one-hot form.

    A fine bank's 32 parent ids are consecutive from its anchor pb[b], so
    they live in at most two consecutive level-1 banks: gather those two
    banks, align by the anchor's in-bank shift r[b] (five conditional
    shifts by r's bits), and distribute to fine nodes with the transposed
    restriction one-hot (exact: one nonzero term per fine node).
    """
    levels = cfg.num_levels(n)
    offs = cfg.level_offsets(n)
    cap0 = offs[1]
    top = min(levels, cfg.max_applied_levels)  # apply levels 0..top-1
    z = mz[:n]
    if top > 1:
        pz = _presum_coarse(mz, state.going_next, cfg, n, top)
        b0 = cap0 // BANK
        cap1 = offs[2] - cap0
        pz1 = pz[cap0: offs[2]]                                   # [cap1, 3]
        pb = state.restrict_pb[:b0] - cap0                        # level-1-local anchors
        q = torch.clamp(torch.div(pb, BANK, rounding_mode="floor"), 0, cap1 // BANK - 1)
        r = pb - q * BANK                                         # in-window shift
        pzb = torch.cat([pz1.reshape(-1, BANK * 3), pz1.new_zeros((1, BANK * 3))])
        win = take_fill(pzb, torch.stack([q, q + 1], dim=1)).reshape(b0, 2 * BANK, 3)
        for bit in (16, 8, 4, 2, 1):
            shifted = torch.cat([win[:, bit:, :], win.new_zeros((b0, bit, 3))], dim=1)
            win = torch.where(((r & bit) > 0)[:, None, None], shifted, win)
        winshift = win[:, :BANK, :]                               # [B0, 32, 3]
        contrib = torch.bmm(state.restrict_onehot[:b0].transpose(1, 2), winshift)  # [B0,32,3]
        if cfg.coarse_damping != 1.0:
            contrib = contrib * cfg.coarse_damping
        z = z + contrib.reshape(-1, 3)[:n]
    return z


def restrict_residual(r_sorted: torch.Tensor, state: ApplyState, cfg: SchwarzConfig,
                      n: int) -> torch.Tensor:
    """Residual restriction, dispatching on cfg.use_onehot_transfer."""
    if cfg.use_onehot_transfer:
        return restrict_residual_onehot(r_sorted, state, cfg, n)
    return restrict_residual_scatter(r_sorted, state.going_next, cfg, n)


def prolong_and_collect(mz: torch.Tensor, state: ApplyState, cfg: SchwarzConfig,
                        n: int) -> torch.Tensor:
    """Additive prolongation, dispatching on cfg.use_onehot_transfer."""
    if cfg.use_onehot_transfer:
        return prolong_and_collect_onehot(mz, state, cfg, n)
    return prolong_and_collect_gather(mz, state.ancestors, state.going_next, cfg, n)


def precondition_sorted(state: ApplyState, r_sorted: torch.Tensor,
                        cfg: SchwarzConfig) -> torch.Tensor:
    """z = M^-1 r entirely in Morton-sorted vertex order. f32[N,3] -> f32[N,3].

    A solve that keeps its vectors in sorted space (permuting b once before
    and x once after the loop) avoids two N-row permutes per iteration.
    """
    n = r_sorted.shape[0]
    mr = restrict_residual(r_sorted, state, cfg, n)
    rhs = mr.reshape(-1, 3 * BANK)                        # [B,96]
    if isinstance(state.inv96, PackedInverse):
        z96 = packed_symv(state.inv96, rhs)
    else:
        # both dense forms of the JAX package (the XLA einsum and the Pallas
        # batched_symv) are the one dense kernel here
        z96 = batched_symv(state.inv96, rhs)
    mz = z96.reshape(-1, 3)                               # [total,3]
    return prolong_and_collect(mz, state, cfg, n)


def precondition(state: ApplyState, r: torch.Tensor, cfg: SchwarzConfig) -> torch.Tensor:
    """z = M^-1 r with r, z in original vertex order. f32[N,3] -> f32[N,3]."""
    r_sorted = r[state.sorted_to_orig]
    z_sorted = precondition_sorted(state, r_sorted, cfg)
    return z_sorted[state.orig_to_sorted]
