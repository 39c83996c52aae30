"""Multilevel domain hierarchy: Morton-bank clustering (port of ``precond_tpu/ops/hierarchy.py``).

Reference pipeline (ReorderRealtime, SeSchwarzPreconditioner.cpp:415-445):
per-warp 32-bit adjacency masks, in-warp transitive closure, leader count,
two-stage prefix sums, per-level repeat, per-vertex ancestor table. As in
the JAX package, a bank's connectivity is a boolean [32,32] matrix batched
over banks, the closure is ceil(log2(32)) = 5 rounds of C |= C @ C (batched
matmuls, exact on 0/1 data), leaders are a masked any() over the strict
lower triangle and prefix sums are cumsums.

Every level has a static capacity (config.level_capacities); actual level
sizes are device values used only in masks and index arithmetic, and a
level that outgrows its capacity raises the `overflow` flag.

Broadcast-multiply-reduce forms of the JAX code are written as batched
matmuls here (eager PyTorch would materialize the broadcast product); the
one-hot factor makes every product exact, only the summation order differs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import SchwarzConfig
from ..utils.gather import INT32_MIN, take_fill
from ..utils.scatter import accumulate_rows

BANK = 32


class StencilPairs(NamedTuple):
    """Cross-primitive vertex pairs of collision stencils, fine sorted space.

    Flattened over stencils x (ita, itb) combos with ita in the first
    primitive and itb in the second (cpp:534-552). `valid` masks real pairs.
    """

    a: torch.Tensor      # i32[P]
    b: torch.Tensor      # i32[P]
    valid: torch.Tensor  # bool[P]


class NeighborMergeMap(NamedTuple):
    """Per ELL pair (v, k): where in the hierarchy the pair's banks merge
    (first level whose banks coincide and the climbed neighbor's lane there,
    cpp:1282-1287)."""

    lam: torch.Tensor      # i32[N,K] merge level (== levels when never)
    lane_ot: torch.Tensor  # i32[N,K] climbed-neighbor lane (%32) at merge
    ok: torch.Tensor       # bool[N,K] pair merges within the hierarchy


class Hierarchy(NamedTuple):
    """Cluster hierarchy over the concatenated node space.

    Node ids: level l occupies [offsets[l], offsets[l] + caps[l]); a node is
    active if its within-level index < level_sizes[l]. going_next maps a
    node to its parent node id (sentinel = total capacity for top level /
    padded nodes), with one extra self-loop slot at the sentinel.

      onehot[b, lc, i] = 1 iff in-bank node i of bank b belongs to the
        bank's lc-th cluster (zero rows for the top level);
      pos[p - cap0]    = flat slot offs[l] + b*32 + lc of coarse node p in
        its child level's per-bank cluster-sum layout, -1 when inactive;
      pb[b]            = smallest parent NODE id of bank b, `total` when
        inactive.
    """

    going_next: torch.Tensor     # i32[total+1]
    coarse_space: torch.Tensor   # i32[L, N]: row l = within-level cluster id at level l
    level_sizes: torch.Tensor    # i32[L]: actual node count per level
    overflow: torch.Tensor       # bool[]: any level exceeded its static capacity
    onehot: torch.Tensor         # f32[total//32, 32, 32]
    pos: torch.Tensor            # i32[total - cap0]
    pb: torch.Tensor             # i32[total//32]


def lane_bitmask_rows(ids_col: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """Per-row 32-wide lane masks: out[r, j] = any slot with ids_col%32 == j."""
    lane = torch.arange(BANK, dtype=ids_col.dtype, device=ids_col.device)
    hits = ((ids_col % BANK)[..., None] == lane) & contrib[..., None]
    return hits.any(dim=1)  # [rows, 32]


def rows_to_bank_adjacency(row_ids: torch.Tensor, rowmask: torch.Tensor,
                           num_banks: int) -> torch.Tensor:
    """OR 32-wide lane rows into banked adjacency A[W,32,32].

    row_ids are within-level node indices; as in JAX's ``.at[].add(mode=
    "drop")`` an id in [-size, -1] wraps and one still outside [0, size)
    drops. Integer counts, so the order of the adds does not matter.
    """
    size = num_banks * BANK
    rows = row_ids.reshape(-1)
    rows = torch.where(rows < 0, rows + size, rows)
    acc = torch.zeros((size, BANK), dtype=torch.int32, device=row_ids.device)
    accumulate_rows(acc, rows, rowmask.reshape(-1, BANK).to(torch.int32),
                    torch.ones_like(rows, dtype=torch.bool))
    return acc.reshape(num_banks, BANK, BANK) > 0


def neighbor_warp_masks_to_adjacency(ids_row: torch.Tensor, ids_col: torch.Tensor,
                                     contrib: torch.Tensor, num_banks: int) -> torch.Tensor:
    """Pair-list form: put (row, col) pairs that share a bank into
    A[W,32,32] (used for the collision-pair lists)."""
    if ids_row.dim() == 1:
        ids_row, ids_col, contrib = ids_row[:, None], ids_col[:, None], contrib[:, None]
    rowmask = lane_bitmask_rows(ids_col, contrib)
    row = torch.where(contrib.any(dim=1), ids_row[:, 0],
                      torch.full_like(ids_row[:, 0], num_banks * BANK))
    return rows_to_bank_adjacency(row, rowmask, num_banks)


def _pair_adjacency(ca: torch.Tensor, cb: torch.Tensor, valid: torch.Tensor,
                    num_banks: int) -> torch.Tensor:
    """Adjacency of the stencil pairs whose two (level) ids share a bank."""
    psame = (torch.div(ca, BANK, rounding_mode="floor") == torch.div(cb, BANK, rounding_mode="floor")) \
        & (ca != cb) & valid
    return neighbor_warp_masks_to_adjacency(ca, cb, psame, num_banks)


def transitive_closure_inbank(adj: torch.Tensor, iters: int) -> torch.Tensor:
    """C = closure(adj | I) per bank via repeated boolean squaring.

    Replaces the serial ffs fixpoint of PreparePrefixSumL0 (cpp:600-614);
    reachable path length doubles per round, so `iters`=5 is exact for 32.
    Entries stay small integers, exact in f32.
    """
    eye = torch.eye(BANK, dtype=torch.float32, device=adj.device)
    c = torch.maximum(adj.float(), eye[None])
    for _ in range(iters):
        c = torch.clamp(c + torch.bmm(c, c), max=1.0)
    return c > 0.0


def _cluster_banks(
    closure: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Elect leaders and number components globally.

    closure: bool[W,32,32] in-bank component matrix, valid: bool[W,32].
    Returns (cluster ids i32[W*32], total cluster count, per-bank exclusive
    leader prefix). Mirrors the elected-prefix rule (cpp:618-623) and
    two-stage prefix sums (cpp:630-740).
    """
    tril = torch.ones(BANK, BANK, dtype=torch.bool, device=closure.device).tril(-1)
    conn_valid = closure & valid[:, None, :] & valid[:, :, None]
    earlier = (conn_valid & tril[None]).any(dim=2)                  # [W,32]
    leader = valid & ~earlier
    cnt = leader.sum(dim=1, dtype=torch.int32)                      # [W]
    bank_prefix = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)      # exclusive
    lead_i = leader.to(torch.int32)
    lane_prefix = (torch.cumsum(lead_i, 1) - lead_i).to(torch.int32)  # [W,32]
    # Elected lane = first member of my component (ffs of the closed mask);
    # argmax returns the first maximal index, like JAX's.
    elected = torch.argmax(conn_valid.to(torch.uint8), dim=2)       # [W,32] i64
    cluster = bank_prefix[:, None] + torch.gather(lane_prefix, 1, elected)
    total = cnt.sum(dtype=torch.int32)
    return cluster.reshape(-1), total, bank_prefix


def _pos_and_anchors(pb_seg: torch.Tensor, lo: int, hi: int, w: int):
    """Invert the per-bank cluster layout for coarse nodes [lo, hi): returns
    the local slot b*32 + lc of each (-1 when inactive) via one searchsorted
    over the nondecreasing bank anchors."""
    c_node = torch.arange(lo, hi, dtype=torch.int32, device=pb_seg.device)
    b_of = torch.clamp(torch.searchsorted(pb_seg, c_node, right=True) - 1, 0, w - 1)
    local_of = c_node - pb_seg[b_of]
    okc = (local_of >= 0) & (local_of < BANK)
    return torch.where(okc, (b_of * BANK + local_of).to(torch.int32), -1)


def build_hierarchy(
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    cfg: SchwarzConfig,
    pairs=None,
    with_merge_map: bool = False,
):
    """Build the full cluster hierarchy from sorted-space adjacency.

    nbr_idx/nbr_mask: ELL vertex adjacency in Morton-sorted order, self
    excluded. pairs: optional collision-stencil connectivity (StencilPairs in
    sorted space; the reference injects it at every level, cpp:421,433).

    with_merge_map=True returns (Hierarchy, NeighborMergeMap).
    """
    dev = nbr_idx.device
    n = nbr_idx.shape[0]
    levels = cfg.num_levels(n)
    caps = cfg.level_capacities(n)
    offs = cfg.level_offsets(n)
    total = offs[-1]

    vid = torch.arange(n, dtype=torch.int32, device=dev)
    going_next = torch.full((total + 1,), total, dtype=torch.int32, device=dev)
    level_sizes = [torch.tensor(n, dtype=torch.int32, device=dev)]
    coarse_rows = [vid]
    overflow = torch.zeros((), dtype=torch.bool, device=dev)

    # ---- level 0: in-bank adjacency over sorted vertex ids ---------------
    w0 = caps[0] // BANK
    u = nbr_idx
    same_bank = (u // BANK == vid[:, None] // BANK) & nbr_mask
    rowmask0 = torch.zeros((caps[0], BANK), dtype=torch.bool, device=dev)
    rowmask0[:n] = lane_bitmask_rows(u, same_bank)
    adj = rowmask0.reshape(w0, BANK, BANK)
    remain = nbr_mask & ~same_bank
    if with_merge_map:
        mm_lam = torch.where(same_bank, 0, levels).to(torch.int32)
        mm_lane = (u % BANK).to(torch.int32)
    if pairs is not None:
        adj = adj | _pair_adjacency(pairs.a, pairs.b, pairs.valid, w0)
    adj = adj | adj.transpose(1, 2)

    cur_ids = vid  # within-level node id of each vertex at the current level

    onehot_full = torch.zeros((total // BANK, BANK, BANK), dtype=torch.float32, device=dev)
    pos_full = torch.full((total - caps[0],), -1, dtype=torch.int32, device=dev)
    pb_full = torch.full((total // BANK,), total, dtype=torch.int32, device=dev)
    oh_chain = []
    lc_iota = torch.arange(BANK, dtype=torch.int32, device=dev)

    for level in range(1, levels):
        w = caps[level - 1] // BANK
        valid = (torch.arange(w * BANK, dtype=torch.int32, device=dev) < level_sizes[-1]).reshape(w, BANK)
        closed = transitive_closure_inbank(adj, cfg.closure_iters)
        cluster, count, bank_prefix = _cluster_banks(closed, valid)  # i32[w*32]

        overflow = overflow | (count > caps[level])
        level_sizes.append(count)

        # goingNext for the just-clustered level (cpp:736, 1068)
        parents = torch.where(
            valid.reshape(-1), offs[level] + torch.clamp(cluster, max=caps[level] - 1), total
        ).to(torch.int32)
        going_next[offs[level - 1]: offs[level - 1] + w * BANK] = parents

        # ---- anchored one-hot operator for child level `level-1` ----------
        local = cluster.reshape(w, BANK) - bank_prefix[:, None]
        oh = (valid[:, None, :] & (local[:, None, :] == lc_iota[None, :, None])).float()
        onehot_full[offs[level - 1] // BANK: offs[level - 1] // BANK + w] = oh
        has_valid = valid.any(dim=1)
        pb_seg = torch.where(has_valid, offs[level] + bank_prefix, total).to(torch.int32)
        pb_full[offs[level - 1] // BANK: offs[level - 1] // BANK + w] = pb_seg
        slot_local = _pos_and_anchors(pb_seg, offs[level], offs[level + 1], w)
        pos_full[offs[level] - caps[0]: offs[level + 1] - caps[0]] = torch.where(
            slot_local >= 0, offs[level - 1] + slot_local, -1
        ).to(torch.int32)
        oh_chain.append((oh, slot_local))

        # vertex -> cluster at `level` (jnp.take semantics: an id past a
        # level's capacity, possible only on overflow, reads INT32_MIN)
        cur_ids = take_fill(cluster, cur_ids, fill=INT32_MIN)
        coarse_rows.append(cur_ids)

        if level == levels - 1:
            break

        # ---- next level's adjacency from still-unconsumed neighbors ------
        # Lane masks in fine space (cu gather), reduced child->parent up the
        # one-hot chain as batched matmuls (exact: 0/1 operator, integer sums).
        wl = caps[level] // BANK
        cv = cur_ids
        cu = cur_ids[nbr_idx]
        cross = (cv[:, None] // BANK == cu // BANK) & remain
        if with_merge_map:
            mm_lam = torch.where(cross, level, mm_lam).to(torch.int32)
            mm_lane = torch.where(cross, cu % BANK, mm_lane).to(torch.int32)
        nsame = cross & (cv[:, None] != cu)
        payload = torch.zeros((caps[0], BANK), dtype=torch.float32, device=dev)
        payload[:n] = lane_bitmask_rows(cu, nsame).float()
        for ohl, slotl in oh_chain:
            red = torch.bmm(ohl, payload.reshape(-1, BANK, BANK))      # [w,lc,32]
            payload = take_fill(red.reshape(-1, BANK), slotl)
        adj = (payload > 0.0).reshape(wl, BANK, BANK)
        remain = remain & ~cross
        if pairs is not None:
            adj = adj | _pair_adjacency(cur_ids[pairs.a.long()], cur_ids[pairs.b.long()],
                                        pairs.valid, wl)
        adj = adj | adj.transpose(1, 2)

    hier = Hierarchy(
        going_next=going_next,
        coarse_space=torch.stack(coarse_rows),
        level_sizes=torch.stack(level_sizes),
        overflow=overflow,
        onehot=onehot_full,
        pos=pos_full,
        pb=pb_full,
    )
    if not with_merge_map:
        return hier
    if levels > 1:
        # pairs still unmerged may meet at the top level; pairs whose top
        # banks differ never merge and drop, like the reference (cpp:1288-1291).
        cu_top = cur_ids[nbr_idx]
        top = remain & (cur_ids[:, None] // BANK == cu_top // BANK)
        mm_lam = torch.where(top, levels - 1, mm_lam).to(torch.int32)
        mm_lane = torch.where(top, cu_top % BANK, mm_lane).to(torch.int32)
    return hier, NeighborMergeMap(lam=mm_lam, lane_ot=mm_lane, ok=mm_lam < levels)


def ancestor_node_ids(h: Hierarchy, cfg: SchwarzConfig, n: int) -> torch.Tensor:
    """coarse_tables (cpp:1092-1162): node id of each vertex's ancestor at
    levels 1..L-1, shape i32[N, L-1] (empty second dim when L == 1)."""
    offs = cfg.level_offsets(n)
    rows = [offs[l] + h.coarse_space[l] for l in range(1, h.coarse_space.shape[0])]
    if not rows:
        return torch.zeros((n, 0), dtype=torch.int32, device=h.coarse_space.device)
    return torch.stack(rows, dim=1).to(torch.int32)


def restriction_operators(going_next: torch.Tensor, cfg: SchwarzConfig, n: int):
    """One-hot transfer operators rederived from going_next.

    Returns (onehot f32[total//32,32,32], pos i32[total-cap0], pb
    i32[total//32]) — the same tensors build_hierarchy emits (see
    Hierarchy). A bank's smallest parent id anchors its consecutive
    cluster-id range.
    """
    dev = going_next.device
    levels = cfg.num_levels(n)
    offs = cfg.level_offsets(n)
    total = offs[-1]
    onehot = torch.zeros((total // BANK, BANK, BANK), dtype=torch.float32, device=dev)
    pos = torch.full((total - offs[1],), -1, dtype=torch.int32, device=dev)
    pbs = torch.full((total // BANK,), total, dtype=torch.int32, device=dev)
    lc_iota = torch.arange(BANK, dtype=torch.int32, device=dev)
    for l in range(levels - 1):
        g2 = going_next[offs[l]: offs[l + 1]].reshape(-1, BANK)     # [Bl,32]
        valid = g2 < total
        pb = torch.where(valid, g2, total).amin(dim=1).to(torch.int32)  # [Bl]
        local = torch.clamp(g2 - pb[:, None], 0, BANK - 1)
        oh = (valid[:, None, :] & (local[:, None, :] == lc_iota[None, :, None])).float()
        onehot[offs[l] // BANK: offs[l + 1] // BANK] = oh
        pbs[offs[l] // BANK: offs[l + 1] // BANK] = pb
        p_slot = _pos_and_anchors(pb, offs[l + 1], offs[l + 2], pb.shape[0])
        pos[offs[l + 1] - offs[1]: offs[l + 2] - offs[1]] = torch.where(
            p_slot >= 0, offs[l] + p_slot, -1
        ).to(torch.int32)
    return onehot, pos, pbs
