"""Banked domain Hessian assembly (port of ``precond_tpu/ops/assembly.py``).

Reference: PrepareHessian (cpp:1229-1345), AdditionalSchwarzHessian2
(cpp:1164-1199). The banked storage is a [total, 288] row table — row =
node, column = a*96 + lane*3 + b — so a row holds the node's three
DOF-rows of its 96x96 domain matrix and the final [B,96,96] tensor is a
pure reshape.

Semantics, as in the JAX package:
  * a pair contribution resolved at level λ lands symmetrically in that
    level's bank, and its diagonal compensation lands on the parent chain
    above λ (cpp:1184-1198, 1297-1343);
  * self diagonals (+ collision w² terms) land on the full ancestor chain;
  * pairs that never share a bank within the level budget drop
    (cpp:1288-1291);
  * empty padded diagonal blocks are identity-filled (cpp:1365-1367).

The JAX broadcast-multiply-reduce forms are batched matmuls here (eager
PyTorch would materialize the broadcast product: [32768,32,32,288] f32 at
1M vertices). Their one-hot factor makes every product exact; only the
summation order differs.

Collision terms (stencil pairs and w² diagonals) are placed by
utils/scatter.accumulate_rows, never by an atomic add, so the prepare stays
bit-reproducible on the card: small sets as 288-wide row placements and
9-wide scalar placements, sets above BIG_PAIR_THRESHOLD pairs as dense
segment sums (segment_place9) added into the table.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import SchwarzConfig
from ..utils.gather import take_fill
from ..utils.scatter import accumulate_rows
from .blockcsr import BlockEll
from .hierarchy import BANK, Hierarchy

ROW = 3 * BANK * 3  # 288 columns per node row
# pair count above which collision placement switches to the dense
# segment_place9 form (the JAX package's threshold, kept so both packages
# take the same branch on the same input)
BIG_PAIR_THRESHOLD = 32768
_CHUNK = 1 << 18    # rows per _level_rows chunk (bounds the [C,32,K] transient)


class CollisionTerms(NamedTuple):
    """Pairwise collision contributions, fine sorted space (from stencils)."""

    pair_a: torch.Tensor      # i32[P] first vertex (mapped)
    pair_b: torch.Tensor      # i32[P] second vertex (mapped)
    pair_mat: torch.Tensor    # f32[P,3,3] w_a*w_b*stiff*d d^T
    pair_valid: torch.Tensor  # bool[P]
    diag_ids: torch.Tensor    # i32[Q] vertex (mapped) for w^2 diagonal terms
    diag_mat: torch.Tensor    # f32[Q,3,3]
    diag_valid: torch.Tensor  # bool[Q]


def node_ancestor_table(going_next: torch.Tensor, levels: int, total: int) -> torch.Tensor:
    """ANC[x, l] = x climbed l levels (sentinel-saturating). i32[total+1, L]."""
    cols = [torch.arange(total + 1, dtype=torch.int32, device=going_next.device)]
    for _ in range(1, levels):
        cols.append(going_next[cols[-1]])
    return torch.stack(cols, dim=1)


def common_bank_climb(
    my: torch.Tensor,
    ot: torch.Tensor,
    going_next: torch.Tensor,
    levels: int,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Climb both node ids up the hierarchy until they share a bank.

    Returns (my', ot', merged); merged is False for pairs that never share
    a bank within `levels` climbs (reference skips those, cpp:1178-1179).
    """
    lam = torch.zeros(my.shape, dtype=torch.int32, device=my.device)
    for _ in range(levels):
        same = torch.div(my, BANK, rounding_mode="floor") == torch.div(ot, BANK, rounding_mode="floor")
        step = (~same) & (lam < levels)
        my = torch.where(step, going_next[my.long()], my)
        ot = torch.where(step, going_next[ot.long()], ot)
        lam = lam + step.to(torch.int32)
    merged = (torch.div(my, BANK, rounding_mode="floor") == torch.div(ot, BANK, rounding_mode="floor")) \
        & (lam < levels) & (my < total)
    return my, ot, merged


def _tile288(mat9: torch.Tensor) -> torch.Tensor:
    """[..., 9] -> [..., 288] with component (a*3+b) at column a*96+y*3+b."""
    lead = mat9.shape[:-1]
    m33 = mat9.reshape(lead + (3, 1, 3))
    return m33.expand(lead + (3, BANK, 3)).reshape(lead + (ROW,))


def _ycol(device) -> torch.Tensor:
    """Lane (other node % 32) of each of the 288 row columns."""
    return (torch.arange(ROW, device=device) % 96) // 3


def _diag_rows(mat9: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """[M,9] blocks placed at their diagonal lane -> [M,288] row payloads."""
    return _tile288(mat9) * (lane[:, None] == _ycol(mat9.device)[None, :])


def _row_scatter(hb2: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                 valid: torch.Tensor, total: int) -> None:
    """hb2[rows] += vals in place for the valid rows below `total`."""
    accumulate_rows(hb2[:total], rows.reshape(-1), vals, valid.reshape(-1))


def _scalar_scatter9(flat: torch.Tensor, ids: torch.Tensor, mat9: torch.Tensor,
                     valid: torch.Tensor, size: int) -> torch.Tensor:
    """flat[ids*9 + c] += mat9[:, c] (the small-set placement)."""
    buf = flat.reshape(size, 9).clone()
    accumulate_rows(buf, ids, mat9, valid)
    return buf.reshape(-1)


def segment_place9(ids: torch.Tensor, mat9: torch.Tensor, valid: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Dense segment sum: out[m] = sum of mat9 rows with ids == m, f32[size,9].

    The placement for large sets. It is a segmented sum (accumulate_rows:
    a stable sort by target, then each target's rows summed in order), so
    every output row only adds values of its own segment. A global cumsum
    differenced at segment boundaries would carry an error absolute in the
    running prefix (~|prefix| * eps): at contact stiffness 1e4 that noise
    swamped the mass-scale diagonals and stalled CG (the JAX package's
    segment_place9 note, ROADMAP Queue C item 1).
    """
    out = mat9.new_zeros((size, 9))
    accumulate_rows(out, ids, mat9, valid)
    return out


def _rows_from_lanes(lanes: torch.Tensor, blk9: torch.Tensor) -> torch.Tensor:
    """vals[c, a*96 + y*3 + b] = sum_k lanes[c,y,k] * blk9[c,k,a*3+b]. -> [C,288]."""
    v = torch.bmm(lanes, blk9)                                  # [C,32,9]
    return v.reshape(-1, BANK, 3, 3).permute(0, 2, 1, 3).reshape(-1, ROW)


def _diag_rows_add_(rows: torch.Tensor, mat9: torch.Tensor, lane: torch.Tensor) -> None:
    """rows[m] += mat9[m] placed at diagonal lane `lane[m]`, in place."""
    r4 = rows.view(-1, 3, BANK, 3)
    ar = torch.arange(r4.shape[0], device=rows.device)
    r4[ar, :, lane.long(), :] += mat9.reshape(-1, 3, 3)


def _level_rows(lane_ot, lam, ok, blk9, lane_my, dself9, level: int) -> torch.Tensor:
    """Per-vertex 288-wide row contributions for one hierarchy level.

    Combines, for the vertex's level-`level` ancestor node:
      * off-diagonal blocks of pairs resolved exactly at `level`
        (lane_ot = climbed neighbor % 32 at its merge level);
      * chain diagonal compensation of pairs resolved below `level`
        (lane_my = own ancestor % 32), cpp:1297-1343;
      * the self diagonal, every level, cpp:1270,1309-1321.
    """
    n = lam.shape[0]
    y = torch.arange(BANK, dtype=lane_ot.dtype, device=lane_ot.device)[None, :, None]
    out = blk9.new_empty((n, ROW))
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        ok_c, lam_c = ok[s:e], lam[s:e]
        sel = (ok_c & (lam_c == level))[:, None, :]
        lanes = (lane_ot[s:e, None, :] == y) & sel              # [C,32,K]
        if level > 0:
            sel_ch = (ok_c & (lam_c < level))[:, None, :]
            lanes = lanes | ((lane_my[s:e, None, None] == y) & sel_ch)
        out[s:e] = _rows_from_lanes(lanes.float(), blk9[s:e])
        _diag_rows_add_(out[s:e], dself9[s:e], lane_my[s:e])
    return out


def _reduce_rows_to_level(
    vals0: torch.Tensor, hier: Hierarchy, cfg: SchwarzConfig, n: int, level: int
) -> torch.Tensor:
    """Reduce fine-row payloads [n,288] to level-`level` rows [cap_l,288].

    Composes `level` anchored one-hot cluster reductions — each a per-bank
    batched matmul plus a small compaction gather — reproducing the
    scatter-by-ancestor sum: the one-hot chain IS repeated going_next.
    """
    offs = cfg.level_offsets(n)
    cap0 = offs[1]
    part = vals0.new_zeros((cap0, ROW))
    part[:n] = vals0
    for l in range(level):
        rb = part.reshape(-1, BANK, ROW)
        oh = hier.onehot[offs[l] // BANK: offs[l + 1] // BANK]
        red = torch.bmm(oh, rb)                                     # [W,lc,ROW]
        pos_l = hier.pos[offs[l + 1] - cap0: offs[l + 2] - cap0]
        part = take_fill(red.reshape(-1, ROW), pos_l - offs[l])
    return part


def assemble_banked_hessian(
    ell_sorted: BlockEll,
    hier: Hierarchy,
    cfg: SchwarzConfig,
    collisions: "CollisionTerms | None" = None,
    merge_map=None,
) -> torch.Tensor:
    """Assemble all domain Hessians -> f32[B, 96, 96] (B = total/32 blocks).

    `ell_sorted` is the system matrix permuted into Morton-sorted order.
    `collisions` (CollisionTerms, optional): stencil Hessian terms in sorted
    space. `merge_map` (hierarchy.NeighborMergeMap, optional): per-pair
    merge levels/lanes emitted by build_hierarchy; without it they are
    derived from the ancestor chains.
    """
    n = ell_sorted.num_verts
    levels = cfg.num_levels(n)
    total = cfg.total_capacity(n)
    nblocks = total // BANK
    gn = hier.going_next
    dev = gn.device

    # m_additionalHessian32 (cpp:168): per-node extra diagonal, flat [total*9].
    addl9 = None
    pair_rows = []          # (rows, vals[.,288], valid) of the small-set path
    pair_dense288 = None    # the big-set path's dense [total,288] placement
    if collisions is not None:
        addl9 = torch.zeros((total * 9,), dtype=torch.float32, device=dev)
        my_c, ot_c, merged = common_bank_climb(
            collisions.pair_a, collisions.pair_b, gn, levels, total)
        okc = merged & collisions.pair_valid
        pm9 = collisions.pair_mat.reshape(-1, 9)
        pmy = gn[torch.clamp(my_c, max=total).long()]
        pot = gn[torch.clamp(ot_c, max=total).long()]
        ok_up = okc & (pmy < total)
        if int(collisions.pair_a.shape[0]) > BIG_PAIR_THRESHOLD:
            addl9 = addl9 + segment_place9(
                collisions.diag_ids, collisions.diag_mat.reshape(-1, 9),
                collisions.diag_valid, total).reshape(-1)
            # symmetric into the shared bank (cpp:1181-1182), slot space
            slots = torch.cat([my_c * BANK + ot_c % BANK, ot_c * BANK + my_c % BANK])
            pm2 = torch.cat([pm9, pm9])
            ok2 = torch.cat([okc, okc])
            pair_dense = segment_place9(slots, pm2, ok2, total * BANK)
            pair_dense288 = (pair_dense.reshape(total, BANK, 3, 3)
                             .permute(0, 2, 1, 3).reshape(total, ROW))
            # parent diagonal compensation one level up (cpp:1184-1198);
            # coinciding parents receive the reference's 2x via both adds
            addl9 = addl9 + segment_place9(
                torch.cat([pmy, pot]), pm2, torch.cat([ok_up, ok_up]), total).reshape(-1)
        else:
            addl9 = _scalar_scatter9(addl9, collisions.diag_ids,
                                     collisions.diag_mat.reshape(-1, 9),
                                     collisions.diag_valid, total)
            ycol = _ycol(dev)
            pv = _tile288(pm9)
            # symmetric into the shared bank (cpp:1181-1182)
            pair_rows.append((my_c, pv * ((ot_c % BANK)[:, None] == ycol), okc))
            pair_rows.append((ot_c, pv * ((my_c % BANK)[:, None] == ycol), okc))
            # parent diagonal compensation one level further up
            # (cpp:1184-1198); coinciding parents get 2x via the two adds
            addl9 = _scalar_scatter9(addl9, pmy, pm9, ok_up, total)
            addl9 = _scalar_scatter9(addl9, pot, pm9, ok_up, total)

    # ---- pair merge levels (cpp:1282-1287) --------------------------------
    if merge_map is not None:
        lam, lane_ot, ok = merge_map.lam, merge_map.lane_ot, merge_map.ok
        lane_my = [hier.coarse_space[l] % BANK for l in range(levels)]
    else:
        anc = node_ancestor_table(gn, levels, total)    # i32[total+1, L]
        myanc = anc[:n]                                 # [N, L]
        otanc = anc[ell_sorted.idx]                     # [N, K, L]
        eq = torch.div(myanc[:, None, :], BANK, rounding_mode="floor") == torch.div(
            otanc, BANK, rounding_mode="floor")
        # first level where the banks coincide (argmax: first maximal index)
        lam = torch.argmax(eq.to(torch.uint8), dim=-1)
        ok = eq.any(dim=-1) & ell_sorted.mask
        lane_ot = torch.gather(otanc, 2, lam[:, :, None])[:, :, 0] % BANK
        lam = lam.to(torch.int32)
        lane_my = [myanc[:, l] % BANK for l in range(levels)]
    blk9 = ell_sorted.blocks.reshape(n, -1, 9)
    dself9 = ell_sorted.diag.reshape(n, 9)
    if addl9 is not None:
        dself9 = dself9 + addl9[: n * 9].reshape(n, 9)

    # ---- per-level row construction + placement --------------------------
    hb2 = blk9.new_zeros((total, ROW))
    offs = cfg.level_offsets(n)
    for l in range(levels):
        vals = _level_rows(lane_ot, lam, ok, blk9, lane_my[l], dself9, l)
        if l == 0:
            hb2[:n] += vals  # rows ARE the fine nodes
        else:
            hb2[offs[l]: offs[l + 1]] += _reduce_rows_to_level(vals, hier, cfg, n, l)
        del vals

    if collisions is not None:
        # ---- coarse-node additional, full chain (cpp:1236-1252) -----------
        coarse_off = cfg.level_offsets(n)[1] if levels > 1 else total
        if coarse_off < total:
            # ancestor chains for the coarse segment only (O(total/32) rows)
            ccols = [torch.arange(coarse_off, total, dtype=torch.int32, device=dev)]
            for _ in range(1, levels):
                ccols.append(gn[ccols[-1].long()])
            cmat9 = addl9[coarse_off * 9: total * 9].reshape(-1, 9)
            for ids in ccols:
                _row_scatter(hb2, ids, _diag_rows(cmat9, ids % BANK), ids < total, total)
        for rows, vals, valid in pair_rows:
            _row_scatter(hb2, rows, vals, valid, total)
        if pair_dense288 is not None:
            hb2 += pair_dense288

    # ---- identity-fill empty diagonals (cpp:1359-1377) --------------------
    node = torch.arange(total, device=hb2.device)
    d00 = hb2[node, (node % BANK) * 3]
    empty = (d00 == 0.0).reshape(nblocks, BANK)
    h96 = hb2.view(nblocks, 3 * BANK, 3 * BANK)  # rows ordered (lane, a)
    h96.diagonal(dim1=1, dim2=2).add_(empty.repeat_interleave(3, dim=1).to(h96.dtype))
    return h96
