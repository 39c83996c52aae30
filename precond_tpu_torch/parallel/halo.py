"""Explicitly scheduled multi-rank PCG: halo SpMV, rank-summed dots, split
Schwarz apply (port of ``precond_tpu/parallel/halo.py``).

The JAX module runs the hot loop as one ``shard_map`` body; here every rank
is a process that runs that body on its own tensors and meets the others
through a comm.Group:

  * fine (level-0) rows are contiguous Morton-sorted slabs, multiples of
    the 32-node bank, so domains never straddle ranks;
  * the SpMV exchanges only the boundary rows it reads: two ring shifts of
    ``halo`` rows when every off-rank column lies within one slab (the
    contiguous mode), else one all_to_all of exactly the off-rank rows
    each rank reads (the sparse mode, host-built send/receive tables);
  * coarse levels (<= N/32 nodes) are replicated: every rank restricts its
    own rows into a partial level-1 vector, one rank-ordered sum makes it
    whole, and every rank applies all coarse blocks;
  * CG dot products are rank-ordered sums (comm.Group.all_reduce_sum).

Everything runs in SORTED vertex order. The host tables are NumPy and equal
the JAX package's bit for bit. Float scatter-adds go through
utils/scatter.accumulate_rows with the sentinel targets (the dump slots)
dropped before it, and ``jnp.take(mode="fill")`` through utils/gather.
The per-rank block applies are the hand-written kernels: K2 on a packed
table, K3 on a dense one (f32 or bf16).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SchwarzConfig
from ..ops.apply import ApplyState
from ..ops.blockcsr import BlockEll
from ..ops.contact import _active, _gap
from ..ops.cuda.packed_symv import PackedInverse, PackedInverseCM, packed_symv
from ..ops.cuda.symv import batched_symv
from ..ops.hierarchy import BANK
from ..ops.stencils import Stencils
from ..utils.gather import take_fill
from ..utils.scatter import accumulate_rows
from .comm import Group, exchange_plan
from .pcg import PcgResult, pcg


class HaloSystem(NamedTuple):
    """Sorted-order ELL system with halo-local column indices (all ranks').

    Contiguous mode (halo >= 0): idx_ext[v, k] indexes the halo-extended
    local x of v's rank: [halo left | own | halo right].

    Sparse mode (halo == -1): idx_ext[v, k] indexes [own rows | remote rows
    in this rank's need-list order]; send_idx / recv_perm drive one
    all_to_all of exactly the off-rank rows each rank reads.
    """

    diag: torch.Tensor       # f32[N,3,3] (sorted order)
    idx_ext: torch.Tensor    # i32[N,K] halo-local columns
    blocks: torch.Tensor     # f32[N,K,3,3]
    halo: int
    shard_rows: int
    send_idx: torch.Tensor   # i32[nsh, nsh, S] src-local rows to send to each dst
    recv_perm: torch.Tensor  # i32[nsh, R] need slot -> flat (src, slot) of the received block


class ShardedApply(NamedTuple):
    """ApplyState split into a row-sharded fine part and a replicated coarse
    part (all ranks' tables; local_apply_state takes one rank's).

    inv_fine / inv_coarse are dense [B,96,96] tables (f32 or bf16) or
    PackedInverse containers. A packed fine table is padded per shard and
    interleaved for `num_shards` ranks, so solve_sorted refuses it on a
    group of another size.
    """

    going_next_fine: torch.Tensor    # i32[rows] parent (coarse-vector index) per fine node
    anc1: torch.Tensor               # i32[rows] level-1 ancestor (coarse-vector index)
    inv_fine: object                 # f32[B0,96,96] | PackedInverse (batch sharded)
    inv_coarse: object               # f32[Bc,96,96] | PackedInverse (replicated)
    going_next_coarse: torch.Tensor  # i32[total_coarse+1] parent within the coarse vector
    n: int
    total_coarse: int
    # live level-1 node count (1 + max fine parent, rounded up to 8): the
    # restriction's rank sum covers only [0, l1_live) + a dump slot
    l1_live: int = 0
    num_shards: int = 1


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _empty_tables(num_shards: int):
    return (np.zeros((num_shards, num_shards, 0), np.int32), np.zeros((num_shards, 0), np.int32))


def build_halo_system(ell_sorted: BlockEll, num_shards: int) -> HaloSystem:
    """A sorted-order ELL matrix with halo-local column indexing (host NumPy).

    Contiguous halo when every off-shard column lies within one shard width
    of its row's shard (two ring shifts of `halo` rows at run time); else
    sparse remote lists (one all_to_all of exactly the rows each shard
    reads). N must divide into bank-aligned shards. The tables land on the
    ELL's device.
    """
    n, k = ell_sorted.idx.shape
    if n % (num_shards * BANK):
        raise ValueError(f"N = {n} does not split into {num_shards} bank-aligned shards; "
                         f"pad N to a multiple of {num_shards * BANK} first")
    dev = ell_sorted.idx.device
    rows_per = n // num_shards
    idx = _host(ell_sorted.idx).astype(np.int64)
    mask = _host(ell_sorted.mask)
    row = np.arange(n)[:, None]
    base = (row // rows_per) * rows_per
    off = np.where(mask, idx - base, 0)
    halo = int(max(0, max(-off.min(), off.max() - rows_per + 1)))
    halo = -(-halo // BANK) * BANK  # bank-align

    def system(idx_ext, halo_, send, recv):
        return HaloSystem(
            diag=ell_sorted.diag, idx_ext=torch.as_tensor(idx_ext.astype(np.int32), device=dev),
            blocks=ell_sorted.blocks, halo=halo_, shard_rows=rows_per,
            send_idx=torch.as_tensor(send, device=dev), recv_perm=torch.as_tensor(recv, device=dev))

    if halo <= rows_per:
        own = np.tile((np.arange(n) % rows_per + halo)[:, None], (1, k))
        return system(np.where(mask, off + halo, own), halo, *_empty_tables(num_shards))

    # ---- sparse remote-column exchange tables ---------------------------
    shard_of = idx // rows_per
    remote = mask & (shard_of != row // rows_per)
    needs = []  # per dst shard: sorted unique global rows it reads remotely
    for s in range(num_shards):
        rows_s = slice(s * rows_per, (s + 1) * rows_per)
        needs.append(np.unique(idx[rows_s][remote[rows_s]]))
    send, recv_perm = exchange_plan(needs, rows_per, num_shards)
    # columns: own rows -> [0, rows_per); remote -> rows_per + need slot
    idx_ext = idx - base
    for d in range(num_shards):
        rows_d = slice(d * rows_per, (d + 1) * rows_per)
        blk_rem = remote[rows_d]
        if blk_rem.any():
            sub = idx_ext[rows_d]
            sub[blk_rem] = rows_per + np.searchsorted(needs[d], idx[rows_d][blk_rem])
            idx_ext[rows_d] = sub
    own = np.arange(n)[:, None] % rows_per
    return system(np.where(mask, idx_ext, own), -1, send, recv_perm)


def _identity_blocks(nb: int, like: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(3 * BANK, dtype=like.dtype, device=like.device)
    return eye.expand(nb, 3 * BANK, 3 * BANK)


def split_apply_state(state: ApplyState, cfg: SchwarzConfig, n: int, num_shards: int = 1,
                      rows: Optional[int] = None) -> ShardedApply:
    """Split prepare() output into fine-sharded / coarse-replicated parts.

    Dense [B,96,96] tables split by block slicing. A PackedInverse's fine
    part is padded so every one of `num_shards` shards holds an equal,
    8-aligned block count, the padding INTERLEAVED per shard (each shard's
    slice = its own blocks + local zero padding); pass the group size of
    the solve. PackedInverseCM is refused: the halo path's vectors are
    row-major.

    `rows` (default ceil32(n), the level-0 capacity) is the padded fine row
    count of a ragged solve (parallel/sharded.py): rows past the capacity
    get the dump parent, the dump ancestor (which reads a zero) and
    identity blocks, so they stay decoupled.
    """
    if isinstance(state.inv96, PackedInverseCM):
        raise ValueError("halo path vectors are row-major; a comp-major PackedInverseCM "
                         "cannot be applied here (prepare with solve_layout='rows')")
    offs = cfg.level_offsets(n)
    cap0, total = offs[1], offs[-1]
    rows = cap0 if rows is None else rows
    if rows < cap0 or rows % BANK:
        raise ValueError(f"rows = {rows} must be a multiple of {BANK} of at least {cap0}")
    total_coarse = total - cap0
    dev = state.going_next.device
    gn = _host(state.going_next).astype(np.int64)
    # fine parents as indices into the coarse vector (sentinel -> dump slot)
    gnf = gn[:cap0]
    gnf = np.where(gnf >= total, total_coarse, gnf - cap0)
    gnf = np.concatenate([gnf, np.full(rows - cap0, total_coarse)]).astype(np.int32)
    gnc = gn[cap0: total + 1]
    gnc = np.where(gnc >= total, total_coarse, gnc - cap0).astype(np.int32)
    anc = _host(state.ancestors)
    anc1 = (anc[:, 0].astype(np.int64) - cap0) if anc.shape[1] else np.zeros(n, np.int64)
    anc1 = np.concatenate([anc1, np.full(rows - n, total_coarse)]).astype(np.int32)
    live = gnf[gnf < total_coarse]
    l1_live = int(live.max()) + 1 if live.size else 0
    l1_live = min(-(-l1_live // 8) * 8, total_coarse)
    b0, b0_rows = cap0 // BANK, rows // BANK
    if b0_rows % num_shards:
        raise ValueError(f"{b0_rows} fine blocks do not split over {num_shards} shards")
    inv = state.inv96
    if isinstance(inv, PackedInverse):
        bc = total // BANK - b0
        f, dg = inv.f[:, :, :b0], inv.dg[:, :b0]
        if b0_rows > b0:   # identity blocks: zero off-diagonals, unit diagonal
            f = torch.cat([f, f.new_zeros((48, 96, b0_rows - b0))], dim=2)
            dg = torch.cat([dg, dg.new_ones((96, b0_rows - b0))], dim=1)
        t = b0_rows // num_shards
        per = -(-t // 8) * 8
        if per != t:
            f = torch.nn.functional.pad(f.reshape(48, 96, num_shards, t), (0, per - t))
            dg = torch.nn.functional.pad(dg.reshape(96, num_shards, t), (0, per - t))
        fine = PackedInverse(f=f.reshape(48, 96, num_shards * per).contiguous(),
                             dg=dg.reshape(96, num_shards * per).contiguous(), nb=b0_rows)
        cf, cdg = inv.f[:, :, b0: b0 + bc], inv.dg[:, b0: b0 + bc]
        pad = (-bc) % 8
        coarse = PackedInverse(f=torch.nn.functional.pad(cf, (0, pad)).contiguous(),
                               dg=torch.nn.functional.pad(cdg, (0, pad)).contiguous(), nb=bc)
        inv_fine, inv_coarse = fine, coarse
    else:
        inv_fine, inv_coarse = inv[:b0], inv[b0:]
        if b0_rows > b0:
            inv_fine = torch.cat([inv_fine, _identity_blocks(b0_rows - b0, inv)])
    return ShardedApply(
        going_next_fine=torch.as_tensor(gnf, device=dev),
        anc1=torch.as_tensor(anc1, device=dev),
        inv_fine=inv_fine,
        inv_coarse=inv_coarse,
        going_next_coarse=torch.as_tensor(gnc, device=dev),
        n=n,
        total_coarse=total_coarse,
        l1_live=l1_live,
        num_shards=num_shards,
    )


class LocalHalo(NamedTuple):
    """One rank's rows of a HaloSystem."""

    diag: torch.Tensor     # f32[rows,3,3]
    idx_ext: torch.Tensor  # i64[rows,K]
    blocks: torch.Tensor   # f32[rows,K,3,3]
    halo: int
    send: torch.Tensor     # i64[nsh,S] this rank's rows to send to each rank
    recv: torch.Tensor     # i64[R] need slot -> flat (src, slot)


class LocalApply(NamedTuple):
    """One rank's part of a ShardedApply: its fine rows and blocks, every
    coarse table."""

    gnf: torch.Tensor      # i32[rows]
    anc1: torch.Tensor     # i32[rows]
    inv_fine: object       # [rows/32,96,96] or PackedInverse f32[48,96,per] (own copy)
    inv_coarse: object
    gnc: torch.Tensor      # i32[total_coarse+1]
    total_coarse: int
    l1: int                # live level-1 span of the restriction's rank sum


def local_halo(hsys: HaloSystem, rank: int) -> LocalHalo:
    rows = slice(rank * hsys.shard_rows, (rank + 1) * hsys.shard_rows)
    sparse = hsys.halo < 0
    return LocalHalo(
        diag=hsys.diag[rows], idx_ext=hsys.idx_ext[rows].long(), blocks=hsys.blocks[rows],
        halo=hsys.halo,
        send=hsys.send_idx[rank].long() if sparse else hsys.send_idx[0, :0].long(),
        recv=hsys.recv_perm[rank].long() if sparse else hsys.recv_perm[0, :0].long())


def local_apply_state(sap: ShardedApply, rank: int, rows_per: int) -> LocalApply:
    """Rank's fine rows and blocks; a packed fine table's [48,96,per] slice
    is copied so the kernel reads a contiguous, aligned table."""
    rows = slice(rank * rows_per, (rank + 1) * rows_per)
    inv = sap.inv_fine
    if isinstance(inv, PackedInverse):
        per = inv.f.shape[2] // sap.num_shards
        cols = slice(rank * per, (rank + 1) * per)
        fine = PackedInverse(f=inv.f[:, :, cols].contiguous(), dg=inv.dg[:, cols].contiguous(),
                             nb=rows_per // BANK)
    else:
        fine = inv[rank * rows_per // BANK: (rank + 1) * rows_per // BANK]
    return LocalApply(gnf=sap.going_next_fine[rows], anc1=sap.anc1[rows], inv_fine=fine,
                      inv_coarse=sap.inv_coarse, gnc=sap.going_next_coarse,
                      total_coarse=sap.total_coarse, l1=sap.l1_live or sap.total_coarse)


def _block_apply(inv, rhs96: torch.Tensor) -> torch.Tensor:
    """z_b = inv_b r_b per block: K2 on a packed table, K3 on a dense one."""
    if isinstance(inv, PackedInverse):
        return packed_symv(inv, rhs96)
    return batched_symv(inv, rhs96)


def local_spmv(group: Group, lh: LocalHalo, x_l: torch.Tensor) -> torch.Tensor:
    """This rank's rows of H x, from its own rows of x and the halo."""
    if lh.halo < 0:
        # sparse mode: send exactly the rows each peer reads, one all_to_all,
        # then arrange the received rows in this rank's need-list order
        nsh, s_cap = lh.send.shape
        received = group.all_to_all(x_l[lh.send.reshape(-1)].reshape(nsh, s_cap, 3))
        xext = torch.cat([x_l, received.reshape(-1, 3)[lh.recv]])
    elif lh.halo:
        left = group.ring_shift(x_l[-lh.halo:], +1)
        right = group.ring_shift(x_l[:lh.halo], -1)
        xext = torch.cat([left, x_l, right])
    else:
        xext = x_l
    xg = xext[lh.idx_ext]
    return torch.einsum("nkij,nkj->ni", lh.blocks, xg) + torch.einsum("nij,nj->ni", lh.diag, x_l)


def local_contact_spmv(group: Group, st: Stencils, x_l: torch.Tensor, rank: int,
                       rows_per: int) -> torch.Tensor:
    """This rank's rows of the rank-1 stencil contact SpMV
    (ops/contact.stencil_contact_spmv).

    The stencil set is replicated (sorted-space ids). Each rank puts the
    stencil-vertex rows it owns into one rank sum of the compact [S,5,3]
    gather, computes every stencil's rank-1 product and places only into
    its own rows."""
    act = _active(st)
    loc = st.idx.long() - rank * rows_per
    own = act & (loc >= 0) & (loc < rows_per)
    xg = x_l[torch.clamp(loc, 0, rows_per - 1)]
    xs = group.all_reduce_sum(torch.where(own[..., None], xg, torch.zeros_like(xg)))
    w = torch.where(act, st.weight, torch.zeros_like(st.weight))
    t = _gap(w, xs, st.direction)
    ys = ((st.stiff * t)[:, None] * w)[:, :, None] * st.direction[:, None, :]
    out = x_l.new_zeros((rows_per, 3))
    accumulate_rows(out, loc.reshape(-1), ys.reshape(-1, 3), own.reshape(-1))
    return out


def local_apply(group: Group, la: LocalApply, cfg: SchwarzConfig, n: int,
                r_l: torch.Tensor) -> torch.Tensor:
    """This rank's rows of z = M^-1 r (the split Schwarz apply)."""
    levels = cfg.num_levels(n)
    cap0 = cfg.level_offsets(n)[1]
    coffs = [o - cap0 for o in cfg.level_offsets(n)[1:]]  # coarse-vector level bounds
    tc, l1 = la.total_coarse, la.l1
    # restriction: own fine rows -> partial level-1 vector, summed over ranks.
    # Fine parents are level-1 nodes, so the sum spans the live level-1 rows.
    partial = r_l.new_zeros((l1, 3))
    accumulate_rows(partial, la.gnf, r_l, la.gnf < l1)
    coarse = r_l.new_zeros((tc, 3))
    coarse[:l1] = group.all_reduce_sum(partial)
    for l in range(1, levels - 1):
        seg = slice(coffs[l - 1], coffs[l])
        accumulate_rows(coarse, la.gnc[seg], coarse[seg].clone(), la.gnc[seg] < tc)
    # own fine blocks + every coarse block
    zf = _block_apply(la.inv_fine, r_l.reshape(-1, 3 * BANK)).reshape(-1, 3)
    zc = _block_apply(la.inv_coarse, coarse.reshape(-1, 3 * BANK)).reshape(-1, 3)
    # top-down pre-sum over the applied coarse levels, then one local gather
    top = min(levels, cfg.max_applied_levels)
    pz = zc
    for l in range(top - 2, 0, -1):
        seg = slice(coffs[l - 1], coffs[l])
        pz[seg] += take_fill(pz, la.gnc[seg])
    if top > 1:
        coarse_term = take_fill(pz, la.anc1)   # padded rows read the dump: zero
        if cfg.coarse_damping != 1.0:
            coarse_term = coarse_term * cfg.coarse_damping
        zf = zf + coarse_term
    return zf


def halo_pcg_solver(group: Group, cfg: SchwarzConfig, n: int, tol: float = 1e-4,
                    max_iters: int = 400):
    """The per-rank PCG solve: (LocalHalo, LocalApply, own rows of sorted b,
    optional replicated sorted-space Stencils) -> PcgResult of own rows.

    `n` is the vertex count of the hierarchy's geometry (cfg.level_offsets).
    """

    def solve(lh: LocalHalo, la: LocalApply, b_l: torch.Tensor,
              stencils: Optional[Stencils] = None) -> PcgResult:
        rows_per = b_l.shape[0]

        def spmv_op(v):
            q = local_spmv(group, lh, v)
            if stencils is not None:
                q = q + local_contact_spmv(group, stencils, v, group.rank, rows_per)
            return q

        return pcg(spmv_op, lambda r: local_apply(group, la, cfg, n, r), b_l, tol=tol,
                   max_iters=max_iters, reduce_sum=group.all_reduce_sum)

    return solve


def solve_sorted(group: Group, cfg: SchwarzConfig, halo_sys: HaloSystem, sap: ShardedApply,
                 b_sorted: torch.Tensor, tol: float = 1e-4, max_iters: int = 400,
                 stencils: Optional[Stencils] = None) -> PcgResult:
    """Sorted-order solve over the group. Every rank passes the whole sorted
    b (and the whole HaloSystem / ShardedApply); each gets back its own
    rows of x (rows rank * shard_rows onwards).

    `stencils` (optional): sorted-space collision Stencils whose rank-1
    contact terms join the sharded SpMV (replicated on every rank).
    """
    rows = b_sorted.shape[0]
    if rows != halo_sys.shard_rows * group.world:
        raise ValueError(f"the halo system has {halo_sys.shard_rows} rows per shard; "
                         f"{rows} rows do not split over {group.world} ranks that way")
    if isinstance(sap.inv_fine, PackedInverse) and sap.num_shards != group.world:
        raise ValueError(f"the packed fine table was split for {sap.num_shards} shards "
                         f"(split_apply_state num_shards); the group has {group.world} ranks")
    per = halo_sys.shard_rows
    solve = halo_pcg_solver(group, cfg, sap.n, tol, max_iters)
    b_l = b_sorted[group.rank * per: (group.rank + 1) * per]
    return solve(local_halo(halo_sys, group.rank), local_apply_state(sap, group.rank, per),
                 b_l, stencils)
