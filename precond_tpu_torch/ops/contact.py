"""Contact fill-in: collision-stencil Hessians as a system-matrix term (port
of ``precond_tpu/ops/contact.py``).

The reference's host simulator assembles contact penalty Hessians INTO the
system CSR it hands the preconditioner (SURVEY §1); the EF/EE/VF sets exist
so the preconditioner can track that same coupling (cpp:67-72). A
preconditioner with contact terms the system lacks is harmful, so a
contact solve needs H to carry the fill-in too.

Per stencil (<=5 verts, weights w, stiffness s, direction d — the rank-1
model of PrepareCollisionHessian, cpp:1201-1227):

    H_c = s * (w w^T) (x) (d d^T)

i.e. block (i, j) = s * w_i * w_j * d d^T. Four forms of the same operator:
the compact-row contact ELL (build_contact_ell + contact_spmv), the rank-1
stencil form with a scatter (stencil_contact_spmv), the slot form with no
scatter per iteration (build_contact_slots + slot_contact_spmv, the one PCG
uses on the card) and the diagonal alone (contact_diag, for block-Jacobi).

Every float scatter-add of the JAX module is utils/scatter.accumulate_rows
here (a fixed-order segmented sum, never an atomic add on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.scatter import accumulate_rows
from .stencils import Stencils


class ContactEll(NamedTuple):
    """Compact-row contact off-diagonals + per-vertex diagonal adds.

    Only rows that actually have contacts occupy slots (R = max_rows cap),
    so the SpMV term gathers R*Kc rows and places R rows."""

    rows: torch.Tensor     # i32[R] vertex of each compact row (n = padding)
    idx: torch.Tensor      # i32[R, Kc] column vertex of each slot
    blocks: torch.Tensor   # f32[R, Kc, 3, 3]
    mask: torch.Tensor     # bool[R, Kc]
    diag: torch.Tensor     # f32[N, 3, 3] contact diagonal contributions
    dropped: torch.Tensor  # i32[] pairs beyond the Kc budget or R row cap


def _active(st: Stencils) -> torch.Tensor:
    """bool[S,5]: the live slots of each stencil."""
    return st.valid[:, None] & (torch.arange(5, device=st.idx.device)[None, :] < st.nverts[:, None])


def _ddt(st: Stencils) -> torch.Tensor:
    d = st.direction
    return st.stiff[:, None, None] * d[:, :, None] * d[:, None, :]   # [S,3,3]


def _stencil_pairs_flat(st: Stencils, n: int):
    """All ordered vertex pairs (i != j) and diagonal terms of the stencils.

    Returns (row i32[P], col i32[P], mat f32[P,3,3], valid bool[P]) for the
    off-diagonals and (ids i32[Q], mat f32[Q,3,3], valid bool[Q]) for the
    diagonal w_i^2 terms.
    """
    w = st.weight                                         # [S,5]
    act = _active(st)
    ddt = _ddt(st)

    ii = np.arange(5)
    pi, pj = np.meshgrid(ii, ii, indexing="ij")
    off = pi.reshape(-1) != pj.reshape(-1)                # 25 -> 20 live combos
    dev = w.device
    pi = torch.as_tensor(pi.reshape(-1)[off], device=dev)
    pj = torch.as_tensor(pj.reshape(-1)[off], device=dev)  # [20]

    row = st.idx[:, pi].reshape(-1)                       # [S*20]
    col = st.idx[:, pj].reshape(-1)
    wij = (w[:, pi] * w[:, pj]).reshape(-1)
    pv = (act[:, pi] & act[:, pj]).reshape(-1)
    mat = wij[:, None, None] * ddt.repeat_interleave(20, dim=0)

    dids = st.idx.reshape(-1)                             # [S*5]
    dw2 = (w * w).reshape(-1)
    dmat = dw2[:, None, None] * ddt.repeat_interleave(5, dim=0)
    return (row, col, mat, pv & (row < n) & (col < n)), (dids, dmat, act.reshape(-1))


def build_contact_ell(st: Stencils, n: int, kc: int = 16, max_rows: int | None = None
                      ) -> ContactEll:
    """Bucket stencil off-diagonals into a compact [R, kc] contact ELL.

    Sort pairs lexicographically, rank unique pairs within each row's run,
    densely number the active rows, place into slots; pairs beyond the kc
    or R budgets are counted in `dropped`. R defaults to 5x the stencil
    count (a row needs a stencil to be active).
    """
    (row, col, mat, valid), (dids, dmat, dvalid) = _stencil_pairs_flat(st, n)
    dev = row.device
    rows_key = torch.where(valid, row, torch.full_like(row, n))
    cols_key = torch.where(valid, col, torch.full_like(col, n))
    # lexicographic (row, col) via two stable argsorts: duplicate pairs from
    # overlapping stencils form runs that MERGE into one slot (their blocks
    # accumulate), so kc budgets unique partners, not raw stencil pairs.
    o1 = torch.argsort(cols_key, stable=True)
    o2 = torch.argsort(rows_key[o1], stable=True)
    order = o1[o2]
    r_s = rows_key[order]
    c_s = cols_key[order]
    true1 = torch.ones((1,), dtype=torch.bool, device=dev)
    pair_start = torch.cat([true1, (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])])
    uid = torch.cumsum(pair_start.to(torch.int32), 0, dtype=torch.int32) - 1   # unique-pair index
    row_start = torch.cat([true1, r_s[1:] != r_s[:-1]])
    uid_base = torch.cummax(torch.where(row_start, uid, torch.zeros_like(uid)), 0).values
    rank = uid - uid_base                                  # unique rank in row
    # dense numbering of ACTIVE rows (compact-row layout)
    rid = torch.cumsum((row_start & (r_s < n)).to(torch.int32), 0, dtype=torch.int32) - 1
    if max_rows is None:
        max_rows = min(n, 5 * st.idx.shape[0])
    r_cap = max_rows
    ok = (r_s < n) & (rank < kc) & (rid < r_cap)
    slot = (rid * kc + rank).long()
    idx = torch.zeros((r_cap * kc,), dtype=torch.int32, device=dev)
    msk = torch.zeros((r_cap * kc,), dtype=torch.bool, device=dev)
    blk = torch.zeros((r_cap * kc, 9), dtype=torch.float32, device=dev)
    rws = torch.full((r_cap,), n, dtype=torch.int32, device=dev)
    # every pair of a slot carries the same column (and of a row the same
    # row id), so these plain writes are order-independent
    keep = ok.nonzero().reshape(-1)
    slot_k = slot[keep]
    idx[slot_k] = c_s[keep].to(torch.int32)
    msk[slot_k] = True
    accumulate_rows(blk, slot_k, mat.reshape(-1, 9)[order[keep]])
    rws[rid[keep].long()] = r_s[keep].to(torch.int32)
    dropped = (pair_start & (r_s < n) & ((rank >= kc) | (rid >= r_cap))).sum()

    diag = torch.zeros((n, 9), dtype=torch.float32, device=dev)
    accumulate_rows(diag, dids, dmat.reshape(-1, 9), dvalid)
    return ContactEll(
        rows=rws,
        idx=idx.reshape(r_cap, kc),
        blocks=blk.reshape(r_cap, kc, 3, 3),
        mask=msk.reshape(r_cap, kc),
        diag=diag.reshape(n, 3, 3),
        dropped=dropped.to(torch.int32),
    )


def _gap(w: torch.Tensor, xs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """einsum("sv,svk,sk->s"): d . sum_i w_i x_i per stencil."""
    return ((w[:, :, None] * xs).sum(dim=1) * d).sum(dim=-1)


def contact_forces(st: Stencils, x: torch.Tensor, rest_gap) -> torch.Tensor:
    """Gap-aware penalty forces of the collision stencils. -> f32[N,3].

    Penalty energy per stencil E = 1/2 * stiff * max(rest_gap - g, 0)^2 with
    g = d . sum_i w_i x_i (the signed separation along the repulsion
    direction), so f_i = stiff * max(rest_gap - g, 0) * w_i * d; its
    Gauss-Newton Hessian (d, w frozen) is exactly the stiff * w_i w_j d d^T
    of collision_terms / build_contact_ell. The weights of each primitive
    sum to ±1, so sum_i f_i = 0: contacts conserve momentum.
    """
    n = x.shape[0]
    act = _active(st)
    w = torch.where(act, st.weight, torch.zeros_like(st.weight))     # [S,5]
    xs = x[torch.clamp(st.idx, 0, n - 1).long()]                     # [S,5,3]
    g = _gap(w, xs, st.direction)                                    # [S]
    mag = st.stiff * torch.clamp(rest_gap - g, min=0.0)              # [S]
    fs = (mag[:, None] * w)[:, :, None] * st.direction[:, None, :]   # [S,5,3]
    out = x.new_zeros((n, 3))
    accumulate_rows(out, st.idx.reshape(-1), fs.reshape(-1, 3), act.reshape(-1))
    return out


def stencil_contact_spmv(st: Stencils, x: torch.Tensor) -> torch.Tensor:
    """y = H_contact x via the rank-1 stencil factorization (the SpMV-time
    twin of contact_forces' Gauss-Newton Hessian): per stencil
    t = d . (sum_i w_i x_i) and y_i += stiff * w_i * t * d. Same operator as
    contact_spmv (duplicate pairs merge by summation; fp order differs)."""
    n = x.shape[0]
    act = _active(st)
    w = torch.where(act, st.weight, torch.zeros_like(st.weight))     # [S,5]
    xs = x[torch.clamp(st.idx, 0, n - 1).long()]
    t = _gap(w, xs, st.direction)                                    # [S]
    ys = ((st.stiff * t)[:, None] * w)[:, :, None] * st.direction[:, None, :]
    out = x.new_zeros((n, 3))
    accumulate_rows(out, st.idx.reshape(-1), ys.reshape(-1, 3), act.reshape(-1))
    return out


class ContactSlots(NamedTuple):
    """Prepare-time slot-sorted factorization of the rank-1 stencil SpMV.

    The P = S*5 flat (stencil, vert) slots are sorted by target row once
    per prepare (the stencil set is fixed per prepare, as the reference
    rebuilds its stencil tables per PreparePreconditioner, cpp:304-413).
    The per-iteration apply then needs no scatter: one wide gather of x,
    one scalar gather of the per-stencil coefficients, and one segmented
    sum over each row's run of sorted slots.

    The JAX package reads each row's sum off a global cumsum as a boundary
    difference. A float cumsum on the card has no deterministic kernel, and
    the difference form's error is absolute in the running prefix; the
    port instead gathers each row's run through `seg` (its sorted slot
    positions, padded with P, which reads a zero) and sums it along a fixed
    axis, which is bit-reproducible and adds only the row's own terms.
    """

    ids: torch.Tensor     # i32[P] stencil-order clipped gather rows (S*5)
    w5: torch.Tensor      # f32[S,5] signed weights (0 for inactive slots)
    d: torch.Tensor       # f32[S,3] stencil directions
    stiff: torch.Tensor   # f32[S]
    sid: torch.Tensor     # i32[P] stencil id of each SORTED slot
    wd: torch.Tensor      # f32[3,P] sorted slot (weight * direction) planes
    bounds: torch.Tensor  # i32[N+1]: #sorted slots with target row < v
    seg: torch.Tensor     # i32[N, Kmax] sorted slot positions of each row, P = padding


def build_contact_slots(st: Stencils, n: int) -> ContactSlots:
    """Sort the S*5 stencil slots by target row; precompute the gather
    tables, the per-row prefix boundaries (histogram + cumsum) and each
    row's padded run of sorted slots. Runs at prepare time; reading the
    longest run's length is one host sync."""
    act = _active(st)
    w = torch.where(act, st.weight, torch.zeros_like(st.weight))     # [S,5]
    live = act & (st.idx >= 0) & (st.idx < n)
    rows = torch.where(live, st.idx, torch.full_like(st.idx, n)).reshape(-1)   # [P], n = inactive
    p = rows.shape[0]
    dev = rows.device
    order = torch.argsort(rows, stable=True).to(torch.int32)
    sid = torch.div(order, 5, rounding_mode="floor")
    wsl = w.reshape(-1)[order.long()]
    dsl = st.direction.T[:, sid.long()]                               # [3,P]
    counts = torch.bincount(rows.long(), minlength=n + 1)[:n]
    bounds = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(counts, 0).to(torch.int32)])
    kmax = int(counts.max()) if n > 0 and p > 0 else 0
    k = torch.arange(kmax, dtype=torch.int32, device=dev)
    pos = bounds[:-1, None] + k[None, :]
    seg = torch.where(k[None, :] < counts[:, None].to(torch.int32), pos, torch.full_like(pos, p))
    return ContactSlots(
        ids=torch.clamp(st.idx, 0, n - 1).reshape(-1),
        w5=w,
        d=st.direction,
        stiff=st.stiff,
        sid=sid,
        wd=wsl[None, :] * dsl,
        bounds=bounds,
        seg=seg,
    )


def _slot_apply(cs: ContactSlots, x: torch.Tensor) -> torch.Tensor:
    """Core apply: x f32[N,3] -> y planes f32[3,N]."""
    s = cs.w5.shape[0]
    xs = x[cs.ids.long()].reshape(s, 5, 3)                # one wide gather
    a = cs.stiff * _gap(cs.w5, xs, cs.d)                  # [S]
    ys = a[cs.sid.long()][None, :] * cs.wd                # [3,P]
    ys = torch.cat([ys, ys.new_zeros((3, 1))], dim=1)     # column P reads zero
    return ys[:, cs.seg.long()].sum(dim=-1)               # [3,N]


def slot_contact_spmv_t(cs: ContactSlots, xt: torch.Tensor) -> torch.Tensor:
    """y^T = H_contact x^T on comp-major [3,N] planes, scatter-free.

    Same operator as stencil_contact_spmv (fp order differs: each row adds
    its slots in row-sorted slot order)."""
    return _slot_apply(cs, xt.T)


def slot_contact_spmv(st: Stencils, cs: ContactSlots, x: torch.Tensor) -> torch.Tensor:
    """Row-major wrapper ([N,3] in/out). `st` is unused (the slots carry
    everything) and kept for signature parity with stencil_contact_spmv."""
    del st
    return _slot_apply(cs, x).T


def contact_diag(st: Stencils, n: int) -> torch.Tensor:
    """f32[N,3,3] contact diagonal blocks (for block-Jacobi of the full
    system), without building the off-diagonal ELL."""
    act = _active(st)
    w = torch.where(act, st.weight, torch.zeros_like(st.weight))
    dmat = (w * w).reshape(-1)[:, None, None] * _ddt(st).repeat_interleave(5, dim=0)
    out = w.new_zeros((n, 9))
    accumulate_rows(out, st.idx.reshape(-1), dmat.reshape(-1, 9), act.reshape(-1))
    return out.reshape(n, 3, 3)


def contact_spmv(ce: ContactEll, x: torch.Tensor) -> torch.Tensor:
    """y = H_contact x: R*Kc-row gather + R-row placement + diagonal term."""
    n = x.shape[0]
    xg = x[ce.idx.long()]                                  # [R,Kc,3]
    blocks = torch.where(ce.mask[:, :, None, None], ce.blocks, torch.zeros_like(ce.blocks))
    off = torch.einsum("rkij,rkj->ri", blocks, xg)
    y = x.new_zeros((n, 3))
    accumulate_rows(y, ce.rows, off, ce.rows < n)
    return y + torch.einsum("nij,nj->ni", ce.diag, x)
