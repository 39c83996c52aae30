"""Structured-grid solve steps, single device and sharded over ranks (port of
``precond_tpu/parallel/gridsharded.py``).

``grid_solve_step`` / ``grid_contact_solve_step``: one implicit step on the
static grid path as one function (prepare_grid, then grid-order PCG with
the stencil SpMV and the row-major grid apply; the contact variant adds the
stencil Hessians to M and the contact ELL to the solved system).

``sharded_grid_solve_step`` / ``sharded_grid_contact_solve_step`` run the
same step over a process group. The JAX package lets GSPMD partition it;
here the schedule is explicit:

  * every rank prepares redundantly on the whole system (K1) and keeps the
    fine blocks of its tile-order slab plus every coarse block, through
    parallel/halo.py's fine/coarse split fed by the analytic parent map
    (ops/gridapply.grid_going_next);
  * rank r owns grid rows [r * 2^k / P, (r+1) * 2^k / P); the SpMV is K4 on
    that slab extended by h = max |di| rows from each ring neighbour (zeros
    past the global edges), keeping the interior rows;
  * each crossing between grid order and tile order is one all_to_all with
    host-built tables (rank r owns the tile-order slab [r N/P, (r+1) N/P));
  * for contact, the stencils, the contact ELL and o2s are replicated, as
    in JAX; every rank computes the contact rows it owns.

As in the JAX package, dense inverses and the row-major layout are pinned.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import SchwarzConfig
from ..device import resolve_device
from ..ops import gridstencil
from ..ops.apply import ApplyState
from ..ops.contact import ContactEll, contact_spmv
from ..ops.gridapply import grid_going_next, precondition_grid
from ..ops.gridstencil import StencilSystem
from ..profiling import PhaseTimer, phase_of
from ..solver import prepare_grid
from ..utils import gridmorton as gm
from ..utils.scatter import accumulate_rows
from . import halo
from .comm import Group, exchange, exchange_plan
from .pcg import PcgResult, pcg


def grid_solve_step(
    ssys: StencilSystem,
    diag_rows: torch.Tensor,
    dirs_rows: torch.Tensor,
    b: torch.Tensor,
    offsets,
    k: int,
    cfg: SchwarzConfig,
    tol: float = 1e-4,
    max_iters: int = 200,
) -> PcgResult:
    """prepare_grid + grid-order PCG on the inputs' device.

    Pinned to dense inverses and the row-major layout, as in the JAX
    package (its GSPMD partitioning cannot split a kernel call): the SpMV
    is K4 through gridstencil.spmv, the apply K3."""
    cfg = dataclasses.replace(cfg, symv_kernel="dense", solve_layout="rows")
    inv96 = prepare_grid(diag_rows, dirs_rows, offsets, k, cfg)

    def pre_op(r):
        return gm.morton_to_grid(precondition_grid(inv96, gm.grid_to_morton(r, k), cfg), k)

    return pcg(lambda v: gridstencil.spmv(ssys, v), pre_op, b, tol=tol, max_iters=max_iters)


def grid_contact_solve_step(
    ssys: StencilSystem,
    diag_rows: torch.Tensor,
    dirs_rows: torch.Tensor,
    b: torch.Tensor,
    stencils,
    ce,
    o2s,
    offsets,
    k: int,
    cfg: SchwarzConfig,
    tol: float = 1e-4,
    max_iters: int = 200,
) -> PcgResult:
    """Contact-enabled grid solve: stencil Hessians in M (arithmetic climbs
    inside prepare_grid), the contact ELL `ce` (ops/contact.build_contact_ell)
    in the solved system. Dense inverses and rows, as grid_solve_step."""
    cfg = dataclasses.replace(cfg, symv_kernel="dense", solve_layout="rows")
    inv96 = prepare_grid(diag_rows, dirs_rows, offsets, k, cfg, stencils, o2s)

    def pre_op(r):
        return gm.morton_to_grid(precondition_grid(inv96, gm.grid_to_morton(r, k), cfg), k)

    return pcg(lambda v: gridstencil.spmv(ssys, v) + contact_spmv(ce, v), pre_op, b,
               tol=tol, max_iters=max_iters)


# ---- the sharded steps -----------------------------------------------------

def _full_offsets(offsets, sym: bool):
    """prepare takes the full +/- direction list (assemble_system_grid's
    layout); a sym=True system holds only the canonical planes."""
    return offsets if not sym else tuple(o for (di, dj) in offsets for o in ((di, dj), (-di, -dj)))


def _slab(t: torch.Tensor, r0: int, r1: int, h: int, nx: int, ny: int) -> torch.Tensor:
    """Grid rows [r0 - h, r1 + h) of vertex-minor planes t [..., nx * ny],
    zero past the grid's edges."""
    lo, hi = max(r0 - h, 0), min(r1 + h, nx)
    part = t[..., lo * ny: hi * ny]
    return F.pad(part, ((lo - (r0 - h)) * ny, ((r1 + h) - hi) * ny)).contiguous()


class GridSlab(NamedTuple):
    """One rank's piece of the stencil system: its grid rows extended by h
    rows on each side."""

    sys: StencilSystem   # grid (rows_per + 2h, ny)
    h: int               # halo rows


def grid_slab(ssys: StencilSystem, rank: int, world: int) -> GridSlab:
    nx, ny = ssys.grid
    if nx % world:
        raise ValueError(f"{nx} grid rows do not split over {world} ranks")
    per = nx // world
    h = max((abs(di) for di, _ in ssys.offsets), default=0)
    if h > per:
        raise ValueError(f"a halo of {h} grid rows is wider than a rank's {per} rows")
    r0, r1 = rank * per, (rank + 1) * per
    sys = StencilSystem(_slab(ssys.diag_t, r0, r1, h, nx, ny),
                        _slab(ssys.dirs_t, r0, r1, h, nx, ny),
                        ssys.offsets, (per + 2 * h, ny), sym=ssys.sym)
    return GridSlab(sys, h)


def slab_spmv(group: Group, gs: GridSlab, x_l: torch.Tensor) -> torch.Tensor:
    """This rank's rows of H x: K4 (or the sym form) on the extended slab,
    the h boundary rows from each ring neighbour, zeros past the edges."""
    hw = gs.h * gs.sys.grid[1]
    if not hw:
        return gridstencil.spmv(gs.sys, x_l)
    left = group.ring_shift(x_l[-hw:], +1)
    right = group.ring_shift(x_l[:hw], -1)
    if group.rank == 0:
        left = torch.zeros_like(left)
    if group.rank == group.world - 1:
        right = torch.zeros_like(right)
    y = gridstencil.spmv(gs.sys, torch.cat([left, x_l, right]))
    return y[hw: hw + x_l.shape[0]]


class ContactRows(NamedTuple):
    """One rank's rows of a replicated ContactEll."""

    cols: torch.Tensor    # i64[C] every column the contact rows read (replicated)
    own: torch.Tensor     # bool[C] columns this rank owns
    loc: torch.Tensor     # i64[C] their local rows (clamped)
    rows: torch.Tensor    # i64[Ro] local row of each owned contact row
    slot: torch.Tensor    # i64[Ro,Kc] index into cols of each slot
    blocks: torch.Tensor  # f32[Ro,Kc,3,3] (invalid slots zero)
    diag: torch.Tensor    # f32[rows_per,3,3] own rows of the contact diagonal


def contact_rows(ce: ContactEll, n: int, rank: int, rows_per: int) -> ContactRows:
    g0 = rank * rows_per
    live = ce.rows < n
    used = live[:, None] & ce.mask
    cols = torch.unique(ce.idx[used].long())          # sorted
    mine = live & (ce.rows >= g0) & (ce.rows < g0 + rows_per)
    slot = torch.searchsorted(cols, ce.idx[mine].long().contiguous())
    slot = torch.clamp(slot, max=max(cols.numel() - 1, 0))
    blocks = torch.where(ce.mask[mine][:, :, None, None], ce.blocks[mine],
                         torch.zeros_like(ce.blocks[mine]))
    own = (cols >= g0) & (cols < g0 + rows_per)
    return ContactRows(cols=cols, own=own, loc=torch.clamp(cols - g0, 0, rows_per - 1),
                       rows=ce.rows[mine].long() - g0, slot=slot, blocks=blocks,
                       diag=ce.diag[g0: g0 + rows_per])


def local_contact_ell_spmv(group: Group, cr: ContactRows, x_l: torch.Tensor) -> torch.Tensor:
    """This rank's rows of contact_spmv(ce, x): the x rows every contact row
    reads, each filled by its owner, in one rank sum; then the own rows'
    products, placed deterministically, and the diagonal term."""
    y = x_l.new_zeros(x_l.shape)
    if cr.cols.numel():   # the same on every rank: the set is replicated
        xg = x_l[cr.loc]
        xs = group.all_reduce_sum(torch.where(cr.own[:, None], xg, torch.zeros_like(xg)))
        accumulate_rows(y, cr.rows, torch.einsum("rkij,rkj->ri", cr.blocks, xs[cr.slot]))
    return y + torch.einsum("nij,nj->ni", cr.diag, x_l)


def _grid_split(inv96, cfg: SchwarzConfig, n: int, world: int) -> halo.ShardedApply:
    """halo.split_apply_state of the grid prepare's dense table, the
    hierarchy being the analytic one (level-0 node j's parent is the
    level-1 node j // 32)."""
    gn = grid_going_next(n, cfg, inv96.device)
    anc = gn[:n, None] if cfg.num_levels(n) > 1 else gn.new_zeros((n, 0))
    state = ApplyState(sorted_to_orig=None, orig_to_sorted=None, going_next=gn, ancestors=anc,
                       inv96=inv96, overflow=None, restrict_onehot=None, restrict_pos=None,
                       restrict_pb=None)
    return halo.split_apply_state(state, cfg, n, world)


def _crossings(k: int, rows_per: int, world: int, rank: int, device):
    """(grid -> tile, tile -> grid) exchange tables of this rank."""
    s2o, o2s = gm.sort_maps(k)
    plans = []
    for perm in (s2o, o2s):
        needs = [perm[d * rows_per: (d + 1) * rows_per] for d in range(world)]
        send, recv = exchange_plan(needs, rows_per, world)
        plans.append((torch.as_tensor(send[rank], device=device).long(),
                      torch.as_tensor(recv[rank], device=device).long()))
    return plans


def _sharded_grid_pcg(group: Group, cfg: SchwarzConfig, ssys: StencilSystem, inv96, b,
                      k: int, tol: float, max_iters: int, contact=None,
                      timer: Optional[PhaseTimer] = None) -> PcgResult:
    n = 4 ** k
    if n % (group.world * 32):
        raise ValueError(f"N = {n} does not split into {group.world} bank-aligned slabs")
    rows_per = n // group.world
    with phase_of(timer, "tables") as ph:
        la = halo.local_apply_state(_grid_split(inv96, cfg, n, group.world), group.rank, rows_per)
        gs = grid_slab(ssys, group.rank, group.world)
        (g2t_s, g2t_r), (t2g_s, t2g_r) = _crossings(k, rows_per, group.world, group.rank,
                                                    b.device)
        cr = None if contact is None else contact_rows(contact, n, group.rank, rows_per)
        ph["sync"] = gs.sys.dirs_t

    def spmv_op(v):
        q = slab_spmv(group, gs, v)
        return q if cr is None else q + local_contact_ell_spmv(group, cr, v)

    def pre_op(r):
        rt = exchange(group, r, g2t_s, g2t_r)[:rows_per]
        zt = halo.local_apply(group, la, cfg, n, rt)
        return exchange(group, zt, t2g_s, t2g_r)[:rows_per]

    b_l = b[group.rank * rows_per: (group.rank + 1) * rows_per]
    with phase_of(timer, "iterate") as ph:
        res = pcg(spmv_op, pre_op, b_l, tol=tol, max_iters=max_iters,
                  reduce_sum=group.all_reduce_sum)
        ph["sync"] = res.x
    return res


def _on(dev, *ts):
    return tuple(torch.as_tensor(t, device=dev) for t in ts)


def sharded_grid_solve_step(group: Group, cfg: SchwarzConfig, offsets, k: int,
                            tol: float = 1e-4, max_iters: int = 200, sym: bool = False,
                            device=None, timer: Optional[PhaseTimer] = None):
    """grid_solve_step over `group`: step(ssys, diag_rows, dirs_rows, b) ->
    PcgResult whose x is this rank's grid rows (row-major grid order, rows
    rank * N/P onwards). Every rank passes the whole system; the step runs
    on `device` (the card unless the caller asks for the CPU). `offsets`
    are the system's planes (the canonical half when sym=True). A `timer`
    gets the phases prepare, tables and iterate."""
    cfg = dataclasses.replace(cfg, symv_kernel="dense", solve_layout="rows")
    full = _full_offsets(tuple(offsets), sym)
    dev = resolve_device(device)

    def step(ssys, diag_rows, dirs_rows, b):
        ssys = ssys.to(dev)
        diag_rows, dirs_rows = _on(dev, diag_rows, dirs_rows)
        b = torch.as_tensor(b, dtype=torch.float32, device=dev)
        with phase_of(timer, "prepare") as ph:
            inv96 = ph["sync"] = prepare_grid(diag_rows, dirs_rows, full, k, cfg)
        return _sharded_grid_pcg(group, cfg, ssys, inv96, b, k, tol, max_iters, timer=timer)

    return step


def sharded_grid_contact_solve_step(group: Group, cfg: SchwarzConfig, offsets, k: int,
                                    tol: float = 1e-4, max_iters: int = 200, device=None,
                                    timer: Optional[PhaseTimer] = None):
    """grid_contact_solve_step over `group`: step(ssys, diag_rows, dirs_rows,
    b, stencils, ce, o2s) -> PcgResult of this rank's grid rows. The
    collision state (stencils, contact ELL, the grid->tile map) is
    replicated on every rank, as in the JAX package. `device` and `timer`
    as in sharded_grid_solve_step."""
    cfg = dataclasses.replace(cfg, symv_kernel="dense", solve_layout="rows")
    dev = resolve_device(device)

    def step(ssys, diag_rows, dirs_rows, b, stencils, ce, o2s):
        ssys, stencils = ssys.to(dev), stencils.to(dev)
        ce = ContactEll(*_on(dev, *ce))
        diag_rows, dirs_rows, o2s = _on(dev, diag_rows, dirs_rows, o2s)
        b = torch.as_tensor(b, dtype=torch.float32, device=dev)
        with phase_of(timer, "prepare") as ph:
            inv96 = ph["sync"] = prepare_grid(diag_rows, dirs_rows, offsets, k, cfg, stencils,
                                              o2s)
        return _sharded_grid_pcg(group, cfg, ssys, inv96, b, k, tol, max_iters, contact=ce,
                                 timer=timer)

    return step
