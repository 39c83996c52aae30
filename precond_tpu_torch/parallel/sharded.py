"""Solve step, single device and sharded over ranks (port of
``precond_tpu/parallel/sharded.py``).

``solve_step`` prepares the preconditioner and runs PCG on one device.
``sharded_solve_step`` is the same step over a process group. The JAX
package lets GSPMD partition the jitted step; PyTorch has no such
partitioner, so the sharded step runs parallel/halo.py's explicit schedule:

  1. every rank prepares redundantly on the whole system (as
     scripts/pod_solve.py does on a pod: the prepare is O(N) and short
     next to the solve);
  2. the system is permuted to sorted order and split into the halo system
     and the ShardedApply (each rank keeps its own rows);
  3. the halo PCG runs, dots summed over ranks;
  4. x goes back to original vertex order with one all_to_all.

A ragged N (not a multiple of world * 32) is padded in sorted space to the
next multiple with decoupled rows: an identity diagonal and no
off-diagonals in the system, a zero right-hand side, the dump parent (no
restriction), the dump ancestor (no prolongation) and identity inverse
blocks. Their residual starts and stays zero, so the real rows solve the
real system.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SchwarzConfig
from ..device import resolve_device
from ..ops.apply import precondition
from ..ops.blockcsr import BlockEll, spmv
from ..ops.hierarchy import BANK
from ..profiling import PhaseTimer, phase_of
from ..solver import SortMaps, prepare_preconditioner, prepare_with_system
from . import halo
from .comm import Group, exchange, exchange_plan, row_range
from .hosts import RankMesh, global_mesh
from .pcg import PcgResult, pcg


def solve_step(
    ell: BlockEll,
    maps: SortMaps,
    b,
    cfg: SchwarzConfig,
    tol: float = 1e-4,
    max_iters: int = 200,
    device=None,
) -> PcgResult:
    """Prepare the preconditioner and PCG-solve H x = b on `device` (the
    card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    ell = ell.to(dev)
    maps = SortMaps(*(m.to(dev) for m in maps))
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    state = prepare_preconditioner(ell, maps, cfg)
    return pcg(
        lambda x: spmv(ell, x),
        lambda r: precondition(state, r, cfg),
        b,
        tol=tol,
        max_iters=max_iters,
    )


def make_mesh(axis: str = "x") -> RankMesh:
    """The 1-D mesh over every rank (hosts.global_mesh)."""
    return global_mesh(axis)


def shard_system(group: Group, ell: BlockEll) -> BlockEll:
    """This rank's row slab of the system (original order, global columns):
    the rows the JAX package's shard_system places on this rank. The sharded
    step itself reads the whole system, since every rank prepares."""
    start, stop = row_range(ell.num_verts, group.world, group.rank)
    return BlockEll(*(t[start:stop] for t in ell))


def pad_sorted_system(ell_sorted: BlockEll, rows: int) -> BlockEll:
    """Append decoupled rows up to `rows`: identity diagonal, no off-diagonals."""
    n, k = ell_sorted.idx.shape
    if rows == n:
        return ell_sorted
    pad = rows - n
    dev = ell_sorted.diag.device
    eye = torch.eye(3, dtype=ell_sorted.diag.dtype, device=dev).expand(pad, 3, 3)
    own = torch.arange(n, rows, dtype=ell_sorted.idx.dtype, device=dev)[:, None].expand(pad, k)
    return BlockEll(
        diag=torch.cat([ell_sorted.diag, eye]),
        idx=torch.cat([ell_sorted.idx, own]),
        blocks=torch.cat([ell_sorted.blocks, ell_sorted.blocks.new_zeros((pad, k, 3, 3))]),
        mask=torch.cat([ell_sorted.mask, ell_sorted.mask.new_zeros((pad, k))]),
    )


def unpermute_plan(orig_to_sorted, n: int, rows_per: int, world: int):
    """Tables of the one all_to_all that takes sorted rows (rank s holds
    sorted rows [s * rows_per, (s+1) * rows_per)) to original order (rank d
    ends with original rows row_range(n, world, d))."""
    o2s = orig_to_sorted.detach().cpu().numpy().astype(np.int64)
    needs = [o2s[slice(*row_range(n, world, d))] for d in range(world)]
    return exchange_plan(needs, rows_per, world)


def sharded_solve_step(group: Group, cfg: SchwarzConfig, tol: float = 1e-4,
                       max_iters: int = 200, device=None, timer: Optional[PhaseTimer] = None):
    """The solve step over `group`: step(ell, maps, b) -> PcgResult whose x
    is this rank's rows of the solution in ORIGINAL vertex order
    (row_range(N, world, rank), a DTensor Shard(0) layout).

    Every rank passes the whole system, maps and right-hand side; the step
    runs on `device` (the card unless the caller asks for the CPU). A
    `timer` gets the phases prepare, tables (host), iterate and unpermute.
    """
    dev = resolve_device(device)

    def step(ell: BlockEll, maps: SortMaps, b) -> PcgResult:
        ell = ell.to(dev)
        maps = SortMaps(*(m.to(dev) for m in maps))
        b = torch.as_tensor(b, dtype=torch.float32, device=dev)
        n = ell.num_verts
        rows = -(-n // (group.world * BANK)) * group.world * BANK
        with phase_of(timer, "prepare") as ph:
            state, ell_sorted = prepare_with_system(ell, maps, cfg)
            ph["sync"] = ell_sorted.diag
        with phase_of(timer, "tables"):
            hsys = halo.build_halo_system(pad_sorted_system(ell_sorted, rows), group.world)
            sap = halo.split_apply_state(state, cfg, n, group.world, rows=rows)
            send, recv = unpermute_plan(maps.orig_to_sorted, n, hsys.shard_rows, group.world)
        b_sorted = torch.cat([b[maps.sorted_to_orig.long()], b.new_zeros((rows - n, 3))])
        with phase_of(timer, "iterate") as ph:
            res = halo.solve_sorted(group, cfg, hsys, sap, b_sorted, tol=tol, max_iters=max_iters)
            ph["sync"] = res.x
        with phase_of(timer, "unpermute") as ph:
            start, stop = row_range(n, group.world, group.rank)
            x = exchange(group, res.x, torch.as_tensor(send[group.rank], device=dev).long(),
                         torch.as_tensor(recv[group.rank], device=dev).long())[: stop - start]
            ph["sync"] = x
        return res._replace(x=x)

    return step
