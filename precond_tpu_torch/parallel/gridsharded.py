"""Structured-grid solve steps (port of ``precond_tpu/parallel/gridsharded.py:31-95``, single device).

One implicit step on the static grid path as one function: prepare_grid,
then grid-order PCG with the stencil SpMV and the row-major grid apply;
the contact variant adds the stencil Hessians to M and the contact ELL to
the solved system. The JAX module also row-shards these steps over a
device mesh (GSPMD); that arrives with the multi-device slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SchwarzConfig
from ..ops import gridstencil
from ..ops.contact import contact_spmv
from ..ops.gridapply import precondition_grid
from ..ops.gridstencil import StencilSystem
from ..solver import prepare_grid
from ..utils import gridmorton as gm
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
