"""Uniform-grid spatial binning for the collision broad phase (port of
``precond_tpu/models/hashgrid.py``).

Primitives are binned into a uniform grid over the scene AABB: each
primitive's representative point gets a linearized cell key, the ids are
sorted by key (one stable argsort), and "primitives near q" is 27 binary
searches into the sorted keys plus a bounded gather. No atomics, no host
round trips.

  build:  keys = linearized cell coords of each primitive's representative
          point; order = argsort(keys, stable)           -- O(P log P)
  query:  for each of the 27 neighbor cells: searchsorted(left/right) gives
          the [start,end) run of that cell; take up to `cap` ids from it

Correctness contract: a query at q finds every primitive whose
representative point lies within one cell of q's cell. With cell size
>= (primitive radius + threshold), any primitive whose surface comes within
`threshold` of q has its representative point in that neighborhood. Cells
can hold any number of primitives; only the first `cap` per cell (in
primitive-id order: the sort is stable) are returned, reported by the
`truncated` flag.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# Cells per axis cap: 2^10 per axis keeps the linearized key within i32.
GRID_MAX = 1024

_NEIGHBOR_OFFSETS = [
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
]


class HashGrid(NamedTuple):
    keys: torch.Tensor      # i32[P] sorted linearized cell keys
    order: torch.Tensor     # i32[P] primitive id occupying each sorted slot
    origin: torch.Tensor    # f32[3] scene AABB min
    inv_cell: torch.Tensor  # f32[3] 1 / effective cell size per axis
    dims: torch.Tensor      # i32[3] cells per axis (<= GRID_MAX)


def _cell_coords(points: torch.Tensor, grid: HashGrid) -> torch.Tensor:
    c = torch.floor((points - grid.origin[None]) * grid.inv_cell[None]).to(torch.int32)
    return torch.minimum(torch.clamp(c, min=0), grid.dims[None] - 1)


def _linearize(c: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]


def build_grid(points: torch.Tensor, cell_size) -> HashGrid:
    """Bin representative points into cells of (at least) `cell_size`.

    `cell_size` may be a device scalar (a data-dependent primitive radius +
    threshold). If the scene is larger than GRID_MAX cells per axis, cells
    grow to fit: more candidates per cell, never missed pairs.
    """
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    extent = torch.clamp(hi - lo, min=1e-12)
    cs = torch.as_tensor(cell_size, dtype=torch.float32, device=points.device)
    cell = torch.maximum(cs, extent / GRID_MAX)
    dims = torch.clamp(torch.ceil(extent / cell).to(torch.int32), 1, GRID_MAX)
    inv_cell = 1.0 / cell * torch.ones((3,), dtype=torch.float32, device=points.device)
    grid = HashGrid(keys=None, order=None, origin=lo, inv_cell=inv_cell, dims=dims)
    keys = _linearize(_cell_coords(points, grid), dims)
    order = torch.argsort(keys, stable=True).to(torch.int32)
    return grid._replace(keys=keys[order.long()], order=order)


def query(grid: HashGrid, points: torch.Tensor, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate primitive ids near each query point.

    Returns (ids i32[Q, 27*cap], valid bool[Q, 27*cap], truncated bool[]):
    up to `cap` primitives from each of the 27 cells around the query's
    cell, in the JAX package's offset order (column = offset * cap + slot;
    the 27 cells are searched in one batched call). `truncated` is True if
    any searched cell held more than `cap` primitives.
    """
    p = grid.keys.shape[0]
    dev = points.device
    base = _cell_coords(points, grid)                              # [Q,3]
    off = torch.tensor(_NEIGHBOR_OFFSETS, dtype=torch.int32, device=dev)
    c = base[:, None, :] + off[None]                               # [Q,27,3]
    in_range = ((c >= 0) & (c < grid.dims)).all(dim=-1)            # [Q,27]
    key = _linearize(c, grid.dims).reshape(-1)
    start = torch.searchsorted(grid.keys, key, right=False).to(torch.int32).reshape(in_range.shape)
    end = torch.searchsorted(grid.keys, key, right=True).to(torch.int32).reshape(in_range.shape)
    truncated = (in_range & (end - start > cap)).any()
    pos = start[..., None] + torch.arange(cap, dtype=torch.int32, device=dev)   # [Q,27,cap]
    valid = (pos < end[..., None]) & in_range[..., None]
    ids = grid.order[torch.clamp(pos, 0, p - 1).long()]
    q = points.shape[0]
    return ids.reshape(q, -1), valid.reshape(q, -1), truncated
