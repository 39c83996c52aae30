"""Scatter-free banked-Hessian assembly for structured power-of-two grids (port of ``precond_tpu/ops/gridassembly.py``, without collisions).

Reference semantics (PrepareHessian cpp:1229-1345 + the level-(λ+1)..top
diagonal compensation, cpp:1297-1343): a neighbor pair merges at the first
level λ where both ancestors share a 32-node bank; its off-diagonal block
lands symmetrically in that bank, its value is also added to the climbing
vertex's diagonal at every level above λ, and the self diagonal lands at
every level.

On a tile-ordered grid (utils/gridmorton.py) every quantity above is a
static function of the vertex's grid position and the spring's (di, dj)
offset, so assembly becomes, per direction:

  * level 0: a static [32,32] lane band selects which direction's block
    sits at each (lane, lane) of the fine [B0,96,96] output;
  * level m >= 1: the vertices crossing a level-m region boundary in a
    given direction form a static mask, all of a region's crossers meet
    the same neighbor node, so the contribution is a masked reshape-sum
    placed at one static column lane per node;
  * diagonal chains: running masked sums of block values, reshape-summed
    per level and placed on static diagonal lanes.

The pattern is computed on the host with NumPy once per (k, offsets,
config), as in the JAX package, and uploaded once per device
(device_pattern). The JAX
package's one-hot selector contractions (the fine band product and the
coarse placement einsum) are a gather and one-hot multiply-adds here, which
select exactly the same terms. Collision terms arrive with the contact
slice; the 3-D box pattern with the box slice.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SchwarzConfig
from ..device import resolve_device
from ..utils import gridmorton as gm
from .gridapply import grid_level_sizes
from .hierarchy import BANK


class GridPattern(NamedTuple):
    """Static assembly pattern (host numpy)."""

    band: np.ndarray        # f32[D,32,32]  level-0 in-tile lane bands
    lam: np.ndarray         # i8[D,N]  merge level per (direction, vertex); -1 invalid
    sc: np.ndarray          # i8[D,N]  crossing-subcase code (3*(si+1)+(sj+1)); -1 none
    # (d, m, sc_code, col i32[s_m]) one entry per nonempty off-diag reduction
    offdiag: Tuple[Tuple[int, int, int, np.ndarray], ...]
    sizes: Tuple[int, ...]  # active nodes per level
    fill: np.ndarray        # f32[B,96] 1 where the node row is padding (identity fill)


def _pattern_nd(dims, s2o, o2s, offsets, cfg: SchwarzConfig) -> GridPattern:
    """Dimension-generic static pattern over any analytic tile ordering.

    dims: vertex extents per axis (row-major flattening). s2o/o2s: tile
    slot <-> row-major vertex maps whose rank interleave yields nested
    dyadic boxes.
    """
    nd = len(dims)
    n = int(np.prod(dims))
    levels = cfg.num_levels(n)
    caps = cfg.level_capacities(n)
    strides = [int(np.prod(dims[a + 1:])) for a in range(nd)]
    coords = [(s2o // strides[a]) % dims[a] for a in range(nd)]   # [nd][N]
    trank = np.arange(n, dtype=np.int64) // BANK   # tile rank per slot
    lane = np.arange(n, dtype=np.int64) % BANK

    sizes = [n]
    for _ in range(1, levels):
        sizes.append(max(sizes[-1] // BANK, 1))

    D = len(offsets)
    band = np.zeros((D, BANK, BANK), np.float32)
    lam8 = np.full((D, n), -1, np.int8)
    sc8 = np.full((D, n), -1, np.int8)
    offdiag = []

    for d, off in enumerate(offsets):
        u = [coords[a] + off[a] for a in range(nd)]
        valid = np.ones(n, bool)
        for a in range(nd):
            valid &= (u[a] >= 0) & (u[a] < dims[a])
        uc = [np.clip(u[a], 0, dims[a] - 1) for a in range(nd)]
        u_flat = sum(uc[a] * strides[a] for a in range(nd))
        u_slot = o2s[u_flat].astype(np.int64)
        tu, lu = u_slot // BANK, u_slot % BANK

        # merge level: first m >= 0 with trank >> 5m == tu >> 5m
        lam = np.full(n, -1, np.int64)
        for m in range(levels - 1, -1, -1):
            lam = np.where((trank >> (5 * m)) == (tu >> (5 * m)), m, lam)
        if not np.all(lam[valid] >= 0):
            raise ValueError(f"direction {off}: a pair fails to merge")
        lam8[d] = np.where(valid, lam, -1).astype(np.int8)

        sel0 = valid & (lam == 0)
        band[d][lane[sel0], lu[sel0]] = 1.0
        # the band must be a pure function of the lane (same across tiles)
        if band[d].sum() * (n // BANK) < sel0.sum():
            raise ValueError(f"direction {off}: the level-0 band differs between tiles")

        for m in range(1, levels):
            shift = 5 * (m - 1)
            p = trank >> shift                     # level-m within-level id
            cv = (tu >> shift) % BANK              # neighbor node's lane
            selm = valid & (lam == m)
            if not selm.any():
                continue
            # crossing direction measured at this level's region geometry
            # (regions are aligned dyadic boxes; node 0 starts at the
            # origin, so its extents give the uniform region size)
            node0 = p == 0
            r_ext = [int(coords[a][node0].max()) + 1 for a in range(nd)]
            code = np.zeros(n, np.int64)
            for a in range(nd):
                sa = np.sign(uc[a] // r_ext[a] - coords[a] // r_ext[a])
                code = code * 3 + (sa + 1)
            code = code.astype(np.int8)
            sc8[d] = np.where(selm, code, sc8[d])
            for c in np.unique(code[selm]):
                sel = selm & (code == c)
                ps, cs = p[sel], cv[sel]
                # each region meets exactly one neighbor node per subcase
                # (JAX checks min == max per region; equivalent and vectorized)
                col = np.zeros(sizes[m], np.int32)
                col[ps] = cs
                if not np.all(col[ps] == cs):
                    raise ValueError(f"direction {off}, level {m}, subcase {c}: "
                                     "a region meets two neighbor nodes")
                offdiag.append((d, m, int(c), col))

    offs = [0]
    for c in caps:
        offs.append(offs[-1] + c)
    nodes = np.arange(offs[-1])
    inactive = np.zeros(offs[-1], bool)
    for l in range(levels):
        seg = nodes[offs[l]: offs[l + 1]] - offs[l]
        inactive[offs[l]: offs[l + 1]] = seg >= sizes[l]
    fill = np.repeat(inactive.reshape(-1, BANK), 3, axis=1).astype(np.float32)

    return GridPattern(band, lam8, sc8, tuple(offdiag), tuple(sizes), fill)


@functools.lru_cache(maxsize=8)
def grid_pattern(k: int, offsets: Tuple[Tuple[int, int], ...], cfg: SchwarzConfig) -> GridPattern:
    """The host pattern of a 2^k square grid, cached per (k, offsets, cfg)."""
    side = 1 << k
    if not gm.supported(side, side):
        raise ValueError(f"no analytic tile order for a {side}x{side} grid")
    s2o, o2s = gm.sort_maps(k)                     # tile slot <-> grid vertex
    return _pattern_nd((side, side), s2o, o2s, offsets, cfg)


class _DevicePattern(NamedTuple):
    """What _assemble_core reads of a GridPattern, uploaded once."""

    fine_idx: torch.Tensor   # i64[32*32]: (d*32 + i) source row of fine entry (i, j)
    lam: torch.Tensor        # i8[D,N]
    sc: torch.Tensor         # i8[D,N]
    cols: tuple              # per offdiag entry: i64[s_m]
    fill: torch.Tensor       # f32[B,96]


def _fine_index(band: np.ndarray) -> np.ndarray:
    """Gather index of the fine level: entry (i, j) of a bank's lane grid
    takes direction dsel[i,j] (0 = the diagonal's identity band, D+1 = a
    zero plane) at lane i. Exact because no two bands share an entry."""
    d_dirs = band.shape[0]
    allb = np.concatenate([np.eye(BANK, dtype=np.float32)[None], band], axis=0)
    if allb.sum(axis=0).max() > 1:
        raise ValueError("two directions place a block at the same lane pair")
    dsel = np.where(allb.any(axis=0), allb.argmax(axis=0), d_dirs + 1)   # [32,32]
    lane_i = np.arange(BANK)[:, None]
    return (dsel * BANK + lane_i).reshape(-1).astype(np.int64)


def device_pattern(k: int, offsets: Tuple[Tuple[int, int], ...], cfg: SchwarzConfig,
                   device=None) -> _DevicePattern:
    """grid_pattern's tensors on `device` (the card unless the caller asks
    for the CPU), uploaded once per (k, offsets, cfg, device)."""
    return _device_pattern(k, tuple(tuple(int(v) for v in o) for o in offsets), cfg,
                           str(resolve_device(device)))


@functools.lru_cache(maxsize=8)
def _device_pattern(k: int, offsets, cfg: SchwarzConfig, device: str) -> _DevicePattern:
    pat = grid_pattern(k, offsets, cfg)
    return _DevicePattern(
        fine_idx=torch.as_tensor(_fine_index(pat.band), device=device),
        lam=torch.as_tensor(pat.lam, device=device),
        sc=torch.as_tensor(pat.sc, device=device),
        cols=tuple(torch.as_tensor(col.astype(np.int64), device=device)
                   for _, _, _, col in pat.offdiag),
        fill=torch.as_tensor(pat.fill, device=device),
    )


def arith_parent(x: torch.Tensor, cfg: SchwarzConfig, n: int) -> torch.Tensor:
    """going_next as pure arithmetic (the grid hierarchy, no table gather).

    Level-l node j's parent is offs[l+1] + j//32 while j is active; padded
    and top-level nodes map to the `total` sentinel (ops/gridapply.py)."""
    levels = cfg.num_levels(n)
    offs = cfg.level_offsets(n)
    sizes = grid_level_sizes(n, cfg)
    total = offs[-1]
    out = torch.full_like(x, total)
    for l in range(levels - 1):
        j = x - offs[l]
        ok = (x >= offs[l]) & (x < offs[l + 1]) & (j < sizes[l])
        out = torch.where(ok, offs[l + 1] + torch.div(j, BANK, rounding_mode="floor"), out)
    return out


def pin_grid_blocks(diag_rows: torch.Tensor, dirs_rows: torch.Tensor,
                    offsets: Tuple[Tuple[int, int], ...], grid: Tuple[int, int],
                    pinned: torch.Tensor, big_diag: float):
    """Row-major twin of gridstencil.pin_vertices: zero every direction
    block with a pinned endpoint, big SPD mass diagonal on pinned rows."""
    nx, ny = grid
    pad = max(max(abs(di), abs(dj)) for di, dj in offsets) if offsets else 0
    pinned = pinned.to(device=diag_rows.device, dtype=torch.bool)
    pg = F.pad(pinned.reshape(1, nx, ny).to(torch.uint8), (pad, pad, pad, pad))[0].bool()
    masks = []
    for di, dj in offsets:
        src = pg[pad + di: pad + di + nx, pad + dj: pad + dj + ny].reshape(-1)
        masks.append(~(pinned | src))
    dirs = dirs_rows * torch.stack(masks).to(dirs_rows.dtype)[:, :, None, None]
    eye = torch.eye(3, dtype=diag_rows.dtype, device=diag_rows.device)
    diag = torch.where(pinned[:, None, None], big_diag * eye[None], diag_rows)
    return diag, dirs


def assemble_grid_hessian(
    diag_rows: torch.Tensor,   # f32[N,3,3] grid (row-major) vertex order
    dirs_rows: torch.Tensor,   # f32[D,N,3,3] grid order, per direction
    offsets: Tuple[Tuple[int, int], ...],
    k: int,
    cfg: SchwarzConfig,
    collisions=None,
) -> torch.Tensor:
    """All domain Hessians f32[B,96,96], on the inputs' device; matches the
    general assemble_banked_hessian on grid meshes."""
    if collisions is not None:
        raise NotImplementedError(
            "collision terms: contact on the grid path is not ported yet (ROADMAP.md Queue A item 3)")
    n = diag_rows.shape[0]
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    pat = grid_pattern(k, offsets, cfg)
    dp = device_pattern(k, offsets, cfg, diag_rows.device)
    # one stacked tile-order buffer [D+1, N, 9] (diagonal first), one gather
    aa = torch.cat([diag_rows.reshape(1, n, 9), dirs_rows.reshape(-1, n, 9)], dim=0)
    aa = gm.grid_to_morton(aa.permute(1, 0, 2), k).permute(1, 0, 2).contiguous()
    return _assemble_core(aa, pat, dp, cfg)


def _assemble_core(aa: torch.Tensor, pat: GridPattern, dp: _DevicePattern,
                   cfg: SchwarzConfig) -> torch.Tensor:
    """Static assembly from tile-order blocks aa [D+1, N, 9] (the diagonal
    first, then one plane per direction)."""
    n = aa.shape[1]
    levels = cfg.num_levels(n)
    caps = cfg.level_capacities(n)
    D = aa.shape[0] - 1
    B0 = n // BANK
    dg, A = aa[0], aa[1:]

    # ---- fine level: one gather over (direction, lane) ---------------------
    # h0[b,i,x,j,y] = aa[dsel[i,j], b, i, x, y] (zero where no band is set),
    # written straight into the output's first B0 blocks
    h96 = aa.new_empty((cfg.total_capacity(n) // BANK, 3 * BANK, 3 * BANK))
    src = torch.cat([aa.reshape(D + 1, B0, BANK, 9), aa.new_zeros((1, B0, BANK, 9))])
    src = src.permute(1, 0, 2, 3).reshape(B0, (D + 2) * BANK, 9)
    h96[:B0].view(B0, BANK, 3, BANK, 3).copy_(
        src[:, dp.fine_idx].reshape(B0, BANK, BANK, 3, 3).permute(0, 1, 3, 2, 4))
    del src
    off = B0

    # ---- coarse levels -----------------------------------------------------
    lam = dp.lam
    sc = dp.sc
    iota = torch.arange(BANK, device=aa.device)
    chain = None  # sum of blocks resolved below the current level
    for m in range(1, levels):
        group = BANK ** m
        s_m = pat.sizes[m]
        em = torch.zeros((n, 9), dtype=aa.dtype, device=aa.device)
        for d in range(D):
            em = em + A[d] * (lam[d] == (m - 1))[:, None]
        chain = em if chain is None else chain + em
        diagpay = chain + dg
        # node diagonal at its own lane, then every crossing subcase at its
        # static column lane: one-hot multiply-adds in entry order
        p_lane = torch.arange(s_m, device=aa.device) % BANK
        onehot = (iota[None, :] == p_lane[:, None]).to(aa.dtype)         # [s_m,32]
        rows = diagpay.reshape(s_m, group, 9).sum(dim=1)[:, :, None] * onehot[:, None, :]
        for (d, lm, c, _), col in zip(pat.offdiag, dp.cols):
            if lm != m:
                continue
            w = ((lam[d] == m) & (sc[d] == c)).to(aa.dtype)
            s = (A[d] * w[:, None]).reshape(s_m, group, 9).sum(dim=1)     # [s_m,9]
            onehot = (iota[None, :] == col[:, None]).to(aa.dtype)
            rows = rows + s[:, :, None] * onehot[:, None, :]              # [s_m,9,32]
        # node p's rows [3, 32 lanes, 3] land at lane p % 32 of block p // 32
        hm = h96[off: off + caps[m] // BANK]
        hm.zero_()
        hm.view(-1, 3, BANK, 3)[:s_m] = rows.reshape(s_m, 3, 3, BANK).permute(0, 1, 3, 2)
        off += caps[m] // BANK
    # identity fill of padded node rows (in place on the diagonal)
    h96.diagonal(dim1=1, dim2=2).add_(dp.fill)
    return h96
