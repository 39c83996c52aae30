"""Static-transfer preconditioner apply for structured power-of-two grids (port of ``precond_tpu/ops/gridapply.py``).

With the analytic tile ordering (utils/gridmorton.py) on a connected
2^k x 2^k grid, every 32-node bank at every level is one connected
cluster, so level-l node j has the parent j//32: going_next is an
arithmetic progression and the transfer operators need no index arrays:

  restriction  (BuildResidualHierarchy, cpp:1548-1598)  = per-level
      reshape-sum over 32 lanes (+ zero-pad to the level capacity);
  prolongation (CollectFinalZ, cpp:1698-1719)           = per-level
      broadcast of the parent z.

The JAX package writes the row-major transfers as one-hot selector
matmuls on [B,96] arrays (its `_sel96`); here they are the equivalent
reshape-sum and repeat, which select exactly. The per-block symv is a
hand-written kernel on the card: K2 (packed) or K3 (dense), through the
row-major or the comp-major entry points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import SchwarzConfig
from ..device import resolve_device
from ..profiling import span
from .cuda.packed_symv import (
    DenseInverseCM,
    PackedInverse,
    PackedInverseCM,
    dense_symv_cm,
    packed_symv,
    packed_symv_cm,
)
from .cuda.symv import batched_symv
from .hierarchy import BANK, Hierarchy


def grid_level_sizes(n: int, cfg: SchwarzConfig) -> tuple:
    """Active node count per level: n / 32^l (exact powers of two)."""
    if n % BANK:
        raise ValueError(f"grid levels need N divisible by {BANK}, got {n}")
    sizes = [n]
    for _ in range(1, cfg.num_levels(n)):
        sizes.append(max(sizes[-1] // BANK, 1))
    return tuple(sizes)


def grid_going_next(n: int, cfg: SchwarzConfig, device=None) -> torch.Tensor:
    """The analytic hierarchy's parent map, i32[total+1], on `device` (the
    card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    levels = cfg.num_levels(n)
    offs = cfg.level_offsets(n)
    sizes = grid_level_sizes(n, cfg)
    total = offs[-1]
    gn = torch.full((total + 1,), total, dtype=torch.int32, device=dev)
    for l in range(levels - 1):
        j = torch.arange(offs[l + 1] - offs[l], dtype=torch.int32, device=dev)
        gn[offs[l]: offs[l + 1]] = torch.where(
            j < sizes[l], offs[l + 1] + torch.div(j, BANK, rounding_mode="floor"), total)
    return gn


def analytic_hierarchy(n: int, cfg: SchwarzConfig, device=None) -> Hierarchy:
    """The arithmetic hierarchy as a full Hierarchy, on `device` (the card
    unless the caller asks for the CPU).

    For any ordering whose banks are single connected clusters at every
    level, build_hierarchy's output is exactly this; providing it
    directly lets prepare skip build_hierarchy.
    """
    dev = resolve_device(device)
    levels = cfg.num_levels(n)
    offs = cfg.level_offsets(n)
    sizes = grid_level_sizes(n, cfg)
    total = offs[-1]
    gn = grid_going_next(n, cfg, dev)

    i32 = dict(dtype=torch.int32, device=dev)
    lc = torch.arange(BANK, **i32)
    onehot = torch.zeros((total // BANK, BANK, BANK), dtype=torch.float32, device=dev)
    pos = torch.full((total - offs[1],), -1, **i32)
    pb = torch.full((total // BANK,), total, **i32)
    base = torch.arange(n, **i32)
    coarse_rows = [base]
    for l in range(levels - 1):
        nb = (offs[l + 1] - offs[l]) // BANK
        b = torch.arange(nb, **i32)
        lane_ok = (b[:, None] * BANK + lc[None, :]) < sizes[l]           # [nb,32]
        oh = lane_ok[:, None, :] & (lc[None, :, None] == 0)
        onehot[offs[l] // BANK: offs[l] // BANK + nb] = oh.float()
        pb[offs[l] // BANK: offs[l] // BANK + nb] = torch.where(
            b * BANK < sizes[l], offs[l + 1] + b, total)
        cap_next = offs[l + 2] - offs[l + 1]
        p = torch.arange(cap_next, **i32)
        pos[offs[l + 1] - offs[1]: offs[l + 2] - offs[1]] = torch.where(
            p < sizes[l + 1], offs[l] + p * BANK, -1)
        coarse_rows.append(torch.div(base, BANK ** (l + 1), rounding_mode="floor"))
    return Hierarchy(
        going_next=gn,
        coarse_space=torch.stack(coarse_rows),
        level_sizes=torch.tensor(sizes, **i32),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        onehot=onehot,
        pos=pos,
        pb=pb,
    )


def restrict_residual_grid(r_sorted: torch.Tensor, cfg: SchwarzConfig, n: int) -> torch.Tensor:
    """f32[N,3] (tile order) -> f32[total,3]: per-level reshape-sums."""
    offs = cfg.level_offsets(n)
    parts = [r_sorted]
    cur = r_sorted
    for l in range(cfg.num_levels(n) - 1):
        s = cur.reshape(-1, BANK, 3).sum(dim=1)          # [caps[l]/32, 3]
        cur = F.pad(s, (0, 0, 0, offs[l + 2] - offs[l + 1] - s.shape[0]))
        parts.append(cur)
    return torch.cat(parts, dim=0)


def prolong_and_collect_grid(mz: torch.Tensor, cfg: SchwarzConfig, n: int) -> torch.Tensor:
    """Additive multi-level sum: top-down parent broadcasts. [total,3]->[N,3]."""
    offs = cfg.level_offsets(n)
    top = min(cfg.num_levels(n), cfg.max_applied_levels)
    pz = mz[offs[top - 1]: offs[top]]
    for l in range(top - 2, -1, -1):
        cur = mz[offs[l]: offs[l + 1]]
        nbanks = (offs[l + 1] - offs[l]) // BANK
        pz = cur + torch.repeat_interleave(pz[:nbanks], BANK, dim=0)
    return pz[:n]


def precondition_grid_cm(inv_cm, rs_cm: torch.Tensor, cfg: SchwarzConfig) -> torch.Tensor:
    """Component-major apply: z^T = M^-1 r^T on [3, N] sorted vectors.

    Restriction is a lane-axis reshape-sum per bank and prolongation a
    lane-axis broadcast of the parent plane, because level l+1's bank b
    groups exactly the level-l banks b*32..b*32+31. The symv takes the
    comp-major inverse: K2 via packed_symv_cm, or K3 via dense_symv_cm.
    """
    if not isinstance(inv_cm, (PackedInverseCM, DenseInverseCM)):
        raise TypeError("the comp-major apply needs pack_sym96_cm / dense_cm inverses")
    n = rs_cm.shape[1]
    offs = cfg.level_offsets(n)
    levels = cfg.num_levels(n)
    sizes = grid_level_sizes(n, cfg)
    # ---- restrict: per-level lane sums ----
    with span("apply.restrict"):
        parts = [rs_cm.reshape(3, n // BANK, BANK)]
        cur = parts[0]
        for l in range(levels - 1):
            nbl = (sizes[l] + BANK - 1) // BANK
            vals = cur[:, :nbl].sum(dim=2)               # (3, sizes[l+1])
            capb = (offs[l + 2] - offs[l + 1]) // BANK
            cur = F.pad(vals, (0, capb * BANK - vals.shape[1])).reshape(3, capb, BANK)
            parts.append(cur)
        mr = torch.cat(parts, dim=1)                     # (3, Btot, 32)
    with span("apply.symv"):
        if isinstance(inv_cm, DenseInverseCM):
            z3 = dense_symv_cm(inv_cm, mr)
        else:
            z3 = packed_symv_cm(inv_cm, mr)
    # ---- prolong + additive collect ----
    with span("apply.prolong"):
        top = min(levels, cfg.max_applied_levels)
        pz = z3[:, offs[top - 1] // BANK: offs[top] // BANK]
        for l in range(top - 2, -1, -1):
            curz = z3[:, offs[l] // BANK: offs[l + 1] // BANK]
            nb = (offs[l + 1] - offs[l]) // BANK
            vals = pz.reshape(3, -1)[:, :nb]             # parent z per child bank
            if l == 0 and cfg.coarse_damping != 1.0:
                vals = vals * cfg.coarse_damping         # z = z0 + theta*sum z_l
            pz = curz + vals[:, :, None]
        return pz.reshape(3, -1)[:, :n]


def precondition_grid(inv96, r_sorted: torch.Tensor, cfg: SchwarzConfig) -> torch.Tensor:
    """z = M^-1 r in tile order, static transfers. f32[N,3] -> f32[N,3].

    Bank-flat formulation on [B,96] arrays; the restriction's bank sums are
    reshape-sums and the prolongation's broadcast a repeat (the JAX
    package's selector matmuls select exactly the same terms).
    """
    if isinstance(inv96, (PackedInverseCM, DenseInverseCM)):
        raise TypeError("comp-major inverse passed to the row-major apply; "
                        "use precondition_grid_cm")
    n = r_sorted.shape[0]
    offs = cfg.level_offsets(n)
    levels = cfg.num_levels(n)
    sizes = grid_level_sizes(n, cfg)
    # ---- restrict (BuildResidualHierarchy, cpp:1548-1598) ----
    with span("apply.restrict"):
        parts = [r_sorted.reshape(-1, 3 * BANK)]
        cur = parts[0]
        for l in range(levels - 1):
            nbl = (sizes[l] + BANK - 1) // BANK          # active banks at level l
            vals = cur[:nbl].reshape(nbl, BANK, 3).sum(dim=1)  # [sizes[l+1], 3] bank sums
            capb = (offs[l + 2] - offs[l + 1]) // BANK
            cur = F.pad(vals, (0, 0, 0, capb * BANK - vals.shape[0])).reshape(capb, 3 * BANK)
            parts.append(cur)
        mr = torch.cat(parts, dim=0)                     # [Btot, 96]
    with span("apply.symv"):
        if isinstance(inv96, PackedInverse):
            z96 = packed_symv(inv96, mr)
        else:
            z96 = batched_symv(inv96, mr)                # [Btot, 96]
    # ---- prolong + additive collect (CollectFinalZ, cpp:1698-1719) ----
    with span("apply.prolong"):
        top = min(levels, cfg.max_applied_levels)
        pz = z96[offs[top - 1] // BANK: offs[top] // BANK]
        for l in range(top - 2, -1, -1):
            curz = z96[offs[l] // BANK: offs[l + 1] // BANK]
            nb = (offs[l + 1] - offs[l]) // BANK
            vals = pz.reshape(-1, 3)[:nb]                # parent z per child bank
            if l == 0 and cfg.coarse_damping != 1.0:
                vals = vals * cfg.coarse_damping         # z = z0 + theta*sum z_l
            pz = curz + vals[:, None, :].expand(nb, BANK, 3).reshape(nb, 3 * BANK)
        return pz.reshape(-1, 3)[:n]
