"""Decides `correct`: the frames the window produced, judged against the
plain reference (reference.py) once the window has closed.

For each checked frame the harness keeps what the timed path produced:
the positions before and after, the PCG's solution x, and the residual r0
and answer z0 = M^-1 r0 of the preconditioner's first call (the PCG starts
from x = 0, so r0 is the frame's right-hand side in the program's layout).
Velocities are judged through the next frame: the reference rebuilds v
from two positions, so a wrong velocity shows as a wrong right-hand side.

Numbers compared (each against its limit in limits/<workload>.json):
  apply_gap        ||z0 - M_ref^-1 b_ref|| / ||M_ref^-1 b_ref||, worst frame:
                   the right-hand side, assembly, K1, the apply (K2 and the
                   crossings) and the order and hierarchy they follow
  residual         ||r0 - H_ref x|| / ||r0||, worst frame: the system the
                   PCG iterated on (K4 or the block-ELL SpMV) and its answer
  update_mismatch  entries of the new positions that differ from x_in + dx
                   in float32 (dx = x with pinned rows zeroed): exact
  unconverged      frames whose PCG ended above tol or whose state is not
                   finite: exact
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import reference as ref

F64 = torch.float64
BIG = 1e300


class Frame(NamedTuple):
    x_prev: object          # f32[N,3] positions before the previous frame (None on frame 0)
    x_in: torch.Tensor
    x_out: torch.Tensor
    r0: torch.Tensor        # the program's layout
    z0: torch.Tensor
    x: torch.Tensor         # the PCG's solution, the program's layout


def order(config: dict, mesh: dict, x_resort: np.ndarray) -> np.ndarray:
    if config["ordering"] == "grid_tiles":
        return ref.tile_order(int(mesh["grid"][0]))
    return ref.morton_order(x_resort, config["schwarz"]["morton_normalization"])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def judge(frames: dict, mesh: dict, scene, config: dict, unconverged: int, device):
    """-> (numbers, hierarchy). `frames` maps checked frame -> Frame."""
    n = len(mesh["positions"])
    schwarz = config["schwarz"]
    levels = ref.num_levels(n, schwarz["bank_size"], schwarz["coarsen_factor"])
    perm = order(config, mesh, scene.x0)
    hier = ref.hierarchy(perm, np.asarray(mesh["springs"]), levels, device)
    o2s = torch.empty(n, dtype=torch.long, device=device)
    o2s[torch.as_tensor(perm, device=device)] = torch.arange(n, device=device)
    pinned = torch.zeros(n, dtype=torch.bool, device=device)
    pinned[torch.as_tensor(scene.pinned, device=device)] = True
    dt = float(mesh["dt"])
    applied = min(levels, schwarz["max_applied_levels"])

    numbers = dict(apply_gap=0.0, residual=0.0, update_mismatch=0, unconverged=unconverged)
    for f in sorted(frames):
        fr = frames[f]
        x_in = fr.x_in.to(device)
        if fr.x_prev is None:
            v = torch.as_tensor(scene.v0, device=device).to(F64)
        else:
            v = (x_in.to(F64) - fr.x_prev.to(device, F64)) / dt
        b_ref = ref.rhs(x_in, v, mesh, pinned, scene.gravity, device)
        layouts = {"rows": lambda t: t, "sorted": lambda t: t[o2s]}
        if tuple(fr.r0.shape) == (3, n):
            layouts = {"planes": lambda t: t.T}
        gaps = {k: _rel(fn(fr.r0.to(device, F64)), b_ref) for k, fn in layouts.items()}
        layout = min(gaps, key=gaps.get)
        if not gaps[layout] < 0.5:   # no layout of the program's vectors fits
            worst = gaps[layout] if math.isfinite(gaps[layout]) else BIG
            numbers["apply_gap"] = max(numbers["apply_gap"], worst)
            numbers["residual"] = max(numbers["residual"], worst)
            continue
        to_orig = layouts[layout]
        sysm = ref.system(x_in, mesh, pinned, device)
        pre = ref.Preconditioner(sysm, hier, applied, float(schwarz["coarse_damping"]))
        z_ref = pre.apply(b_ref)
        del pre
        z0 = to_orig(fr.z0.to(device)).to(F64)
        numbers["apply_gap"] = max(numbers["apply_gap"], _rel(z0, z_ref))
        x32 = to_orig(fr.x.to(device)).float()
        r0 = to_orig(fr.r0.to(device)).to(F64)
        res = _rel(ref.matvec(sysm, x32.to(F64)), r0)
        numbers["residual"] = max(numbers["residual"], res)
        dx = torch.where(pinned[:, None], torch.zeros_like(x32), x32)
        numbers["update_mismatch"] += int((fr.x_out.to(device) != x_in + dx).sum())
    # a NaN or an overflow reads as the largest number JSON carries
    numbers = {k: v if math.isfinite(v) else BIG for k, v in numbers.items()}
    return numbers, hier


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)
