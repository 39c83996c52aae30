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

With contact (a traffic with a `contact` block) the reference finds each
checked frame's contact set itself (contact.py) and H, b and M_ref carry
its terms, and four more numbers are compared:
  contact_apply_gap  the apply gap over the rows a reference contact
                     touches (unpinned vertices with a nonzero weight),
                     worst frame: the contact terms of M and b, which the
                     sheet's million other rows would dilute
  contact_residual   the residual over those rows, worst frame: the
                     contact SpMV and the contact set it iterated with
  contact_count_gap  pairs by which the program's live stencils of a set
                     (EF, EE, VF; read from the stencils it built) depart
                     from the reference's count, beyond that set's pairs
                     at the threshold (below), worst set and frame: a
                     contact the reference does not have (a wrong
                     exclusion, threshold or cap) lands on rows that the
                     two numbers above do not look at: exact
  detect_overflow    frames of the run whose detection found a grid cell
                     over its cap or dropped hits over its budget: exact

Pairs at the threshold: the program forms its closest points in float32
from absolute coordinates, so its distances are off by a few units in the
last place of the largest coordinate; a pair within NEAR_ULPS of them of
the threshold may fall on either side there. The reference decides such
a pair by its float64 distance, as any other. Where the program decided
it otherwise, the pair changes the rows of its own vertices in H and b,
and in M the bank of 32 fine nodes each of them is in (the coarse banks
above, which hold a thousand nodes and more, far less): so the residuals
leave out its vertices' rows and the apply gaps the rows of their fine
banks, and each such pair may move its set's count by one. Their count is
printed with each frame's contact set.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import contact as contact_mod
from . import reference as ref

F64 = torch.float64
BIG = 1e300
# half-width of the band around the threshold, in units in the last place
# of the frame's largest float32 coordinate (the program's closest points
# round by about two)
NEAR_ULPS = 8


class Frame(NamedTuple):
    x_prev: object          # f32[N,3] positions before the previous frame (None on frame 0)
    x_in: torch.Tensor
    x_out: torch.Tensor
    r0: torch.Tensor        # the program's layout
    z0: torch.Tensor
    x: torch.Tensor         # the PCG's solution, the program's layout
    live: object            # i64[3] live stencils of EF, EE, VF (None: no detection ran)


def order(config: dict, mesh: dict, x_resort: np.ndarray) -> np.ndarray:
    if config["ordering"] == "grid_tiles":
        return ref.tile_order(int(mesh["grid"][0]))
    return ref.morton_order(x_resort, config["schwarz"]["morton_normalization"])


def _rel(a: torch.Tensor, b: torch.Tensor, rows=None) -> float:
    if rows is not None:
        if not bool(rows.any()):
            return 0.0
        a, b = a[rows], b[rows]
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def judge(frames: dict, mesh: dict, scene, config: dict, unconverged: int, device,
          detect_overflow: int = 0):
    """-> (numbers, hierarchy, notes). `frames` maps checked frame -> Frame;
    `notes` are lines about each frame's contact set."""
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
    con = scene.contact
    if con is not None:
        numbers.update(contact_apply_gap=0.0, contact_residual=0.0, contact_count_gap=0,
                       detect_overflow=detect_overflow)
        fine_bank = hier.nodes[0] // ref.BANK
    notes = []
    for f in sorted(frames):
        fr = frames[f]
        x_in = fr.x_in.to(device)
        if fr.x_prev is None:
            v = torch.as_tensor(scene.v0, device=device).to(F64)
        else:
            v = (x_in.to(F64) - fr.x_prev.to(device, F64)) / dt
        if con is not None:
            x64 = x_in.to(F64)
            near = NEAR_ULPS * torch.finfo(torch.float32).eps * float(x_in.abs().max())
            st, undecided, info = contact_mod.find(x64, mesh["faces"], mesh["edges"],
                                                   con.threshold, con.per_primitive_cap, near)
            shaky = contact_mod.rows_touched(undecided, n, pinned)
            # rows of every fine bank an undecided pair's vertex is in
            banks = torch.zeros(int(fine_bank.max()) + 1, dtype=torch.bool, device=device)
            banks[fine_bank[shaky]] = True
            steady = ~banks[fine_bank]
            touched = contact_mod.rows_touched(st, n, pinned)
            live = [0, 0, 0] if fr.live is None else [int(c) for c in fr.live]
            band = torch.bincount(undecided.kind, minlength=len(contact_mod.KINDS)).tolist()
            numbers["contact_count_gap"] = max(
                numbers["contact_count_gap"],
                *(max(0, abs(p - info[k]) - b) for p, k, b in zip(live, contact_mod.KINDS, band)))
            counts = " ".join(f"{key}={val}" for key, val in info.items())
            notes.append(f"contact frame {f}: {counts} band={near:.3e} rows={int(touched.sum())}"
                         + f" rows_left_out={int((touched & ~steady).sum())}"
                         + " program_EF_EE_VF=" + ",".join(map(str, live)))
            forces = contact_mod.forces(st, x64, con.stiffness, con.rest_gap)
            b_ref = ref.rhs(x_in, v, mesh, pinned, scene.gravity, device, scene.rest, forces)
            sysm = ref.system(x_in, mesh, pinned, device, st, con.stiffness)
        else:
            b_ref = ref.rhs(x_in, v, mesh, pinned, scene.gravity, device, scene.rest)
            sysm = ref.system(x_in, mesh, pinned, device)
        layouts = {"rows": lambda t: t, "sorted": lambda t: t[o2s]}
        if tuple(fr.r0.shape) == (3, n):
            layouts = {"planes": lambda t: t.T}
        gaps = {k: _rel(fn(fr.r0.to(device, F64)), b_ref) for k, fn in layouts.items()}
        layout = min(gaps, key=gaps.get)
        if not gaps[layout] < 0.5:   # no layout of the program's vectors fits
            worst = gaps[layout] if math.isfinite(gaps[layout]) else BIG
            for k in ("apply_gap", "residual", "contact_apply_gap", "contact_residual"):
                if k in numbers:
                    numbers[k] = max(numbers[k], worst)
            continue
        to_orig = layouts[layout]
        pre = ref.Preconditioner(sysm, hier, applied, float(schwarz["coarse_damping"]))
        z_ref = pre.apply(b_ref)
        del pre
        z0 = to_orig(fr.z0.to(device)).to(F64)
        x32 = to_orig(fr.x.to(device)).float()
        r0 = to_orig(fr.r0.to(device)).to(F64)
        hx = ref.matvec(sysm, x32.to(F64))
        if con is None:
            numbers["apply_gap"] = max(numbers["apply_gap"], _rel(z0, z_ref))
            numbers["residual"] = max(numbers["residual"], _rel(hx, r0))
        else:
            for k, gap in (("apply_gap", _rel(z0, z_ref, steady)),
                           ("contact_apply_gap", _rel(z0, z_ref, touched & steady)),
                           ("residual", _rel(hx, r0, ~shaky)),
                           ("contact_residual", _rel(hx, r0, touched & ~shaky))):
                numbers[k] = max(numbers[k], gap)
        dx = torch.where(pinned[:, None], torch.zeros_like(x32), x32)
        numbers["update_mismatch"] += int((fr.x_out.to(device) != x_in + dx).sum())
    # a NaN or an overflow reads as the largest number JSON carries
    numbers = {k: v if math.isfinite(v) else BIG for k, v in numbers.items()}
    return numbers, hier, notes


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)
