"""Debug-mode numerical guards (port of ``precond_tpu/utils/guards.py``).

Reference analogues: stencil-overflow clamp + printf (cpp:312-316),
identity-fill of singular blocks (cpp:1365-1367). Here: explicit NaN/Inf
sentinels and hierarchy overflow checks that wrap a prepare in debug runs.
Each check reads a few scalars back to the host.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.apply import ApplyState
from ..ops.cuda.packed_symv import DenseInverseCM, PackedInverse, PackedInverseCM


def check_finite(name: str, *tensors: torch.Tensor) -> List[str]:
    """Return a list of problem descriptions (empty = healthy)."""
    problems = []
    for i, t in enumerate(tensors):
        bad = int((~torch.isfinite(t)).sum())
        if bad:
            problems.append(f"{name}[{i}]: {bad}/{t.numel()} non-finite values")
    return problems


def validate_apply_state(state: ApplyState) -> List[str]:
    """Sanity-check a prepared preconditioner state.

    A bf16 table is widened to f32 for the checks: the widening is exact,
    so a NaN or Inf stays one and the asymmetry is the stored one."""
    inv = state.inv96
    if isinstance(inv, (PackedInverse, PackedInverseCM)):
        # packed storage keeps one copy of each off-diagonal element, so
        # the applied operator is symmetric by construction — only
        # finiteness can go wrong
        problems = check_finite("inv96.packed", inv.f, inv.dg)
    else:
        name, m = ("inv96.cm", inv.m) if isinstance(inv, DenseInverseCM) else ("inv96", inv)
        m = m.float()
        problems = check_finite(name, m)
        asym = float((m - m.transpose(1, 2)).abs().max())
        scale = max(float(m.abs().max()), 1e-30)
        if asym > 1e-5 * scale:
            problems.append(f"{name} asymmetry {asym:.3e} (scale {scale:.3e})")
    if bool(state.overflow):
        problems.append(
            "hierarchy overflow: a level exceeded its static capacity "
            "(raise SchwarzConfig.level_headroom)"
        )
    return problems


def assert_healthy(state: ApplyState) -> None:
    """Raise on an unhealthy prepared state (a real exception, so the
    guard survives ``python -O``)."""
    problems = validate_apply_state(state)
    if problems:
        raise RuntimeError("; ".join(problems))


def assert_system_finite(ell) -> None:
    """Abort on a poisoned INPUT system (NaN/Inf in diag or blocks).

    Checked separately from the prepared state: the inverse repairs
    non-finite blocks by identity fill, so a poisoned input could otherwise
    factorize to a finite-but-meaningless preconditioner.
    """
    problems = check_finite("system.diag", ell.diag)
    blocks = getattr(ell, "blocks", None)
    if blocks is not None:
        problems += check_finite("system.blocks", blocks)
    if problems:
        raise ValueError("; ".join(problems))
