"""Preconditioned conjugate gradients (port of ``precond_tpu/parallel/pcg.py``).

The reference leaves the PCG loop to the host simulator (SURVEY.md §3.4,
SeSchwarzPreconditioner.h:55-63). Here it is a Python loop over device
tensors. Dot products go through a reduction hook (identity on one
device) so a distributed caller can insert an all-reduce.

Host syncs: the convergence test reads ||r||^2 on the host, which syncs
once per tested iteration (`check_every` spaces the tests out). Everything
else stays on the device; capturing the loop body in a CUDA graph is later
work. Spans (profiling.span): ``pcg.spmv`` and ``pcg.precond`` around each
operator call, ``pcg.sync`` around the host read of the convergence test.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..profiling import span


class PcgResult(NamedTuple):
    x: torch.Tensor             # f32[N,3]
    iterations: int
    rel_residual: torch.Tensor  # f32[]


def _identity_reduce(x: torch.Tensor) -> torch.Tensor:
    return x


def pcg(
    spmv: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-4,
    max_iters: int = 1000,
    reduce_sum: Callable[[torch.Tensor], torch.Tensor] = _identity_reduce,
    check_every: int = 1,
) -> PcgResult:
    """Solve H x = b to ||r|| <= tol * ||b|| (the BASELINE.md criterion).

    spmv/precond map f32[N,3] -> f32[N,3]. check_every > 1 tests
    convergence only every that many iterations (runs up to check_every-1
    past tolerance — harmless for CG), one host sync per test.
    """

    def dot(u, v):
        return reduce_sum(torch.sum(u * v))

    x = torch.zeros_like(b) if x0 is None else x0.clone()
    with span("pcg.spmv"):
        ax = spmv(x)
    r = b - ax
    with span("pcg.precond"):
        z = precond(r)
    p = z
    rz = dot(r, z)
    b2 = dot(b, b)
    tol2 = tol * tol * b2
    it = 0
    while it < max_iters:
        live = dot(r, r) > tol2
        # one host sync per convergence test
        with span("pcg.sync"):
            live = bool(live)
        if not live:
            break
        for _ in range(max(check_every, 1)):
            with span("pcg.spmv"):
                q = spmv(p)
            alpha = rz / dot(p, q)
            x = x + alpha * p
            r = r - alpha * q
            with span("pcg.precond"):
                z = precond(r)
            rz_new = dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
    rel = torch.sqrt(dot(r, r) / torch.clamp(b2, min=1e-30))
    return PcgResult(x=x, iterations=it, rel_residual=rel)


def pcg_with_history(
    spmv: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    num_iters: int,
    x0: Optional[torch.Tensor] = None,
    reduce_sum: Callable[[torch.Tensor], torch.Tensor] = _identity_reduce,
):
    """Fixed-iteration PCG recording the relative-residual curve.

    Returns (x, rel_residuals f32[num_iters]); no host sync inside the loop.
    """

    def dot(u, v):
        return reduce_sum(torch.sum(u * v))

    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - spmv(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    bnorm = torch.sqrt(torch.clamp(dot(b, b), min=1e-30))
    curve = []
    for _ in range(num_iters):
        q = spmv(p)
        alpha = rz / dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = precond(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        curve.append(torch.sqrt(dot(r, r)) / bnorm)
    return x, torch.stack(curve) if curve else b.new_zeros((0,))


def jacobi_preconditioner(diag: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """Block-Jacobi (3x3 diagonal inverse) baseline preconditioner."""
    inv = torch.linalg.inv(diag)

    def apply(r):
        return torch.einsum("nij,nj->ni", inv, r)

    return apply
