"""Batched dense inversion of the 96x96 domain Hessians (port of ``precond_tpu/ops/batched_inverse.py``).

The reference runs a hand-written AVX2 in-place LDL^T elimination per block
and emits a packed symmetric inverse (LDLtInverse512, cpp:1347-1546). This
module holds the plain PyTorch versions: the Cholesky oracle, the panel-32
blocked LDL^T + Gram inverse (the plain version of the CUDA kernel in
ops/cuda/spd_inverse.py), the non-finite repair, and the dense block
matvec (the plain version of ops/cuda/symv.py).
"""

from __future__ import annotations

import torch


def invert_spd_blocks(h96: torch.Tensor) -> torch.Tensor:
    """Explicit inverses of a batch of SPD matrices by Cholesky + two
    triangular solves, symmetrized (the oracle). [B,96,96] -> [B,96,96]."""
    m = h96.shape[-1]
    chol = torch.linalg.cholesky(h96)
    eye = torch.eye(m, dtype=h96.dtype, device=h96.device).expand_as(h96)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    inv = torch.linalg.solve_triangular(chol.transpose(1, 2), linv, upper=True)
    return 0.5 * (inv + inv.transpose(1, 2))


def _mm(a: torch.Tensor, b: torch.Tensor, tb: bool = False) -> torch.Tensor:
    """Batched a @ b (or a @ b^T) in full f32."""
    return torch.bmm(a, b.transpose(1, 2) if tb else b)


def _factor32(app: torch.Tensor):
    """(W1 = L^-1 unit-lower, d) of a batch of SPD 32x32 panels, in-place LDL^T.

    The same row operations are applied to an augmented identity, so W is
    built alongside the elimination; the trailing block stays symmetric, so
    column j below the pivot is read off the pivot row.
    """
    b, p, _ = app.shape
    eye = torch.eye(p, dtype=app.dtype, device=app.device)
    m = torch.cat([app, eye.expand(b, p, p)], dim=2)                 # [B,P,2P]
    sub = torch.arange(p, device=app.device)
    for j in range(p):
        row = m[:, j, :]                                             # [B,2P]
        dj = row[:, j: j + 1]                                        # [B,1]
        c = row[:, :p] * (sub > j) / dj                              # [B,P]
        m = m - c[:, :, None] * row[:, None, :]                      # rank-1
    d = torch.diagonal(m[:, :, :p], dim1=1, dim2=2)                  # [B,P]
    return m[:, :, p:], d


def lower_inverse_blocks(w1s, lblk, mm):
    """W = L^-1 blockwise: unit-block-lower forward substitution over the
    3x3 panel grid, parameterized over the matmul primitive."""
    wb = {(0, 0): w1s[0], (1, 1): w1s[1], (2, 2): w1s[2]}
    wb[(1, 0)] = -mm(w1s[1], mm(lblk[(1, 0)], wb[(0, 0)]))
    wb[(2, 0)] = -mm(
        w1s[2], mm(lblk[(2, 0)], wb[(0, 0)]) + mm(lblk[(2, 1)], wb[(1, 0)])
    )
    wb[(2, 1)] = -mm(w1s[2], mm(lblk[(2, 1)], wb[(1, 1)]))
    return wb


def invert_spd_blocks_panel(h96: torch.Tensor, repair: bool = True) -> torch.Tensor:
    """[B,96,96] SPD -> symmetric PSD inverses, panel-32 blocked LDL^T.

    Three 32-wide panel eliminations, rank-32 trailing updates, a blockwise
    triangular inverse, and one Gram product A^-1 = Wh^T Wh (Wh = D^-1/2
    L^-1) that makes the result symmetric and PSD by construction — the
    property that keeps CG valid on cond~1e7 stiff systems. The JAX version
    chunks the batch for the TPU's on-chip memory; no chunking here.
    """
    b = h96.shape[0]
    P, NP = 32, 3
    s = h96
    w1s, diss, lblk = [], [], {}
    for p in range(NP):
        w1, d = _factor32(s[:, :P, :P])
        w1s.append(w1)
        diss.append(torch.rsqrt(d))
        if p < NP - 1:
            r = s[:, P:, :P]                                 # [B,T,32]
            y = _mm(r, w1, tb=True)                          # R @ W1^T
            l21 = y * (1.0 / d)[:, None, :]
            s = s[:, P:, P:] - _mm(l21, y, tb=True)          # [B,T,T]
            for q in range(p + 1, NP):
                lblk[(q, p)] = l21[:, P * (q - p - 1): P * (q - p), :]

    wb = lower_inverse_blocks(w1s, lblk, _mm)

    zero = torch.zeros((b, P, P), dtype=h96.dtype, device=h96.device)
    rows = []
    for q in range(NP):
        blks = [diss[q][:, :, None] * wb[(q, p)] if (q, p) in wb else zero for p in range(NP)]
        rows.append(torch.cat(blks, dim=2))
    wh = torch.cat(rows, dim=1)                              # [B,96,96]
    gram = torch.bmm(wh.transpose(1, 2), wh)
    out = 0.5 * (gram + gram.transpose(1, 2))
    return _repair_nonfinite(out) if repair else out


def _repair_nonfinite(inv96: torch.Tensor) -> torch.Tensor:
    """Replace any non-finite block inverse with the identity.

    A NaN block anywhere in M would silently poison the whole CG solve; an
    identity block merely weakens the preconditioner on those 32 nodes.
    Production prepares repair; under debug_checks / PRECOND_DEBUG_CHECKS
    the solver turns the repair off so a genuine factorization bug reaches
    utils/guards.assert_healthy and raises.
    """
    ok = torch.isfinite(inv96).all(dim=2).all(dim=1)[:, None, None]
    eye = torch.eye(inv96.shape[-1], dtype=inv96.dtype, device=inv96.device)
    return torch.where(ok, inv96, eye[None])


def apply_block_inverse(inv96: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """z_b = inv_b @ r_b for every block. ([B,96,96], [B,96]) -> [B,96].

    The plain version of the dense symv (SchwarzLocalXSym, cpp:1600-1696);
    accumulation is f32. A bf16 table (SchwarzConfig.inverse_dtype) takes
    the rhs rounded to bf16, as the JAX package's ``rhs.astype(inv96.dtype)``
    does; both are widened to f32 before the einsum, because an einsum on
    bf16 operands returns bf16 and would round the output.
    """
    if inv96.dtype == torch.bfloat16:
        return torch.einsum("bij,bj->bi", inv96.float(), rhs.to(torch.bfloat16).float())
    return torch.einsum("bij,bj->bi", inv96, rhs)
