"""Deterministic float placement: the port's one scatter-add.

The JAX package places floats with ``.at[idx].add`` (deterministic on a
TPU). On the card a plain ``index_add_`` / ``scatter_add_`` is an atomic
add, whose summation order changes from run to run, so the result would
not repeat bit for bit. Every float scatter-add of the port goes through
``accumulate_rows`` instead: ``index_put_(accumulate=True)`` under
PyTorch's deterministic algorithms sorts the targets stably and sums each
target's segment in that order (on the CPU it adds in index order). It is
a segmented sum: a row only ever adds values of its own segment, never a
running prefix differenced at segment boundaries.
"""

from __future__ import annotations

import torch


def accumulate_rows(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    valid: torch.Tensor | None = None) -> None:
    """out[idx] += vals in place, summing duplicates in a fixed order.

    With `valid`, only the valid entries whose target lies in out's rows are
    placed; the rest drop (JAX's ``mode="drop"``). They are removed before
    the placement rather than sent to a dump row: the deterministic kernel
    sums each target's run serially, so one dump row collecting most of a
    large set would serialize the whole placement.
    """
    if valid is not None:
        keep = valid & (idx >= 0) & (idx < out.shape[0])
        idx, vals = idx[keep], vals[keep]
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out.index_put_((idx.long(),), vals, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev)
