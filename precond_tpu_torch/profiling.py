"""Observability: per-phase timing and solver metrics (port of
``precond_tpu/profiling.py``).

Every solve can emit structured metrics (iterations, residual curve,
per-phase milliseconds, nnz/s) with the JAX package's fields, rounding and
JSON. A phase synchronizes the card around its clock where the JAX package
blocks on its arrays, and ``device_trace`` writes a torch.profiler Chrome
trace where the JAX package writes a jax.profiler one.

Spans name the phases of a frame without synchronizing anything: inside
``tracing()`` each ``span(name)`` is a ``torch.profiler.record_function``
range, which a running torch.profiler stamps on the clock of the kernels it
records (and ``torch.autograd.profiler.emit_nvtx()`` turns into an NVTX
range). Outside ``tracing()`` a span is one flag test. The names are dotted,
parent first: ``frame`` (``ClothSim.step``) with ``frame.resort``,
``frame.detect``, ``frame.rhs``, ``frame.refresh``, ``frame.prepare``,
``frame.pcg`` and ``frame.update``; ``prepare.permute``,
``prepare.hierarchy``, ``prepare.assembly`` and ``prepare.factor`` in the
prepares; ``pcg.spmv``, ``pcg.precond`` and ``pcg.sync`` in ``pcg``;
``apply.restrict``, ``apply.symv`` and ``apply.prolong`` in the applies.
``counters()`` is a registry of counts the program sets on the host.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


class _Off:
    """The span outside ``tracing()``: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_TRACING = False
_OFF = _Off()
_COUNTS: Dict[str, float] = {}


def span(name: str):
    """A named range of the program: a ``record_function`` range inside
    ``tracing()``, a shared no-op context outside it. Never synchronizes."""
    if not _TRACING:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def tracing():
    """Turn spans on inside the block (and back to what they were after)."""
    global _TRACING
    was, _TRACING = _TRACING, True
    try:
        yield
    finally:
        _TRACING = was


def count(name: str, n: float = 1) -> None:
    """Add `n` to the counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def set_count(name: str, value: float) -> None:
    _COUNTS[name] = value


def counters() -> Dict[str, float]:
    """A snapshot of every counter.

    ``spmv.ell_slots`` / ``spmv.ell_stored``: the padded slots (N x width)
    and the stored off-diagonal blocks of the block-ELL system that the
    general path's SpMV iterates on, set by ``ClothSim`` when it is built.
    """
    return dict(_COUNTS)


def _sync(obj) -> None:
    """Wait for the devices of the CUDA tensors in `obj` (a tensor, or a
    (named) tuple, list or dict of them); CPU tensors need nothing."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _sync(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _sync(v)


@dataclass
class PhaseTimer:
    """Wall-clock per-phase accumulator (device-synchronized); each phase
    is also a ``span`` of its name."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync: object = None):
        """Time the block. `sync` (tensors the phase waits for before its
        clock starts) and ``out["sync"]`` (set inside the block: tensors the
        phase waits for before its clock stops) are synchronized."""
        if sync is not None:
            _sync(sync)
        t0 = time.perf_counter()
        out = {}
        try:
            with span(name):
                yield out
        finally:
            if "sync" in out:
                _sync(out["sync"])
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> Dict[str, float]:
        return {k: round(v * 1e3, 3) for k, v in self.phases.items()}

    def report(self) -> str:
        rows = [f"{k}: {v * 1e3:8.2f} ms (x{self.counts[k]})" for k, v in self.phases.items()]
        return "\n".join(rows)


def phase_of(timer: Optional[PhaseTimer], name: str):
    """``timer.phase(name)``, or a block that times nothing without a timer
    (its ``out`` dict is accepted and ignored)."""
    return timer.phase(name) if timer is not None else contextlib.nullcontext({})


@dataclass
class SolveMetrics:
    """Structured record of one preconditioned solve."""

    num_verts: int = 0
    nnz_blocks: int = 0
    iterations: int = 0
    rel_residual: float = 0.0
    phase_ms: Dict[str, float] = field(default_factory=dict)
    residual_curve: List[float] = field(default_factory=list)

    def nnz_per_second(self) -> Optional[float]:
        it_ms = self.phase_ms.get("iterate")
        if not it_ms or not self.iterations:
            return None
        return 9 * self.nnz_blocks * self.iterations / (it_ms / 1e3)

    def to_json(self) -> str:
        d = {
            "num_verts": self.num_verts,
            "nnz_blocks": self.nnz_blocks,
            "iterations": self.iterations,
            "rel_residual": self.rel_residual,
            "phase_ms": self.phase_ms,
        }
        nps = self.nnz_per_second()
        if nps is not None:
            d["nnz_per_s"] = nps
        if self.residual_curve:
            d["residual_curve"] = self.residual_curve
        return json.dumps(d)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """torch.profiler trace around a region, written as a Chrome trace
    (``trace.json``) into `trace_dir`; a no-op when `trace_dir` is None.
    Records CPU activity, and CUDA activity whenever a card is present, with
    the program's spans on (``tracing()``)."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        with tracing():
            yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
