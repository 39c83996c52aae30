"""Observability: per-phase timing and solver metrics (port of
``precond_tpu/profiling.py``).

Every solve can emit structured metrics (iterations, residual curve,
per-phase milliseconds, nnz/s) with the JAX package's fields, rounding and
JSON. A phase synchronizes the card around its clock where the JAX package
blocks on its arrays, and ``device_trace`` writes a torch.profiler Chrome
trace where the JAX package writes a jax.profiler one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


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
    """Wall-clock per-phase accumulator (device-synchronized)."""

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
    Records CPU activity, and CUDA activity whenever a card is present."""
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
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
