"""The port's observability plumbing (profiling.py), mirroring
tests/test_profiling.py, with the JAX package's module as the reference for
the fields, rounding and JSON."""

import json
import os
import time

import numpy as np
import pytest
import torch

from precond_tpu import profiling as jprof
from precond_tpu_torch.profiling import PhaseTimer, SolveMetrics, device_trace

torch.set_num_threads(2)


def test_phase_timer_accumulates():
    t = PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a", sync=torch.ones(8)):
        time.sleep(0.01)
    with t.phase("b") as out:
        out["sync"] = (torch.ones((8,)) * 2, {"x": torch.zeros(3)})  # device sync hook
    d = t.as_dict()
    assert d["a"] >= 15.0  # ms
    assert t.counts["a"] == 2
    assert "b" in d
    assert "a:" in t.report()


def test_phase_timer_rounding_and_report_match_jax():
    phases = {"prepare": 0.0123456789, "iterate": 1.23456789e-4}
    counts = {"prepare": 1, "iterate": 3}
    mine = PhaseTimer(phases=dict(phases), counts=dict(counts))
    ref = jprof.PhaseTimer(phases=dict(phases), counts=dict(counts))
    assert mine.as_dict() == ref.as_dict()
    assert mine.report() == ref.report()


@pytest.mark.parametrize("phase_ms,curve", [({"iterate": 6.0}, [1.0, 0.1, 0.01]),
                                            ({"prepare": 2.5}, []),
                                            ({}, [0.5])])
def test_solve_metrics_json_matches_jax(phase_ms, curve):
    kw = dict(num_verts=100, nnz_blocks=700, iterations=12, rel_residual=5e-5,
              phase_ms=phase_ms, residual_curve=curve)
    assert SolveMetrics(**kw).to_json() == jprof.SolveMetrics(**kw).to_json()
    j = json.loads(SolveMetrics(**kw).to_json())
    assert j["iterations"] == 12
    if "iterate" in phase_ms:
        assert j["nnz_per_s"] == 9 * 700 * 12 / 6e-3
    assert len(j.get("residual_curve", [])) == len(curve)


def test_device_trace(tmp_path):
    with device_trace(None):
        pass
    d = str(tmp_path / "trace")
    a = torch.as_tensor(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    with device_trace(d):
        (a @ a).sum()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
