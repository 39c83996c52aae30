"""spans.py on a hand-made Chrome trace, the metric readers with and without
the spans, and the program's ELL counters in the tiny cells on the CPU.

Run: python -m pytest benchmark/tests/test_bm_spans.py -q
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bm_support as bm  # noqa: E402

if bm.REPO not in sys.path:
    sys.path.insert(0, bm.REPO)
from benchmark import devtrace, roofline, spans  # noqa: E402

torch.set_num_threads(2)

with open(os.path.join(bm.REPO, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)

# host spans (name, start, end) in us, on one thread, inside the window 0-1000
HOST = [("frame", 10, 900),
        ("frame.prepare", 20, 90), ("prepare.factor", 50, 80),
        ("frame.pcg", 100, 800),
        ("pcg.spmv", 110, 120), ("pcg.precond", 130, 150), ("apply.symv", 135, 145),
        ("pcg.sync", 160, 200),
        ("pcg.spmv", 210, 220), ("pcg.precond", 230, 250), ("pcg.sync", 260, 300),
        ("pcg.spmv", 310, 320), ("pcg.precond", 330, 350), ("pcg.sync", 360, 400),
        ("frame.update", 810, 850)]
# (correlation, launch time, category, device start, device end)
LAUNCHED = [(1, 25, "kernel", 30, 60),       # frame.prepare
            (2, 55, "kernel", 60, 90),       # prepare.factor
            (3, 112, "kernel", 115, 135),    # spmv 1
            (4, 137, "kernel", 140, 170),    # apply.symv in precond 1
            (5, 132, "kernel", 170, 180),    # precond 1
            (6, 155, "kernel", 180, 185),    # frame.pcg: a vector update
            (7, 165, "gpu_memcpy", 185, 187),  # pcg.sync: the read
            (8, 212, "kernel", 213, 233),    # spmv 2
            (9, 232, "kernel", 233, 273),    # precond 2
            (10, 235, "kernel", 250, 263),   # precond 2, overlapping
            (11, 262, "gpu_memcpy", 273, 275),
            (12, 312, "kernel", 315, 335),   # spmv 3
            (13, 332, "kernel", 335, 375),   # precond 3
            (14, 355, "kernel", 375, 380),   # frame.pcg
            (15, 362, "gpu_memcpy", 380, 382),
            (16, 815, "kernel", 815, 825),   # frame.update
            (17, 905, "kernel", 950, 960)]   # launched under no span
# device gaps in the window: 0-30 (no span open), 90-115 (frame), 135-140
# (apply.symv), 187-213, 275-315, 382-815 (pcg.sync), 825-950 (frame.update),
# 960-1000 (none): 724 us idle, 504 of them begun inside frame.pcg
IDLE_US, PCG_IDLE_US = 724.0, 504.0


def _event(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": float(ts),
            "dur": float(dur), "args": args}


def _write(tmp_path, host=HOST, launched=LAUNCHED):
    ev = [_event(devtrace.WINDOW, "user_annotation", 0, 1000)]
    ev += [_event(n, "user_annotation", a, b - a) for n, a, b in host]
    ev += [_event("aten::mul", "cpu_op", t - 1, 3) for _, t, *_ in launched]
    for corr, t, cat, d0, d1 in launched:
        ev.append(_event("cudaLaunchKernel", "cuda_runtime", t, 1, correlation=corr))
        ev.append(_event(f"void k{corr}<float>(float*)", cat, d0, d1 - d0, tid=7,
                         correlation=corr))
    if launched:
        # a fill whose launch the trace lost, under kernel 17; a device-side
        # copy of a span, which is not device work
        ev.append(_event("Memset (Device)", "gpu_memset", 955, 3, tid=7, correlation=999))
        ev.append(_event("frame.pcg", "gpu_user_annotation", 115, 267, tid=7))
    path = str(tmp_path / "host.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    return path


def test_reduction_by_hand(tmp_path):
    r = spans.reduce(_write(tmp_path))
    names = [s.name for s in r.spans]
    assert sorted(names) == sorted(n for n, _, _ in HOST)
    parent = {(s.name, s.t0): r.spans[s.parent].name if s.parent >= 0 else None
              for s in r.spans}
    assert parent[("apply.symv", 135)] == "pcg.precond"
    assert parent[("prepare.factor", 50)] == "frame.prepare"
    assert parent[("pcg.sync", 360)] == "frame.pcg"
    assert parent[("frame", 10)] is None
    assert r.window_us == 1000.0 and r.busy_us == 276.0 and r.idle_us == IDLE_US
    assert spans._union(r.unattributed) == 10.0

    assert spans.prepare_ms(r) == pytest.approx(0.060)
    assert spans.spmv_us(r) == pytest.approx(20.0)
    assert spans.apply_us(r) == pytest.approx(40.0)         # overlaps counted once
    assert spans.pcg_iterations(r) == 2
    assert spans.pcg_vector_us(r) == pytest.approx(16.0 / 2)
    assert spans.pcg_idle_share_pct(r) == pytest.approx(100.0 * PCG_IDLE_US / IDLE_US)
    cov = spans.coverage(r)
    assert cov["frame_busy_us"] == 266.0
    assert cov["share"] == pytest.approx(1.0) and cov["sum_ratio"] == pytest.approx(1.0)
    table = spans.table(r)
    assert table["pcg.spmv"] == [3, 60.0, 0.0]
    assert table["pcg.sync"][2] == pytest.approx(26.0 + 40.0 + 433.0)
    assert table["frame"][2] == pytest.approx(25.0)

    s = spans.summary(r)
    assert set(spans.QUANTITIES) <= set(s)
    json.dumps(s)


def test_a_launch_outside_the_children_lowers_the_coverage(tmp_path):
    # kernel 6 launched between the frame's children: the frame's own time
    launched = [x if x[0] != 6 else (6, 95, "kernel", 180, 185) for x in LAUNCHED]
    r = spans.reduce(_write(tmp_path, launched=launched))
    cov = spans.coverage(r)
    assert cov["share"] == pytest.approx(261.0 / 266.0)
    assert cov["sum_ratio"] == pytest.approx(261.0 / 266.0)
    assert spans.pcg_vector_us(r) == pytest.approx(11.0 / 2)


@pytest.mark.parametrize("host", [[], [("other", 0, 5)]], ids=["no_spans", "no_pcg"])
def test_quantities_are_none_without_program_spans(tmp_path, host):
    r = spans.reduce(_write(tmp_path, host=host))
    assert (r is None) == (not host)
    for name, f in spans.QUANTITIES.items():
        assert f(r) is None, name
    assert spans.summary(None) is None


def test_no_device_events_reduce_to_none(tmp_path):
    assert spans.reduce(_write(tmp_path, launched=[])) is None


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"bm_metric_{name}", os.path.join(bm.REPO, "benchmark", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OLD_METRICS = ["pcg_iters", "device_idle_pct", "kernels_per_frame", "k1_roofline_pct",
               "k2_roofline_pct", "k4_roofline_pct"]


def test_old_readers_ignore_the_new_context(tmp_path):
    kernels = {"spd_inverse96_kernel": [2.8e-3] * 3, "packed_symv96_kernel": [2.4e-4] * 400,
               "stencil_spmv_kernel": [1.8e-4] * 400, "elementwise_kernel": [1e-5] * 900}
    tr = devtrace.Trace(0.32, 0.25, kernels, {k: sum(v) for k, v in kernels.items()}, 3)
    problem = dict(n=1 << 20, blocks=33825, planes=12, level_sizes=[1 << 20, 32768, 1024, 32],
                   nnz_spmv=1, nnz_apply=1)
    base = dict(iters=[140, 150], trace=tr, problem=problem, roofline=roofline)
    r = spans.reduce(_write(tmp_path))
    plain, grown = SimpleNamespace(**base), SimpleNamespace(**base, spans=r,
                                                            counters={"spmv.ell_slots": 8})
    for name in OLD_METRICS:
        mod = _reader(name)
        v = mod.read(plain)
        assert v is not None and v == mod.read(grown), name


def test_ell_fill_reads_the_counters(monkeypatch):
    from precond_tpu_torch import profiling

    mod = _reader("ell_fill_pct")
    monkeypatch.setattr(profiling, "_COUNTS", {"spmv.ell_slots": 400, "spmv.ell_stored": 150})
    assert mod.read(SimpleNamespace()) == pytest.approx(37.5)
    monkeypatch.setattr(profiling, "_COUNTS", {})
    assert mod.read(SimpleNamespace()) is None
    # a program without the registry
    monkeypatch.delattr(profiling, "counters")
    assert mod.read(SimpleNamespace()) is None


def test_ell_fill_names_only_the_general_cell():
    entry = [m for m in SPEC["per_layer"] if m["name"] == "ell_fill_pct"]
    assert entry and entry[0]["workloads"] == ["cloth_delaunay_1m.drape"]
    assert entry[0]["source"] == "program_counter"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return bm.tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("config", ["cloth_grid_1m_tiny", "cloth_delaunay_1m_tiny"])
def test_tiny_cells_write_the_fill_where_the_ell_is_walked(checkout, config):
    from precond_tpu_torch import profiling

    profiling._COUNTS.clear()
    result, lines = bm.run_cpu(checkout, f"{config}.drape", trace=True)
    assert result["correct"], lines
    got = result["metrics"].get("ell_fill_pct")
    if config.startswith("cloth_delaunay"):
        c = profiling.counters()
        assert got == {"value": 100.0 * c["spmv.ell_stored"] / c["spmv.ell_slots"], "unit": "%"}
        assert 0.0 < got["value"] < 100.0
    else:
        assert got is None
    assert set(result["metrics"]) <= {"pcg_iters", "ell_fill_pct"}
