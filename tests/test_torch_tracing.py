"""The port's spans and counters (profiling.span / tracing / counters) on the
CPU: the simulators' frames traced by a CPU torch.profiler, every span under
its parent, the frame's operator time under its children, nothing recorded
outside tracing(), and the same positions bit for bit with tracing on."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from precond_tpu_torch import SchwarzConfig, profiling
from precond_tpu_torch.models import cloth, tetmesh
from precond_tpu_torch.models.simulator import ClothSim, SoftBodySim
from precond_tpu_torch.profiling import PhaseTimer, device_trace, span, tracing

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import torch_irregular_mesh as tim  # noqa: E402

torch.set_num_threads(2)

PARENT = {
    "frame": None,
    "frame.resort": "frame", "frame.detect": "frame", "frame.rhs": "frame",
    "frame.refresh": "frame", "frame.prepare": "frame", "frame.pcg": "frame",
    "frame.update": "frame",
    "prepare.permute": "frame.prepare", "prepare.hierarchy": "frame.prepare",
    "prepare.assembly": "frame.prepare", "prepare.factor": "frame.prepare",
    "pcg.spmv": "frame.pcg", "pcg.precond": "frame.pcg", "pcg.sync": "frame.pcg",
    "apply.restrict": "pcg.precond", "apply.symv": "pcg.precond",
    "apply.prolong": "pcg.precond",
}
GRID_SPANS = set(PARENT) - {"frame.resort", "prepare.permute", "prepare.hierarchy"}
GENERAL_SPANS = set(PARENT) - {"frame.detect"}


def _grid_sim():
    """32 x 32 grid path, contact detection on (a flat sheet: no contacts)."""
    mesh = cloth.make_grid(32, 32, z_wave=0.02, mass=1e-3)
    return ClothSim(mesh, SchwarzConfig(), pinned=np.arange(32), collision_stiffness=1e3,
                    collision_threshold=1e-3, collision_budget=256, collision_cell_cap=8,
                    device="cpu")


def _general_sim():
    """A 400-vertex Delaunay sheet: the general path, re-sorting on frame 0."""
    return ClothSim(cloth.ClothMesh(**tim.irregular_cloth(20)), SchwarzConfig(),
                    pinned=np.arange(20), device="cpu")


def _box_sim():
    box = tetmesh.make_box(8, 8, 8, mass=0.05, youngs=5e4)
    return SoftBodySim(box, SchwarzConfig(), pinned=np.flatnonzero(box.positions[:, 2] < 1e-6),
                       material="corotational", device="cpu")


SIMS = {"grid": _grid_sim, "general": _general_sim, "box": _box_sim}


def _trace(fn, path, on=True):
    """Run fn under a CPU torch.profiler (spans on or off); the trace's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if on:
            with tracing():
                fn()
        else:
            fn()
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _tree(events):
    """[(name, t0, t1, parent index)] of the user annotations, nested."""
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"), key=lambda s: (s[1], -s[2]))
    out, stack = [], []
    for name, t0, t1 in spans:
        while stack and out[stack[-1]][2] <= t0:
            stack.pop()
        out.append((name, t0, t1, stack[-1] if stack else -1))
        stack.append(len(out) - 1)
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each simulator's second and third frames, traced; the first frame of
    the general sheet's second episode re-sorts."""
    d = tmp_path_factory.mktemp("tracing")
    out = {}
    for kind, make in SIMS.items():
        sim = make()
        sim.step()
        iters = []

        def frames():
            if kind == "general":
                sim.pre.frame_index = 0
            for _ in range(2):
                sim.step()
                iters.append(sim.last_solve.iterations)

        out[kind] = (_trace(frames, str(d / f"{kind}.json")), iters)
    return out


@pytest.mark.parametrize("kind,expected", [("grid", GRID_SPANS), ("general", GENERAL_SPANS)])
def test_every_span_under_its_parent(traced, kind, expected):
    events, iters = traced[kind]
    tree = _tree(events)
    assert {s[0] for s in tree} == expected
    for name, _, _, parent in tree:
        assert (tree[parent][0] if parent >= 0 else None) == PARENT[name], name
    frames = [i for i, s in enumerate(tree) if s[0] == "frame"]
    assert len(frames) == 2
    for i, it in zip(frames, iters):
        pcg = [j for j, s in enumerate(tree) if s[0] == "frame.pcg" and s[3] == i]
        calls = [s for s in tree if s[3] == pcg[0]]
        # one SpMV and one preconditioner call before the loop and one an
        # iteration; one convergence test an iteration and the last one
        assert sum(s[0] == "pcg.spmv" for s in calls) == it + 1
        assert sum(s[0] == "pcg.precond" for s in calls) == it + 1
        assert sum(s[0] == "pcg.sync" for s in calls) == it + 1
    if kind == "general":
        assert sum(s[0] == "frame.resort" for s in tree) == 1


def test_softbody_frame_spans(traced):
    tree = _tree(traced["box"][0])
    names = {s[0] for s in tree}
    assert {"frame", "frame.refresh", "frame.rhs", "frame.prepare", "prepare.assembly",
            "prepare.factor", "frame.pcg", "pcg.spmv", "pcg.precond", "apply.symv",
            "frame.update"} <= names
    for name, _, _, parent in tree:
        assert (tree[parent][0] if parent >= 0 else None) == PARENT[name], name


@pytest.mark.parametrize("kind", list(SIMS))
def test_frame_operator_time_falls_under_its_children(traced, kind):
    events, _ = traced[kind]
    tree = _tree(events)
    ops = sorted(((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "cpu_op"),
                 key=lambda o: (o[0], -o[1]))
    top, end = [], -1.0
    for o in ops:  # operators not inside another operator
        if o[0] >= end:
            top.append(o)
            end = o[1]
    for i, (_, f0, f1, _) in enumerate(tree):
        if tree[i][0] != "frame":
            continue
        kids = [(s[1], s[2]) for s in tree if s[3] == i]
        mine = [o for o in top if f0 <= o[0] and o[1] <= f1]
        under = sum(o[1] - o[0] for o in mine if any(k0 <= o[0] and o[1] <= k1 for k0, k1 in kids))
        total = sum(o[1] - o[0] for o in mine)
        assert total > 0 and under > 0.99 * total, (kind, under / total)


def test_no_span_outside_tracing(tmp_path):
    sim = _general_sim()
    events = _trace(sim.step, str(tmp_path / "off.json"), on=False)
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not [e for e in events if e.get("cat") == "user_annotation"]
    assert span("frame") is span("pcg.spmv")


@pytest.mark.parametrize("kind", ["grid", "general"])
def test_tracing_leaves_the_positions_bitwise_equal(tmp_path, kind):
    def three(sim):
        for _ in range(3):
            sim.step()

    off = SIMS[kind]()
    three(off)
    on = SIMS[kind]()
    _trace(lambda: three(on), str(tmp_path / "on.json"))
    assert torch.equal(on.state.positions, off.state.positions)
    assert torch.equal(on.state.velocities, off.state.velocities)


def test_tracing_nests_and_restores():
    assert not profiling._TRACING
    with tracing():
        with tracing():
            assert span("x") is not span("x")
        assert profiling._TRACING
    assert not profiling._TRACING
    with pytest.raises(RuntimeError):
        with tracing():
            raise RuntimeError("leaves the switch as it was")
    assert not profiling._TRACING


def test_counter_registry(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    profiling.set_count("test.a", 5)
    profiling.count("test.a")
    profiling.count("test.b", 2.5)
    snap = profiling.counters()
    assert snap["test.a"] == 6 and snap["test.b"] == 2.5
    profiling.count("test.a", 4)
    assert snap["test.a"] == 6 and profiling.counters()["test.a"] == 10  # a snapshot


def test_general_sim_counts_its_ell_slots():
    arrays = tim.irregular_cloth(20)
    sim = ClothSim(cloth.ClothMesh(**arrays), SchwarzConfig(), device="cpu")
    c = profiling.counters()
    mask = sim._ell0.mask
    assert c["spmv.ell_slots"] == mask.numel() == 400 * mask.shape[1]
    # every spring fills one slot at each of its ends
    assert c["spmv.ell_stored"] == int(mask.sum()) == 2 * len(arrays["springs"])


def test_phase_timer_opens_a_span(tmp_path):
    timer = PhaseTimer()

    def work():
        with timer.phase("prepare") as out:
            out["sync"] = torch.ones(4) * 2

    events = _trace(work, str(tmp_path / "on.json"))
    assert [s[0] for s in _tree(events)] == ["prepare"]
    events = _trace(work, str(tmp_path / "off.json"), on=False)
    assert _tree(events) == []
    assert timer.counts["prepare"] == 2 and timer.as_dict()["prepare"] >= 0.0


def test_device_trace_turns_tracing_on(tmp_path):
    sim = _grid_sim()
    sim.step()
    with device_trace(str(tmp_path / "t")):
        sim.step()
    assert not profiling._TRACING
    with open(tmp_path / "t" / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    names = {s[0] for s in _tree(events)}
    assert {"frame", "frame.pcg", "pcg.spmv", "apply.symv"} <= names
