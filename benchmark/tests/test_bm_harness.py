"""The benchmark's harness on the CPU at 32 x 32: every cell's traffic mix
end to end, a cell added from files alone, the control and the faults that
must turn `correct` false, and what the harness and the reference import.

Run: python -m pytest benchmark/tests -q   (about a minute)
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bm_support as bm  # noqa: E402

torch.set_num_threads(2)

with open(os.path.join(bm.REPO, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
TINY_CELLS = [f"{w['config']}_tiny.{w['traffic']}" for w in SPEC["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "precond_tpu"}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return bm.tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", TINY_CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(checkout, workload, trace):
    result, lines = bm.run_cpu(checkout, workload, trace=trace)
    assert result["correct"], lines
    # the port and the float64 reference agree far inside the limit
    assert result["check"]["apply_gap"]["value"] < 1e-3, lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    # on the CPU only the program's own counts are written, never a time,
    # a rate, a memory size or a device share
    allowed = {m["name"] for m in SPEC["per_layer"] if m["source"] == "program_counter"}
    assert set(result["metrics"]) <= (allowed if trace else set())
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "check"
    assert [ln.split()[1] for ln in lines if ln.startswith("check ")] == list(result["check"])
    json.dumps(result, allow_nan=False)


def test_seed_makes_the_inputs(checkout):
    sys.path.insert(0, checkout)
    try:
        from benchmark import harness, scene

        cell = harness.load_cell(checkout, TINY_CELLS[0])
        mesh = harness.build_mesh(checkout, cell.config)
        a, b = scene.make(cell.traffic, mesh, 2**31 + 7), scene.make(cell.traffic, mesh, 2**31 + 7)
        c = scene.make(cell.traffic, mesh, 2**31 + 8)
    finally:
        sys.path.remove(checkout)
    assert np.array_equal(a.v0, b.v0) and a.checked == b.checked
    assert not np.array_equal(a.v0, c.v0)
    assert 0 in a.checked and len(a.pinned) > 0


def test_bf16_inverse_table_fails_the_comparison(checkout):
    """The control: the program's own bfloat16 inverse tables, the precision
    below the configuration's float32."""
    result, lines = bm.run_cpu(checkout, TINY_CELLS[0], inverse_dtype="bfloat16")
    assert not result["correct"], lines
    assert result["check"]["apply_gap"]["value"] > result["check"]["apply_gap"]["limit"]


# calibrate.py's faults that stay near the answer, read on the card too
NEAR_FAULTS = {"answer_altered": "answer_x1.01", "spmv_scaled": "spmv_x1.01"}


def _fault_run(checkout, monkeypatch, fault):
    from precond_tpu_torch.models import simulator

    if fault == "state_unchanged":
        real_step = simulator.ClothSim.step

        def step(self):
            before = self.state
            real_step(self)
            self.state = before
            return before

        monkeypatch.setattr(simulator.ClothSim, "step", step)
    else:
        spec = importlib.util.spec_from_file_location(
            "bm_calibrate", os.path.join(bm.REPO, "benchmark", "calibrate.py"))
        calibrate = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(calibrate)
        name, wrap, _ = calibrate.FAULTS[NEAR_FAULTS[fault]]
        monkeypatch.setattr(simulator, name, wrap(getattr(simulator, name)))
    return bm.run_cpu(checkout, TINY_CELLS[0])


@pytest.mark.parametrize("fault", ["state_unchanged", *NEAR_FAULTS])
def test_faults_fail_the_comparison(checkout, monkeypatch, fault):
    result, lines = _fault_run(checkout, monkeypatch, fault)
    assert not result["correct"], lines


def test_cell_added_from_files_alone(checkout, tmp_path):
    """A new configuration, traffic mix and per-layer metric are files and
    entries in BENCHMARK.json; no file the benchmark has is edited."""
    root = str(tmp_path / "grown")
    shutil.copytree(checkout, root, ignore=shutil.ignore_patterns("cache"))
    bench = os.path.join(root, "benchmark")
    before = {p: open(os.path.join(dp, p), "rb").read() for dp, _, fs in os.walk(bench)
              for p in fs}
    cfg = json.load(open(os.path.join(bench, "configs", "cloth_grid_1m_tiny.json")))
    cfg["mesh"]["side"] = 16
    json.dump(cfg, open(os.path.join(bench, "configs", "sheet16.json"), "w"))
    traffic = json.load(open(os.path.join(bench, "traffic", "drape.json")))
    traffic.update(gravity=[0.0, 0.0, -4.9], episode_frames=5, checked_frames=2)
    json.dump(traffic, open(os.path.join(bench, "traffic", "soft_drape.json"), "w"))
    shutil.copy(os.path.join(bench, "limits", TINY_CELLS[0] + ".json"),
                os.path.join(bench, "limits", "sheet16.soft_drape.json"))
    with open(os.path.join(bench, "metrics", "frames_checked.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.iters))\n")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "sheet16", "source": "test", "file": "benchmark/configs/sheet16.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "sheet16.soft_drape", "config": "sheet16",
                              "traffic": "soft_drape", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "frames_checked", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "simulator",
                              "moves": "frame_ms", "workloads": ["sheet16.soft_drape"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))

    result, lines = bm.run_cpu(root, "sheet16.soft_drape", trace=True)
    assert result["correct"], lines
    assert result["metrics"]["frames_checked"]["value"] >= 1
    assert any(ln.startswith("problem n=256 ") for ln in lines)
    for p, data in before.items():
        hits = [os.path.join(dp, p) for dp, _, fs in os.walk(bench) if p in fs]
        assert any(open(h, "rb").read() == data for h in hits), p


_MODULES = """
import json, sys, time, torch
sys.path.insert(0, {root!r}); sys.path.insert(1, {repo!r})
torch.set_num_threads(2)
from benchmark import {what}
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_modules(root, what, body=""):
    code = _MODULES.format(root=root, repo=bm.REPO, what=what, body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(checkout):
    body = (f"r, _ = harness.run({checkout!r}, {TINY_CELLS[-1]!r}, 5, 0.5, False, "
            "torch.device('cpu'), time.perf_counter())\nassert r['correct']")
    found = _top_level_modules(checkout, "harness", body)
    assert "precond_tpu_torch" in found
    assert not found & FORBIDDEN


@pytest.mark.parametrize("module", ["reference", "contact"])
def test_reference_imports_nothing_of_the_program(checkout, module):
    found = _top_level_modules(checkout, module)
    assert not found & (FORBIDDEN | {"precond_tpu_torch"})
