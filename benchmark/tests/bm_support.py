"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout whose BENCHMARK.json holds tiny test-only cells, and a
run of a cell there on the CPU through the harness (the command-line entry
refuses to run without a card)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_SIDE = 32
# a tiny fold folds this share of the columns, in episodes of this many
# frames (detection dominates a tiny frame on the CPU) with PCG capped
# at this many iterations (a sound frame takes ~40, a control's may not end)
TINY_FOLD = 0.25
TINY_FOLD_FRAMES = 6
TINY_FOLD_ITERS = 400
# the tiny fold cell's limits (the card's cell sets its own from calibrate.py)
FOLD_LIMITS = {"apply_gap": 0.002, "residual": 0.002, "update_mismatch": 0, "unconverged": 0,
               "contact_apply_gap": 0.002, "contact_residual": 0.002, "contact_count_gap": 0,
               "detect_overflow": 0}


def closest_point_ee_weights(build_stencils):
    """The program's stencil builder with its edge-edge weights put right:
    it gives (s, 1 - s, -t, -(1 - t)) for the closest points a0 + s (a1 - a0)
    and b0 + t (b1 - b0), whose barycentrics are (1 - s, s, -(1 - t), -t).
    A fold run on the program as it stands reads `correct` false for that
    alone (test_bm_contact.py), so the tests that need a sound program
    run with this one in its place."""
    import torch

    def fixed(edges, faces, ef=None, ee=None, vf=None):
        st = build_stencils(edges, faces, ef=ef, ee=ee, vf=vf)
        is_ee = (st.nverts == 4) & (st.nfirst == 2)
        return st._replace(weight=torch.where(is_ee[:, None], st.weight[:, [1, 0, 3, 2, 4]],
                                              st.weight))
    return fixed


def tiny_checkout(dst: str, side: int = TINY_SIDE) -> str:
    """Copy benchmark/ into `dst` with a BENCHMARK.json whose cells are the
    real ones on side x side sheets (`<config>_tiny`). A traffic mix with a
    fold folds a quarter of the columns there (8 at 32), its contact budget
    grown by as much as the folded share, in 6-frame episodes. Returns
    `dst`."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    os.makedirs(os.path.join(dst, "benchmark", "cache"), exist_ok=True)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    rename = {c["name"]: c["name"] + "_tiny" for c in spec["configs"]}
    sides = {}
    bench = os.path.join(dst, "benchmark")
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        if cfg["mesh"]["kind"] == "grid":
            sides[c["name"]] = cfg["mesh"]["side"]
        cfg["mesh"]["side"] = side
        cfg["vertices"] = side * side
        c["name"] = rename[c["name"]]
        c["file"] = f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(dst, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        with open(path) as f:
            traffic = json.load(f)
        if "fold" not in traffic:
            continue
        big = max(sides.values())   # folds are of grid sheets
        grow = TINY_FOLD / (traffic["fold"]["columns"] / big)
        traffic["fold"]["columns"] = int(TINY_FOLD * side)
        traffic["contact"]["budget_per_vertex"] *= grow
        traffic["episode_frames"] = TINY_FOLD_FRAMES
        traffic["max_iters"] = TINY_FOLD_ITERS
        with open(path, "w") as f:
            json.dump(traffic, f)
    for w in spec["workloads"]:
        old = w["name"]
        w["config"] = rename[w["config"]]
        w["name"] = f"{w['config']}.{w['traffic']}"
        shutil.copy(os.path.join(bench, "limits", old + ".json"),
                    os.path.join(bench, "limits", w["name"] + ".json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"{rename[x.split('.')[0]]}.{x.split('.', 1)[1]}"
                              for x in m["workloads"]]
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return dst


def add_cell(root: str, config: str, traffic: str, limits: dict, **changes) -> str:
    """Add the cell `<config>.<traffic>` to the checkout `root` with
    `limits`; with `changes`, its traffic is a copy of `traffic` with those
    keys of its `contact` block changed. Returns the cell's name."""
    bench = os.path.join(root, "benchmark")
    if changes:
        with open(os.path.join(bench, "traffic", traffic + ".json")) as f:
            mix = json.load(f)
        mix["contact"].update(changes)
        traffic += "_" + "_".join(f"{k}{v}" for k, v in changes.items())
        with open(os.path.join(bench, "traffic", traffic + ".json"), "w") as f:
            json.dump(mix, f)
    name = f"{config}.{traffic}"
    with open(os.path.join(bench, "limits", name + ".json"), "w") as f:
        json.dump(limits, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                              "why": "a test cell"})
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)
    return name


def run_cpu(root: str, workload: str, seed: int = 123456789012, seconds: float = 1.0,
            trace: bool = False, **overrides):
    """harness.run of `workload` in the checkout `root`, on the CPU.
    The checkout's `benchmark` package is imported afresh."""
    import torch

    for name in [m for m in sys.modules if m == "benchmark" or m.startswith("benchmark.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    if REPO not in sys.path:
        sys.path.insert(1, REPO)
    try:
        from benchmark import harness

        return harness.run(root, workload, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), overrides or None)
    finally:
        sys.path.remove(root)
