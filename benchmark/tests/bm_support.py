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


def tiny_checkout(dst: str, side: int = TINY_SIDE) -> str:
    """Copy benchmark/ into `dst` with a BENCHMARK.json whose cells are the
    real ones on side x side sheets (`<config>_tiny`). Returns `dst`."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    os.makedirs(os.path.join(dst, "benchmark", "cache"), exist_ok=True)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    rename = {c["name"]: c["name"] + "_tiny" for c in spec["configs"]}
    bench = os.path.join(dst, "benchmark")
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg["mesh"]["side"] = side
        cfg["vertices"] = side * side
        c["name"] = rename[c["name"]]
        c["file"] = f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(dst, c["file"]), "w") as f:
            json.dump(cfg, f)
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
