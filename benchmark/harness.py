"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: BENCHMARK.json names the cell, its configuration's
file, its traffic mix (traffic/<name>.json, read by scene.py) and its
metrics (metrics/<name>.py, each a `read(ctx)` that returns a number or
None); the configuration names its kind of mesh (meshes/<kind>.py) and
limits/<workload>.json holds the limits of the comparison.

The window replays an episode of frames from the seeded state through the
program's ClothSim.step(): before each replay the state and the
preconditioner's frame counter are reset, so the mix of frames (re-sort
frames included) does not depend on the program's speed.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, devtrace, reference, roofline, scene as scene_mod, spans as spans_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "precond_tpu")


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> SimpleNamespace:
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = os.path.join(root, "benchmark")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return SimpleNamespace(
        chips=int(w["chips"]),
        config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(bench, "limits", workload + ".json")),
        end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]),
    )


def build_mesh(root: str, config: dict) -> dict:
    """The configuration's mesh arrays, from benchmark/cache/ when a run in
    this checkout built them before (keyed by the kind and its numbers)."""
    p = config["mesh"]
    key = hashlib.sha256(json.dumps(p, sort_keys=True).encode()).hexdigest()[:16]
    cache = os.path.join(root, "benchmark", "cache")
    path = os.path.join(cache, f"mesh-{p['kind']}-{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        maker = _load_file(os.path.join(root, "benchmark", "meshes", p["kind"] + ".py"),
                           f"benchmark.meshes.{p['kind']}")
        arrays = maker.build(p)
        os.makedirs(cache, exist_ok=True)
        part = path + ".part.npz"
        np.savez(part, **arrays)
        os.replace(part, path)
    return dict(arrays, mass=float(config["mass"]), dt=float(config["dt"]))


def make_sim(mesh: dict, config: dict, scene, device, **schwarz_overrides):
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models.cloth import ClothMesh
    from precond_tpu_torch.models.simulator import ClothSim

    grid = tuple(int(g) for g in mesh["grid"]) or None
    cm = ClothMesh(positions=scene.rest, edges=mesh["edges"], faces=mesh["faces"],
                   springs=mesh["springs"], stiffness=mesh["stiffness"], mass=mesh["mass"],
                   dt=mesh["dt"], grid=grid)
    contact = {}
    c = scene.contact
    if c is not None:
        contact = dict(collision_stiffness=c.stiffness, collision_threshold=c.threshold,
                       collision_budget=c.budget, collision_cell_cap=c.cell_cap,
                       collision_rest_gap=c.rest_gap)
        schwarz_overrides = {"max_collision_per_vert": c.per_primitive_cap, **schwarz_overrides}
    cfg = SchwarzConfig(**{**config["schwarz"], **schwarz_overrides})
    return ClothSim(cm, cfg, gravity=scene.gravity, pinned=scene.pinned, tol=scene.tol,
                    max_iters=scene.max_iters, device=device, **contact)


class Tap:
    """Wraps the simulator module's PCG entry and its stencil builder. While
    armed it keeps the residual the first preconditioner call gets and that
    call's answer, and the live stencils of each contact set (EF, EE, VF)
    as counts on the device; otherwise it passes each call straight
    through."""

    def __init__(self):
        from precond_tpu_torch.models import simulator

        self.module, self.real, self.real_build = simulator, simulator.pcg, simulator.build_stencils
        self.armed, self.got, self.live = False, None, None
        simulator.pcg, simulator.build_stencils = self.pcg, self.build_stencils

    def build_stencils(self, edges, faces, ef=None, ee=None, vf=None):
        st = self.real_build(edges, faces, ef=ef, ee=ee, vf=vf)
        if self.armed:
            sizes = [0 if s is None else s.stiff.shape[0] for s in (ef, ee, vf)]
            self.live = torch.stack([p.sum() for p in torch.split(st.valid, sizes)])
        return st

    def pcg(self, spmv, precond, b, *args, **kw):
        if not self.armed:
            return self.real(spmv, precond, b, *args, **kw)
        first = []

        def tapped(r):
            z = precond(r)
            if not first:
                first.append((r.clone(), z.clone()))
            return z

        res = self.real(spmv, tapped, b, *args, **kw)
        self.got = first[0]
        return res

    def close(self):
        self.module.pcg, self.module.build_stencils = self.real, self.real_build


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def episode_runner(sim, scene, device):
    """-> reset(), which puts the sim at the start of an episode."""
    from precond_tpu_torch.models.simulator import SimState

    x0 = torch.as_tensor(scene.x0, device=device)
    v0 = torch.as_tensor(scene.v0, device=device)

    def reset():
        sim.state = SimState(positions=x0, velocities=v0, step_count=0)
        sim.pre.frame_index = 0

    return reset


class _Stretch:
    """torch.profiler over consecutive frames of the first episode, with a
    device sync at each end. host=False traces the card alone (kernels,
    copies, fills), so the host runs at its own pace; host=True adds the
    host's operators, which the idle-gap labels need, inside the
    devtrace.WINDOW annotation, and turns the program's spans on
    (profiling.tracing()), which spans.py reduces."""

    def __init__(self, frames, path, host, device):
        self.frames, self.path, self.host, self.device = frames, path, host, device
        self.count, self.wall_s = 0, None

    def before(self, episode, f):
        if episode or f != self.frames[0]:
            return
        _sync(self.device)
        acts = [torch.profiler.ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        if self.host or not acts:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.spans = None
        if self.host:
            from precond_tpu_torch import profiling

            self.spans = profiling.tracing()
            self.spans.__enter__()
        self.rf = torch.profiler.record_function(devtrace.WINDOW)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def after(self, episode, f):
        if episode or f not in self.frames:
            return
        self.count += 1
        if f == self.frames[-1]:
            _sync(self.device)
            self.wall_s = time.perf_counter() - self.t0
            self.rf.__exit__(None, None, None)
            if self.spans is not None:
                self.spans.__exit__(None, None, None)
            self.prof.stop()
            self.prof.export_chrome_trace(self.path)
            self.prof = self.rf = None


def window(sim, scene, device, seconds: float, trace_dir=None, t_setup0=None):
    """Warm up, then replay episodes for `seconds`. Returns a namespace with
    the per-frame walls, iterations, failures, the checked frames and, with
    `trace_dir`, the traced stretches. A frame fails where its PCG ended
    above tol or its state is not finite (`unconverged_flags`), or where
    its contact detection found a grid cell over its cap or dropped hits
    over its budget (`overflow_flags`); the flags of all frames are read
    once, after the last."""
    tap = Tap()
    reset = episode_runner(sim, scene, device)
    try:
        reset()
        t_warm = time.perf_counter()
        for _ in range(scene.warm_frames):
            sim.step()
        reset()
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        out = SimpleNamespace(walls=[], iters=[], frames={}, peak_bytes=None)
        t0 = time.perf_counter()
        out.warm_s = t0 - t_warm
        out.setup_s = None if t_setup0 is None else t0 - t_setup0
        deadline = t0 + seconds
        rels, finite, overflow, tol = [], [], [], scene.tol
        episode, f, prev, closed = 0, 0, None, False
        stretches = []
        if trace_dir is not None:
            stretches = [_Stretch(scene.traced, os.path.join(trace_dir, "device.json"), False, device),
                         _Stretch(scene.labelled, os.path.join(trace_dir, "host.json"), True, device)]
        out.stretches = stretches
        # the first episode runs on past the window's close until every
        # frame that is checked or traced has run
        last_needed = max(scene.checked + sum((st.frames for st in stretches), ()))
        t_prev = t0
        while True:
            if f == scene.episode_frames:
                episode, f, prev = episode + 1, 0, None
                reset()
            if not closed and time.perf_counter() >= deadline:
                _sync(device)
                out.window_s = time.perf_counter() - t0
                if device.type == "cuda":
                    out.peak_bytes = torch.cuda.max_memory_allocated(device)
                closed = True
            pending = episode == 0 and f <= last_needed
            if closed and not pending:
                break
            for st in stretches:
                st.before(episode, f)
            checked = episode == 0 and f in scene.checked
            x_in = sim.state.positions
            tap.armed, tap.got, tap.live = checked, None, None
            sim.step()
            tap.armed = False
            if not closed:
                t = time.perf_counter()
                out.walls.append(t - t_prev)
                out.iters.append(sim.last_solve.iterations)
                t_prev = t
            rels.append(sim.last_solve.rel_residual.reshape(()))
            finite.append(torch.isfinite(sim.state.positions).all())
            info = sim.last_detect_info
            if info is not None:
                overflow.append(info.truncated | (info.dropped > 0))
            if checked:
                if tap.got is None:
                    raise RuntimeError("the checked frame did not reach the simulator's pcg: "
                                       "the benchmark cannot observe its preconditioner")
                r0, z0 = tap.got
                out.frames[f] = check.Frame(x_prev=prev, x_in=x_in, x_out=sim.state.positions,
                                            r0=r0, z0=z0, x=sim.last_solve.x, live=tap.live)
            for st in stretches:
                st.after(episode, f)
            prev = x_in
            f += 1
        bad = (torch.stack(rels) > tol) | ~torch.stack(finite)
        out.unconverged_flags = bad.cpu().tolist()
        out.overflow_flags = (torch.stack(overflow).cpu().tolist() if overflow
                              else [False] * len(rels))
        out.failed_flags = [a or b for a, b in zip(out.unconverged_flags, out.overflow_flags)]
        return out
    finally:
        tap.close()


def _quantile(values, q):
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1] if len(values) > 1 \
        else values[0]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
        t_setup0: float, schwarz_overrides=None):
    """-> (result dict, stderr lines). `device` is a torch.device; on the
    CPU only counts are reported, never a time, a rate or a memory size."""
    t_in = time.perf_counter()
    cell = load_cell(root, workload)
    mesh = build_mesh(root, cell.config)
    scene = scene_mod.make(cell.traffic, mesh, seed)
    t_sim = time.perf_counter()
    sim = make_sim(mesh, cell.config, scene, device, **(schwarz_overrides or {}))
    t_built = time.perf_counter()
    trace_dir = None
    if trace:
        trace_dir = os.path.join(root, "benchmark", "cache", "traces", workload)
        os.makedirs(trace_dir, exist_ok=True)
    w = window(sim, scene, device, seconds, trace_dir, t_setup0)
    attempted = len(w.walls)
    failed = sum(w.failed_flags[:attempted])

    del sim
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, hier, notes = check.judge(w.frames, mesh, scene, cell.config,
                                       sum(w.unconverged_flags), device, sum(w.overflow_flags))
    correct = check.verdict(numbers, cell.limits)

    n = len(mesh["positions"])
    blocks = sum(math.ceil(s / reference.BANK) for s in hier.sizes)
    planes = 0
    if len(mesh["grid"]):
        ny = int(mesh["grid"][1])
        s = np.asarray(mesh["springs"], np.int64)
        di, dj = s[:, 1] // ny - s[:, 0] // ny, s[:, 1] % ny - s[:, 0] % ny
        flip = np.where((di < 0) | ((di == 0) & (dj < 0)), -1, 1)
        # one plane each way per distinct spring direction
        planes = 2 * len(np.unique(flip * di * (2 * ny + 1) + flip * dj))
    problem = dict(n=n, blocks=blocks, planes=planes, level_sizes=list(hier.sizes),
                   nnz_spmv=roofline.nnz_spmv(n, 2 * len(mesh["springs"])),
                   nnz_apply=roofline.nnz_apply(blocks))

    on_card = device.type == "cuda"
    metrics = {}
    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                     "count": cell.chips if on_card else 0,
                     "memory_peak_bytes": w.peak_bytes if on_card else 0}
    breakdown = None
    if not trace:
        values = {
            "frame_ms": 1e3 * w.window_s / attempted,
            "frame_ms_p90": 1e3 * _quantile(w.walls, 90),
            "peak_mem_gb": (w.peak_bytes or 0) / 1e9,
            "setup_s": w.setup_s,
        }
        if on_card:
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        dev_st, host_st = w.stretches
        tr = devtrace.reduce(dev_st.path, dev_st.wall_s, dev_st.count) if on_card else None
        spans = spans_mod.reduce(host_st.path) if on_card else None
        ctx = SimpleNamespace(iters=w.iters, trace=tr, spans=spans, problem=problem,
                              roofline=roofline)
        for m in cell.per_layer:
            if not on_card and m["source"] != "program_counter":
                continue
            reader = _load_file(os.path.join(root, "benchmark", "metrics", m["name"] + ".py"),
                                f"benchmark.metrics.{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            result_device.update(busy_s=tr.busy_s, window_s=tr.window_s)
            breakdown = devtrace.breakdown(tr, devtrace.idle_by_host(host_st.path))
    if on_card:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True)
        result_device["power_limit"] = q.stdout.strip().splitlines()[0] if q.returncode == 0 \
            and q.stdout.strip() else "unknown"

    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    lines = [f"setup imports_s={t_in - t_setup0} mesh_and_scene_s={t_sim - t_in} "
             f"sim_init_s={t_built - t_sim} warm_frames_s={w.warm_s}",
             f"problem n={n} levels={problem['level_sizes']} blocks={blocks} planes={planes} "
             f"nnz_spmv={problem['nnz_spmv']} nnz_apply={problem['nnz_apply']} "
             f"frames={attempted} checked={sorted(w.frames)} iters_mean="
             f"{statistics.fmean(w.iters) if w.iters else float('nan')}"]
    lines += notes
    lines += [f"check {k} {v} limit {cell.limits[k]}" for k, v in numbers.items()]
    return result, lines
