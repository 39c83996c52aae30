"""Shared helpers of the port's dissection scripts: the twins of the JAX
package's measurement suite (scripts/torch_profile_*.py,
torch_micro_bench.py, torch_time_prepare.py, torch_parse_trace.py).

The JAX scripts chain K applications of an op through a data dependency
inside one jit / fori_loop, so that one dispatch covers the chain, and take
the minimum of 3 reps after one warm call. The twins chain the same ops
eagerly (`chain`): no host sync inside the chain (no `.item()`, no
`float()`; scalars such as PCG's rz stay 0-d device tensors), and
`torch.cuda.synchronize()` only at its end. Beside each time they print the
device busy share of the chain: the device time per call of it that
torch.profiler records (kernels, copies and fills, device activity only,
over enough calls to fill 20 ms), over the chain's best wall without the
profiler, so a share can read a little above 100% where the two differ.
On the card the share separates device work from launch pacing; a
fori_loop has no such split. On the CPU nothing runs on a device and the
share reads "not measured".

Each script takes --device (the card unless --device cpu, through
precond_tpu_torch.device.resolve_device, which raises without a card; there
is no fallback) and prints its header, then the card's name and power limit
as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from typing import Callable, Optional

import torch

#: the mesh recipe every JAX script of the suite builds (cloth.make_grid kwargs)
MESH_KW = dict(z_wave=0.02, mass=0.001, dt=1.0 / 60.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def env_int(name: str, default: int) -> int:
    """An integer knob from the environment, with the JAX script's default."""
    return int(os.environ.get(name, str(default)))


def parse_args(description: str, argv=None,
               add: Optional[Callable[[argparse.ArgumentParser], None]] = None) -> tuple:
    """(device, namespace): --device from the command line (the card unless
    --device cpu), and the arguments that `add(parser)` declares."""
    from precond_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    if add is not None:
        add(ap)
    ns = ap.parse_args(argv)
    return resolve_device(ns.device), ns


def parse_device(description: str, argv=None) -> torch.device:
    """--device from the command line: the card unless --device cpu."""
    return parse_args(description, argv)[0]


def card_line(dev: torch.device) -> str:
    """The card's name and power limit from nvidia-smi, or a note that the
    run is on the CPU (whose times are not a device's)."""
    if dev.type != "cuda":
        return f"device: {dev} (no card: times are the host's, busy shares not measured)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def header(line: str, dev: torch.device, log: Callable[[str], None] = log) -> None:
    """The JAX script's header line, then the card line."""
    log(line)
    log(card_line(dev))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def first_value(obj) -> torch.Tensor:
    """The first element of the first tensor in `obj` (a tensor or a (named)
    tuple of them): what a JAX script's `sync` reads to end its clock."""
    while not isinstance(obj, torch.Tensor):
        obj = obj[0]
    return obj.reshape(-1)[:1]


def chain(op: Callable, k: int) -> Callable:
    """x -> op(x, *rest), k times, eagerly: the twin of `fori_loop(0, k,
    lambda _, x: op(x, *rest), x)`. Nothing in it waits for the device."""

    def run(x, *rest):
        for _ in range(k):
            x = op(x, *rest)
        return x

    return run


def best_wall(fn: Callable[[], object], dev: torch.device, reps: int = 3) -> tuple:
    """(first, best): the wall of one warm call and the least wall of `reps`
    more, each ending in a device sync (seconds). Also returns the last
    result."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def device_profile(fn: Callable[[], object], reps: int = 1, top: int = 8) -> Optional[dict]:
    """torch.profiler's CUDA activity over `reps` warm calls of `fn`:
    wall_ms and busy_ms per call, device activities per call and the top
    activities by device time; None when the trace holds no device activity
    (on the CPU, or where the profiler cannot see the card). Only device
    activity is recorded: CPU ops' events would cost the trace's processing
    most of its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    tops = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    return dict(wall_ms=wall_ms / reps, busy_ms=busy_ms / reps,
                activities=sum(e.count for e in dev) // reps,
                top=[(e.self_device_time_total / 1e3 / reps, e.count // reps, e.key) for e in tops])


def profile_phase(label: str, fn: Callable[[], object], reps: int, top: int = 8,
                  log: Callable[[str], None] = log) -> Optional[dict]:
    """Device busy share and the top device activities of `reps` calls of
    `fn`, from torch.profiler's CUDA trace, after one warm-up call; prints
    "[profile <label>]" lines and returns device_profile's dict."""
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof = device_profile(fn, reps, top)
    if prof is None:
        log(f"[profile {label}] device time not measured (the trace holds no device activity)")
        return None
    log(f"[profile {label}] wall {prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), {prof['activities']} device activities")
    for ms, count, key in prof["top"]:
        log(f"[profile {label}]   {ms:9.3f} ms x{count:<5d} {key[:90]}")
    return prof


class Timing(dict):
    """One measured line: first_s, best_s (per call of the chain), busy_ms
    (device time per call of the chain, or None), busy (its share of
    best_s, or None) and out (the chain's last result)."""

    def note(self) -> str:
        if self["busy"] is None:
            return "   busy not measured"
        return f"   busy {100 * self['busy']:5.1f}%"


#: the least wall of a profiled window: short chains are profiled over
#: several calls (at most PROFILE_MAX_CALLS), so that the busy share of a
#: chain of a few launches is not one launch's
PROFILE_MIN_S = 0.02
PROFILE_MAX_CALLS = 50


def measure(fn: Callable[[], object], dev: torch.device, reps: int = 3) -> Timing:
    """One warm call, the least wall of `reps` calls, and the device busy
    share of more calls under torch.profiler (on the card only): as many as
    fill PROFILE_MIN_S of wall, per call."""
    first, best, out = best_wall(fn, dev, reps)
    calls = max(1, min(PROFILE_MAX_CALLS, int(PROFILE_MIN_S / max(best, 1e-9)) + 1))
    prof = device_profile(fn, calls) if dev.type == "cuda" else None
    busy_ms = prof["busy_ms"] if prof else None
    return Timing(first_s=first, best_s=best, out=out, busy_ms=busy_ms,
                  busy=None if busy_ms is None else busy_ms / (best * 1e3))
