"""Reduce a torch.profiler Chrome trace of the traced frames to what the
per-layer readers and the result's `breakdown` need.

The grouping of device events by collapsed name is a frozen copy of
``scripts/torch_parse_trace.py``. Two traces: one of the card alone over a
few frames (busy time = the union of its kernels, copies and fills, over
the host wall between two syncs), and one of host and card over another
frame, whose idle gaps inside the ``bm_window`` annotation are labelled
with the innermost host operator running when each began. Profiling the
host's operators slows the host, so the busy share comes from the first.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bm_window"


def _drop_brackets(name: str, left: str, right: str) -> str:
    out, depth = [], 0
    for ch in name:
        if ch == left:
            depth += 1
        elif ch == right and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def collapse(name: str) -> str:
    """`void ns::kern<4, float>(float const*, int).3` -> `ns::kern`."""
    name = re.sub(r"\.\d+$", "", name).replace("(anonymous namespace)::", "")
    name = _drop_brackets(_drop_brackets(name, "<", ">"), "(", ")").strip()
    return re.sub(r"^void\s+", "", name)


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    kernels: dict      # collapsed kernel name -> list of durations (s)
    device_ops: dict   # collapsed name of any device event -> total s
    frames: int


def _union(intervals):
    """(covered length, gaps between the covered runs) of [start, end) pairs."""
    total, end, gaps = 0.0, None, []
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def _spans(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _device(spans) -> list:
    return [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]


def reduce(path: str, window_s: float, frames: int) -> Trace:
    """The device-only trace of `frames` frames that took `window_s` seconds
    of host wall between two syncs."""
    dev = _device(_spans(path))
    busy, _ = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    kernels, ops = defaultdict(list), defaultdict(float)
    for e in dev:
        name = collapse(e.get("name", ""))
        ops[name] += e["dur"] * 1e-6
        if e["cat"] == "kernel":
            kernels[name].append(e["dur"] * 1e-6)
    return Trace(window_s, busy * 1e-6, dict(kernels), dict(ops), frames)


def idle_by_host(path: str) -> dict:
    """Idle seconds of the card inside the WINDOW annotation of a host and
    device trace, by the innermost host operator open when each gap began."""
    spans = _spans(path)
    win = [e for e in spans if e.get("name") == WINDOW and not e.get("cat", "").startswith("gpu")]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW!r} annotation")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in _device(spans)
               if e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    _, gaps = _union(clipped + [(w0, w0), (w1, w1)])
    host = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in spans
                  if e.get("cat") == "cpu_op" and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        label = "host outside any operator"
        i = bisect.bisect_right(starts, g0) - 1
        # the innermost operator open at g0 started last among those open
        for j in range(i, max(i - 200, -1), -1):
            if host[j][1] >= g0:
                label = host[j][2]
                break
        idle[label] += (g1 - g0) * 1e-6
    return dict(idle)


def breakdown(t: Trace, idle: dict, top: int = 10) -> dict:
    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": best(t.device_ops), "idle_gaps": best(idle)}
