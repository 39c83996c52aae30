"""Reduce a host and device Chrome trace by the program's spans.

The program names the phases of a frame with spans
(``precond_tpu_torch.profiling.span``: ``frame`` and ``frame.*``,
``prepare.*``, ``pcg.*``, ``apply.*``), which torch.profiler records as
``user_annotation`` ranges on the host, on the clock of the kernels. Here
each device event (kernel, copy, fill) is linked to its host launch through
the trace's correlation id and put under the innermost span open on the
launching thread when the launch ran; each span instance gets the union of
its events' intervals (device busy, its descendants' included). Each
device idle gap inside the ``devtrace.WINDOW`` annotation goes to the
innermost span open when the gap began.

    python3 benchmark/spans.py benchmark/cache/traces/<workload>/host.json

prints the per-span table and the quantities below. The trace needs host
and device activity and the program's spans on (``profiling.tracing()``);
a trace without program spans or without device events reduces to None.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from typing import List, NamedTuple, Optional

try:
    from . import devtrace
except ImportError:  # run as a script
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import devtrace

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class Span(NamedTuple):
    name: str
    t0: float     # host clock, us
    t1: float
    tid: object
    parent: int   # index of the enclosing span, -1 at the top


class Spans(NamedTuple):
    spans: List[Span]
    events: List[list]   # per span: (start, end) of the device events launched innermost in it
    idle: List[float]    # per span: us of device idle whose gaps began innermost in it
    window_us: float
    busy_us: float       # union of every device event inside the window
    idle_us: float       # device idle inside the window
    unattributed: list   # (start, end) of device events launched under no span


def _union(intervals) -> float:
    covered, _ = devtrace._union(intervals)
    return covered


def _nest(spans_of_tid: list, spans: list) -> None:
    """Fill the parents of one thread's spans (indices into `spans`)."""
    stack = []
    for i in sorted(spans_of_tid, key=lambda i: (spans[i][1], -spans[i][2])):
        while stack and spans[stack[-1]][2] <= spans[i][1]:
            stack.pop()
        spans[i][4] = stack[-1] if stack else -1
        stack.append(i)


def _locate(spans_of_tid: list, spans: list, times: list) -> list:
    """The innermost span of the thread open at each of `times` (-1: none)."""
    order = sorted(spans_of_tid, key=lambda i: (spans[i][1], -spans[i][2]))
    out = [-1] * len(times)
    stack, j = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(order) and spans[order[j]][1] <= t:
            k = order[j]
            while stack and spans[stack[-1]][2] <= spans[k][1]:
                stack.pop()
            stack.append(k)
            j += 1
        while stack and spans[stack[-1]][2] <= t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def reduce(path: str) -> Optional[Spans]:
    """The spans of a host and device trace, or None without program spans."""
    events = devtrace._spans(path)
    host = [e for e in events if e.get("cat") == "user_annotation"]
    window = [e for e in host if e.get("name") == devtrace.WINDOW]
    raw = [[e["name"], e["ts"], e["ts"] + e["dur"], e.get("tid"), -1] for e in host
           if e.get("name") != devtrace.WINDOW]
    device = devtrace._device(events)
    if not raw or not device:
        return None
    by_tid = defaultdict(list)
    for i, s in enumerate(raw):
        by_tid[s[3]].append(i)
    for idx in by_tid.values():
        _nest(idx, raw)
    main = max(by_tid, key=lambda t: len(by_tid[t]))

    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launches[corr] = (e["ts"], e.get("tid"))
    if window:
        w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    else:
        w0 = min(e["ts"] for e in device)
        w1 = max(e["ts"] + e["dur"] for e in device)

    # each device event under the innermost span open at its launch
    queries = defaultdict(list)
    unattributed = []
    for e in device:
        got = launches.get((e.get("args") or {}).get("correlation"))
        if got is None:
            unattributed.append((e["ts"], e["ts"] + e["dur"]))
            continue
        tid = got[1] if got[1] in by_tid else main
        queries[tid].append((got[0], (e["ts"], e["ts"] + e["dur"])))
    per_span = [[] for _ in raw]
    for tid, qs in queries.items():
        for q, k in zip(qs, _locate(by_tid[tid], raw, [t for t, _ in qs])):
            (per_span[k] if k >= 0 else unattributed).append(q[1])

    # each idle gap inside the window under the innermost span open when it began
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device
               if e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy, gaps = devtrace._union(clipped + [(w0, w0), (w1, w1)])
    idle = [0.0] * len(raw)
    for (g0, g1), k in zip(gaps, _locate(by_tid[main], raw, [g0 for g0, _ in gaps])):
        if k >= 0:
            idle[k] += g1 - g0
    spans = [Span(name, t0, t1, tid, parent) for name, t0, t1, tid, parent in raw]
    return Spans(spans, per_span, idle, w1 - w0, busy, sum(g1 - g0 for g0, g1 in gaps),
                 unattributed)


def children(r: Spans) -> List[list]:
    kids = [[] for _ in r.spans]
    for i, s in enumerate(r.spans):
        if s.parent >= 0:
            kids[s.parent].append(i)
    return kids


def subtree(r: Spans, i: int, skip=(), kids=None) -> list:
    """Span `i` and its descendants, leaving out the subtrees of spans whose
    name is in `skip`."""
    kids = children(r) if kids is None else kids
    out, todo = [], [i]
    while todo:
        j = todo.pop()
        out.append(j)
        todo += [k for k in kids[j] if r.spans[k].name not in skip]
    return out


def busy_us(r: Spans, i: int, skip=(), kids=None) -> float:
    """Device busy of span `i` (the union of its subtree's events)."""
    return _union([iv for j in subtree(r, i, skip, kids) for iv in r.events[j]])


def instances(r: Spans, name: str) -> list:
    return [i for i, s in enumerate(r.spans) if s.name == name]


def mean_busy_us(r: Optional[Spans], name: str) -> Optional[float]:
    """Device busy of the instances of a span, their mean in us."""
    idx = instances(r, name) if r else []
    if not idx:
        return None
    kids = children(r)
    return sum(busy_us(r, i, kids=kids) for i in idx) / len(idx)


def prepare_ms(r: Optional[Spans]) -> Optional[float]:
    """Device busy of a frame's prepare, ms per prepare."""
    us = mean_busy_us(r, "frame.prepare")
    return None if us is None else us / 1e3


def spmv_us(r: Optional[Spans]) -> Optional[float]:
    """Device busy of one SpMV of the PCG, us per call."""
    return mean_busy_us(r, "pcg.spmv")


def apply_us(r: Optional[Spans]) -> Optional[float]:
    """Device busy of one preconditioner call of the PCG, us per call."""
    return mean_busy_us(r, "pcg.precond")


def pcg_iterations(r: Spans, kids=None) -> int:
    """PCG iterations of the traced frames: each solve calls the SpMV once
    before its loop and once an iteration."""
    kids = children(r) if kids is None else kids
    return sum(max(sum(r.spans[k].name == "pcg.spmv" for k in subtree(r, i, kids=kids)) - 1, 0)
               for i in instances(r, "frame.pcg"))


def pcg_vector_us(r: Optional[Spans]) -> Optional[float]:
    """Device busy of the PCG outside its SpMV and preconditioner calls (dots,
    vector updates, the convergence test), us per iteration."""
    idx = instances(r, "frame.pcg") if r else []
    if not idx:
        return None
    kids = children(r)
    its = pcg_iterations(r, kids)
    if not its:
        return None
    skip = ("pcg.spmv", "pcg.precond")
    return sum(busy_us(r, i, skip, kids) for i in idx) / its


def pcg_idle_share_pct(r: Optional[Spans]) -> Optional[float]:
    """Share of the window's device idle whose gaps began inside the PCG."""
    idx = instances(r, "frame.pcg") if r else []
    if not idx or r.idle_us <= 0:
        return None
    kids = children(r)
    inside = sum(r.idle[j] for i in idx for j in subtree(r, i, kids=kids))
    return 100.0 * inside / r.idle_us


def coverage(r: Spans) -> dict:
    """How far the children of each `frame` account for its device busy:
    `share`, the union of the children's events over the frame's busy, and
    `sum_ratio`, the children's busy summed over their instances over it."""
    kids = children(r)
    frame, share, total = 0.0, 0.0, 0.0
    for i in instances(r, "frame"):
        frame += busy_us(r, i, kids=kids)
        share += _union([iv for c in kids[i] for j in subtree(r, c, kids=kids)
                         for iv in r.events[j]])
        total += sum(busy_us(r, c, kids=kids) for c in kids[i])
    return {"frame_busy_us": frame, "share": share / frame if frame else None,
            "sum_ratio": total / frame if frame else None}


def table(r: Spans) -> dict:
    """name -> [instances, device busy us (summed), idle us begun innermost in it]."""
    kids = children(r)
    out = {}
    for i, s in enumerate(r.spans):
        row = out.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += busy_us(r, i, kids=kids)
        row[2] += r.idle[i]
    return out


QUANTITIES = {"prepare_ms": prepare_ms, "spmv_us": spmv_us, "apply_us": apply_us,
              "pcg_vector_us": pcg_vector_us, "pcg_idle_share_pct": pcg_idle_share_pct}


def summary(r: Optional[Spans]) -> Optional[dict]:
    if r is None:
        return None
    out = {k: f(r) for k, f in QUANTITIES.items()}
    out.update(pcg_iterations=pcg_iterations(r), window_us=r.window_us, busy_us=r.busy_us,
               idle_us=r.idle_us, unattributed_us=_union(r.unattributed), coverage=coverage(r),
               spans=table(r))
    return out


if __name__ == "__main__":
    print(json.dumps(summary(reduce(sys.argv[1])), indent=1))
