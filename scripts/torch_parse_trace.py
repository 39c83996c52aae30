#!/usr/bin/env python3
"""Aggregate a device trace into a top-ops table: the twin of
scripts/parse_xplane.py, for the Chrome trace (trace.json) that
precond_tpu_torch.profiling.device_trace writes through torch.profiler.

Usage: python scripts/torch_parse_trace.py <trace.json> [--reps N] [--top K] [--raw]

Groups the trace's device events (CUDA kernels, copies and fills: the
categories "kernel", "gpu_memcpy" and "gpu_memset") by name and prints
count, total ms, ms per rep and share of the device op time. Names
collapse as the JAX script collapses XLA's (a trailing ".<digits>"), and
also lose their template arguments, argument list and return type, so a
kernel's instantiations group together; --raw keeps the full names.
--reps divides by the number of identical repetitions the traced program
ran, so numbers read as per-instance costs. Beside the total device op
time it prints the wall that the device events span (first start to last
end) and the busy share of that span. A trace without device events (one
taken on the CPU) exits non-zero with a plain message.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_events(events: list) -> list:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES and "dur" in e]


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
    """`void ns::kern<4, float>(float const*, int).3` -> `ns::kern`; an
    anonymous namespace drops out (`(anonymous namespace)::kern` -> `kern`)."""
    name = re.sub(r"\.\d+$", "", name).replace("(anonymous namespace)::", "")
    name = _drop_brackets(_drop_brackets(name, "<", ">"), "(", ")").strip()
    return re.sub(r"^void\s+", "", name)


def summarize(events: list, reps: int = 1, raw: bool = False) -> dict:
    """Totals by (collapsed) name over the device events: {"ops": {name:
    (count, total_ms)}, "total_ms", "span_ms", "events"}. Raises
    SystemExit when there is no device event."""
    dev = device_events(events)
    if not dev:
        raise SystemExit("no device events in the trace (kernels, copies or fills): it was "
                         "taken without a card, or the profiler could not see the card")
    tot, cnt = defaultdict(float), defaultdict(int)
    for e in dev:
        name = e.get("name", "") if raw else collapse(e.get("name", ""))
        tot[name] += e["dur"] / 1e3  # us -> ms
        cnt[name] += 1
    start = min(e["ts"] for e in dev)
    end = max(e["ts"] + e["dur"] for e in dev)
    return {"ops": {k: (cnt[k], tot[k]) for k in tot}, "total_ms": sum(tot.values()),
            "span_ms": (end - start) / 1e3, "events": len(dev), "reps": reps}


def table(summary: dict, top: int = 40) -> list:
    """The printed lines of a summary."""
    grand, reps, span = summary["total_ms"], summary["reps"], summary["span_ms"]
    busy = f"{100 * grand / span:.1f}% busy" if span > 0 else "busy share undefined"
    lines = [f"total device op time: {grand:.3f} ms ({grand / reps:.3f} ms/rep over {reps} reps); "
             f"device events span {span:.3f} ms of wall ({busy})",
             f"{'op':60s} {'count':>7s} {'total ms':>10s} {'ms/rep':>9s} {'%':>6s}"]
    rows = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:top]
    for name, (count, ms) in rows:
        lines.append(f"{name[:60]:60s} {count:7d} {ms:10.3f} {ms / reps:9.4f} "
                     f"{100 * ms / grand:5.1f}%")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--raw", action="store_true", help="no name collapsing")
    args = ap.parse_args(argv)
    for line in table(summarize(load(args.trace), args.reps, args.raw), args.top):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
