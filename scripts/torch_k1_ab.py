#!/usr/bin/env python3
"""Time the port's K1 (spd_inverse) from several checkouts on one CUDA card, in turns.

    python3 scripts/torch_k1_ab.py CHECKOUT_A CHECKOUT_B [--order ABBA] [--sizes 34952,2185]

Each turn is a fresh process that imports ``precond_tpu_torch`` from its
checkout (so it builds and loads that checkout's kernels), makes a batch
of SPD blocks q q^T / 96 + I from one seeded generator on the card for
each size, and times ``spd_inverse`` with CUDA events, with ``repair``
off and on: 3 rounds of 10 launches after 2 warm ones. It prints one JSON
line per turn; the default order A, B, B, A lets drift on the card show as
a difference between the two A turns. The sizes default to the cloth 1024
and general 1024 block count (34,952) and the 256 paths' (2,185). At
34,952 the input and the output are 1.29 GB each, far beyond the 50 MB L2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def worker(checkout: str, sizes) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse

    rows = []
    for b in sizes:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((b, 96, 96), generator=g, device="cuda")
        h = torch.baddbmm(torch.eye(96, device="cuda").expand(b, 96, 96), q, q.transpose(1, 2),
                          alpha=1.0 / 96)
        del q
        for repair in (False, True):
            for _ in range(2):
                out = spd_inverse(h, repair=repair)
            torch.cuda.synchronize()
            rounds = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    spd_inverse(h, repair=repair)
                end.record()
                end.synchronize()
                rounds.append(start.elapsed_time(end) / 10)
            nbytes = 2 * b * 96 * 96 * 4
            rows.append({"b": b, "repair": repair, "ms": rounds,
                         "bound_ms": nbytes / 3.35e12 * 1e3,
                         "out_sum": float(out.double().sum())})
        del h, out
        torch.cuda.empty_cache()
    return {"checkout": checkout, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", help="repository checkouts, named A, B, ... in order")
    ap.add_argument("--order", default="ABBA", help="turns, by checkout letter")
    ap.add_argument("--sizes", default="34952,2185", help="block counts, comma-separated")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sizes = [int(v) for v in args.sizes.split(",")]
    if args.worker:
        print(json.dumps(worker(args.checkouts[0], sizes)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    turns = []
    for letter in args.order:
        checkout = args.checkouts[ord(letter) - ord("A")]
        out = subprocess.run([sys.executable, os.path.abspath(__file__), checkout, "--worker",
                              "--sizes", args.sizes], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(f"{letter} {out.stdout.strip()}", flush=True)
        turns.append((letter, {(r["b"], r["repair"]): r["ms"] for r in json.loads(out.stdout)["rows"]}))
    summarize(turns, args.order)
    return 0


def summarize(turns, order: str) -> None:
    """Per size and repair flag: each checkout's median and range over all
    its rounds, and, over consecutive pairs of turns (1-2, 3-4, ...) that
    hold A and B, how often B's mean was the lower."""
    import statistics

    for key in turns[0][1]:
        line = {"b": key[0], "repair": key[1]}
        for letter in sorted(set(order)):
            ms = [m for lt, rows in turns if lt == letter for m in rows[key]]
            line[letter] = {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms)}
        pairs = [(turns[i], turns[i + 1]) for i in range(0, len(turns) - 1, 2)
                 if {turns[i][0], turns[i + 1][0]} == {"A", "B"}]
        wins = sum(statistics.mean(dict(p)["B"][key]) < statistics.mean(dict(p)["A"][key])
                   for p in pairs)
        line["pairs"], line["b_wins"] = len(pairs), wins
        print(f"[summary] {json.dumps(line)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
