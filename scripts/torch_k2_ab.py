#!/usr/bin/env python3
"""Time the port's K2 (packed_symv_t) from several checkouts on one CUDA card, in turns.

    python3 scripts/torch_k2_ab.py CHECKOUT_A CHECKOUT_B [--order ABBA] [--bp 35072]

Each turn is a fresh process that imports ``precond_tpu_torch`` from its
checkout (so it builds and loads that checkout's kernels), fills a packed
table F f32[48,96,Bp], dg and x from one seeded generator on the card, and
times ``packed_symv_t`` with CUDA events: 3 rounds of 50 launches after 5
warm ones. It prints one JSON line per turn; the default order
A, B, B, A lets drift on the card show as a difference between the two A
turns. Bp defaults to the table of general 1024 and cloth 1024. F is 0.65
GB, far beyond the 50 MB L2, so every launch reads it from device memory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def worker(checkout: str, bp: int) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse, packed_symv_t

    g = torch.Generator(device="cuda").manual_seed(0)
    f = torch.randn((48, 96, bp), generator=g, device="cuda")
    dg = torch.randn((96, bp), generator=g, device="cuda")
    x = torch.randn((96, bp), generator=g, device="cuda")
    packed = PackedInverse(f=f, dg=dg, nb=bp)
    for _ in range(5):
        z = packed_symv_t(packed, x)
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            packed_symv_t(packed, x)
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / 50)
    nbytes = (48 * 96 + 3 * 96) * 4 * bp
    return {"checkout": checkout, "bp": bp, "ms": rounds,
            "tb_per_s": [nbytes / (m * 1e-3) / 1e12 for m in rounds],
            "bound_ms": nbytes / 3.35e12 * 1e3,
            "z_sum": float(z.double().sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", help="repository checkouts, named A, B, ... in order")
    ap.add_argument("--order", default="ABBA", help="turns, by checkout letter")
    ap.add_argument("--bp", type=int, default=35072)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.checkouts[0], args.bp)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    for letter in args.order:
        checkout = args.checkouts[ord(letter) - ord("A")]
        out = subprocess.run([sys.executable, os.path.abspath(__file__), checkout, "--worker",
                              "--bp", str(args.bp)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(f"{letter} {out.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
