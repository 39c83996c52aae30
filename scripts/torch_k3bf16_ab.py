#!/usr/bin/env python3
"""Time the port's K3-bf16 (symv96_bf16) from several checkouts on one CUDA card, in turns.

    python3 scripts/torch_k3bf16_ab.py CHECKOUT_A CHECKOUT_B [--order ABBA] [--b 34952 2185]

Each turn is a fresh process that imports ``precond_tpu_torch`` from its
checkout (so it builds and loads that checkout's kernels), makes a bitwise
symmetric bf16 table [B,96,96] and an f32 rhs [B,96] from one seeded
generator on the card, checks ``batched_symv`` against the plain einsum
(1e-5 * max|z|), and times it with CUDA events: 3 rounds of 50 launches
after 5 warm ones, then ``torch.bmm(out_dtype=float32)`` on the same table
and the rhs rounded beforehand, the same way. It prints one JSON line per
turn and size; the default order A, B, B, A lets drift on the card show as
a difference between the two A turns. B = 34,952 is cloth 1024's table
(0.64 GB, far beyond the 50 MB L2); B = 2,185 general 256's (40 MB, which
back-to-back launches find in L2).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _time(fn, rounds: int = 3, iters: int = 50) -> list:
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def worker(checkout: str, b: int) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from precond_tpu_torch.ops.batched_inverse import apply_block_inverse
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.ops.cuda.symv import batched_symv

    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((b, 96, 96), generator=g, device="cuda")
    inv = (0.5 * (a + a.transpose(1, 2))).to(torch.bfloat16)
    del a
    rhs = torch.randn((b, 96), generator=g, device="cuda")
    z = batched_symv(inv, rhs)
    want = apply_block_inverse(inv, rhs)
    err = float((z - want).abs().max())
    ok = err <= 1e-5 * float(want.abs().max())
    del want
    rb = rhs.to(torch.bfloat16)[:, :, None]
    ms = _time(lambda: batched_symv(inv, rhs))
    try:
        lib_ms = _time(lambda: torch.bmm(inv, rb, out_dtype=torch.float32))
    except (RuntimeError, TypeError):
        lib_ms = None
    log = _lib.build_info.get("log", "")
    at = log.find("symv96_bf16_kernel")
    ptxas = [ln.split(":", 1)[-1].strip() for ln in log[at:].splitlines()[1:4]
             if at >= 0 and ("registers" in ln or "spill" in ln or "smem" in ln)]
    return {"checkout": checkout, "b": b, "ms": ms, "bmm_ms": lib_ms, "max_abs_err": err,
            "ok": ok, "z_sum": float(z.double().sum()), "ptxas": ptxas}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", help="repository checkouts, named A, B, ... in order")
    ap.add_argument("--order", default="ABBA", help="turns, by checkout letter")
    ap.add_argument("--b", type=int, nargs="+", default=[34952, 2185])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        for b in args.b:
            print(json.dumps(worker(args.checkouts[0], b)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    bad = 0
    for letter in args.order:
        checkout = args.checkouts[ord(letter) - ord("A")]
        out = subprocess.run([sys.executable, os.path.abspath(__file__), checkout, "--worker",
                              "--b", *map(str, args.b)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        for line in out.stdout.strip().splitlines():
            print(f"{letter} {line}", flush=True)
            bad += not json.loads(line)["ok"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
