#!/usr/bin/env python3
"""Time ablations of the port's K1 kernel (csrc/spd_inverse.cu) side by side on one CUDA card.

    python3 scripts/torch_k1_variants.py [VARIANT ...]

Each variant is a copy of the kernel source with one named edit, built by
its own ``nvcc`` (all started together) into its own library under
``build/k1_variants/`` and called through the same C entry as the port's
wrapper. Variants that cut work out (``no_factor``, ``no_products``,
``no_output``) compute wrong inverses on purpose: they split the kernel's
time between its phases. Inputs, made on the card:
B = 34,952 random SPD blocks (q q^T / 96 + I from seed 0), the cloth 1024
grid path's assembled blocks (the main path's K1 input, 81% exact zeros),
a batch of identity blocks, and B = 5 (five blocks, one per SM: the
latency of one matrix). Times are CUDA events over 10 launches after 2 warm ones
(3 rounds at B = 34,952), with repair on as the main path calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "build", "k1_variants")
SOURCE = os.path.join(HERE, "precond_tpu_torch", "csrc", "spd_inverse.cu")

FACTOR_LOOP = "for (int j = 0; j < P; ++j) {\n    const float rinv"
PRODUCT_LOOP = "for (int k = 0; k < P; ++k) {\n    const float4 xv"
RINV = "const float rinv = 1.0f / __shfl_sync(0xffffffffu, r[j], j);"
EMITS = ("if (slot == 0) {\n    emit(dst, acc, 0, 0", "} else {\n    emit(dst, acc, 0, 1")
NEVER = "blockIdx.x > (1u << 30)"   # a launch never has this many blocks

VARIANTS = {
    "kernel": [],
    "no_factor": [(FACTOR_LOOP, FACTOR_LOOP.replace("j < P", "j < 0"))],
    "no_products": [(PRODUCT_LOOP, PRODUCT_LOOP.replace("k < P", "k < 0"))],
    "no_output": [(EMITS[0], EMITS[0].replace("(slot == 0)", f"(slot == 0 && {NEVER})")),
                  (EMITS[1], EMITS[1].replace("} else {", f"}} else if ({NEVER}) {{"))],
    "unroll1": [("#pragma unroll 2\n  for (int k = 0;", "#pragma unroll 1\n  for (int k = 0;")],
    "unroll4": [("#pragma unroll 2\n  for (int k = 0;", "#pragma unroll 4\n  for (int k = 0;")],
    "four_blocks": [("__launch_bounds__(THREADS, 5)", "__launch_bounds__(THREADS, 4)")],
    # the multiplier by IEEE division, as the plain PyTorch version computes it
    "division": [(RINV, "const float piv = __shfl_sync(0xffffffffu, r[j], j);"),
                 ("r[j], i) * rinv;", "r[j], i) / piv;")],
}


def build(names) -> dict:
    sys.path.insert(0, HERE)
    from precond_tpu_torch.ops.cuda import _lib

    with open(SOURCE) as f:
        src = f.read()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: the source has no {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", cu, "-o", os.path.join(OUT_DIR, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{out}")
        logs[name] = "; ".join(ln.replace("ptxas info    :", "").strip() for ln in out.splitlines()
                               if "registers" in ln or "spill" in ln)
    return logs


def inputs():
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.gridassembly import assemble_grid_hessian

    b = 34952
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, 96, 96), generator=g, device="cuda")
    rnd = torch.baddbmm(torch.eye(96, device="cuda").expand(b, 96, 96), q, q.transpose(1, 2),
                        alpha=1.0 / 96)
    del q
    mesh = cloth.make_grid(1024, 1024, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, device="cuda")
    cl = assemble_grid_hessian(dgr, drr, offsets, 10, SchwarzConfig())
    eye = torch.eye(96, device="cuda").expand(b, 96, 96).contiguous()
    return {"random": rnd, "cloth1024": cl, "identity": eye, "b5": rnd[:5].contiguous()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS), help=", ".join(VARIANTS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_variants.py needs a CUDA card", file=sys.stderr)
        return 2
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    logs = build(args.variants)
    from precond_tpu_torch.ops.batched_inverse import invert_spd_blocks_panel

    data = inputs()
    plain = {k: invert_spd_blocks_panel(data[k][:2048]) for k in ("random", "cloth1024")}
    stream = torch.cuda.current_stream().cuda_stream
    for name in args.variants:
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"{name}.so"))
        fn = lib.spd_inverse96
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(x, out):
            code = fn(x.data_ptr(), out.data_ptr(), x.shape[0], 1, stream)
            if code != 0:
                raise RuntimeError(f"variant {name}: cudaError_t {code}")

        rec = {"variant": name, "ptxas": logs[name], "ms": {}, "rel_vs_plain": {}}
        for key, x in data.items():
            out = torch.empty_like(x)
            for _ in range(2):
                call(x, out)
            rounds = []
            for _ in range(3 if key == "random" else 1):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(x, out)
                end.record()
                end.synchronize()
                rounds.append(start.elapsed_time(end) / 10)
            rec["ms"][key] = rounds if key == "random" else rounds[0]
            if key in plain:
                ref = plain[key]
                rec["rel_vs_plain"][key] = float((out[:2048] - ref).abs().max() / ref.abs().max())
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
