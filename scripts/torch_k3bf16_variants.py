#!/usr/bin/env python3
"""Time ablations of the port's K3-bf16 kernel (csrc/symv_bf16.cu) side by side on one CUDA card.

    python3 scripts/torch_k3bf16_variants.py [VARIANT ...] [--b 34952 2185]

Each variant is a copy of the kernel source with named edits, built by its
own ``nvcc`` (all started together) into its own library under
``build/k3bf16_variants/`` and called through the same C entry as the
port's wrapper. Variants that cut work out give wrong results on purpose:
``no_compute`` (copies only) and ``no_table_copy`` (multiplies only) split
the kernel's time between loading and multiplying; ``contiguous_src``
makes the same copies from a contiguous span of each table (the cost of
the triangle's scattered row prefixes); ``tile_dst`` lands them in
swizzled per-tile lines instead of the compact triangle (the layout of the
kernel's first design). ``stages3`` runs a 3-stage ring. Names compose:
``no_compute+tile_dst`` applies both. ``l2_32`` / ``l2_64`` / ``l2_128``
run the unchanged kernel with the device's L2 fetch granularity limit
(``cudaLimitMaxL2FetchGranularity``) set to that many bytes for the turn,
then restored. Inputs, made on the card from seed 0: a bitwise-symmetric
bf16 table [B,96,96] and an f32 rhs [B,96]. Times are CUDA events around a
CUDA graph of 20 launches (so no host time enters), the median of 5
replays after 2 warm ones; each turn also runs once outside the graph
against the plain einsum, and a name given twice runs twice, in the order
given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "build", "k3bf16_variants")
SOURCE = os.path.join(HERE, "precond_tpu_torch", "csrc", "symv_bf16.cu")

COPY = "cp_async16(st + 16 * (tid + s * THREADS), tab + src[s]);"
LAST = "const bool last_copy = tid + (COPIES - 1) * THREADS < CHUNKS;"
ROUND = "__device__ __forceinline__ float bf16_round"
# chunk q's slot in per-tile 128-byte lines: row r of tile t at 16 * (r ^ (t & 7))
TILE_DST = """__device__ __forceinline__ int tile_dst(int q) {
  int g = 0;
  while (4 * (g + 1) * (g + 2) <= q) ++g;
  const int off = q - 4 * g * (g + 1);
  const int r = off / (g + 1), k = off - r * (g + 1);
  const int t = k == g ? 66 + g : g * (g - 1) / 2 + k;
  return t * 128 + 16 * (r ^ (t & 7));
}

"""
# appended to every variant: the L2 fetch granularity limit and the occupancy
EXTRA = '''
extern "C" int l2_fetch_granularity(int set_bytes, int* was) {
  size_t v = 0;
  cudaError_t e = cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  if (e != cudaSuccess) return static_cast<int>(e);
  *was = static_cast<int>(v);
  if (set_bytes >= 0) e = cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, set_bytes);
  return static_cast<int>(e);
}

extern "C" int k_occupancy(int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(symv96_bf16_kernel,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, symv96_bf16_kernel, THREADS, 0));
}
'''

VARIANTS = {
    "kernel": [],
    "no_compute": [("if (ti > tj) {", "if (false) {"), ("} else if (ti >= 0) {", "} else if (false) {")],
    "no_table_copy": [("if (s < COPIES - 1 || last_copy) cp_async16", "if (false) cp_async16")],
    "contiguous_src": [("return (8 * g + r) * D * 2 + 16 * (off - r * (g + 1));",
                        "return 16 * q;")],
    "tile_dst": [(ROUND, TILE_DST + ROUND),
                 (LAST, LAST + "\n  int dsw[COPIES];\n#pragma unroll\n  for (int s = 0; s < COPIES; ++s) "
                        "dsw[s] = tile_dst(tid + s * THREADS);"),
                 (COPY, "cp_async16(st + dsw[s], tab + src[s]);")],
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
}
LIMIT_TURNS = {"l2_32": 32, "l2_64": 64, "l2_128": 128}


def _source_of(name: str) -> str:
    """The built source a turn runs (limit turns run the unchanged kernel)."""
    return "kernel" if name in LIMIT_TURNS else name


def build(names) -> dict:
    sys.path.insert(0, HERE)
    from precond_tpu_torch.ops.cuda import _lib

    with open(SOURCE) as f:
        src = f.read()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in [e for part in name.split("+") for e in VARIANTS[part]]:
            if old not in text:
                raise SystemExit(f"variant {name}: the source has no {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text + EXTRA)
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


def graph_ms(fn, launches: int = 20, rounds: int = 5) -> float:
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    for _ in range(2):
        g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS) + sorted(LIMIT_TURNS)}")
    ap.add_argument("--b", type=int, nargs="+", default=[34952, 2185])
    args = ap.parse_args(argv)
    names = args.variants or sorted(VARIANTS) + sorted(LIMIT_TURNS)
    sys.path.insert(0, HERE)
    import torch
    from precond_tpu_torch.ops.batched_inverse import apply_block_inverse

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    logs = build(sorted({_source_of(n) for n in names}))
    libs = {}
    for name in logs:
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"{name}.so"))
        lib.symv96_bf16.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.l2_fetch_granularity.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.k_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
        per_sm = ctypes.c_int(0)
        lib.k_occupancy(ctypes.byref(per_sm))
        print(f"[occupancy] {name}: {per_sm.value} blocks per SM", flush=True)
        libs[name] = lib
    was = ctypes.c_int(0)
    next(iter(libs.values())).l2_fetch_granularity(-1, ctypes.byref(was))
    default_l2 = was.value
    print(f"[l2] cudaLimitMaxL2FetchGranularity default {default_l2} bytes", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for b in args.b:
        a = torch.randn((b, 96, 96), generator=g, device="cuda")
        inv = (0.5 * (a + a.transpose(1, 2))).to(torch.bfloat16)
        del a
        rhs = torch.randn((b, 96), generator=g, device="cuda")
        want = apply_block_inverse(inv, rhs)
        rb = rhs.to(torch.bfloat16)[:, :, None]
        bmm = graph_ms(lambda: torch.bmm(inv, rb, out_dtype=torch.float32))
        print(json.dumps({"b": b, "variant": "torch.bmm(out_dtype=float32)", "ms": bmm}), flush=True)
        for name in names:
            lib = libs[_source_of(name)]
            z = torch.empty_like(rhs)

            def call(lib=lib, z=z):
                code = lib.symv96_bf16(inv.data_ptr(), rhs.data_ptr(), z.data_ptr(), b,
                                       torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError(f"launch failed: cudaError_t {code}")

            if name in LIMIT_TURNS:
                lib.l2_fetch_granularity(LIMIT_TURNS[name], ctypes.byref(was))
            try:
                call()
                torch.cuda.synchronize()
                err = float((z - want).abs().max())
                ms = graph_ms(call)
            finally:
                if name in LIMIT_TURNS:
                    lib.l2_fetch_granularity(default_l2, ctypes.byref(was))
            print(json.dumps({"b": b, "variant": name, "ms": ms, "max_abs_err": err,
                              "ptxas": logs[_source_of(name)]}), flush=True)
        del inv, rhs, want, rb
    return 0


if __name__ == "__main__":
    sys.exit(main())
