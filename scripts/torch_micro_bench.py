#!/usr/bin/env python3
"""Micro-benchmarks of the hot primitives: the twin of
scripts/micro_bench.py, in precond_tpu_torch, at the JAX script's sizes and
with its data (one default_rng(0) stream, drawn in the same order).

Each primitive is chained k times through a data dependency, eagerly with
no host sync inside the chain, and timed as the least of 3 reps after a
warm call, with the chain's device busy share (torch_dissect_common):

  dispatch floor           one tiny op and a sync: the launch floor
  batched 96x96 SPD inverse at B = 2,208 and 8,736: the inverse kernel (K1)
                           and the library path the JAX script times
                           (torch.linalg.cholesky + torch.cholesky_inverse)
  row gathers on [N,3]     12 neighbours summed, a permutation, and 96-wide
                           bank rows (9 per bank, summed)
  scatter-add of N rows    into 4,096 rows through utils/scatter.accumulate_rows
                           (the port's deterministic placement; one call)
  batched symv             the dense symv kernel (K3) and the einsum, B = 2,208
  elementwise stream       x * 1.000001 over an 81 MB array (the large copy)

The JAX script's gather lines call its two-argument `chain` with three
arguments and raise there; the twin times what they set out to time. Its
bank gather grows the shape ([2048, 9, 96] from [2048, 96]), which a chain
cannot carry: the twin sums the 9 gathered rows, as its first gather does.

    python3 scripts/torch_micro_bench.py [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_dissect_common as dc  # noqa: E402

#: the JAX script's sizes
SIZES = dict(inverse_b=(2208, 8736), n=65536, scatter_rows=4096, symv_b=2208,
             stream_rows=2208 * 96 * 96 // 128)


def spd_batch(rng, b: int) -> np.ndarray:
    """q q^T + 96 I for q standard normal [b,96,96] (f32), as the JAX script."""
    q = rng.standard_normal((b, 96, 96)).astype(np.float32)
    return np.einsum("bij,bkj->bik", q, q) + 96 * np.eye(96, dtype=np.float32)


def k1_inverse(h):
    from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse

    return spd_inverse(h) + 1e-9


def library_inverse(h):
    return torch.cholesky_inverse(torch.linalg.cholesky(h)) + 1e-9


def gather_rows(x, idx):
    return x[idx].sum(dim=1) * 0.5


def gather_perm(x, idx):
    return x[idx] * 0.5


def scatter_add(x, tgt, rows: int):
    from precond_tpu_torch.utils.scatter import accumulate_rows

    out = x.new_zeros((rows, 3))
    accumulate_rows(out, tgt, x)
    return out


def k3_symv(r, inv):
    from precond_tpu_torch.ops.cuda.symv import batched_symv

    return batched_symv(inv, r)


def einsum_symv(r, inv):
    return torch.einsum("bij,bj->bi", inv, r)


def stream(a):
    return a * 1.000001


def run(dev: torch.device, sizes: dict = SIZES, log=dc.log) -> dict:
    """Every line of the script; returns {label: Timing}."""
    rng = np.random.default_rng(0)
    out = {}

    def t(label: str, fn, x, *rest, k: int, fmt):
        run_ = dc.chain(fn, k)
        tm = dc.measure(lambda: run_(x, *rest), dev)
        per = tm["best_s"] / k
        tm["ms"] = per * 1e3
        log(f"{label}: {fmt(per)}" + tm.note())
        out[label] = tm

    def dev_t(a):
        return torch.as_tensor(a, device=dev)

    one = torch.ones((8, 128), device=dev)
    t("dispatch floor", lambda x: x + 1, one, k=1, fmt=lambda s: f"{s * 1e3:.3f} ms")

    spds = [dev_t(spd_batch(rng, b)) for b in sizes["inverse_b"]]
    for b, spd in zip(sizes["inverse_b"], spds):
        for name, fn in (("K1 spd_inverse", k1_inverse), ("library chol inverse", library_inverse)):
            t(f"{name} B={b}", fn, spd, k=3,
              fmt=lambda s, b=b: f"{s * 1e3:.1f} ms  ({2 * b * 96 ** 3 / s / 1e12:.2f} eff-TFLOP/s)")
    del spds

    n = sizes["n"]
    xs = dev_t(rng.standard_normal((n, 3)).astype(np.float32))
    idx = dev_t(rng.integers(0, n, size=(n, 12)).astype(np.int64))
    t(f"gather [{n},12] rows", gather_rows, xs, idx, k=20,
      fmt=lambda s: f"{s * 1e3:.3f} ms  ({s / (n * 12) * 1e9:.2f} ns/row)")
    idx1 = dev_t(rng.permutation(n).astype(np.int64))
    t(f"gather [{n}] perm rows", gather_perm, xs, idx1, k=20,
      fmt=lambda s: f"{s * 1e3:.3f} ms  ({s / n * 1e9:.2f} ns/row)")
    xb = xs.reshape(-1, 96)
    idxb = dev_t(rng.integers(0, n // 32, size=(n // 32, 9)).astype(np.int64))
    t(f"bank gather [{n // 32},9]x96", gather_rows, xb, idxb, k=20,
      fmt=lambda s: f"{s * 1e3:.3f} ms")

    rows = sizes["scatter_rows"]
    tgt = dev_t(rng.integers(0, rows, size=(n,)).astype(np.int32))
    t(f"scatter-add [{n}]->{rows} (single dispatch)", lambda x, g: scatter_add(x, g, rows), xs,
      tgt, k=1, fmt=lambda s: f"{s * 1e3:.3f} ms")

    b = sizes["symv_b"]
    inv = dev_t(rng.standard_normal((b, 96, 96)).astype(np.float32))
    r = dev_t(rng.standard_normal((b, 96)).astype(np.float32))
    for name, fn in (("K3 symv", k3_symv), ("einsum symv", einsum_symv)):
        t(f"{name} B={b}", fn, r, inv, k=20,
          fmt=lambda s: f"{s * 1e3:.3f} ms  ({4 * b * 96 * 96 / s / 1e9:.0f} GB/s inv-read)")

    big = dev_t(rng.standard_normal((sizes["stream_rows"], 128)).astype(np.float32))
    t(f"elementwise stream {big.numel() * 4 / 1e6:.0f}MB", stream, big, k=20,
      fmt=lambda s: f"{s * 1e3:.3f} ms ({2 * big.numel() * 4 / s / 1e9:.0f} GB/s)")
    return out


def main(argv=None) -> int:
    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    dc.log(f"device: {dev}")
    dc.log(dc.card_line(dev))
    run(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
