"""The port's twins of the JAX package's micro-benchmarks, prepare timer and
re-sort cadence study, on the CPU:

  * scripts/torch_micro_bench.py: each primitive against the JAX package's
    form of it at small sizes (inverses at rtol 2e-4, atol 1e-5,
    tests/test_gridprep.py:110; gathers and the scatter-add at rtol 1e-5,
    atol 1e-6 * max; symv at the JAX package's K3 tolerance, rtol = atol =
    1e-5, tests/test_pallas_symv.py:22) and its lines in the script's order;
  * scripts/torch_time_prepare.py: the script's line at 16^2;
  * scripts/torch_study_resort.py: the first 5 frames at STUDY_GRID=20,
    per-frame iterations within 2 of scripts/study_resort.py's run(), for
    every cadence.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dissect_support import close, jax_script, np_, twin_lines

from precond_tpu.ops.batched_inverse import invert_spd_blocks as jinvert

import torch_micro_bench as tw_mb
import torch_study_resort as tw_study
import torch_time_prepare as tw_time

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL = dict(inverse_b=(4, 6), n=2048, scatter_rows=64, symv_b=8, stream_rows=32)
STUDY_ITERS_BAND = 2


def test_micro_bench_inverses():
    h = tw_mb.spd_batch(np.random.default_rng(0), 4)
    want = np_(jinvert(jnp.asarray(h)) + 1e-9)
    for fn in (tw_mb.k1_inverse, tw_mb.library_inverse):
        np.testing.assert_allclose(fn(torch.as_tensor(h)).numpy(), want, rtol=2e-4, atol=1e-5)


def test_micro_bench_gathers_scatter_symv():
    rng = np.random.default_rng(1)
    n = 256
    x = rng.standard_normal((n, 3)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, 12))
    close(tw_mb.gather_rows(torch.as_tensor(x), torch.as_tensor(idx)).numpy(),
          np_(jnp.take(jnp.asarray(x), idx, axis=0).sum(axis=1) * 0.5))
    perm = rng.permutation(n)
    close(tw_mb.gather_perm(torch.as_tensor(x), torch.as_tensor(perm)).numpy(),
          np_(jnp.take(jnp.asarray(x), perm, axis=0) * 0.5))
    tgt = rng.integers(0, 16, size=(n,)).astype(np.int32)
    close(tw_mb.scatter_add(torch.as_tensor(x), torch.as_tensor(tgt), 16).numpy(),
          np_(jnp.zeros((16, 3), jnp.float32).at[tgt].add(x)))
    inv = rng.standard_normal((8, 96, 96)).astype(np.float32)
    r = rng.standard_normal((8, 96)).astype(np.float32)
    want = np_(jnp.einsum("bij,bj->bi", inv, r, preferred_element_type=jnp.float32))
    for fn in (tw_mb.k3_symv, tw_mb.einsum_symv):
        np.testing.assert_allclose(fn(torch.as_tensor(r), torch.as_tensor(inv)).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def test_micro_bench_lines(capsys):
    out = tw_mb.run(CPU, SMALL)
    labels = ["dispatch floor", "K1 spd_inverse B=4", "library chol inverse B=4",
              "K1 spd_inverse B=6", "library chol inverse B=6", "gather [2048,12] rows",
              "gather [2048] perm rows", "bank gather [64,9]x96",
              "scatter-add [2048]->64 (single dispatch)", "K3 symv B=8", "einsum symv B=8",
              "elementwise stream 0MB"]
    assert list(out) == labels
    printed = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()]
    assert printed == labels
    assert all(np.isfinite(t["ms"]) and t["busy"] is None for t in out.values())


def test_time_prepare_line(monkeypatch, capsys):
    out = twin_lines(tw_time, monkeypatch, capsys, {"BENCH_GRID": 16})
    last = out.splitlines()[-1]
    assert last.startswith("prepare min-of-5: ") and "(grid=16, n=256)" in last


def test_study_resort_matches_jax(monkeypatch):
    env = {"STUDY_GRID": 20, "STUDY_FRAMES": 5}
    run = jax_script("study_resort", monkeypatch, env)
    assert run.out == ""   # its study runs under __main__ only
    for cadence in tw_study.CADENCES:
        want = run.g["run"](cadence)
        got = tw_study.run(cadence, 20, 5, CPU)
        assert len(got["iters"]) == len(want) == 5
        assert np.abs(np.array(got["iters"]) - np.array(want)).max() <= STUDY_ITERS_BAND, \
            (cadence, got["iters"], want)
