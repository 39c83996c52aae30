"""The port's twins of the JAX package's PCG-iteration dissections and its
trace parser, on the CPU:

  * scripts/torch_profile_iteration_cm.py against profile_iteration_cm.py
    at 32^2 (the smallest grid with the comp-major path), K = 2;
  * scripts/torch_profile_iteration.py against profile_iteration.py at
    16^2, K = 2;
  * scripts/torch_parse_trace.py on synthetic Chrome traces and on a real
    CPU device_trace (no device events: a plain non-zero exit);
  * every twin raises without --device on a machine without a card.

Each JAX script runs with BENCH_GRID and PROF_K set (tests/dissect_support);
its inputs (system, inverse, rhs) cross to the twin through convert.py.
A single preconditioner op is held at the JAX package's apply tolerance
(rtol 1e-5, atol 1e-6 * max|z|, tests/test_torch_apply.py:49). The chained
K = 2 variants compound the SpMV's, the apply's and the dots' rounding
through two PCG steps, so their result (the first entry of x, which the
JAX script returns) is held at rtol 1e-4, atol 1e-4 * max|x|; dots-only at
K = 1, because its first step zeroes r in exact arithmetic and its second
divides 0 by 0 (what either package gets there is rounding). The variant
names must be the JAX script's, in its order, in what each twin prints.
symv-only and no-cross of the row-major script are numerically
meaningless by design (op-mix attribution only) and are not compared.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_support import close, jax_script, line_names, np_, twin_lines

from precond_tpu_torch import convert
from precond_tpu_torch.profiling import device_trace

import torch_parse_trace as parse_trace
import torch_profile_iteration as tw_rows
import torch_profile_iteration_cm as tw_cm

torch.set_num_threads(2)

CPU = torch.device("cpu")
CHAINED_RTOL = 1e-4
TWINS = ("torch_profile_iteration_cm", "torch_profile_iteration", "torch_profile_apply",
         "torch_profile_apply_fine", "torch_profile_prepare", "torch_profile_prepare_grid",
         "torch_profile_assembly", "torch_micro_bench", "torch_time_prepare",
         "torch_study_resort")


def _ssys(j):
    return convert.stencil_system_from_numpy(np_(j.diag_t), np_(j.dirs_t), j.offsets, j.grid,
                                             sym=j.sym, device="cpu")


@pytest.fixture(scope="module")
def cm():
    """The JAX comp-major script at 32^2 and the twin's setup on its inputs."""
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("profile_iteration_cm", mp, {"BENCH_GRID": 32, "PROF_K": 2})
    g = run.g
    s = tw_cm.setup(32, CPU)
    assert type(s.inv).__name__ == type(g["inv_cm"]).__name__ == "DenseInverseCM"
    s.inv = convert.dense_inverse_cm_from_numpy(np_(g["inv_cm"].m), device="cpu")
    s.ssys = _ssys(g["ssys"])
    np.testing.assert_array_equal(s.bt.numpy(), np_(g["bt"]))
    return run, s


@pytest.fixture(scope="module")
def rows():
    """The JAX row-major script at 16^2 and the twin's setup on its inputs."""
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("profile_iteration", mp, {"BENCH_GRID": 16, "PROF_K": 2})
    g = run.g
    s = tw_rows.setup(16, CPU)
    s.inv = torch.as_tensor(np_(g["inv96"]))
    s.ssys = _ssys(g["ssys"])
    np.testing.assert_array_equal(s.b.numpy(), np_(g["b"]))
    assert s.btot == g["_btot"]
    return run, s


def _chained_close(first, x, want):
    """The JAX script's result (x's first entry) against the twin's."""
    np.testing.assert_allclose(first, np_(want), rtol=CHAINED_RTOL,
                               atol=CHAINED_RTOL * float(x.abs().max()))


# ---- comp-major --------------------------------------------------------------

def test_iteration_cm_names(cm, monkeypatch, capsys):
    run, _ = cm
    assert list(tw_cm.VARIANTS) == list(run.g["VARIANTS"])
    names = list(run.g["VARIANTS"])
    out = twin_lines(tw_cm, monkeypatch, capsys, {"BENCH_GRID": 32, "PROF_K": 2})
    assert line_names(out, names) == line_names(run.out, names) == names
    assert out.splitlines()[0] == run.out.splitlines()[0] == "grid=32 n=1024 K=2 inv=DenseInverseCM"


@pytest.mark.parametrize("name", ["full", "crossings-only", "symv-only"])
def test_iteration_cm_pre_op(cm, name):
    run, s = cm
    jpre, tpre = run.g["VARIANTS"][name][1], tw_cm.VARIANTS[name][1]
    r = np.random.default_rng(3).standard_normal((3, s.n)).astype(np.float32)
    close(tpre(s, torch.as_tensor(r)).numpy(), np_(jpre(run.g["inv_cm"], jnp.asarray(r))))


CHAINED = [("full", 2), ("no-apply", 2), ("no-spmv", 2), ("dots-only", 1)]


def _jax_chain(run, name, k, *args):
    """The JAX script's K-iteration loop of a variant at K = k."""
    run.g["K"] = k
    use_spmv, jpre = run.g["VARIANTS"][name]
    return run.g["loop_for"](use_spmv, jpre)(*args)


@pytest.mark.parametrize("name,k", CHAINED + [("crossings-only", 2)])
def test_iteration_cm_chained(cm, name, k):
    run, s = cm
    want = _jax_chain(run, name, k, run.g["ssys"], run.g["inv_cm"], run.g["bt"])
    assert tw_cm.VARIANTS[name][0] == run.g["VARIANTS"][name][0]
    x = tw_cm.k_iterations(s, *tw_cm.VARIANTS[name], k)
    _chained_close(x[:1, 0].numpy(), x, want)


# ---- row-major ---------------------------------------------------------------

def test_iteration_names(rows, monkeypatch, capsys):
    run, _ = rows
    assert list(tw_rows.VARIANTS) == list(run.g["VARIANTS"])
    names = list(run.g["VARIANTS"])
    out = twin_lines(tw_rows, monkeypatch, capsys, {"BENCH_GRID": 16, "PROF_K": 2})
    assert line_names(out, names) == line_names(run.out, names) == names
    assert out.splitlines()[0] == run.out.splitlines()[0]


@pytest.mark.parametrize("name", ["full", "transfers-only"])
def test_iteration_pre_op(rows, name):
    run, s = rows
    jpre, tpre = run.g["VARIANTS"][name][1], tw_rows.VARIANTS[name][1]
    r = np.random.default_rng(4).standard_normal((s.n, 3)).astype(np.float32)
    close(tpre(s, torch.as_tensor(r)).numpy(), np_(jpre(run.g["inv96"], jnp.asarray(r))))


@pytest.mark.parametrize("name,k", CHAINED + [("transfers-only", 2)])
def test_iteration_chained(rows, name, k):
    run, s = rows
    want = _jax_chain(run, name, k, run.g["ssys"], run.g["inv96"], run.g["b"])
    assert tw_rows.VARIANTS[name][0] == run.g["VARIANTS"][name][0]
    x = tw_rows.k_iterations(s, *tw_rows.VARIANTS[name], k)
    _chained_close(x[0, :1].numpy(), x, want)


# ---- the trace parser ----------------------------------------------------------

def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


SYNTHETIC = [
    _event("void packed_symv96_kernel<32>(float const*, float*, int)", 0.0, 200.0),
    _event("void packed_symv96_kernel<32>(float const*, float*, int)", 1000.0, 240.0),
    _event("stencil_spmv_kernel(float const*, int).1", 300.0, 150.0),
    _event("stencil_spmv_kernel(float const*, int).2", 1400.0, 150.0),
    _event("Memcpy DtoD (Device -> Device)", 600.0, 60.0, cat="gpu_memcpy"),
    _event("Memset (Device)", 700.0, 0.0, cat="gpu_memset"),
    _event("aten::add", 0.0, 5000.0, cat="cpu_op"),
    _event("cudaLaunchKernel", 0.0, 3.0, cat="cuda_runtime"),
]


def test_parse_trace_collapses_and_totals():
    assert parse_trace.collapse("void ns::kern<4, at::F<float>>(float const*, int).12") == "ns::kern"
    assert parse_trace.collapse("(anonymous namespace)::k96(float const*)") == "k96"
    assert parse_trace.collapse("void at::native::(anonymous namespace)::cat<3>(int)") == \
        "at::native::cat"
    summary = parse_trace.summarize(SYNTHETIC, reps=2)
    assert summary["events"] == 6
    assert summary["ops"]["packed_symv96_kernel"] == (2, pytest.approx(0.44))
    assert summary["ops"]["stencil_spmv_kernel"] == (2, pytest.approx(0.30))
    assert summary["ops"]["Memcpy DtoD"] == (1, pytest.approx(0.06))
    assert summary["total_ms"] == pytest.approx(0.80)
    assert summary["span_ms"] == pytest.approx(1.55)
    lines = parse_trace.table(summary, top=2)
    assert lines[0].startswith("total device op time: 0.800 ms (0.400 ms/rep over 2 reps)")
    assert "span 1.550 ms" in lines[0] and "51.6% busy" in lines[0]
    assert len(lines) == 4 and lines[2].split()[:2] == ["packed_symv96_kernel", "2"]
    assert lines[2].split()[2:4] == ["0.440", "0.2200"]
    raw = parse_trace.summarize(SYNTHETIC, raw=True)
    assert len(raw["ops"]) == 5 and raw["ops"]["stencil_spmv_kernel(float const*, int).1"][0] == 1


def test_parse_trace_main(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": SYNTHETIC}))
    assert parse_trace.main([str(path), "--reps", "2", "--top", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 5 and out[2].startswith("packed_symv96_kernel")
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": SYNTHETIC[-2:]}))
    with pytest.raises(SystemExit, match="no device events"):
        parse_trace.main([str(empty)])


def test_parse_trace_cpu_device_trace(tmp_path):
    """A real trace from profiling.device_trace on the CPU holds CPU ops
    only: the parser says so and exits non-zero."""
    x = torch.randn(64, 3)
    with device_trace(str(tmp_path)):
        (x * 2.0).sum()
    events = parse_trace.load(os.path.join(tmp_path, "trace.json"))
    assert events and not parse_trace.device_events(events)
    with pytest.raises(SystemExit) as e:
        parse_trace.main([os.path.join(tmp_path, "trace.json")])
    assert "no device events" in str(e.value)


# ---- no card, no fallback --------------------------------------------------------

@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_card(name, monkeypatch):
    """Without --device a twin runs on the card, and raises where there is
    none instead of running on the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(name).main([])


# ---- chip_smoke.py's [dissect] phase -----------------------------------------------

def test_chip_smoke_dissect_gates(tmp_path):
    """chip_smoke.py's [dissect] phase runs every twin through its module
    functions; at 16^2 (32^2 for the comp-major twin) on the CPU every line
    is timed and both `full` variants repeat bit for bit, so the only
    faults are the CPU's: no kernel launched and no device event to parse.
    On the card the same gates must all hold."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    assert chip_smoke.DISSECT == {"iteration_cm": 1024, "iteration": 256, "apply": 1024,
                                  "apply_fine": 1024, "prepare": 1024, "prepare_grid": 1024,
                                  "assembly": 256}
    sizes = {**{k: 16 for k in chip_smoke.DISSECT}, "iteration_cm": 32}
    counts, faults = chip_smoke.run_dissect(
        str(tmp_path), sizes, {k: 2 for k in sizes}, device="cpu",
        micro_sizes=dict(inverse_b=(4,), n=1024, scatter_rows=64, symv_b=8, stream_rows=32))
    assert [f for f in faults if not f.startswith("trace: no device events")] == \
        [f"{k} never launched" for k in chip_smoke.DISSECT_KERNELS]
    assert len(faults) == 5
    assert set(counts) == {"dissect iteration_cm 32", "dissect trace 32", "dissect iteration 16",
                           "dissect apply 16", "dissect apply_fine 16", "dissect prepare 16",
                           "dissect prepare_grid 16", "dissect assembly 16", "dissect micro_bench"}
    launched = {k: 1 for k in chip_smoke.DISSECT_KERNELS}
    assert chip_smoke.dissect_faults({"a": 1.0}, {"full": True}, launched) == []
    bad = chip_smoke.dissect_faults({"a": float("nan"), "b": 0.0}, {"iteration 256": False},
                                    {**launched, "symv96": 0}, "no device events")
    assert len(bad) == 5 and "symv96 never launched" in bad
