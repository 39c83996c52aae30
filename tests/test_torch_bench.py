"""bench_torch.py (the port's bench) against bench.py on the CPU.

Both run the same tiny configs (the general path, the cloth grid path, the
tet box and general paths, the folded collide sheet on the grid M) with
BENCH_ITERS=2, one solve rep and a solve chain of 1; the counts they print
must agree: vertices and nnz exactly, iterations within one convergence
check window (both test every 8 iterations), residuals within the solve
tolerance, the same fields. Times are not compared: a CPU run measures the
CPU."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402

CONFIGS = [("general", 16), ("cloth", 16), ("tet", 8), ("tet", 6), ("collide", 16)]
IDS = [f"{c}:{g}" for c, g in CONFIGS]
ENV = {"BENCH_ITERS": "2", "BENCH_SOLVE_REPS": "1", "BENCH_SOLVE_CHAIN": "1"}
# pcg(check_every=8) in both packages
WINDOW = 8


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rows(two_threads):
    """{(config, grid): (bench.py's row, bench_torch.py's row)}, each config
    run once per package."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        yield {(c, g): (bench.run_config(c, g), bench_torch.run_config(c, g, device="cpu"))
               for c, g in CONFIGS}


@pytest.fixture
def bench_env(monkeypatch, two_threads):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_CONFIG", raising=False)
    return monkeypatch


@pytest.mark.parametrize("spec", CONFIGS, ids=IDS)
def test_counts_equal(rows, spec):
    ref, got = rows[spec]
    for key in ("num_verts", "nnz_spmv", "nnz_apply"):
        assert got[key] == ref[key], (key, got[key], ref[key])


@pytest.mark.parametrize("spec", CONFIGS, ids=IDS)
def test_iterations_within_one_window(rows, spec):
    ref, got = rows[spec]
    for key in ("schwarz_iters", "jacobi_iters"):
        assert got[key] % WINDOW == 0, (key, got[key])
        assert abs(got[key] - ref[key]) <= WINDOW, (key, got[key], ref[key])
    assert got["schwarz_iters"] < got["jacobi_iters"]


@pytest.mark.parametrize("spec", CONFIGS, ids=IDS)
def test_residuals_within_tolerance(rows, spec):
    ref, got = rows[spec]
    for key in ("schwarz_rel", "jacobi_rel"):
        assert 0.0 <= got[key] <= 1e-4 and ref[key] <= 1e-4, (key, got[key], ref[key])


@pytest.mark.parametrize("spec", CONFIGS, ids=IDS)
def test_fields_as_bench_py(rows, spec):
    """The same keys (bench.py adds dispatch_suspect only when its dispatch
    floor dominates a solve, and so does the port), finite positive rates."""
    ref, got = rows[spec]
    optional = {"dispatch_suspect"}
    assert set(got) - optional == set(ref) - optional
    assert got["device"] == "cpu"
    assert (got["config"], got["grid"]) == spec
    assert got["metric"] == ref["metric"] and got["unit"] == ref["unit"]
    assert got["value"] > 0 and got["iter_ms"] > 0 and got["prepare_ms"] > 0
    assert got["solve_reps"] == 1 and got["solve_chain"] == 1


def test_default_configs_headline_last(monkeypatch):
    monkeypatch.delenv("BENCH_CONFIG", raising=False)
    monkeypatch.delenv("BENCH_CONFIGS", raising=False)
    assert bench_torch.config_specs() == [
        ("collide", 256), ("tet", 48), ("tet", 64), ("general", 256), ("general", 1024),
        ("cloth", 256), ("cloth", 1024)]
    monkeypatch.setenv("BENCH_CONFIG", "tet")
    monkeypatch.setenv("BENCH_GRID", "32")
    assert bench_torch.config_specs() == [("tet", 32)]


def test_main_prints_headline_last(capsys, bench_env):
    bench_env.setenv("BENCH_CONFIGS", "general:16,cloth:16")
    assert bench_torch.main(["--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["config"] for r in lines] == ["general", "cloth"]
    assert all("error" not in r for r in lines)


def test_main_error_row_and_exit_1(capsys, bench_env):
    """A config that raises prints bench.py's error row, the rest still run,
    and main returns 1."""
    real = bench_torch.run_config

    def run_config(config, grid, device=None):
        if config == "boom":
            raise ValueError("no such config")
        return real(config, grid, device)

    bench_env.setenv("BENCH_CONFIGS", "boom:8,cloth:16")
    bench_env.setattr(bench_torch, "run_config", run_config)
    assert bench_torch.main(["--device", "cpu"]) == 1
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines[0] == {"metric": "pcg_iteration_nnz_throughput", "config": "boom", "grid": 8,
                        "error": "ValueError: no such config"}
    assert lines[-1]["config"] == "cloth" and "error" not in lines[-1]


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run_config("general", 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])


def test_chip_smoke_bench_gate():
    """chip_smoke.py's [bench] phase holds each row to the JAX records: equal
    nnz, the iteration bands (collide's relative bands end at the next
    multiple of 8), finite residuals <= 1e-4, a positive rate, no error."""
    row = {"config": "general", "grid": 1024, "value": 1.0, "schwarz_rel": 9e-5,
           "jacobi_rel": 1e-5, "schwarz_iters": 120, "jacobi_iters": 544,
           "nnz_spmv": 122499108, "nnz_apply": 164414208}
    assert chip_smoke.bench_row_faults(row) == []
    assert chip_smoke.bench_bands("collide", 256) == ((372 * 0.9, 416), (746 * 0.95, 784))
    bad = {"value": 0.0, "jacobi_rel": float("nan"), "schwarz_iters": 136, "nnz_apply": 1}
    assert len(chip_smoke.bench_row_faults({**row, **bad})) == len(bad)
    assert chip_smoke.bench_row_faults({"config": "tet", "grid": 48, "error": "E: x"}) == ["error E: x"]
    assert ",".join(f"{c}:{g}" for c, g in chip_smoke.BENCH_SPECS) == bench_torch.DEFAULT_CONFIGS
