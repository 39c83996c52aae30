"""bench_torch.py's path-switching BENCH_* settings against bench.py on the CPU.

Each setting sends a config down another build or solve path than the
default: the corotational and neo-Hookean tet assembly, the tet general-M
sort (BOXMORTON=0) and the sorted-space static-transfer apply
(BOXSTENCIL=0), the collide fold's position-sorted general M, the cloth
general ELL SpMV (STENCIL=0), the stencil SpMV with the sorted apply
(GRIDMORTON=0) or with the Morton crossings around it (GRIDPREP=0), and the
symmetric stencil table (SPMV_SYM=1). Both benches run each case at a tiny
size under the same environment, and their rows must agree as in
test_torch_bench.py: vertices and nnz exactly, iterations within one
convergence check window, residuals within the solve tolerance, the same
fields."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import bench_torch  # noqa: E402

ENV = {"BENCH_ITERS": "2", "BENCH_SOLVE_REPS": "1", "BENCH_SOLVE_CHAIN": "1"}
WINDOW = 8  # pcg(check_every=8) in both packages

CASES = [
    ("tet", 6, "BENCH_MATERIAL", "corotational"),
    ("tet", 6, "BENCH_MATERIAL", "neohookean"),
    ("tet", 8, "BENCH_BOXMORTON", "0"),
    ("tet", 8, "BENCH_BOXSTENCIL", "0"),
    ("collide", 16, "BENCH_COLLIDE_M", "general"),
    ("cloth", 16, "BENCH_STENCIL", "0"),
    ("cloth", 16, "BENCH_GRIDMORTON", "0"),
    ("cloth", 16, "BENCH_GRIDPREP", "0"),
    ("cloth", 16, "BENCH_SPMV_SYM", "1"),
]


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("config,grid,knob,value", CASES,
                         ids=[f"{c}:{g}-{k[6:]}={v}" for c, g, k, v in CASES])
def test_setting_matches_bench_py(monkeypatch, two_threads, config, grid, knob, value):
    for k, v in {**ENV, knob: value}.items():
        monkeypatch.setenv(k, v)
    ref = bench.run_config(config, grid)
    got = bench_torch.run_config(config, grid, device="cpu")
    for key in ("num_verts", "nnz_spmv", "nnz_apply"):
        assert got[key] == ref[key], (key, got[key], ref[key])
    for key in ("schwarz_iters", "jacobi_iters"):
        assert got[key] % WINDOW == 0, (key, got[key])
        assert abs(got[key] - ref[key]) <= WINDOW, (key, got[key], ref[key])
    assert got["schwarz_iters"] < got["jacobi_iters"]
    for key in ("schwarz_rel", "jacobi_rel"):
        assert 0.0 <= got[key] <= 1e-4 and ref[key] <= 1e-4, (key, got[key], ref[key])
    optional = {"dispatch_suspect"}
    assert set(got) - optional == set(ref) - optional
    assert got["value"] > 0 and got["prepare_ms"] > 0
