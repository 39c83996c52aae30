"""The port's twin of scripts/probe_crossing_fix.py
(scripts/torch_probe_crossing_fix.py) against the JAX script, on the CPU
at 32^2 (the smallest grid with the comp-major path), K = 2.

The JAX script runs in-process (tests/dissect_support) with BENCH_GRID=32
and PROF_K=2. From 32^2 up its "auto" prepare returns a comp-major inverse,
which its line 116 hands to pack_sym96_cm, so it stops there; everything it
defined before (the variants, the loops, the system, the rhs) is reached
from its namespace. The row-major loops run on the JAX package's row-major
inverse (solve_layout="rows"), the comp-major loop on the script's own
comp-major one, as the twin does; the twin takes the JAX inputs through
convert.py.

  * each variant's x (the first entry, which the JAX script returns;
    its comp-major loop, defined after line 116, is compiled from its
    source into its namespace)
    against the JAX loop's at rtol 1e-4, atol 1e-4 * max|x|, the
    dissection tests' chained tolerance (two PCG steps compound the SpMV's,
    the apply's and the dots' rounding); the JAX "+bar" variants return
    their plain variant's value bit for bit, which the twin's one line
    about them relies on;
  * the twin's stream and patch loops agree bit for bit;
  * the port's crossings equal the JAX package's bit for bit (they are
    permutations);
  * the twin's main runs end to end at 32^2 and prints finite lines.
"""

import ast
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_support import fault_line, jax_script, np_

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.solver import prepare_grid as jax_prepare_grid
from precond_tpu.utils import gridmorton as jgm
from precond_tpu_torch import convert
from precond_tpu_torch.utils import gridmorton as tgm

import torch_probe_crossing_fix as tw

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRID, K = 32, 2
CHAINED_RTOL = 1e-4


@pytest.fixture(scope="module")
def crossing():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("probe_crossing_fix", mp, {"BENCH_GRID": GRID, "PROF_K": K},
                         raises=(AttributeError, TypeError))
    g = run.g
    inv_rows = jax_prepare_grid(g["dgr"], g["drr"], g["goffsets"], g["k_gm"],
                                JaxConfig(solve_layout="rows"), None, jnp.asarray(g["o2s"]))
    s = tw.setup(GRID, CPU)
    assert type(s.inv).__name__ == "Tensor" and type(g["inv96"]).__name__ == "DenseInverseCM"
    j = g["ssys"]
    s.ssys = convert.stencil_system_from_numpy(np_(j.diag_t), np_(j.dirs_t), j.offsets, j.grid,
                                               sym=j.sym, device="cpu")
    s.inv = torch.as_tensor(np_(inv_rows))
    s.inv_cm = convert.dense_inverse_cm_from_numpy(np_(g["inv96"].m), device="cpu")
    np.testing.assert_array_equal(s.b.numpy(), np_(g["b"]))
    return run, s, inv_rows


def test_jax_script_faults_at_line_116(crossing):
    run, _, _ = crossing
    assert run.error is not None
    assert fault_line(run.error, run.g["__file__"]) == 116
    assert run.out.splitlines() == []


@pytest.mark.parametrize("name", ["stream", "stream+bar", "patch", "patch+bar"])
def test_variant_matches_jax(crossing, name):
    run, s, inv_rows = crossing
    g = run.g
    want = g["loop_for"](g["VARIANTS"][name])(g["ssys"], inv_rows, g["b"])
    plain = g["loop_for"](g["VARIANTS"][name.split("+")[0]])(g["ssys"], inv_rows, g["b"])
    np.testing.assert_array_equal(np_(want), np_(plain))
    x = tw.k_iterations(s, tw._variants()[name.split("+")[0]], K)
    np.testing.assert_allclose(x[0, :1].numpy(), np_(want), rtol=CHAINED_RTOL,
                               atol=CHAINED_RTOL * float(x.abs().max()))


def _define_after_fault(g: dict, name: str) -> None:
    """Compile the script's top-level function `name`, which comes after
    its faulting line, from its source into its namespace."""
    path = g["__file__"]
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[node], type_ignores=[]), path, "exec"), g)


def test_comp_major_matches_jax(crossing):
    run, s, _ = crossing
    g = run.g
    _define_after_fault(g, "loop_cm")
    want = g["loop_cm"]()(g["ssys"], g["inv96"], jnp.transpose(g["b"]))
    x = tw.k_iterations_cm(s, K)
    np.testing.assert_allclose(x[:1, 0].numpy(), np_(want), rtol=CHAINED_RTOL,
                               atol=CHAINED_RTOL * float(x.abs().max()))


def test_variants_bit_for_bit(crossing):
    _, s, _ = crossing
    out = tw.run(s, K, log=lambda m: None)
    assert out["stream"]["same"] and out["patch"]["same"]
    assert torch.equal(out["stream"]["out"], out["patch"]["out"])


@pytest.mark.parametrize("name", ["grid_to_morton", "morton_to_grid", "grid_to_morton_patch",
                                  "morton_to_grid_patch", "grid_to_morton_cm", "morton_to_grid_cm"])
def test_crossings_match_jax(name):
    k = GRID.bit_length() - 1
    x = np.random.default_rng(8).standard_normal((4**k, 3)).astype(np.float32)
    if name.endswith("_cm"):
        x = np.ascontiguousarray(x.T)
    got = getattr(tgm, name)(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got, np_(getattr(jgm, name)(jnp.asarray(x), k)))


def test_main_prints_finite_lines(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_GRID", str(GRID))
    monkeypatch.setenv("PROF_K", str(K))
    assert tw.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"grid={GRID} n={GRID * GRID} K={K} packed=False"
    assert [ln.split()[0] for ln in out[2:]] == ["stream", "patch", "stream+bar", "comp-major"]
    assert out[4] == tw.BARRIER_NOTE
    for ln in (out[2], out[3], out[5]):
        ms = float(ln.split()[1])
        assert math.isfinite(ms) and ms > 0
    assert "DRIFT" not in out[3]
