"""The port's twin of scripts/probe_stiff.py (scripts/torch_probe_stiff.py)
against the JAX script, on the CPU at 16^2.

The JAX script runs in-process at 16^2 (tests/dissect_support: its main
with argv ["16"]), over its four stiffnesses; the twin runs the same scan
on its own detection, systems and prepares. Each solver's iterations to
1e-4 (check_every 8) must equal the JAX script's at stiffness 1e3 and lie
in chip_smoke.py's [contact probes] band above it (+-12% or +-16
iterations): from 1e4 up a count moves with any change of summation order
(chip_smoke.PROBE_BANDS). The twin's main runs end to end and prints
finite lines.
"""

import math

import pytest
import torch

from dissect_support import assert_probe_count, jax_script, parse_scan, run_main

import torch_probe_common as pc
import torch_probe_stiff as tw

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRID = 16


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("probe_stiff", mp, {})
        run_main(run, [GRID])
    return run


@pytest.fixture(scope="module")
def twin():
    s = pc.setup(GRID, CPU)
    lines = []
    return s, tw.run(s, pc.STIFFNESS, log=lines.append), lines


def test_scan_lines(jax_run, twin):
    """Both scan the same four stiffnesses on the same sheet; every twin
    solve converged, with a finite wall."""
    s, out, lines = twin
    assert jax_run.out.splitlines()[0] == f"n={s.n} stencils={s.live}" == "n=256 stencils=192"
    assert sorted(parse_scan(jax_run.out)) == sorted(parse_scan("\n".join(lines))) == \
        list(pc.STIFFNESS)
    for row in out.values():
        for r in row.values():
            assert r["rel"] <= pc.TOL and math.isfinite(r["wall_s"]) and r["wall_s"] > 0


@pytest.mark.parametrize("solver", tw.SOLVERS)
@pytest.mark.parametrize("stiff", pc.STIFFNESS)
def test_iterations(jax_run, twin, stiff, solver):
    want = parse_scan(jax_run.out)[stiff][solver]
    assert parse_scan("\n".join(twin[2]))[stiff][solver] == twin[1][stiff][solver]["iters"]
    assert_probe_count(twin[1][stiff][solver]["iters"], want, stiff)


def test_main_prints_finite_lines(capsys):
    assert tw.main([str(GRID), "--device", "cpu", "--stiff", "1e3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "n=256 stencils=192" and out[1].startswith("device: cpu")
    assert parse_scan("\n".join(out)) == {1e3: {"static": 224, "general": 80, "jacobi": 568}}
    walls = [float(w) for w in out[3].replace("(", " ").split() if w[0].isdigit()]
    assert len(walls) == 6 and all(math.isfinite(w) and w > 0 for w in walls)
