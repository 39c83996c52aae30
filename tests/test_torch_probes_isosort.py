"""The port's twin of scripts/probe_isosort.py
(scripts/torch_probe_isosort.py) against the JAX script, on the CPU at
16^2.

The JAX script's line 85 calls compute_sort_maps(pj) for its "per-axis"
column, but that call defaults to the isotropic sort, the same as its
iso_maps (checked below), so as written its two columns are one sort. The
JAX script runs here in-process with its compute_sort_maps bound to the
JAX function with "per_axis" passed, which is what that line meant, and
the twin's "axis" column (compute_sort_maps(pos, "per_axis") in the port)
is held to it. Each column's iterations equal the JAX script's at
stiffness 1e3 and lie in chip_smoke.py's [contact probes] band above it
(chip_smoke.PROBE_BANDS); the per-axis column differs from the isotropic
one at every stiffness, in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_support import assert_probe_count, jax_script, parse_scan, run_main

from precond_tpu.solver import compute_sort_maps as jax_sort_maps

import torch_probe_common as pc
import torch_probe_isosort as tw

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRID = 16
COLUMNS = ("axis", "iso", "jacobi")


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("probe_isosort", mp, {})
        run.g["compute_sort_maps"] = lambda p: jax_sort_maps(p, "per_axis")
        run_main(run, [GRID])
    return run


@pytest.fixture(scope="module")
def twin():
    s = pc.setup(GRID, CPU)
    lines = []
    return s, tw.run(s, pc.STIFFNESS, log=lines.append), lines


def test_jax_line_85_is_the_isotropic_sort(jax_run, twin):
    """As written, the JAX script's "per-axis" maps are its iso_maps; the
    port's two sorts on the same positions are the JAX package's."""
    pj = jnp.asarray(twin[0].pos.numpy())
    default, iso = jax_sort_maps(pj), jax_run.g["iso_maps"](pj)
    np.testing.assert_array_equal(np.asarray(default.sorted_to_orig), np.asarray(iso.sorted_to_orig))
    from precond_tpu_torch.solver import compute_sort_maps

    for norm in ("per_axis", "isotropic"):
        np.testing.assert_array_equal(compute_sort_maps(twin[0].pos, norm).sorted_to_orig.numpy(),
                                      np.asarray(jax_sort_maps(pj, norm).sorted_to_orig))


@pytest.mark.parametrize("col", COLUMNS)
@pytest.mark.parametrize("stiff", pc.STIFFNESS)
def test_iterations(jax_run, twin, stiff, col):
    _, out, lines = twin
    assert parse_scan("\n".join(lines))[stiff][col] == out[stiff][col]["iters"]
    assert_probe_count(out[stiff][col]["iters"], parse_scan(jax_run.out)[stiff][col], stiff)


@pytest.mark.parametrize("stiff", pc.STIFFNESS)
def test_per_axis_differs_from_iso(jax_run, twin, stiff):
    jrow, row = parse_scan(jax_run.out)[stiff], twin[1][stiff]
    assert jrow["axis"] != jrow["iso"]
    assert row["axis"]["iters"] != row["iso"]["iters"]
    assert row["axis"]["iters"] > row["iso"]["iters"]


def test_main_prints_finite_lines(capsys):
    assert tw.main([str(GRID), "--device", "cpu", "--stiff", "1e3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "n=256 stencils=192" and out[1].startswith("device: cpu")
    assert parse_scan("\n".join(out)) == {1e3: {"axis": 200, "iso": 80, "jacobi": 568}}
    walls = [float(w) for w in out[3].replace("(", " ").split() if w[0].isdigit()]
    assert len(walls) == 6 and all(np.isfinite(w) and w > 0 for w in walls)
