"""The port's twin of scripts/probe_damping.py
(scripts/torch_probe_damping.py) against the JAX script, on the CPU at
16^2.

  * the iterations of each theta and of block-Jacobi against the JAX
    script's own run at 16^2: equal at stiffness 1e3, in chip_smoke.py's
    [contact probes] band above it (chip_smoke.PROBE_BANDS);
  * the twin's precondition_grid_damped against the JAX script's on the
    same inverse and residual, and against gridapply.precondition_grid
    with SchwarzConfig.coarse_damping = theta: all three compute
    z0 + theta * sum_{l>=1} z_l, the last summing the coarse levels before
    it scales them, so they agree to f32 rounding, held at the JAX
    package's apply tolerance (rtol 1e-5, atol 1e-6 * max|z|,
    tests/test_torch_apply.py:49).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_support import assert_probe_count, close, jax_script, np_, parse_scan, run_main

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu_torch.ops.gridapply import precondition_grid
from precond_tpu_torch.solver import prepare_grid

import torch_probe_common as pc
import torch_probe_damping as tw

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRID = 16
COLUMNS = tw.THETAS + ("jacobi",)


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("probe_damping", mp, {})
        run_main(run, [GRID])
    return run


@pytest.fixture(scope="module")
def sheet():
    return pc.setup(GRID, CPU)


@pytest.fixture(scope="module")
def twin(sheet):
    lines = []
    return tw.run(sheet, pc.STIFFNESS, log=lines.append), lines


@pytest.mark.parametrize("col", COLUMNS)
@pytest.mark.parametrize("stiff", pc.STIFFNESS)
def test_iterations(jax_run, twin, stiff, col):
    out, lines = twin
    assert parse_scan("\n".join(lines))[stiff][col] == out[stiff][col]["iters"]
    assert_probe_count(out[stiff][col]["iters"], parse_scan(jax_run.out)[stiff][col], stiff)


@pytest.fixture(scope="module")
def applied(sheet):
    """The static inverse at stiffness 1e4 (the twin's prepare) and a
    residual in tile order."""
    cfg = tw.config()
    st = pc.with_stiffness(sheet.st, 1e4)
    inv = prepare_grid(sheet.dgr, sheet.drr, sheet.offsets, sheet.k, cfg, st,
                       sheet.maps.orig_to_sorted)
    r = np.random.default_rng(5).standard_normal((sheet.n, 3)).astype(np.float32)
    return cfg, inv, r


@pytest.mark.parametrize("theta", tw.THETAS)
def test_damped_apply_matches_jax(jax_run, applied, theta):
    cfg, inv, r = applied
    jcfg = dataclasses.replace(JaxConfig(), solve_layout="rows", symv_kernel="dense")
    want = jax_run.g["precondition_grid_damped"](jnp.asarray(inv.numpy()), jnp.asarray(r), jcfg,
                                                 theta)
    close(tw.precondition_grid_damped(inv, torch.as_tensor(r), cfg, theta).numpy(), np_(want))


@pytest.mark.parametrize("theta", tw.THETAS)
def test_damped_apply_is_coarse_damping(applied, theta):
    cfg, inv, r = applied
    got = tw.precondition_grid_damped(inv, torch.as_tensor(r), cfg, theta)
    want = precondition_grid(inv, torch.as_tensor(r), dataclasses.replace(cfg, coarse_damping=theta))
    close(got.numpy(), want.numpy())
    if theta == 1.0:
        assert not torch.equal(got, precondition_grid(
            inv, torch.as_tensor(r), dataclasses.replace(cfg, coarse_damping=0.5)))


def test_main_prints_finite_lines(capsys):
    assert tw.main([str(GRID), "--device", "cpu", "--stiff", "1e3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "n=256 stencils=192" and out[1].startswith("device: cpu")
    assert parse_scan("\n".join(out)) == {1e3: {1.0: 224, 0.5: 200, 0.25: 200, 0.125: 200,
                                                 "jacobi": 568}}
    walls = [float(w) for w in out[3].replace("(", " ").split() if w[0].isdigit()]
    assert len(walls) == 10 and all(np.isfinite(w) and w > 0 for w in walls)
