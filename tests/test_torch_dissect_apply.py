"""The port's twins of the JAX package's apply dissections, on the CPU at
16^2 (K = 2): scripts/torch_profile_apply.py against profile_apply.py and
scripts/torch_profile_apply_fine.py against profile_apply_fine.py.

Each JAX script runs with BENCH_GRID and PROF_K set; its components (the
lambdas it hands to its timing calls, tests/dissect_support) are applied
once to the script's own inputs, and the twin's component of the same
name to those inputs carried through convert.py. Tolerance: the JAX
package's apply tolerance, rtol 1e-5 and atol 1e-6 * max|z|
(tests/test_torch_apply.py:49). Each twin prints the JAX script's line
names, in its order.
"""

import numpy as np
import pytest
import torch

from dissect_support import close, closure, jax_script, line_names, np_, twin_lines

from precond_tpu_torch import convert

import torch_profile_apply as tw_apply
import torch_profile_apply_fine as tw_fine

torch.set_num_threads(2)

CPU = torch.device("cpu")
ENV = {"BENCH_GRID": 16, "PROF_K": 2}


def _state(j):
    return convert.apply_state_from_numpy(**{k: np_(v) for k, v in j._asdict().items()},
                                          device="cpu")


def _ell(j):
    return convert.block_ell_from_numpy(np_(j.diag), np_(j.idx), np_(j.blocks), np_(j.mask),
                                        device="cpu")


def _ssys(j):
    return convert.stencil_system_from_numpy(np_(j.diag_t), np_(j.dirs_t), j.offsets, j.grid,
                                             sym=j.sym, device="cpu")


@pytest.fixture(scope="module")
def apply_run():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("profile_apply", mp, ENV)
    g = run.g
    # the first jitted function prepares; then one chain per timed component
    ops = [closure(f, "op") for f in run.jitted[1:]]
    assert len(ops) == len(tw_apply.COMPONENTS)
    jargs = {"r0_11": g["r0"][:1, :1], "inv": g["inv"], "r0": g["r0"], "mr0": g["mr0"],
             "state": g["state"], "ssys": g["ssys"], "ells": g["ells"], "r0x2": g["r0"] * 2.0}
    targs = {k: torch.as_tensor(np_(jargs[k])) for k in ("r0_11", "inv", "r0", "mr0", "r0x2")}
    targs.update(state=_state(g["state"]), ssys=_ssys(g["ssys"]), ells=_ell(g["ells"]))
    return run, ops, jargs, targs, tw_apply.setup(16, CPU)


@pytest.fixture(scope="module")
def fine_run():
    with pytest.MonkeyPatch.context() as mp:
        run = jax_script("profile_apply_fine", mp, ENV)
    g = run.g
    ops = [closure(f, "fn") for f in run.jitted[1:]]
    assert len(ops) == len(tw_fine.COMPONENTS)
    st = _state(g["state"])
    targs = {"r0": torch.as_tensor(np_(g["r0"])), "mr0": torch.as_tensor(np_(g["mr0"])),
             "state": st, "inv": st.inv96}
    jargs = {"r0": g["r0"], "mr0": g["mr0"], "state": g["state"], "inv": g["state"].inv96}
    return run, ops, jargs, targs, tw_fine.setup(16, CPU)


def test_apply_setup_matches(apply_run):
    """The twin's own setup draws the JAX script's r0 / mr0 and prepares
    the same hierarchy on the same Morton order."""
    run, _, _, targs, s = apply_run
    np.testing.assert_array_equal(s.r0.numpy(), targs["r0"].numpy())
    np.testing.assert_array_equal(s.mr0.numpy(), targs["mr0"].numpy())
    for field in ("sorted_to_orig", "going_next", "restrict_pb"):
        np.testing.assert_array_equal(getattr(s.state, field).numpy(),
                                      getattr(targs["state"], field).numpy())


@pytest.mark.parametrize("i", range(len(tw_apply.COMPONENTS)),
                         ids=[c[0] for c in tw_apply.COMPONENTS])
def test_apply_component(apply_run, i):
    _, ops, jargs, targs, s = apply_run
    _, fn, names = tw_apply.COMPONENTS[i]
    want = ops[i](*[jargs[a] for a in names])
    got = fn(s, *[targs[a] for a in names])
    close(got.numpy(), np_(want))


def test_apply_names(apply_run, monkeypatch, capsys):
    run = apply_run[0]
    names = [c[0] for c in tw_apply.COMPONENTS]
    out = twin_lines(tw_apply, monkeypatch, capsys, ENV)
    assert line_names(out, names) == line_names(run.out, names) == names
    assert out.splitlines()[0] == run.out.splitlines()[0]


def test_apply_fine_setup_matches(fine_run):
    """The twin's own setup draws the JAX script's inputs and prepares on
    the same tile order."""
    _, _, _, targs, s = fine_run
    np.testing.assert_array_equal(s.r0.numpy(), targs["r0"].numpy())
    np.testing.assert_array_equal(s.mr0.numpy(), targs["mr0"].numpy())
    for field in ("sorted_to_orig", "going_next", "restrict_pb"):
        np.testing.assert_array_equal(getattr(s.state, field).numpy(),
                                      getattr(targs["state"], field).numpy())


@pytest.mark.parametrize("i", range(len(tw_fine.COMPONENTS)),
                         ids=[c[0] for c in tw_fine.COMPONENTS])
def test_apply_fine_component(fine_run, i):
    _, ops, jargs, targs, s = fine_run
    _, fn, names = tw_fine.COMPONENTS[i]
    want = ops[i](*[jargs[a] for a in names])
    got = fn(s, *[targs[a] for a in names])
    close(got.numpy(), np_(want))


def test_apply_fine_names(fine_run, monkeypatch, capsys):
    run = fine_run[0]
    names = [c[0] for c in tw_fine.COMPONENTS]
    out = twin_lines(tw_fine, monkeypatch, capsys, ENV)
    assert line_names(out, names) == line_names(run.out, names) == names
    assert out.splitlines()[0] == run.out.splitlines()[0]
