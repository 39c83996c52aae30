"""The port's twin of scripts/probe_contact.py
(scripts/torch_probe_contact.py) against the JAX functions that script
calls, on the CPU at 16^2, on the same folded sheet at stiffness 1e3
(the JAX side built by scripts/jax_probe_record.py's `sheet`, the
script's recipe with detection op by op):

  * the stencils (integers bit for bit, floats within 1e-6);
  * collision_terms of the stencils mapped to the tile order,
    grid_collision_terms (rows and fine diagonals within 1e-6 * max, as
    tests/test_torch_gridcontact.py), build_contact_slots (the sorted-slot
    tables bit for bit, floats within 1e-6);
  * the three contact SpMV forms (contact ELL with kc 32, rank-1 scatter,
    slots) within 5e-6 * max|y| (the JAX contact tests' tolerance);
  * the iterations of the static and the general M to 1e-4
    (check_every 8), equal to the JAX record's (jax_probe_record.contact);
  * the composed loop's scatter and slots forms agree (the same operator,
    rounded differently: rtol 1e-4, atol 1e-4 * max|x| after K = 2, the
    dissection tests' chained tolerance);
  * the JAX script's section 1 ends at its line 143, which reads
    ContactSlots.w; the field is w5 (read from the source: running the
    script would point JAX's compilation cache at /tmp for the process);
  * the twin's main runs end to end at 16^2 and prints finite lines.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_support import SCRIPTS, line_names, np_

import jax_probe_record as jr
from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.ops import contact as jct
from precond_tpu.ops.gridassembly import grid_collision_terms as jax_grid_terms
from precond_tpu.ops.stencils import collision_terms as jax_terms
from precond_tpu_torch.ops.gridassembly import grid_collision_terms
from precond_tpu_torch.ops.stencils import collision_terms, map_stencils

import torch_probe_contact as tw

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRID = 16
SPMV_RTOL = 5e-6
CHAINED_RTOL = 1e-4
LINES = ["prepare_grid plain", "prepare_grid +stencils", "collision_terms", "grid_collision_terms",
         "build_contact_ell", "build_contact_slots"]


@pytest.fixture(scope="module")
def sheets():
    j = jr.sheet(GRID, tw.STIFFNESS)
    return j, tw.setup(GRID, CPU)


def _same(got, want, name):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


def test_stencils(sheets):
    j, s = sheets
    assert s.live == j["live"] == 192
    for name, got, want in zip(j["st"]._fields, s.st, j["st"]):
        _same(got, want, name)


def _jax_mapped(st, o2s, n):
    """probe_contact.py:122-128's map_st."""
    return st._replace(idx=jnp.where(st.valid[:, None] & (jnp.arange(5) < st.nverts[:, None]),
                                     jnp.take(o2s, jnp.clip(st.idx, 0, n - 1)), 0))


def test_collision_and_grid_terms(sheets):
    j, s = sheets
    jt = jax_terms(_jax_mapped(j["st"], j["maps"].orig_to_sorted, j["n"]))
    tt = collision_terms(map_stencils(s.st, s.maps.orig_to_sorted))
    for name, got, want in zip(jt._fields, tt, jt):
        scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
        if np.asarray(want).dtype.kind in "iub":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * scale,
                                       err_msg=name)
    jrows, jdg = jax.jit(lambda t: jax_grid_terms(t, JaxConfig(), j["n"]))(jt)
    rows, dg = grid_collision_terms(tt, s.cfg, s.n)
    scale = float(np.abs(np_(jrows)).max())
    assert scale > 0
    np.testing.assert_allclose(rows.numpy(), np_(jrows), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(dg.numpy(), np_(jdg), rtol=0, atol=1e-6 * scale)


def test_contact_slots(sheets):
    j, s = sheets
    jcs = jct.build_contact_slots(j["st"], j["n"])
    for name in jcs._fields:
        _same(getattr(s.cs, name), getattr(jcs, name), name)


@pytest.mark.parametrize("form", ["ell", "scatter", "slots"])
def test_spmv_forms(sheets, form):
    j, s = sheets
    x = np.random.default_rng(3).standard_normal((s.n, 3)).astype(np.float32)
    st, n, xj = j["st"], j["n"], jnp.asarray(x)
    want = {"ell": lambda: jct.contact_spmv(
                jax.jit(lambda t: jct.build_contact_ell(t, n, kc=tw.KC))(st), xj),
            "scatter": lambda: jct.stencil_contact_spmv(st, xj),
            "slots": lambda: jct.slot_contact_spmv(st, jct.build_contact_slots(st, n), xj)}[form]()
    ys = tw.spmv_forms(s, torch.as_tensor(x))
    assert int(s.ce.dropped) == 0
    for got in (ys[form], ys["slots"]):
        np.testing.assert_allclose(got.numpy(), np_(want), rtol=0,
                                   atol=SPMV_RTOL * float(np.abs(np_(want)).max()))


def test_solves_match_jax_record(sheets):
    _, s = sheets
    want = jr.contact(GRID)
    lines = []
    out = tw.solves(s, log=lines.append)
    for name in ("static", "general"):
        assert out[name]["iters"] == want[name], (name, out[name]["iters"], want[name])
        assert out[name]["rel"] <= 1e-4
    assert [ln.split()[0] for ln in lines] == ["solve[static", "prepare", "solve[general"]


def test_composed_loop_forms(sheets):
    _, s = sheets
    s.inv = tw.prepare_walls(s, log=lambda m: None)["prepare_grid +stencils"]["out"]
    assert not tw.is_cm(s.inv)
    xs = {f: tw.k_iterations(s, f, 2) for f in tw.FORMS}
    ref = xs["slots"]
    np.testing.assert_allclose(xs["scatter"].numpy(), ref.numpy(), rtol=CHAINED_RTOL,
                               atol=CHAINED_RTOL * float(ref.abs().max()))
    assert float((xs["none"] - ref).abs().max()) > CHAINED_RTOL * float(ref.abs().max())
    assert torch.equal(tw.k_iterations(s, "slots", 2), ref)


def test_jax_script_faults_at_line_143():
    path = f"{SCRIPTS}/probe_contact.py"
    with open(path) as f:
        lines = f.read().splitlines()
    assert "fetch=lambda o: o.w[:1])" in lines[142]
    assert "w" not in jct.ContactSlots._fields and "w5" in jct.ContactSlots._fields
    from precond_tpu_torch.ops.contact import ContactSlots

    assert "w5" in ContactSlots._fields


def test_main_prints_finite_lines(capsys):
    assert tw.main([str(GRID), "--device", "cpu", "--k", "2"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "n=256 stencils=192 (slots=960)" and lines[1].startswith("device: cpu")
    stripped = "\n".join(ln.strip() for ln in lines)
    assert line_names(stripped, LINES) == LINES
    ms = [float(ln.split()[-5]) for ln in lines if ln.strip().split(" ")[0] in
          ("prepare_grid", "collision_terms", "grid_collision_terms", "build_contact_ell",
           "build_contact_slots", "iter[none", "iter[scatter]", "iter[slots")]
    assert len(ms) == 9 and all(math.isfinite(v) and v > 0 for v in ms)
    assert "static inv type: Tensor (cm=False)" in lines
    assert "solve[static M]   iters=224 " in out and "solve[general M]  iters=224 " in out
