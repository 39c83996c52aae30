"""Port vs JAX: contact fill-in (ops/contact.py) and the collision placements
of the banked assembly.

Mirrors the general-path tests of tests/test_contact.py (the dense oracle,
the rank-1 and slot SpMV forms, the ELL budget, the forces, the assembly's
big placement against its small one) at their tolerances, and holds each
form against the JAX function on the same stencils: integer outputs
(contact-ELL rows, slots, masks, drop counts; ContactSlots.sid / bounds)
bit for bit, floats within the JAX tests' 5e-6 * max|y|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.models import collision as jcol
from precond_tpu.ops import assembly as jas
from precond_tpu.ops import blockcsr as jbc
from precond_tpu.ops import contact as jct
from precond_tpu.ops import hierarchy as jhi
from precond_tpu.ops import stencils as jst
from precond_tpu.solver import compute_sort_maps as jax_sort_maps
from precond_tpu_torch import SchwarzConfig, convert
from precond_tpu_torch.models import collision
from precond_tpu_torch.ops import assembly as tas
from precond_tpu_torch.ops import contact as tct
from precond_tpu_torch.ops import hierarchy as thi
from precond_tpu_torch.ops import stencils as tst

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _folded_positions(grid):
    mesh = jcloth.make_grid(grid, grid, z_wave=0.0, mass=0.002)
    h = 1.0 / (grid - 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    return mesh, p.astype(np.float32), h


@pytest.fixture(scope="module")
def fold():
    """tests/test_contact.py's _folded_stencils (16x16, VF + EE at 0.75 h,
    stiffness 1e3, budget 2n) in both packages: (jax stencils, port
    stencils, n). The port detects its own sets; they must equal JAX's."""
    grid = 16
    mesh, p, h = _folded_positions(grid)
    n = mesh.num_verts
    fj, ej, pj = jnp.asarray(mesh.faces), jnp.asarray(mesh.edges), jnp.asarray(p)
    vf, _ = jcol.detect_vf_grid(pj, fj, 0.75 * h, 1e3, 2 * n)
    ee, _ = jcol.detect_ee_grid(pj, ej, 0.75 * h, 1e3, 2 * n)
    js = jst.build_stencils(ej, fj, ee=ee, vf=vf)
    ft, et, pt = (torch.as_tensor(a) for a in (mesh.faces, mesh.edges, p))
    tvf, _ = collision.detect_vf_grid(pt, ft, 0.75 * h, 1e3, 2 * n)
    tee, _ = collision.detect_ee_grid(pt, et, 0.75 * h, 1e3, 2 * n)
    ts = tst.build_stencils(et, ft, ee=tee, vf=tvf)
    for name, g, w in zip(js._fields, ts, js):
        w = _np(w)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6, err_msg=name)
    assert int(ts.valid.sum()) > 0
    return js, ts, n


def _dense_oracle(st, n):
    """H_c = sum_s stiff (w w^T) (x) (d d^T), built directly from stencils."""
    idx, w, nv = np.asarray(st.idx), np.asarray(st.weight), np.asarray(st.nverts)
    stiff, d, valid = np.asarray(st.stiff), np.asarray(st.direction), np.asarray(st.valid)
    h = np.zeros((3 * n, 3 * n), np.float64)
    for s in range(idx.shape[0]):
        if not valid[s]:
            continue
        ddt = stiff[s] * np.outer(d[s], d[s])
        for a in range(nv[s]):
            for b in range(nv[s]):
                i, j = idx[s, a], idx[s, b]
                h[3 * i: 3 * i + 3, 3 * j: 3 * j + 3] += w[s, a] * w[s, b] * ddt
    return h


def _close(y, y_ref):
    scale = max(np.abs(y_ref).max(), 1e-12)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=5e-6 * scale)


def test_contact_ell_matches_dense_oracle(fold):
    js, ts, n = fold
    ce = tct.build_contact_ell(ts, n, kc=32)
    assert int(ce.dropped) == 0
    x = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    y_ref = (_dense_oracle(ts, n) @ x.reshape(-1).astype(np.float64)).reshape(n, 3)
    _close(tct.contact_spmv(ce, torch.as_tensor(x)).numpy(), y_ref)
    jce = jct.build_contact_ell(js, n, kc=32)
    for name, g, w in zip(jce._fields, ce, jce):
        w = _np(w)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
    _close(tct.contact_spmv(ce, torch.as_tensor(x)).numpy(),
           _np(jct.contact_spmv(jce, jnp.asarray(x))))


def test_stencil_contact_spmv_matches_dense_oracle(fold):
    js, ts, n = fold
    x = np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32)
    y_ref = (_dense_oracle(ts, n) @ x.reshape(-1).astype(np.float64)).reshape(n, 3)
    y = tct.stencil_contact_spmv(ts, torch.as_tensor(x)).numpy()
    _close(y, y_ref)
    _close(y, _np(jct.stencil_contact_spmv(js, jnp.asarray(x))))
    ce = tct.build_contact_ell(ts, n, kc=32)
    cd = tct.contact_diag(ts, n).numpy()
    np.testing.assert_allclose(cd, ce.diag.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(cd, _np(jct.contact_diag(js, n)), rtol=0, atol=1e-6)


def test_slot_contact_spmv_matches_dense_oracle(fold):
    """The scatter-free slot apply equals the dense H_c and the stencil form;
    its sorted-slot tables equal JAX's bit for bit."""
    js, ts, n = fold
    cs = tct.build_contact_slots(ts, n)
    jcs = jct.build_contact_slots(js, n)
    for name in ("ids", "sid", "bounds"):
        np.testing.assert_array_equal(getattr(cs, name).numpy(), _np(getattr(jcs, name)),
                                      err_msg=name)
    np.testing.assert_allclose(cs.wd.numpy(), _np(jcs.wd), rtol=0, atol=1e-6)
    x = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    y_ref = (_dense_oracle(ts, n) @ x.reshape(-1).astype(np.float64)).reshape(n, 3)
    y = tct.slot_contact_spmv(ts, cs, torch.as_tensor(x)).numpy()
    _close(y, y_ref)
    _close(y, tct.stencil_contact_spmv(ts, torch.as_tensor(x)).numpy())
    _close(y, _np(jct.slot_contact_spmv(js, jcs, jnp.asarray(x))))
    yt = tct.slot_contact_spmv_t(cs, torch.as_tensor(x.T.copy())).numpy()
    np.testing.assert_array_equal(yt, y.T)
    # the slot apply repeats bit for bit
    assert torch.equal(tct.slot_contact_spmv(ts, cs, torch.as_tensor(x)),
                       tct.slot_contact_spmv(ts, cs, torch.as_tensor(x)))


def test_contact_ell_budget_drops_counted(fold):
    js, ts, n = fold
    ce = tct.build_contact_ell(ts, n, kc=1)
    assert int(ce.dropped) > 0
    assert int(ce.dropped) == int(jct.build_contact_ell(js, n, kc=1).dropped)
    small = tct.build_contact_ell(ts, n, kc=4, max_rows=40)
    jsmall = jct.build_contact_ell(js, n, kc=4, max_rows=40)
    assert int(small.dropped) == int(jsmall.dropped) > 0
    np.testing.assert_array_equal(small.rows.numpy(), _np(jsmall.rows))


def _penalty_energy(st, x, rest_gap):
    """Reference energy: 1/2 sum_s stiff * max(rest_gap - g_s, 0)^2."""
    idx, w, nv = np.asarray(st.idx), np.asarray(st.weight), np.asarray(st.nverts)
    stiff, valid = np.asarray(st.stiff), np.asarray(st.valid)
    d = np.asarray(st.direction).astype(np.float64)
    e = 0.0
    for s in range(idx.shape[0]):
        if not valid[s]:
            continue
        g = sum(w[s, a] * d[s] @ x[idx[s, a]] for a in range(nv[s]))
        e += 0.5 * stiff[s] * max(rest_gap - g, 0.0) ** 2
    return e


def test_contact_forces_match_energy_gradient(fold):
    js, ts, n = fold
    rest = 0.75 / 15
    rng = np.random.default_rng(1)
    p = np.asarray(jcloth.make_grid(16, 16, z_wave=0.0, mass=0.002).positions).astype(np.float64)
    p += 1e-4 * rng.standard_normal(p.shape)
    f = tct.contact_forces(ts, torch.as_tensor(p.astype(np.float32)), rest).numpy()
    np.testing.assert_allclose(f.sum(axis=0), 0.0, atol=2e-4 * np.abs(f).max())
    _close(f, _np(jct.contact_forces(js, jnp.asarray(p.astype(np.float32)), rest)))
    eps = 1e-5
    for v in rng.choice(n, size=8, replace=False):
        for k in range(3):
            pp, pm = p.copy(), p.copy()
            pp[v, k] += eps
            pm[v, k] -= eps
            g = -(_penalty_energy(ts, pp, rest) - _penalty_energy(ts, pm, rest)) / (2 * eps)
            assert abs(f[v, k] - g) < 5e-3 * max(np.abs(f).max(), 1.0), (v, k, f[v, k], g)


def test_contact_forces_push_apart(fold):
    js, ts, n = fold
    mesh, p, h = _folded_positions(16)
    fold_mask = np.asarray(mesh.positions)[:, 0] > 0.5
    f = tct.contact_forces(ts, torch.as_tensor(p), 0.75 * h).numpy()
    assert np.abs(f).max() > 0
    upper = fold_mask & (np.abs(f).max(axis=1) > 1e-6)
    lower = ~fold_mask & (np.abs(f).max(axis=1) > 1e-6)
    assert f[upper, 2].mean() > 0
    assert f[lower, 2].mean() < 0


def _pad_terms(terms, extra):
    """Append `extra` INVALID pair rows (crosses the big-path threshold
    without changing the operator)."""
    z = terms.pair_a.new_zeros(extra)
    return terms._replace(
        pair_a=torch.cat([terms.pair_a, z]), pair_b=torch.cat([terms.pair_b, z]),
        pair_mat=torch.cat([terms.pair_mat, terms.pair_mat.new_zeros((extra, 3, 3))]),
        pair_valid=torch.cat([terms.pair_valid, z.bool()]),
    )


@pytest.fixture(scope="module")
def sorted_system(fold):
    """The fold's system in sorted space with its stencil pairs and terms,
    in both packages."""
    js, ts, n = fold
    mesh, _, _ = _folded_positions(16)
    jmesh = jcloth.make_grid(16, 16, z_wave=0.0, mass=0.001)
    ell = jcloth.assemble_system(jmesh)
    maps = jax_sort_maps(jnp.asarray(jmesh.positions))
    es = jbc.permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    jm = js._replace(idx=jnp.where(js.valid[:, None] & (jnp.arange(5) < js.nverts[:, None]),
                                   jnp.take(maps.orig_to_sorted, jnp.clip(js.idx, 0, n - 1)), 0))
    tes = convert.block_ell_from_numpy(*(_np(a) for a in es), device="cpu")
    tm = tst.map_stencils(ts, torch.as_tensor(_np(maps.orig_to_sorted)))
    return es, jm, tes, tm


def test_assembly_collision_big_path_matches_small(sorted_system):
    """assemble_banked_hessian with the padded (big) collision set equals the
    small-set placement, and each equals the JAX assembly."""
    es, jm, tes, tm = sorted_system
    cfg = SchwarzConfig()
    th, tmm = thi.build_hierarchy(tes.idx, tes.mask, cfg, tst.stencil_pairs(tm),
                                  with_merge_map=True)
    terms = tst.collision_terms(tm)
    assert terms.pair_a.shape[0] <= tas.BIG_PAIR_THRESHOLD, "small-path precondition"
    h_small = tas.assemble_banked_hessian(tes, th, cfg, terms, merge_map=tmm).numpy()
    big = _pad_terms(terms, 40000 - terms.pair_a.shape[0])
    h_big = tas.assemble_banked_hessian(tes, th, cfg, big, merge_map=tmm).numpy()
    scale = max(np.abs(h_small).max(), 1e-12)
    np.testing.assert_allclose(h_big, h_small, rtol=0, atol=1e-6 * scale)

    jh, jmm = jhi.build_hierarchy(es.idx, es.mask, JaxConfig(), jst.stencil_pairs(jm),
                                  with_merge_map=True)
    want = _np(jas.assemble_banked_hessian(es, jh, JaxConfig(), jst.collision_terms(jm),
                                           merge_map=jmm))
    np.testing.assert_allclose(h_small, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(h_big, want, rtol=0, atol=1e-6 * np.abs(want).max())
