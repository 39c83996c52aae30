"""Port vs JAX: collision stencils (ops/stencils.py) and their effect on the
general prepare.

Mirrors tests/test_stencils.py (flattening semantics cpp:304-413, rank-1
Hessian routing cpp:1164-1227, a dense single-domain oracle) and runs the
same sets through both packages: stencil ids, counts and masks, the
connectivity pairs and the collision-term routing are integer outputs and
match bit for bit; weights and Hessian terms within 1e-6; applies within
the JAX tests' own tolerances.
"""

import jax.numpy as jnp
import numpy as np
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import blockcsr as jbc
from precond_tpu.ops import stencils as jst
from precond_tpu.solver import SchwarzPreconditioner as JaxPre
from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner, convert
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops import blockcsr
from precond_tpu_torch.ops import stencils as st

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _sets(kind, a, b, stiff, bary, normal):
    """The same proximity set for both packages: (jax set, port set)."""
    fields = (np.asarray(a, np.int32), np.asarray(b, np.int32), np.asarray(stiff, np.float32),
              np.asarray(bary, np.float32), np.asarray(normal, np.float32))
    jcls = {"ef": jst.EfSets, "ee": jst.EeSets, "vf": jst.VfSets}[kind]
    conv = {"ef": convert.ef_sets_from_numpy, "ee": convert.ee_sets_from_numpy,
            "vf": convert.vf_sets_from_numpy}[kind]
    return jcls(*map(jnp.asarray, fields)), conv(*fields, device="cpu")


def _both(mesh, **sets):
    """build_stencils in both packages on the same sets."""
    js = jst.build_stencils(jnp.asarray(mesh.edges), jnp.asarray(mesh.faces),
                            **{k: v[0] for k, v in sets.items()})
    ts = st.build_stencils(torch.as_tensor(mesh.edges), torch.as_tensor(mesh.faces),
                           **{k: v[1] for k, v in sets.items()})
    return js, ts


def _assert_stencils_match(ts, js):
    for name, g, w in zip(js._fields, ts, js):
        w = _np(w)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6, err_msg=name)


def dense_stencil_hessian(n, sten):
    """Oracle: H_c = sum_s stiff * (w w^T) kron (d d^T) scattered to verts."""
    h = np.zeros((3 * n, 3 * n))
    idx, w, nv = np.asarray(sten.idx), np.asarray(sten.weight), np.asarray(sten.nverts)
    dirs, stiff, valid = np.asarray(sten.direction), np.asarray(sten.stiff), np.asarray(sten.valid)
    for s in range(idx.shape[0]):
        if not valid[s]:
            continue
        dd = stiff[s] * np.outer(dirs[s], dirs[s])
        for a in range(nv[s]):
            for b in range(nv[s]):
                ia, ib = idx[s, a], idx[s, b]
                h[3 * ia: 3 * ia + 3, 3 * ib: 3 * ib + 3] += w[s, a] * w[s, b] * dd
    return h


def test_flattening_weights():
    mesh = jcloth.make_grid(4, 4)
    js, s = _both(
        mesh,
        ef=_sets("ef", [0], [1], [7.0], [[0.3, 0.2, 0.4]], [[0.0, 0.0, 1.0]]),
        ee=_sets("ee", [0], [5], [5.0], [[0.25, 0.6]], [[0.0, 1.0, 0.0]]),
        vf=_sets("vf", [15], [2], [3.0], [[0.2, 0.3]], [[1.0, 0.0, 0.0]]),
    )
    assert s.count == 3
    w = s.weight.numpy()
    np.testing.assert_allclose(w[0, :5], [0.3, 0.7, -0.2, -0.4, -0.4], rtol=1e-6)   # EF
    np.testing.assert_allclose(w[1, :4], [0.25, 0.75, -0.6, -0.4], rtol=1e-6)       # EE
    # VF: the physically consistent -(1-b0-b1) third weight (PARITY.md)
    np.testing.assert_allclose(w[2, :4], [-0.2, -0.3, -0.5, 1.0], rtol=1e-6)
    np.testing.assert_array_equal(s.nfirst.numpy(), [2, 2, 3])
    np.testing.assert_array_equal(s.nverts.numpy(), [5, 4, 4])
    _assert_stencils_match(s, js)
    # negative ids are masked invalid; an id past the table reads the fill
    js2, s2 = _both(mesh, vf=_sets("vf", [-1, 3], [0, 10_000], [1.0, 1.0], [[0.1, 0.1]] * 2,
                                   [[0, 0, 1]] * 2))
    assert not bool(s2.valid[0])
    _assert_stencils_match(s2, js2)


def test_pairs_and_terms_match_jax():
    """stencil_pairs and collision_terms on mapped stencils: the pair ids
    and masks exactly, the Hessian terms within 1e-6 of the max."""
    mesh = jcloth.make_grid(8, 8)
    rng = np.random.default_rng(0)
    m = 12
    js, ts = _both(
        mesh,
        ef=_sets("ef", rng.integers(-1, 40, m), rng.integers(0, 98, m), rng.random(m) * 100,
                 rng.random((m, 3)) * 0.5, rng.standard_normal((m, 3))),
        ee=_sets("ee", rng.integers(0, 40, m), rng.integers(-1, 40, m), rng.random(m) * 100,
                 rng.random((m, 2)), rng.standard_normal((m, 3))),
        vf=_sets("vf", rng.integers(0, 64, m), rng.integers(0, 98, m), rng.random(m) * 100,
                 rng.random((m, 2)) * 0.5, rng.standard_normal((m, 3))),
    )
    o2s = rng.permutation(64).astype(np.int32)
    jm = js._replace(idx=jnp.where(
        js.valid[:, None] & (jnp.arange(5) < js.nverts[:, None]),
        jnp.take(jnp.asarray(o2s), jnp.clip(js.idx, 0, 63)), 0))
    tm = st.map_stencils(ts, torch.as_tensor(o2s))
    np.testing.assert_array_equal(tm.idx.numpy(), _np(jm.idx))
    for a, b in zip(st.stencil_pairs(tm), jst.stencil_pairs(jm)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    jt, tt = jst.collision_terms(jm), st.collision_terms(tm)
    for name, g, w in zip(jt._fields, tt, jt):
        w = _np(w)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)


def test_single_domain_exact_with_collisions():
    # 25 verts, one domain: apply must equal (H + H_collision)^{-1} exactly.
    mesh = jcloth.make_grid(5, 5, z_wave=0.02)
    n = mesh.num_verts
    js, sten = _both(
        mesh,
        ee=_sets("ee", [0], [30], [60.0], [[0.5, 0.5]], [[0.0, 1.0, 0.0]]),
        vf=_sets("vf", [24, 7], [0, 11], [50.0, 80.0], [[0.2, 0.5], [0.4, 0.3]],
                 [[0.0, 0.0, 1.0], [0.6, 0.8, 0.0]]),
    )
    ell = cloth.assemble_system(cloth.make_grid(5, 5, z_wave=0.02), device="cpu")
    pre = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(ell, sten)
    assert not bool(pre.state.overflow)

    h_sys = blockcsr.to_dense(ell).double().numpy() + dense_stencil_hessian(n, sten)
    r = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    z = pre.apply(r).numpy().reshape(-1)
    z_ref = np.linalg.solve(h_sys, r.reshape(-1).astype(np.float64))
    np.testing.assert_allclose(z, z_ref, rtol=3e-4, atol=1e-8)
    jpre = JaxPre(JaxConfig())
    jpre.allocate(mesh.positions)
    jpre.prepare(jcloth.assemble_system(mesh), js)
    zj = _np(jpre.apply(jnp.asarray(r))).reshape(-1)
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-6 * np.abs(zj).max())


def test_multilevel_collisions_spd_and_convergence():
    # 144 verts, 2 levels, cross-mesh contacts: M^{-1} stays symmetric PSD
    # and clusters the spectrum of H + H_c (long dt: stiffness-dominated).
    mesh = jcloth.make_grid(12, 12, z_wave=0.02, dt=0.5)
    n = mesh.num_verts
    rng = np.random.default_rng(3)
    js, sten = _both(mesh, vf=_sets("vf", [140, 3, 77], [0, 100, 30], [200.0, 150.0, 120.0],
                                    rng.random((3, 2), dtype=np.float32) * 0.4,
                                    [[0, 0, 1], [1, 0, 0], [0, 1, 0]]))
    ell = cloth.assemble_system(cloth.make_grid(12, 12, z_wave=0.02, dt=0.5), device="cpu")
    pre = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(ell, sten)
    assert not bool(pre.state.overflow)
    jpre = JaxPre(JaxConfig())
    jpre.allocate(mesh.positions)
    jpre.prepare(jcloth.assemble_system(mesh), js)
    np.testing.assert_array_equal(pre.state.going_next.numpy(), _np(jpre.state.going_next))

    h_sys = _np(jbc.to_dense(jcloth.assemble_system(mesh))).astype(np.float64) \
        + dense_stencil_hessian(n, sten)
    cols = []
    for i in range(3 * n):
        e = np.zeros((n, 3), np.float32)
        e[i // 3, i % 3] = 1.0
        cols.append(pre.apply(e).numpy().reshape(-1))
    minv = np.stack(cols, 1).astype(np.float64)
    assert np.abs(minv - minv.T).max() / np.abs(minv).max() < 1e-5
    evals = np.linalg.eigvalsh(0.5 * (minv + minv.T))
    assert evals.min() > -1e-10 * evals.max()
    ev = np.abs(np.linalg.eigvals(minv @ h_sys))
    ev_h = np.linalg.eigvalsh(h_sys)
    assert ev.max() / ev.min() < (ev_h.max() / ev_h.min()) / 3
