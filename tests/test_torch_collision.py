"""Port vs JAX: proximity detection (models/collision.py, models/hashgrid.py).

Mirrors tests/test_collision.py case for case, and runs the same inputs
through both packages. Integer outputs (hash-grid keys and order, detected
ids, truncation flags and dropped counts) must match bit for bit; the
geometry follows the JAX formulas term for term (see the port's _norm), so
the floats (bary, normals) match within 1e-6. Tie-breaking follows
jax.lax.top_k (lower index first).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.models import collision as jcol
from precond_tpu.models import hashgrid as jhg
from precond_tpu.ops import stencils as jst
from precond_tpu.solver import SchwarzPreconditioner as JaxPre
from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
from precond_tpu_torch.models import cloth, collision
from precond_tpu_torch.models import hashgrid as thg
from precond_tpu_torch.ops import stencils as st

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _t(a):
    return torch.as_tensor(np.array(a))


def assert_sets_match(got, want, atol=1e-6):
    """Port set vs JAX set: integer fields exactly, float fields within atol."""
    for name, g, w in zip(want._fields, got, want):
        w = _np(w)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)


def _two_layer(n=10, gap=0.012):
    m1 = jcloth.make_grid(n, n)
    n1 = m1.num_verts
    pos = np.concatenate([m1.positions, m1.positions + [0, 0, gap]]).astype(np.float32)
    faces = np.concatenate([m1.faces, m1.faces + n1]).astype(np.int32)
    edges = np.concatenate(
        [m1.edges, np.where(m1.edges >= 0, m1.edges + n1, -1)]
    ).astype(np.int32)
    return pos, edges, faces


def _pair_set(ids_a, ids_b):
    a, b = np.asarray(ids_a), np.asarray(ids_b)
    ok = (a >= 0) & (b >= 0)
    return set(zip(a[ok].tolist(), b[ok].tolist()))


def _fold(grid=16, jitter=0.05, seed=0):
    """The bench's folded sheet, jittered by `jitter` grid spacings."""
    mesh = jcloth.make_grid(grid, grid, z_wave=0.0, mass=1e-3)
    h = 1.0 / (grid - 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    p = p + np.random.default_rng(seed).normal(0, jitter * h, p.shape)
    return mesh, p.astype(np.float32), h


# ---- closest-point geometry --------------------------------------------------

def test_point_triangle_closest():
    a, b, c = _t([0.0, 0.0, 0.0]), _t([1.0, 0.0, 0.0]), _t([0.0, 1.0, 0.0])
    bary, q = collision.point_triangle_closest(_t([0.25, 0.25, 1.0]), a, b, c)
    np.testing.assert_allclose(q.numpy(), [0.25, 0.25, 0.0], atol=1e-6)
    np.testing.assert_allclose(bary.numpy(), [0.5, 0.25, 0.25], atol=1e-6)
    _, q = collision.point_triangle_closest(_t([-1.0, -1.0, 0.5]), a, b, c)
    np.testing.assert_allclose(q.numpy(), [0.0, 0.0, 0.0], atol=1e-6)
    _, q = collision.point_triangle_closest(_t([0.5, -2.0, 0.0]), a, b, c)
    np.testing.assert_allclose(q.numpy(), [0.5, 0.0, 0.0], atol=1e-6)
    # every region, against JAX, on random points and triangles
    rng = np.random.default_rng(0)
    p, ta, tb, tc = (rng.standard_normal((500, 3)).astype(np.float32) for _ in range(4))
    jb, jq = jcol.point_triangle_closest(*map(jnp.asarray, (p, ta, tb, tc)))
    tbary, tq = collision.point_triangle_closest(*map(torch.as_tensor, (p, ta, tb, tc)))
    np.testing.assert_array_equal(tbary.numpy(), _np(jb))
    np.testing.assert_array_equal(tq.numpy(), _np(jq))


def test_segment_segment_closest():
    s, t = collision.segment_segment_closest(
        _t([0.0, 0.0, 0.0]), _t([1.0, 0.0, 0.0]), _t([0.5, 1.0, 1.0]), _t([0.5, -1.0, 1.0]))
    np.testing.assert_allclose(float(s), 0.5, atol=1e-6)
    np.testing.assert_allclose(float(t), 0.5, atol=1e-6)
    rng = np.random.default_rng(1)
    segs = [rng.standard_normal((500, 3)).astype(np.float32) for _ in range(4)]
    segs[3][:50] = segs[2][:50]  # degenerate second segments
    js, jt = jcol.segment_segment_closest(*map(jnp.asarray, segs))
    ts, tt = collision.segment_segment_closest(*map(torch.as_tensor, segs))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(tt.numpy(), _np(jt))


def test_detect_vf_finds_nearby_vertex():
    mesh = cloth.make_grid(4, 4)
    pos = np.concatenate([mesh.positions, [[0.45, 0.45, 0.01]]]).astype(np.float32)
    vf = collision.detect_vf(_t(pos), _t(mesh.faces), 0.05, 100.0, 8)
    found = vf.v_id.numpy()
    assert (found == 16).any()
    ok = found >= 0
    np.testing.assert_allclose(np.linalg.norm(vf.normal.numpy()[ok], axis=1), 1.0, atol=1e-5)
    jvf = jcol.detect_vf(jnp.asarray(pos), jnp.asarray(mesh.faces), 0.05, 100.0, 8)
    assert_sets_match(vf, jvf)


def test_detect_to_prepare_roundtrip():
    """Two stacked sheets: detection feeds stencils, prepare ingests them,
    and the port's apply matches the JAX package's on the same sets."""
    m1 = jcloth.make_grid(6, 6)
    n1 = m1.num_verts
    pos = np.concatenate([m1.positions, m1.positions + [0, 0, 0.012]]).astype(np.float32)
    faces = np.concatenate([m1.faces, m1.faces + n1]).astype(np.int32)
    edges = np.concatenate([m1.edges, np.where(m1.edges >= 0, m1.edges + n1, -1)]).astype(np.int32)
    springs = np.concatenate([m1.springs, m1.springs + n1])
    stiffness = np.concatenate([m1.stiffness, m1.stiffness])
    jmesh = jcloth.ClothMesh(pos, edges, faces, springs, stiffness, m1.mass, m1.dt)
    tmesh = cloth.ClothMesh(pos, edges, faces, springs, stiffness, m1.mass, m1.dt)

    jvf = jcol.detect_vf(jnp.asarray(pos), jnp.asarray(faces), 0.02, 500.0, 64)
    vf = collision.detect_vf(_t(pos), _t(faces), 0.02, 500.0, 64)
    assert_sets_match(vf, jvf)
    assert int((vf.v_id >= 0).sum()) > 0
    sten = st.build_stencils(_t(edges), _t(faces), vf=vf)

    pre = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    pre.allocate(pos)
    pre.prepare(cloth.assemble_system(tmesh, device="cpu"), sten)
    assert not bool(pre.state.overflow)
    jpre = JaxPre(JaxConfig())
    jpre.allocate(pos)
    jpre.prepare(jcloth.assemble_system(jmesh),
                 jst.build_stencils(jnp.asarray(edges), jnp.asarray(faces), vf=jvf))
    r = np.random.default_rng(0).standard_normal((2 * n1, 3)).astype(np.float32)
    z = pre.apply(r).numpy()
    zj = _np(jpre.apply(jnp.asarray(r)))
    assert np.all(np.isfinite(z))
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-6 * np.abs(zj).max())


# ---- hash-grid broad phase -----------------------------------------------------

def test_hashgrid_build_and_query_exact():
    pos, _, faces = _two_layer()
    cen = pos[faces[:, :3]].mean(axis=1).astype(np.float32)
    jg = jhg.build_grid(jnp.asarray(cen), 0.05)
    tg = thg.build_grid(torch.as_tensor(cen), 0.05)
    for name in jg._fields:
        np.testing.assert_array_equal(getattr(tg, name).numpy(), _np(getattr(jg, name)), err_msg=name)
    for cap in (2, 8):
        jq = jhg.query(jg, jnp.asarray(pos), cap)
        tq = thg.query(tg, torch.as_tensor(pos), cap)
        for a, b in zip(tq, jq):
            np.testing.assert_array_equal(a.numpy(), _np(b))
    assert bool(tq[2]) is False and bool(thg.query(tg, torch.as_tensor(pos), 1)[2]) is True


def test_vf_grid_matches_bruteforce():
    pos, edges, faces = _two_layer()
    vf_b = collision.detect_vf(_t(pos), _t(faces), 0.02, 1.0, 4096)
    vf_g, info = collision.detect_vf_grid(_t(pos), _t(faces), 0.02, 1.0, 4096,
                                          per_vertex_cap=32, cell_cap=16)
    assert not bool(info.truncated)
    assert int(info.dropped) == 0
    assert _pair_set(vf_g.v_id, vf_g.f_id) == _pair_set(vf_b.v_id, vf_b.f_id)
    ok = vf_g.v_id.numpy() >= 0
    np.testing.assert_allclose(np.linalg.norm(vf_g.normal.numpy()[ok], axis=1), 1.0, atol=1e-5)
    jvf, jinfo = jcol.detect_vf_grid(jnp.asarray(pos), jnp.asarray(faces), 0.02, 1.0, 4096,
                                     per_vertex_cap=32, cell_cap=16)
    assert_sets_match(vf_g, jvf)
    assert_sets_match(info, jinfo)


def test_ee_grid_matches_bruteforce():
    pos, edges, faces = _two_layer()
    ee_b = collision.detect_ee(_t(pos), _t(edges), 0.015, 1.0, 4096)
    ee_g, info = collision.detect_ee_grid(_t(pos), _t(edges), 0.015, 1.0, 4096,
                                          per_edge_cap=32, cell_cap=32)
    assert not bool(info.truncated)
    assert _pair_set(ee_g.e_id0, ee_g.e_id1) == _pair_set(ee_b.e_id0, ee_b.e_id1)
    jee, jinfo = jcol.detect_ee_grid(jnp.asarray(pos), jnp.asarray(edges), 0.015, 1.0, 4096,
                                     per_edge_cap=32, cell_cap=32)
    assert_sets_match(ee_g, jee)
    assert_sets_match(info, jinfo)


def test_ef_grid_matches_bruteforce():
    pos, edges, faces = _two_layer()
    ef_b = collision.detect_ef(_t(pos), _t(edges), _t(faces), 0.02, 1.0, 4096)
    ef_g, info = collision.detect_ef_grid(_t(pos), _t(edges), _t(faces), 0.02, 1.0, 4096,
                                          per_edge_cap=32, cell_cap=16)
    assert not bool(info.truncated)
    assert _pair_set(ef_g.e_id, ef_g.f_id) == _pair_set(ef_b.e_id, ef_b.f_id)
    jef, jinfo = jcol.detect_ef_grid(jnp.asarray(pos), jnp.asarray(edges), jnp.asarray(faces),
                                     0.02, 1.0, 4096, per_edge_cap=32, cell_cap=16)
    assert_sets_match(ef_g, jef)
    assert_sets_match(info, jinfo)


@pytest.mark.parametrize("kind", ["vf", "ee", "ef"])
def test_bruteforce_detectors_match_jax(kind):
    pos, edges, faces = _two_layer(n=6)
    jp, je, jf = jnp.asarray(pos), jnp.asarray(edges), jnp.asarray(faces)
    tp, te, tf = _t(pos), _t(edges), _t(faces)
    if kind == "vf":
        got, want = collision.detect_vf(tp, tf, 0.02, 3.0, 512), jcol.detect_vf(jp, jf, 0.02, 3.0, 512)
    elif kind == "ee":
        got, want = collision.detect_ee(tp, te, 0.015, 3.0, 512), jcol.detect_ee(jp, je, 0.015, 3.0, 512)
    else:
        got = collision.detect_ef(tp, te, tf, 0.02, 3.0, 512)
        want = jcol.detect_ef(jp, je, jf, 0.02, 3.0, 512)
    assert_sets_match(got, want)


def test_vf_grid_per_vertex_budget():
    pos, edges, faces = _two_layer()
    vf, _ = collision.detect_vf_grid(_t(pos), _t(faces), 0.02, 1.0, 4096,
                                     per_vertex_cap=1, cell_cap=16)
    vids = vf.v_id.numpy()
    vids = vids[vids >= 0]
    assert np.unique(vids).size == vids.size
    jvf, _ = jcol.detect_vf_grid(jnp.asarray(pos), jnp.asarray(faces), 0.02, 1.0, 4096,
                                 per_vertex_cap=1, cell_cap=16)
    assert_sets_match(vf, jvf)


def test_vf_grid_chunked_equals_unchunked():
    pos, edges, faces = _two_layer()
    a, ia = collision.detect_vf_grid(_t(pos), _t(faces), 0.02, 1.0, 512,
                                     per_vertex_cap=8, cell_cap=16, chunk=64)
    b, ib = collision.detect_vf_grid(_t(pos), _t(faces), 0.02, 1.0, 512,
                                     per_vertex_cap=8, cell_cap=16)
    assert _pair_set(a.v_id, a.f_id) == _pair_set(b.v_id, b.f_id)
    # the port's chunks are the same rows, so everything matches exactly
    assert_sets_match(a, type(b)(*(f.numpy() for f in b)), atol=0)
    assert bool(ia.truncated) == bool(ib.truncated) and int(ia.dropped) == int(ib.dropped)


def test_vf_grid_dropped_counter():
    pos, edges, faces = _two_layer()
    _, info = collision.detect_vf_grid(_t(pos), _t(faces), 0.02, 1.0, 4,
                                       per_vertex_cap=8, cell_cap=16)
    assert int(info.dropped) > 0
    _, jinfo = jcol.detect_vf_grid(jnp.asarray(pos), jnp.asarray(faces), 0.02, 1.0, 4,
                                   per_vertex_cap=8, cell_cap=16)
    assert int(info.dropped) == int(jinfo.dropped)


# ---- the collide recipe on a small fold --------------------------------------------

@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_fold_detection_matches_jax(jitter):
    """The JAX bench's collide recipe (threshold 0.75 h, stiffness 1e3, a
    budget of n // 4 and a cap of 2 per set) on a 16x16 fold: every field
    of all three sets, the flags and the stencils built from them."""
    mesh, p, h = _fold(16, jitter)
    n = mesh.num_verts
    jp, jf, je = jnp.asarray(p), jnp.asarray(mesh.faces), jnp.asarray(mesh.edges)
    tp, tf, te = _t(p), _t(mesh.faces), _t(mesh.edges)
    kw = dict(threshold=0.75 * h, stiffness=1e3, max_pairs=n // 4)
    jvf, jiv = jcol.detect_vf_grid(jp, jf, per_vertex_cap=2, **kw)
    jee, jie = jcol.detect_ee_grid(jp, je, per_edge_cap=2, **kw)
    jef, jif = jcol.detect_ef_grid(jp, je, jf, per_edge_cap=2, **kw)
    tvf, tiv = collision.detect_vf_grid(tp, tf, per_vertex_cap=2, **kw)
    tee, tie = collision.detect_ee_grid(tp, te, per_edge_cap=2, **kw)
    tef, tif = collision.detect_ef_grid(tp, te, tf, per_edge_cap=2, **kw)
    for got, want in ((tvf, jvf), (tee, jee), (tef, jef), (tiv, jiv), (tie, jie), (tif, jif)):
        assert_sets_match(got, want)
    js = jst.build_stencils(je, jf, ef=jef, ee=jee, vf=jvf)
    ts = st.build_stencils(te, tf, ef=tef, ee=tee, vf=tvf)
    assert_sets_match(ts, js)
    assert int(ts.valid.sum()) > 0
