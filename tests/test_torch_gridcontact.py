"""Port vs JAX: contact on the structured grid path.

The same stencils (detected by the port on a folded sheet, carried to both
packages as numpy arrays) through both packages:
  * grid_collision_terms, the small branch and the big branch (the set
    padded with invalid pairs to 40,000), at tests/test_contact.py:183-221's
    atol 1e-6 * max, and the big branch against the small one;
  * assemble_grid_hessian with collisions at rtol 1e-5, atol 3e-5 * max
    (tests/test_gridprep.py:87), and prepare_grid with stencils at rtol
    2e-4, atol 1e-5 (tests/test_gridprep.py:142-183); the port's grid
    prepare against the port's general prepare on the tile maps, whose
    hierarchy the contacts leave arithmetic (going_next bit for bit);
  * grid_contact_solve_step at 32x32 within 2 iterations of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import contact as jct
from precond_tpu.ops import gridassembly as jga
from precond_tpu.ops import stencils as jst
from precond_tpu.parallel.gridsharded import grid_contact_solve_step as jax_contact_step
from precond_tpu.solver import prepare_grid as jax_prepare_grid
from precond_tpu_torch import SchwarzConfig, convert
from precond_tpu_torch.models import cloth as tcloth
from precond_tpu_torch.models import collision
from precond_tpu_torch.ops import contact as tct
from precond_tpu_torch.ops import gridapply as tgap
from precond_tpu_torch.ops import gridassembly as tga
from precond_tpu_torch.ops import stencils as tst
from precond_tpu_torch.parallel.gridsharded import grid_contact_solve_step
from precond_tpu_torch.solver import SortMaps, prepare_grid, prepare_with_system
from precond_tpu_torch.utils import gridmorton as tgm

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _fold(g, gap=0.006):
    """tests/test_gridprep.py:152-158's folded sheet (z_wave 0.02, mass 1e-3)."""
    mesh = tcloth.make_grid(g, g, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, gap, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    return mesh, p.astype(np.float32)


def _stencils(mesh, p, thresh=0.01, budget=None):
    """VF + EE stencils of the fold (the JAX test's recipe), as numpy fields."""
    budget = 4 * mesh.grid[0] if budget is None else budget
    pt, ft, et = (torch.as_tensor(a) for a in (p, mesh.faces, mesh.edges))
    vf, _ = collision.detect_vf_grid(pt, ft, thresh, 1e3, budget)
    ee, _ = collision.detect_ee_grid(pt, et, thresh, 1e3, budget)
    st = tst.build_stencils(et, ft, ee=ee, vf=vf)
    assert int(st.valid.sum()) > 0, "fixture found no contacts"
    return [f.numpy() for f in st]


def _both(fields):
    return jst.Stencils(*map(jnp.asarray, fields)), convert.stencils_from_numpy(*fields, device="cpu")


@pytest.fixture(scope="module")
def fold16():
    mesh, p = _fold(16, gap=0.5 / 15)
    fields = _stencils(mesh, p, thresh=0.75 / 15, budget=2 * mesh.num_verts)
    return mesh, p, fields


def _terms(fields, n, k):
    js, ts = _both(fields)
    s2o, o2s = tgm.sort_maps(k)
    jm = js._replace(idx=jnp.where(
        js.valid[:, None] & (jnp.arange(5) < js.nverts[:, None]),
        jnp.take(jnp.asarray(o2s), jnp.clip(js.idx, 0, n - 1)), 0))
    tm = tst.map_stencils(ts, torch.as_tensor(o2s))
    np.testing.assert_array_equal(tm.idx.numpy(), _np(jm.idx))
    return jst.collision_terms(jm), tst.collision_terms(tm)


def _pad(terms, total, cat, zeros):
    """Append invalid pair rows up to `total` (crosses BIG_PAIR_THRESHOLD
    without changing the operator)."""
    extra = total - terms.pair_a.shape[0]
    z = zeros(extra)
    return terms._replace(pair_a=cat([terms.pair_a, z]), pair_b=cat([terms.pair_b, z]),
                          pair_mat=cat([terms.pair_mat, zeros((extra, 3, 3), float)]),
                          pair_valid=cat([terms.pair_valid, zeros(extra, bool)]))


def _jzeros(shape, kind=None):
    return jnp.zeros(shape, {None: jnp.int32, float: jnp.float32, bool: bool}[kind])


def _tzeros(shape, kind=None):
    return torch.zeros(shape, dtype={None: torch.int32, float: torch.float32,
                                     bool: torch.bool}[kind])


@pytest.mark.parametrize("branch", ["small", "big"])
def test_grid_collision_terms_match_jax(fold16, branch):
    mesh, _, fields = fold16
    n = mesh.num_verts
    jt, tt = _terms(fields, n, 4)
    assert tt.pair_a.shape[0] <= 32768, "small-branch precondition"
    if branch == "big":
        jt = _pad(jt, 40000, jnp.concatenate, _jzeros)
        tt = _pad(tt, 40000, torch.cat, _tzeros)
    jrows, jdg = jax.jit(lambda t: jga.grid_collision_terms(t, JaxConfig(), n))(jt)
    rows, dg = tga.grid_collision_terms(tt, SchwarzConfig(), n)
    scale = max(float(np.abs(_np(jrows)).max()), 1e-12)
    assert scale > 0
    np.testing.assert_allclose(rows.numpy(), _np(jrows), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(dg.numpy(), _np(jdg), rtol=0, atol=1e-6 * scale)


def test_grid_collision_terms_big_branch_matches_small(fold16):
    """The port's dense segment placement (> 32,768 pairs) reproduces its
    small-set placement (tests/test_contact.py:183-221's tight tolerance)."""
    mesh, _, fields = fold16
    n = mesh.num_verts
    _, tt = _terms(fields, n, 4)
    rows_s, dg_s = tga.grid_collision_terms(tt, SchwarzConfig(), n)
    rows_b, dg_b = tga.grid_collision_terms(_pad(tt, 40000, torch.cat, _tzeros), SchwarzConfig(), n)
    scale = max(float(rows_s.abs().max()), 1e-12)
    np.testing.assert_allclose(rows_b.numpy(), rows_s.numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(dg_b.numpy(), dg_s.numpy(), rtol=0, atol=1e-6 * scale)


@pytest.fixture(scope="module", params=[5, 6])
def contact_grid(request):
    """tests/test_gridprep.py:142-183's fold at 2^k, the stencils, and the
    row-major grid blocks in both packages."""
    k = request.param
    g = 1 << k
    mesh, p = _fold(g)
    fields = _stencils(mesh, p)
    jdg, jdr, off = jcloth.assemble_system_grid(jcloth.make_grid(g, g, z_wave=0.02, mass=0.001,
                                                                 dt=1.0 / 60.0), positions=p)
    tdg, tdr, _ = convert.grid_blocks_from_numpy(_np(jdg), _np(jdr), off, device="cpu")
    return dict(k=k, mesh=mesh, p=p, fields=fields, jax=(jdg, jdr), port=(tdg, tdr), off=off)


def test_assemble_grid_hessian_with_collisions_matches_jax(contact_grid):
    c = contact_grid
    k, n = c["k"], c["mesh"].num_verts
    cfg, jcfg = SchwarzConfig(solve_layout="rows"), JaxConfig(solve_layout="rows")
    jt, tt = _terms(c["fields"], n, k)
    want = _np(jax.jit(lambda a, b, t: jga.assemble_grid_hessian(a, b, c["off"], k, jcfg, t))(
        *c["jax"], jt))
    got = tga.assemble_grid_hessian(*c["port"], c["off"], k, cfg, tt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=3e-5 * np.abs(want).max())
    # the contacts moved the blocks: the same assembly without them differs
    bare = tga.assemble_grid_hessian(*c["port"], c["off"], k, cfg)
    assert float((got - bare).abs().max()) > 1e-3 * float(bare.abs().max())


def test_prepare_grid_with_stencils_matches_jax_and_general(contact_grid):
    c = contact_grid
    k, n = c["k"], c["mesh"].num_verts
    cfg, jcfg = SchwarzConfig(solve_layout="rows"), JaxConfig(solve_layout="rows")
    s2o, o2s = tgm.sort_maps(k)
    js, ts = _both(c["fields"])
    want = _np(jax.jit(lambda a, b, s, o: jax_prepare_grid(a, b, c["off"], k, jcfg, s, o))(
        *c["jax"], js, jnp.asarray(o2s)))
    got = prepare_grid(*c["port"], c["off"], k, cfg, ts, torch.as_tensor(o2s))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    # the port's general prepare on the tile maps: contacts leave the
    # hierarchy arithmetic, and the inverses agree
    ell = tcloth.assemble_system(c["mesh"], positions=c["p"], device="cpu")
    state, _ = prepare_with_system(ell, SortMaps(torch.as_tensor(s2o), torch.as_tensor(o2s)), cfg, ts)
    np.testing.assert_array_equal(state.going_next.numpy(),
                                  tgap.grid_going_next(n, cfg, "cpu").numpy())
    np.testing.assert_allclose(got.numpy(), state.inv96.numpy(), rtol=2e-4, atol=1e-5)


def test_grid_contact_solve_step_matches_jax(g=32):
    mesh, p = _fold(g)
    n = mesh.num_verts
    k = 5
    fields = _stencils(mesh, p)
    js, ts = _both(fields)
    jmesh = jcloth.make_grid(g, g, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    jsys = jcloth.assemble_system_stencil(jmesh, positions=p)
    jdg, jdr, off = jcloth.assemble_system_grid(jmesh, positions=p)
    tsys = tcloth.assemble_system_stencil(mesh, positions=p, device="cpu")
    tdg, tdr, _ = tcloth.assemble_system_grid(mesh, positions=p, device="cpu")
    jce = jct.build_contact_ell(js, n, kc=32)
    tce = tct.build_contact_ell(ts, n, kc=32)
    _, o2s = tgm.sort_maps(k)
    b = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    jres = jax.jit(lambda a, c, bb, s, ce, o: jax_contact_step(
        jsys, a, c, bb, s, ce, o, off, k, JaxConfig(), tol=1e-4, max_iters=400))(
        jdg, jdr, jnp.asarray(b), js, jce, jnp.asarray(o2s))
    tres = grid_contact_solve_step(tsys, tdg, tdr, torch.as_tensor(b), ts, tce,
                                   torch.as_tensor(o2s), off, k, SchwarzConfig(),
                                   tol=1e-4, max_iters=400)
    assert float(jres.rel_residual) <= 1e-4 and float(tres.rel_residual) <= 1e-4
    assert abs(tres.iterations - int(jres.iterations)) <= 2, (tres.iterations, int(jres.iterations))
