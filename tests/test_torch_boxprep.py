"""Port vs JAX: the 3-D box path (box_pattern, assemble_box_hessian,
prepare_box) and the cases of tests/test_boxprep.py.

The box pattern bit for bit; the static box assembly at rtol 1e-5, atol
3e-5 * max and the inverses at rtol 2e-4 (tests/test_boxprep.py's
tolerances), each against the JAX function on the same planes and against
the port's general path on the box maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import tetmesh as jtet
from precond_tpu.ops import boxstencil as jbs
from precond_tpu.ops import gridassembly as jga
from precond_tpu.ops import stencils as jst
from precond_tpu.solver import prepare_box as jax_prepare_box
from precond_tpu_torch import SchwarzConfig, convert
from precond_tpu_torch.models import collision
from precond_tpu_torch.models import tetmesh as ttet
from precond_tpu_torch.ops import boxstencil, gridassembly
from precond_tpu_torch.ops import hierarchy as thi
from precond_tpu_torch.ops.apply import precondition_sorted
from precond_tpu_torch.ops.assembly import assemble_banked_hessian
from precond_tpu_torch.ops.blockcsr import BlockEll, permute
from precond_tpu_torch.ops.gridapply import grid_going_next, precondition_grid
from precond_tpu_torch.ops.stencils import build_stencils
from precond_tpu_torch.parallel.pcg import pcg
from precond_tpu_torch.solver import SortMaps, prepare_box, prepare_with_system
from precond_tpu_torch.utils import boxmorton as bm

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _box(dims):
    """The JAX system of make_box(dims, mass 0.05, youngs 5e4) and the port's
    copy of the same arrays, with the box maps."""
    mesh = ttet.make_box(*dims, mass=0.05, youngs=5e4)
    jell = jtet.assemble_system(mesh)
    ell = BlockEll(*(torch.as_tensor(_np(a)) for a in jell))
    s2o, o2s = bm.sort_maps(*dims)
    return mesh, jell, ell, SortMaps(torch.as_tensor(s2o), torch.as_tensor(o2s))


@pytest.mark.parametrize("dims", [(8, 8, 4), (8, 8, 8), (16, 8, 8)])
def test_general_hierarchy_is_arithmetic_on_boxes(dims):
    cfg = SchwarzConfig()
    mesh, _, ell, maps = _box(dims)
    state, _ = prepare_with_system(ell, maps, cfg)
    assert not bool(state.overflow)
    np.testing.assert_array_equal(state.going_next.numpy(),
                                  grid_going_next(mesh.num_verts, cfg, "cpu").numpy())
    jp = jga.box_pattern(dims, jbs.BOX_OFFSETS, JaxConfig())
    tp = gridassembly.box_pattern(dims, boxstencil.BOX_OFFSETS, cfg)
    for name in ("band", "lam", "sc", "fill"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)
    assert tp.sizes == jp.sizes and [e[:3] for e in tp.offdiag] == [e[:3] for e in jp.offdiag]


@pytest.fixture(scope="module")
def box8():
    dims = (8, 8, 8)
    mesh, jell, ell, maps = _box(dims)
    jdg, jdr = jbs.planes_from_ell(jell, dims)
    dg, dr = boxstencil.planes_from_ell(ell, dims)
    np.testing.assert_array_equal(dr.numpy(), _np(jdr))
    return dict(dims=dims, mesh=mesh, jell=jell, ell=ell, maps=maps, jax=(jdg, jdr), port=(dg, dr))


def test_box_static_assembly_matches_jax_and_general(box8):
    b = box8
    cfg = SchwarzConfig()
    want = _np(jax.jit(lambda a, c: jga.assemble_box_hessian(a, c, jbs.BOX_OFFSETS, b["dims"],
                                                             JaxConfig()))(*b["jax"]))
    got = gridassembly.assemble_box_hessian(*b["port"], boxstencil.BOX_OFFSETS, b["dims"], cfg)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=3e-5 * scale)
    maps = b["maps"]
    ells = permute(b["ell"], maps.sorted_to_orig, maps.orig_to_sorted)
    hier = thi.build_hierarchy(ells.idx, ells.mask, cfg, None)
    h_gen = assemble_banked_hessian(ells, hier, cfg, None)
    np.testing.assert_allclose(got.numpy(), h_gen.numpy(), rtol=1e-5, atol=3e-5 * scale)


def test_box_analytic_prepare_matches_general(box8):
    b = box8
    cfg = SchwarzConfig()
    st_gen, _ = prepare_with_system(b["ell"], b["maps"], cfg)
    st_ana, _ = prepare_with_system(b["ell"], b["maps"], cfg, analytic_hier=True)
    np.testing.assert_array_equal(st_gen.going_next.numpy(), st_ana.going_next.numpy())
    np.testing.assert_allclose(st_ana.inv96.numpy(), st_gen.inv96.numpy(), rtol=2e-4, atol=1e-6)
    r = torch.as_tensor(np.random.default_rng(0).standard_normal((b["mesh"].num_verts, 3))
                        .astype(np.float32))
    z_gen = precondition_sorted(st_gen, r, cfg).numpy()
    z_box = precondition_grid(st_ana.inv96, r, cfg).numpy()
    np.testing.assert_allclose(z_box, z_gen, rtol=1e-5, atol=1e-5 * np.abs(z_gen).max())


def test_prepare_box_matches_jax_and_solves(box8):
    b = box8
    dims, n = b["dims"], b["mesh"].num_verts
    cfg = SchwarzConfig()
    want = _np(jax.jit(lambda a, c: jax_prepare_box(a, c, jbs.BOX_OFFSETS, dims, JaxConfig()))(
        *b["jax"]))
    inv96 = prepare_box(*b["port"], boxstencil.BOX_OFFSETS, dims, cfg)
    np.testing.assert_allclose(inv96.numpy(), want, rtol=2e-4, atol=1e-5)
    bsys = boxstencil.from_ell(b["ell"], dims)
    rhs = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32))

    def pre_op(r):
        return bm.morton_to_box(precondition_grid(inv96, bm.box_to_morton(r, *dims), cfg), *dims)

    res = pcg(lambda v: boxstencil.spmv(bsys, v), pre_op, rhs, tol=1e-4, max_iters=300)
    assert float(res.rel_residual) <= 1e-4 * 1.01


def test_prepare_box_with_stencils_matches_general_and_jax(box8):
    """Collision terms on the 3-D box path: the arithmetic climbs reproduce
    the general assembly (clustering is invariant) and the JAX prepare."""
    b = box8
    dims, mesh, n = b["dims"], b["mesh"], b["mesh"].num_verts
    cfg = SchwarzConfig()
    pos, fj, ej = (torch.as_tensor(a) for a in (mesh.positions, mesh.faces, mesh.edges))
    h = 1.0 / 7
    vf, _ = collision.detect_vf_grid(pos, fj, 1.2 * h, 1e3, 256, per_vertex_cap=4)
    ee, _ = collision.detect_ee_grid(pos, ej, 1.2 * h, 1e3, 256, per_edge_cap=4)
    st = build_stencils(ej, fj, ee=ee, vf=vf)
    assert int(st.valid.sum()) > 0, "fixture found no contacts"
    state, _ = prepare_with_system(b["ell"], b["maps"], cfg, st)
    np.testing.assert_array_equal(state.going_next.numpy(),
                                  grid_going_next(n, cfg, "cpu").numpy())
    o2s = b["maps"].orig_to_sorted
    inv96 = prepare_box(*b["port"], boxstencil.BOX_OFFSETS, dims, cfg, st, o2s)
    np.testing.assert_allclose(inv96.numpy(), state.inv96.numpy(), rtol=2e-4, atol=1e-5)
    fields = [f.numpy() for f in st]
    js = jst.Stencils(*map(jnp.asarray, fields))
    want = _np(jax.jit(lambda a, c, s, o: jax_prepare_box(a, c, jbs.BOX_OFFSETS, dims, JaxConfig(),
                                                          s, o))(*b["jax"], js, jnp.asarray(o2s)))
    carried = convert.stencils_from_numpy(*fields, device="cpu")
    np.testing.assert_allclose(prepare_box(*b["port"], boxstencil.BOX_OFFSETS, dims, cfg, carried,
                                           o2s).numpy(), want, rtol=2e-4, atol=1e-5)
