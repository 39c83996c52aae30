"""Port vs JAX: the structured grid path's prepare and apply, and the slice whole.

Same meshes and vectors (numpy, from a seed) through both packages, at
32x32 and 64x64:
  * analytic hierarchy, parent map and the static assembly pattern bitwise;
  * assemble_grid_hessian at rtol 1e-5, atol 3e-5 * max (tests/test_gridprep.py:87);
  * prepare_grid inverses at rtol 2e-4, atol 1e-5 (tests/test_gridprep.py:110);
  * precondition_grid / precondition_grid_cm on the same inverses at
    1e-5 * max|z| (tests/test_cm_path.py:71), the packed comp-major form
    against JAX's packed_symv_cm in interpret mode;
  * grid_solve_step and the comp-major PCG converge to 1e-4 within 2
    iterations of JAX's count on the same 64x64 system.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import gridapply as jgap
from precond_tpu.ops import gridassembly as jga
from precond_tpu.ops import gridstencil as jgs
from precond_tpu.ops.pallas import packed_symv as jps
from precond_tpu.parallel import pcg as jpcg
from precond_tpu.parallel.gridsharded import grid_solve_step as jax_grid_solve_step
from precond_tpu.solver import SortMaps as JaxSortMaps
from precond_tpu.solver import prepare_grid as jax_prepare_grid
from precond_tpu.solver import prepare_with_system as jax_prepare_with_system
from precond_tpu.utils import gridmorton as jgm
from precond_tpu_torch import SchwarzConfig, convert
from precond_tpu_torch.models import cloth as tcloth
from precond_tpu_torch.ops import gridapply as tgap
from precond_tpu_torch.ops import gridassembly as tga
from precond_tpu_torch.ops import gridstencil as tgs
from precond_tpu_torch.ops.cuda.packed_symv import (
    DenseInverseCM,
    PackedInverse,
    PackedInverseCM,
    dense_cm,
    pack_sym96,
    pack_sym96_cm,
)
from precond_tpu_torch.parallel import pcg as tpcg
from precond_tpu_torch.parallel.gridsharded import grid_solve_step
from precond_tpu_torch.solver import SortMaps, prepare_grid, prepare_with_system
from precond_tpu_torch.utils import gridmorton as tgm

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _mesh(g, pkg):
    return pkg.make_grid(g, g, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)


def _k(g):
    return g.bit_length() - 1


def _grid_blocks(g):
    """JAX's row-major grid blocks and the port's copy of the same arrays."""
    jdg, jdr, off = jcloth.assemble_system_grid(_mesh(g, jcloth))
    return (jdg, jdr, off), convert.grid_blocks_from_numpy(_np(jdg), _np(jdr), off, device="cpu")


def _jax_prepare(g, cfg):
    (jdg, jdr, off), _ = _grid_blocks(g)
    return jax.jit(lambda a, b: jax_prepare_grid(a, b, off, _k(g), cfg))(jdg, jdr)


def _rel_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), np.abs(got - want).max()


# ---- hierarchy and pattern: bitwise -----------------------------------------

@pytest.mark.parametrize("g", [32, 64])
def test_analytic_hierarchy_bitwise(g):
    n = g * g
    jh = jgap.analytic_hierarchy(n, JaxConfig())
    th = tgap.analytic_hierarchy(n, SchwarzConfig(), device="cpu")
    for name in jh._fields:
        np.testing.assert_array_equal(getattr(th, name).numpy(), _np(getattr(jh, name)), err_msg=name)
    assert tgap.grid_level_sizes(n, SchwarzConfig()) == jgap.grid_level_sizes(n, JaxConfig())
    np.testing.assert_array_equal(tgap.grid_going_next(n, SchwarzConfig(), "cpu").numpy(),
                                  _np(jgap.grid_going_next(n, JaxConfig())))


@pytest.mark.parametrize("g", [32, 64])
def test_grid_pattern_bitwise(g):
    (_, _, off), _ = _grid_blocks(g)
    jp = jga.grid_pattern(_k(g), off, JaxConfig())
    tp = tga.grid_pattern(_k(g), off, SchwarzConfig())
    for name in ("band", "lam", "sc", "fill"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)
    assert tp.sizes == jp.sizes
    assert [e[:3] for e in tp.offdiag] == [e[:3] for e in jp.offdiag]
    for te, je in zip(tp.offdiag, jp.offdiag):
        np.testing.assert_array_equal(te[3], je[3])


def test_arith_parent_bitwise(g=64):
    n = g * g
    cfg = SchwarzConfig()
    x = np.arange(cfg.total_capacity(n) + 1, dtype=np.int32)
    np.testing.assert_array_equal(tga.arith_parent(torch.as_tensor(x), cfg, n).numpy(),
                                  _np(jga.arith_parent(jnp.asarray(x), JaxConfig(), n)))


# ---- assembly and prepare ------------------------------------------------------

@pytest.mark.parametrize("g", [32, 64])
def test_assemble_grid_hessian_matches_jax(g):
    (jdg, jdr, off), (tdg, tdr, _) = _grid_blocks(g)
    cfg = JaxConfig(solve_layout="rows")
    want = _np(jax.jit(lambda a, b: jga.assemble_grid_hessian(a, b, off, _k(g), cfg))(jdg, jdr))
    got = tga.assemble_grid_hessian(tdg, tdr, off, _k(g), SchwarzConfig(solve_layout="rows"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("g", [32, 64])
def test_prepare_grid_dense_rows_matches_jax(g):
    want = _np(_jax_prepare(g, JaxConfig(symv_kernel="dense", solve_layout="rows")))
    _, (tdg, tdr, off) = _grid_blocks(g)
    got = prepare_grid(tdg, tdr, off, _k(g), SchwarzConfig(symv_kernel="dense", solve_layout="rows"))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["rows", "auto"])
def test_prepare_grid_packed_matches_jax(layout, g=64):
    kw = dict(symv_kernel="packed", packed_symv_block_b=128, solve_layout=layout)
    want = _jax_prepare(g, JaxConfig(**kw))
    _, (tdg, tdr, off) = _grid_blocks(g)
    got = prepare_grid(tdg, tdr, off, _k(g), SchwarzConfig(**kw))
    assert type(got) is (PackedInverseCM if layout == "auto" else PackedInverse)
    assert type(want).__name__ == type(got).__name__ and got.nb == int(want.nb)
    np.testing.assert_allclose(got.f.numpy(), _np(want.f), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got.dg.numpy(), _np(want.dg), rtol=2e-4, atol=1e-5)


def test_prepare_grid_dense_cm_matches_jax(g=64):
    """The auto layout below the packed threshold: DenseInverseCM, held
    against JAX's batch-minor table through convert."""
    want = _jax_prepare(g, JaxConfig())
    assert isinstance(want, jps.DenseInverseCM)
    _, (tdg, tdr, off) = _grid_blocks(g)
    got = prepare_grid(tdg, tdr, off, _k(g), SchwarzConfig())
    assert isinstance(got, DenseInverseCM)
    ref = convert.dense_inverse_cm_from_numpy(_np(want.m), device="cpu")
    np.testing.assert_allclose(got.m.numpy(), ref.m.numpy(), rtol=2e-4, atol=1e-5)


def test_prepare_with_analytic_hierarchy_matches_jax_and_prepare_grid(g=64):
    """prepare_with_system(analytic_hier=True) on the tile-ordered ELL:
    the same inverses as JAX's, and as prepare_grid's."""
    k = _k(g)
    cfg = SchwarzConfig(symv_kernel="dense", solve_layout="rows")
    jcfg = JaxConfig(symv_kernel="dense", solve_layout="rows")
    s2o, o2s = tgm.sort_maps(k)
    jell = jcloth.assemble_system(_mesh(g, jcloth))
    jstate, _ = jax.jit(lambda e, m: jax_prepare_with_system(e, m, jcfg, None, analytic_hier=True))(
        jell, JaxSortMaps(jnp.asarray(s2o), jnp.asarray(o2s)))
    tell = tcloth.assemble_system(_mesh(g, tcloth), device="cpu")
    tstate, _ = prepare_with_system(tell, SortMaps(torch.as_tensor(s2o), torch.as_tensor(o2s)),
                                    cfg, analytic_hier=True)
    np.testing.assert_array_equal(tstate.going_next.numpy(), _np(jstate.going_next))
    np.testing.assert_array_equal(tstate.restrict_pos.numpy(), _np(jstate.restrict_pos))
    np.testing.assert_allclose(tstate.inv96.numpy(), _np(jstate.inv96), rtol=2e-4, atol=1e-5)
    _, (tdg, tdr, off) = _grid_blocks(g)
    np.testing.assert_allclose(prepare_grid(tdg, tdr, off, k, cfg).numpy(), tstate.inv96.numpy(),
                               rtol=2e-4, atol=1e-5)


def test_forced_cm_on_general_prepare_warns(g=32):
    mesh = _mesh(g, tcloth)
    from precond_tpu_torch.solver import compute_sort_maps

    ell = tcloth.assemble_system(mesh, device="cpu")
    maps = compute_sort_maps(torch.as_tensor(mesh.positions))
    with pytest.warns(UserWarning, match="solve_layout='cm'"):
        state, _ = prepare_with_system(ell, maps, SchwarzConfig(solve_layout="cm"))
    assert isinstance(state.inv96, torch.Tensor)
    # a 16x16 grid prepare cannot honor cm either (the crossings need 32x32)
    dg, dr, off = tcloth.assemble_system_grid(_mesh(16, tcloth), device="cpu")
    with pytest.warns(UserWarning, match="solve_layout='cm'"):
        inv = prepare_grid(dg, dr, off, 4, SchwarzConfig(solve_layout="cm"))
    assert isinstance(inv, torch.Tensor)


def test_stencils_without_o2s_refused(g=32):
    """prepare_grid and prepare_box take stencils only with the sort map
    into tile order (JAX asserts it, solver.py:135,246; the port raises)."""
    from precond_tpu_torch.models import tetmesh
    from precond_tpu_torch.ops import boxstencil
    from precond_tpu_torch.ops.stencils import empty_stencils
    from precond_tpu_torch.solver import prepare_box

    _, (tdg, tdr, off) = _grid_blocks(g)
    with pytest.raises(ValueError, match="o2s"):
        prepare_grid(tdg, tdr, off, 5, SchwarzConfig(), stencils=empty_stencils())
    dims = (4, 4, 2)
    ell = tetmesh.assemble_system(tetmesh.make_box(*dims), device="cpu")
    dg, dr = boxstencil.planes_from_ell(ell, dims)
    with pytest.raises(ValueError, match="o2s"):
        prepare_box(dg, dr, boxstencil.BOX_OFFSETS, dims, SchwarzConfig(), empty_stencils())


# ---- apply -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense64():
    """JAX's dense row-major inverses at 64x64 and a residual."""
    g = 64
    inv = _np(_jax_prepare(g, JaxConfig(symv_kernel="dense", solve_layout="rows")))
    r = np.random.default_rng(2).standard_normal((g * g, 3)).astype(np.float32)
    return inv, r


def test_restrict_and_prolong_grid_match_jax(dense64):
    _, r = dense64
    n = r.shape[0]
    mr = tgap.restrict_residual_grid(torch.as_tensor(r), SchwarzConfig(), n)
    jmr = _np(jgap.restrict_residual_grid(jnp.asarray(r), JaxConfig(), n))
    _rel_close(mr.numpy(), jmr, 1e-6)
    z = tgap.prolong_and_collect_grid(torch.as_tensor(jmr), SchwarzConfig(), n)
    _rel_close(z.numpy(), _np(jgap.prolong_and_collect_grid(jnp.asarray(jmr), JaxConfig(), n)), 1e-6)


@pytest.mark.parametrize("form", ["dense", "packed"])
def test_precondition_grid_matches_jax(dense64, form):
    inv, r = dense64
    cfg_kw = dict(symv_kernel=form, packed_symv_block_b=128, solve_layout="rows")
    k = 6
    rs = _np(jgm.grid_to_morton(jnp.asarray(r), k))
    if form == "dense":
        jinv, tinv = jnp.asarray(inv), torch.as_tensor(inv)
    else:
        jinv = jps.pack_sym96(jnp.asarray(inv), block_b=128)
        tinv = pack_sym96(torch.as_tensor(inv), block_b=128)
    want = _np(jgap.precondition_grid(jinv, jnp.asarray(rs), JaxConfig(**cfg_kw)))
    got = tgap.precondition_grid(tinv, torch.as_tensor(rs), SchwarzConfig(**cfg_kw))
    _rel_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("form", ["dense", "packed"])
def test_precondition_grid_cm_matches_jax(dense64, form):
    """Comp-major apply on the same inverse: packed through JAX's
    interpret-mode packed_symv_cm, dense through its einsum."""
    inv, r = dense64
    k = 6
    cfg_kw = dict(symv_kernel=form, packed_symv_block_b=128)
    rt = np.ascontiguousarray(r.T)
    rs = _np(jgm.grid_to_morton_cm(jnp.asarray(rt), k))
    if form == "dense":
        jinv, tinv = jps.dense_cm(jnp.asarray(inv)), dense_cm(torch.as_tensor(inv))
    else:
        jinv = jps.pack_sym96_cm(jnp.asarray(inv), block_b=128)
        tinv = pack_sym96_cm(torch.as_tensor(inv), block_b=128)
    want = _np(jgap.precondition_grid_cm(jinv, jnp.asarray(rs), JaxConfig(**cfg_kw)))
    got = tgap.precondition_grid_cm(tinv, torch.as_tensor(rs), SchwarzConfig(**cfg_kw))
    _rel_close(got.numpy(), want, 1e-5)
    # and against the row-major apply of the unpermuted inverse
    rows = tgap.precondition_grid(torch.as_tensor(inv), torch.as_tensor(np.ascontiguousarray(rs.T)),
                                  SchwarzConfig(symv_kernel="dense"))
    _rel_close(got.numpy().T, rows.numpy(), 1e-5)


def test_convert_carries_jax_cm_inverses(dense64):
    inv, _ = dense64
    jp = jps.pack_sym96_cm(jnp.asarray(inv), block_b=128)
    tp = convert.packed_inverse_cm_from_numpy(_np(jp.f), _np(jp.dg), jp.nb, device="cpu")
    mine = pack_sym96_cm(torch.as_tensor(inv), block_b=128)
    assert isinstance(tp, PackedInverseCM) and tp.nb == mine.nb
    np.testing.assert_array_equal(tp.f.numpy(), mine.f.numpy())
    np.testing.assert_array_equal(tp.dg.numpy(), mine.dg.numpy())
    jd = convert.dense_inverse_cm_from_numpy(_np(jps.dense_cm(jnp.asarray(inv)).m), device="cpu")
    np.testing.assert_array_equal(jd.m.numpy(), dense_cm(torch.as_tensor(inv)).m.numpy())


def test_row_and_cm_types_never_mix(dense64):
    inv, r = dense64
    rs = torch.as_tensor(r)
    with pytest.raises(TypeError, match="precondition_grid_cm"):
        tgap.precondition_grid(pack_sym96_cm(torch.as_tensor(inv), 128), rs, SchwarzConfig())
    with pytest.raises(TypeError, match="precondition_grid_cm"):
        tgap.precondition_grid(dense_cm(torch.as_tensor(inv)), rs, SchwarzConfig())
    with pytest.raises(TypeError, match="comp-major"):
        tgap.precondition_grid_cm(torch.as_tensor(inv), rs.T.contiguous(), SchwarzConfig())


# ---- the slice whole ------------------------------------------------------------

def _systems(g):
    jmesh, tmesh = _mesh(g, jcloth), _mesh(g, tcloth)
    return (jcloth.assemble_system_stencil(jmesh), jcloth.assemble_system_grid(jmesh),
            tcloth.assemble_system_stencil(tmesh, device="cpu"),
            tcloth.assemble_system_grid(tmesh, device="cpu"))


def test_grid_solve_step_matches_jax(g=64):
    jsys, (jdg, jdr, off), tsys, (tdg, tdr, _) = _systems(g)
    b = np.random.default_rng(0).standard_normal((g * g, 3)).astype(np.float32)
    jres = jax.jit(lambda a, c, bb: jax_grid_solve_step(jsys, a, c, bb, off, _k(g), JaxConfig(),
                                                        tol=1e-4, max_iters=300))(jdg, jdr, jnp.asarray(b))
    tres = grid_solve_step(tsys, tdg, tdr, torch.as_tensor(b), off, _k(g), SchwarzConfig(),
                           tol=1e-4, max_iters=300)
    assert float(jres.rel_residual) <= 1e-4 and float(tres.rel_residual) <= 1e-4
    assert abs(tres.iterations - int(jres.iterations)) <= 2, (tres.iterations, int(jres.iterations))


@pytest.mark.parametrize("symv", ["packed", "auto"])
def test_cm_pcg_matches_jax(symv, g=64):
    """The comp-major solve of the JAX bench's cloth config, at 64x64:
    [3,N] carries, spmv_t, the cm crossings and the cm apply (packed via
    K2's entry, or dense cm below the threshold)."""
    k = _k(g)
    jsys, (jdg, jdr, off), tsys, (tdg, tdr, _) = _systems(g)
    kw = dict(symv_kernel=symv, packed_symv_block_b=128)
    jcfg, cfg = JaxConfig(**kw), SchwarzConfig(**kw)
    jinv = jax.jit(lambda a, c: jax_prepare_grid(a, c, off, k, jcfg))(jdg, jdr)
    tinv = prepare_grid(tdg, tdr, off, k, cfg)
    assert type(tinv).__name__ == type(jinv).__name__
    b = np.random.default_rng(3).standard_normal((g * g, 3)).astype(np.float32)
    bt = np.ascontiguousarray(b.T)
    jres = jpcg.pcg(lambda p: jgs.spmv_t(jsys, p),
                    lambda r: jgm.morton_to_grid_cm(jgap.precondition_grid_cm(
                        jinv, jgm.grid_to_morton_cm(r, k), jcfg), k),
                    jnp.asarray(bt), tol=1e-4, max_iters=400)
    tres = tpcg.pcg(lambda p: tgs.spmv_t(tsys, p),
                    lambda r: tgm.morton_to_grid_cm(tgap.precondition_grid_cm(
                        tinv, tgm.grid_to_morton_cm(r, k), cfg), k),
                    torch.as_tensor(bt), tol=1e-4, max_iters=400)
    assert float(jres.rel_residual) <= 1e-4 and float(tres.rel_residual) <= 1e-4
    assert abs(tres.iterations - int(jres.iterations)) <= 2, (tres.iterations, int(jres.iterations))
    true_rel = float(torch.linalg.norm(torch.as_tensor(bt) - tgs.spmv_t(tsys, tres.x))
                     / torch.linalg.norm(torch.as_tensor(bt)))
    assert true_rel <= 1e-3
