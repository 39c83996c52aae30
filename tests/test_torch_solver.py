"""Port vs JAX for the slice as a whole: allocate -> prepare -> PCG-apply.

Each package runs its own full path on the same inputs (numpy, from a
seed). PCG reaches 1e-4 in an iteration count within max(2, 5%) of JAX's;
z matches with rtol 1e-5, atol 1e-6 * max|z| (tests/test_reference_api.py:116);
prepare and apply are bit-reproducible twice over; debug checks raise.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import blockcsr as jbc
from precond_tpu.parallel import pcg as jpcg
from precond_tpu.parallel.sharded import solve_step as jax_solve_step
from precond_tpu.solver import SchwarzPreconditioner as JaxPre
from precond_tpu.solver import compute_sort_maps as jax_sort_maps
from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops import blockcsr
from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse
from precond_tpu_torch.parallel import pcg
from precond_tpu_torch.parallel.sharded import solve_step
from precond_tpu_torch.solver import compute_sort_maps
from precond_tpu_torch.utils.guards import assert_healthy, validate_apply_state

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _band(a, b):
    return abs(a - b) <= max(2, int(0.05 * b))


def test_entry_problem_solve_step():
    """The JAX package's entry() problem: 32x32 cloth, solve_step, tol 1e-4."""
    mesh = jcloth.make_grid(32, 32, z_wave=0.02)
    b = np.random.default_rng(0).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    jres = jax_solve_step(jcloth.assemble_system(mesh), jax_sort_maps(jnp.asarray(mesh.positions)),
                          jnp.asarray(b), JaxConfig(), tol=1e-4, max_iters=100)
    tmesh = cloth.make_grid(32, 32, z_wave=0.02)
    tres = solve_step(cloth.assemble_system(tmesh, device="cpu"),
                      compute_sort_maps(torch.as_tensor(tmesh.positions)), b, SchwarzConfig(),
                      tol=1e-4, max_iters=100, device="cpu")
    assert float(jres.rel_residual) <= 1e-4 and float(tres.rel_residual) <= 1e-4
    assert _band(tres.iterations, int(jres.iterations)), (tres.iterations, int(jres.iterations))


@pytest.mark.parametrize("symv", ["dense", "packed"])
def test_cloth64_solve_and_apply_match_jax(symv):
    g = 64
    kw = dict(symv_kernel=symv, packed_symv_block_b=128)
    mesh = jcloth.make_grid(g, g, z_wave=0.02)
    jell = jcloth.assemble_system(mesh)
    jpre = JaxPre(JaxConfig(**kw))
    jpre.allocate(mesh.positions)
    jpre.prepare(jell)
    tmesh = cloth.make_grid(g, g, z_wave=0.02)
    tell = cloth.assemble_system(tmesh, device="cpu")
    tpre = SchwarzPreconditioner(SchwarzConfig(**kw), device="cpu")
    tpre.allocate(tmesh.positions)
    tpre.prepare(tell)
    assert isinstance(tpre.state.inv96, PackedInverse) == (symv == "packed")

    r = np.random.default_rng(4).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    zj = _np(jpre.apply(jnp.asarray(r)))
    zt = tpre.apply(r).numpy()
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-6 * np.abs(zj).max())

    jres = jpcg.pcg(lambda x: jbc.spmv(jell, x), jpre.apply, jnp.asarray(r), tol=1e-4,
                    max_iters=500)
    tres = pcg.pcg(lambda x: blockcsr.spmv(tell, x), tpre.apply, torch.as_tensor(r), tol=1e-4,
                   max_iters=500)
    assert float(jres.rel_residual) <= 1e-4 and float(tres.rel_residual) <= 1e-4
    assert _band(tres.iterations, int(jres.iterations)), (tres.iterations, int(jres.iterations))
    tjac = pcg.pcg(lambda x: blockcsr.spmv(tell, x), pcg.jacobi_preconditioner(tell.diag),
                   torch.as_tensor(r), tol=1e-4, max_iters=3000)
    assert tres.iterations < tjac.iterations


def _prepared(cfg=None, g=16):
    mesh = cloth.make_grid(g, g, z_wave=0.02)
    ell = cloth.assemble_system(mesh, device="cpu")
    pre = SchwarzPreconditioner(cfg or SchwarzConfig(), device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(ell)
    return mesh, ell, pre


@pytest.mark.parametrize("symv", ["dense", "packed"])
def test_prepare_and_apply_bit_reproducible(symv):
    cfg = SchwarzConfig(symv_kernel=symv, packed_symv_block_b=128)
    mesh, ell, pre1 = _prepared(cfg, g=24)
    _, _, pre2 = _prepared(cfg, g=24)
    for a, b in zip(pre1.state, pre2.state):
        if isinstance(a, PackedInverse):
            assert torch.equal(a.f, b.f) and torch.equal(a.dg, b.dg) and a.nb == b.nb
        else:
            assert torch.equal(a, b)
    r = np.random.default_rng(0).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    assert torch.equal(pre1.apply(r), pre2.apply(r))
    assert torch.equal(pre1.apply(r), pre1.apply(r))


def test_debug_checks_raise_on_nan_system():
    mesh = cloth.make_grid(16, 16, z_wave=0.02)
    ell = cloth.assemble_system(mesh, device="cpu")
    bad = ell._replace(diag=ell.diag.clone())
    bad.diag[7, 0, 0] = float("nan")
    pre = SchwarzPreconditioner(SchwarzConfig(debug_checks=True), device="cpu")
    pre.allocate(mesh.positions)
    with pytest.raises(ValueError, match="non-finite"):
        pre.prepare(bad)
    pre.prepare(ell)  # the same config passes cleanly on the healthy system
    assert_healthy(pre.state)


def test_guards_catch_nan_state():
    _, _, pre = _prepared()
    inv = pre.state.inv96.clone()
    inv[0, 0, 0] = float("nan")
    problems = validate_apply_state(pre.state._replace(inv96=inv))
    assert any("non-finite" in p for p in problems)
    _, _, pp = _prepared(SchwarzConfig(symv_kernel="packed", packed_symv_block_b=128,
                                       debug_checks=True))
    assert validate_apply_state(pp.state) == []


def test_overflow_retry_matches_jax():
    """A squeezed level capacity overflows; prepare rebuilds with doubled
    headroom until it fits, landing where the JAX package lands."""
    cfg_kw = dict(level_headroom=0.3)
    mesh = jcloth.make_grid(40, 40, z_wave=0.02)
    jpre = JaxPre(JaxConfig(**cfg_kw))
    jpre.allocate(mesh.positions)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpre.prepare(jcloth.assemble_system(mesh))
    tmesh = cloth.make_grid(40, 40, z_wave=0.02)
    tpre = SchwarzPreconditioner(SchwarzConfig(**cfg_kw), device="cpu")
    tpre.allocate(tmesh.positions)
    with pytest.warns(UserWarning, match="overflow"):
        tpre.prepare(cloth.assemble_system(tmesh, device="cpu"))
    assert not bool(tpre.state.overflow)
    assert tpre.cfg_effective.level_headroom == jpre.cfg_effective.level_headroom > 0.3
    np.testing.assert_array_equal(tpre.state.going_next.numpy(), _np(jpre.state.going_next))


def test_pcg_history_and_jacobi_match_jax():
    mesh, ell, pre = _prepared(g=24)
    b = np.random.default_rng(2).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    spmv = lambda v: blockcsr.spmv(ell, v)  # noqa: E731
    _, curve = pcg.pcg_with_history(spmv, pre.apply, torch.as_tensor(b), num_iters=60)
    res = pcg.pcg(spmv, pre.apply, torch.as_tensor(b), tol=1e-4, max_iters=200)
    crossed = int(np.argmax(curve.numpy() <= 1e-4)) + 1
    assert abs(crossed - res.iterations) <= 1
    jdiag = _np(ell.diag)
    want = _np(jpcg.jacobi_preconditioner(jnp.asarray(jdiag))(jnp.asarray(b)))
    got = pcg.jacobi_preconditioner(torch.as_tensor(jdiag))(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    res8 = pcg.pcg(spmv, pre.apply, torch.as_tensor(b), tol=1e-4, max_iters=200, check_every=8)
    assert res8.iterations % 8 == 0 and float(res8.rel_residual) <= 1e-4


def test_allocate_resorts_on_cadence():
    mesh, ell, pre = _prepared()
    maps = pre.maps
    pre.allocate(mesh.positions)
    assert pre.maps is maps  # frame 1: no re-sort
    pre.frame_index = pre.cfg.resort_every
    pre.allocate(mesh.positions)
    assert pre.maps is not maps


def _collide(grid):
    """The JAX bench's collide recipe (bench.py:220-270) at `grid`, through
    both packages' detection: (jax mesh, positions, jax stencils, port
    stencils). Valid stencils kept and padded to a multiple of 8."""
    from precond_tpu.models import collision as jcol
    from precond_tpu.ops import stencils as jst
    from precond_tpu_torch.models import collision as tcol
    from precond_tpu_torch.ops import stencils as tst

    mesh = jcloth.make_grid(grid, grid, z_wave=0.0, mass=1e-3, dt=1.0 / 60.0)
    n, h = mesh.num_verts, 1.0 / (grid - 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    p = p.astype(np.float32)
    kw = dict(threshold=0.75 * h, stiffness=1e3, max_pairs=n // 4)
    pj, fj, ej = jnp.asarray(p), jnp.asarray(mesh.faces), jnp.asarray(mesh.edges)
    js = jst.build_stencils(ej, fj, ef=jcol.detect_ef_grid(pj, ej, fj, per_edge_cap=2, **kw)[0],
                            ee=jcol.detect_ee_grid(pj, ej, per_edge_cap=2, **kw)[0],
                            vf=jcol.detect_vf_grid(pj, fj, per_vertex_cap=2, **kw)[0])
    pt, ft, et = (torch.as_tensor(a) for a in (p, mesh.faces, mesh.edges))
    ts = tst.build_stencils(et, ft, ef=tcol.detect_ef_grid(pt, et, ft, per_edge_cap=2, **kw)[0],
                            ee=tcol.detect_ee_grid(pt, et, per_edge_cap=2, **kw)[0],
                            vf=tcol.detect_vf_grid(pt, ft, per_vertex_cap=2, **kw)[0])
    keep = np.flatnonzero(np.asarray(js.valid))
    np.testing.assert_array_equal(torch.nonzero(ts.valid).reshape(-1).numpy(), keep)
    keep = np.concatenate([keep, np.zeros((-keep.size) % 8, np.int64)])
    js = type(js)(*(jnp.asarray(np.asarray(f)[keep]) for f in js))
    ts = type(ts)(*(f[torch.as_tensor(keep)] for f in ts))
    live = int(np.asarray(js.valid).sum())
    js = js._replace(valid=js.valid.at[live:].set(False))
    ts.valid[live:] = False
    return mesh, p, js, ts


def test_collide_fold_prepare_and_solve_match_jax():
    """The collide path on a 32x32 fold: stencils (bitwise) into prepare,
    the apply within 1e-5 of JAX's, PCG on H + H_c in sorted space (block-
    ELL + slot contact SpMV) within the iteration band of JAX's (block-ELL +
    stencil contact SpMV), fewer iterations than block-Jacobi, and a
    bit-reproducible prepare."""
    from precond_tpu.ops import contact as jct
    from precond_tpu.ops.apply import precondition_sorted as jprec
    from precond_tpu.solver import prepare_with_system as jax_prepare
    from precond_tpu_torch.ops import contact as tct
    from precond_tpu_torch.ops.apply import precondition_sorted
    from precond_tpu_torch.ops.stencils import map_stencils

    mesh, p, js, ts = _collide(32)
    for name, g, w in zip(js._fields, ts, js):
        w = _np(w)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    n = mesh.num_verts
    jcfg, cfg = JaxConfig(coarse_damping=0.25), SchwarzConfig(coarse_damping=0.25)
    maps = jax_sort_maps(jnp.asarray(p))
    jstate, jells = jax_prepare(jcloth.assemble_system(mesh, positions=p), maps, jcfg, js)
    tmesh = cloth.make_grid(32, 32, z_wave=0.0, mass=1e-3, dt=1.0 / 60.0)
    tell = cloth.assemble_system(tmesh, positions=p, device="cpu")
    pre = SchwarzPreconditioner(cfg, device="cpu")
    pre.allocate(p)
    pre.prepare(tell, ts)
    np.testing.assert_array_equal(pre.state.going_next.numpy(), _np(jstate.going_next))

    r = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    rs = r[_np(maps.sorted_to_orig)]
    zj = _np(jprec(jstate, jnp.asarray(rs), jcfg))
    zt = precondition_sorted(pre.state, torch.as_tensor(rs), cfg).numpy()
    # contact makes the blocks stiff (cond ~6e5): each package's f32 inverse
    # reads ~5e-6 of max against f64, so the applies are held at the JAX
    # inverse test's 1e-4 of max (tests/test_batched_inverse.py:49)
    assert np.abs(zt - zj).max() < 1e-4 * np.abs(zj).max()

    jm = js._replace(idx=jnp.take(maps.orig_to_sorted, jnp.clip(js.idx, 0, n - 1)))
    jres = jpcg.pcg(lambda x: jbc.spmv(jells, x) + jct.stencil_contact_spmv(jm, x),
                    lambda v: jprec(jstate, v, jcfg), jnp.asarray(rs), tol=1e-4, max_iters=2000)
    ells = blockcsr.permute(tell, pre.maps.sorted_to_orig, pre.maps.orig_to_sorted)
    tm = ts._replace(idx=pre.maps.orig_to_sorted[torch.clamp(ts.idx, 0, n - 1).long()])
    slots = tct.build_contact_slots(tm, n)

    def spmv(x):
        return blockcsr.spmv(ells, x) + tct.slot_contact_spmv(tm, slots, x)

    tres = pcg.pcg(spmv, lambda v: precondition_sorted(pre.state, v, cfg), torch.as_tensor(rs),
                   tol=1e-4, max_iters=2000)
    assert float(jres.rel_residual) <= 1e-4 and float(tres.rel_residual) <= 1e-4
    assert _band(tres.iterations, int(jres.iterations)), (tres.iterations, int(jres.iterations))
    jac = pcg.pcg(spmv, pcg.jacobi_preconditioner(ells.diag + tct.contact_diag(tm, n)),
                  torch.as_tensor(rs), tol=1e-4, max_iters=5000)
    assert tres.iterations < jac.iterations

    pre2 = SchwarzPreconditioner(cfg, device="cpu")
    pre2.allocate(p)
    pre2.prepare(tell, ts)
    for a, b in zip(pre.state, pre2.state):
        assert torch.equal(a, b)
    # prepare_with_system maps the stencils exactly as map_stencils does
    assert torch.equal(map_stencils(ts, pre.maps.orig_to_sorted).idx,
                       torch.as_tensor(np.asarray(jnp.where(
                           js.valid[:, None] & (jnp.arange(5) < js.nverts[:, None]),
                           jnp.take(maps.orig_to_sorted, jnp.clip(js.idx, 0, n - 1)), 0))))
