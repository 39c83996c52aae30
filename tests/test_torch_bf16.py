"""Port vs JAX: bf16 inverse storage (SchwarzConfig.inverse_dtype="bfloat16").

  * the config check and the packed-storage rule;
  * _factorize's bf16 tables on the general, grid and box prepares: the
    port's own f32 table rounded to bf16, bit for bit;
  * the dense applies on the SAME bf16 table as JAX (carried across by
    convert: the two packages' f32 inverses differ by ~1e-6, which flips
    some bf16 roundings by one ulp) at 1e-5 * max|z|: the rhs is rounded to
    bf16 and the products summed in f32 in both, so only the order of the
    f32 sums differs;
  * the guards on a bf16 table;
  * every bf16 table is bitwise symmetric (the general, grid and box
    prepares under both inverse routes, and a JAX table carried across by
    convert): the card's symv96_bf16 reads only the lower triangle;
  * tests/test_precond_oracle.py's 24x24 per_axis case: bf16 converges
    within 2 * its_f32 + 10 (the JAX test's own allowance), and each count
    within 3 iterations of JAX's on the same system.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import blockcsr as jbc
from precond_tpu.ops.batched_inverse import apply_block_inverse as jax_apply_block_inverse
from precond_tpu.ops.pallas import packed_symv as jps
from precond_tpu.parallel.pcg import pcg as jax_pcg
from precond_tpu.solver import SchwarzPreconditioner as JaxPre
from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner, convert
from precond_tpu_torch.models import cloth, tetmesh
from precond_tpu_torch.ops import boxstencil
from precond_tpu_torch.ops.apply import precondition
from precond_tpu_torch.ops.blockcsr import spmv
from precond_tpu_torch.ops.cuda.packed_symv import DenseInverseCM, dense_symv_cm
from precond_tpu_torch.ops.cuda.symv import batched_symv
from precond_tpu_torch.parallel.pcg import pcg
from precond_tpu_torch.solver import prepare_box, prepare_grid
from precond_tpu_torch.utils.guards import validate_apply_state

torch.set_num_threads(2)
BF16 = SchwarzConfig(inverse_dtype="bfloat16")


def _np(a):
    return np.array(a)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_check():
    assert SchwarzConfig().inverse_dtype == "float32"
    with pytest.raises(ValueError, match="inverse_dtype"):
        SchwarzConfig(inverse_dtype="float16")
    # packed storage is f32 only, as in the JAX package (config.py:100-106)
    for kernel in ("auto", "packed", "dense"):
        for n in (100, 10**6):
            cfg = SchwarzConfig(inverse_dtype="bfloat16", symv_kernel=kernel)
            jcfg = JaxConfig(inverse_dtype="bfloat16", symv_kernel=kernel)
            assert not cfg.use_packed_symv(n)
            assert cfg.use_packed_symv(n) == jcfg.use_packed_symv(n)
    assert SchwarzConfig(symv_kernel="packed").use_packed_symv(100)


def _general(cfg, g=16):
    mesh = cloth.make_grid(g, g, z_wave=0.02)
    pre = SchwarzPreconditioner(cfg, device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(cloth.assemble_system(mesh, device="cpu"))
    return pre


def test_factorize_bf16_general():
    f32, bf = _general(SchwarzConfig()).state.inv96, _general(BF16).state.inv96
    assert bf.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert torch.equal(bf, f32.to(torch.bfloat16))
    assert validate_apply_state(_general(BF16).state) == []


def test_factorize_bf16_grid():
    mesh = cloth.make_grid(32, 32, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, device="cpu")
    f32 = prepare_grid(dgr, drr, offsets, 5, SchwarzConfig())
    bf = prepare_grid(dgr, drr, offsets, 5, BF16)
    assert isinstance(bf, DenseInverseCM) and bf.m.dtype == torch.bfloat16
    assert torch.equal(bf.m, f32.m.to(torch.bfloat16))
    # a packed request still gets the dense bf16 table
    packed = prepare_grid(dgr, drr, offsets, 5,
                          SchwarzConfig(inverse_dtype="bfloat16", symv_kernel="packed"))
    assert isinstance(packed, DenseInverseCM) and torch.equal(packed.m, bf.m)


def test_factorize_bf16_box():
    dims = (8, 8, 4)
    mesh = tetmesh.make_box(*dims, mass=0.05, youngs=5e4)
    dg, dr = boxstencil.planes_from_ell(tetmesh.assemble_system(mesh, device="cpu"), dims)
    f32 = prepare_box(dg, dr, boxstencil.BOX_OFFSETS, dims, SchwarzConfig())
    bf = prepare_box(dg, dr, boxstencil.BOX_OFFSETS, dims, BF16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, f32.to(torch.bfloat16))


def _bf16_table(path, inverse_kernel):
    cfg = SchwarzConfig(inverse_dtype="bfloat16", inverse_kernel=inverse_kernel)
    if path == "general":
        mesh = cloth.make_grid(32, 32, z_wave=0.02)
        pre = SchwarzPreconditioner(cfg, device="cpu")
        pre.allocate(mesh.positions)
        pre.prepare(cloth.assemble_system(mesh, device="cpu"))
        return pre.state.inv96
    if path == "grid":
        mesh = cloth.make_grid(32, 32, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
        inv = prepare_grid(*cloth.assemble_system_grid(mesh, device="cpu"), 5, cfg)
        assert isinstance(inv, DenseInverseCM)
        return inv.m
    if path == "box":
        dims = (8, 8, 4)
        mesh = tetmesh.make_box(*dims, mass=0.05, youngs=5e4)
        dg, dr = boxstencil.planes_from_ell(tetmesh.assemble_system(mesh, device="cpu"), dims)
        return prepare_box(dg, dr, boxstencil.BOX_OFFSETS, dims, cfg)
    # a JAX bf16 state carried across by convert
    mesh = jcloth.make_grid(32, 32, z_wave=0.02)
    jpre = JaxPre(JaxConfig(inverse_dtype="bfloat16", inverse_kernel=inverse_kernel))
    jpre.allocate(mesh.positions)
    jpre.prepare(jcloth.assemble_system(mesh))
    return convert.apply_state_from_numpy(*jpre.state, device="cpu").inv96


@pytest.mark.parametrize("inverse_kernel", ["panel", "xla"])
@pytest.mark.parametrize("path", ["general", "grid", "box", "jax_convert"])
def test_bf16_tables_bitwise_symmetric(path, inverse_kernel):
    """The precondition of the card's symv96_bf16, which reads only the lower
    triangle and the diagonal of each table."""
    m = _bf16_table(path, inverse_kernel)
    assert m.dtype == torch.bfloat16 and m.dim() == 3 and m.shape[1:] == (96, 96)
    assert torch.equal(m, m.transpose(1, 2))


@pytest.mark.parametrize("b", [1, 7, 300])
def test_dense_symv_bf16_matches_jax(b):
    a = _rand((b, 96, 96), 0)
    inv = jnp.asarray(0.5 * (a + np.swapaxes(a, 1, 2))).astype(jnp.bfloat16)
    rhs = _rand((b, 96), 1)
    want = _np(jax_apply_block_inverse(inv, jnp.asarray(rhs)))
    tinv = convert.bf16_from_numpy(_np(inv), "cpu")
    assert tinv.dtype == torch.bfloat16
    got = batched_symv(tinv, torch.as_tensor(rhs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the rhs really is rounded: an f32 rhs against the widened table differs
    plain = torch.einsum("bij,bj->bi", tinv.float(), torch.as_tensor(rhs)).numpy()
    assert np.abs(plain - want).max() > 1e-4 * np.abs(want).max()


def test_dense_symv_cm_bf16_matches_jax():
    b = 40
    a = _rand((b, 96, 96), 2)
    inv96 = jnp.asarray(0.5 * (a + np.swapaxes(a, 1, 2)))
    jinv = jps.dense_cm(inv96.astype(jnp.bfloat16))
    rs3 = _rand((3, b, 32), 3)
    want = _np(jps.dense_symv_cm(jinv, jnp.asarray(rs3)))
    tinv = convert.dense_inverse_cm_from_numpy(_np(jinv.m), device="cpu")
    assert tinv.m.dtype == torch.bfloat16
    got = dense_symv_cm(tinv, torch.as_tensor(rs3)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_general_apply_bf16_same_table_as_jax():
    mesh = jcloth.make_grid(16, 16, z_wave=0.02)
    jcfg = JaxConfig(inverse_dtype="bfloat16")
    jpre = JaxPre(jcfg)
    jpre.allocate(mesh.positions)
    jpre.prepare(jcloth.assemble_system(mesh))
    assert jpre.state.inv96.dtype == jnp.bfloat16
    state = convert.apply_state_from_numpy(*jpre.state, device="cpu")
    assert state.inv96.dtype == torch.bfloat16
    r = _rand((mesh.num_verts, 3), 4)
    want = _np(jpre.apply(jnp.asarray(r)))
    got = precondition(state, torch.as_tensor(r), BF16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_convert_keeps_the_comp_major_types():
    """JAX's comp-major inverses cross as the port's comp-major types (the
    packed ones share field names with PackedInverse)."""
    mesh = jcloth.make_grid(16, 16, z_wave=0.02)
    jpre = JaxPre(JaxConfig())
    jpre.allocate(mesh.positions)
    jpre.prepare(jcloth.assemble_system(mesh))
    a = _rand((20, 96, 96), 5)
    inv96 = jnp.asarray(0.5 * (a + np.swapaxes(a, 1, 2)))
    for jinv, want in ((jps.dense_cm(inv96.astype(jnp.bfloat16)), "DenseInverseCM"),
                       (jps.pack_sym96_cm(inv96, block_b=128), "PackedInverseCM"),
                       (jps.pack_sym96(inv96, block_b=128), "PackedInverse")):
        state = convert.apply_state_from_numpy(*jpre.state._replace(inv96=jinv), device="cpu")
        assert type(state.inv96).__name__ == want


def test_guards_on_bf16_table():
    mesh = cloth.make_grid(32, 32, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    cm = prepare_grid(*cloth.assemble_system_grid(mesh, device="cpu"), 5, BF16)
    state = _general(BF16).state
    assert validate_apply_state(state._replace(inv96=cm)) == []
    m = cm.m.clone()
    m[1, 2, 3] = float("inf")
    assert any("non-finite" in p for p in
               validate_apply_state(state._replace(inv96=DenseInverseCM(m=m))))
    inv = state.inv96.clone()
    inv[0, 3, 5] = float("nan")
    problems = validate_apply_state(state._replace(inv96=inv))
    assert any("non-finite" in p for p in problems), problems
    inv = state.inv96.clone()
    inv[0, 3, 5] = inv[0, 5, 3].float() + 1.0
    problems = validate_apply_state(state._replace(inv96=inv))
    assert any("asymmetry" in p for p in problems), problems


def test_bf16_per_axis_converges_like_jax():
    """tests/test_precond_oracle.py:107-129 on both packages."""
    mesh = cloth.make_grid(24, 24, z_wave=0.02, mass=1e-3)
    ell = cloth.assemble_system(mesh, device="cpu")
    jell = jcloth.assemble_system(mesh)
    b = _rand((mesh.num_verts, 3), 6)
    its, jits = {}, {}
    for dtype in ("float32", "bfloat16"):
        pre = SchwarzPreconditioner(
            SchwarzConfig(inverse_dtype=dtype, morton_normalization="per_axis"), device="cpu")
        pre.allocate(mesh.positions)
        pre.prepare(ell)
        res = pcg(lambda x: spmv(ell, x), pre.apply, torch.as_tensor(b), tol=1e-4, max_iters=1000)
        assert float(res.rel_residual) <= 1e-4, dtype
        its[dtype] = int(res.iterations)
        jpre = JaxPre(JaxConfig(inverse_dtype=dtype, morton_normalization="per_axis"))
        jpre.allocate(mesh.positions)
        jpre.prepare(jell)
        jres = jax_pcg(lambda x: jbc.spmv(jell, x), jpre.apply, jnp.asarray(b), tol=1e-4,
                       max_iters=1000)
        jits[dtype] = int(jres.iterations)
    assert its["bfloat16"] <= 2 * its["float32"] + 10, its
    for dtype in its:
        assert abs(its[dtype] - jits[dtype]) <= 3, (its, jits)
