"""Port vs JAX on an unstructured mesh: irregular Delaunay cloth with a hub.

scripts/torch_irregular_mesh.py builds the arrays (977 vertices from a
jittered 33 x 33 lattice, a hole of radius 6 around a centre vertex with
42 mesh neighbours, ELL width 72); each package builds its own
ClothMesh(..., grid=None) from them. The integer outputs (sort maps, ELL
structure, hierarchy) match bit for bit; apply on one identical state (the
JAX package prepares, convert.py carries the state across, as in
tests/test_torch_apply.py) matches with rtol 1e-5, atol 1e-6 * max|z|
under the dense and the packed symv. Each package's own prepare does not
reach that tolerance here: at mass 1e-3 the diagonal blocks' condition
numbers reach ~2e4, and each package's f32 inverse lies ~6e-5 from the
float64 inverse of the same blocks. So the prepares are held through PCG: reaches 1e-4 within one convergence test (both test
every iteration) of JAX's count, x within 1e-4 of JAX's x in relative
norm; a squeezed level_headroom retries to JAX's headroom with going_next
bitwise equal. The JAX hierarchy build, apply and PCG run under jax.jit:
on this mesh each is ~10x faster compiled than op by op.
"""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops.apply import precondition as jax_precondition
from precond_tpu.ops import blockcsr as jbc
from precond_tpu.ops import hierarchy as jhi
from precond_tpu.parallel import pcg as jpcg
from precond_tpu.solver import SchwarzPreconditioner as JaxPre
from precond_tpu.solver import compute_sort_maps as jax_sort_maps
from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner, convert
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops import blockcsr
from precond_tpu_torch.ops.apply import precondition
from precond_tpu_torch.ops import hierarchy as thi
from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse
from precond_tpu_torch.parallel import pcg
from precond_tpu_torch.solver import compute_sort_maps

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import torch_irregular_mesh as tim  # noqa: E402

torch.set_num_threads(2)

SIDE, HUB_RADIUS = 33, 6.0
# the packed symv at this size: 31 blocks in tiles of 8 (the last one ragged)
PACKED = dict(symv_kernel="packed", packed_symv_block_b=8)


def _np(a):
    return np.array(a)


@pytest.fixture(scope="module")
def meshes():
    arrays = tim.irregular_cloth(SIDE, HUB_RADIUS)
    jmesh, tmesh = jcloth.ClothMesh(**arrays), cloth.ClothMesh(**arrays)
    b = np.random.default_rng(0).standard_normal((tmesh.num_verts, 3)).astype(np.float32)
    return dict(arrays=arrays, jmesh=jmesh, jell=jcloth.assemble_system(jmesh), tmesh=tmesh,
                tell=cloth.assemble_system(tmesh, device="cpu"), b=b)


def _jax_pre(m, **kw):
    """The JAX package's preconditioner prepared on the mesh with config kw."""
    jpre = JaxPre(JaxConfig(**kw))
    jpre.allocate(m["jmesh"].positions)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpre.prepare(m["jell"])
    return jpre


def _port_pre(m, **kw):
    """The port's preconditioner on the mesh with config kw, allocated."""
    tpre = SchwarzPreconditioner(SchwarzConfig(**kw), device="cpu")
    tpre.allocate(m["tmesh"].positions)
    return tpre


def _jax_apply_and_pcg(jpre, jell, r, b):
    """JAX's apply of r and its PCG solve of b, compiled as one function."""
    cfg = jpre.cfg_effective

    @jax.jit
    def run(state, ell, r, b):
        return jax_precondition(state, r, cfg), jpcg.pcg(
            lambda x: jbc.spmv(ell, x), lambda v: jax_precondition(state, v, cfg), b, tol=1e-4,
            max_iters=1000)

    return run(jpre.state, jell, jnp.asarray(r), jnp.asarray(b))


def test_mesh_arrays_deterministic_without_duplicate_springs(meshes):
    a, again = meshes["arrays"], tim.irregular_cloth(SIDE, HUB_RADIUS)
    for key in ("positions", "edges", "faces", "springs", "stiffness"):
        np.testing.assert_array_equal(a[key], again[key], err_msg=key)
    s = a["springs"].astype(np.int64)
    n = len(a["positions"])
    assert (s[:, 0] != s[:, 1]).all()
    key = np.minimum(s[:, 0], s[:, 1]) * n + np.maximum(s[:, 0], s[:, 1])
    assert np.unique(key).size == key.size, "two springs join one pair"
    hub = tim.hub_vertex(a)
    assert 36 <= tim.mesh_degrees(a)[hub] <= 48 and meshes["tmesh"].grid is None
    assert 970 <= n <= 1030
    assert tim.digest(a) != tim.digest(tim.irregular_cloth(SIDE, HUB_RADIUS, seed=1))


@pytest.mark.parametrize("radius", [0.0, HUB_RADIUS], ids=["plain", "hub"])
def test_mesh_follows_recipe(radius):
    """Unit square, make_grid's z_wave, Euler's formula for a triangulated
    disc, each edge's opposite vertices in its faces, and the stiffnesses:
    k_struct on the mesh edges, k_bend on the rest."""
    m = tim.irregular_cloth(SIDE, radius)
    pos, edges, faces = m["positions"], m["edges"], m["faces"]
    n = len(pos)
    assert pos[:, :2].min() == 0.0 and pos[:, :2].max() == 1.0
    np.testing.assert_allclose(pos[:, 2], 0.02 * np.sin(7.3 * pos[:, 0]) * np.cos(5.1 * pos[:, 1]),
                               atol=1e-7)
    assert n - len(edges) + len(faces) == 1
    tri = {tuple(sorted(f)) for f in faces.tolist()}
    for lo, hi, o0, o1 in edges.tolist():
        assert tuple(sorted((lo, hi, o0))) in tri
        assert o1 == -1 or tuple(sorted((lo, hi, o1))) in tri
    assert (m["stiffness"][:len(edges)] == tim.K_STRUCT).all()
    assert (m["stiffness"][len(edges):] == tim.K_BEND).all()
    np.testing.assert_array_equal(m["springs"][:len(edges)], edges[:, :2])
    deg = tim.mesh_degrees(m)
    assert deg.min() >= 2 and (deg.max() >= 36) == bool(radius)


@pytest.mark.parametrize("what", ["sort_maps", "ell", "hierarchy"])
def test_integer_outputs_bitwise(meshes, what):
    jmaps = jax_sort_maps(jnp.asarray(meshes["arrays"]["positions"]))
    tmaps = compute_sort_maps(torch.as_tensor(meshes["arrays"]["positions"]))
    if what == "sort_maps":
        np.testing.assert_array_equal(tmaps.orig_to_sorted.numpy(), _np(jmaps.orig_to_sorted))
        np.testing.assert_array_equal(tmaps.sorted_to_orig.numpy(), _np(jmaps.sorted_to_orig))
        return
    jell, tell = meshes["jell"], meshes["tell"]
    if what == "ell":
        width = int(tim.degrees(meshes["arrays"]).max())
        assert tell.idx.shape[1] == width == jell.idx.shape[1]
        np.testing.assert_array_equal(tell.idx.numpy(), _np(jell.idx))
        np.testing.assert_array_equal(tell.mask.numpy(), _np(jell.mask))
        np.testing.assert_allclose(tell.blocks.numpy(), _np(jell.blocks), rtol=1e-6,
                                   atol=1e-6 * np.abs(_np(jell.blocks)).max())
        return
    js = jbc.permute(jell, jmaps.sorted_to_orig, jmaps.orig_to_sorted)
    ts = blockcsr.permute(tell, tmaps.sorted_to_orig, tmaps.orig_to_sorted)
    jh, jm = jax.jit(lambda i, m: jhi.build_hierarchy(i, m, JaxConfig(), with_merge_map=True))(
        js.idx, js.mask)
    th, tm = thi.build_hierarchy(ts.idx, ts.mask, SchwarzConfig(), with_merge_map=True)
    for name in jh._fields:
        np.testing.assert_array_equal(getattr(th, name).numpy(), _np(getattr(jh, name)),
                                      err_msg=name)
    for name in jm._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), _np(getattr(jm, name)),
                                      err_msg=name)


@pytest.mark.parametrize("symv", ["dense", "packed"])
def test_apply_and_pcg_match_jax(meshes, symv):
    kw = PACKED if symv == "packed" else {}
    jpre, tpre = _jax_pre(meshes, **kw), _port_pre(meshes, **kw)
    tpre.prepare(meshes["tell"])
    assert isinstance(tpre.state.inv96, PackedInverse) == (symv == "packed")
    fields = {k: (v if k == "inv96" and hasattr(v, "f") else _np(v))
              for k, v in jpre.state._asdict().items()}
    same = convert.apply_state_from_numpy(**fields, device="cpu")
    r = np.random.default_rng(4).standard_normal((meshes["tmesh"].num_verts, 3)).astype(np.float32)
    b, jell, tell = meshes["b"], meshes["jell"], meshes["tell"]
    zj, jres = _jax_apply_and_pcg(jpre, jell, r, b)
    zj = _np(zj)
    zt = precondition(same, torch.as_tensor(r), SchwarzConfig(**kw)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-6 * np.abs(zj).max())

    tres = pcg.pcg(lambda x: blockcsr.spmv(tell, x), tpre.apply, torch.as_tensor(b), tol=1e-4,
                   max_iters=1000)
    assert float(jres.rel_residual) <= 1e-4 and float(tres.rel_residual) <= 1e-4
    assert abs(tres.iterations - int(jres.iterations)) <= 1, (tres.iterations,
                                                              int(jres.iterations))
    xj = _np(jres.x)
    assert np.linalg.norm(tres.x.numpy() - xj) <= 1e-4 * np.linalg.norm(xj)


def test_dense_and_packed_port_agree(meshes):
    dense, packed = _port_pre(meshes), _port_pre(meshes, **PACKED)
    dense.prepare(meshes["tell"])
    packed.prepare(meshes["tell"])
    r = np.random.default_rng(5).standard_normal((meshes["tmesh"].num_verts, 3)).astype(np.float32)
    zd, zp = dense.apply(r).numpy(), packed.apply(r).numpy()
    np.testing.assert_allclose(zp, zd, rtol=1e-5, atol=1e-6 * np.abs(zd).max())


def test_overflow_retry_lands_on_jax_headroom(meshes):
    jpre, tpre = _jax_pre(meshes, level_headroom=0.3), _port_pre(meshes, level_headroom=0.3)
    with pytest.warns(UserWarning, match="overflow"):
        tpre.prepare(meshes["tell"])
    assert not bool(tpre.state.overflow)
    assert tpre.cfg_effective.level_headroom == jpre.cfg_effective.level_headroom > 0.3
    np.testing.assert_array_equal(tpre.state.going_next.numpy(), _np(jpre.state.going_next))
