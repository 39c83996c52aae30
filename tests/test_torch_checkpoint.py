"""The port's npz checkpoint (io/checkpoint.py) and its file format.

  * round trips of all five inverse kinds — dense f32, dense bf16,
    PackedInverse, PackedInverseCM and DenseInverseCM — with bitwise-equal
    applies after the load (the comp-major ones on the grid path's
    comp-major apply);
  * config and mesh mismatch refusals, and the restored level_headroom;
  * files written by the JAX package's save_solver (10x10 dense f32 and
    bf16) loaded by the port: its apply matches JAX's within 1e-6 * max|z|
    (f32) or 1e-5 * max|z| (bf16, the same table: only the order of the f32
    sums differs); and the arrays of a port-written file are the JAX
    package's layouts for the same blocks.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.io import checkpoint as jckpt
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops.pallas import packed_symv as jps
from precond_tpu.solver import SchwarzPreconditioner as JaxPre
from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
from precond_tpu_torch.io import checkpoint
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops import hierarchy as hi
from precond_tpu_torch.ops.apply import ApplyState
from precond_tpu_torch.ops.cuda import packed_symv as tps
from precond_tpu_torch.ops.cuda.packed_symv import DenseInverseCM, PackedInverse, PackedInverseCM
from precond_tpu_torch.ops.gridapply import analytic_hierarchy, precondition_grid_cm
from precond_tpu_torch.solver import SortMaps, prepare_grid
from precond_tpu_torch.utils import gridmorton as gm

torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _general(cfg, g=10):
    mesh = cloth.make_grid(g, g, z_wave=0.02)
    pre = SchwarzPreconditioner(cfg, device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(cloth.assemble_system(mesh, device="cpu"))
    return pre


def _grid(cfg, k=5):
    """A solver holding the grid path's state: the tile maps, the analytic
    hierarchy and prepare_grid's comp-major inverse."""
    g = 1 << k
    n = g * g
    mesh = cloth.make_grid(g, g, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, device="cpu")
    inv = prepare_grid(dgr, drr, offsets, k, cfg)
    hier = analytic_hierarchy(n, cfg, "cpu")
    pre = SchwarzPreconditioner(cfg, device="cpu")
    pre.maps = SortMaps(gm.sort_index(k, device="cpu").to(torch.int32),
                        gm.sort_index(k, inverse=True, device="cpu").to(torch.int32))
    pre.state = ApplyState(pre.maps.sorted_to_orig, pre.maps.orig_to_sorted, hier.going_next,
                           hi.ancestor_node_ids(hier, cfg, n), inv, hier.overflow, hier.onehot,
                           hier.pos, hier.pb)
    pre.frame_index = 3
    return pre, k


def _apply(pre, r, k=None):
    if k is None:
        return pre.apply(r)
    return gm.morton_to_grid_cm(precondition_grid_cm(
        pre.state.inv96, gm.grid_to_morton_cm(r.T.contiguous(), k), pre.cfg_effective), k)


CASES = {
    "dense_f32": (lambda: (_general(SchwarzConfig()), None), torch.Tensor),
    "dense_bf16": (lambda: (_general(SchwarzConfig(inverse_dtype="bfloat16")), None), torch.Tensor),
    "packed": (lambda: (_general(SchwarzConfig(symv_kernel="packed", packed_symv_block_b=128)),
                        None), PackedInverse),
    "packed_cm": (lambda: _grid(SchwarzConfig(symv_kernel="packed", packed_symv_block_b=128)),
                  PackedInverseCM),
    "dense_cm": (lambda: _grid(SchwarzConfig()), DenseInverseCM),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_roundtrip_bitwise(tmp_path, case):
    build, want_type = CASES[case]
    pre, k = build()
    assert type(pre.state.inv96) is want_type
    n = pre.maps.sorted_to_orig.shape[0]
    r = torch.as_tensor(_rand((n, 3), 0))
    x = torch.as_tensor(_rand((n, 3), 1))
    z_before = _apply(pre, r, k)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save_solver(path, pre, x=x)

    pre2 = SchwarzPreconditioner(pre.cfg, device="cpu")
    x2 = checkpoint.load_solver(path, pre2)
    assert pre2.frame_index == pre.frame_index
    assert torch.equal(x2, x)
    assert type(pre2.state.inv96) is want_type
    for a, b in zip(pre.state, pre2.state):
        if isinstance(a, tuple):
            for fa, fb in zip(a, b):
                assert (fa == fb) if isinstance(fa, int) else torch.equal(fa, fb)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(_apply(pre2, r, k), z_before)


def test_refuses_config_and_mesh_mismatch(tmp_path):
    cfg = SchwarzConfig(inverse_dtype="bfloat16")
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save_solver(path, _general(cfg))
    with pytest.raises(ValueError, match="config mismatch"):
        checkpoint.load_solver(path, SchwarzPreconditioner(SchwarzConfig(), device="cpu"))
    pre4 = SchwarzPreconditioner(cfg, device="cpu")
    pre4.allocate(cloth.make_grid(6, 6).positions)
    with pytest.raises(ValueError, match="mesh mismatch"):
        checkpoint.load_solver(path, pre4)


def test_restores_level_headroom(tmp_path):
    pre = _general(SchwarzConfig())
    # as after overflow recovery: the state follows a grown headroom
    pre.cfg_effective = dataclasses.replace(pre.cfg, level_headroom=8.0)
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save_solver(path, pre)
    pre2 = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    checkpoint.load_solver(path, pre2)
    assert pre2.cfg_effective.level_headroom == 8.0
    assert pre2.cfg.level_headroom == 2.0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-5)])
def test_loads_jax_written_file(tmp_path, dtype, tol):
    mesh = jcloth.make_grid(10, 10, z_wave=0.02)
    jpre = JaxPre(JaxConfig(inverse_dtype=dtype))
    jpre.allocate(mesh.positions)
    jpre.prepare(jcloth.assemble_system(mesh))
    r = _rand((mesh.num_verts, 3), 2)
    x = _rand((mesh.num_verts, 3), 3)
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save_solver(path, jpre, x=jnp.asarray(x))
    want = np.array(jpre.apply(jnp.asarray(r)))

    pre = SchwarzPreconditioner(SchwarzConfig(inverse_dtype=dtype), device="cpu")
    x2 = checkpoint.load_solver(path, pre)
    np.testing.assert_array_equal(x2.numpy(), x)
    assert pre.frame_index == jpre.frame_index
    assert pre.state.inv96.dtype == getattr(torch, dtype)
    got = pre.apply(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("kind", ["dense_bf16", "dense_cm", "packed", "packed_cm"])
def test_port_file_uses_jax_layouts(tmp_path, kind):
    """The arrays of a port-written file are the JAX package's for the same
    blocks: its pack_sym96(_cm) / dense_cm layouts, bf16 as uint16 views
    recorded in __dtypes__, nb an int32 scalar."""
    a = _rand((40, 96, 96), 4)
    a = 0.5 * (a + np.swapaxes(a, 1, 2))
    ta, ja = torch.as_tensor(a), jnp.asarray(a)
    pre = _general(SchwarzConfig())
    if kind == "dense_bf16":
        inv, want = ta.to(torch.bfloat16), {"": ja.astype(jnp.bfloat16)}
    elif kind == "dense_cm":
        inv, want = tps.dense_cm(ta), {".m": jps.dense_cm(ja).m}
    else:
        pack, jpack = ((tps.pack_sym96, jps.pack_sym96) if kind == "packed"
                       else (tps.pack_sym96_cm, jps.pack_sym96_cm))
        inv, jp = pack(ta, block_b=128), jpack(ja, block_b=128)
        want = {".f": jp.f, ".dg": jp.dg, ".nb": jp.nb}
    pre.state = pre.state._replace(inv96=inv)
    path = os.path.join(tmp_path, "port.npz")
    checkpoint.save_solver(path, pre)
    with np.load(path) as data:
        dtypes = json.loads(bytes(data["__dtypes__"].tobytes()).decode())
        assert bytes(data["__inv_type__"].tobytes()).decode() == type(inv).__name__
        for suffix, w in want.items():
            key = "state.inv96" + suffix
            got, w = data[key], np.array(w)
            assert got.shape == w.shape and got.dtype.itemsize == w.dtype.itemsize, key
            if w.dtype.name == "bfloat16":
                assert dtypes[key] == "bfloat16" and got.dtype == np.uint16
                w = w.view(np.uint16)
            else:
                assert got.dtype == w.dtype, key
            np.testing.assert_array_equal(got, w)
