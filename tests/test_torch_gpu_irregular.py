"""The kernels on an unstructured mesh: K1, K2 and K3 on the blocks and
tables of irregular Delaunay cloth with a hub, against their plain versions.

The mesh is scripts/torch_irregular_mesh.py's 256 x 256 lattice with a hole
of radius 19 around a centre vertex (64,405 vertices; the centre meets ~125
mesh neighbours and the ELL is ~215 wide). Needs a CUDA card and skips
without one; imports no JAX:

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA card" -m gpu tests/test_torch_gpu_irregular.py

Tolerances are chip_smoke.py's for the same kernels: K1 per block 1e-3 of
the block's max|inverse| against float64 (the blocks reach cond ~1e7), K2
2e-5 |z| + 2e-5 max|z|, K3 1e-5 |z| + 1e-5 max|z|.
"""

import os
import sys

import numpy as np
import pytest
import torch

from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops import hierarchy as hi
from precond_tpu_torch.ops.assembly import assemble_banked_hessian
from precond_tpu_torch.ops.batched_inverse import apply_block_inverse, invert_spd_blocks_panel
from precond_tpu_torch.ops.blockcsr import permute
from precond_tpu_torch.ops.cuda import _lib
from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse, packed_symv_ref, packed_symv_t
from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse
from precond_tpu_torch.ops.cuda.symv import batched_symv

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import torch_irregular_mesh as tim  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def hub():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = tim.irregular_cloth(256, 19.0)
    mesh = cloth.ClothMesh(**arrays)
    ell = cloth.assemble_system(mesh)
    out = {"arrays": arrays, "mesh": mesh, "ell": ell}
    for symv in ("dense", "packed"):
        pre = SchwarzPreconditioner(SchwarzConfig(symv_kernel=symv))
        pre.allocate(mesh.positions)
        pre.prepare(ell)
        out[symv] = pre
    return out


def _h96(pre, ell):
    es = permute(ell, pre.maps.sorted_to_orig, pre.maps.orig_to_sorted)
    hier, mm = hi.build_hierarchy(es.idx, es.mask, pre.cfg_effective, None, with_merge_map=True)
    return assemble_banked_hessian(es, hier, pre.cfg_effective, None, merge_map=mm)


def _per_block(x, ref):
    return ((x.double() - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2)))


def test_k1_on_hub_blocks(hub):
    pre = hub["dense"]
    h96 = _h96(pre, hub["ell"])
    before = _lib.launch_counts["spd_inverse96"]
    got = spd_inverse(h96, repair=False)
    assert _lib.launch_counts["spd_inverse96"] == before + 1
    plain = invert_spd_blocks_panel(h96, repair=False)
    truth = torch.linalg.inv(h96.double())
    err_k, err_kp = _per_block(got, truth), _per_block(got, plain.double())
    assert torch.isfinite(got).all() and torch.equal(got, got.transpose(1, 2))
    assert float(err_k.max()) < 1e-3 and float(err_kp.max()) < 1e-3
    centre = tim.hub_vertex(hub["arrays"])
    bank = int(pre.maps.orig_to_sorted[centre]) // 32
    assert float(err_k[bank]) < 1e-3, float(err_k[bank])


def test_k2_on_hub_packed_table(hub):
    packed = hub["packed"].state.inv96
    assert isinstance(packed, PackedInverse)
    bp = packed.f.shape[2]
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((96, bp)).astype(np.float32),
                        device="cuda")
    before = _lib.launch_counts["packed_symv96"]
    got = packed_symv_t(packed, x)
    assert _lib.launch_counts["packed_symv96"] == before + 1
    plain = packed_symv_ref(packed, x.T).T
    scale = float(plain.abs().max())
    assert bool(((got - plain).abs() <= 2e-5 * plain.abs() + 2e-5 * scale).all())


def test_k3_on_hub_dense_table(hub):
    inv96 = hub["dense"].state.inv96
    assert not isinstance(inv96, PackedInverse)
    rhs = torch.as_tensor(
        np.random.default_rng(3).standard_normal((inv96.shape[0], 96)).astype(np.float32),
        device="cuda")
    before = _lib.launch_counts["symv96"]
    got = batched_symv(inv96, rhs)
    assert _lib.launch_counts["symv96"] == before + 1
    plain = apply_block_inverse(inv96, rhs)
    scale = float(plain.abs().max())
    assert bool(((got - plain).abs() <= 1e-5 * plain.abs() + 1e-5 * scale).all())


@pytest.mark.parametrize("order", ["original", "sorted"])
def test_ell_spmv_on_hub_mesh(hub, order):
    """The block-ELL SpMV kernel on the hub mesh's own ELL (width ~215, one
    row of ~125 valid slots), in both vertex orders, against its plain
    version and float64 on the CPU. Per row, within (4K + 14) u and (K + 8) u
    of the row's sum of |terms| (tests/test_torch_gpu_kernels.py's bounds of
    f32 summation, u = 2^-24)."""
    from precond_tpu_torch.ops.blockcsr import spmv, spmv_plain

    ell = hub["ell"]
    if order == "sorted":
        maps = hub["dense"].maps
        ell = permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    k = ell.max_degree
    x = torch.as_tensor(
        np.random.default_rng(4).standard_normal((ell.num_verts, 3)).astype(np.float32),
        device="cuda")
    before = _lib.launch_counts["ell_spmv"]
    got = spmv(ell, x)
    assert _lib.launch_counts["ell_spmv"] == before + 1
    plain = spmv_plain(ell, x).cpu().double()
    diag, idx, blocks, mask = (t.cpu() for t in ell)
    xd = x.cpu().double()
    b = blocks.double() * mask[:, :, None, None]
    xg = xd[idx.long()]
    y64 = torch.einsum("nij,nj->ni", diag.double(), xd) + torch.einsum("nkij,nkj->ni", b, xg)
    scale = (torch.einsum("nij,nj->ni", diag.double().abs(), xd.abs())
             + torch.einsum("nkij,nkj->ni", b.abs(), xg.abs()))
    got = got.cpu().double()
    u = 2.0 ** -24
    assert bool(((got - plain).abs() <= (4 * k + 14) * u * scale).all())
    assert bool(((got - y64).abs() <= (k + 8) * u * scale).all())
