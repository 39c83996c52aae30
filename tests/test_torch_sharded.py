"""The port's sharded solve step (parallel/sharded.py) on the CPU: the
ragged padding in sorted space, the split with padded rows, the unpermute
tables (every rank simulated here), and the world-size-1 step against the
single-device solve_step. The multi-rank runs against the JAX package are
in test_torch_multiprocess.py."""

import numpy as np
import pytest
import torch

from precond_tpu_torch import SchwarzConfig
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse, unpack_sym96
from precond_tpu_torch.parallel import halo, sharded
from precond_tpu_torch.parallel.comm import Group, row_range
from precond_tpu_torch.solver import compute_sort_maps, prepare_with_system

torch.set_num_threads(2)


def _problem(side):
    mesh = cloth.make_grid(side, side, z_wave=0.02, mass=0.01)
    ell = cloth.assemble_system(mesh, device="cpu")
    maps = compute_sort_maps(torch.as_tensor(mesh.positions))
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((mesh.num_verts, 3))
                        .astype(np.float32))
    return ell, maps, b


def test_pad_sorted_system_appends_decoupled_rows():
    ell, maps, _ = _problem(24)
    _, es = prepare_with_system(ell, maps, SchwarzConfig())
    padded = sharded.pad_sorted_system(es, 640)
    assert padded.num_verts == 640 and sharded.pad_sorted_system(es, 576) is es
    assert torch.equal(padded.diag[576:], torch.eye(3).expand(64, 3, 3))
    assert not padded.mask[576:].any() and not padded.blocks[576:].any()
    assert torch.equal(padded.idx[576:], torch.arange(576, 640)[:, None].expand(64, es.max_degree)
                       .to(padded.idx.dtype))
    assert torch.equal(padded.diag[:576], es.diag) and torch.equal(padded.idx[:576], es.idx)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_split_with_padded_rows(kind):
    """576 rows padded to 640 on 4 shards: the pad rows get the dump parent
    and ancestor and identity blocks, interleaved per shard when packed."""
    cfg = SchwarzConfig(symv_kernel=kind)
    ell, maps, _ = _problem(24)
    state, _ = prepare_with_system(ell, maps, cfg)
    sap = halo.split_apply_state(state, cfg, 576, num_shards=4, rows=640)
    plain = halo.split_apply_state(state, cfg, 576, num_shards=1)
    tc = sap.total_coarse
    assert sap.going_next_fine.shape[0] == 640 and (sap.going_next_fine[576:] == tc).all()
    assert (sap.anc1[576:] == tc).all() and torch.equal(sap.anc1[:576], plain.anc1)
    assert torch.equal(sap.going_next_fine[:576], plain.going_next_fine)
    if kind == "dense":
        assert torch.equal(sap.inv_fine[:18], plain.inv_fine)
        assert torch.equal(sap.inv_fine[18:], torch.eye(96).expand(2, 96, 96))
    else:
        assert isinstance(sap.inv_fine, PackedInverse) and sap.inv_fine.f.shape[2] == 4 * 8
        blocks = torch.cat([unpack_sym96(halo.local_apply_state(sap, r, 160).inv_fine, 5)
                            for r in range(4)])
        assert torch.equal(blocks[:18], unpack_sym96(plain.inv_fine, 18))
        assert torch.equal(blocks[18:], torch.eye(96).expand(2, 96, 96))


@pytest.mark.parametrize("side,world", [(32, 2), (32, 4), (24, 4), (24, 8), (32, 8)])
def test_unpermute_plan_reaches_original_rows(side, world):
    """Every rank simulated: rank s holds sorted rows of its slab, the plan's
    all_to_all must leave rank d with original rows row_range(n, world, d)."""
    ell, maps, _ = _problem(side)
    n = ell.num_verts
    rows = -(-n // (world * 32)) * world * 32
    per = rows // world
    x = torch.randn((n, 3))
    xs = torch.cat([x[maps.sorted_to_orig.long()], torch.zeros((rows - n, 3))])
    send, recv = sharded.unpermute_plan(maps.orig_to_sorted, n, per, world)
    for d in range(world):
        received = torch.cat([xs[s * per: (s + 1) * per][torch.as_tensor(send[s, d]).long()]
                              for s in range(world)])
        start, stop = row_range(n, world, d)
        assert torch.equal(received[torch.as_tensor(recv[d]).long()][: stop - start], x[start:stop])


def test_shard_system_and_mesh():
    ell, _, _ = _problem(24)
    part = sharded.shard_system(Group.single("cpu"), ell)
    assert all(torch.equal(a, b) for a, b in zip(part, ell))
    assert sharded.make_mesh().shape == {"x": 1}


@pytest.mark.parametrize("side", [32, 24])
def test_world_one_step_matches_solve_step(side):
    cfg = SchwarzConfig()
    ell, maps, b = _problem(side)
    one = sharded.solve_step(ell, maps, b, cfg, max_iters=100, device="cpu")
    res = sharded.sharded_solve_step(Group.single("cpu"), cfg, max_iters=100, device="cpu")(
        ell, maps, b)
    assert abs(res.iterations - one.iterations) <= 3 and float(res.rel_residual) <= 1e-4
    scale = float(one.x.abs().max())
    np.testing.assert_allclose(res.x.numpy(), one.x.numpy(), rtol=5e-3, atol=5e-4 * scale)


def test_sharded_step_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded.sharded_solve_step(Group.single("cpu"), SchwarzConfig())
