"""The port's halo tables and fine/coarse split (parallel/halo.py) against
the JAX package's, on the same inputs: build_halo_system's tables bit for
bit in both exchange modes, split_apply_state's fields for dense and
packed states, and the errors the port raises where JAX asserts."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JCfg
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import blockcsr as jblockcsr
from precond_tpu.ops.pallas.packed_symv import pack_sym96_cm as jpack_cm
from precond_tpu.parallel import halo as jhalo
from precond_tpu.solver import compute_sort_maps as jsort_maps
from precond_tpu.solver import prepare_preconditioner as jprepare

from precond_tpu_torch import SchwarzConfig, convert
from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse
from precond_tpu_torch.parallel import halo
from precond_tpu_torch.parallel.comm import Group

torch.set_num_threads(2)


def _sorted_system(kind):
    """(JAX sorted ELL, its mesh) for a Morton-sorted square or a banded strip."""
    if kind == "banded":   # identity order on a strip: short jumps, thin halo
        mesh = jcloth.make_grid(128, 8, z_wave=0.0)
        return jcloth.assemble_system(mesh), mesh
    side = {"morton32": 32, "morton128": 128}[kind]
    mesh = jcloth.make_grid(side, side, z_wave=0.02, mass=0.01)
    ell = jcloth.assemble_system(mesh)
    maps = jsort_maps(jnp.asarray(mesh.positions))
    return jblockcsr.permute(ell, maps.sorted_to_orig, maps.orig_to_sorted), mesh


def _port_ell(ell):
    return convert.block_ell_from_numpy(ell.diag, ell.idx, ell.blocks, ell.mask, device="cpu")


@pytest.mark.parametrize("kind,shards,mode", [
    ("morton32", 2, "contiguous"), ("morton32", 4, "sparse"), ("morton32", 8, "sparse"),
    ("banded", 4, "contiguous"), ("banded", 8, "contiguous"), ("morton128", 8, "sparse"),
    ("morton32", 1, "contiguous"),
])
def test_halo_tables_match_jax(kind, shards, mode):
    ell, _ = _sorted_system(kind)
    ref = jhalo.build_halo_system(ell, shards)
    got = halo.build_halo_system(_port_ell(ell), shards)
    assert (got.halo < 0) == (mode == "sparse") and got.halo == ref.halo
    assert got.shard_rows == ref.shard_rows
    for f in ("idx_ext", "send_idx", "recv_perm"):
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype == np.int32, f
        np.testing.assert_array_equal(have, want, err_msg=f)
    np.testing.assert_array_equal(got.diag.numpy(), np.asarray(ref.diag))
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(ref.blocks))


def test_local_halo_is_each_ranks_rows():
    ell, _ = _sorted_system("morton32")
    hs = halo.build_halo_system(_port_ell(ell), 4)
    for rank in range(4):
        lh = halo.local_halo(hs, rank)
        rows = slice(rank * 256, (rank + 1) * 256)
        assert torch.equal(lh.idx_ext, hs.idx_ext[rows].long())
        assert torch.equal(lh.send, hs.send_idx[rank].long())
        assert torch.equal(lh.recv, hs.recv_perm[rank].long())


@pytest.fixture(scope="module")
def states():
    """JAX dense and packed states of the 32x32 Morton cloth, as numpy."""
    mesh = jcloth.make_grid(32, 32, z_wave=0.02, mass=0.01)
    ell = jcloth.assemble_system(mesh)
    maps = jsort_maps(jnp.asarray(mesh.positions))
    out = {}
    for kind in ("dense", "packed"):
        cfg = JCfg(symv_kernel=kind)
        out[kind] = (jprepare(ell, maps, cfg), cfg)
    return mesh.num_verts, out


def _port_state(state):
    return convert.apply_state_from_numpy(*[np.asarray(f) if not hasattr(f, "f") else f
                                            for f in state], device="cpu")


@pytest.mark.parametrize("kind", ["dense", "packed"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_split_apply_state_matches_jax(states, kind, shards):
    n, by_kind = states
    state, jcfg = by_kind[kind]
    ref = jhalo.split_apply_state(state, jcfg, n, num_shards=shards)
    cfg = SchwarzConfig(symv_kernel=kind)
    got = halo.split_apply_state(_port_state(state), cfg, n, num_shards=shards)
    for f in ("going_next_fine", "anc1", "going_next_coarse"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert (got.n, got.total_coarse, got.l1_live) == (ref.n, ref.total_coarse, ref.l1_live)
    assert got.num_shards == shards
    for part in ("inv_fine", "inv_coarse"):
        g, r = getattr(got, part), getattr(ref, part)
        if kind == "packed":
            assert isinstance(g, PackedInverse) and g.nb == int(r.nb)
            np.testing.assert_array_equal(g.f.numpy(), np.asarray(r.f), err_msg=part)
            np.testing.assert_array_equal(g.dg.numpy(), np.asarray(r.dg), err_msg=part)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=part)


def test_packed_split_interleaves_per_shard(states):
    """32 fine blocks over 8 shards: 4 each, padded to 8 inside every
    shard's slice; each rank keeps a contiguous copy of its slice."""
    n, by_kind = states
    state, _ = by_kind["packed"]
    sap = halo.split_apply_state(_port_state(state), SchwarzConfig(symv_kernel="packed"), n, 8)
    assert sap.inv_fine.f.shape[2] == 8 * 8
    f4 = sap.inv_fine.f.reshape(48, 96, 8, 8)
    assert not f4[..., 4:].any() and not sap.inv_fine.dg.reshape(96, 8, 8)[..., 4:].any()
    for rank in (0, 5):
        la = halo.local_apply_state(sap, rank, n // 8)
        assert la.inv_fine.f.is_contiguous() and la.inv_fine.f.shape == (48, 96, 8)
        assert torch.equal(la.inv_fine.f, f4[:, :, rank])


def test_split_rejects_uneven_shards_and_cm(states):
    n, by_kind = states
    state, _ = by_kind["dense"]
    st = _port_state(state)
    with pytest.raises(ValueError, match="do not split over 3 shards"):
        halo.split_apply_state(st, SchwarzConfig(), n, num_shards=3)
    cm = convert.packed_inverse_cm_from_numpy(*jpack_cm(state.inv96, block_b=8), device="cpu")
    with pytest.raises(ValueError, match="comp-major"):
        halo.split_apply_state(st._replace(inv96=cm), SchwarzConfig(), n, num_shards=8)
    with pytest.raises(ValueError, match="multiple of 32"):
        halo.split_apply_state(st, SchwarzConfig(), n, rows=n - 32)


def test_solve_sorted_refuses_packed_split_for_another_group(states):
    """A packed table padded for 8 shards must not run on a group of 1: its
    interleaved padding would misalign every rank's blocks."""
    n, by_kind = states
    state, _ = by_kind["packed"]
    cfg = SchwarzConfig(symv_kernel="packed")
    st = _port_state(state)
    ell, _ = _sorted_system("morton32")
    hs = halo.build_halo_system(_port_ell(ell), 1)
    sap = halo.split_apply_state(st, cfg, n, num_shards=8)
    with pytest.raises(ValueError, match="split for 8 shards"):
        halo.solve_sorted(Group.single("cpu"), cfg, hs, sap, torch.zeros((n, 3)))
    # the same state split for the group's size solves
    ok = halo.solve_sorted(Group.single("cpu"), cfg, hs,
                           halo.split_apply_state(st, cfg, n, num_shards=1),
                           torch.ones((n, 3)), max_iters=200)
    assert float(ok.rel_residual) <= 1e-4


def test_build_halo_system_rejects_unaligned_rows():
    ell, _ = _sorted_system("morton32")
    with pytest.raises(ValueError, match="bank-aligned"):
        halo.build_halo_system(_port_ell(ell), 3)


def test_convert_carries_jax_halo_pieces(states):
    """A JAX HaloSystem / ShardedApply carried across (convert) gives the
    same per-rank pieces as the port's own build."""
    n, by_kind = states
    state, jcfg = by_kind["packed"]
    ell, _ = _sorted_system("morton32")
    jh = jhalo.build_halo_system(ell, 4)
    js = jhalo.split_apply_state(state, jcfg, n, num_shards=4)
    hs = convert.halo_system_from_numpy(*[np.asarray(f) if not isinstance(f, int) else f
                                          for f in jh], device="cpu")
    sap = convert.sharded_apply_from_numpy(
        np.asarray(js.going_next_fine), np.asarray(js.anc1), js.inv_fine, js.inv_coarse,
        np.asarray(js.going_next_coarse), js.n, js.total_coarse, js.l1_live, num_shards=4,
        device="cpu")
    own = halo.split_apply_state(_port_state(state), dataclasses.replace(
        SchwarzConfig(), symv_kernel="packed"), n, 4)
    mine = halo.build_halo_system(_port_ell(ell), 4)
    for rank in range(4):
        a, b = halo.local_apply_state(sap, rank, 256), halo.local_apply_state(own, rank, 256)
        assert torch.equal(a.inv_fine.f, b.inv_fine.f) and torch.equal(a.gnf, b.gnf)
        assert torch.equal(a.anc1, b.anc1) and a.l1 == b.l1
        la, lb = halo.local_halo(hs, rank), halo.local_halo(mine, rank)
        assert torch.equal(la.idx_ext, lb.idx_ext) and torch.equal(la.send, lb.send)
