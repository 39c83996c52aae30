"""Port vs JAX: the cluster hierarchy, exactly.

going_next, coarse_space, level_sizes, overflow, onehot, pos, pb and the
neighbor merge map are integer (or 0/1) outputs, so they must match bit for
bit; the inputs include partial end-of-level banks (inactive slots, pos -1)
and a squeezed-headroom case that overflows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import blockcsr as jbc
from precond_tpu.ops import hierarchy as jhi
from precond_tpu.solver import compute_sort_maps as jax_sort_maps
from precond_tpu_torch import convert
from precond_tpu_torch.config import SchwarzConfig as TorchConfig
from precond_tpu_torch.ops import hierarchy as thi

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _sorted_adjacency(g1, g2, seed=None):
    mesh = jcloth.make_grid(g1, g2, z_wave=0.02)
    pos = mesh.positions
    if seed is not None:  # scramble the geometry: a less regular clustering
        pos = pos + np.random.default_rng(seed).normal(0, 0.01, pos.shape).astype(np.float32)
    ell = jcloth.assemble_system(mesh)
    maps = jax_sort_maps(jnp.asarray(pos))
    es = jbc.permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    return _np(es.idx), _np(es.mask)


CASES = {
    "cloth12": dict(g=(12, 12)),        # partial end-of-level banks
    "cloth40": dict(g=(40, 40)),        # inactive coarse slots (pos -1)
    "cloth64": dict(g=(64, 64)),
    "strip": dict(g=(4, 200)),
    "scrambled": dict(g=(33, 31), seed=5),
    "overflow": dict(g=(40, 40), cfg={"level_headroom": 0.05}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_hierarchy_exact(case):
    spec = CASES[case]
    idx, mask = _sorted_adjacency(*spec["g"], seed=spec.get("seed"))
    kw = spec.get("cfg", {})
    jh, jm = jhi.build_hierarchy(jnp.asarray(idx), jnp.asarray(mask), JaxConfig(**kw),
                                 with_merge_map=True)
    th, tm = thi.build_hierarchy(torch.as_tensor(idx), torch.as_tensor(mask), TorchConfig(**kw),
                                 with_merge_map=True)
    for name in jh._fields:
        np.testing.assert_array_equal(getattr(th, name).numpy(), _np(getattr(jh, name)),
                                      err_msg=name)
    for name in jm._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), _np(getattr(jm, name)),
                                      err_msg=name)
    if case == "overflow":
        assert bool(th.overflow)
    if case == "cloth40":
        assert (th.pos.numpy() == -1).any()  # inactive coarse slots
    th2 = thi.build_hierarchy(torch.as_tensor(idx), torch.as_tensor(mask), TorchConfig(**kw))
    np.testing.assert_array_equal(th2.going_next.numpy(), th.going_next.numpy())


@pytest.mark.parametrize("case", ["cloth12", "cloth40", "scrambled"])
def test_restriction_operators_and_ancestors_exact(case):
    spec = CASES[case]
    idx, mask = _sorted_adjacency(*spec["g"], seed=spec.get("seed"))
    n = idx.shape[0]
    jcfg, tcfg = JaxConfig(), TorchConfig()
    jh = jhi.build_hierarchy(jnp.asarray(idx), jnp.asarray(mask), jcfg)
    th = thi.build_hierarchy(torch.as_tensor(idx), torch.as_tensor(mask), tcfg)
    j_ops = jhi.restriction_operators(jh.going_next, jcfg, n)
    t_ops = thi.restriction_operators(th.going_next, tcfg, n)
    for a, b in zip(j_ops, t_ops):
        np.testing.assert_array_equal(b.numpy(), _np(a))
    # the standalone rederivation equals what the builder emitted
    for a, b in zip(t_ops, (th.onehot, th.pos, th.pb)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(thi.ancestor_node_ids(th, tcfg, n).numpy(),
                                  _np(jhi.ancestor_node_ids(jh, jcfg, n)))


def test_closure_and_cluster_banks_exact():
    rng = np.random.default_rng(0)
    adj = rng.random((20, 32, 32)) < 0.04
    adj = adj | np.swapaxes(adj, 1, 2)
    valid = np.arange(32)[None, :] < rng.integers(0, 33, (20, 1))
    jc = jhi.transitive_closure_inbank(jnp.asarray(adj), 5)
    tc = thi.transitive_closure_inbank(torch.as_tensor(adj), 5)
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    for a, b in zip(jhi._cluster_banks(jc, jnp.asarray(valid)),
                    thi._cluster_banks(tc, torch.as_tensor(valid))):
        np.testing.assert_array_equal(b.numpy(), _np(a))


def _random_pairs(n, m, seed):
    """m stencil-like vertex pairs, a third of them masked off."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, m).astype(np.int32)
    b = np.clip(a + rng.integers(-3 * 32, 3 * 32, m), 0, n - 1).astype(np.int32)
    return a, b, rng.random(m) < 0.67


def test_pairs_not_ported_yet():
    """Collision-stencil pairs are ported: build_hierarchy(..., pairs) gives
    JAX's hierarchy and merge map bit for bit, and the pairs change it."""
    idx, mask = _sorted_adjacency(8, 8)
    a, b, v = _random_pairs(64, 40, 0)
    jh = jhi.build_hierarchy(jnp.asarray(idx), jnp.asarray(mask), JaxConfig(),
                             jhi.StencilPairs(jnp.asarray(a), jnp.asarray(b), jnp.asarray(v)))
    th = thi.build_hierarchy(torch.as_tensor(idx), torch.as_tensor(mask), TorchConfig(),
                             pairs=thi.StencilPairs(*map(torch.as_tensor, (a, b, v))))
    for name in jh._fields:
        np.testing.assert_array_equal(getattr(th, name).numpy(), _np(getattr(jh, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case,m", [("cloth40", 300), ("cloth64", 2000), ("scrambled", 500),
                                    ("overflow", 300)])
def test_build_hierarchy_with_pairs_exact(case, m):
    spec = CASES[case]
    idx, mask = _sorted_adjacency(*spec["g"], seed=spec.get("seed"))
    kw = spec.get("cfg", {})
    a, b, v = _random_pairs(idx.shape[0], m, 1)
    jp = jhi.StencilPairs(jnp.asarray(a), jnp.asarray(b), jnp.asarray(v))
    tp = thi.StencilPairs(*map(torch.as_tensor, (a, b, v)))
    jh, jm = jhi.build_hierarchy(jnp.asarray(idx), jnp.asarray(mask), JaxConfig(**kw), jp,
                                 with_merge_map=True)
    th, tm = thi.build_hierarchy(torch.as_tensor(idx), torch.as_tensor(mask), TorchConfig(**kw),
                                 tp, with_merge_map=True)
    for name in jh._fields:
        np.testing.assert_array_equal(getattr(th, name).numpy(), _np(getattr(jh, name)),
                                      err_msg=name)
    for name in jm._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), _np(getattr(jm, name)),
                                      err_msg=name)
    plain = thi.build_hierarchy(torch.as_tensor(idx), torch.as_tensor(mask), TorchConfig(**kw))
    # contact connectivity merges clusters: never more clusters than without
    assert (th.level_sizes[1:] <= plain.level_sizes[1:]).all()


def test_neighbor_warp_masks_to_adjacency_exact():
    rng = np.random.default_rng(2)
    rows = rng.integers(-40, 200, (50, 4)).astype(np.int32)
    cols = rng.integers(0, 160, (50, 4)).astype(np.int32)
    contrib = rng.random((50, 4)) < 0.5
    want = jhi.neighbor_warp_masks_to_adjacency(jnp.asarray(rows), jnp.asarray(cols),
                                                jnp.asarray(contrib), 5)
    got = thi.neighbor_warp_masks_to_adjacency(*map(torch.as_tensor, (rows, cols, contrib)), 5)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_hierarchy_via_convert_roundtrip():
    """The ELL carried across by convert.py builds the same hierarchy."""
    mesh = jcloth.make_grid(20, 20, z_wave=0.02)
    ell = jcloth.assemble_system(mesh)
    maps = jax_sort_maps(jnp.asarray(mesh.positions))
    es = jbc.permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    tes = convert.block_ell_from_numpy(*(_np(a) for a in es), device="cpu")
    jh = jhi.build_hierarchy(es.idx, es.mask, JaxConfig())
    th = thi.build_hierarchy(tes.idx, tes.mask, TorchConfig())
    np.testing.assert_array_equal(th.coarse_space.numpy(), _np(jh.coarse_space))
