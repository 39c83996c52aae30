"""Port vs JAX: banked domain Hessians h96, including the identity fill.

Tolerance atol 1e-6 * max|h| (rtol 0), the JAX package's own assembly
equivalence tolerance (tests/test_contact.py:264-266): the port writes the
one-hot reductions as batched matmuls, so only the summation order differs.
Collision terms go through both placements (small sets, and segment_place9
above BIG_PAIR_THRESHOLD pairs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import assembly as jas
from precond_tpu.ops import blockcsr as jbc
from precond_tpu.ops import hierarchy as jhi
from precond_tpu.ops import stencils as jst
from precond_tpu.solver import compute_sort_maps as jax_sort_maps
from precond_tpu_torch import convert
from precond_tpu_torch.config import SchwarzConfig as TorchConfig
from precond_tpu_torch.ops import assembly as tas
from precond_tpu_torch.ops import hierarchy as thi
from precond_tpu_torch.ops import stencils as tst

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _setup(g1, g2, mass):
    mesh = jcloth.make_grid(g1, g2, z_wave=0.02, mass=mass)
    ell = jcloth.assemble_system(mesh)
    maps = jax_sort_maps(jnp.asarray(mesh.positions))
    es = jbc.permute(ell, maps.sorted_to_orig, maps.orig_to_sorted)
    tes = convert.block_ell_from_numpy(*(_np(a) for a in es), device="cpu")
    return es, tes


@pytest.mark.parametrize("g,mass", [((12, 12), 1.0), ((40, 40), 0.001), ((64, 64), 1.0)])
@pytest.mark.parametrize("with_mm", [True, False])
def test_h96_matches_jax(g, mass, with_mm):
    es, tes = _setup(*g, mass)
    jcfg, tcfg = JaxConfig(), TorchConfig()
    jh, jm = jhi.build_hierarchy(es.idx, es.mask, jcfg, with_merge_map=True)
    th, tm = thi.build_hierarchy(tes.idx, tes.mask, tcfg, with_merge_map=True)
    want = _np(jas.assemble_banked_hessian(es, jh, jcfg, merge_map=jm if with_mm else None))
    got = tas.assemble_banked_hessian(tes, th, tcfg, merge_map=tm if with_mm else None).numpy()
    assert got.shape == want.shape == (tcfg.num_blocks(es.num_verts), 96, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_identity_fill_of_empty_diagonals():
    es, tes = _setup(12, 12, 1.0)  # 144 vertices: banks 4.5 full at level 0
    cfg = TorchConfig()
    th, tm = thi.build_hierarchy(tes.idx, tes.mask, cfg, with_merge_map=True)
    h = tas.assemble_banked_hessian(tes, th, cfg, merge_map=tm).numpy()
    # level 0: vertices 144..159 are padding -> identity diagonal blocks
    pad = h[4, 48:, 48:]
    np.testing.assert_array_equal(pad, np.eye(48, dtype=np.float32))
    np.testing.assert_array_equal(h[4, 48:, :48], 0.0)
    jh, jm = jhi.build_hierarchy(es.idx, es.mask, JaxConfig(), with_merge_map=True)
    want = _np(jas.assemble_banked_hessian(es, jh, JaxConfig(), merge_map=jm))
    np.testing.assert_array_equal(h[4], want[4])


def test_node_ancestor_table_exact():
    es, tes = _setup(40, 40, 1.0)
    jcfg, tcfg = JaxConfig(), TorchConfig()
    jh = jhi.build_hierarchy(es.idx, es.mask, jcfg)
    th = thi.build_hierarchy(tes.idx, tes.mask, tcfg)
    n = es.num_verts
    np.testing.assert_array_equal(
        tas.node_ancestor_table(th.going_next, tcfg.num_levels(n), tcfg.total_capacity(n)).numpy(),
        _np(jas.node_ancestor_table(jh.going_next, jcfg.num_levels(n), jcfg.total_capacity(n))),
    )


def _stencils(n, m, seed):
    """m random stencils (EF/EE/VF mix) over n vertices, as numpy fields of
    the JAX Stencils, ids already in sorted space."""
    rng = np.random.default_rng(seed)
    nverts = rng.choice([4, 5], m).astype(np.int32)
    nfirst = np.where(nverts == 5, 2, rng.choice([2, 3], m)).astype(np.int32)
    base = rng.integers(0, n, m)
    idx = np.clip(base[:, None] + rng.integers(-80, 80, (m, 5)), 0, n - 1).astype(np.int32)
    idx[np.arange(5)[None] >= nverts[:, None]] = 0
    w = rng.uniform(-1, 1, (m, 5)).astype(np.float32)
    w[np.arange(5)[None] >= nverts[:, None]] = 0
    d = rng.standard_normal((m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (idx, w, nverts, nfirst, rng.uniform(10, 1e3, m).astype(np.float32), d,
            rng.random(m) < 0.9)


def _collision_inputs(g, m, seed=0):
    es, tes = _setup(g, g, 0.001)
    fields = _stencils(es.num_verts, m, seed)
    js = jst.Stencils(*map(jnp.asarray, fields))
    ts = convert.stencils_from_numpy(*fields, device="cpu")
    return es, tes, js, ts


@pytest.mark.parametrize("g,m,big", [(12, 20, False), (40, 300, False), (40, 300, True)])
def test_h96_with_collisions_matches_jax(monkeypatch, g, m, big):
    """Collision terms through both placements (big: the threshold lowered
    so 3,000 pairs take segment_place9) against the JAX assembly."""
    es, tes, js, ts = _collision_inputs(g, m)
    if big:
        monkeypatch.setattr(jas, "BIG_PAIR_THRESHOLD", 0)
        monkeypatch.setattr(tas, "BIG_PAIR_THRESHOLD", 0)
    jcfg, tcfg = JaxConfig(), TorchConfig()
    jh, jm = jhi.build_hierarchy(es.idx, es.mask, jcfg, jst.stencil_pairs(js), with_merge_map=True)
    th, tm = thi.build_hierarchy(tes.idx, tes.mask, tcfg, tst.stencil_pairs(ts),
                                 with_merge_map=True)
    np.testing.assert_array_equal(th.going_next.numpy(), _np(jh.going_next))
    want = _np(jas.assemble_banked_hessian(es, jh, jcfg, jst.collision_terms(js), merge_map=jm))
    got = tas.assemble_banked_hessian(tes, th, tcfg, tst.collision_terms(ts), merge_map=tm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_collision_placements_agree():
    """The big (segment_place9) and small (row + scalar) placements give the
    same h96, and segment_place9 is a segmented sum: a tiny entry beside
    huge ones in other segments keeps its own value exactly."""
    _, tes, _, ts = _collision_inputs(40, 300, seed=3)
    cfg = TorchConfig()
    th, tm = thi.build_hierarchy(tes.idx, tes.mask, cfg, tst.stencil_pairs(ts), with_merge_map=True)
    terms = tst.collision_terms(ts)
    small = tas.assemble_banked_hessian(tes, th, cfg, terms, merge_map=tm)
    pad = 40000 - terms.pair_a.shape[0]
    z = terms.pair_a.new_zeros(pad)
    big_terms = terms._replace(
        pair_a=torch.cat([terms.pair_a, z]), pair_b=torch.cat([terms.pair_b, z]),
        pair_mat=torch.cat([terms.pair_mat, terms.pair_mat.new_zeros((pad, 3, 3))]),
        pair_valid=torch.cat([terms.pair_valid, z.bool()]))
    big = tas.assemble_banked_hessian(tes, th, cfg, big_terms, merge_map=tm)
    np.testing.assert_allclose(big.numpy(), small.numpy(), rtol=0,
                               atol=1e-6 * float(small.abs().max()))
    ids = torch.tensor([0, 0, 1, 2, 2, 2, 5], dtype=torch.int32)
    vals = torch.tensor([1e6, 1e6, 3.6, -1e6, 1e6, 2.5, 7.0])[:, None].expand(7, 9).contiguous()
    out = tas.segment_place9(ids, vals, torch.ones(7, dtype=torch.bool), 6)
    np.testing.assert_array_equal(out[:, 0].numpy(), np.float32([2e6, 3.6, 2.5, 0.0, 0.0, 7.0]))


def test_collisions_not_ported_yet():
    """Collision terms are ported: a small set goes through the assembly and
    lands where the JAX package puts it."""
    es, tes, js, ts = _collision_inputs(8, 6, seed=1)
    th = thi.build_hierarchy(tes.idx, tes.mask, TorchConfig(), tst.stencil_pairs(ts))
    jh = jhi.build_hierarchy(es.idx, es.mask, JaxConfig(), jst.stencil_pairs(js))
    got = tas.assemble_banked_hessian(tes, th, TorchConfig(), collisions=tst.collision_terms(ts))
    want = _np(jas.assemble_banked_hessian(es, jh, JaxConfig(), jst.collision_terms(js)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
