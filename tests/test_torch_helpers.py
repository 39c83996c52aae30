"""The port's small public helpers against the JAX package's, on the CPU:
the AABB predicates, the host Morton encoder, the native bridge's Morton
argsort (native and NumPy fallback), the spring adjacency lists and the
dropping scatter-add. Integer and boolean outputs must match bit for bit;
the float scatter within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu import native as jnative
from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import blockcsr as jblockcsr
from precond_tpu.utils import aabb as jaabb
from precond_tpu.utils import morton as jmorton
from precond_tpu_torch import native
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops import blockcsr
from precond_tpu_torch.utils import aabb, morton


def _boxes(rng, n):
    lo = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return lo, hi


def _pair(lo, hi):
    return (jaabb.Aabb(jnp.asarray(lo), jnp.asarray(hi)),
            aabb.Aabb(torch.as_tensor(lo), torch.as_tensor(hi)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aabb_predicates_match_jax(seed):
    rng = np.random.default_rng(seed)
    lo, hi = _boxes(rng, 1)
    jb, tb = _pair(lo[0], hi[0])
    pts = rng.uniform(-2, 2, (400, 3)).astype(np.float32)
    # points on the faces: the closed-box test must agree at the boundary
    pts[:50] = np.where(rng.random((50, 3)) < 0.5, lo[0], hi[0])
    for radius in (0.0, 0.1, 0.5):
        np.testing.assert_array_equal(
            aabb.contains(tb, torch.as_tensor(pts), radius=radius).numpy(),
            np.asarray(jaabb.contains(jb, jnp.asarray(pts), radius=radius)))
    olo, ohi = _boxes(rng, 300)
    jo, to = _pair(olo, ohi)
    np.testing.assert_array_equal(aabb.overlaps(tb, to).numpy(), np.asarray(jaabb.overlaps(jb, jo)))
    pa = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    pb = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    # axis-parallel segments: zero direction components take the 1e-6 rule
    pb[:100, rng.integers(0, 3)] = pa[:100, 0]
    pb[100:150] = pa[100:150]
    pb[150:200, :2] = pa[150:200, :2]
    hits = aabb.segment_intersects(tb, torch.as_tensor(pa), torch.as_tensor(pb)).numpy()
    np.testing.assert_array_equal(
        hits, np.asarray(jaabb.segment_intersects(jb, jnp.asarray(pa), jnp.asarray(pb))))
    assert hits.any() and not hits.all()
    grown_t = aabb.grow(tb, torch.as_tensor(pts[:7]))
    grown_j = jaabb.grow(jb, jnp.asarray(pts[:7]))
    for got, want in zip(grown_t, grown_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aabb_predicates_reference_cases():
    """tests/test_morton.py::test_aabb_predicates's cases, on the port."""
    box = aabb.Aabb(lower=torch.tensor([0.0, 0.0, 0.0]), upper=torch.tensor([1.0, 2.0, 3.0]))
    pts = torch.tensor([[0.5, 1.0, 1.5], [1.5, 1.0, 1.5], [-0.05, 0.0, 0.0]])
    assert aabb.contains(box, pts).tolist() == [True, False, False]
    assert aabb.contains(box, pts, radius=0.1).tolist() == [True, False, True]
    other = aabb.Aabb(lower=torch.tensor([0.9, 1.9, 2.9]), upper=torch.tensor([2.0, 3.0, 4.0]))
    disjoint = aabb.Aabb(lower=torch.tensor([1.1, 0.0, 0.0]), upper=torch.tensor([2.0, 1.0, 1.0]))
    assert bool(aabb.overlaps(box, other)) and not bool(aabb.overlaps(box, disjoint))
    pa = torch.tensor([[-1.0, 1.0, 1.5], [-1.0, 3.0, 1.5], [0.2, 0.5, 0.5]])
    pb = torch.tensor([[2.0, 1.0, 1.5], [2.0, 3.0, 1.5], [0.8, 0.5, 0.5]])
    # crossing, missing, inside
    assert aabb.segment_intersects(box, pa, pb).tolist() == [True, False, True]
    grown = aabb.grow(box, torch.tensor([[2.0, -1.0, 0.5]]))
    assert grown.lower.tolist() == [0.0, -1.0, 0.0] and grown.upper.tolist() == [2.0, 2.0, 3.0]


@pytest.mark.parametrize("scale", [1.0, 1.7])
def test_encode_np_matches_jax(scale):
    """The host uint64 encoder bit for bit, with points outside the cube
    (scale 1.7) clamped as the JAX one clamps them, in f32 and in f64 (each
    scaled and truncated in its own dtype), from a strided view too."""
    rng = np.random.default_rng(3)
    pts64 = rng.random((2000, 3)) * scale - (scale - 1.0) / 2
    for pts in (pts64.astype(np.float32), pts64, pts64[::2]):
        got = morton.encode_np(pts)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, jmorton.encode_np(pts))


def test_have_native():
    assert native.have_native() == jnative.have_native()
    assert native.have_native(), "g++ and make should build native/libprecond_host.so"


@pytest.mark.parametrize("fallback", [False, True], ids=["native", "numpy"])
def test_morton_argsort_matches_jax(fallback):
    rng = np.random.default_rng(1)
    pos = rng.random((700, 3)).astype(np.float32)
    pos[:, 2] *= 0.01
    pos[600:] = pos[:100]                       # ties keep their index order
    want = jnative.morton_argsort(pos)
    if fallback:
        saved = native._lib, native._lib_tried
        native._lib, native._lib_tried = None, True
        try:
            got = native.morton_argsort(pos)
        finally:
            native._lib, native._lib_tried = saved
    else:
        got = native.morton_argsort(pos)
        # the host C encoder against the port's own device encoder, on the
        # positions scaled to the unit cube per axis as the C code scales them
        unit = (pos - pos.min(0)) / np.ptp(pos, 0)
        np.testing.assert_array_equal(got, morton.argsort_morton(torch.from_numpy(unit)).numpy())
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nx,ny", [(6, 6), (5, 9)])
def test_adjacency_from_springs_matches_jax(nx, ny):
    mesh = cloth.make_grid(nx, ny)
    got = cloth.adjacency_from_springs(mesh.num_verts, mesh.springs)
    want = jcloth.adjacency_from_springs(mesh.num_verts, mesh.springs)
    assert len(got) == len(want) == mesh.num_verts
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    # a repeated spring, a self pair and an isolated vertex
    springs = np.array([[0, 2], [2, 0], [1, 1], [0, 2]], np.int32)
    for g, w in zip(cloth.adjacency_from_springs(4, springs),
                    jcloth.adjacency_from_springs(4, springs)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tail", [(), (3,), (3, 3)])
def test_scatter_accumulate_matches_jax(tail):
    """Repeated targets summed; targets in [-size, 0) count from the end and
    any other target outside [0, size) drops, as JAX's mode="drop" does."""
    rng = np.random.default_rng(4)
    size = 37
    tgt = rng.integers(-size - 5, size + 5, (40, 6)).astype(np.int32)
    vals = rng.standard_normal((40, 6) + tail).astype(np.float32)
    got = blockcsr.scatter_accumulate(size, torch.as_tensor(tgt), torch.as_tensor(vals))
    want = np.asarray(jblockcsr.scatter_accumulate(size, jnp.asarray(tgt), jnp.asarray(vals)))
    assert got.shape == want.shape == (size,) + tail
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    unique = np.arange(size, dtype=np.int32)[::-1].copy()
    uvals = rng.standard_normal((size,) + tail).astype(np.float32)
    np.testing.assert_array_equal(
        blockcsr.scatter_accumulate(size, torch.as_tensor(unique), torch.as_tensor(uvals),
                                    unique=True).numpy(),
        np.asarray(jblockcsr.scatter_accumulate(size, jnp.asarray(unique), jnp.asarray(uvals),
                                                unique=True)))
