"""Port vs JAX: the analytic tile order of power-of-two grids.

The maps and every crossing are permutations, so they must match bit for
bit: sort maps for k = 3..7, the row-major crossings, the patch
factorization and the comp-major crossings on 32x32 and 64x64 grids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.utils import gridmorton as jgm
from precond_tpu_torch.utils import gridmorton as tgm

torch.set_num_threads(2)


def _x(k, w=3, seed=0):
    return np.random.default_rng(seed).standard_normal((4**k, w)).astype(np.float32)


@pytest.mark.parametrize("k", [3, 4, 5, 6, 7])
def test_sort_maps_bitwise(k):
    js2o, jo2s = jgm.sort_maps(k)
    ts2o, to2s = tgm.sort_maps(k)
    assert ts2o.dtype == np.int32 and to2s.dtype == np.int32
    np.testing.assert_array_equal(ts2o, js2o)
    np.testing.assert_array_equal(to2s, jo2s)
    np.testing.assert_array_equal(tgm._tile_rank(k), jgm._tile_rank(k))
    np.testing.assert_array_equal(tgm._rank_to_tile(k), jgm._rank_to_tile(k))


@pytest.mark.parametrize("side", [4, 8, 12, 16, 32, 64, 1024])
def test_supported_matches(side):
    for ny in (side, 2 * side):
        assert tgm.supported(side, ny) == jgm.supported(side, ny)


@pytest.mark.parametrize("k", [5, 6])
@pytest.mark.parametrize("w", [3, 9])
def test_row_crossings_bitwise(k, w):
    x = _x(k, w)
    g2m, m2g = tgm.crossing_pair(k)
    jg2m, jm2g = jgm.crossing_pair(k)
    assert (g2m.__name__, m2g.__name__) == (jg2m.__name__, jm2g.__name__)
    got = g2m(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg2m(jnp.asarray(x), k)))
    np.testing.assert_array_equal(m2g(torch.as_tensor(got), k).numpy(),
                                  np.asarray(jm2g(jnp.asarray(got), k)))
    np.testing.assert_array_equal(m2g(torch.as_tensor(got), k).numpy(), x)


@pytest.mark.parametrize("k", [5, 6])
def test_patch_crossings_bitwise(k):
    x = _x(k, seed=1)
    got = tgm.grid_to_morton_patch(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgm.grid_to_morton_patch(jnp.asarray(x), k)))
    np.testing.assert_array_equal(got, tgm.grid_to_morton(torch.as_tensor(x), k).numpy())
    back = tgm.morton_to_grid_patch(torch.as_tensor(got), k).numpy()
    np.testing.assert_array_equal(back, np.asarray(jgm.morton_to_grid_patch(jnp.asarray(got), k)))
    np.testing.assert_array_equal(tgm._patch_perm(), jgm._patch_perm())
    np.testing.assert_array_equal(tgm._patch_rank(k), jgm._patch_rank(k))
    np.testing.assert_array_equal(tgm._rank_to_patch(k), jgm._rank_to_patch(k))


@pytest.mark.parametrize("k", [5, 6])
def test_cm_crossings_bitwise(k):
    xt = np.ascontiguousarray(_x(k, seed=2).T)
    got = tgm.grid_to_morton_cm(torch.as_tensor(xt), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgm.grid_to_morton_cm(jnp.asarray(xt), k)))
    back = tgm.morton_to_grid_cm(torch.as_tensor(got), k).numpy()
    np.testing.assert_array_equal(back, np.asarray(jgm.morton_to_grid_cm(jnp.asarray(got), k)))
    np.testing.assert_array_equal(back, xt)


def test_crossing_index_is_the_sort_map():
    s2o, o2s = tgm.sort_maps(6)
    np.testing.assert_array_equal(tgm.sort_index(6, device="cpu").numpy(), s2o)
    np.testing.assert_array_equal(tgm.sort_index(6, inverse=True, device="cpu").numpy(), o2s)


def test_crossings_reject_wrong_sizes():
    with pytest.raises(ValueError, match="4096"):
        tgm.grid_to_morton(torch.zeros((100, 3)), 6)
    with pytest.raises(ValueError, match="32x32"):
        tgm.grid_to_morton_cm(torch.zeros((3, 256)), 4)
