"""Port vs JAX: the 3-D box stencil SpMV (ops/boxstencil.py) and the box
sort maps (utils/boxmorton.py).

The box maps and crossings bit for bit; the planes against the JAX ones
and the SpMV against the block-ELL oracle at tests/test_boxstencil.py's
2e-5 * max|y|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.models import tetmesh as jtet
from precond_tpu.ops import boxstencil as jbs
from precond_tpu.utils import boxmorton as jbm
from precond_tpu_torch import convert
from precond_tpu_torch.models import tetmesh as ttet
from precond_tpu_torch.ops import blockcsr, boxstencil
from precond_tpu_torch.utils import boxmorton as tbm

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


@pytest.mark.parametrize("dims", [(4, 4, 2), (8, 8, 4), (16, 8, 8), (8, 16, 32)])
def test_box_maps_and_crossings_bitwise(dims):
    s2o, o2s = tbm.sort_maps(*dims)
    js2o, jo2s = jbm.sort_maps(*dims)
    assert s2o.dtype == js2o.dtype == np.int32
    np.testing.assert_array_equal(s2o, js2o)
    np.testing.assert_array_equal(o2s, jo2s)
    assert tbm.supported(*dims) == jbm.supported(*dims)
    n = int(np.prod(dims))
    x = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    got = tbm.box_to_morton(torch.as_tensor(x), *dims)
    np.testing.assert_array_equal(got.numpy(), _np(jbm.box_to_morton(jnp.asarray(x), *dims)))
    np.testing.assert_array_equal(tbm.morton_to_box(got, *dims).numpy(), x)
    np.testing.assert_array_equal(
        tbm.morton_to_box(torch.as_tensor(x), *dims).numpy(),
        _np(jbm.morton_to_box(jnp.asarray(x), *dims)))


def test_box_support_matches_jax():
    for dims in [(4, 4, 2), (4, 4, 1), (2, 4, 4), (6, 8, 8), (8, 8, 8), (64, 64, 64)]:
        assert tbm.supported(*dims) == jbm.supported(*dims), dims


@pytest.mark.parametrize("dims", [(6, 5, 4), (8, 8, 4)])
def test_box_stencil_spmv_matches_ell_and_jax(dims):
    mesh = ttet.make_box(*dims, mass=0.05, youngs=5e4)
    jell = jtet.assemble_system(mesh)
    ell = blockcsr.BlockEll(*(torch.as_tensor(_np(a)) for a in jell))
    sys = boxstencil.from_ell(ell, dims)
    jsys = jbs.from_ell(jell, dims)
    assert sys.offsets == jsys.offsets and sys.dims == tuple(jsys.dims)
    np.testing.assert_array_equal(sys.dirs_t.numpy(), _np(jsys.dirs_t))
    np.testing.assert_array_equal(sys.diag_t.numpy(), _np(jsys.diag_t))
    x = np.random.default_rng(0).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    y_ell = blockcsr.spmv(ell, torch.as_tensor(x)).numpy()
    y_st = boxstencil.spmv(sys, torch.as_tensor(x)).numpy()
    scale = np.abs(y_ell).max()
    np.testing.assert_allclose(y_st, y_ell, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(y_st, _np(jbs.spmv(jsys, jnp.asarray(x))), rtol=0, atol=2e-5 * scale)
    # completeness: total block mass carried by the planes equals the ELL's
    tot_planes = float(sys.dirs_t.abs().sum())
    tot_ell = float((ell.blocks * ell.mask[:, :, None, None]).abs().sum())
    np.testing.assert_allclose(tot_planes, tot_ell, rtol=1e-5)
    # carried across by convert, the JAX planes give the same system
    carried = convert.box_stencil_system_from_numpy(_np(jsys.diag_t), _np(jsys.dirs_t),
                                                    jsys.offsets, jsys.dims, device="cpu")
    np.testing.assert_array_equal(boxstencil.spmv(carried, torch.as_tensor(x)).numpy(), y_st)
