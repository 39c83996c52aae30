"""Port vs JAX: the stencil-form grid system and its SpMV (K4's plain version).

Same meshes and vectors (numpy, from a seed) through both packages:
  * stencil structure bitwise; system planes within 1e-6 * max;
  * spmv / spmv_t / K4's plain version against JAX gridstencil.spmv AND the
    Pallas spmv_system in interpret mode, plain and pinned, at
    5e-6 * max|y| (tests/test_pallas_stencil_spmv.py:21-23);
  * the symmetric half-storage SpMV and pin_vertices against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.models import cloth as jcloth
from precond_tpu.ops import gridassembly as jga
from precond_tpu.ops import gridstencil as jgs
from precond_tpu.ops.pallas.stencil_spmv import spmv_system as jax_spmv_system
from precond_tpu_torch import convert
from precond_tpu_torch.models import cloth as tcloth
from precond_tpu_torch.ops import gridassembly as tga
from precond_tpu_torch.ops import gridstencil as tgs
from precond_tpu_torch.ops.cuda import stencil_spmv as tk4

torch.set_num_threads(2)


def _mesh(g, pkg, z_wave=0.02):
    return pkg.make_grid(g, g, z_wave=z_wave, mass=0.001, dt=1.0 / 60.0)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _pinned_pair(g):
    """JAX and port systems pinned at the first row (32 boundary vertices at g=32)."""
    jsys = jcloth.assemble_system_stencil(_mesh(g, jcloth, 0.0))
    tsys = tcloth.assemble_system_stencil(_mesh(g, tcloth, 0.0), device="cpu")
    pinned = np.zeros(g * g, bool)
    pinned[:g] = True
    return (jgs.pin_vertices(jsys, jnp.asarray(pinned), 360.0),
            tgs.pin_vertices(tsys, torch.as_tensor(pinned), 360.0))


@pytest.mark.parametrize("g", [32, 64])
def test_stencil_structure_bitwise(g):
    m = _mesh(g, jcloth)
    joff, jks = jcloth.stencil_structure_from_springs(g, g, m.springs, m.stiffness)
    toff, tks = tcloth.stencil_structure_from_springs(g, g, m.springs, m.stiffness)
    assert toff == joff
    np.testing.assert_array_equal(tks, jks)


@pytest.mark.parametrize("g", [32, 64])
@pytest.mark.parametrize("sym", [False, True])
def test_assemble_system_stencil_matches_jax(g, sym):
    jsys = jcloth.assemble_system_stencil(_mesh(g, jcloth), sym=sym)
    tsys = tcloth.assemble_system_stencil(_mesh(g, tcloth), sym=sym, device="cpu")
    assert (tsys.offsets, tsys.grid, tsys.sym) == (jsys.offsets, jsys.grid, jsys.sym)
    assert tsys.num_verts == jsys.num_verts
    _close(tsys.diag_t, jsys.diag_t, 1e-6)
    _close(tsys.dirs_t, jsys.dirs_t, 1e-6)
    _close(tsys.diag, jsys.diag, 1e-6)


@pytest.mark.parametrize("g", [32, 64])
def test_assemble_system_grid_matches_jax(g):
    jdg, jdr, joff = jcloth.assemble_system_grid(_mesh(g, jcloth))
    tdg, tdr, toff = tcloth.assemble_system_grid(_mesh(g, tcloth), device="cpu")
    assert toff == joff
    _close(tdg, jdg, 1e-6)
    _close(tdr, jdr, 1e-6)


@pytest.mark.parametrize("g", [32, 64])
def test_spmv_matches_jax_and_pallas(g):
    """The port's spmv, spmv_t and K4 plain version on the JAX system's
    own planes, against the XLA form and the Pallas kernel (interpret)."""
    jsys = jcloth.assemble_system_stencil(_mesh(g, jcloth))
    tsys = convert.stencil_system_from_numpy(np.asarray(jsys.diag_t), np.asarray(jsys.dirs_t),
                                             jsys.offsets, jsys.grid, device="cpu")
    x = np.random.default_rng(0).standard_normal((g * g, 3)).astype(np.float32)
    y_xla = np.asarray(jgs.spmv(jsys, jnp.asarray(x)))
    y_pallas = np.asarray(jax_spmv_system(jsys, jnp.asarray(x), tile=512, interpret=True))
    y = tgs.spmv(tsys, torch.as_tensor(x)).numpy()
    yt = tgs.spmv_t(tsys, torch.as_tensor(x.T.copy())).numpy()
    plain = tgs.spmv_t_plain(tsys.diag_t, tsys.dirs_t, torch.as_tensor(x.T.copy()),
                             tsys.offsets, tsys.grid).numpy()
    fused = tk4.spmv_system(tsys, torch.as_tensor(x)).numpy()
    for got in (y, yt.T, plain.T, fused):
        _close(got, y_xla, 5e-6)
        _close(got, y_pallas, 5e-6)


@pytest.mark.parametrize("g", [32, 64])
def test_spmv_on_port_system_matches_jax(g):
    """Each package on its own assembled system."""
    jsys = jcloth.assemble_system_stencil(_mesh(g, jcloth))
    tsys = tcloth.assemble_system_stencil(_mesh(g, tcloth), device="cpu")
    x = np.random.default_rng(3).standard_normal((g * g, 3)).astype(np.float32)
    _close(tgs.spmv(tsys, torch.as_tensor(x)), jgs.spmv(jsys, jnp.asarray(x)), 5e-6)


def test_spmv_pinned_matches_jax_and_pallas(g=32):
    jsys, tsys = _pinned_pair(g)
    _close(tsys.dirs_t, jsys.dirs_t, 1e-6)
    _close(tsys.diag_t, jsys.diag_t, 1e-6)
    x = np.random.default_rng(1).standard_normal((g * g, 3)).astype(np.float32)
    y_xla = np.asarray(jgs.spmv(jsys, jnp.asarray(x)))
    y_pallas = np.asarray(jax_spmv_system(jsys, jnp.asarray(x), tile=256, interpret=True))
    y = tgs.spmv(tsys, torch.as_tensor(x)).numpy()
    _close(y, y_xla, 5e-6)
    _close(y, y_pallas, 5e-6)


def test_spmv_nonfinite_off_grid_is_never_read(g=32):
    """The plain version (and K4) skip off-grid neighbours instead of reading
    a flat shift that wraps a row edge: a non-finite value at (0, g-1)
    reaches only its true grid neighbours, not (1, 0) one flat step away."""
    tsys = tcloth.assemble_system_stencil(_mesh(g, tcloth), device="cpu")
    x = torch.zeros((3, g * g))
    x[:, g - 1] = float("inf")
    y = tgs.spmv_t(tsys, x)
    near = np.zeros((g, g), bool)
    for di, dj in tsys.offsets + ((0, 0),):
        i, j = 0 - di, g - 1 - dj               # rows whose neighbour is (0, g-1)
        if 0 <= i < g and 0 <= j < g:
            near[i, j] = True
    finite = torch.isfinite(y).all(dim=0).numpy().reshape(g, g)
    np.testing.assert_array_equal(finite, ~near)


@pytest.mark.parametrize("g", [32, 64])
def test_sym_spmv_matches_jax(g):
    jsys = jcloth.assemble_system_stencil(_mesh(g, jcloth), sym=True)
    tsys = convert.stencil_system_from_numpy(np.asarray(jsys.diag_t), np.asarray(jsys.dirs_t),
                                             jsys.offsets, jsys.grid, sym=True, device="cpu")
    full = tcloth.assemble_system_stencil(_mesh(g, tcloth), device="cpu")
    x = np.random.default_rng(2).standard_normal((g * g, 3)).astype(np.float32)
    y = tgs.spmv(tsys, torch.as_tensor(x)).numpy()
    _close(y, jgs.spmv(jsys, jnp.asarray(x)), 5e-6)
    _close(y, tgs.spmv(full, torch.as_tensor(x)).numpy(), 5e-6)
    with pytest.raises(ValueError, match="full-plane"):
        tk4.spmv_system(tsys, torch.as_tensor(x))


def test_pin_grid_blocks_matches_jax(g=32):
    jdg, jdr, off = jcloth.assemble_system_grid(_mesh(g, jcloth))
    pinned = np.zeros(g * g, bool)
    pinned[:g] = True
    pinned[5 * g + 7] = True
    jd, jr = jga.pin_grid_blocks(jdg, jdr, off, (g, g), jnp.asarray(pinned), 360.0)
    td, tr = tga.pin_grid_blocks(torch.as_tensor(np.array(jdg)), torch.as_tensor(np.array(jdr)),
                                 off, (g, g), torch.as_tensor(pinned), 360.0)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
