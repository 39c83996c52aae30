"""Port vs JAX: the plain versions behind the three CUDA kernels.

On the CPU each kernel wrapper takes its plain PyTorch version; these tests
hold those against the JAX functions — the Pallas kernels run in interpret
mode as the JAX package's own tests run them — with the JAX tests'
tolerances:
  K1 inverse: 1e-5 relative, bitwise symmetric; cond ~1e7: < 3e-2 and
      min eigenvalue > 0 (tests/test_pallas_chol.py);
  K2 packed symv: rtol = atol = 2e-5 (tests/test_packed_symv.py:36-48);
  K3 dense symv: rtol = atol = 1e-5 (tests/test_pallas_symv.py:22).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from precond_tpu.ops import batched_inverse as jbi
from precond_tpu.ops.pallas import chol_inverse as jchol
from precond_tpu.ops.pallas import packed_symv as jps
from precond_tpu.ops.pallas import symv as jsymv
from precond_tpu_torch.ops import batched_inverse as tbi
from precond_tpu_torch.ops.cuda import packed_symv as tps
from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse
from precond_tpu_torch.ops.cuda.symv import batched_symv

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _spd(b, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 96, 96)).astype(np.float32)
    return np.einsum("bij,bkj->bik", q, q) + 96 * np.eye(96, dtype=np.float32)


def _stiff_spd():
    rng = np.random.default_rng(1)
    b = 4
    d = np.exp(rng.uniform(0, 16, size=(b, 96))).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((b, 96, 96)))
    spd = np.einsum("bik,bk,bjk->bij", q, d, q).astype(np.float32)
    return 0.5 * (spd + np.swapaxes(spd, 1, 2))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


# ---- K1: batched SPD inverse -------------------------------------------------

@pytest.fixture(scope="module")
def spd5():
    spd = _spd(5)
    return spd, spd_inverse(torch.as_tensor(spd)).numpy()


def test_k1_plain_vs_jax_panel(spd5):
    spd, got = spd5
    want = _np(jbi.invert_spd_blocks_panel(jnp.asarray(spd)))
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(got, np.swapaxes(got, 1, 2))  # exactly symmetric
    assert _rel(got, np.linalg.inv(spd.astype(np.float64))) < 1e-5


def test_k1_plain_vs_jax_pallas_unblocked(spd5):
    spd, got = spd5
    with pltpu.force_tpu_interpret_mode():
        want = _np(jchol.invert_spd_blocks_chol(jnp.asarray(spd), group=8, extract="onehot"))
    assert _rel(got, want) < 1e-5


def test_k1_plain_vs_jax_pallas_panel(spd5):
    spd, got = spd5
    with pltpu.force_tpu_interpret_mode():
        want = _np(jchol.invert_spd_blocks_chol_panel(jnp.asarray(spd), group=8))
    assert _rel(got, want) < 1e-5


def test_k1_plain_stiff_psd():
    spd = _stiff_spd()
    got = spd_inverse(torch.as_tensor(spd)).numpy()
    ref = np.linalg.inv(spd.astype(np.float64))
    assert _rel(got, ref) < 3e-2
    assert np.linalg.eigvalsh(got.astype(np.float64)).min() > 0
    np.testing.assert_array_equal(got, np.swapaxes(got, 1, 2))
    want = _np(jbi.invert_spd_blocks_panel(jnp.asarray(spd)))
    assert _rel(want, ref) < 3e-2  # the JAX function meets the same bound


def test_cholesky_oracle_vs_jax():
    spd = _spd(6, seed=3)
    got = tbi.invert_spd_blocks(torch.as_tensor(spd)).numpy()
    want = _np(jbi.invert_spd_blocks(jnp.asarray(spd)))
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(got, np.swapaxes(got, 1, 2))


def test_repair_nonfinite_matches_jax():
    rng = np.random.default_rng(0)
    inv = rng.standard_normal((5, 96, 96)).astype(np.float32)
    inv[2, 10, 3] = np.nan
    inv[4, 0, 0] = np.inf
    got = tbi._repair_nonfinite(torch.as_tensor(inv)).numpy()
    np.testing.assert_array_equal(got, _np(jbi._repair_nonfinite(jnp.asarray(inv))))
    np.testing.assert_array_equal(got[2], np.eye(96, dtype=np.float32))
    # repair=False leaves the non-finite block for the debug guards
    bad = _spd(3)
    bad[1, 0, 0] = np.nan
    out = spd_inverse(torch.as_tensor(bad), repair=False).numpy()
    assert not np.isfinite(out[1]).all() and np.isfinite(out[[0, 2]]).all()


@pytest.mark.parametrize("at", [0, 40, 95])
def test_k1_repair_per_panel_vs_jax(spd5, at):
    """A NaN on the diagonal in each 32-wide panel: the repaired block is the
    identity, as in the JAX function; unrepaired it stays non-finite; the
    other blocks keep their bits (the CUDA kernel repairs in its epilogue
    and is held to the same in tests/test_torch_gpu_kernels.py)."""
    spd, clean = spd5
    bad = spd.copy()
    bad[1, at, at] = np.nan
    got = spd_inverse(torch.as_tensor(bad)).numpy()
    np.testing.assert_array_equal(got[1], np.eye(96, dtype=np.float32))
    np.testing.assert_array_equal(got[[0, 2, 3, 4]], clean[[0, 2, 3, 4]])
    want = _np(jbi.invert_spd_blocks_panel(jnp.asarray(bad)))
    np.testing.assert_array_equal(want[1], np.eye(96, dtype=np.float32))
    assert _rel(got, want) < 1e-5
    raw = spd_inverse(torch.as_tensor(bad), repair=False).numpy()
    assert not np.isfinite(raw[1]).all()
    np.testing.assert_array_equal(raw[[0, 2, 3, 4]], clean[[0, 2, 3, 4]])


# ---- K2: packed symmetric symv -------------------------------------------------

def _random_sym(b, seed=0):
    a = np.random.default_rng(seed).standard_normal((b, 96, 96)).astype(np.float32)
    return 0.5 * (a + np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("b,block_b", [(1, 128), (3, 128), (64, 64), (130, 128), (300, 256)])
def test_k2_pack_and_plain_vs_jax(b, block_b):
    a = _random_sym(b, seed=2)
    rhs = np.random.default_rng(3).standard_normal((b, 96)).astype(np.float32)
    jp = jps.pack_sym96(jnp.asarray(a), block_b=block_b)
    tp = tps.pack_sym96(torch.as_tensor(a), block_b=block_b)
    np.testing.assert_array_equal(tp.f.numpy(), _np(jp.f))
    np.testing.assert_array_equal(tp.dg.numpy(), _np(jp.dg))
    assert tp.nb == int(jp.nb)
    want = _np(jps.packed_symv(jp, jnp.asarray(rhs), block_b=block_b))  # Pallas, interpreted
    got = tps.packed_symv(tp, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tps.packed_symv_ref(tp, torch.as_tensor(rhs)).numpy(),
                               _np(jps.packed_symv_ref(jp, jnp.asarray(rhs))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(tps.unpack_sym96(tp, b).numpy(), a)


def test_k2_plain_exactly_symmetric():
    packed = tps.pack_sym96(torch.as_tensor(_random_sym(4, seed=5)), block_b=128)
    ei = torch.zeros((4, 96))
    ej = torch.zeros((4, 96))
    ei[:, 7] = 1.0
    ej[:, 63] = 1.0
    assert torch.equal(tps.packed_symv(packed, ej)[:, 7], tps.packed_symv(packed, ei)[:, 63])


# ---- K3: dense block symv -------------------------------------------------------

@pytest.mark.parametrize("b,group", [(32, 16), (7, 16), (48, 8)])
def test_k3_plain_vs_jax_pallas(b, group):
    rng = np.random.default_rng(0)
    inv = rng.standard_normal((b, 96, 96)).astype(np.float32)
    rhs = rng.standard_normal((b, 96)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jsymv.batched_symv(jnp.asarray(inv), jnp.asarray(rhs), group=group))
    got = batched_symv(torch.as_tensor(inv), torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tbi.apply_block_inverse(torch.as_tensor(inv), torch.as_tensor(rhs)).numpy(),
        _np(jbi.apply_block_inverse(jnp.asarray(inv), jnp.asarray(rhs))), rtol=1e-5, atol=1e-5,
    )
