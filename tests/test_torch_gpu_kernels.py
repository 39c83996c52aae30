"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card and skip without one (the decision is made inside a
fixture, so every test collects everywhere). They import no JAX, so they
run where only PyTorch is installed (``-o markers=...`` registers the gpu
marker that tests/conftest.py registers otherwise):

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA card" -m gpu tests/test_torch_gpu_kernels.py

Tolerances are those of the JAX package's own tests of the same functions
(tests/test_pallas_chol.py, tests/test_packed_symv.py, tests/test_pallas_symv.py).
"""

import numpy as np
import pytest
import torch

from precond_tpu_torch.ops.batched_inverse import apply_block_inverse, invert_spd_blocks_panel
from precond_tpu_torch.ops.cuda import _lib
from precond_tpu_torch.ops.cuda.packed_symv import pack_sym96, packed_symv, packed_symv_ref
from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse
from precond_tpu_torch.ops.cuda.symv import batched_symv

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd(b, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 96, 96)).astype(np.float32)
    return np.einsum("bij,bkj->bik", q, q) + 96 * np.eye(96, dtype=np.float32)


def _stiff_spd(b, seed=1):
    """cond ~1e7, the stiff-cloth regime (tests/test_pallas_chol.py:30-47)."""
    rng = np.random.default_rng(seed)
    d = np.exp(rng.uniform(0, 16, size=(b, 96))).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((b, 96, 96)))
    spd = np.einsum("bik,bk,bjk->bij", q, d, q).astype(np.float32)
    return 0.5 * (spd + np.swapaxes(spd, 1, 2))


def _sym(b, seed=0):
    a = np.random.default_rng(seed).standard_normal((b, 96, 96)).astype(np.float32)
    return 0.5 * (a + np.swapaxes(a, 1, 2))


# B = 1 and 5: fewer blocks than the card's resident slots (132 SMs x 5);
# 300: one partial wave; 4,096: several waves, the last one ragged
@pytest.mark.parametrize("b", [1, 5, 300, 4096])
def test_spd_inverse_kernel_matches_plain(cuda, b):
    spd = torch.as_tensor(_spd(b), device=cuda)
    before = _lib.launch_counts["spd_inverse96"]
    got = spd_inverse(spd)
    assert _lib.launch_counts["spd_inverse96"] == before + 1
    want = invert_spd_blocks_panel(spd)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err
    ref = np.linalg.inv(_spd(b).astype(np.float64))
    err64 = np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max()
    assert err64 < 1e-5, err64
    assert torch.equal(got, got.transpose(1, 2))  # bitwise symmetric


def test_spd_inverse_kernel_stiff_psd(cuda):
    spd = _stiff_spd(4)
    got = spd_inverse(torch.as_tensor(spd, device=cuda)).cpu().numpy()
    ref = np.linalg.inv(spd.astype(np.float64))
    relerr = np.abs(got - ref).max() / np.abs(ref).max()
    assert relerr < 3e-2, relerr
    assert np.linalg.eigvalsh(got.astype(np.float64)).min() > 0
    np.testing.assert_array_equal(got, np.swapaxes(got, 1, 2))


def test_spd_inverse_repair_and_debug(cuda):
    spd = torch.as_tensor(_spd(3), device=cuda)
    spd[1, 0, 0] = float("nan")
    repaired = spd_inverse(spd)
    assert torch.equal(repaired[1], torch.eye(96, device=cuda))
    assert not torch.isfinite(spd_inverse(spd, repair=False)[1]).all()


def test_spd_inverse_kernel_mixed_padding(cuda):
    """Random SPD blocks interleaved with the identity-filled padding blocks
    that assembly emits: each block is inverted on its own."""
    spd = _spd(64, seed=4)
    spd[1::3] = np.eye(96, dtype=np.float32)
    h = torch.as_tensor(spd, device=cuda)
    got = spd_inverse(h)
    want = invert_spd_blocks_panel(h)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    assert torch.equal(got[1::3], torch.eye(96, device=cuda).expand(len(spd[1::3]), 96, 96))
    ref = np.linalg.inv(spd.astype(np.float64))
    assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() < 1e-5
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.parametrize("at", [0, 40, 95])
def test_spd_inverse_kernel_repair_per_panel(cuda, at):
    """A NaN on the diagonal in each 32-wide panel: repair=True writes the
    identity in the kernel (one launch, no pass after it), repair=False
    leaves the block non-finite, and the neighbouring blocks keep their
    bits either way."""
    clean = torch.as_tensor(_spd(5, seed=5), device=cuda)
    bad = clean.clone()
    bad[2, at, at] = float("nan")
    base = spd_inverse(clean)
    before = _lib.launch_counts["spd_inverse96"]
    repaired = spd_inverse(bad, repair=True)
    assert _lib.launch_counts["spd_inverse96"] == before + 1
    raw = spd_inverse(bad, repair=False)
    assert _lib.launch_counts["spd_inverse96"] == before + 2
    assert torch.equal(repaired[2], torch.eye(96, device=cuda))
    assert not torch.isfinite(raw[2]).all()
    keep = [0, 1, 3, 4]
    assert torch.equal(repaired[keep], base[keep]) and torch.equal(raw[keep], base[keep])
    plain = invert_spd_blocks_panel(bad, repair=True)
    assert torch.equal(plain[2], repaired[2])


def test_spd_inverse_kernel_bitwise_repeatable(cuda):
    """Two launches on the same inputs give the same bits (no atomics, a
    fixed order of every sum)."""
    h = torch.as_tensor(_stiff_spd(300, seed=9), device=cuda)
    assert torch.equal(spd_inverse(h), spd_inverse(h))


def test_spd_inverse_kernel_occupancy(cuda):
    """At most ~56 KB of shared memory per block and at least four blocks per SM."""
    from precond_tpu_torch.ops.cuda.spd_inverse import occupancy

    smem, blocks = occupancy(cuda)
    assert smem <= 56 * 1024, smem
    assert blocks >= 4, blocks


# B = 1 and 33: fewer 32-block tiles than persistent thread blocks; 5,000:
# more, the last one ragged; 34,952: the main path's table (Bp = 35,072)
@pytest.mark.parametrize("b,block_b", [(1, 128), (33, 128), (64, 64), (256, 128), (130, 128),
                                       (300, 256), (5000, 128), (34952, 256)])
def test_packed_symv_kernel_matches_plain(cuda, b, block_b):
    a = torch.as_tensor(_sym(b, seed=2), device=cuda)
    rhs = torch.as_tensor(
        np.random.default_rng(3).standard_normal((b, 96)).astype(np.float32), device=cuda
    )
    packed = pack_sym96(a, block_b=block_b)
    before = _lib.launch_counts["packed_symv96"]
    got = packed_symv(packed, rhs)
    assert _lib.launch_counts["packed_symv96"] == before + 1
    want = packed_symv_ref(packed, rhs)
    dense = apply_block_inverse(a, rhs)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.cpu().numpy(), dense.cpu().numpy(), rtol=2e-5, atol=2e-5)


def test_packed_symv_kernel_bitwise_repeatable(cuda):
    """Two launches on the same inputs give the same bits (fixed fma order)."""
    from precond_tpu_torch.ops.cuda.packed_symv import packed_symv_t

    packed = pack_sym96(torch.as_tensor(_sym(5000, seed=8), device=cuda), block_b=128)
    bp = packed.f.shape[2]
    xt = torch.as_tensor(np.random.default_rng(9).standard_normal((96, bp)).astype(np.float32),
                         device=cuda)
    assert torch.equal(packed_symv_t(packed, xt), packed_symv_t(packed, xt))


def test_packed_symv_kernel_rejects_unaligned_bp(cuda):
    """TMA needs a 16-byte pitch: Bp = 130 raises before any launch."""
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse, packed_symv_t

    f = torch.zeros((48, 96, 130), device=cuda)
    dg = torch.zeros((96, 130), device=cuda)
    before = _lib.launch_counts["packed_symv96"]
    with pytest.raises(ValueError, match="multiple of 4"):
        packed_symv_t(PackedInverse(f=f, dg=dg, nb=130), torch.zeros((96, 130), device=cuda))
    assert _lib.launch_counts["packed_symv96"] == before


def test_packed_symv_kernel_exactly_symmetric(cuda):
    """<e_i, M e_j> == <e_j, M e_i> bit for bit."""
    packed = pack_sym96(torch.as_tensor(_sym(4, seed=5), device=cuda), block_b=128)
    ei = torch.zeros((4, 96), device=cuda)
    ej = torch.zeros((4, 96), device=cuda)
    ei[:, 7] = 1.0
    ej[:, 63] = 1.0
    assert torch.equal(packed_symv(packed, ej)[:, 7], packed_symv(packed, ei)[:, 63])


@pytest.mark.parametrize("b", [7, 32, 2185])
def test_symv_kernel_matches_plain(cuda, b):
    rng = np.random.default_rng(0)
    inv = torch.as_tensor(rng.standard_normal((b, 96, 96)).astype(np.float32), device=cuda)
    rhs = torch.as_tensor(rng.standard_normal((b, 96)).astype(np.float32), device=cuda)
    before = _lib.launch_counts["symv96"]
    got = batched_symv(inv, rhs)
    assert _lib.launch_counts["symv96"] == before + 1
    want = apply_block_inverse(inv, rhs)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


def _bf16_b(b):
    """A bf16 test size: an int, or "grid-1" / "grid+1" around the kernel's
    persistent grid (thread blocks x one table each = one round), which is
    known only on the card."""
    if isinstance(b, int):
        return b
    from precond_tpu_torch.ops.cuda.symv import bf16_grid

    return bf16_grid()[0] + int(b[4:])


# B = 1 and 5: fewer tables than thread blocks; 19 and 300 one partial
# round; 2,185 (general 256) and 4,097 several rounds, the last ragged;
# one table below and above a full round of the persistent grid
@pytest.mark.parametrize("b", [1, 5, 19, 300, 2185, 4097, "grid-1", "grid+1"])
def test_symv_bf16_kernel_matches_plain(cuda, b):
    """K3's bf16 entry: z = inv bf16(r) with f32 sums, against the plain
    einsum of the widened operands (only the order of the f32 sums differs)."""
    b = _bf16_b(b)
    inv = torch.as_tensor(_sym(b, seed=8), device=cuda).to(torch.bfloat16)
    rhs = torch.as_tensor(np.random.default_rng(9).standard_normal((b, 96)).astype(np.float32),
                          device=cuda)
    before = dict(_lib.launch_counts)
    got = batched_symv(inv, rhs)
    assert _lib.launch_counts["symv96_bf16"] == before["symv96_bf16"] + 1
    assert _lib.launch_counts["symv96"] == before["symv96"]
    assert got.dtype == torch.float32
    want = apply_block_inverse(inv, rhs)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, batched_symv(inv, rhs))          # bitwise repeat
    # the CPU plain version of the same operands agrees as well
    cpu = apply_block_inverse(inv.cpu(), rhs.cpu())
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("b", [1, 300, 2185])
def test_symv_bf16_kernel_reads_only_the_lower_triangle(cuda, b):
    """NaN above the diagonal changes no bit of z: the kernel reads the lower
    triangle and the diagonal only, and counts no entry twice."""
    inv = torch.as_tensor(_sym(b, seed=10), device=cuda).to(torch.bfloat16)
    rhs = torch.as_tensor(np.random.default_rng(11).standard_normal((b, 96)).astype(np.float32),
                          device=cuda)
    clean = batched_symv(inv, rhs)
    upper = torch.triu(torch.ones(96, 96, dtype=torch.bool, device=cuda), diagonal=1)
    poisoned = inv.masked_fill(upper, float("nan"))
    got = batched_symv(poisoned, rhs)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)
    want = apply_block_inverse(inv, rhs)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_symv_bf16_kernel_through_dense_symv_cm(cuda):
    """A bf16 DenseInverseCM (the grid path's comp-major table) through
    dense_symv_cm against the plain einsum of the same table."""
    from precond_tpu_torch.ops.cuda.packed_symv import DenseInverseCM, dense_cm, dense_symv_cm

    b = 300
    table = dense_cm(torch.as_tensor(_sym(b, seed=12), device=cuda)).m.to(torch.bfloat16)
    assert torch.equal(table, table.transpose(1, 2))
    inv = DenseInverseCM(m=table)
    rs3 = torch.as_tensor(
        np.random.default_rng(13).standard_normal((3, b, 32)).astype(np.float32), device=cuda)
    before = _lib.launch_counts["symv96_bf16"]
    got = dense_symv_cm(inv, rs3)
    assert _lib.launch_counts["symv96_bf16"] == before + 1
    want = apply_block_inverse(table, rs3.permute(1, 0, 2).reshape(b, 96))
    want = want.reshape(b, 3, 32).permute(1, 0, 2)
    assert got.shape == (3, b, 32)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_symv_rejects_other_dtypes(cuda):
    inv = torch.zeros((2, 96, 96), dtype=torch.float16, device=cuda)
    before = dict(_lib.launch_counts)
    with pytest.raises(ValueError, match="no kernel"):
        batched_symv(inv, torch.zeros((2, 96), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        batched_symv(inv.to(torch.bfloat16), torch.zeros((2, 96), device=cuda).double())
    # symv96_bf16 copies 16-byte chunks: a table 2 or 8 bytes off is refused
    flat = torch.zeros(2 * 96 * 96 + 8, dtype=torch.bfloat16, device=cuda)
    for skip in (1, 4):
        with pytest.raises(ValueError, match="16-byte"):
            batched_symv(flat[skip:skip + 2 * 96 * 96].view(2, 96, 96),
                         torch.zeros((2, 96), device=cuda))
    assert _lib.launch_counts == before
    # 16 bytes off is aligned, and runs
    z = batched_symv(flat[8:].view(2, 96, 96), torch.zeros((2, 96), device=cuda))
    assert _lib.launch_counts["symv96_bf16"] == before["symv96_bf16"] + 1
    assert torch.equal(z, torch.zeros_like(z))


def _cloth_stencil(nx, ny, cuda, pin_rows=0):
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.gridstencil import pin_vertices

    mesh = cloth.make_grid(nx, ny, z_wave=0.02, mass=0.001)
    sys_ = cloth.assemble_system_stencil(mesh, device=cuda)
    if pin_rows:
        pinned = torch.zeros(nx * ny, dtype=torch.bool, device=cuda)
        pinned[: pin_rows * ny] = True
        sys_ = pin_vertices(sys_, pinned, 360.0)
    return sys_


@pytest.mark.parametrize("nx,ny,pin", [(32, 32, 0), (64, 64, 0), (32, 64, 0), (48, 80, 1),
                                       (32, 32, 1)])
def test_stencil_spmv_kernel_matches_plain(cuda, nx, ny, pin):
    """K4 vs its plain version at 5e-6 * max|y| (tests/test_pallas_stencil_spmv.py:21-23),
    square and not, plain and pinned."""
    from precond_tpu_torch.ops.cuda.stencil_spmv import stencil_spmv
    from precond_tpu_torch.ops.gridstencil import spmv_t_plain

    s = _cloth_stencil(nx, ny, cuda, pin)
    xt = torch.as_tensor(np.random.default_rng(0).standard_normal((3, nx * ny)).astype(np.float32),
                         device=cuda)
    before = _lib.launch_counts["stencil_spmv"]
    got = stencil_spmv(s.diag_t, s.dirs_t, xt, s.offsets, s.grid)
    assert _lib.launch_counts["stencil_spmv"] == before + 1
    want = spmv_t_plain(s.diag_t, s.dirs_t, xt, s.offsets, s.grid)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 5e-6 * float(want.abs().max())


def test_stencil_spmv_kernel_arbitrary_offsets(cuda):
    """Random planes (nonzero where the neighbour is off-grid), negative and
    long shifts, nx != ny: the kernel skips exactly what the 2-D padding of
    the plain version skips."""
    from precond_tpu_torch.ops.cuda.stencil_spmv import stencil_spmv
    from precond_tpu_torch.ops.gridstencil import spmv_t_plain

    nx, ny = 37, 23
    offsets = ((3, -2), (0, 5), (-4, 1), (1, 0), (0, -1), (-1, -1), (7, 7), (-9, 0))
    rng = np.random.default_rng(1)
    n = nx * ny
    diag = torch.as_tensor(rng.standard_normal((3, 3, n)).astype(np.float32), device=cuda)
    dirs = torch.as_tensor(rng.standard_normal((len(offsets), 3, 3, n)).astype(np.float32),
                           device=cuda)
    xt = torch.as_tensor(rng.standard_normal((3, n)).astype(np.float32), device=cuda)
    got = stencil_spmv(diag, dirs, xt, offsets, (nx, ny))
    want = spmv_t_plain(diag, dirs, xt, offsets, (nx, ny))
    assert float((got - want).abs().max()) <= 5e-6 * float(want.abs().max())
    # an infinite x at the end of row 0 reaches only its true neighbours
    xt[:, ny - 1] = float("inf")
    got = stencil_spmv(diag, dirs, xt, offsets, (nx, ny))
    want = spmv_t_plain(diag, dirs, xt, offsets, (nx, ny))
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    with pytest.raises(ValueError, match="at most 32"):
        stencil_spmv(diag, dirs[:1].expand(33, 3, 3, n).contiguous(), xt,
                     ((1, 0),) * 33, (nx, ny))


@pytest.mark.parametrize("b,block_b", [(1, 128), (33, 128), (130, 128), (300, 256), (5000, 128),
                                       (34952, 256)])
def test_packed_symv_cm_kernel_matches_plain(cuda, b, block_b):
    """K2 through packed_symv_cm on a [3,B,32] comp-plane rhs, against its
    plain version and the dense row-major apply of the unpermuted inverse."""
    from precond_tpu_torch.ops.cuda.packed_symv import (
        dense_cm, dense_symv_cm, pack_sym96_cm, packed_symv_cm)

    a = torch.as_tensor(_sym(b, seed=6), device=cuda)
    rs3 = torch.as_tensor(
        np.random.default_rng(7).standard_normal((3, b, 32)).astype(np.float32), device=cuda)
    packed = pack_sym96_cm(a, block_b=block_b)
    before = _lib.launch_counts["packed_symv96"]
    got = packed_symv_cm(packed, rs3)
    assert _lib.launch_counts["packed_symv96"] == before + 1
    rhs_cm = rs3.permute(1, 0, 2).reshape(b, 96)          # DOF c*32+l
    want = packed_symv_ref(packed, rhs_cm).reshape(b, 3, 32).permute(1, 0, 2)
    rows = apply_block_inverse(a, rs3.permute(1, 2, 0).reshape(b, 96))   # DOF l*3+c
    dense = rows.reshape(b, 32, 3).permute(2, 0, 1)
    for ref in (want, dense):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=2e-5, atol=2e-5)
    before = _lib.launch_counts["symv96"]
    got_dense = dense_symv_cm(dense_cm(a), rs3)
    assert _lib.launch_counts["symv96"] == before + 1
    np.testing.assert_allclose(got_dense.cpu().numpy(), dense.cpu().numpy(), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_operands(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        spd_inverse(torch.zeros((2, 96, 96), device=cuda).transpose(1, 2))
    before = _lib.launch_counts["spd_inverse96"]
    with pytest.raises(ValueError, match="16-byte"):   # K1 stages by 16-byte cp.async
        spd_inverse(torch.zeros(2 * 96 * 96 + 1, device=cuda)[1:].view(2, 96, 96))
    assert _lib.launch_counts["spd_inverse96"] == before
    with pytest.raises(ValueError, match="float32"):
        batched_symv(torch.zeros((2, 96, 96), device=cuda, dtype=torch.float64),
                     torch.zeros((2, 96), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        batched_symv(torch.zeros((2, 96, 96), device=cuda), torch.zeros((3, 96), device=cuda))


def test_solver_on_card_matches_cpu(cuda):
    """The whole slice on the card against the same code on the CPU (plain
    versions), on a 32x32 cloth: apply within rtol 1e-5 / atol 1e-6*max|z|
    (tests/test_reference_api.py:116), for both symv forms."""
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import cloth

    mesh = cloth.make_grid(32, 32, z_wave=0.02)
    r = np.random.default_rng(4).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    for symv in ("dense", "packed"):
        cfg = SchwarzConfig(symv_kernel=symv, packed_symv_block_b=128)
        z = {}
        for dev in ("cpu", "cuda"):
            pre = SchwarzPreconditioner(cfg, device=dev)
            pre.allocate(mesh.positions)
            pre.prepare(cloth.assemble_system(mesh, device=dev))
            z[dev] = pre.apply(r).cpu().numpy()
        scale = np.abs(z["cpu"]).max()
        np.testing.assert_allclose(z["cuda"], z["cpu"], rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("symv,layout", [("packed", "auto"), ("dense", "auto"), ("dense", "rows")])
def test_grid_path_on_card_matches_cpu(cuda, symv, layout):
    """The grid path (prepare_grid + crossings + grid apply) on the card
    against the same code on the CPU, 32x32, rtol 1e-5 / atol 1e-6*max|z|."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.gridapply import precondition_grid, precondition_grid_cm
    from precond_tpu_torch.solver import prepare_grid
    from precond_tpu_torch.utils import gridmorton as gm

    mesh = cloth.make_grid(32, 32, z_wave=0.02)
    r = np.random.default_rng(4).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    cfg = SchwarzConfig(symv_kernel=symv, packed_symv_block_b=128, solve_layout=layout)
    z = {}
    for dev in ("cpu", "cuda"):
        dg, dr, off = cloth.assemble_system_grid(mesh, device=dev)
        inv = prepare_grid(dg, dr, off, 5, cfg)
        rt = torch.as_tensor(r, device=dev)
        if layout == "rows":
            z[dev] = gm.morton_to_grid(precondition_grid(inv, gm.grid_to_morton(rt, 5), cfg), 5)
        else:
            z[dev] = gm.morton_to_grid_cm(
                precondition_grid_cm(inv, gm.grid_to_morton_cm(rt.T.contiguous(), 5), cfg), 5).T
        z[dev] = z[dev].cpu().numpy()
    scale = np.abs(z["cpu"]).max()
    np.testing.assert_allclose(z["cuda"], z["cpu"], rtol=1e-5, atol=1e-6 * scale)


# ---- the general path's block-ELL SpMV (csrc/ell_spmv.cu) -------------------
#
# Tolerances are worst-case bounds of f32 summation, per row, against the
# row's sum of |terms| (|diag| |x| plus |block| |x[idx]| over the valid slots,
# in float64): u = 2^-24, and a sum of m products rounds within ~m u of it.
# The kernel sums at most K/3 + 1 products a lane and then four adds, so it
# lies within (K + 8) u of float64. The plain version's einsum sums 3K
# products a row, so kernel and plain lie within (4K + 14) u of each other.
# Both bounds hold whatever the summation order; a missed or doubled slot
# breaks them by a whole term.

U32 = 2.0 ** -24


def _random_ell(n, k, seed, fill=0.3):
    """A well-formed BlockEll on the host: scattered (non-prefix) valid
    slots, every 7th row empty, every 11th full; padded slots hold a zero
    block and their own row's id. Returns (ell, x) as numpy arrays."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, k)) < fill
    mask[::7] = False
    mask[3::11] = True
    own = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, k))
    idx = np.where(mask, rng.integers(0, n, (n, k), dtype=np.int32), own)
    blocks = rng.standard_normal((n, k, 3, 3), dtype=np.float32)
    blocks *= mask[:, :, None, None]
    diag = rng.standard_normal((n, 3, 3), dtype=np.float32)
    x = rng.standard_normal((n, 3), dtype=np.float32)
    return (diag, idx, blocks, mask), x


def _to(arrays, dev):
    from precond_tpu_torch.ops.blockcsr import BlockEll

    return BlockEll(*(torch.as_tensor(a, device=dev) for a in arrays))


def _f64_and_scale(arrays, x):
    """y in float64 on the CPU and each row's sum of |terms|."""
    diag, idx, blocks, mask = (torch.as_tensor(a) for a in arrays)
    xd = torch.as_tensor(x).double()
    b = blocks.double() * mask[:, :, None, None]
    xg = xd[idx.long()]
    y = torch.einsum("nij,nj->ni", diag.double(), xd) + torch.einsum("nkij,nkj->ni", b, xg)
    s = (torch.einsum("nij,nj->ni", diag.double().abs(), xd.abs())
         + torch.einsum("nkij,nkj->ni", b.abs(), xg.abs()))
    return y, s


@pytest.mark.parametrize("k", [1, 7, 41, 215])
@pytest.mark.parametrize("n", [1, 1000, 2 ** 16 + 3])
def test_ell_spmv_kernel_matches_plain(cuda, n, k):
    from precond_tpu_torch.ops.blockcsr import spmv, spmv_plain

    arrays, x = _random_ell(n, k, seed=n + k)
    h = _to(arrays, cuda)
    xd = torch.as_tensor(x, device=cuda)
    before = _lib.launch_counts["ell_spmv"]
    got = spmv(h, xd)
    assert _lib.launch_counts["ell_spmv"] == before + 1
    plain = spmv_plain(h, xd)
    torch.cuda.synchronize()
    y64, scale = _f64_and_scale(arrays, x)
    got_c = got.cpu().double()
    assert bool(torch.isfinite(got).all())
    assert bool(((got_c - plain.cpu().double()).abs() <= (4 * k + 14) * U32 * scale).all())
    assert bool(((got_c - y64).abs() <= (k + 8) * U32 * scale).all())


@pytest.mark.parametrize("n,k", [(1000, 7), (2 ** 16 + 3, 41), (3000, 215)])
def test_ell_spmv_kernel_never_reads_masked_slots(cuda, n, k):
    """NaN blocks and other rows' ids in the masked slots: y is bit for bit
    the y of the same system with clean padding, and finite."""
    from precond_tpu_torch.ops.cuda.ell_spmv import ell_spmv

    arrays, x = _random_ell(n, k, seed=7 * n + k)
    diag, idx, blocks, mask = arrays
    rng = np.random.default_rng(k)
    dirty_blocks = np.where(mask[:, :, None, None], blocks, np.float32(np.nan))
    dirty_idx = np.where(mask, idx, rng.integers(0, n, (n, k), dtype=np.int32))
    xd = torch.as_tensor(x, device=cuda)
    clean = ell_spmv(_to(arrays, cuda), xd)
    dirty = ell_spmv(_to((diag, dirty_idx, dirty_blocks, mask), cuda), xd)
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)


def test_ell_spmv_kernel_bitwise_repeatable(cuda):
    from precond_tpu_torch.ops.cuda.ell_spmv import ell_spmv

    arrays, x = _random_ell(2 ** 16 + 3, 41, seed=11)
    h = _to(arrays, cuda)
    xd = torch.as_tensor(x, device=cuda)
    assert torch.equal(ell_spmv(h, xd), ell_spmv(h, xd))


def test_ell_spmv_rejects_bad_operands(cuda):
    from precond_tpu_torch.ops.cuda.ell_spmv import ell_spmv

    arrays, x = _random_ell(100, 7, seed=12)
    h = _to(arrays, cuda)
    xd = torch.as_tensor(x, device=cuda)
    before = dict(_lib.launch_counts)
    bad = [
        ("float32", h._replace(blocks=h.blocks.double()), xd),
        ("float32", h, xd.double()),
        ("int32", h._replace(idx=h.idx.long()), xd),
        ("bool", h._replace(mask=h.mask.to(torch.uint8)), xd),
        ("CUDA tensor", h, xd.cpu()),
        ("CUDA tensor", h._replace(diag=h.diag.cpu()), xd),
        ("shape", h, xd[:99]),
        ("shape", h, torch.zeros((100, 4), device=cuda)),
        ("shape", h._replace(mask=h.mask[:, :6]), xd),
        ("contiguous", h._replace(blocks=h.blocks.transpose(2, 3)), xd),
        ("contiguous", h, xd.T.contiguous().T),
    ]
    for what, hh, xx in bad:
        with pytest.raises(ValueError, match=what):
            ell_spmv(hh, xx)
    assert _lib.launch_counts == before


def _clothsim_frames(mesh, frames, cuda):
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models.simulator import ClothSim

    g = mesh.grid[1]
    sim = ClothSim(mesh, SchwarzConfig(), pinned=np.arange(g), device=cuda)
    before = dict(_lib.launch_counts)
    spmv_calls = 0
    for _ in range(frames):
        sim.step()
        assert float(sim.last_solve.rel_residual) <= 1e-4
        spmv_calls += sim.last_solve.iterations + 1   # the PCG's r0 = b - H x0, then one an iteration
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sim.state.positions).all())
    return {k: _lib.launch_counts[k] - before[k] for k in before}, spmv_calls


def test_clothsim_general_path_launches_ell_spmv_per_pcg_spmv(cuda):
    """A 12x12 sheet takes the general path (12 is no power of two): one
    ell_spmv launch per PCG SpMV call, no K4."""
    from precond_tpu_torch.models import cloth

    mesh = cloth.make_grid(12, 12, mass=0.05, dt=1.0 / 60.0, k_struct=3e3, k_shear=3e3,
                           k_bend=30.0)
    launched, spmv_calls = _clothsim_frames(mesh, 3, cuda)
    assert launched["ell_spmv"] == spmv_calls and launched["stencil_spmv"] == 0


def test_clothsim_grid_path_launches_no_ell_spmv(cuda):
    """A 32x32 sheet takes the grid path: K4 SpMVs, no ell_spmv launch."""
    from precond_tpu_torch.models import cloth

    mesh = cloth.make_grid(32, 32, mass=0.02, dt=1.0 / 60.0, k_struct=5e3, k_shear=5e3,
                           k_bend=50.0)
    launched, spmv_calls = _clothsim_frames(mesh, 1, cuda)
    assert launched["ell_spmv"] == 0 and launched["stencil_spmv"] == spmv_calls
