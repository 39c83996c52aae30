"""Port vs JAX: the reference-shaped facade (reference_api.SeSchwarzPreconditioner).

Mirrors tests/test_reference_api.py: the facade driven through the
reference's own calling convention (input pointers, AllocatePrecoditioner,
PreparePreconditioner with the CSR triplet + VF sets and prefix counts,
Preconditioning) must reproduce the port's native pipeline and the JAX
facade on the same inputs, at that test's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import cloth as jcloth
from precond_tpu.models import collision as jcol
from precond_tpu.ops.stencils import VfSets as JaxVfSets
from precond_tpu.reference_api import SeSchwarzPreconditioner as JaxFacade
from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner, convert
from precond_tpu_torch.models import cloth
from precond_tpu_torch.ops.stencils import VfSets, build_stencils
from precond_tpu_torch.reference_api import SeSchwarzPreconditioner

torch.set_num_threads(2)


def _csr_from_ell(ell):
    """BlockEll (numpy fields) -> (adjacency starts/ids, off-diagonal blocks)."""
    idx, mask, blocks = (np.asarray(a) for a in (ell.idx, ell.mask, ell.blocks))
    starts, ids, vals = [0], [], []
    for i in range(idx.shape[0]):
        cols = idx[i][mask[i]]
        order = np.argsort(cols)
        ids.extend(cols[order].tolist())
        vals.append(blocks[i][mask[i]][order])
        starts.append(len(ids))
    return (np.asarray(starts, np.int32), np.asarray(ids, np.int32),
            np.concatenate(vals, axis=0).astype(np.float32))


def _drive(facade, mesh, positions, diag, csr, **sets):
    """The reference's calling sequence on `facade`; csr = (starts, ids, off)."""
    starts, ids, off = csr
    facade.m_positions = positions
    facade.m_edges = np.asarray(mesh.edges)
    facade.m_faces = np.asarray(mesh.faces)
    facade.m_neighbours = (starts, ids)
    facade.AllocatePrecoditioner(len(positions), len(mesh.edges), len(mesh.faces))
    facade.PreparePreconditioner(diag, off, starts, **sets)


def test_reference_contract_matches_native_pipeline():
    mesh = jcloth.make_grid(16, 16, z_wave=0.02)
    n = mesh.num_verts
    ell = jcloth.assemble_system(mesh)
    csr = _csr_from_ell(ell)
    pre = SeSchwarzPreconditioner(SchwarzConfig(), device="cpu")
    _drive(pre, mesh, np.asarray(mesh.positions), np.asarray(ell.diag), csr)

    ref = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    ref.allocate(mesh.positions)
    ref.prepare(cloth.assemble_system(cloth.make_grid(16, 16, z_wave=0.02), device="cpu"))
    jf = JaxFacade(JaxConfig())
    _drive(jf, mesh, np.asarray(mesh.positions), np.asarray(ell.diag), csr)

    r = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    z = pre.Preconditioning(r).numpy()
    np.testing.assert_allclose(z, ref.apply(r).numpy(), rtol=1e-6, atol=1e-8)
    zj = np.asarray(jf.Preconditioning(r))
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-6 * np.abs(zj).max())


def test_reference_contract_with_collision_sets_and_counts():
    """VF sets with the reference's prefix-count sizing (cpp:306-308)."""
    mesh = jcloth.make_grid(16, 16, z_wave=0.0)
    n = mesh.num_verts
    h = 1.0 / 15
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    p = p.astype(np.float32)
    vf, _ = jcol.detect_vf_grid(jnp.asarray(p), jnp.asarray(mesh.faces), 0.75 * h, 1e3, 2 * n)
    keep = np.asarray(vf.v_id) >= 0
    live = int(keep.sum())
    assert live > 0
    order = np.argsort(~keep, kind="stable")   # live entries first
    vf_np = JaxVfSets(*(np.asarray(f)[order] for f in vf))
    vf_counts = np.zeros((n + 1,), np.int32)
    vf_counts[n] = live

    ell = jcloth.assemble_system(mesh, positions=p)
    csr = _csr_from_ell(ell)
    pre = SeSchwarzPreconditioner(SchwarzConfig(), device="cpu")
    _drive(pre, mesh, p, np.asarray(ell.diag), csr,
           vf_sets=VfSets(*vf_np), vf_counts=vf_counts)

    ref = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    ref.allocate(p)
    live_sets = convert.vf_sets_from_numpy(*(f[:live] for f in vf_np), device="cpu")
    ref.prepare(cloth.assemble_system(cloth.make_grid(16, 16, z_wave=0.0), positions=p,
                                      device="cpu"),
                build_stencils(torch.as_tensor(mesh.edges), torch.as_tensor(mesh.faces),
                               vf=live_sets))
    jf = JaxFacade(JaxConfig())
    _drive(jf, mesh, p, np.asarray(ell.diag), csr, vf_sets=vf_np, vf_counts=vf_counts)

    r = np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32)
    z = pre.Preconditioning(r).numpy()
    z_native = ref.apply(r).numpy()
    scale = max(abs(z_native).max(), 1e-12)
    np.testing.assert_allclose(z, z_native, rtol=1e-5, atol=1e-6 * scale)
    zj = np.asarray(jf.Preconditioning(r))
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-6 * scale)


def test_facade_raises_where_jax_asserts():
    pre = SeSchwarzPreconditioner(SchwarzConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="m_positions"):
        pre.AllocatePrecoditioner(4, 0, 0)
    pre.m_positions = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="numVerts"):
        pre.AllocatePrecoditioner(4, 0, 0)
    with pytest.raises(RuntimeError, match="AllocatePrecoditioner"):
        pre.PreparePreconditioner(np.zeros((3, 3, 3)), np.zeros((0, 3, 3)), np.zeros(4, np.int32))


def test_facade_defaults_to_the_card():
    if torch.cuda.is_available():
        assert SeSchwarzPreconditioner(SchwarzConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SeSchwarzPreconditioner(SchwarzConfig())
