"""The general path's block-ELL SpMV on the CPU: the dispatch and the
padded-slot invariant that the card's kernel (csrc/ell_spmv.cu) relies on.

On CPU tensors ``blockcsr.spmv`` is its plain version and launches nothing.
The kernel reads only the valid slots, where the plain version multiplies
every slot; the two agree because every producer of a BlockEll leaves each
masked slot with a zero block and a column id pointing at its own row.
"""

import numpy as np
import pytest
import torch

from precond_tpu_torch.models import cloth, tetmesh
from precond_tpu_torch.models.simulator import _pin_ell
from precond_tpu_torch.ops import blockcsr
from precond_tpu_torch.ops.cuda import _lib

torch.set_num_threads(2)


def _cloth_ell(g=12):
    mesh = cloth.make_grid(g, g, z_wave=0.02, mass=0.01)
    return mesh, cloth.assemble_system(mesh, device="cpu")


@pytest.mark.parametrize("transposed", [False, True])
def test_spmv_on_cpu_takes_the_plain_path(transposed):
    """Bit for bit the plain version, and no launch counted."""
    _, ell = _cloth_ell()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((ell.num_verts, 3)),
                        dtype=torch.float32)
    if transposed:   # a strided x is taken as the plain version takes it
        x = x.T.contiguous().T
    before = dict(_lib.launch_counts)
    got = blockcsr.spmv(ell, x)
    assert torch.equal(got, blockcsr.spmv_plain(ell, x))
    assert _lib.launch_counts == before and _lib.launch_counts["ell_spmv"] == 0
    dense = blockcsr.to_dense(ell).double() @ x.double().reshape(-1)
    np.testing.assert_allclose(got.reshape(-1).numpy(), dense.numpy(), rtol=0,
                               atol=1e-5 * float(dense.abs().max()))


def _from_coo():
    rng = np.random.default_rng(1)
    n, m = 50, 300
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = rows != cols
    return blockcsr.from_coo(n, rows[keep], cols[keep],
                             rng.standard_normal((int(keep.sum()), 3, 3)).astype(np.float32),
                             rng.standard_normal((n, 3, 3)).astype(np.float32),
                             max_degree=24, device="cpu")


def _permute():
    _, ell = _cloth_ell()
    p = torch.as_tensor(np.random.default_rng(2).permutation(ell.num_verts), dtype=torch.int32)
    inv = torch.empty_like(p)
    inv[p.long()] = torch.arange(len(p), dtype=torch.int32)
    return blockcsr.permute(ell, p, inv)


def _pin():
    mesh, ell = _cloth_ell()
    pinned = torch.zeros(ell.num_verts, dtype=torch.bool)
    pinned[:: 5] = True
    return _pin_ell(ell, pinned, mesh.mass / mesh.dt**2)


def _update():
    mesh, ell = _cloth_ell()
    _, _, sos = cloth.ell_structure_from_springs(mesh.num_verts, mesh.springs)
    moved = mesh.positions + np.random.default_rng(3).normal(0, 0.01, mesh.positions.shape)
    shell = ell._replace(blocks=torch.full_like(ell.blocks, float("nan")))
    return cloth.update_ell_blocks(shell, torch.as_tensor(mesh.springs),
                                   torch.as_tensor(mesh.stiffness),
                                   torch.as_tensor(moved.astype(np.float32)),
                                   mesh.mass / mesh.dt**2, torch.as_tensor(sos))


def _fill_from_ke():
    box = tetmesh.make_box(4, 3, 3)
    idx, mask, off_src, diag_src = tetmesh.ell_structure_from_tets(box.num_verts, box.tets)
    t = torch.as_tensor
    ke = tetmesh.element_blocks(t(box.positions), t(box.tets), box.lam, box.mu)
    return tetmesh.fill_ell_from_ke(t(idx), t(mask), t(off_src), t(diag_src), ke,
                                    box.mass / box.dt**2)


@pytest.mark.parametrize("producer", [_from_coo, _permute, _pin, _update, _fill_from_ke],
                         ids=["from_coo", "permute", "pin_ell", "update_ell_blocks",
                              "fill_ell_from_ke"])
def test_padded_slots_are_zero_and_point_home(producer):
    """Every masked slot: a zero block (+0.0 or -0.0) and its own row's id.
    Each producer here also leaves some rows padded, so the check bites."""
    ell = producer()
    n, k = ell.idx.shape
    pad = ~ell.mask
    assert bool(pad.any()) and bool(ell.mask.any())
    own = torch.arange(n, dtype=ell.idx.dtype)[:, None].expand(n, k)
    assert torch.equal(ell.idx[pad], own[pad])
    assert bool((ell.blocks[pad] == 0).all())
    assert bool(torch.isfinite(ell.blocks).all())
    valid = ell.idx[ell.mask]
    assert bool(((valid >= 0) & (valid < n)).all())
