"""Port vs JAX: the tet model (models/tetmesh.py).

Integer outputs (make_box's tets, faces, edges; the ELL structure and its
contributor tables) bit for bit; float outputs against the JAX functions on
the same inputs, and the cases of tests/test_tetmesh.py at their own
tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precond_tpu.models import tetmesh as jtet
from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
from precond_tpu_torch.models import tetmesh as ttet
from precond_tpu_torch.ops import blockcsr
from precond_tpu_torch.parallel.pcg import jacobi_preconditioner, pcg

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                    np.float32)


@pytest.mark.parametrize("dims", [(3, 3, 3), (5, 4, 3), (8, 8, 4)])
def test_make_box_and_structure_bitwise(dims):
    jm, tm = jtet.make_box(*dims, youngs=1e4), ttet.make_box(*dims, youngs=1e4)
    for name in ("positions", "tets", "faces", "edges"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tm.lam, tm.mu, tm.dims, tm.mass, tm.dt) == (jm.lam, jm.mu, jm.dims, jm.mass, jm.dt)
    for a, b in zip(ttet.ell_structure_from_tets(tm.num_verts, tm.tets),
                    jtet.ell_structure_from_tets(jm.num_verts, jm.tets)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttet.adjacency_lists(tm), jtet.adjacency_lists(jm)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def box3():
    mesh = ttet.make_box(3, 3, 3, youngs=1e4)
    rest = torch.as_tensor(mesh.positions)
    tets = torch.as_tensor(mesh.tets)
    return mesh, rest, tets, jnp.asarray(mesh.positions), jnp.asarray(mesh.tets)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def test_assemble_system_matches_jax():
    mesh = ttet.make_box(5, 4, 3, mass=0.05, youngs=5e4)
    x = mesh.positions + 0.02 * np.random.default_rng(0).standard_normal(mesh.positions.shape)
    x = x.astype(np.float32)
    want = jtet.assemble_system(mesh, positions=x)
    got = ttet.assemble_system(mesh, positions=x, device="cpu")
    np.testing.assert_array_equal(got.idx.numpy(), _np(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), _np(want.mask))
    _close(got.blocks, want.blocks, 1e-5)
    _close(got.diag, want.diag, 1e-5)


def test_corot_and_snh_match_jax(box3):
    mesh, rest, tets, jrest, jtets = box3
    x = mesh.positions + 0.05 * np.random.default_rng(1).standard_normal(mesh.positions.shape)
    x = (x @ _rot(0.4).T).astype(np.float32)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    ke0, jke0 = (ttet.element_blocks(rest, tets, mesh.lam, mesh.mu),
                 jtet.element_blocks(jrest, jtets, mesh.lam, mesh.mu))
    _close(ke0, jke0, 1e-5)
    r, jr = ttet.corot_rotations(xt, rest, tets), jtet.corot_rotations(xj, jrest, jtets)
    _close(r, jr, 1e-5)
    _close(ttet.element_blocks_corot(ke0, r), jtet.element_blocks_corot(jke0, jr), 1e-5)
    _close(ttet.corot_forces(ke0, r, xt, rest, tets),
           jtet.corot_forces(jke0, jr, xj, jrest, jtets), 1e-4)
    _close(ttet.snh_forces(xt, rest, tets, mesh.lam, mesh.mu),
           jtet.snh_forces(xj, jrest, jtets, mesh.lam, mesh.mu), 1e-4)
    _close(ttet.snh_element_blocks(xt, rest, tets, mesh.lam, mesh.mu),
           jtet.snh_element_blocks(xj, jrest, jtets, mesh.lam, mesh.mu), 1e-4)


# ---- tests/test_tetmesh.py's cases -----------------------------------------------

def test_stiffness_properties():
    mesh = ttet.make_box(3, 3, 3)
    dense = blockcsr.to_dense(ttet.assemble_system(mesh, device="cpu")).double().numpy()
    np.testing.assert_allclose(dense, dense.T, rtol=1e-5, atol=1e-2)
    assert np.linalg.eigvalsh(0.5 * (dense + dense.T)).min() > 0
    t = np.tile(np.array([1.0, 0.0, 0.0]), mesh.num_verts)
    m_dt2 = mesh.mass / mesh.dt**2
    np.testing.assert_allclose(dense @ t, m_dt2 * t, rtol=1e-4, atol=1e-2)


def test_single_domain_exact_tet():
    mesh = ttet.make_box(3, 3, 3)  # 27 verts <= 32: one domain
    ell = ttet.assemble_system(mesh, device="cpu")
    pre = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(ell)
    assert not bool(pre.state.overflow)
    r = np.random.default_rng(0).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    z = pre.apply(r).numpy().reshape(-1)
    z_ref = np.linalg.solve(blockcsr.to_dense(ell).double().numpy(), r.reshape(-1))
    np.testing.assert_allclose(z, z_ref, rtol=3e-4, atol=1e-10)


def test_pcg_on_soft_body():
    mesh = ttet.make_box(6, 6, 6, mass=0.01)
    ell = ttet.assemble_system(mesh, device="cpu")
    assert ell.max_degree >= 14
    pre = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(ell)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((mesh.num_verts, 3))
                        .astype(np.float32))
    rs = pcg(lambda x: blockcsr.spmv(ell, x), pre.apply, b, tol=1e-4, max_iters=500)
    rj = pcg(lambda x: blockcsr.spmv(ell, x), jacobi_preconditioner(ell.diag), b, tol=1e-4,
             max_iters=2000)
    assert float(rs.rel_residual) <= 1e-4
    assert rs.iterations < rj.iterations


def test_element_stiffness_annihilates_rigid_modes(box3):
    mesh, rest, tets, _, _ = box3
    ke = ttet.element_blocks(rest, tets, mesh.lam, mesh.mu).double().numpy()
    w = np.array([[0, -0.3, 0.2], [0.3, 0, -0.1], [-0.2, 0.1, 0]])
    scale = np.abs(ke).max()
    for t in range(len(mesh.tets)):
        k12 = ke[t].transpose(0, 2, 1, 3).reshape(12, 12)
        x0 = mesh.positions[mesh.tets[t]].astype(np.float64)
        assert np.abs(k12 @ (w @ x0.T).T.reshape(-1)).max() < 1e-5 * scale, t
        assert np.abs(k12 @ np.tile([1.0, 2.0, 3.0], 4)).max() < 1e-5 * scale, t


def test_corot_rest_and_rigid_motion(box3):
    mesh, rest, tets, _, _ = box3
    ke0 = ttet.element_blocks(rest, tets, mesh.lam, mesh.mu)
    r = ttet.corot_rotations(rest, rest, tets)
    assert float((r - torch.eye(3)).abs().max()) < 1e-5
    assert float(ttet.corot_forces(ke0, r, rest, rest, tets).abs().max()) == 0.0
    rot = torch.as_tensor(_rot(0.7))
    xr = rest @ rot.T + torch.tensor([0.3, -0.2, 0.5])
    rr = ttet.corot_rotations(xr, rest, tets)
    assert float((rr - rot).abs().max()) < 1e-5
    scale = float(ke0.abs().max())
    assert float(ttet.corot_forces(ke0, rr, xr, rest, tets).abs().max()) < 1e-5 * scale
    want = torch.einsum("ij,tabjk,lk->tabil", rot, ke0, rot)
    assert float((ttet.element_blocks_corot(ke0, rr) - want).abs().max()) < 1e-4 * scale


def test_corot_matches_linear_to_first_order(box3):
    mesh, rest, tets, _, _ = box3
    ke0 = ttet.element_blocks(rest, tets, mesh.lam, mesh.mu)
    dx = torch.as_tensor((1e-4 * np.random.default_rng(0).standard_normal(mesh.positions.shape))
                         .astype(np.float32))
    xs = rest + dx
    fc = ttet.corot_forces(ke0, ttet.corot_rotations(xs, rest, tets), xs, rest, tets)
    ell = ttet.assemble_system(mesh, device="cpu")
    flin = -(blockcsr.spmv(ell, dx) - (mesh.mass / mesh.dt**2) * dx)
    assert float((fc - flin).abs().max()) < 2e-3 * float(flin.abs().max())


def test_stable_neohookean_forces_and_hessian(box3):
    mesh, rest, tets, _, _ = box3
    lam, mu = mesh.lam, mesh.mu
    assert float(ttet.snh_forces(rest, rest, tets, lam, mu).abs().max()) < 1e-3
    xr = rest @ torch.as_tensor(_rot(0.7)).T + torch.tensor([0.3, -0.2, 0.5])
    assert float(ttet.snh_forces(xr, rest, tets, lam, mu).abs().max()) < 0.1

    # finite-difference gradient check at a deformed state (f64 oracle)
    x = mesh.positions.astype(np.float64) + 0.05 * np.random.default_rng(0).standard_normal(
        mesh.positions.shape)
    f = ttet.snh_forces(torch.as_tensor(x, dtype=torch.float32), rest, tets, lam, mu).numpy()
    rs = mesh.positions.astype(np.float64)[mesh.tets]
    dm = np.stack([rs[:, 1] - rs[:, 0], rs[:, 2] - rs[:, 0], rs[:, 3] - rs[:, 0]], axis=2)

    def energy(xx):
        xs = xx[mesh.tets]
        ds = np.stack([xs[:, 1] - xs[:, 0], xs[:, 2] - xs[:, 0], xs[:, 3] - xs[:, 0]], axis=2)
        fg = ds @ np.linalg.inv(dm)
        vol = np.abs(np.linalg.det(dm)) / 6
        psi = 0.5 * mu * ((fg * fg).sum((1, 2)) - 3) + 0.5 * lam * (np.linalg.det(fg) - 1 - mu / lam) ** 2
        return float((vol * psi).sum())

    eps = 1e-6
    for v, k in [(3, 0), (10, 2), (20, 1)]:
        xp, xm = x.copy(), x.copy()
        xp[v, k] += eps
        xm[v, k] -= eps
        fd = -(energy(xp) - energy(xm)) / (2 * eps)
        assert abs(f[v, k] - fd) < 5e-3 * max(abs(fd), 1.0), (v, k, f[v, k], fd)

    # SPD projection under 60% compression
    ke = ttet.snh_element_blocks(rest * torch.tensor([1.0, 1.0, 0.4]), rest, tets, lam, mu)
    struct = [torch.as_tensor(a) for a in ttet.ell_structure_from_tets(mesh.num_verts, mesh.tets)]
    ell = ttet.fill_ell_from_ke(*struct, ke, mesh.mass / mesh.dt**2)
    h = blockcsr.to_dense(ell).double().numpy()
    assert np.linalg.eigvalsh(0.5 * (h + h.T)).min() > 0
