"""Port vs JAX: the simulators (models/simulator.py).

The cases of tests/test_simulator.py on the port, at their own bounds; the
port's ClothSim against the JAX ClothSim on a 16x16 fold with contact for
3 frames, and its SoftBodySim (corotational, 5^3) against the JAX one:
positions within 2e-4 * max|x| (tests/test_simulator.py:122's tolerance)
and iterations within 2 per frame. The grid path's comp-major and
row-major frames agree at the same tolerance.
"""

import numpy as np
import pytest
import torch

from precond_tpu.config import SchwarzConfig as JaxConfig
from precond_tpu.models import simulator as jsim
from precond_tpu.models import tetmesh as jtet
from precond_tpu_torch import SchwarzConfig, convert
from precond_tpu_torch.models import cloth, tetmesh
from precond_tpu_torch.models.simulator import ClothSim, SimState, SoftBodySim

torch.set_num_threads(2)


def _np(a):
    return np.array(a)


def _two_layers(n, gap):
    """Two stacked n x n sheets joined only by proximity (tests/test_simulator.py:74-84)."""
    m1 = cloth.make_grid(n, n, mass=0.05, dt=1.0 / 60.0, k_struct=2e3, k_shear=2e3, k_bend=20.0)
    n1 = m1.num_verts
    pos = np.concatenate([m1.positions, m1.positions + [0, 0, gap]]).astype(np.float32)
    faces = np.concatenate([m1.faces, m1.faces + n1]).astype(np.int32)
    edges = np.concatenate([m1.edges, np.where(m1.edges >= 0, m1.edges + n1, -1)]).astype(np.int32)
    springs = np.concatenate([m1.springs, m1.springs + n1])
    stiffness = np.concatenate([m1.stiffness, m1.stiffness])
    return cloth.ClothMesh(pos, edges, faces, springs, stiffness, m1.mass, m1.dt), n1


def _converged(sim):
    return float(sim.last_solve.rel_residual) <= 1e-4


# ---- tests/test_simulator.py's cases ----------------------------------------------

def test_hanging_cloth_steps():
    n = 12
    mesh = cloth.make_grid(n, n, mass=0.05, dt=1.0 / 60.0, k_struct=3e3, k_shear=3e3, k_bend=30.0)
    pinned = np.arange(n)
    sim = ClothSim(mesh, SchwarzConfig(), pinned=pinned, device="cpu")
    z0 = float(sim.state.positions[:, 2].mean())
    for _ in range(6):
        st = sim.step()
        assert torch.isfinite(st.positions).all() and _converged(sim)
        assert sim.last_solve.iterations < 400
    pos = sim.state.positions.numpy()
    np.testing.assert_allclose(pos[pinned], mesh.positions[pinned], atol=1e-6)
    assert pos[:, 2].mean() < z0 - 1e-4
    assert float(sim.state.velocities.abs().max()) < 50.0


def test_soft_body_settles():
    mesh = tetmesh.make_box(5, 5, 5, mass=0.05, youngs=5e4)
    pinned = np.flatnonzero(np.arange(mesh.num_verts) % 5 == 0)
    sim = SoftBodySim(mesh, SchwarzConfig(), pinned=pinned, device="cpu")
    z0 = float(sim.state.positions[:, 2].mean())
    for _ in range(5):
        st = sim.step()
        assert torch.isfinite(st.positions).all() and _converged(sim)
    pos = sim.state.positions.numpy()
    np.testing.assert_allclose(pos[pinned], mesh.positions[pinned], atol=1e-6)
    assert pos[:, 2].mean() < z0
    assert float(sim.state.velocities.abs().max()) < 50.0


def test_two_layer_cloth_with_collisions():
    n = 8
    mesh = cloth.make_grid(n, n, mass=0.05, dt=1.0 / 60.0, k_struct=2e3, k_shear=2e3, k_bend=20.0)
    sim = ClothSim(mesh, SchwarzConfig(), pinned=np.arange(n), collision_stiffness=1e3,
                   collision_threshold=0.02, collision_budget=64, device="cpu")
    for _ in range(3):
        st = sim.step()
        assert torch.isfinite(st.positions).all() and _converged(sim)


def test_collision_sim_uses_all_three_set_types():
    n = 12
    mesh2, n1 = _two_layers(n, 0.012)
    pinned = np.concatenate([np.arange(n), n1 + np.arange(n)])
    sim = ClothSim(mesh2, SchwarzConfig(), pinned=pinned, collision_stiffness=1e3,
                   collision_threshold=0.015, collision_budget=512, collision_cell_cap=32,
                   device="cpu")
    for _ in range(2):
        st = sim.step()
        assert torch.isfinite(st.positions).all() and _converged(sim)
    assert not bool(sim.last_detect_info.truncated)


def test_grid_fast_path_matches_generic():
    mesh = cloth.make_grid(16, 16, mass=0.05, dt=1.0 / 60.0, k_struct=3e3, k_shear=3e3, k_bend=30.0)
    pinned = np.asarray([0, 15])
    fast = ClothSim(mesh, SchwarzConfig(), pinned=pinned, device="cpu")
    assert fast._gmk is not None
    slow = ClothSim(mesh, SchwarzConfig(), pinned=pinned, device="cpu")
    slow._gmk = None
    for _ in range(3):
        sf, ss = fast.step(), slow.step()
    diff = float((sf.positions - ss.positions).abs().max())
    assert diff < 2e-4 * float(ss.positions.abs().max()), diff
    np.testing.assert_allclose(sf.positions.numpy()[pinned], mesh.positions[pinned])


def test_contact_forces_separate_close_sheets():
    n = 8
    gap0 = 0.006
    mesh2, n1 = _two_layers(n, gap0)
    pinned = np.concatenate([np.arange(n1), n1 + np.arange(n)])
    sim = ClothSim(mesh2, SchwarzConfig(), gravity=(0.0, 0.0, 0.0), pinned=pinned,
                   collision_stiffness=5e3, collision_threshold=0.015, collision_budget=512,
                   collision_cell_cap=32, device="cpu")
    for _ in range(4):
        st = sim.step()
        assert torch.isfinite(st.positions).all()
    p = st.positions.numpy()
    gap = p[n1:, 2].mean() - p[:n1, 2].mean()
    assert gap0 * 1.5 < gap < 0.06, gap
    assert float(st.velocities.abs().max()) < 5.0


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                    np.float32)


def test_soft_body_corotational_rigid_invariance():
    mesh = tetmesh.make_box(8, 8, 8, mass=0.05, youngs=5e4)
    xr = torch.as_tensor(mesh.positions @ _rot(0.6).T)
    drift = {}
    for material in ("corotational", "linear"):
        sim = SoftBodySim(mesh, SchwarzConfig(), gravity=(0.0, 0.0, 0.0), material=material,
                          device="cpu")
        sim.state = sim.state._replace(positions=xr)
        st = sim.step()
        drift[material] = float((st.positions - xr).abs().max())
        if material == "corotational":
            assert _converged(sim)
    assert drift["corotational"] < 1e-4, drift
    assert drift["linear"] > 10 * max(drift["corotational"], 1e-6), drift


@pytest.mark.parametrize("material", ["corotational", "neohookean"])
def test_soft_body_box_drop_steps(material):
    """tests/test_simulator.py:196-209 (corotational) and
    tests/test_tetmesh.py:196-205 (neohookean) on the box path."""
    mesh = tetmesh.make_box(8, 8, 4, mass=0.05, youngs=5e4)
    base = np.flatnonzero(mesh.positions[:, 2] < 1e-6)
    sim = SoftBodySim(mesh, SchwarzConfig(), pinned=base, material=material, device="cpu")
    assert sim._box is not None
    for _ in range(3):
        st = sim.step()
        assert torch.isfinite(st.positions).all() and _converged(sim)


def test_soft_body_collision_separates_boxes():
    m1 = tetmesh.make_box(4, 4, 4, mass=0.05, youngs=5e4)
    n1 = m1.num_verts
    gap0 = 0.08
    pos = np.concatenate([m1.positions, m1.positions + [0.0, 0.0, 1.0 + gap0]]).astype(np.float32)
    mesh2 = tetmesh.TetMesh(
        positions=pos, tets=np.concatenate([m1.tets, m1.tets + n1]).astype(np.int32),
        faces=np.concatenate([m1.faces, m1.faces + n1]).astype(np.int32),
        edges=np.concatenate([m1.edges, np.where(m1.edges >= 0, m1.edges + n1, -1)]).astype(np.int32),
        mass=m1.mass, dt=m1.dt, lam=m1.lam, mu=m1.mu, dims=None)
    sim = SoftBodySim(mesh2, SchwarzConfig(), gravity=(0.0, 0.0, 0.0), pinned=np.arange(n1),
                      material="corotational", collision_stiffness=5e3, collision_threshold=0.15,
                      collision_budget=512, collision_cell_cap=32, device="cpu")
    ztop0 = pos[n1:, 2].mean()
    for _ in range(4):
        st = sim.step()
        assert torch.isfinite(st.positions).all()
    rise = st.positions.numpy()[n1:, 2].mean() - ztop0
    assert 0.01 < rise < 0.5, rise


# ---- against the JAX simulators ----------------------------------------------------

def _fold16():
    """A 16x16 sheet folded onto itself 0.5 h apart (the JAX bench's collide
    recipe at 16), jittered by 1e-3 h so that no two candidate contacts tie
    exactly, at rest in that shape and held by its crease column."""
    g = 16
    mesh = cloth.make_grid(g, g, z_wave=0.0, mass=0.002, dt=1.0 / 60.0, k_struct=2e3,
                           k_shear=2e3, k_bend=20.0)
    h = 1.0 / (g - 1)
    p = mesh.positions.copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    p = p + 1e-3 * h * np.random.default_rng(0).standard_normal(p.shape)
    crease = np.flatnonzero(np.abs(p[:, 0] - 0.5) < 0.25 * h)
    return mesh._replace(positions=p.astype(np.float32)), crease, h


def _match_frames(jax_sim, port_sim, frames, tol):
    """Step both simulators `frames` times from the same state: each frame
    starts from the JAX simulator's state, carried across with
    convert.sim_state_from_numpy. Contact sets are discontinuous in the
    positions, so along a free trajectory a last-bit difference can switch
    a near-threshold contact a frame later; from the same state each frame
    is the same function in both packages."""
    for f in range(frames):
        st = jax_sim.state
        port_sim.state = convert.sim_state_from_numpy(
            _np(st.positions), _np(st.velocities), st.step_count, device="cpu")
        js, ts = jax_sim.step(), port_sim.step()
        want = _np(js.positions)
        got = ts.positions.numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2e-4 * scale, (f, np.abs(got - want).max())
        ji, ti = int(jax_sim.last_solve.iterations), port_sim.last_solve.iterations
        assert abs(ti - ji) <= 2, (f, ti, ji)
        assert float(port_sim.last_solve.rel_residual) <= tol
        assert ts.step_count == js.step_count


# Both packages solve to 1e-6 here: at the default 1e-4 the two PCG runs
# may stop two iterations apart on the same system, which alone moves a
# frame's positions by ~1e-3 of max|x| on the fold.
_TIGHT = 1e-6


def test_clothsim_fold_matches_jax():
    mesh, crease, h = _fold16()
    kw = dict(gravity=(0.0, 0.0, -9.8), pinned=crease, collision_stiffness=1e3,
              collision_threshold=0.75 * h, collision_budget=256, collision_cell_cap=8,
              tol=_TIGHT, max_iters=1000)
    jax_sim = jsim.ClothSim(mesh, JaxConfig(max_collision_per_vert=2), **kw)
    port_sim = ClothSim(mesh, SchwarzConfig(max_collision_per_vert=2), device="cpu", **kw)
    assert port_sim._gmk == 4
    _match_frames(jax_sim, port_sim, 3, _TIGHT)
    assert port_sim.last_detect_info is not None


def test_softbody_corotational_matches_jax():
    mesh = tetmesh.make_box(5, 5, 5, mass=0.05, youngs=5e4)
    base = np.flatnonzero(mesh.positions[:, 2] < 1e-6)
    kw = dict(pinned=base, material="corotational", tol=_TIGHT, max_iters=1000)
    jax_sim = jsim.SoftBodySim(jtet.TetMesh(*mesh), JaxConfig(), **kw)
    port_sim = SoftBodySim(mesh, SchwarzConfig(), device="cpu", **kw)
    _match_frames(jax_sim, port_sim, 3, _TIGHT)


def test_clothsim_cm_and_rows_frames_agree():
    """The grid path's comp-major solve (DenseInverseCM at 32x32) and its
    row-major solve give the same frame, and the state carries across."""
    g = 32
    mesh = cloth.make_grid(g, g, mass=0.02, dt=1.0 / 60.0, k_struct=5e3, k_shear=5e3, k_bend=50.0)
    out = {}
    for layout in ("auto", "rows"):
        cfg = SchwarzConfig(solve_layout=layout)
        sim = ClothSim(mesh, cfg, pinned=np.arange(g), device="cpu")
        st = sim.step()
        assert _converged(sim)
        out[layout] = st
    scale = float(out["rows"].positions.abs().max())
    assert float((out["auto"].positions - out["rows"].positions).abs().max()) < 2e-4 * scale
    carried = convert.sim_state_from_numpy(_np(out["rows"].positions), _np(out["rows"].velocities),
                                           1, device="cpu")
    assert isinstance(carried, SimState) and carried.step_count == 1
    assert torch.equal(carried.positions, out["rows"].positions)
