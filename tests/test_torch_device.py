"""The port's entry points run on the card unless the caller asks for the
CPU: without a card they raise instead of carrying on on the CPU."""

import numpy as np
import pytest
import torch

from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner, convert
from precond_tpu_torch.device import resolve_device
from precond_tpu_torch.models import cloth, tetmesh
from precond_tpu_torch.models.simulator import ClothSim, SoftBodySim
from precond_tpu_torch.ops import blockcsr, gridapply, gridassembly
from precond_tpu_torch.ops.stencils import empty_stencils
from precond_tpu_torch.parallel.comm import Group
from precond_tpu_torch.parallel.sharded import solve_step
from precond_tpu_torch.solver import compute_sort_maps
from precond_tpu_torch.utils import boxmorton, gridmorton


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _mesh():
    return cloth.make_grid(8, 8, z_wave=0.02)


@pytest.mark.parametrize("entry", [
    "preconditioner", "solve_step", "assemble_system", "from_coo", "convert", "resolve",
    "assemble_system_grid", "assemble_system_stencil", "sort_index", "grid_pattern_upload",
    "analytic_hierarchy", "convert_stencil", "convert_grid_blocks", "convert_packed_cm",
    "convert_dense_cm", "cloth_sim", "soft_body_sim", "tet_assemble_system", "box_sort_index",
    "convert_sim_state", "convert_box_stencil", "empty_stencils", "group_single",
])
def test_entry_points_raise_without_card(no_card, entry):
    mesh = _mesh()
    ell = cloth.assemble_system(mesh, device="cpu")
    maps = compute_sort_maps(torch.as_tensor(mesh.positions))
    b = np.ones((mesh.num_verts, 3), np.float32)
    calls = {
        "preconditioner": lambda: SchwarzPreconditioner(SchwarzConfig()),
        "solve_step": lambda: solve_step(ell, maps, b, SchwarzConfig()),
        "assemble_system": lambda: cloth.assemble_system(mesh),
        "from_coo": lambda: blockcsr.from_coo(
            2, np.array([0]), np.array([1]), np.ones((1, 3, 3)), np.ones((2, 3, 3))),
        "convert": lambda: convert.sort_maps_from_numpy(np.arange(3), np.arange(3)),
        "resolve": lambda: resolve_device(None),
        "assemble_system_grid": lambda: cloth.assemble_system_grid(mesh),
        "assemble_system_stencil": lambda: cloth.assemble_system_stencil(mesh),
        "sort_index": lambda: gridmorton.sort_index(3),
        "grid_pattern_upload": lambda: gridassembly.device_pattern(
            3, ((1, 0), (-1, 0)), SchwarzConfig()),
        "analytic_hierarchy": lambda: gridapply.analytic_hierarchy(64, SchwarzConfig()),
        "convert_stencil": lambda: convert.stencil_system_from_numpy(
            np.zeros((3, 3, 4)), np.zeros((0, 3, 3, 4)), (), (2, 2)),
        "convert_grid_blocks": lambda: convert.grid_blocks_from_numpy(
            np.zeros((4, 3, 3)), np.zeros((0, 4, 3, 3)), ()),
        "convert_packed_cm": lambda: convert.packed_inverse_cm_from_numpy(
            np.zeros((48, 96, 1)), np.zeros((96, 1)), 1),
        "convert_dense_cm": lambda: convert.dense_inverse_cm_from_numpy(np.zeros((3, 32, 3, 32, 1))),
        "cloth_sim": lambda: ClothSim(mesh),
        "soft_body_sim": lambda: SoftBodySim(tetmesh.make_box(4, 4, 2)),
        "tet_assemble_system": lambda: tetmesh.assemble_system(tetmesh.make_box(3, 3, 3)),
        "box_sort_index": lambda: boxmorton.sort_index((4, 4, 2)),
        "convert_sim_state": lambda: convert.sim_state_from_numpy(np.zeros((4, 3)), np.zeros((4, 3))),
        "convert_box_stencil": lambda: convert.box_stencil_system_from_numpy(
            np.zeros((3, 3, 32)), np.zeros((0, 3, 3, 32)), (), (4, 4, 2)),
        "empty_stencils": lambda: empty_stencils(),
        "group_single": lambda: Group.single(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_empty_stencils_and_single_group_on_cpu_when_asked(no_card):
    st = empty_stencils(device="cpu")
    assert all(t.device.type == "cpu" and t.shape[0] == 0 for t in st)
    assert st.idx.shape == (0, 5) and st.direction.shape == (0, 3)
    g = Group.single("cpu")
    assert g.device.type == "cpu" and (g.rank, g.world, g.distributed) == (0, 1, False)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(g.all_reduce_sum(x), x)


def test_entry_points_run_on_cpu_when_asked(no_card):
    mesh = _mesh()
    ell = cloth.assemble_system(mesh, device="cpu")
    maps = compute_sort_maps(torch.as_tensor(mesh.positions))
    b = np.random.default_rng(0).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    res = solve_step(ell, maps, b, SchwarzConfig(), device="cpu")
    assert res.x.device.type == "cpu" and float(res.rel_residual) <= 1e-4
    pre = SchwarzPreconditioner(SchwarzConfig(), device="cpu")
    pre.allocate(mesh.positions)
    pre.prepare(ell)
    assert pre.apply(b).device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
    sim = ClothSim(mesh, SchwarzConfig(), pinned=np.arange(8), device="cpu")
    assert sim.step().positions.device.type == "cpu" and float(sim.last_solve.rel_residual) <= 1e-4
    box = tetmesh.make_box(4, 4, 2, mass=0.05, youngs=5e4)
    soft = SoftBodySim(box, SchwarzConfig(), device="cpu")
    assert soft.step().positions.device.type == "cpu" and soft._box == (4, 4, 2)
    assert tetmesh.assemble_system(box, device="cpu").diag.device.type == "cpu"
    x = torch.arange(96, dtype=torch.float32).reshape(32, 3)
    assert torch.equal(boxmorton.morton_to_box(boxmorton.box_to_morton(x, 4, 4, 2), 4, 4, 2), x)
    assert torch.equal(boxmorton.sort_index((4, 4, 2), device="cpu"),
                       torch.as_tensor(boxmorton.sort_maps(4, 4, 2)[0], dtype=torch.int64))
