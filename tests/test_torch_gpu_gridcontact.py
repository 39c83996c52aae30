"""Contact on the grid path and the simulators on the card against their
CPU runs.

These tests hold the card's grid collision terms, its prepare_grid with
stencils at 64x64 (K1, every placement through accumulate_rows), one
ClothSim frame at 32x32 with contact and one SoftBodySim frame on the box
path (K1, K2 or K3, K4) against the same calls on the CPU (plain
versions), and check that the card repeats bit for bit. They need a card
and skip without one; they import no JAX:

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA card" -m gpu tests/test_torch_gpu_gridcontact.py
"""

import numpy as np
import pytest
import torch

from precond_tpu_torch import SchwarzConfig
from precond_tpu_torch.models import cloth, collision, tetmesh
from precond_tpu_torch.models.simulator import ClothSim, SoftBodySim
from precond_tpu_torch.ops import gridassembly
from precond_tpu_torch.ops.cuda import _lib
from precond_tpu_torch.ops.stencils import build_stencils, collision_terms, map_stencils
from precond_tpu_torch.solver import prepare_grid
from precond_tpu_torch.utils import gridmorton as gm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fold(grid):
    """The JAX bench's collide sheet (bench.py:220-227) at `grid`."""
    mesh = cloth.make_grid(grid, grid, z_wave=0.0, mass=1e-3, dt=1.0 / 60.0)
    h = 1.0 / (grid - 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    return mesh, p.astype(np.float32), h


def _stencils(mesh, p, h):
    pt, ft, et = (torch.as_tensor(a) for a in (p, mesh.faces, mesh.edges))
    kw = dict(threshold=0.75 * h, stiffness=1e3, max_pairs=mesh.num_verts // 4)
    vf, _ = collision.detect_vf_grid(pt, ft, per_vertex_cap=2, **kw)
    ee, _ = collision.detect_ee_grid(pt, et, per_edge_cap=2, **kw)
    ef, _ = collision.detect_ef_grid(pt, et, ft, per_edge_cap=2, **kw)
    return build_stencils(et, ft, ef=ef, ee=ee, vf=vf)


def _close(card, cpu, rel):
    scale = float(cpu.abs().max())
    assert float((card.cpu() - cpu).abs().max()) <= rel * scale


@pytest.mark.parametrize("big", [False, True])
def test_grid_collision_terms_match_cpu_and_repeat(cuda, big, monkeypatch):
    mesh, p, h = _fold(64)
    n = mesh.num_verts
    if big:
        monkeypatch.setattr(gridassembly, "BIG_PAIR_THRESHOLD", 0)
    _, o2s = gm.sort_maps(6)
    terms = collision_terms(map_stencils(_stencils(mesh, p, h), torch.as_tensor(o2s)))
    cfg = SchwarzConfig()
    rows, dg = gridassembly.grid_collision_terms(terms, cfg, n)
    gterms = type(terms)(*(t.to(cuda) for t in terms))
    grows, gdg = gridassembly.grid_collision_terms(gterms, cfg, n)
    _close(grows, rows, 1e-6)
    _close(gdg, dg, 1e-6)
    again = gridassembly.grid_collision_terms(gterms, cfg, n)
    assert torch.equal(again[0], grows) and torch.equal(again[1], gdg)


def test_prepare_grid_with_stencils_matches_cpu_and_repeats(cuda):
    mesh, p, h = _fold(64)
    st = _stencils(mesh, p, h)
    _, o2s = gm.sort_maps(6)
    cfg = SchwarzConfig(coarse_damping=0.25, solve_layout="rows")
    dg, dr, off = cloth.assemble_system_grid(mesh, positions=p, device="cpu")
    want = prepare_grid(dg, dr, off, 6, cfg, st, torch.as_tensor(o2s))
    gst, go2s = st.to(cuda), torch.as_tensor(o2s, device=cuda)
    gdg, gdr = dg.to(cuda), dr.to(cuda)
    before = _lib.launch_counts["spd_inverse96"]
    got = prepare_grid(gdg, gdr, off, 6, cfg, gst, go2s)
    assert _lib.launch_counts["spd_inverse96"] == before + 1
    # stiff contact blocks: the JAX inverse test's 1e-4 of max
    # (tests/test_batched_inverse.py:49)
    _close(got, want, 1e-4)
    assert torch.equal(got, prepare_grid(gdg, gdr, off, 6, cfg, gst, go2s))


def test_clothsim_frame_matches_cpu_and_repeats(cuda):
    mesh, p, h = _fold(32)
    mesh = mesh._replace(positions=p)
    kw = dict(pinned=np.flatnonzero(np.abs(p[:, 0] - 0.5) < 0.25 * h), collision_stiffness=1e3,
              collision_threshold=0.75 * h, collision_budget=mesh.num_verts // 4,
              collision_cell_cap=8)
    cfg = SchwarzConfig(coarse_damping=0.25, max_collision_per_vert=2)
    out = []
    for dev in ("cpu", cuda, cuda):
        sim = ClothSim(mesh, cfg, device=dev, **kw)
        _lib.reset_launch_counts()
        st = sim.step()
        assert float(sim.last_solve.rel_residual) <= 1e-4
        if dev != "cpu":
            its = sim.last_solve.iterations
            assert _lib.launch_counts["spd_inverse96"] == 1
            assert _lib.launch_counts["symv96"] >= its and _lib.launch_counts["stencil_spmv"] >= its
        out.append((st.positions, sim.last_solve.iterations))
    (cpu, it_cpu), (card, it_card), (again, _) = out
    assert abs(it_cpu - it_card) <= 2
    _close(card, cpu, 2e-4)
    assert torch.equal(card, again)


def test_softbody_box_frame_matches_cpu(cuda):
    mesh = tetmesh.make_box(8, 8, 8, mass=0.05, youngs=5e4)
    base = np.flatnonzero(mesh.positions[:, 2] < 1e-6)
    out = []
    for dev in ("cpu", cuda):
        sim = SoftBodySim(mesh, SchwarzConfig(), pinned=base, material="corotational", device=dev)
        st = sim.step()
        assert float(sim.last_solve.rel_residual) <= 1e-4
        out.append(st.positions)
    _close(out[1], out[0], 2e-4)
