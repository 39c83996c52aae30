"""The contact path on the card against its CPU run, and its bit-for-bit repeats.

The contact modules have no hand-written kernel: on the card they are
plain PyTorch, with every float placement through
utils/scatter.accumulate_rows (a deterministic segmented sum, never an
atomic add). These tests hold the card's detection, collision placement
(segment_place9) and slot contact SpMV against the same calls on the CPU,
and check that each repeats bit for bit on the card. They need a card and
skip without one; they import no JAX:

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA card" -m gpu tests/test_torch_gpu_contact.py
"""

import numpy as np
import pytest
import torch

from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
from precond_tpu_torch.models import cloth, collision
from precond_tpu_torch.ops import contact
from precond_tpu_torch.ops.assembly import segment_place9
from precond_tpu_torch.ops.cuda import _lib
from precond_tpu_torch.ops.stencils import build_stencils

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the contact path's device run has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fold(grid=32):
    """The JAX bench's collide sheet (bench.py:220-227) at `grid`."""
    mesh = cloth.make_grid(grid, grid, z_wave=0.0, mass=1e-3, dt=1.0 / 60.0)
    h = 1.0 / (grid - 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    return mesh, p.astype(np.float32), h


def _detect(mesh, p, h, dev):
    n = mesh.num_verts
    pt = torch.as_tensor(p, device=dev)
    ft = torch.as_tensor(mesh.faces, device=dev)
    et = torch.as_tensor(mesh.edges, device=dev)
    kw = dict(threshold=0.75 * h, stiffness=1e3, max_pairs=n // 4)
    vf, i1 = collision.detect_vf_grid(pt, ft, per_vertex_cap=2, **kw)
    ee, i2 = collision.detect_ee_grid(pt, et, per_edge_cap=2, **kw)
    ef, i3 = collision.detect_ef_grid(pt, et, ft, per_edge_cap=2, **kw)
    return (vf, ee, ef, i1, i2, i3), build_stencils(et, ft, ef=ef, ee=ee, vf=vf)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _match(card, cpu, atol=1e-6):
    """Integer fields bit for bit, float fields within atol."""
    for x, y in zip(card, cpu):
        x = x.cpu()
        if x.is_floating_point():
            assert torch.allclose(x, y, rtol=0, atol=atol), float((x - y).abs().max())
        else:
            assert torch.equal(x, y)


def test_detection_matches_cpu_and_repeats(cuda):
    mesh, p, h = _fold(32)
    sets_cpu, st_cpu = _detect(mesh, p, h, "cpu")
    sets_gpu, st_gpu = _detect(mesh, p, h, cuda)
    for g, c in zip(sets_gpu, sets_cpu):
        _match(g, c)
    _match(st_gpu, st_cpu)
    assert int(st_gpu.valid.sum()) > 0
    again, st_again = _detect(mesh, p, h, cuda)
    assert all(_same(a, b) for a, b in zip(again, sets_gpu)) and _same(st_again, st_gpu)


def test_segment_place9_matches_cpu_and_repeats(cuda):
    rng = np.random.default_rng(0)
    p, size = 200_000, 30_000
    ids = torch.as_tensor(rng.integers(-10, size + 10, p).astype(np.int32))
    vals = torch.as_tensor((rng.standard_normal((p, 9)) * np.exp(rng.uniform(0, 12, (p, 1))))
                           .astype(np.float32))
    valid = torch.as_tensor(rng.random(p) < 0.9)
    want = segment_place9(ids, vals, valid, size)
    got = segment_place9(ids.to(cuda), vals.to(cuda), valid.to(cuda), size)
    assert torch.allclose(got.cpu(), want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, segment_place9(ids.to(cuda), vals.to(cuda), valid.to(cuda), size))


def test_contact_slots_match_cpu_and_repeat(cuda):
    mesh, p, h = _fold(32)
    n = mesh.num_verts
    _, st = _detect(mesh, p, h, "cpu")
    cs_cpu = contact.build_contact_slots(st, n)
    st_gpu = st.to(cuda)
    cs_gpu = contact.build_contact_slots(st_gpu, n)
    for name in ("ids", "sid", "bounds", "seg"):
        assert torch.equal(getattr(cs_gpu, name).cpu(), getattr(cs_cpu, name)), name
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32))
    want = contact.slot_contact_spmv(st, cs_cpu, x)
    got = contact.slot_contact_spmv(st_gpu, cs_gpu, x.to(cuda))
    scale = float(want.abs().max())
    assert torch.allclose(got.cpu(), want, rtol=0, atol=5e-6 * scale)
    assert torch.allclose(got.cpu(), contact.stencil_contact_spmv(st, x), rtol=0, atol=5e-6 * scale)
    assert torch.equal(got, contact.slot_contact_spmv(st_gpu, cs_gpu, x.to(cuda)))
    assert torch.equal(contact.stencil_contact_spmv(st_gpu, x.to(cuda)),
                       contact.stencil_contact_spmv(st_gpu, x.to(cuda)))
    assert torch.equal(contact.contact_diag(st_gpu, n), contact.contact_diag(st_gpu, n))


def test_collide_prepare_on_card_matches_cpu_and_repeats(cuda):
    mesh, p, h = _fold(32)
    _, st = _detect(mesh, p, h, "cpu")
    cfg = SchwarzConfig(coarse_damping=0.25)
    r = np.random.default_rng(4).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    out, states = {}, []
    for dev in ("cpu", cuda, cuda):
        pre = SchwarzPreconditioner(cfg, device=dev)
        pre.allocate(p)
        before = _lib.launch_counts["spd_inverse96"]
        pre.prepare(cloth.assemble_system(mesh, positions=p, device=dev), st)
        if dev != "cpu":
            assert _lib.launch_counts["spd_inverse96"] == before + 1
            states.append(pre.state)
        out[str(dev)] = pre.apply(r).cpu()
    assert torch.equal(states[0].going_next.cpu(), pre.state.going_next.cpu())
    assert all(torch.equal(a, b) for a, b in zip(*states))
    want = out["cpu"]
    # stiff contact blocks: the JAX inverse test's 1e-4 of max
    # (tests/test_batched_inverse.py:49)
    assert float((out["cuda"] - want).abs().max()) < 1e-4 * float(want.abs().max())
