"""The port's sharded grid steps (parallel/gridsharded.py) on the CPU, every
rank simulated in this process: the slab SpMV with its ring halo, the
crossing tables between grid and tile order, the contact rows of a
replicated contact ELL, and the world-size-1 steps against the
single-device ones. The multi-rank runs against the JAX package are in
test_torch_multiprocess.py."""

import numpy as np
import pytest
import torch

from precond_tpu_torch import SchwarzConfig
from precond_tpu_torch.models import cloth, collision
from precond_tpu_torch.ops import gridstencil
from precond_tpu_torch.ops.contact import build_contact_ell, contact_spmv
from precond_tpu_torch.ops.stencils import build_stencils
from precond_tpu_torch.parallel import gridsharded as gsh
from precond_tpu_torch.parallel.comm import Group
from precond_tpu_torch.utils import gridmorton as gm

torch.set_num_threads(2)


class _Ranks:
    """Every rank of a group in one process. The ring shift hands back the
    neighbour's slice of the same kind; the rank sum adds what every rank
    contributed in a first pass (`parts`), in rank order."""

    def __init__(self, xs, rank, parts=None):
        self.xs, self.rank, self.world, self.parts = xs, rank, len(xs), parts
        self.sent = []

    def ring_shift(self, x, shift):
        peer = self.xs[(self.rank - shift) % self.world]
        return peer[-x.shape[0]:] if shift > 0 else peer[: x.shape[0]]

    def all_reduce_sum(self, x):
        self.sent.append(x)
        if self.parts is None:
            return x
        acc = self.parts[0]
        for p in self.parts[1:]:
            acc = acc + p
        return acc


def _cloth(side, sym=False, folded=False):
    mesh = cloth.make_grid(side, side, z_wave=0.0 if folded else 0.02, mass=0.001, dt=1.0 / 60.0)
    pos = None
    if folded:
        h = 1.0 / (side - 1)
        p = np.asarray(mesh.positions).copy()
        fold = p[:, 0] > 0.5
        p[:, 2] = np.where(fold, 0.5 * h, 0.0)
        p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
        pos = p.astype(np.float32)
    ssys = cloth.assemble_system_stencil(mesh, positions=pos, sym=sym, device="cpu")
    return mesh, pos, ssys


def _fold_stencils(mesh, pos):
    """The fold's VF and EE contacts within 0.75 h."""
    n = mesh.num_verts
    h = 1.0 / (int(round(n ** 0.5)) - 1)
    p, f, e = (torch.as_tensor(a) for a in (pos, mesh.faces, mesh.edges))
    vf, _ = collision.detect_vf_grid(p, f, 0.75 * h, 1e3, n // 4, per_vertex_cap=2)
    ee, _ = collision.detect_ee_grid(p, e, 0.75 * h, 1e3, n // 4, per_edge_cap=2)
    return build_stencils(e, f, ee=ee, vf=vf)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("side,world", [(32, 2), (32, 4), (64, 8), (32, 1)])
def test_slab_spmv_is_each_ranks_rows(sym, side, world):
    _, _, ssys = _cloth(side, sym)
    n = side * side
    x = torch.randn((n, 3))
    want = gridstencil.spmv(ssys, x)
    per = n // world
    xs = [x[r * per: (r + 1) * per] for r in range(world)]
    for r in range(world):
        gs = gsh.grid_slab(ssys, r, world)
        got = gsh.slab_spmv(_Ranks(xs, r), gs, xs[r])
        assert torch.equal(got, want[r * per: (r + 1) * per])   # the same sums, row by row


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_crossing_tables_move_rows_between_orders(world):
    """Rank d's plan row and every rank's send rows toward d must leave d
    with its tile-order slab (grid -> tile) and its grid slab (back)."""
    k = 5
    n = 4 ** k
    per = n // world
    x = torch.randn((n, 3))
    plans = [gsh._crossings(k, per, world, r, "cpu") for r in range(world)]
    for way, (src, want) in enumerate(((x, gm.grid_to_morton(x, k)),
                                       (gm.grid_to_morton(x, k), x))):
        for d in range(world):
            received = torch.cat([src[s * per: (s + 1) * per][plans[s][way][0][d]]
                                  for s in range(world)])
            got = received[plans[d][way][1]][:per]
            assert torch.equal(got, want[d * per: (d + 1) * per])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_contact_rows_are_each_ranks_rows(world):
    side = 32
    mesh, pos, _ = _cloth(side, folded=True)
    n = side * side
    ce = build_contact_ell(_fold_stencils(mesh, pos), n, kc=16)
    assert int((ce.rows < n).sum()) > 50
    x = torch.randn((n, 3))
    want = contact_spmv(ce, x)
    per = n // world
    xs = [x[r * per: (r + 1) * per] for r in range(world)]
    crs = [gsh.contact_rows(ce, n, r, per) for r in range(world)]
    firsts = [_Ranks(xs, r) for r in range(world)]
    for r in range(world):
        gsh.local_contact_ell_spmv(firsts[r], crs[r], xs[r])
    parts = [g.sent[0] for g in firsts]
    for r in range(world):
        got = gsh.local_contact_ell_spmv(_Ranks(xs, r, parts), crs[r], xs[r])
        torch.testing.assert_close(got, want[r * per: (r + 1) * per], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sym", [False, True])
def test_world_one_step_matches_grid_solve_step(sym):
    k, cfg = 5, SchwarzConfig()
    mesh, _, ssys = _cloth(32, sym)
    dg, dr, full = cloth.assemble_system_grid(mesh, device="cpu")
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((1024, 3)).astype(np.float32))
    one = gsh.grid_solve_step(ssys, dg, dr, b, full, k, cfg, tol=1e-5, max_iters=300)
    res = gsh.sharded_grid_solve_step(Group.single("cpu"), cfg, ssys.offsets, k, tol=1e-5,
                                      max_iters=300, sym=sym, device="cpu")(ssys, dg, dr, b)
    assert abs(res.iterations - one.iterations) <= 5
    scale = float(one.x.abs().max())
    np.testing.assert_allclose(res.x.numpy(), one.x.numpy(), rtol=0, atol=5e-4 * scale)


@pytest.mark.parametrize("entry", [gsh.sharded_grid_solve_step,
                                   gsh.sharded_grid_contact_solve_step])
def test_sharded_grid_steps_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(Group.single("cpu"), SchwarzConfig(), ((1, 0), (0, 1)), 5)


def test_world_one_contact_step_runs_on_the_cpu_when_asked():
    """Inputs on the CPU with device='cpu': the step and its result stay
    there (the contact ELL and o2s are moved along with the system)."""
    k, cfg = 5, SchwarzConfig(coarse_damping=0.25)
    mesh, pos, ssys = _cloth(32, folded=True)
    dg, dr, full = cloth.assemble_system_grid(mesh, positions=pos, device="cpu")
    st = _fold_stencils(mesh, pos)
    ce = build_contact_ell(st, 1024, kc=16)
    o2s = torch.as_tensor(gm.sort_maps(k)[1])
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((1024, 3)).astype(np.float32))
    one = gsh.grid_contact_solve_step(ssys, dg, dr, b, st, ce, o2s, full, k, cfg, tol=1e-5,
                                      max_iters=400)
    res = gsh.sharded_grid_contact_solve_step(Group.single("cpu"), cfg, full, k, tol=1e-5,
                                              max_iters=400, device="cpu")(
        ssys, dg, dr, b, st, ce, o2s)
    assert res.x.device.type == "cpu" and abs(res.iterations - one.iterations) <= 5
    scale = float(one.x.abs().max())
    np.testing.assert_allclose(res.x.numpy(), one.x.numpy(), rtol=0, atol=5e-4 * scale)


def test_grid_slab_rejects_uneven_rows():
    _, _, ssys = _cloth(32)
    with pytest.raises(ValueError, match="do not split over 3"):
        gsh.grid_slab(ssys, 0, 3)
    with pytest.raises(ValueError, match="wider than a rank"):
        gsh.grid_slab(ssys, 0, 32)
