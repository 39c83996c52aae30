"""Shared by the contact-regime probes' twins (scripts/torch_probe_*.py):
the folded sheet, its contact detection, its systems and the PCG solves
that the JAX package's probe scripts (scripts/probe_*.py) build.

The sheet is the JAX bench's `collide` sheet (bench.py:220-227): a grid x
grid cloth, z_wave 0, mass 1e-3, dt 1/60, the right half folded onto the
left at a gap of 0.5 h. Detection is probe_stiff.py:51-64's recipe (the
same in probe_damping.py and probe_isosort.py): VF / EE / EF at threshold
0.75 h, a budget of n // 4 per set and a cap of 2, then build_stencils with
the valid stencils kept and padded to a multiple of 8. The scans detect at
stiffness 1.0 and scale the stencils' stiffness per row
(`with_stiffness`); probe_contact.py detects at 1e3 directly.

Every solve is PCG to 1e-4 testing every 8 iterations, as the scripts'
(`solve`). Timing, the card line and --device come from
torch_dissect_common.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

import torch_dissect_common as dc

#: the scans' contact stiffnesses (probe_stiff.py:87)
STIFFNESS = (1e3, 1e4, 1e5, 1e6)
#: the scans' PCG: tol, iteration cap, convergence test spacing
TOL, MAX_ITERS, CHECK_EVERY = 1e-4, 20000, 8


def folded_sheet(grid: int):
    """The JAX bench's `collide` sheet. Returns (mesh, positions f32[N,3], h)."""
    from precond_tpu_torch.models import cloth

    mesh = cloth.make_grid(grid, grid, z_wave=0.0, mass=0.001, dt=1.0 / 60.0)
    h = 1.0 / max(grid - 1, 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    return mesh, p.astype(np.float32), h


def detect(pos, faces, edges, h: float, stiffness: float):
    """The probes' (and the bench's) detection on the tensors' device:
    VF/EE/EF at threshold 0.75 h, a budget of n // 4 per set and a cap of
    2, then build_stencils with the valid stencils kept (one host read) and
    padded to a multiple of 8. Returns (sets, infos, stencils, live count)."""
    from precond_tpu_torch.models import collision as coll
    from precond_tpu_torch.ops.stencils import build_stencils

    n = pos.shape[0]
    kw = dict(threshold=0.75 * h, stiffness=stiffness, max_pairs=n // 4)
    vf, i1 = coll.detect_vf_grid(pos, faces, per_vertex_cap=2, **kw)
    ee, i2 = coll.detect_ee_grid(pos, edges, per_edge_cap=2, **kw)
    ef, i3 = coll.detect_ef_grid(pos, edges, faces, per_edge_cap=2, **kw)
    st = build_stencils(edges, faces, ef=ef, ee=ee, vf=vf)
    keep = torch.nonzero(st.valid).reshape(-1)
    live = keep.numel()
    keep = torch.cat([keep, keep.new_zeros((-live) % 8)])
    st = type(st)(*(f[keep] for f in st))
    st.valid[live:] = False
    return (vf, ee, ef), (i1, i2, i3), st, live


def setup(grid: int, dev: torch.device, stiffness: float = 1.0) -> SimpleNamespace:
    """The probes' inputs on `dev`: the sheet and its stencils (detected at
    `stiffness`), the stencil system, the block-ELL, the row-major grid
    blocks, the tile maps, the positions and the [N,3] rhs (default_rng(0))."""
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.solver import SortMaps
    from precond_tpu_torch.utils import gridmorton as gm

    mesh, positions, h = folded_sheet(grid)
    n = mesh.num_verts
    k = grid.bit_length() - 1
    pos = torch.as_tensor(positions, device=dev)
    faces = torch.as_tensor(mesh.faces, device=dev)
    edges = torch.as_tensor(mesh.edges, device=dev)
    _, _, st, live = detect(pos, faces, edges, h, stiffness)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, positions=positions, device=dev)
    rng = np.random.default_rng(0)
    return SimpleNamespace(
        grid=grid, n=n, k=k, h=h, dev=dev, pos=pos, st=st, live=live,
        ssys=cloth.assemble_system_stencil(mesh, positions=positions, device=dev),
        ell=cloth.assemble_system(mesh, positions=positions, device=dev),
        dgr=dgr, drr=drr, offsets=offsets,
        maps=SortMaps(gm.sort_index(k, device=dev), gm.sort_index(k, inverse=True, device=dev)),
        b=torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32), device=dev))


def with_stiffness(st, stiff: float):
    """The stencils with every row's stiffness scaled (probe_stiff.py:88)."""
    return st._replace(stiff=st.stiff * stiff)


def contact_spmv(s, st):
    """The scans' operator: the grid stencil SpMV (K4) plus the slot contact
    SpMV on slots built once (probe_stiff.py:89, 94-95)."""
    from precond_tpu_torch.ops import gridstencil
    from precond_tpu_torch.ops.contact import build_contact_slots, slot_contact_spmv

    cs = build_contact_slots(st, s.n)
    return lambda v: gridstencil.spmv(s.ssys, v) + slot_contact_spmv(st, cs, v)


def static_pre(s, st, cfg):
    """The static grid M: prepare_grid with the stencils on the tile maps,
    applied row-major through the streaming crossings (probe_stiff.py:90-99)."""
    from precond_tpu_torch.ops.gridapply import precondition_grid
    from precond_tpu_torch.solver import prepare_grid
    from precond_tpu_torch.utils import gridmorton as gm

    inv = prepare_grid(s.dgr, s.drr, s.offsets, s.k, cfg, st, s.maps.orig_to_sorted)
    return lambda r: gm.morton_to_grid(precondition_grid(inv, gm.grid_to_morton(r, s.k), cfg), s.k)


def general_pre(s, st, maps, cfg):
    """The general M: prepare_with_system with the stencils on `maps`,
    applied in sorted space (probe_stiff.py:106-116)."""
    from precond_tpu_torch.ops.apply import precondition_sorted
    from precond_tpu_torch.solver import prepare_with_system

    gs, _ = prepare_with_system(s.ell, maps, cfg, st)
    s2o, o2s = gs.sorted_to_orig.long(), gs.orig_to_sorted.long()
    return lambda r: precondition_sorted(gs, r[s2o], cfg)[o2s]


def jacobi_pre(s, st):
    """Block-Jacobi on the ELL diagonal plus the contact diagonal
    (probe_stiff.py:121-125)."""
    from precond_tpu_torch.ops.contact import contact_diag

    dinv = torch.linalg.inv(s.ell.diag + contact_diag(st, s.n))
    return lambda r: torch.einsum("nij,nj->ni", dinv, r)


def solve(s, spmv, pre, max_iters: int = MAX_ITERS) -> dict:
    """One PCG solve of the sheet's rhs to TOL, testing every CHECK_EVERY
    iterations; its wall (host clock ending in a device sync) beside the
    iterations, the relative residual and ms per iteration."""
    from precond_tpu_torch import pcg

    dc.sync(s.dev)
    t0 = time.perf_counter()
    res = pcg(spmv, pre, s.b, tol=TOL, max_iters=max_iters, check_every=CHECK_EVERY)
    dc.sync(s.dev)
    wall = time.perf_counter() - t0
    return dict(iters=res.iterations, rel=float(res.rel_residual), wall_s=wall,
                ms_per_iter=wall * 1e3 / max(res.iterations, 1), x=res.x)


def wall_note(name: str, r: dict) -> str:
    return f"{name} {r['wall_s'] * 1e3:.1f} ms ({r['ms_per_iter']:.3f} ms/iter)"


def add_scan_args(default_grid: int):
    """argparse additions of the scans: the side (the JAX scripts' one
    positional argument) and the stiffnesses."""

    def add(ap):
        ap.add_argument("grid", type=int, nargs="?", default=default_grid,
                        help=f"side of the folded sheet (default {default_grid})")
        ap.add_argument("--stiff", type=float, nargs="+", default=list(STIFFNESS),
                        help="contact stiffnesses (default: the JAX script's four)")

    return add
