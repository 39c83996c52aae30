"""Implicit-Euler cloth and soft-body simulators driving the preconditioned
PCG (port of ``precond_tpu/models/simulator.py``).

The reference ships only the preconditioner; the host simulator that owns
time integration, force/Hessian assembly, collision detection and the PCG
loop is reconstructed in SURVEY.md §3.4 from the API comments
(SeSchwarzPreconditioner.h:55-63). One step = inertia target ->
Gauss-Newton system -> Schwarz-PCG solve -> velocity update, with
pinned-vertex constraints and optional self-collision penalties.

The JAX package jits each frame into one dispatch; the port runs it
eagerly on the simulator's device (the card unless the caller asks for the
CPU), with the PCG's one host sync per iteration. Every float scatter-add
is utils/scatter.accumulate_rows. A step is the span ``frame``, split into
``frame.resort``, ``frame.detect``, ``frame.rhs``, ``frame.refresh``,
``frame.prepare``, ``frame.pcg`` and ``frame.update`` (profiling.span).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SchwarzConfig
from ..device import resolve_device
from ..ops import blockcsr, boxstencil, gridstencil
from ..ops.apply import precondition_sorted
from ..ops.contact import contact_forces, stencil_contact_spmv
from ..ops.cuda.packed_symv import DenseInverseCM, PackedInverseCM
from ..ops.gridapply import precondition_grid, precondition_grid_cm
from ..ops.gridassembly import pin_grid_blocks
from ..ops.stencils import build_stencils
from ..parallel.pcg import pcg
from ..profiling import set_count, span
from ..solver import SchwarzPreconditioner, SortMaps, prepare_box, prepare_grid, prepare_with_system
from ..utils import boxmorton as bm
from ..utils import gridmorton as gm
from ..utils.scatter import accumulate_rows
from . import cloth as cloth_model
from . import collision as collision_model
from . import tetmesh as tet_model


class SimState(NamedTuple):
    positions: torch.Tensor   # f32[N,3]
    velocities: torch.Tensor  # f32[N,3]
    step_count: int = 0


class _Contact:
    """The collision settings both simulators share, and their detection."""

    def __init__(self, stiffness, threshold, budget, cell_cap, rest_gap):
        self.on = stiffness > 0.0
        self.stiffness = stiffness
        self.threshold = threshold
        self.budget = budget
        self.cell_cap = cell_cap
        # penalty rest separation: contacts push apart until this gap
        # (defaults to the detection threshold)
        self.rest_gap = threshold if rest_gap is None else rest_gap

    def detect(self, x, faces, edges, pinned, cfg: SchwarzConfig):
        """Hash-grid VF/EE/EF detection (the reference consumes all three,
        cpp:67-72) with the per-vertex budget cfg.max_collision_per_vert
        (cpp:187-188). Returns (stencils, pinned-eliminated stencils, info).

        Pinned DOF are eliminated from the solve (dx = 0), so the contact
        Hessian entering H and M must be the eliminated one too: the stencil
        Hessian is rank-1 in the weights (stiff * w w^T (x) d d^T), so
        zeroing pinned vertices' weights reproduces it exactly. The penalty
        forces keep the full weights: the gap depends on pinned positions
        even though their DOF do not move."""
        kv = cfg.max_collision_per_vert
        kw = dict(threshold=self.threshold, stiffness=self.stiffness, max_pairs=self.budget,
                  cell_cap=self.cell_cap)
        vf, i1 = collision_model.detect_vf_grid(x, faces, per_vertex_cap=kv, **kw)
        ee, i2 = collision_model.detect_ee_grid(x, edges, per_edge_cap=kv, **kw)
        ef, i3 = collision_model.detect_ef_grid(x, edges, faces, per_edge_cap=kv, **kw)
        stencils = build_stencils(edges, faces, ef=ef, ee=ee, vf=vf)
        info = collision_model.DetectInfo(
            truncated=i1.truncated | i2.truncated | i3.truncated,
            dropped=i1.dropped + i2.dropped + i3.dropped,
        )
        wmask = ~pinned[torch.clamp(stencils.idx, 0, x.shape[0] - 1).long()]
        st_sys = stencils._replace(weight=stencils.weight * wmask.to(torch.float32))
        return stencils, st_sys, info


def _pin_ell(ell: blockcsr.BlockEll, pinned: torch.Tensor, m_dt2: float) -> blockcsr.BlockEll:
    """Decouple pinned rows/columns, keep an SPD mass diagonal on them."""
    touches = pinned[:, None] | pinned[ell.idx.long()]
    eye = torch.eye(3, dtype=ell.diag.dtype, device=ell.diag.device)
    return ell._replace(
        blocks=torch.where(touches[:, :, None, None], torch.zeros_like(ell.blocks), ell.blocks),
        diag=torch.where(pinned[:, None, None], m_dt2 * eye, ell.diag),
    )


def _sorted_solve(ell, maps: SortMaps, cfg: SchwarzConfig, st_sys, rhs, tol, max_iters):
    """The general path: prepare_with_system, then PCG in Morton-sorted space
    (rhs permuted once, x back once) with the block-ELL SpMV plus the
    rank-1 contact SpMV of the stencils mapped into sorted space."""
    n = rhs.shape[0]
    with span("frame.prepare"):
        state, ells = prepare_with_system(ell, maps, cfg, st_sys)
        if st_sys is not None:
            mapped = st_sys._replace(
                idx=maps.orig_to_sorted[torch.clamp(st_sys.idx, 0, n - 1).long()])

            def spmv_op(p):
                return blockcsr.spmv(ells, p) + stencil_contact_spmv(mapped, p)
        else:
            def spmv_op(p):
                return blockcsr.spmv(ells, p)
    with span("frame.pcg"):
        res = pcg(spmv_op, lambda r: precondition_sorted(state, r, cfg),
                  rhs[maps.sorted_to_orig.long()], tol=tol, max_iters=max_iters)
        return res, res.x[maps.orig_to_sorted.long()]


def _pinned_mask(n: int, pinned, device) -> torch.Tensor:
    mask = torch.zeros((n,), dtype=torch.bool, device=device)
    if pinned is not None:
        mask[torch.as_tensor(np.asarray(pinned), device=device).long()] = True
    return mask


class SoftBodySim:
    """Tet-body deformable, implicit Euler, Schwarz-PCG solve.

    material="linear": small-strain elasticity keeps K constant — H is
    assembled and prepared once, internal forces f = -K (x - x0) reuse the
    solver SpMV.

    material="corotational": warped-stiffness elasticity — per-element
    rotations R from the deformation gradient's polar factor, H = M/dt^2 +
    sum_e R_e K_e R_e^T reassembled every step, forces f_a = -sum R K
    (R^T x - x0).

    material="neohookean": stable Neo-Hookean (Smith, de Goes & Kim 2018)
    — exact autodiff forces and eigen-projected SPD element Hessians
    reassembled every step.

    collision_stiffness > 0 enables self-contact on the surface mesh, with
    the same treatment as ClothSim. Power-of-two boxes take the structured
    box path (analytic 3-D tile order, prepare_box, stencil SpMV).
    """

    def __init__(self, mesh, cfg: SchwarzConfig = SchwarzConfig(),
                 gravity=(0.0, 0.0, -9.8), pinned: Optional[np.ndarray] = None,
                 tol: float = 1e-4, max_iters: int = 400,
                 material: str = "linear",
                 collision_stiffness: float = 0.0,
                 collision_threshold: float = 0.0,
                 collision_budget: int = 256,
                 collision_cell_cap: int = 16,
                 collision_rest_gap: Optional[float] = None,
                 device=None):
        if material not in ("linear", "corotational", "neohookean"):
            raise ValueError(f"material={material!r}")
        dev = self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.tol = tol
        self.max_iters = max_iters
        self.material = material
        self.gravity = torch.tensor(gravity, dtype=torch.float32, device=dev)
        self.pinned = _pinned_mask(mesh.num_verts, pinned, dev)
        self.contact = _Contact(collision_stiffness, collision_threshold, collision_budget,
                                collision_cell_cap, collision_rest_gap)
        self.collide = self.contact.on

        self._box = mesh.dims if (mesh.dims and bm.supported(*mesh.dims)) else None
        self._static_system = material == "linear" and not self.collide
        self.pre = SchwarzPreconditioner(cfg, device=dev)
        if self._box is not None:
            # analytic box ordering (topology-derived, never re-sorts)
            s2o, o2s = bm.sort_maps(*self._box)
            self.pre.maps = SortMaps(torch.as_tensor(s2o, device=dev),
                                     torch.as_tensor(o2s, device=dev))
        else:
            # general-path sort maps from REST positions (domain quality
            # follows rest-space locality; bodies deform locally)
            self.pre.allocate(mesh.positions)

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        self._ell_struct = tuple(map(t, tet_model.ell_structure_from_tets(mesh.num_verts,
                                                                          mesh.tets)))
        self._tets_d = t(mesh.tets)
        self._rest_d = t(np.asarray(mesh.positions, np.float32))
        self._faces_d = t(mesh.faces)
        self._edges_d = t(mesh.edges)
        self._ke0 = tet_model.element_blocks(self._rest_d, self._tets_d, mesh.lam, mesh.mu)

        if self._static_system:
            m_dt2 = mesh.mass / mesh.dt**2
            self.ell = _pin_ell(tet_model.assemble_system(mesh, device=dev), self.pinned, m_dt2)
            self._bsys = None
            if self._box is not None:
                # structured-box path: analytic 3-D tile ordering (no runtime
                # sort, arithmetic hierarchy) + gather-free SpMV
                self._bsys = boxstencil.from_ell(self.ell, self._box)
                dgr, drr = boxstencil.planes_from_ell(self.ell, self._box)
                self._inv96 = prepare_box(dgr, drr, boxstencil.BOX_OFFSETS, self._box, cfg)
            else:
                self.pre.prepare(self.ell)
        self.state = SimState(positions=self._rest_d.clone(),
                              velocities=torch.zeros((mesh.num_verts, 3), dtype=torch.float32,
                                                     device=dev))

    def _box_ops(self, bsys, inv96):
        """(spmv, apply) of the box path, in row-major box order."""
        nx, ny, nz = self._box

        def pre_apply(r):
            return bm.morton_to_box(
                precondition_grid(inv96, bm.box_to_morton(r, nx, ny, nz), self.cfg), nx, ny, nz)

        return (lambda p: boxstencil.spmv(bsys, p)), pre_apply

    # -- static-system step (constant K, prepared once) ---------------------

    def _step_static(self, x, v):
        dt = self.mesh.dt
        m_dt2 = self.mesh.mass / dt**2
        if self._box is not None:
            spmv_op, pre_apply = self._box_ops(self._bsys, self._inv96)
        else:
            spmv_op, pre_apply = (lambda p: blockcsr.spmv(self.ell, p)), self.pre.apply

        with span("frame.rhs"):
            # f_int = -K (x - x0); K = H - (m/dt^2) I on unpinned rows
            dxr = x - self._rest_d
            f_int = -(spmv_op(dxr) - m_dt2 * dxr)
            y = x + dt * v + dt * dt * self.gravity[None, :]
            rhs = m_dt2 * (y - x) + f_int
            rhs = torch.where(self.pinned[:, None], torch.zeros_like(rhs), rhs)
        with span("frame.pcg"):
            res = pcg(spmv_op, pre_apply, rhs, tol=self.tol, max_iters=self.max_iters)
        return res, res.x, None

    # -- dynamic-system step (corotational, neohookean and/or colliding) ---

    def _step_dynamic(self, x, v):
        cfg, mesh = self.cfg, self.mesh
        dt = mesh.dt
        m_dt2 = mesh.mass / dt**2
        tets, rest, ke0 = self._tets_d, self._rest_d, self._ke0
        with span("frame.refresh"):
            if self.material == "corotational":
                r = tet_model.corot_rotations(x, rest, tets)
                ke = tet_model.element_blocks_corot(ke0, r)
                f_int = tet_model.corot_forces(ke0, r, x, rest, tets)
            elif self.material == "neohookean":
                ke = tet_model.snh_element_blocks(x, rest, tets, mesh.lam, mesh.mu)
                f_int = tet_model.snh_forces(x, rest, tets, mesh.lam, mesh.mu)
            else:
                ke = ke0
                eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(tets.shape[0], 3, 3)
                f_int = tet_model.corot_forces(ke0, eye, x, rest, tets)
            ell = _pin_ell(tet_model.fill_ell_from_ke(*self._ell_struct, ke, m_dt2), self.pinned,
                           m_dt2)

        stencils = st_sys = info = None
        if self.collide:
            with span("frame.detect"):
                stencils, st_sys, info = self.contact.detect(x, self._faces_d, self._edges_d,
                                                             self.pinned, cfg)

        with span("frame.rhs"):
            # rhs: inertia target + internal + contact penalty forces
            y = x + dt * v + dt * dt * self.gravity[None, :]
            rhs = m_dt2 * (y - x) + f_int
            if stencils is not None:
                rhs = rhs + contact_forces(stencils, x, self.contact.rest_gap)
            rhs = torch.where(self.pinned[:, None], torch.zeros_like(rhs), rhs)

        maps = self.pre.maps
        if self._box is not None:
            with span("frame.refresh"):
                bsys = boxstencil.from_ell(ell, self._box)
                dgr, drr = boxstencil.planes_from_ell(ell, self._box)
            with span("frame.prepare"):
                inv96 = prepare_box(dgr, drr, boxstencil.BOX_OFFSETS, self._box, cfg,
                                    st_sys, maps.orig_to_sorted)
            box_spmv, pre_op = self._box_ops(bsys, inv96)
            if st_sys is not None:
                # rank-1 stencil form of the contact Hessian (ops/contact.py)
                def spmv_op(p):
                    return box_spmv(p) + stencil_contact_spmv(st_sys, p)
            else:
                spmv_op = box_spmv
            with span("frame.pcg"):
                res = pcg(spmv_op, pre_op, rhs, tol=self.tol, max_iters=self.max_iters)
            return res, res.x, info
        res, x_unsorted = _sorted_solve(ell, maps, cfg, st_sys, rhs, self.tol, self.max_iters)
        return res, x_unsorted, info

    def step(self) -> SimState:
        with span("frame"):
            x, v = self.state.positions, self.state.velocities
            if self._static_system:
                res, dx, info = self._step_static(x, v)
            else:
                res, dx, info = self._step_dynamic(x, v)
            with span("frame.update"):
                dx = torch.where(self.pinned[:, None], torch.zeros_like(dx), dx)
                x_new = x + dx
                self.state = SimState(positions=x_new, velocities=(x_new - x) / self.mesh.dt,
                                      step_count=self.state.step_count + 1)
        self.last_solve = res
        self.last_detect_info = info
        return self.state


class ClothSim:
    """Mass-spring cloth with implicit Euler and multilevel Schwarz PCG.

    Power-of-two square grids take the structured grid path: the analytic
    tile order (never re-sorted), prepare_grid with the contacts' Hessian
    terms by arithmetic climbs, the stencil SpMV (K4 on the card) and the
    grid apply — comp-major when prepare_grid returns a comp-major inverse,
    row-major otherwise. Other meshes take the general path.
    """

    def __init__(
        self,
        mesh: cloth_model.ClothMesh,
        cfg: SchwarzConfig = SchwarzConfig(),
        gravity=(0.0, 0.0, -9.8),
        pinned: Optional[np.ndarray] = None,
        tol: float = 1e-4,
        max_iters: int = 400,
        collision_stiffness: float = 0.0,
        collision_threshold: float = 0.0,
        collision_budget: int = 256,
        collision_cell_cap: int = 16,
        collision_rest_gap: Optional[float] = None,
        device=None,
    ):
        dev = self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.tol = tol
        self.max_iters = max_iters
        n = mesh.num_verts
        self.gravity = torch.tensor(gravity, dtype=torch.float32, device=dev)
        self.pinned = _pinned_mask(n, pinned, dev)
        self.contact = _Contact(collision_stiffness, collision_threshold, collision_budget,
                                collision_cell_cap, collision_rest_gap)
        self.collide = self.contact.on

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        self.pre = SchwarzPreconditioner(cfg, device=dev)
        # fixed ELL sparsity from rest topology; values refresh per step
        self._ell0 = cloth_model.assemble_system(mesh, device=dev)
        _, ell_mask, spring_of_slot = cloth_model.ell_structure_from_springs(n, mesh.springs)
        # grid path: the analytic tile order follows connectivity, which is
        # static for a grid, so it never re-sorts
        self._gmk = None
        if mesh.grid is not None and gm.supported(*mesh.grid):
            self._gmk = mesh.grid[0].bit_length() - 1
            s2o, o2s = gm.sort_maps(self._gmk)
            self._grid_maps = SortMaps(t(s2o), t(o2s))
            self._stencil_offsets, ks = cloth_model.stencil_structure_from_springs(
                mesh.grid[0], mesh.grid[1], mesh.springs, mesh.stiffness)
            self._stencil_ks = t(ks)
        else:
            # the general path's padded ELL; its SpMV kernel reads the stored slots only
            set_count("spmv.ell_slots", int(ell_mask.size))
            set_count("spmv.ell_stored", int(ell_mask.sum()))
        self._springs_d = t(mesh.springs)
        self._stiff_d = t(mesh.stiffness)
        self._rest_pos = t(np.asarray(mesh.positions, np.float32))
        self._faces_d = t(mesh.faces)
        self._edges_d = t(mesh.edges)
        self._sos_d = t(spring_of_slot)
        self.state = SimState(positions=self._rest_pos.clone(),
                              velocities=torch.zeros((n, 3), dtype=torch.float32, device=dev))

    def _rhs(self, x, v, stencils):
        """Gauss-Newton rhs around x with the inertia target, spring forces
        and the gap-aware contact penalty forces; zero on pinned rows."""
        mesh = self.mesh
        dt = mesh.dt
        m_dt2 = mesh.mass / dt**2
        s0, s1 = self._springs_d[:, 0].long(), self._springs_d[:, 1].long()
        rest = torch.linalg.norm(self._rest_pos[s1] - self._rest_pos[s0], dim=-1)
        d = x[s1] - x[s0]
        length = torch.linalg.norm(d, dim=-1)
        dn = d / torch.clamp(length, min=1e-12)[:, None]
        f = (self._stiff_d * (length - rest))[:, None] * dn
        f_int = torch.zeros_like(x)
        accumulate_rows(f_int, torch.cat([s0, s1]), torch.cat([f, -f]))
        y = x + dt * v + dt * dt * self.gravity[None, :]
        rhs = m_dt2 * (y - x) + f_int
        if stencils is not None:
            rhs = rhs + contact_forces(stencils, x, self.contact.rest_gap)
        return torch.where(self.pinned[:, None], torch.zeros_like(rhs), rhs)

    def _frame(self, x, v):
        cfg, mesh = self.cfg, self.mesh
        m_dt2 = mesh.mass / mesh.dt**2
        pinned = self.pinned
        stencils = st_sys = info = None
        if self.collide:
            with span("frame.detect"):
                stencils, st_sys, info = self.contact.detect(x, self._faces_d, self._edges_d,
                                                             pinned, cfg)
        with span("frame.rhs"):
            rhs = self._rhs(x, v, stencils)
        maps = self.pre.maps
        gmk = self._gmk
        if gmk is None:
            with span("frame.refresh"):
                ell = cloth_model.update_ell_blocks(self._ell0, self._springs_d, self._stiff_d,
                                                    x, m_dt2, self._sos_d)
                ell = _pin_ell(ell, pinned, m_dt2)
            res, x_unsorted = _sorted_solve(ell, maps, cfg, st_sys, rhs, self.tol, self.max_iters)
            return res, x_unsorted, info

        # static-pattern grid prepare: no ELL permute, no hierarchy build;
        # contacts ride the same static path with arithmetic-climb terms
        grid, offs = mesh.grid, self._stencil_offsets
        full_off = tuple(o for di, dj in offs for o in ((di, dj), (-di, -dj)))
        with span("frame.refresh"):
            dgr, drr = cloth_model.update_grid_blocks(offs, self._stencil_ks, x, m_dt2, grid)
            dgr, drr = pin_grid_blocks(dgr, drr, full_off, grid, pinned, m_dt2)
        with span("frame.prepare"):
            inv96 = prepare_grid(dgr, drr, full_off, gmk, cfg, st_sys, maps.orig_to_sorted)
        with span("frame.refresh"):
            ssys = gridstencil.pin_vertices(
                cloth_model.update_stencil_blocks(offs, self._stencil_ks, x, m_dt2, grid),
                pinned, m_dt2)
        if isinstance(inv96, (PackedInverseCM, DenseInverseCM)):
            # comp-major solve: [3,N] carries, transpose-free SpMV
            def pre_op(r):
                return gm.morton_to_grid_cm(
                    precondition_grid_cm(inv96, gm.grid_to_morton_cm(r, gmk), cfg), gmk)

            if st_sys is not None:
                def spmv_op(p):
                    return gridstencil.spmv_t(ssys, p) + stencil_contact_spmv(st_sys, p.T).T
            else:
                def spmv_op(p):
                    return gridstencil.spmv_t(ssys, p)
            with span("frame.pcg"):
                res = pcg(spmv_op, pre_op, rhs.T.contiguous(), tol=self.tol,
                          max_iters=self.max_iters)
                return res, res.x.T, info
        g2m, m2g = gm.crossing_pair(gmk)

        def pre_op(r):
            return m2g(precondition_grid(inv96, g2m(r, gmk), cfg), gmk)

        if st_sys is not None:
            def spmv_op(p):
                return gridstencil.spmv(ssys, p) + stencil_contact_spmv(st_sys, p)
        else:
            def spmv_op(p):
                return gridstencil.spmv(ssys, p)
        with span("frame.pcg"):
            res = pcg(spmv_op, pre_op, rhs, tol=self.tol, max_iters=self.max_iters)
        return res, res.x, info

    def step(self) -> SimState:
        """Advance one frame: re-sort on the cadence (general path), then
        detection, prepare and PCG."""
        with span("frame"):
            x, v = self.state.positions, self.state.velocities
            if self._gmk is not None:
                # analytic grid ordering is topology-derived: never re-sorts
                self.pre.maps = self._grid_maps
                self.pre.frame_index += 1
            elif self.pre.resorts_next():
                with span("frame.resort"):
                    self.pre.allocate(x)  # refreshes Morton maps on the cadence
            else:
                self.pre.allocate(x)  # counts the frame toward the cadence
            res, x_unsorted, info = self._frame(x, v)
            with span("frame.update"):
                dx = torch.where(self.pinned[:, None], torch.zeros_like(x_unsorted), x_unsorted)
                x_new = x + dx
                self.state = SimState(positions=x_new, velocities=(x_new - x) / self.mesh.dt,
                                      step_count=self.state.step_count + 1)
        self.last_solve = res
        self.last_detect_info = info
        return self.state
