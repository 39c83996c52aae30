"""Cloth model: grid mesh, mass-spring Hessian, implicit-Euler system.

Port of ``precond_tpu/models/cloth.py:26-350``: an n x m grid with
structural, shear and bending springs, and the SPD implicit-Euler system

    H = (m / dt^2) M + sum_e k_e (d_e d_e^T expanded over the edge stencil)

in Gauss-Newton form (k d d^T per spring), SPD for any configuration, as
a block-ELL matrix (the general path) or in stencil form (the structured
grid path: StencilSystem planes for the SpMV, row-major per-direction
blocks for prepare_grid). Topology is built on the host (NumPy); block
values on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blockcsr import BlockEll


class ClothMesh(NamedTuple):
    positions: np.ndarray   # f32[N,3] rest positions
    edges: np.ndarray       # i32[E,4]: two endpoints + two opposite verts (-1 if boundary)
    faces: np.ndarray       # i32[F,3] triangles
    springs: np.ndarray     # i32[S,2] all spring endpoint pairs
    stiffness: np.ndarray   # f32[S]
    mass: float
    dt: float
    # (nx, ny) when the mesh is a regular grid; None for general meshes.
    grid: Tuple[int, int] | None = None

    @property
    def num_verts(self) -> int:
        return self.positions.shape[0]


def make_grid(nx: int, ny: int, size: float = 1.0, mass: float = 1.0, dt: float = 1.0 / 60.0,
              k_struct: float = 1e4, k_shear: float = 1e4, k_bend: float = 1e2,
              z_wave: float = 0.0) -> ClothMesh:
    """Regular nx x ny cloth grid in the XY plane (optionally z-perturbed)."""
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    scale = size / max(nx - 1, 1)
    pos = np.stack([xs * scale, ys * scale, np.zeros_like(xs, np.float64)], -1).reshape(-1, 3)
    if z_wave:
        pos[:, 2] = z_wave * np.sin(pos[:, 0] * 7.3) * np.cos(pos[:, 1] * 5.1)

    gi, gj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (gi * ny + gj).reshape(-1)
    b = ((gi + 1) * ny + gj).reshape(-1)
    c = ((gi + 1) * ny + gj + 1).reshape(-1)
    d = (gi * ny + gj + 1).reshape(-1)
    faces = np.concatenate(
        [np.stack([a, b, c], 1), np.stack([a, c, d], 1)]
    ).astype(np.int32)

    # unique mesh edges with opposite vertices (for collision stencils)
    he0 = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    he1 = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    hopp = np.concatenate([faces[:, 2], faces[:, 0], faces[:, 1]])
    n_total = nx * ny
    lo = np.minimum(he0, he1).astype(np.int64)
    hi = np.maximum(he0, he1).astype(np.int64)
    key = lo * n_total + hi
    order = np.argsort(key, kind="stable")
    key_s, lo_s, hi_s, opp_s = key[order], lo[order], hi[order], hopp[order]
    first = np.empty(len(key_s), bool)
    first[:1] = True
    first[1:] = key_s[1:] != key_s[:-1]
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, len(key_s)))
    opp1 = np.where(counts > 1, opp_s[np.minimum(starts + 1, len(key_s) - 1)], -1)
    edges = np.stack([lo_s[starts], hi_s[starts], opp_s[starts], opp1], 1).astype(np.int32)

    def grid_springs(di, dj):
        ii, jj = np.meshgrid(np.arange(nx - di), np.arange(ny - dj), indexing="ij")
        s0 = (ii * ny + jj).reshape(-1)
        s1 = ((ii + di) * ny + jj + dj).reshape(-1)
        return np.stack([s0, s1], 1)

    def shear_springs():
        ii, jj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
        s = np.stack([(ii * ny + jj).reshape(-1), ((ii + 1) * ny + jj + 1).reshape(-1)], 1)
        t = np.stack([((ii + 1) * ny + jj).reshape(-1), (ii * ny + jj + 1).reshape(-1)], 1)
        return np.concatenate([s, t])

    groups = [
        (grid_springs(1, 0), k_struct),
        (grid_springs(0, 1), k_struct),
        (shear_springs(), k_shear),
        (grid_springs(2, 0), k_bend),
        (grid_springs(0, 2), k_bend),
    ]
    springs = np.concatenate([g for g, _ in groups]).astype(np.int32)
    stiff = np.concatenate([np.full(len(g), k, np.float32) for g, k in groups])

    return ClothMesh(
        positions=pos.astype(np.float32),
        edges=edges,
        faces=faces,
        springs=springs,
        stiffness=stiff,
        mass=mass,
        dt=dt,
        grid=(nx, ny),
    )


def adjacency_from_springs(num_verts: int, springs: np.ndarray) -> list[np.ndarray]:
    """Vertex adjacency lists (the reference's m_neighbours CSR, h:51): the
    sorted distinct spring partners of each vertex, i32."""
    s = np.asarray(springs, np.int64).reshape(-1, 2)
    key = np.unique(np.concatenate([s[:, 0] * num_verts + s[:, 1],
                                    s[:, 1] * num_verts + s[:, 0]]))
    cols = (key % num_verts).astype(np.int32)
    return np.split(cols, np.searchsorted(key // num_verts, np.arange(1, num_verts)))


def spring_hessian_blocks(positions: torch.Tensor, springs: torch.Tensor,
                          stiffness: torch.Tensor) -> torch.Tensor:
    """Per-spring Gauss-Newton 3x3 block k * d d^T. [S,3,3]."""
    d = positions[springs[:, 1]] - positions[springs[:, 0]]
    len2 = torch.sum(d * d, dim=-1, keepdim=True)
    dn = d * torch.rsqrt(torch.clamp(len2, min=1e-12))
    return stiffness[:, None, None] * dn[:, :, None] * dn[:, None, :]


def ell_structure_from_springs(n: int, springs: np.ndarray):
    """Host-side integer setup: ELL sparsity + the slot->spring inverse.

    Returns (idx i32[N,K], mask bool[N,K], spring_of_slot i32[N,K]) where
    spring_of_slot[v,k] is the spring whose off-diagonal block belongs in
    slot (v,k) (S for padded slots), so the per-step value fill is a gather.
    """
    from .. import native

    idx, mask = native.elements_to_adjacency_ell(n, springs)
    k = idx.shape[1]
    s_count = len(springs)
    # rows are sorted ascending; key flattening makes the table globally
    # sorted so both slot lookups are two vectorized searchsorteds
    keys = np.where(mask, np.arange(n, dtype=np.int64)[:, None] * (n + 1) + idx,
                    np.arange(n, dtype=np.int64)[:, None] * (n + 1) + n).reshape(-1)
    a = springs[:, 0].astype(np.int64)
    b = springs[:, 1].astype(np.int64)
    slot_a = np.searchsorted(keys, a * (n + 1) + b) - a * k
    slot_b = np.searchsorted(keys, b * (n + 1) + a) - b * k
    if not (np.all((slot_a >= 0) & (slot_a < k)) and np.all((slot_b >= 0) & (slot_b < k))):
        raise ValueError("spring endpoints missing from the adjacency table")
    spring_of_slot = np.full(n * k, s_count, np.int32)
    spring_of_slot[a * k + slot_a] = np.arange(s_count, dtype=np.int32)
    spring_of_slot[b * k + slot_b] = np.arange(s_count, dtype=np.int32)
    return idx, mask, spring_of_slot.reshape(n, k)


def assemble_system(mesh: ClothMesh, positions: np.ndarray | None = None,
                    device=None) -> BlockEll:
    """Implicit-Euler system H = (m/dt^2) I + spring Hessian, as BlockEll.

    Structure on the host (integers only), values on `device` (the card
    unless the caller asks for the CPU).
    """
    dev = resolve_device(device)
    n = mesh.num_verts
    idx, mask, spring_of_slot = ell_structure_from_springs(n, mesh.springs)
    shell = BlockEll(
        diag=torch.zeros((n, 3, 3), dtype=torch.float32, device=dev),
        idx=torch.as_tensor(idx, device=dev),
        blocks=torch.zeros(idx.shape + (3, 3), dtype=torch.float32, device=dev),
        mask=torch.as_tensor(mask, device=dev),
    )
    pos = mesh.positions if positions is None else positions
    return update_ell_blocks(
        shell,
        torch.as_tensor(mesh.springs, device=dev),
        torch.as_tensor(mesh.stiffness, device=dev),
        torch.as_tensor(np.asarray(pos, np.float32), device=dev),
        mesh.mass / mesh.dt**2,
        torch.as_tensor(spring_of_slot, device=dev),
    )


def update_ell_blocks(h: BlockEll, mesh_springs: torch.Tensor, stiffness: torch.Tensor,
                      positions: torch.Tensor, mass_over_dt2: float,
                      spring_of_slot: torch.Tensor) -> BlockEll:
    """Per-step refresh of spring blocks into a fixed ELL sparsity.

    Gather-only: blocks[v,k] = -ke[spring_of_slot[v,k]] and the diagonal is
    the mass term plus the row-sum of gathered spring blocks. Assumes at
    most one spring per vertex pair (the mesh builders never produce more).
    """
    ke = spring_hessian_blocks(positions, mesh_springs, stiffness)  # [S,3,3]
    s_count = ke.shape[0]
    ke_pad = torch.cat([ke, ke.new_zeros((1, 3, 3))])
    gathered = ke_pad[torch.clamp(spring_of_slot, max=s_count)]    # [N,K,3,3]
    eye = torch.eye(3, dtype=h.diag.dtype, device=h.diag.device)
    diag = mass_over_dt2 * eye[None] + gathered.sum(dim=1)
    return h._replace(diag=diag, blocks=-gathered)


# ---- stencil-form assembly (structured-grid path) --------------------------
#
# On a regular grid every spring lies at one of ~6 canonical (di, dj)
# offsets, so the system can be held in stencil form (ops/gridstencil.py)
# and assembly needs no gathers: position differences are window slices,
# and each direction's blocks pad into place.

def stencil_structure_from_springs(nx: int, ny: int, springs: np.ndarray,
                                   stiffness: np.ndarray):
    """Host-side one-time structure: canonical offsets + stiffness grids.

    Returns (offsets, ks) where offsets is a tuple of canonical (di, dj)
    with di > 0 or (di == 0 and dj > 0), and ks f32[Dc, nx, ny] holds the
    stiffness of the spring leaving vertex (i, j) in that direction (0 if
    absent; duplicates accumulate).
    """
    a, b = springs[:, 0].astype(np.int64), springs[:, 1].astype(np.int64)
    di = b // ny - a // ny
    dj = b % ny - a % ny
    flip = (di < 0) | ((di == 0) & (dj < 0))
    a, b = np.where(flip, b, a), np.where(flip, a, b)
    di, dj = np.where(flip, -di, di), np.where(flip, -dj, dj)
    keys = sorted({(int(p), int(q)) for p, q in zip(di, dj)})
    ks = np.zeros((len(keys), nx, ny), np.float32)
    for d, (p, q) in enumerate(keys):
        sel = (di == p) & (dj == q)
        np.add.at(ks[d].reshape(-1), a[sel], stiffness[sel])
    return tuple(keys), ks


def _pad2(t: torch.Tensor, rows: Tuple[int, int], cols: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad the leading two axes of [mx, my, 3, 3]."""
    return torch.nn.functional.pad(t, (0, 0, 0, 0, cols[0], cols[1], rows[0], rows[1]))


def _stencil_block_fields(offsets, ks: torch.Tensor, positions: torch.Tensor,
                          mass_over_dt2: float, grid):
    """Shared block computation: positions -> (diag [n,3,3], dirs list of
    [n,3,3] row-major, full_offsets). Gather-free.

    Per canonical direction: window-slice the endpoint positions, form the
    Gauss-Newton block k d^ d^T per spring, pad it into both endpoints'
    direction planes (negated off-diagonal), and accumulate the diagonal.
    """
    nx, ny = grid
    n = nx * ny
    pos = positions.reshape(nx, ny, 3)
    eye = torch.eye(3, dtype=positions.dtype, device=positions.device)
    diag = (mass_over_dt2 * eye).expand(nx, ny, 3, 3)
    dirs, full_offsets = [], []
    for d, (di, dj) in enumerate(offsets):
        ai0, aj0 = max(0, -di), max(0, -dj)
        bi0, bj0 = max(0, di), max(0, dj)
        mx, my = nx - abs(di), ny - abs(dj)
        pa = pos[ai0: ai0 + mx, aj0: aj0 + my]
        pb = pos[bi0: bi0 + mx, bj0: bj0 + my]
        dv = pb - pa
        dn = dv * torch.rsqrt(torch.clamp(torch.sum(dv * dv, -1, keepdim=True), min=1e-12))
        kb = ks[d, ai0: ai0 + mx, aj0: aj0 + my][..., None, None] \
            * dn[..., :, None] * dn[..., None, :]            # [mx,my,3,3]
        at_a = _pad2(kb, (ai0, nx - mx - ai0), (aj0, ny - my - aj0))
        at_b = _pad2(kb, (bi0, nx - mx - bi0), (bj0, ny - my - bj0))
        diag = diag + at_a + at_b
        dirs.append(-at_a.reshape(n, 3, 3))
        full_offsets.append((di, dj))
        dirs.append(-at_b.reshape(n, 3, 3))
        full_offsets.append((-di, -dj))
    return diag.reshape(n, 3, 3), dirs, tuple(full_offsets)


def update_stencil_blocks(offsets, ks: torch.Tensor, positions: torch.Tensor,
                          mass_over_dt2: float, grid, sym: bool = False):
    """Stencil refresh: positions -> StencilSystem (vertex-minor planes).

    sym=True keeps only the canonical half of the direction planes (the
    symmetric SpMV applies each plane to both endpoints)."""
    from ..ops.gridstencil import StencilSystem

    nx, ny = grid
    n = nx * ny
    diag, dirs, full_offsets = _stencil_block_fields(
        offsets, ks, positions, mass_over_dt2, grid
    )
    if sym:
        dirs = dirs[0::2]                 # canonical (+d) planes only
        full_offsets = full_offsets[0::2]
    return StencilSystem(
        diag.reshape(n, 9).T.contiguous().reshape(3, 3, n),
        torch.stack(dirs).reshape(-1, n, 9).permute(0, 2, 1).contiguous().reshape(-1, 3, 3, n),
        tuple(full_offsets), (nx, ny), sym=sym,
    )


def update_grid_blocks(offsets, ks: torch.Tensor, positions: torch.Tensor,
                       mass_over_dt2: float, grid):
    """Refresh of ROW-MAJOR blocks for the static grid assembly
    (ops/gridassembly.py): (diag f32[N,3,3], dirs f32[D,N,3,3])."""
    diag, dirs, _ = _stencil_block_fields(offsets, ks, positions, mass_over_dt2, grid)
    return diag, torch.stack(dirs)


def _grid_inputs(mesh: ClothMesh, positions, device, what: str):
    if mesh.grid is None:
        raise ValueError(f"{what} needs a grid mesh")
    dev = resolve_device(device)
    nx, ny = mesh.grid
    offsets, ks = stencil_structure_from_springs(nx, ny, mesh.springs, mesh.stiffness)
    pos = mesh.positions if positions is None else positions
    return (offsets, torch.as_tensor(ks, device=dev),
            torch.as_tensor(np.asarray(pos, np.float32), device=dev),
            mesh.mass / mesh.dt**2, (nx, ny))


def assemble_system_grid(mesh: ClothMesh, positions: np.ndarray | None = None, device=None):
    """Row-major per-direction blocks for the static grid assembly, on
    `device` (the card unless the caller asks for the CPU).

    Returns (diag f32[N,3,3], dirs f32[D,N,3,3], full_offsets): the same
    physics as assemble_system_stencil in the layout ops/gridassembly.py
    consumes."""
    offsets, ks, pos, m_dt2, grid = _grid_inputs(mesh, positions, device, "grid assembly")
    full_offsets = tuple(o for di, dj in offsets for o in ((di, dj), (-di, -dj)))
    diag, dirs = update_grid_blocks(offsets, ks, pos, m_dt2, grid)
    return diag, dirs, full_offsets


def assemble_system_stencil(mesh: ClothMesh, positions: np.ndarray | None = None,
                            sym: bool = False, device=None):
    """Implicit-Euler system as a StencilSystem (structured grids only), on
    `device` (the card unless the caller asks for the CPU)."""
    offsets, ks, pos, m_dt2, grid = _grid_inputs(mesh, positions, device, "stencil assembly")
    return update_stencil_blocks(offsets, ks, pos, m_dt2, grid, sym)
