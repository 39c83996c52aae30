"""Tet-mesh deformable body: FEM Hessians and the implicit system (port of
``precond_tpu/models/tetmesh.py``).

A box of tets with linear, corotational or stable Neo-Hookean elasticity,
producing the 3x3-block system the preconditioner consumes:

    H = (m/dt^2) M + K,   K_ab = V (λ g_a g_b^T + μ g_b g_a^T + μ (g_a·g_b) I)

with g_i the linear shape-function gradients. Topology is built on the
host with NumPy (the same integers as the JAX package, vectorized); block
values on the device. The per-vertex force placement goes through
utils/scatter.accumulate_rows (a fixed-order segmented sum). The stable
Neo-Hookean forces and Hessians use torch.func in place of jax.grad /
jax.hessian.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blockcsr import BlockEll
from ..utils.scatter import accumulate_rows


class TetMesh(NamedTuple):
    positions: np.ndarray  # f32[N,3]
    tets: np.ndarray       # i32[T,4]
    faces: np.ndarray      # i32[F,3] surface triangles (for collisions)
    edges: np.ndarray      # i32[E,4] surface edges (2 endpoints + 2 opposite)
    mass: float
    dt: float
    lam: float             # Lamé lambda
    mu: float              # Lamé mu
    dims: tuple | None = None  # (nx, ny, nz) for structured boxes

    @property
    def num_verts(self) -> int:
        return self.positions.shape[0]


# 5-tet decompositions of a cube (corner c = a*4 + b*2 + d for offsets
# (a, b, d)), parity-flipped for conformity between neighbouring cubes
_TETS_EVEN = np.array([(0, 1, 2, 4), (1, 2, 3, 7), (1, 4, 5, 7), (2, 4, 6, 7), (1, 2, 4, 7)])
_TETS_ODD = np.array([(0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7), (0, 3, 5, 6)])
_TET_FACES = np.array([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)])


def make_box(nx: int, ny: int, nz: int, size: float = 1.0, mass: float = 1.0,
             dt: float = 1.0 / 60.0, youngs: float = 1e5, poisson: float = 0.4) -> TetMesh:
    """Box of (nx-1)(ny-1)(nz-1) cubes, 5 tets each.

    The JAX package builds the same arrays with Python loops and dicts;
    here they are vectorized in the same order: tets cube by cube (i, j, k
    row-major), surface faces (the faces of exactly one tet, as sorted
    triples) in order of first appearance, surface edges sorted by their
    endpoints with the opposite vertices in order of appearance."""
    xs, ys, zs = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    scale = size / max(nx - 1, 1)
    pos = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32) * scale

    ci, cj, ck = (a.reshape(-1) for a in np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"))
    corners = np.stack([((ci + a) * ny + cj + b) * nz + ck + d
                        for a in (0, 1) for b in (0, 1) for d in (0, 1)], axis=1)   # [C,8]
    even = ((ci + cj + ck) % 2 == 0)[:, None, None]
    tets = np.where(even, corners[:, _TETS_EVEN], corners[:, _TETS_ODD])
    tets = tets.reshape(-1, 4).astype(np.int32)

    # surface triangles: faces appearing in exactly one tet
    n = nx * ny * nz
    tri = np.sort(tets[:, _TET_FACES].reshape(-1, 3).astype(np.int64), axis=1)
    key = (tri[:, 0] * n + tri[:, 1]) * n + tri[:, 2]
    _, first, counts = np.unique(key, return_index=True, return_counts=True)
    keep = np.sort(first[counts == 1])
    faces = tri[keep].astype(np.int32).reshape(-1, 3)

    # surface edges with the opposite vertex of each adjacent face
    he = np.stack([faces[:, [0, 1, 2]], faces[:, [1, 2, 0]], faces[:, [2, 0, 1]]],
                  axis=1).reshape(-1, 3).astype(np.int64)               # (e0, e1, opp)
    lo, hi = np.minimum(he[:, 0], he[:, 1]), np.maximum(he[:, 0], he[:, 1])
    order = np.argsort(lo * n + hi, kind="stable")
    ek, opp = (lo * n + hi)[order], he[order, 2]
    starts = np.flatnonzero(np.concatenate([[True], ek[1:] != ek[:-1]]))
    cnt = np.diff(np.append(starts, len(ek)))
    opp1 = np.where(cnt > 1, opp[np.minimum(starts + 1, len(ek) - 1)], -1)
    edges = np.stack([lo[order][starts], hi[order][starts], opp[starts], opp1], 1)
    edges = edges.astype(np.int32).reshape(-1, 4)

    lam = youngs * poisson / ((1 + poisson) * (1 - 2 * poisson))
    mu = youngs / (2 * (1 + poisson))
    return TetMesh(positions=pos, tets=tets, faces=faces, edges=edges,
                   mass=mass, dt=dt, lam=lam, mu=mu, dims=(nx, ny, nz))


def _edge_matrix(x: torch.Tensor) -> torch.Tensor:
    """[T,4,3] element vertices -> [T,3,3] with the edge vectors as COLUMNS."""
    return torch.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]], dim=2)


def _shape_grads(rest: torch.Tensor, tets: torch.Tensor):
    """Per-element shape gradients g [T,4,3], volumes [T], Dm^-1 [T,3,3].

    dm's columns are the edge vectors, so the barycentric map is
    xi = dm^-1 (X - x0) and grad N_i is the i-th ROW of dm^-1."""
    dm = _edge_matrix(rest[tets.long()])
    vol = torch.abs(torch.linalg.det(dm)) / 6.0
    dminv = torch.linalg.inv(dm)
    g0 = -torch.sum(dminv, dim=1, keepdim=True)
    return torch.cat([g0, dminv], dim=1), vol, dminv


def element_blocks(positions: torch.Tensor, tets: torch.Tensor, lam: float, mu: float
                   ) -> torch.Tensor:
    """Per-tet 4x4 grid of 3x3 stiffness blocks. [T,4,4,3,3]."""
    g, vol, _ = _shape_grads(positions, tets)
    outer_ab = torch.einsum("tai,tbj->tabij", g, g)              # g_a g_b^T
    outer_ba = outer_ab.transpose(-1, -2)                        # g_b g_a^T
    dots = torch.einsum("tai,tbi->tab", g, g)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    ke = lam * outer_ab + mu * outer_ba + mu * dots[..., None, None] * eye
    return vol[:, None, None, None, None] * ke


def ell_structure_from_tets(n: int, tets: np.ndarray):
    """Host integer setup for device-resident tet assembly.

    Several tets contribute to the same (row, col) block, so each ELL slot
    gets a padded contributor list:
      off_src  i32[N,K,C]: tet*16 + a_loc*4 + b_loc  (T*16 = padding)
      diag_src i32[N,D]:   tet*16 + a_loc*5          (self pairs)
    Device assembly is then gather + sum, no scatter.
    """
    from .. import native

    t_count = len(tets)
    idx, mask = native.elements_to_adjacency_ell(n, tets)
    k = idx.shape[1]

    # directed off-diagonal contributions (a != b): slot of b in row a
    al, bl = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    sel = al != bl
    al, bl = al[sel], bl[sel]                       # 12 pairs
    rows = tets[:, al].reshape(-1).astype(np.int64)  # [T*12]
    cols = tets[:, bl].reshape(-1).astype(np.int64)
    src = (np.repeat(np.arange(t_count, dtype=np.int64) * 16, 12)
           + np.tile(al * 4 + bl, t_count))
    keys = np.where(mask, np.arange(n, dtype=np.int64)[:, None] * (n + 1) + idx,
                    np.arange(n, dtype=np.int64)[:, None] * (n + 1) + n).reshape(-1)
    pos = np.searchsorted(keys, rows * (n + 1) + cols)
    slot = pos - rows * k
    if not (np.all(slot >= 0) and np.all(slot < k)):
        raise ValueError("tet edges missing from the adjacency table")
    flat = rows * k + slot                           # target slot per contribution
    order = np.argsort(flat, kind="stable")
    flat_s, src_s = flat[order], src[order]
    first = np.flatnonzero(np.concatenate([[True], flat_s[1:] != flat_s[:-1]]))
    counts = np.diff(np.append(first, len(flat_s)))
    c_max = int(counts.max()) if len(counts) else 1
    rank = np.arange(len(flat_s)) - np.repeat(first, counts)
    off_src = np.full((n * k, c_max), t_count * 16, np.int64)
    off_src[flat_s, rank] = src_s
    off_src = off_src.reshape(n, k, c_max).astype(np.int32)

    # diagonal contributions: tets containing each vertex
    drows = tets.reshape(-1).astype(np.int64)        # [T*4]
    dsrc = (np.repeat(np.arange(t_count, dtype=np.int64) * 16, 4)
            + np.tile(np.arange(4) * 5, t_count))
    dorder = np.argsort(drows, kind="stable")
    drows_s, dsrc_s = drows[dorder], dsrc[dorder]
    dfirst = np.flatnonzero(np.concatenate([[True], drows_s[1:] != drows_s[:-1]]))
    dcounts = np.diff(np.append(dfirst, len(drows_s)))
    d_max = int(dcounts.max()) if len(dcounts) else 1
    drank = np.arange(len(drows_s)) - np.repeat(dfirst, dcounts)
    diag_src = np.full((n, d_max), t_count * 16, np.int64)
    diag_src[drows_s, drank] = dsrc_s
    return idx, mask, off_src, diag_src.astype(np.int32)


def fill_ell_from_ke(idx, mask, off_src, diag_src, ke, mass_over_dt2) -> BlockEll:
    """Device assembly from per-element blocks [T,4,4,3,3]: the ELL via
    contributor gathers and sums (no scatter)."""
    ke_flat = torch.cat([ke.reshape(-1, 3, 3), ke.new_zeros((1, 3, 3))])
    pad = ke_flat.shape[0] - 1
    blocks = torch.sum(ke_flat[torch.clamp(off_src.long(), max=pad)], dim=2)   # [N,K,3,3]
    eye = torch.eye(3, dtype=ke.dtype, device=ke.device)
    diag = mass_over_dt2 * eye[None] + torch.sum(ke_flat[torch.clamp(diag_src.long(), max=pad)],
                                                 dim=1)
    return BlockEll(diag=diag, idx=idx, blocks=blocks, mask=mask)


def fill_ell_tets(idx, mask, off_src, diag_src, positions, tets, lam, mu,
                  mass_over_dt2) -> BlockEll:
    """Linear-elastic device assembly (constant K, evaluated at `positions`)."""
    ke = element_blocks(positions, tets, lam, mu)            # [T,4,4,3,3]
    return fill_ell_from_ke(idx, mask, off_src, diag_src, ke, mass_over_dt2)


def corot_rotations(x: torch.Tensor, rest: torch.Tensor, tets: torch.Tensor) -> torch.Tensor:
    """Per-element polar rotations R of the deformation gradient. [T,3,3].

    F = Ds(x) Dm(rest)^-1; R from the SVD polar decomposition with the
    reflection fix (det R = +1 even for inverted elements)."""
    t = tets.long()
    f = _edge_matrix(x[t]) @ torch.linalg.inv(_edge_matrix(rest[t]))   # [T,3,3]
    u, _, vt = torch.linalg.svd(f)
    det = torch.linalg.det(u @ vt)
    ell = torch.eye(3, dtype=f.dtype, device=f.device).repeat(f.shape[0], 1, 1)
    ell[:, 2, 2] = det                                                 # reflection fix
    return u @ ell @ vt


def element_blocks_corot(ke0: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Warped-stiffness element blocks: ke'_ab = R ke0_ab R^T. [T,4,4,3,3].

    Rotating the rest-state stiffness by the element's rotation keeps the
    blocks SPD, so H = M/dt^2 + sum_e R_e K_e R_e^T stays a valid CG system
    at arbitrary rotations."""
    return torch.einsum("tij,tabjk,tlk->tabil", r, ke0, r)


def _det3(f: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors (differentiable in every AD mode)."""
    return (f[..., 0, 0] * (f[..., 1, 1] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 1])
            - f[..., 0, 1] * (f[..., 1, 0] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 0])
            + f[..., 0, 2] * (f[..., 1, 0] * f[..., 2, 1] - f[..., 1, 1] * f[..., 2, 0]))


def _snh_psi(f: torch.Tensor, lam: float, mu: float) -> torch.Tensor:
    """Stable Neo-Hookean energy density (Smith, de Goes & Kim 2018), per [...,3,3]:

        psi = mu/2 (I_C - 3) + lam/2 (J - alpha)^2,  alpha = 1 + mu/lam

    finite (and meaningful) through inversion."""
    alpha = 1.0 + mu / lam
    ic = torch.sum(f * f, dim=(-2, -1))
    return 0.5 * mu * (ic - 3.0) + 0.5 * lam * (_det3(f) - alpha) ** 2


def snh_forces(x: torch.Tensor, rest: torch.Tensor, tets: torch.Tensor, lam: float, mu: float
               ) -> torch.Tensor:
    """Exact stable-Neo-Hookean internal forces f = -dE/dx. -> f32[N,3]."""
    _, vol, dminv = _shape_grads(rest, tets)
    t = tets.long()

    def energy(xx):
        return torch.sum(vol * _snh_psi(_edge_matrix(xx[t]) @ dminv, lam, mu))

    return -torch.func.grad(energy)(x)


def snh_element_blocks(x: torch.Tensor, rest: torch.Tensor, tets: torch.Tensor, lam: float,
                       mu: float, eig_floor: float = 0.0) -> torch.Tensor:
    """SPD-projected stable-Neo-Hookean element Hessians. [T,4,4,3,3].

    The exact 9x9 energy-density Hessian d2psi/dF2 (torch.func.hessian,
    vmapped over elements) is indefinite under compression; each element's
    is eigen-projected to PSD (eigenvalues clamped at `eig_floor`). Element
    blocks are ke_ab = vol * g_a^T H9 g_b contracted over the F indices."""
    g, vol, dminv = _shape_grads(rest, tets)
    f = _edge_matrix(x[tets.long()]) @ dminv                      # [T,3,3]
    h9 = torch.func.vmap(torch.func.hessian(lambda ff: _snh_psi(ff, lam, mu)))(f)
    h9 = h9.reshape(-1, 9, 9)
    h9 = 0.5 * (h9 + h9.transpose(1, 2))
    w, v = torch.linalg.eigh(h9)
    h9 = torch.einsum("tik,tk,tjk->tij", v, torch.clamp(w, min=eig_floor), v)
    h9 = h9.reshape(-1, 3, 3, 3, 3)                               # [T,i,J,k,L]
    ke = torch.einsum("taJ,tiJkL,tbL->tabik", g, h9, g)
    return vol[:, None, None, None, None] * ke


def corot_forces(ke0: torch.Tensor, r: torch.Tensor, x: torch.Tensor, rest: torch.Tensor,
                 tets: torch.Tensor) -> torch.Tensor:
    """Corotational internal forces f_a = -sum_b R ke0_ab (R^T x_b - x0_b),
    placed per vertex. -> f32[N,3]. Exact zero on rigid motions."""
    t = tets.long()
    dloc = torch.einsum("tji,tbj->tbi", r, x[t]) - rest[t]      # R^T x_b - x0_b
    fe = -torch.einsum("tij,tabjk,tbk->tai", r, ke0, dloc)      # [T,4,3]
    out = x.new_zeros((x.shape[0], 3))
    accumulate_rows(out, t.reshape(-1), fe.reshape(-1, 3))
    return out


def assemble_system(mesh: TetMesh, positions: np.ndarray | None = None,
                    device=None) -> BlockEll:
    """H = (m/dt^2) I + K as BlockEll. Structure on the host (integers only),
    values on `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    n = mesh.num_verts
    idx, mask, off_src, diag_src = ell_structure_from_tets(n, mesh.tets)
    pos = mesh.positions if positions is None else positions

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    return fill_ell_tets(t(idx), t(mask), t(off_src), t(diag_src), t(np.asarray(pos, np.float32)),
                         t(mesh.tets), mesh.lam, mesh.mu, mesh.mass / mesh.dt**2)


def adjacency_lists(mesh: TetMesh) -> list[np.ndarray]:
    """Per-vertex sorted neighbour lists of the tet graph."""
    adj = [set() for _ in range(mesh.num_verts)]
    for t in mesh.tets:
        for a in range(4):
            for b in range(4):
                if a != b:
                    adj[int(t[a])].add(int(t[b]))
    return [np.asarray(sorted(s), np.int32) for s in adj]
