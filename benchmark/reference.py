"""Plain reference of one implicit mass-spring cloth frame and of the
multilevel additive Schwarz preconditioner it is solved with.

NumPy, SciPy and plain PyTorch in float64; it imports nothing of the
program. From the mesh arrays, the pinned set and a frame's positions it
works out again what the program derives:

  * the implicit-Euler system H = (m/dt^2) I + sum_s k_s d_s d_s^T (Gauss-
    Newton spring blocks), pinned vertices decoupled (their rows and
    columns dropped, the mass block kept on their diagonal);
  * the right-hand side b = (m/dt) v + m g + f_springs (+ f_contact),
    zero on pinned rows, the springs' rest lengths from the rest positions
    the simulator was built with;
  * with contact (contact.py), the contact Hessian with pinned vertices'
    weights zeroed in H and, through D_l below, in every level's banks;
  * the preconditioner M^-1 = sum_l c_l R_l^T D_l^-1 R_l over levels
    l < min(L, max_applied_levels): R_l sums vertices into their level-l
    node, D_l is the Galerkin matrix R_l H R_l^T kept on the diagonal
    blocks of 32 consecutive nodes (a bank; empty lanes are identity),
    c_0 = 1 and c_l = coarse_damping above. Level-0 nodes are the vertices
    in the configuration's order (the 8x4-tile order of a power-of-two
    grid, or the Morton order of the positions of the last re-sort); a
    level-(l+1) node is a connected component of level-l nodes joined by
    springs inside one bank, numbered in the order of its smallest node.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import contact as contact_mod

BANK = 32
F64 = torch.float64


# ---- orders ------------------------------------------------------------------

def tile_order(side: int) -> np.ndarray:
    """sorted -> original map of a 2^k x 2^k grid: 8x4 tiles (lanes row-major
    in a tile), tiles ranked by interleaving the tile row with the high bits
    of the tile column, the column's lowest bit kept as the least bit."""
    k = side.bit_length() - 1
    if side != 1 << k or side < 8:
        raise ValueError(f"tile order needs a power-of-two side >= 8, got {side}")
    nti, ntj = side // 8, side // 4
    ti, tj = np.meshgrid(np.arange(nti), np.arange(ntj), indexing="ij")

    def spread(v):
        out = np.zeros_like(v, dtype=np.int64)
        for t in range(k):
            out |= ((v >> t) & 1) << (2 * t)
        return out

    rank = (((2 * spread(ti) + spread(tj >> 1)) << 1) | (tj & 1)).reshape(-1)
    tile_of_rank = np.empty_like(rank)
    tile_of_rank[rank] = np.arange(rank.size)
    ti, tj = tile_of_rank // ntj, tile_of_rank % ntj
    wi, wj = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    i = ti[:, None, None] * 8 + wi[None]
    j = tj[:, None, None] * 4 + wj[None]
    return (i * side + j).reshape(-1)


def morton_order(positions: np.ndarray, normalization: str = "isotropic") -> np.ndarray:
    """sorted -> original map: stable sort by 63-bit Morton keys of the
    positions normalised into the unit cube in float32 (by the largest
    extent, or per axis), 21 bits an axis, interleaved x, y, z."""
    p = np.asarray(positions, np.float32)
    lower, upper = p.min(axis=0), p.max(axis=0)
    if normalization == "isotropic":
        ext = (upper - lower).max()
        unit = (p - lower) / (ext if ext > 0 else np.float32(1.0))
    else:
        e = upper - lower
        unit = (p - lower) / np.where(e > 0, e, np.float32(1.0))
    scale = np.float32(1 << 21)
    q = np.clip(unit * scale, np.float32(0.0), scale - np.float32(1.0)).astype(np.int64)
    key = np.zeros(len(p), np.int64)
    for bit in range(21):
        for axis, shift in ((0, 2), (1, 1), (2, 0)):
            key |= ((q[:, axis] >> bit) & 1) << (3 * bit + shift)
    return np.argsort(key, kind="stable")


# ---- hierarchy ---------------------------------------------------------------

def num_levels(n: int, bank: int = BANK, coarsen: int = 32) -> int:
    levels, size = 1, math.ceil(max(n, 1) / bank) * bank
    while size > bank:
        size = math.ceil((size // coarsen) / bank) * bank
        levels += 1
    return levels


class Hierarchy(NamedTuple):
    nodes: list   # per level: i64[N] node of each vertex (torch, on the device)
    sizes: list   # per level: node count


def hierarchy(order: np.ndarray, springs: np.ndarray, levels: int, device) -> Hierarchy:
    """Level-l node of every vertex, from the level-0 order and the springs."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(order)
    cur = np.empty(n, np.int64)
    cur[order] = np.arange(n)
    a, b = springs[:, 0].astype(np.int64), springs[:, 1].astype(np.int64)
    nodes, sizes = [cur], [n]
    for _ in range(1, levels):
        size = sizes[-1]
        na, nb = cur[a], cur[b]
        keep = (na // BANK == nb // BANK) & (na != nb)
        g = coo_matrix((np.ones(int(keep.sum()), np.int8), (na[keep], nb[keep])), shape=(size, size))
        count, label = connected_components(g, directed=False)
        leader = np.full(count, size, np.int64)
        np.minimum.at(leader, label, np.arange(size))
        rank = np.empty(count, np.int64)
        rank[np.argsort(leader, kind="stable")] = np.arange(count)
        cur = rank[label][cur]
        nodes.append(cur)
        sizes.append(count)
    return Hierarchy([torch.as_tensor(v, device=device) for v in nodes], sizes)


# ---- system ------------------------------------------------------------------

class System(NamedTuple):
    a: torch.Tensor        # i64[S] spring ends
    b: torch.Tensor
    coupled: torch.Tensor  # bool[S]: neither end pinned
    k_blocks: torch.Tensor  # f64[S,3,3]
    diag: torch.Tensor     # f64[N,3,3]
    contact: object = None  # contact.Stencils with pinned weights zeroed, or None
    stiffness: float = 0.0  # of the contacts


def spring_blocks(x: torch.Tensor, a, b, k) -> torch.Tensor:
    d = x[b] - x[a]
    dn = d / torch.linalg.norm(d, dim=1, keepdim=True)
    return k[:, None, None] * dn[:, :, None] * dn[:, None, :]


def system(x32: torch.Tensor, mesh: dict, pinned: torch.Tensor, device, contact=None,
           stiffness: float = 0.0) -> System:
    x = x32.to(device, F64)
    springs = torch.as_tensor(mesh["springs"], device=device).long()
    a, b = springs[:, 0], springs[:, 1]
    k = torch.as_tensor(mesh["stiffness"], device=device).to(F64)
    kb = spring_blocks(x, a, b, k)
    n = x.shape[0]
    m_dt2 = float(mesh["mass"]) / float(mesh["dt"]) ** 2
    diag = torch.zeros((n, 3, 3), dtype=F64, device=device)
    diag.index_add_(0, a, kb)
    diag.index_add_(0, b, kb)
    diag[pinned] = 0.0
    diag += m_dt2 * torch.eye(3, dtype=F64, device=device)
    if contact is not None:
        contact = contact_mod.eliminate(contact, pinned)
    return System(a, b, ~(pinned[a] | pinned[b]), kb, diag, contact, stiffness)


def matvec(s: System, v: torch.Tensor) -> torch.Tensor:
    """H v, v f64[N,3]."""
    y = torch.einsum("nij,nj->ni", s.diag, v)
    kb = s.k_blocks * s.coupled[:, None, None]
    y.index_add_(0, s.a, -torch.einsum("sij,sj->si", kb, v[s.b]))
    y.index_add_(0, s.b, -torch.einsum("sij,sj->si", kb, v[s.a]))
    if s.contact is not None:
        y += contact_mod.matvec(s.contact, s.stiffness, v)
    return y


def rhs(x32: torch.Tensor, v: torch.Tensor, mesh: dict, pinned: torch.Tensor,
        gravity, device, rest=None, forces=None) -> torch.Tensor:
    """(m/dt) v + m g + spring forces (+ `forces`), zero on pinned rows.
    f64[N,3]. The springs' rest lengths come from `rest` (the mesh's own
    positions by default)."""
    x = x32.to(device, F64)
    rest = torch.as_tensor(mesh["positions"] if rest is None else rest, device=device).to(F64)
    springs = torch.as_tensor(mesh["springs"], device=device).long()
    a, b = springs[:, 0], springs[:, 1]
    k = torch.as_tensor(mesh["stiffness"], device=device).to(F64)
    d = x[b] - x[a]
    length = torch.linalg.norm(d, dim=1, keepdim=True)
    rest_len = torch.linalg.norm(rest[b] - rest[a], dim=1, keepdim=True)
    f = k[:, None] * (length - rest_len) * d / length
    out = torch.zeros_like(x)
    out.index_add_(0, a, f)
    out.index_add_(0, b, -f)
    m, dt = float(mesh["mass"]), float(mesh["dt"])
    out += (m / dt) * v.to(device, F64) + m * torch.as_tensor(gravity, dtype=F64, device=device)
    if forces is not None:
        out += forces
    out[pinned] = 0.0
    return out


# ---- preconditioner ------------------------------------------------------------

def _bank_solver(s: System, node: torch.Tensor, size: int):
    """Cholesky factors of the level's bank blocks D = R H R^T (diagonal
    blocks of 32 nodes), as f64[B,96,96]."""
    dev = node.device
    banks = max(1, math.ceil(size / BANK))
    flat = torch.zeros(banks * 96 * 96, dtype=F64, device=dev)
    ij = torch.arange(3, device=dev)
    ii, jj = ij[:, None], ij[None, :]

    def place(p, q, blocks):
        """flat[bank(p)][3 lane(p) + i][3 lane(q) + j] += blocks[:, i, j]"""
        idx = (p // BANK * 9216)[:, None, None] + (3 * (p % BANK))[:, None, None] * 96 \
            + ii * 96 + (3 * (q % BANK))[:, None, None] + jj
        flat.index_add_(0, idx.reshape(-1), blocks.reshape(-1))

    place(node, node, s.diag)
    pa, pb = node[s.a], node[s.b]
    same = (pa // BANK == pb // BANK) & s.coupled
    neg = -s.k_blocks[same]
    place(pa[same], pb[same], neg)
    place(pb[same], pa[same], neg)
    if s.contact is not None:
        for p, q, mat in contact_mod.blocks(s.contact, s.stiffness):
            np_, nq = node[p], node[q]
            same = np_ // BANK == nq // BANK
            place(np_[same], nq[same], mat[same])
    d = flat.reshape(banks, 96, 96)
    empty = torch.arange(banks * BANK, device=dev) >= size
    lanes = torch.nonzero(empty).reshape(-1)
    for c in range(3):
        d[lanes // BANK, 3 * (lanes % BANK) + c, 3 * (lanes % BANK) + c] = 1.0
    return torch.linalg.cholesky(d), banks


class Preconditioner:
    """M^-1 of one frame's system: factors of every applied level."""

    def __init__(self, s: System, hier: Hierarchy, applied: int, damping: float):
        self.hier = hier
        self.levels = []
        for l in range(applied):
            chol, banks = _bank_solver(s, hier.nodes[l], hier.sizes[l])
            self.levels.append((chol, banks, 1.0 if l == 0 else damping))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        z = torch.zeros_like(r)
        for (chol, banks, c), node in zip(self.levels, self.hier.nodes):
            rl = torch.zeros((banks * BANK, 3), dtype=F64, device=r.device)
            rl.index_add_(0, node, r)
            zl = torch.cholesky_solve(rl.reshape(banks, 96, 1), chol).reshape(banks * BANK, 3)
            z += c * zl[node]
        return z
