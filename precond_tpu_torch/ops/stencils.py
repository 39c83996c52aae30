"""Collision stencils: EF/EE/VF proximity sets -> unified stencils (port of
``precond_tpu/ops/stencils.py``).

Reference: SeCollisionElements.h:33-69 (the POD contract between host
collision detection and the preconditioner) and PrepareCollisionStencils
(cpp:304-413), which flattens the three set types into `Stencil`s with
signed barycentric weights:

  EF (cpp:335-353): 5 verts (2 edge + 3 face), w = (b0, 1-b0, -b1, -b2, -(1-b1-b2))
  EE (cpp:356-380): 4 verts (2 + 2),           w = (b0, 1-b0, -b1, -(1-b1))
  VF (cpp:381-405): 4 verts (3 face + vertex),  w = (-b0, -b1, -(1-b0-b1), 1)

The reference's VF branch reads `m_bary[2]` from a Float2 (cpp:399), an
out-of-bounds read; as in the JAX package the third face weight is the
physically consistent -(1-b0-b1) (the weights of each primitive sum to ±1).
The reference appends stencils with an atomic counter; here the order is
fixed (EF, EE, VF) so builds are bit-reproducible.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..utils.gather import INT32_MIN, take_fill
from .assembly import CollisionTerms
from .hierarchy import StencilPairs

MAX_STENCIL_VERTS = 5
# static (ita, itb) combos, ita < itb (cpp:534-536)
_COMBOS = [(a, b) for a in range(MAX_STENCIL_VERTS) for b in range(a + 1, MAX_STENCIL_VERTS)]


class EfSets(NamedTuple):
    """Edge-face proximity pairs (SeCollisionElements.h:33-40)."""
    e_id: torch.Tensor    # i32[M]
    f_id: torch.Tensor    # i32[M]
    stiff: torch.Tensor   # f32[M]
    bary: torch.Tensor    # f32[M,3]: (x) on edge, (y,z) on face
    normal: torch.Tensor  # f32[M,3]


class EeSets(NamedTuple):
    """Edge-edge proximity pairs (SeCollisionElements.h:51-58)."""
    e_id0: torch.Tensor
    e_id1: torch.Tensor
    stiff: torch.Tensor
    bary: torch.Tensor    # f32[M,2]
    normal: torch.Tensor


class VfSets(NamedTuple):
    """Vertex-face proximity pairs (SeCollisionElements.h:42-49)."""
    v_id: torch.Tensor
    f_id: torch.Tensor
    stiff: torch.Tensor
    bary: torch.Tensor    # f32[M,2]
    normal: torch.Tensor


class Stencils(NamedTuple):
    """Unified collision stencil array (reference Stencil, h:60-69)."""
    idx: torch.Tensor        # i32[S,5] vertex ids
    weight: torch.Tensor     # f32[S,5] signed barycentric weights
    nverts: torch.Tensor     # i32[S] in {4,5}
    nfirst: torch.Tensor     # i32[S] verts of the first primitive
    stiff: torch.Tensor      # f32[S]
    direction: torch.Tensor  # f32[S,3] repulsion direction
    valid: torch.Tensor      # bool[S]

    @property
    def count(self) -> int:
        return self.idx.shape[0]

    def to(self, device) -> "Stencils":
        return Stencils(*(t.to(device) for t in self))


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, jnp.clip(ids, 0, None), axis=0)``: ids clipped from
    below only; an id past the table reads the int32 fill."""
    return take_fill(table, torch.clamp(ids, min=0), fill=INT32_MIN)


def build_stencils(
    edges: torch.Tensor,
    faces: torch.Tensor,
    ef: Optional[EfSets] = None,
    ee: Optional[EeSets] = None,
    vf: Optional[VfSets] = None,
) -> Stencils:
    """Flatten EF/EE/VF sets into stencils (PrepareCollisionStencils).

    edges: i32[E,4] (two endpoints first, h:48); faces: i32[F,3]. Runs on the
    device of `edges`. Negative primitive ids mark invalid entries
    (cpp:330,359,385).
    """
    dev = edges.device
    parts = []

    def _part(idx, w, nv, nf, stiff, direction, valid):
        s = idx.shape[0]
        idx5 = torch.zeros((s, 5), dtype=torch.int32, device=dev)
        idx5[:, : idx.shape[1]] = idx.to(torch.int32)
        w5 = torch.zeros((s, 5), dtype=torch.float32, device=dev)
        w5[:, : w.shape[1]] = w
        parts.append(Stencils(
            idx=idx5, weight=w5,
            nverts=torch.full((s,), nv, dtype=torch.int32, device=dev),
            nfirst=torch.full((s,), nf, dtype=torch.int32, device=dev),
            stiff=stiff.to(torch.float32),
            direction=direction.to(torch.float32),
            valid=valid,
        ))

    if ef is not None and ef.e_id.shape[0]:
        ok = (ef.e_id >= 0) & (ef.f_id >= 0)
        e = _rows(edges, ef.e_id)
        f = _rows(faces, ef.f_id)
        idx = torch.cat([e[:, :2], f[:, :3]], dim=1)
        b = ef.bary
        w = torch.stack(
            [b[:, 0], 1.0 - b[:, 0], -b[:, 1], -b[:, 2], -(1.0 - b[:, 1] - b[:, 2])], dim=1
        )
        _part(idx, w, 5, 2, ef.stiff, ef.normal, ok)

    if ee is not None and ee.e_id0.shape[0]:
        ok = (ee.e_id0 >= 0) & (ee.e_id1 >= 0)
        e0 = _rows(edges, ee.e_id0)
        e1 = _rows(edges, ee.e_id1)
        idx = torch.cat([e0[:, :2], e1[:, :2]], dim=1)
        b = ee.bary
        w = torch.stack([b[:, 0], 1.0 - b[:, 0], -b[:, 1], -(1.0 - b[:, 1])], dim=1)
        _part(idx, w, 4, 2, ee.stiff, ee.normal, ok)

    if vf is not None and vf.v_id.shape[0]:
        ok = (vf.v_id >= 0) & (vf.f_id >= 0)
        f = _rows(faces, vf.f_id)
        idx = torch.cat([f[:, :3], vf.v_id[:, None].to(f.dtype)], dim=1)
        b = vf.bary
        w = torch.stack([-b[:, 0], -b[:, 1], -(1.0 - b[:, 0] - b[:, 1]), torch.ones_like(b[:, 0])],
                        dim=1)
        _part(idx, w, 4, 3, vf.stiff, vf.normal, ok)

    if not parts:
        return empty_stencils(dev)
    return Stencils(*[torch.cat(cols) for cols in zip(*parts)])


def empty_stencils(device=None) -> Stencils:
    """A set of no stencils, on the card unless `device` says otherwise
    (RuntimeError without a card, device.resolve_device)."""
    device = resolve_device(device)
    return Stencils(
        idx=torch.zeros((0, 5), dtype=torch.int32, device=device),
        weight=torch.zeros((0, 5), dtype=torch.float32, device=device),
        nverts=torch.zeros((0,), dtype=torch.int32, device=device),
        nfirst=torch.zeros((0,), dtype=torch.int32, device=device),
        stiff=torch.zeros((0,), dtype=torch.float32, device=device),
        direction=torch.zeros((0, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((0,), dtype=torch.bool, device=device),
    )


def _combo_cols(device):
    ca = torch.tensor([c for c, _ in _COMBOS], dtype=torch.int32, device=device)
    cb = torch.tensor([c for _, c in _COMBOS], dtype=torch.int32, device=device)
    return ca, cb


def map_stencils(st: Stencils, orig_to_sorted: torch.Tensor) -> Stencils:
    """Stencil vertex ids through a vertex permutation, inactive slots -> 0
    (JAX ``solver.prepare_with_system``'s `mapped`)."""
    n = orig_to_sorted.shape[0]
    act = st.valid[:, None] & (torch.arange(5, device=st.idx.device) < st.nverts[:, None])
    ids = orig_to_sorted[torch.clamp(st.idx, 0, n - 1).long()]
    return st._replace(idx=torch.where(act, ids, torch.zeros_like(ids)))


def stencil_pairs(mapped: Stencils) -> StencilPairs:
    """Cross-primitive pairs for connectivity injection (cpp:534-552)."""
    ca, cb = _combo_cols(mapped.idx.device)
    a = mapped.idx[:, ca.long()]
    b = mapped.idx[:, cb.long()]
    valid = (
        mapped.valid[:, None]
        & (ca[None] < mapped.nfirst[:, None])
        & (cb[None] >= mapped.nfirst[:, None])
        & (cb[None] < mapped.nverts[:, None])
    )
    return StencilPairs(a=a.reshape(-1), b=b.reshape(-1), valid=valid.reshape(-1))


def collision_terms(mapped: Stencils) -> CollisionTerms:
    """Rank-1 collision Hessian terms (PrepareCollisionHessian, cpp:1201-1227).

    hmat = stiff * d d^T; the diagonal gets w_i^2 * hmat per stencil vertex,
    every (unordered) vertex pair gets w_a * w_b * hmat routed to its common
    bank. Unlike connectivity injection, *all* pairs count here, not just
    cross-primitive ones (cpp:1219-1224).
    """
    d = mapped.direction
    hmat = mapped.stiff[:, None, None] * d[:, :, None] * d[:, None, :]  # [S,3,3]

    it = torch.arange(MAX_STENCIL_VERTS, device=d.device)
    diag_valid = mapped.valid[:, None] & (it[None] < mapped.nverts[:, None])
    diag_mat = (mapped.weight ** 2)[:, :, None, None] * hmat[:, None]

    ca, cb = _combo_cols(d.device)
    pair_valid = mapped.valid[:, None] & (cb[None] < mapped.nverts[:, None])
    wa = mapped.weight[:, ca.long()]
    wb = mapped.weight[:, cb.long()]
    pair_mat = (wa * wb)[:, :, None, None] * hmat[:, None]
    pa = mapped.idx[:, ca.long()]
    pb = mapped.idx[:, cb.long()]

    return CollisionTerms(
        pair_a=pa.reshape(-1),
        pair_b=pb.reshape(-1),
        pair_mat=pair_mat.reshape(-1, 3, 3),
        pair_valid=pair_valid.reshape(-1),
        diag_ids=mapped.idx.reshape(-1),
        diag_mat=diag_mat.reshape(-1, 3, 3),
        diag_valid=diag_valid.reshape(-1),
    )
