"""Proximity detection: the EF/EE/VF sets the preconditioner eats (port of
``precond_tpu/models/collision.py``).

The reference excludes detection (its host simulator passes proximity sets
already found, SeSchwarzPreconditioner.cpp:67-72). This is a vectorized
broad + narrow phase: hash-grid candidates (models/hashgrid.py), exact
point-triangle / segment-segment closest points (Ericson, RTCD ch. 5), with
static candidate budgets, on the device of the positions.

Selections follow the JAX package exactly. ``jax.lax.top_k`` puts the lower
index first among equal values; ``torch.topk`` promises no tie order, so
every top-k here is a stable descending sort followed by the first k. The
geometry mirrors the JAX formulas term for term, so a near-tie resolves the
same way in both packages wherever the f32 operations agree.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.stencils import EeSets, EfSets, VfSets
from .hashgrid import build_grid, query

_NEG_INF = float("-inf")


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3) in a fixed order: (x0 + x1) + x2. Written
    out elementwise, so the CPU and the card round it the same way (a
    reduction kernel may associate differently) and a tie between
    candidates resolves the same on both."""
    ab = a * b
    return (ab[..., 0] + ab[..., 1]) + ab[..., 2]


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=-1)`` as XLA computes it: the fused
    reduction is a chain of fused multiply-adds, sqrt(fma(x2, x2, fma(x1,
    x1, x0*x0))). Each fma is formed in f64 (a product of two f32 is exact
    there) and rounded to f32, which gives the same bits on the CPU and the
    card."""
    w = v.double()
    h = (w[..., 0] * w[..., 0]).float().double()
    h = (w[..., 1] * w[..., 1] + h).float().double()
    n = torch.sqrt((w[..., 2] * w[..., 2] + h).float())
    return n[..., None] if keepdim else n


def _nz(x: torch.Tensor) -> torch.Tensor:
    """x where x != 0, else 1 (a guarded denominator)."""
    return torch.where(x != 0, x, torch.ones_like(x))


def point_triangle_closest(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest point on triangle abc to p. Returns (bary[...,3], point).

    Vectorized over leading dims; branch-free region selection.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom_in = va + vb + vc

    # interior barycentrics (guarded)
    v_in = vb / _nz(denom_in)
    w_in = vc / _nz(denom_in)

    # edge/vertex regions
    v_ab = d1 / _nz(d1 - d3)
    w_ac = d2 / _nz(d2 - d6)
    t_bc = (d4 - d3) / _nz((d4 - d3) + (d5 - d6))

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (~in_a) & (~in_b) & (~in_c) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (~in_a) & (~in_b) & (~in_c) & (~on_ab) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = ((~in_a) & (~in_b) & (~in_c) & (~on_ab) & (~on_ac) & (va <= 0)
             & (d4 - d3 >= 0) & (d5 - d6 >= 0))

    one, zero = torch.ones_like(d1), torch.zeros_like(d1)
    u = torch.where(in_a, one,
        torch.where(in_b, zero,
        torch.where(in_c, zero,
        torch.where(on_ab, 1.0 - v_ab,
        torch.where(on_ac, 1.0 - w_ac,
        torch.where(on_bc, zero, 1.0 - v_in - w_in))))))
    v = torch.where(in_a, zero,
        torch.where(in_b, one,
        torch.where(in_c, zero,
        torch.where(on_ab, v_ab,
        torch.where(on_ac, zero,
        torch.where(on_bc, 1.0 - t_bc, v_in))))))
    w = 1.0 - u - v
    bary = torch.stack([u, v, w], dim=-1)
    point = u[..., None] * a + v[..., None] * b + w[..., None] * c
    return bary, point


def segment_segment_closest(p1, q1, p2, q2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest points of segments p1q1 / p2q2: returns (s, t) parameters."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    zero = torch.zeros_like(denom)
    s = torch.clamp(torch.where(denom != 0, (b * f - c * e) / _nz(denom), zero), 0.0, 1.0)
    t = torch.where(e != 0, (b * s + f) / _nz(e), zero)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp(torch.where(e != 0, (b * t_cl - c) / _nz(a), s), 0.0, 1.0)
    return s, t_cl


class DetectInfo(NamedTuple):
    """Broad-phase health flags, the analogue of the reference's stencil
    overflow clamp + warning (cpp:312-316)."""

    truncated: torch.Tensor  # bool[]: some grid cell exceeded cell_cap
    dropped: torch.Tensor    # i32[]: true hits evicted by the global budget


def top_k(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest, ties to the
    lower index (a stable descending sort, then the first k)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _chunked(fn, queries: torch.Tensor, chunk: int):
    """Map `fn` over row-chunks of `queries` plus their global indices.

    fn((q_chunk f32[M,3], id_chunk i32[M])) -> tuple of tensors with leading
    dim M, or 0-d flags. The JAX package pads the last chunk with id -1
    rows that fn masks out; here the last chunk is simply shorter, which
    gives the same rows. Flags come back stacked, one per chunk.
    """
    nq = queries.shape[0]
    ids = torch.arange(nq, dtype=torch.int32, device=queries.device)
    if nq <= chunk:
        return fn((queries, ids))
    outs = [fn((queries[s: s + chunk], ids[s: s + chunk])) for s in range(0, nq, chunk)]
    return tuple(torch.stack(parts) if parts[0].dim() == 0 else torch.cat(parts)
                 for parts in zip(*outs))


def _compact(score: torch.Tensor, max_pairs: int, *fields):
    """Global budget: keep the `max_pairs` best-scoring rows.

    score = -distance for hits, -inf otherwise. Returns (ok, dropped,
    *fields[top]) where dropped counts true hits beyond the budget."""
    flat = score.reshape(-1)
    k = min(max_pairs, flat.shape[0])
    top_score, top = top_k(flat, k)
    if k < max_pairs:
        top_score = torch.cat([top_score, flat.new_full((max_pairs - k,), _NEG_INF)])
        top = torch.cat([top, top.new_zeros((max_pairs - k,))])
    ok = top_score > _NEG_INF
    dropped = torch.clamp((flat > _NEG_INF).sum() - max_pairs, min=0).to(torch.int32)
    return (ok, dropped) + tuple(f.reshape((-1,) + f.shape[score.dim():])[top] for f in fields)


def _safe_normal(diff: torch.Tensor) -> torch.Tensor:
    nlen = _norm(diff, keepdim=True)
    return diff / torch.where(nlen > 1e-12, nlen, torch.ones_like(nlen))


def _take_top(f: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(f, si, axis=1)`` with f's trailing dims kept."""
    idx = si.reshape(si.shape + (1,) * (f.dim() - 2)).expand(si.shape + f.shape[2:])
    return torch.gather(f, 1, idx)


def _face_radius(va, vb, vc, centroid) -> torch.Tensor:
    return torch.sqrt(torch.max(torch.maximum(
        _dot(va - centroid, va - centroid),
        torch.maximum(_dot(vb - centroid, vb - centroid), _dot(vc - centroid, vc - centroid)),
    )))


def detect_vf_grid(
    positions: torch.Tensor,
    faces: torch.Tensor,
    threshold: float,
    stiffness: float,
    max_pairs: int,
    per_vertex_cap: int = 8,
    cell_cap: int = 8,
    chunk: int = 65536,
) -> Tuple[VfSets, DetectInfo]:
    """Hash-grid vertex-face proximity with a per-vertex stencil budget.

    Broad phase: faces binned by centroid with cell size >= face radius +
    threshold (so the 27-cell query is exhaustive, models/hashgrid.py).
    Each vertex keeps at most `per_vertex_cap` nearest faces (the reference
    budgets 32 stencils/vertex, cpp:187-188), then the global `max_pairs`
    budget keeps the nearest of those.
    """
    fa = faces[:, :3].long()
    va, vb, vc = positions[fa[:, 0]], positions[fa[:, 1]], positions[fa[:, 2]]
    centroid = (va + vb + vc) / 3.0
    grid = build_grid(centroid, _face_radius(va, vb, vc, centroid) + threshold)
    kv = per_vertex_cap

    def process(args):
        q, vid = args
        cand, cvalid, trunc = query(grid, q, cell_cap)          # [M,C]
        tri = fa[cand.long()]                                   # [M,C,3]
        a, b, c = positions[tri].unbind(dim=-2)                 # one gather
        bary, qp = point_triangle_closest(q[:, None], a, b, c)
        diff = q[:, None] - qp
        dist = _norm(diff)
        own = (tri == vid.long()[:, None, None]).any(dim=-1)
        hit = (dist < threshold) & ~own & cvalid & (vid >= 0)[:, None]
        score = torch.where(hit, -dist, torch.full_like(dist, _NEG_INF))
        sc, si = top_k(score, kv)                                # [M,kv]
        return (sc, _take_top(cand, si), _take_top(bary, si)[..., :2], _take_top(diff, si),
                vid[:, None].expand(sc.shape), trunc)

    sc, fid, bary2, diff, vid, trunc = _chunked(process, positions, chunk)
    ok, dropped, sc_t, fid_t, bary_t, diff_t, vid_t = _compact(
        sc, max_pairs, sc, fid, bary2, diff, vid)
    sets = VfSets(
        v_id=torch.where(ok, vid_t, torch.full_like(vid_t, -1)),
        f_id=torch.where(ok, fid_t, torch.full_like(fid_t, -1)),
        stiff=torch.full((max_pairs,), stiffness, dtype=torch.float32, device=positions.device),
        bary=bary_t,
        normal=_safe_normal(diff_t),
    )
    return sets, DetectInfo(truncated=trunc.any(), dropped=dropped)


def detect_ee_grid(
    positions: torch.Tensor,
    edges: torch.Tensor,
    threshold: float,
    stiffness: float,
    max_pairs: int,
    per_edge_cap: int = 8,
    cell_cap: int = 8,
    chunk: int = 65536,
) -> Tuple[EeSets, DetectInfo]:
    """Hash-grid edge-edge proximity (non-adjacent pairs, i < j dedupe)."""
    e2 = edges[:, :2].long()
    p0, p1 = positions[e2[:, 0]], positions[e2[:, 1]]
    mid = 0.5 * (p0 + p1)
    half = 0.5 * torch.sqrt(torch.max(_dot(p1 - p0, p1 - p0)))
    grid = build_grid(mid, 2.0 * half + threshold)
    kv = per_edge_cap

    def process(args):
        q, eid = args
        cand, cvalid, trunc = query(grid, q, cell_cap)           # [M,C]
        ce = e2[cand.long()]                                     # [M,C,2]
        cp0, cp1 = positions[ce].unbind(dim=-2)
        my = e2[torch.clamp(eid, min=0).long()]                  # [M,2]
        mp0, mp1 = positions[my[:, 0]], positions[my[:, 1]]
        s, t = segment_segment_closest(mp0[:, None], mp1[:, None], cp0, cp1)
        c1 = mp0[:, None] + s[..., None] * (mp1 - mp0)[:, None]
        c2 = cp0 + t[..., None] * (cp1 - cp0)
        diff = c1 - c2
        dist = _norm(diff)
        shares = (ce[..., :, None] == my[:, None, None, :]).any(dim=-1).any(dim=-1)
        hit = ((dist < threshold) & ~shares & cvalid
               & (cand > eid[:, None]) & (eid >= 0)[:, None])
        score = torch.where(hit, -dist, torch.full_like(dist, _NEG_INF))
        sc, si = top_k(score, kv)
        return (sc, _take_top(cand, si), _take_top(torch.stack([s, t], dim=-1), si),
                _take_top(diff, si), eid[:, None].expand(sc.shape), trunc)

    sc, cid, st, diff, eid, trunc = _chunked(process, mid, chunk)
    ok, dropped, sc_t, cid_t, st_t, diff_t, eid_t = _compact(
        sc, max_pairs, sc, cid, st, diff, eid)
    sets = EeSets(
        e_id0=torch.where(ok, eid_t, torch.full_like(eid_t, -1)),
        e_id1=torch.where(ok, cid_t, torch.full_like(cid_t, -1)),
        stiff=torch.full((max_pairs,), stiffness, dtype=torch.float32, device=positions.device),
        bary=st_t,
        normal=_safe_normal(diff_t),
    )
    return sets, DetectInfo(truncated=trunc.any(), dropped=dropped)


def detect_ef_grid(
    positions: torch.Tensor,
    edges: torch.Tensor,
    faces: torch.Tensor,
    threshold: float,
    stiffness: float,
    max_pairs: int,
    per_edge_cap: int = 8,
    cell_cap: int = 8,
    chunk: int = 65536,
) -> Tuple[EfSets, DetectInfo]:
    """Hash-grid edge-face proximity: edge midpoints queried against the
    face-centroid grid (cell size covers face radius + edge half-length +
    threshold, so the 27-cell neighborhood is exhaustive)."""
    fa = faces[:, :3].long()
    e2 = edges[:, :2].long()
    va, vb, vc = positions[fa[:, 0]], positions[fa[:, 1]], positions[fa[:, 2]]
    centroid = (va + vb + vc) / 3.0
    fradius = _face_radius(va, vb, vc, centroid)
    p0, p1 = positions[e2[:, 0]], positions[e2[:, 1]]
    mid = 0.5 * (p0 + p1)
    ehalf = 0.5 * torch.sqrt(torch.max(_dot(p1 - p0, p1 - p0)))
    grid = build_grid(centroid, fradius + ehalf + threshold)
    kv = per_edge_cap

    def process(args):
        q, eid = args
        cand, cvalid, trunc = query(grid, q, cell_cap)           # [M,C]
        tri = fa[cand.long()]
        a, b, c = positions[tri].unbind(dim=-2)
        bary, qp = point_triangle_closest(q[:, None], a, b, c)
        diff = q[:, None] - qp
        dist = _norm(diff)
        my = e2[torch.clamp(eid, min=0).long()]
        shares = (tri[..., :, None] == my[:, None, None, :]).any(dim=-1).any(dim=-1)
        hit = (dist < threshold) & ~shares & cvalid & (eid >= 0)[:, None]
        score = torch.where(hit, -dist, torch.full_like(dist, _NEG_INF))
        sc, si = top_k(score, kv)
        return (sc, _take_top(cand, si), _take_top(bary, si)[..., :2], _take_top(diff, si),
                eid[:, None].expand(sc.shape), trunc)

    sc, fid, bary2, diff, eid, trunc = _chunked(process, mid, chunk)
    ok, dropped, sc_t, fid_t, bary_t, diff_t, eid_t = _compact(
        sc, max_pairs, sc, fid, bary2, diff, eid)
    # EfSet bary layout (SeCollisionElements.h:33-40): x on the edge (the
    # midpoint sample -> 0.5), (y,z) on the face.
    bary3 = torch.cat([bary_t.new_full((max_pairs, 1), 0.5), bary_t], dim=1)
    sets = EfSets(
        e_id=torch.where(ok, eid_t, torch.full_like(eid_t, -1)),
        f_id=torch.where(ok, fid_t, torch.full_like(fid_t, -1)),
        stiff=torch.full((max_pairs,), stiffness, dtype=torch.float32, device=positions.device),
        bary=bary3,
        normal=_safe_normal(diff_t),
    )
    return sets, DetectInfo(truncated=trunc.any(), dropped=dropped)


def _brute_sets(hit, dist, diff, max_pairs, cols):
    """Shared tail of the brute-force detectors: global top-k over the flat
    [rows, cols] hit matrix -> (ok, row ids, col ids, flat top, normals)."""
    flat = hit.reshape(-1)
    score = torch.where(flat, -dist.reshape(-1), torch.full_like(dist.reshape(-1), _NEG_INF))
    top = top_k(score, max_pairs)[1]
    ok = flat[top]
    rows = torch.div(top, cols, rounding_mode="floor").to(torch.int32)
    colids = (top % cols).to(torch.int32)
    return ok, rows, colids, top, _safe_normal(diff.reshape(-1, 3)[top])


def detect_vf(positions: torch.Tensor, faces: torch.Tensor, threshold: float,
              stiffness: float, max_pairs: int) -> VfSets:
    """Brute-force vertex-face proximity below `threshold`, excluding the
    face's own vertices ([N,F] distances: small meshes and tests only).
    Invalid rows get id -1 (the reference's negative-id convention, cpp:385)."""
    n, nf = positions.shape[0], faces.shape[0]
    fl = faces.long()
    a, b, c = positions[fl[:, 0]], positions[fl[:, 1]], positions[fl[:, 2]]
    p = positions[:, None, :]
    bary, q = point_triangle_closest(p, a[None], b[None], c[None])   # [N,F,...]
    diff = p - q
    dist = _norm(diff)
    vids = torch.arange(n, device=positions.device)[:, None]
    own = (fl[None, :, 0] == vids) | (fl[None, :, 1] == vids) | (fl[None, :, 2] == vids)
    hit = (dist < threshold) & ~own
    ok, v, f, top, normal = _brute_sets(hit, dist, diff, max_pairs, nf)
    return VfSets(
        v_id=torch.where(ok, v, torch.full_like(v, -1)),
        f_id=torch.where(ok, f, torch.full_like(f, -1)),
        stiff=torch.full((max_pairs,), stiffness, dtype=torch.float32, device=positions.device),
        bary=bary.reshape(-1, 3)[top][:, :2],
        normal=normal,
    )


def detect_ef(positions: torch.Tensor, edges: torch.Tensor, faces: torch.Tensor,
              threshold: float, stiffness: float, max_pairs: int) -> EfSets:
    """Brute-force edge-face proximity: edge midpoints near a face, excluding
    edges that share a vertex with the face. Bary layout as EfSet
    (SeCollisionElements.h:33-40): (x) along the edge, (y,z) on the face."""
    nf = faces.shape[0]
    el, fl = edges.long(), faces.long()
    mid = 0.5 * (positions[el[:, 0]] + positions[el[:, 1]])
    a, b, c = positions[fl[:, 0]], positions[fl[:, 1]], positions[fl[:, 2]]
    bary, q = point_triangle_closest(mid[:, None], a[None], b[None], c[None])   # [E,F,..]
    diff = mid[:, None] - q
    dist = _norm(diff)
    shares = torch.zeros(dist.shape, dtype=torch.bool, device=positions.device)
    for ei in range(2):
        for fi in range(3):
            shares = shares | (el[:, None, ei] == fl[None, :, fi])
    hit = (dist < threshold) & ~shares
    ok, e, f, top, normal = _brute_sets(hit, dist, diff, max_pairs, nf)
    bf = bary.reshape(-1, 3)[top]
    # (edge t = 0.5 at the midspan sample, face y,z)
    bary3 = torch.cat([bf.new_full((max_pairs, 1), 0.5), bf[:, :2]], dim=1)
    return EfSets(
        e_id=torch.where(ok, e, torch.full_like(e, -1)),
        f_id=torch.where(ok, f, torch.full_like(f, -1)),
        stiff=torch.full((max_pairs,), stiffness, dtype=torch.float32, device=positions.device),
        bary=bary3,
        normal=normal,
    )


def detect_ee(positions: torch.Tensor, edges: torch.Tensor, threshold: float,
              stiffness: float, max_pairs: int) -> EeSets:
    """Brute-force edge-edge proximity below `threshold` for non-adjacent
    edge pairs (i < j)."""
    ne = edges.shape[0]
    el = edges.long()
    p1, q1 = positions[el[:, 0]], positions[el[:, 1]]
    s, t = segment_segment_closest(p1[:, None], q1[:, None], p1[None], q1[None])
    c1 = p1[:, None] + s[..., None] * (q1 - p1)[:, None]
    c2 = p1[None] + t[..., None] * (q1 - p1)[None]
    diff = c1 - c2
    dist = _norm(diff)
    shares = ((el[:, None, 0] == el[None, :, 0]) | (el[:, None, 0] == el[None, :, 1])
              | (el[:, None, 1] == el[None, :, 0]) | (el[:, None, 1] == el[None, :, 1]))
    ar = torch.arange(ne, device=positions.device)
    hit = (dist < threshold) & ~shares & (ar[:, None] < ar[None, :])
    ok, e0, e1, top, normal = _brute_sets(hit, dist, diff, max_pairs, ne)
    return EeSets(
        e_id0=torch.where(ok, e0, torch.full_like(e0, -1)),
        e_id1=torch.where(ok, e1, torch.full_like(e1, -1)),
        stiff=torch.full((max_pairs,), stiffness, dtype=torch.float32, device=positions.device),
        bary=torch.stack([s.reshape(-1)[top], t.reshape(-1)[top]], dim=-1),
        normal=normal,
    )
