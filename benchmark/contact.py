"""Plain float64 reference of a frame's self-contact.

Plain PyTorch in float64 on the device it is given; it imports nothing of
the program. From a frame's positions, the mesh's faces and edges and the
cell's contact settings it finds the contact set itself and builds the
terms a contact adds to the frame's system:

  * the set: vertex-face (VF) pairs of a vertex and a face without it,
    edge-edge (EE) pairs of edges i < j that share no vertex, and
    edge-face (EF) pairs of an edge's midpoint and a face that shares no
    vertex with the edge, each nearer than the threshold by the exact
    closest points; each vertex (VF) or edge (EE, EF) keeps the nearest
    `per_primitive_cap` of its pairs. Candidates come from a cell list of
    this module's own (every primitive whose bounding sphere can come
    within the threshold; no cap on a cell);
  * a stencil a pair, with the layout, weights and direction the
    program's stencils document (ops/stencils.py), but for the EE weights
    (below): VF (f0, f1, f2, v) with (-u, -v, -w, 1) for the closest
    point's barycentrics (u, v, w); EE (a0, a1, b0, b1) with
    (1 - s, s, -(1 - t), -t), the barycentrics of the closest points
    a0 + s (a1 - a0) and b0 + t (b1 - b0); EF (e0, e1, f0, f1, f2) with
    (1/2, 1/2, -u, -v, -w); the direction is the unit vector from the
    second primitive's closest point to the first's. Each weight times the
    direction is the gradient of the pair's distance by that vertex;
  * the penalty forces of the energy 1/2 k max(rest_gap - g, 0)^2 with
    g = d . sum_i w_i x_i, f_i = k max(rest_gap - g, 0) w_i d, with every
    weight (pinned vertices' too);
  * the Hessian sum_s k (w w^T) (x) (d d^T) with pinned vertices' weights
    zeroed, for H and for the Galerkin bank blocks of every level.

Departures from the program, on purpose: no global budget (the program
keeps the nearest `budget` pairs of each set and counts the rest; the
harness fails a frame that dropped any) and no cap on a broad-phase cell
(the program's flag for a full cell fails the frame likewise); among pairs
of one primitive at equal distance the lower candidate id is kept first
(the program keeps its hash grid's candidate order), which matters only
where a primitive has more pairs than its cap (reported as `capped`).

Departure of the program from these weights: its EE stencils
(ops/stencils.py, after cpp:356-380, where an EeSet's bary is the weight
of each edge's first vertex) take its detection's segment parameters (s, t)
as those weights, (s, 1 - s, -t, -(1 - t)): the closest points mirrored
along each edge. The comparison reads that as a fault of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F64 = torch.float64
I64 = torch.int64
# query primitives a chunk of the broad phase, and its candidate pairs at a time
CHUNK = 65536
PAIRS = 1 << 23
# offsets of the 27 cells around a cell
_OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]


class Stencils(NamedTuple):
    idx: torch.Tensor     # i64[S,5] vertex ids (unused slots 0, weight 0)
    w: torch.Tensor       # f64[S,5] weights
    d: torch.Tensor       # f64[S,3] unit directions
    dist: torch.Tensor    # f64[S] closest-point distance
    kind: torch.Tensor    # i64[S]: 0 EF, 1 EE, 2 VF


KINDS = ("EF", "EE", "VF")


# ---- closest points ---------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _point_segment(p, a, b):
    """Parameter t in [0, 1] of the point of segment ab nearest p."""
    ab = b - a
    den = _dot(ab, ab)
    t = _dot(p - a, ab) / torch.where(den > 0, den, torch.ones_like(den))
    return t.clamp(0.0, 1.0)


def point_triangle(p, a, b, c):
    """Barycentrics (u, v, w) of the point of triangle abc nearest p:
    the projection onto the plane where it falls inside, else the nearest
    point of the three edges."""
    e0, e1, q = b - a, c - a, p - a
    d00, d01, d11 = _dot(e0, e0), _dot(e0, e1), _dot(e1, e1)
    d20, d21 = _dot(q, e0), _dot(q, e1)
    den = d00 * d11 - d01 * d01
    safe = torch.where(den > 0, den, torch.ones_like(den))
    v = (d11 * d20 - d01 * d21) / safe
    w = (d00 * d21 - d01 * d20) / safe
    u = 1.0 - v - w
    inside = (den > 0) & (u >= 0) & (v >= 0) & (w >= 0)
    zero = torch.zeros_like(u)
    cands = []
    for (s, e, slot_s, slot_e) in ((a, b, 0, 1), (b, c, 1, 2), (a, c, 0, 2)):
        t = _point_segment(p, s, e)
        bary = [zero, zero, zero]
        bary[slot_s], bary[slot_e] = 1.0 - t, t
        cands.append(torch.stack(bary, -1))
    bary = cands[0]
    best = _dot(p - _at(bary, a, b, c), p - _at(bary, a, b, c))
    for cand in cands[1:]:
        dd = _dot(p - _at(cand, a, b, c), p - _at(cand, a, b, c))
        better = dd < best
        bary = torch.where(better[..., None], cand, bary)
        best = torch.where(better, dd, best)
    return torch.where(inside[..., None], torch.stack([u, v, w], -1), bary)


def _at(bary, a, b, c):
    return bary[..., 0:1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c


def segment_segment(a0, a1, b0, b1):
    """(s, t) of the nearest points a0 + s (a1 - a0) and b0 + t (b1 - b0):
    the stationary point where it lies inside the unit square, else the
    best of the four sides (each side the other parameter's clamped best)."""
    da, db, r = a1 - a0, b1 - b0, a0 - b0
    aa, bb, ab = _dot(da, da), _dot(db, db), _dot(da, db)
    ar, br = _dot(da, r), _dot(db, r)
    den = aa * bb - ab * ab
    safe = torch.where(den > 0, den, torch.ones_like(den))
    s_in = (ab * br - bb * ar) / safe
    t_in = (aa * br - ab * ar) / safe
    inside = (den > 1e-14 * aa * bb) & (s_in >= 0) & (s_in <= 1) & (t_in >= 0) & (t_in <= 1)

    def gap2(s, t):
        g = r + s[..., None] * da - t[..., None] * db
        return _dot(g, g)

    one = torch.ones_like(aa)
    sides = []
    for s in (torch.zeros_like(aa), one):
        sides.append((s, _point_segment(a0 + s[..., None] * da, b0, b1)))
    for t in (torch.zeros_like(aa), one):
        sides.append((_point_segment(b0 + t[..., None] * db, a0, a1), t))
    s, t = sides[0]
    best = gap2(s, t)
    for s2, t2 in sides[1:]:
        g2 = gap2(s2, t2)
        better = g2 < best
        s, t = torch.where(better, s2, s), torch.where(better, t2, t)
        best = torch.where(better, g2, best)
    return torch.where(inside, s_in, s), torch.where(inside, t_in, t)


# ---- broad phase -------------------------------------------------------------

def _quantile(r, share):
    return float(r.sort().values[int(share * (r.shape[0] - 1))]) if r.shape[0] else 0.0


def _cell_candidates(q, rq, p, rp, reach):
    """Yields (qi, pi) index pairs, in chunks, of every query point q[qi]
    and primitive point p[pi] with |q - p| <= rq + rp + reach (every pair
    whose primitives can come within `reach`). Primitives up to twice the
    99.9th percentile of their side's radii go into a cell list whose cells
    span the largest such distance among them; the rare larger ones (a
    stretched triangle) are paired with every primitive of the other side
    directly."""
    big_q, big_p = rq > 2 * _quantile(rq, 0.999), rp > 2 * _quantile(rp, 0.999)
    dev = q.device

    def within(qi, pi):
        near = (q[qi] - p[pi]).norm(dim=-1) <= (rq[qi] + rp[pi] + reach) * (1 + 1e-9)
        return qi[near], pi[near]

    small = torch.nonzero(~big_p).reshape(-1)
    size = float(rq[~big_q].max() + rp[~big_p].max()) + reach
    lo = torch.minimum(q.amin(0), p.amin(0))
    dims = ((torch.maximum(q.amax(0), p.amax(0)) - lo) // size + 1).to(I64)

    def key(c):
        return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]

    pkey = key(((p[small] - lo) // size).to(I64))
    idx = torch.argsort(pkey)
    skey, order = pkey[idx], small[idx]
    off = torch.tensor(_OFFSETS, dtype=I64, device=dev)
    queries = torch.nonzero(~big_q).reshape(-1)
    for s in range(0, queries.shape[0], CHUNK):
        qs = queries[s: s + CHUNK]
        cells = ((q[qs] - lo) // size).to(I64)[:, None, :] + off[None]    # [M,27,3]
        inr = ((cells >= 0) & (cells < dims)).all(-1).reshape(-1)
        k = key(cells).reshape(-1)
        start = torch.searchsorted(skey, k)
        count = torch.where(inr, torch.searchsorted(skey, k, right=True) - start, 0)
        ends = torch.cumsum(count, 0)
        total = int(ends[-1])
        # runs of cells of up to PAIRS candidates (or one cell that holds more)
        marks = range(PAIRS, total, PAIRS)
        if total > PAIRS:
            marks = (torch.searchsorted(ends, torch.tensor(marks, device=dev)) + 1).tolist()
        bounds = sorted({0, count.shape[0], *marks})
        for a, b in zip(bounds[:-1], bounds[1:]):
            c = count[a:b]
            n = int(c.sum())
            if not n:
                continue
            slot = torch.repeat_interleave(torch.arange(a, b, device=dev), c)
            # each candidate's place in its cell's run of the sorted keys
            j = torch.arange(n, device=dev) + (ends[a] - c[0]) - (ends[slot] - count[slot])
            yield within(qs[slot // 27], order[start[slot] + j])
    # the larger primitives of either side, against every one of the other
    allp = torch.arange(p.shape[0], device=dev)
    for qi_big in torch.nonzero(big_q).reshape(-1).split(max(1, PAIRS // max(1, p.shape[0]))):
        qi, pi = (t.reshape(-1) for t in torch.meshgrid(qi_big, allp, indexing="ij"))
        yield within(qi, pi)
    smallq = torch.nonzero(~big_q).reshape(-1)
    for pi_big in torch.nonzero(big_p).reshape(-1).split(max(1, PAIRS // max(1, q.shape[0]))):
        qi, pi = (t.reshape(-1) for t in torch.meshgrid(smallq, pi_big, indexing="ij"))
        yield within(qi, pi)


# ---- the set -----------------------------------------------------------------

def _nearest(query, dist, cand, cap):
    """(mask of the pairs each query keeps: its `cap` nearest, ties to the
    lower candidate id; the number of queries that had more)."""
    o = torch.argsort(cand, stable=True)
    o = o[torch.argsort(dist[o], stable=True)]
    o = o[torch.argsort(query[o], stable=True)]
    qs = query[o]
    first = torch.ones_like(qs, dtype=torch.bool)
    first[1:] = qs[1:] != qs[:-1]
    pos = torch.arange(qs.shape[0], device=qs.device)
    rank = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    keep = torch.zeros_like(first)
    keep[o] = rank < cap
    return keep, int((rank == cap).sum())


def _radius(centre, *corners):
    return torch.stack([(c - centre).norm(dim=-1) for c in corners]).amax(0)


def _unit(g):
    n = g.norm(dim=-1, keepdim=True)
    return g / torch.where(n > 1e-12, n, torch.ones_like(n))


def _pad5(t):
    return torch.cat([t, t.new_zeros((t.shape[0], 5 - t.shape[1]))], 1) if t.shape[1] < 5 else t


def find(x, faces, edges, threshold, cap, near):
    """The frame's contact set from positions x f64[N,3].

    Returns (Stencils of the pairs nearer than `threshold`, each primitive's
    `cap` nearest; Stencils of the pairs within `near` of the threshold on
    either side; {"EF"/"EE"/"VF": pairs, "capped": primitives with more
    pairs than `cap`, "near_threshold": pairs within `near`})."""
    dev = x.device
    faces = torch.as_tensor(faces, device=dev)[:, :3].to(I64)
    edges = torch.as_tensor(edges, device=dev)[:, :2].to(I64)
    fa, fb, fc = x[faces[:, 0]], x[faces[:, 1]], x[faces[:, 2]]
    centroid = (fa + fb + fc) / 3.0
    frad = _radius(centroid, fa, fb, fc)
    ea, eb = x[edges[:, 0]], x[edges[:, 1]]
    mid = 0.5 * (ea + eb)
    erad = 0.5 * (eb - ea).norm(dim=-1)
    point = torch.zeros(max(x.shape[0], edges.shape[0]), dtype=F64, device=dev)
    reach = threshold + near

    def ef(e, f):
        ok = ~(edges[e][:, :, None] == faces[f][:, None, :]).any(-1).any(-1)
        e, f = e[ok], f[ok]
        bary = point_triangle(mid[e], fa[f], fb[f], fc[f])
        half = torch.full_like(bary[:, 0], 0.5)
        w = torch.stack([half, half, -bary[:, 0], -bary[:, 1], -bary[:, 2]], 1)
        return e, f, torch.cat([edges[e], faces[f]], 1), w, mid[e] - _at(bary, fa[f], fb[f], fc[f])

    def ee(i, j):
        ok = (j > i) & ~(edges[i][:, :, None] == edges[j][:, None, :]).any(-1).any(-1)
        i, j = i[ok], j[ok]
        s, t = segment_segment(ea[i], eb[i], ea[j], eb[j])
        g = (ea[i] + s[:, None] * (eb[i] - ea[i])) - (ea[j] + t[:, None] * (eb[j] - ea[j]))
        return i, j, torch.cat([edges[i], edges[j]], 1), \
            torch.stack([1.0 - s, s, -(1.0 - t), -t], 1), g

    def vf(v, f):
        ok = ~(faces[f] == v[:, None]).any(-1)
        v, f = v[ok], f[ok]
        bary = point_triangle(x[v], fa[f], fb[f], fc[f])
        return v, f, torch.cat([faces[f], v[:, None]], 1), \
            torch.cat([-bary, torch.ones_like(bary[:, :1])], 1), \
            x[v] - _at(bary, fa[f], fb[f], fc[f])

    kinds = {
        "EF": (ef, mid, point[:edges.shape[0]], centroid, frad),
        "EE": (ee, mid, erad, mid, erad),
        "VF": (vf, x, point[:x.shape[0]], centroid, frad),
    }
    contacts, undecided, info = [], [], {"capped": 0}
    for k, name in enumerate(KINDS):
        narrow, q, rq, p, rp = kinds[name]
        cols = []
        for qi, ci in _cell_candidates(q, rq, p, rp, reach):
            qi, ci, idx, w, g = narrow(qi, ci)
            dist = g.norm(dim=-1)
            hit = dist < reach
            cols.append((qi[hit], ci[hit], _pad5(idx[hit]), _pad5(w[hit]), _unit(g[hit]),
                         dist[hit]))
        if not cols:
            info[name] = 0
            continue
        qi, ci, idx, w, d, dist = (torch.cat(c) for c in zip(*cols))
        kind = torch.full_like(qi, k)
        inside = dist < threshold
        keep, capped = _nearest(qi[inside], dist[inside], ci[inside], cap)
        info["capped"] += capped
        contacts.append(Stencils(idx[inside][keep], w[inside][keep], d[inside][keep],
                                 dist[inside][keep], kind[inside][keep]))
        info[name] = int(keep.sum())
        amb = (dist - threshold).abs() <= near
        undecided.append(Stencils(idx[amb], w[amb], d[amb], dist[amb], kind[amb]))
    contacts, undecided = _cat(contacts, dev), _cat(undecided, dev)
    info["near_threshold"] = int(undecided.dist.shape[0])
    return contacts, undecided, info


def _cat(parts, dev):
    if not parts:
        return Stencils(torch.zeros((0, 5), dtype=I64, device=dev),
                        torch.zeros((0, 5), dtype=F64, device=dev),
                        torch.zeros((0, 3), dtype=F64, device=dev),
                        torch.zeros(0, dtype=F64, device=dev),
                        torch.zeros(0, dtype=I64, device=dev))
    return Stencils(*(torch.cat(c) for c in zip(*parts)))


# ---- forces and Hessian --------------------------------------------------------

def forces(st: Stencils, x, stiffness, rest_gap):
    """Penalty forces f64[N,3] (every weight, pinned vertices' too)."""
    g = (st.d * (st.w[:, :, None] * x[st.idx]).sum(1)).sum(-1)
    mag = stiffness * torch.clamp(rest_gap - g, min=0.0)
    out = torch.zeros_like(x)
    out.index_add_(0, st.idx.reshape(-1), ((mag[:, None] * st.w)[:, :, None]
                                           * st.d[:, None, :]).reshape(-1, 3))
    return out


def eliminate(st: Stencils, pinned) -> Stencils:
    """Pinned vertices' weights zeroed: the Hessian of the solve."""
    return st._replace(w=st.w * (~pinned[st.idx]).to(F64))


def matvec(st: Stencils, stiffness, v):
    """H_contact v, with st's weights as they are."""
    t = (st.d * (st.w[:, :, None] * v[st.idx]).sum(1)).sum(-1)
    out = torch.zeros_like(v)
    out.index_add_(0, st.idx.reshape(-1), ((stiffness * t[:, None] * st.w)[:, :, None]
                                           * st.d[:, None, :]).reshape(-1, 3))
    return out


def blocks(st: Stencils, stiffness, rows: int = 1 << 18):
    """Yields (p, q, f64[M,3,3]): the Hessian's block k w_p w_q d d^T for
    every ordered pair of slots (p, q) of every stencil, p == q included,
    in chunks of stencils."""
    a = torch.arange(5, device=st.idx.device)
    sa, sb = a.repeat_interleave(5), a.repeat(5)
    for s in range(0, st.idx.shape[0], rows):
        idx, w, d = st.idx[s: s + rows], st.w[s: s + rows], st.d[s: s + rows]
        ww = stiffness * w[:, sa] * w[:, sb]                        # [M,25]
        live = ww != 0
        ddt = d[:, :, None] * d[:, None, :]
        mat = ww[:, :, None, None] * ddt[:, None]
        yield idx[:, sa][live], idx[:, sb][live], mat[live]


def rows_touched(st: Stencils, n: int, pinned):
    """bool[N]: unpinned vertices with a nonzero weight in some stencil."""
    out = torch.zeros(n, dtype=torch.bool, device=st.idx.device)
    out[st.idx[st.w != 0]] = True
    return out & ~pinned
