"""Axis-aligned bounding box of a point set (port of ``precond_tpu/utils/aabb.py``).

The reference grows an AABB serially over all positions
(SeSchwarzPreconditioner.cpp:193-211); here it is a min/max reduction. The
box predicates (SeAabb.h:109-178) are vectorized over leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Aabb(NamedTuple):
    lower: torch.Tensor  # f32[3]
    upper: torch.Tensor  # f32[3]

    @property
    def extent(self) -> torch.Tensor:
        # Zero-extent axes are padded so the unit-cube normalization below
        # never divides by zero (flat/degenerate meshes).
        e = self.upper - self.lower
        return torch.where(e > 0, e, torch.ones_like(e))


def compute_aabb(positions: torch.Tensor) -> Aabb:
    """[N,3] -> Aabb."""
    return Aabb(lower=positions.amin(dim=0), upper=positions.amax(dim=0))


def to_unit_cube(positions: torch.Tensor, aabb: Aabb) -> torch.Tensor:
    """Normalize positions into [0,1]^3 (reference FillSortingData, cpp:219-235)."""
    return (positions - aabb.lower) / aabb.extent


# ---- predicates (reference SeAabb.h:109-178, vectorized over leading dims)


def grow(aabb: Aabb, points: torch.Tensor) -> Aabb:
    """Enlarge to cover additional points ([...,3]); SeAabb.h:64-82."""
    pts = points.reshape(-1, 3)
    return Aabb(lower=torch.minimum(aabb.lower, pts.amin(dim=0)),
                upper=torch.maximum(aabb.upper, pts.amax(dim=0)))


def contains(aabb: Aabb, p: torch.Tensor, radius: float = 0.0) -> torch.Tensor:
    """Point-in-box test, optionally with the box enlarged by `radius`.

    The reference's radius variant (SeAabb.h:124-129) passes the enlarged
    box where a point belongs; the JAX package implements the intended test,
    and so does this. p is [...,3]; returns bool[...]."""
    lo = aabb.lower - radius
    hi = aabb.upper + radius
    return torch.all((p >= lo) & (p <= hi), dim=-1)


def overlaps(a: Aabb, b: Aabb) -> torch.Tensor:
    """Box-box overlap (the reference stubs IsOverlap to false, SeAabb.h:182)."""
    return torch.all((a.lower <= b.upper) & (b.lower <= a.upper), dim=-1)


def segment_intersects(aabb: Aabb, pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Segment-box slab test (reference IsIntersect, SeAabb.h:157-178).

    pa, pb are [...,3] segment endpoints; returns bool[...]. The reference's
    conventions: zero direction components become 1e-6, the parameter range
    is clipped to [0, 1], and the inequality is strict."""
    d = pb - pa
    d = torch.where(d == 0.0, torch.full_like(d, 1e-6), d)
    inv = 1.0 / d
    left = (aabb.lower - pa) * inv
    right = (aabb.upper - pa) * inv
    lo = torch.clamp(torch.minimum(left, right).amax(dim=-1), min=0.0)
    hi = torch.clamp(torch.maximum(left, right).amin(dim=-1), max=1.0)
    return lo < hi
