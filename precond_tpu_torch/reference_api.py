"""Drop-in reference-shaped API (port of ``precond_tpu/reference_api.py``;
SeSchwarzPreconditioner.h:37-178).

A user of the reference drives exactly three methods around their own
simulator (SURVEY.md §3, §8):

    pre.m_positions / m_edges / m_faces / m_neighbours = ...   (h:44-51)
    pre.AllocatePrecoditioner(numVerts, numEdges, numFaces)    (h:56)
    pre.PreparePreconditioner(diag, csrOffDiags, csrRanges,
                              efSets, eeSets, vfSets,
                              efCounts, eeCounts, vfCounts)    (h:59-60)
    z = pre.Preconditioning(residual)                          (h:62-63)

This module reproduces that contract (including the reference's spelling
of "AllocatePrecoditioner") on top of the port's pipeline. Inputs follow
the reference conventions:

  * m_edges i32[E,4] — two endpoints first (h:48); m_faces i32[F,>=3]
    (Int4 with 3 used, h:49); m_neighbours a (starts i32[N+1], ids
    i32[nnz]) CSR pair (h:51, SeCsr.h:161-173).
  * PreparePreconditioner's system matrix is the reference triplet
    (cpp:67-72): `diagonal` f32[N,3,3], `csr_off_diagonals` f32[nnz,3,3]
    aligned with the adjacency CSR's column ids, `csr_ranges` i32[N+1]
    row starts into it.
  * EF/EE/VF proximity sets are ops.stencils.{EfSets,EeSets,VfSets} of
    numpy arrays or tensors; the *Counts arrays are the reference's
    exclusive-prefix layouts whose totals sit at counts[numEdges] /
    counts[numVerts] (cpp:306-308) — pass None to use every entry of a set.

It runs on the card unless built with device="cpu". Where the JAX package
asserts, the port raises (ValueError / RuntimeError survive ``python -O``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import SchwarzConfig
from .device import resolve_device
from .ops.blockcsr import from_coo
from .ops.stencils import EeSets, EfSets, Stencils, VfSets, build_stencils
from .solver import SchwarzPreconditioner


def _slice_sets(sets, counts, n_prims: int):
    """Apply the reference's prefix-count convention: the live total sits
    at counts[n_prims] (cpp:306-308); entries beyond it are garbage."""
    if sets is None or counts is None:
        return sets
    total = int(np.asarray(counts).reshape(-1)[n_prims])
    return type(sets)(*(f[:total] for f in sets))


def _on(sets, device):
    """The set's fields as tensors on `device` (ids int32, floats f32)."""
    if sets is None:
        return None
    out = []
    for f in sets:
        t = torch.as_tensor(np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f))
        t = t.to(torch.int32) if not t.is_floating_point() else t.to(torch.float32)
        out.append(t.to(device))
    return type(sets)(*out)


class SeSchwarzPreconditioner:
    """Reference-contract facade over the port's three-phase pipeline."""

    def __init__(self, cfg: SchwarzConfig = SchwarzConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # input pointers, set by the host before allocate (h:44-51)
        self.m_positions: Optional[np.ndarray] = None   # f32[N,3]
        self.m_edges: Optional[np.ndarray] = None       # i32[E,4]
        self.m_faces: Optional[np.ndarray] = None       # i32[F,>=3]
        self.m_neighbours: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._impl = SchwarzPreconditioner(cfg, device=self.device)
        self._nv = None

    # -- phase 1 ----------------------------------------------------------
    def AllocatePrecoditioner(self, numVerts: int, numEdges: int, numFaces: int) -> None:
        """Per-frame entry (cpp:38-65): sizes + the cadenced spatial sort."""
        if self.m_positions is None:
            raise RuntimeError("set m_positions first (h:44)")
        if len(self.m_positions) < numVerts:
            raise ValueError(f"m_positions holds {len(self.m_positions)} vertices, "
                             f"fewer than numVerts={numVerts}")
        self._nv = int(numVerts)
        self._impl.allocate(np.asarray(self.m_positions, np.float32)[:numVerts])

    # -- phase 2 ----------------------------------------------------------
    def PreparePreconditioner(
        self,
        diagonal: np.ndarray,                 # f32[N,3,3]
        csr_off_diagonals: np.ndarray,        # f32[nnz,3,3]
        csr_ranges: np.ndarray,               # i32[N+1] row starts
        ef_sets: Optional[EfSets] = None,
        ee_sets: Optional[EeSets] = None,
        vf_sets: Optional[VfSets] = None,
        ef_counts: Optional[np.ndarray] = None,
        ee_counts: Optional[np.ndarray] = None,
        vf_counts: Optional[np.ndarray] = None,
    ) -> None:
        """Hierarchy + banked assembly + factorization (cpp:67-98).

        Column ids come from m_neighbours, exactly like the reference (its
        csrOffDiagonals ride the adjacency CSR's index structure)."""
        if self._nv is None:
            raise RuntimeError("call AllocatePrecoditioner first")
        n = self._nv
        starts, ids = self.m_neighbours
        del starts
        ids = np.asarray(ids).reshape(-1)
        ranges = np.asarray(csr_ranges).reshape(-1)
        off = np.asarray(csr_off_diagonals, np.float32)
        counts = np.diff(ranges[: n + 1]).astype(np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        lo, hi = int(ranges[0]), int(ranges[n])
        ell = from_coo(n, rows, ids[lo:hi], off[lo:hi], np.asarray(diagonal, np.float32),
                       device=self.device)

        stencils: Optional[Stencils] = None
        n_edges = len(np.asarray(self.m_edges))
        ef = _on(_slice_sets(ef_sets, ef_counts, n_edges), self.device)
        ee = _on(_slice_sets(ee_sets, ee_counts, n_edges), self.device)
        vf = _on(_slice_sets(vf_sets, vf_counts, n), self.device)
        if any(s is not None for s in (ef, ee, vf)):
            stencils = build_stencils(
                torch.as_tensor(np.asarray(self.m_edges, np.int32), device=self.device),
                torch.as_tensor(np.asarray(self.m_faces, np.int32)[:, :3], device=self.device),
                ef=ef, ee=ee, vf=vf,
            )
        self._impl.prepare(ell, stencils)
        self._ell = ell

    # -- phase 3 ----------------------------------------------------------
    def Preconditioning(self, residual) -> torch.Tensor:
        """z = M^-1 r, every PCG iteration (cpp:100-110)."""
        return self._impl.apply(residual)
