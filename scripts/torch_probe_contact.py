#!/usr/bin/env python3
"""Dissect the collide config: the twin of scripts/probe_contact.py, in
precond_tpu_torch, on the JAX bench's folded sheet at stiffness 1e3
(torch_probe_common; detection at 1e3 directly, as the bench does).

  1. the walls of prepare_grid without and with the stencils (the split
     of the collide grid prepare), and alone: collision_terms (stencils
     mapped to the tile order), grid_collision_terms, build_contact_ell
     (kc 32) and build_contact_slots. The JAX script's line 143 reads
     ContactSlots.w, which does not exist (the field is w5), so it stops
     there; the twin fetches w5.
  2. ms per iteration of the composed PCG loop (K iterations, no host sync
     inside) for three contact SpMV forms: none, the rank-1 scatter
     (stencil_contact_spmv) and the slot-sorted segmented sum
     (slot_contact_spmv), on the layout the "auto" inverse picks
     (comp-major from 32^2 up: transposes around the contact SpMV, as
     probe_contact.py:149-203 writes it).
  3. iterations and wall of PCG to 1e-4 (check_every 8, max_iters 2000) with
     the static grid M and with the general M (prepare_with_system with the
     stencils on the tile maps: contact pairs in the clustering), both
     row-major (solve_layout="rows"), on the same operator (grid stencil
     SpMV + slot contact SpMV).

Each timed line is the least of the reps after a warm call, with its device
busy share (torch_dissect_common.measure); the JAX script's K-vs-3K
differencing is not needed where every call ends in a device sync.

    python3 scripts/torch_probe_contact.py [grid] [--k 50] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_dissect_common as dc  # noqa: E402
import torch_probe_common as pc  # noqa: E402

STIFFNESS = 1e3
FORMS = ("none", "scatter", "slots")
#: the contact ELL's row width (probe_contact.py:98)
KC = 32
#: the solves' iteration cap (probe_contact.py:235)
SOLVE_MAX_ITERS = 2000


def setup(grid: int, dev: torch.device):
    """The sheet at stiffness 1e3, its contact ELL and slots, and the
    script's config (the defaults: solve_layout "auto")."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.ops.contact import build_contact_ell, build_contact_slots

    s = pc.setup(grid, dev, STIFFNESS)
    s.cfg = SchwarzConfig()
    s.ce = build_contact_ell(s.st, s.n, kc=KC)
    s.cs = build_contact_slots(s.st, s.n)
    return s


def _ms(t) -> str:
    return f"{t['best_s'] * 1e3:8.2f} ms{t.note()}"


def prepare_walls(s, log=dc.log) -> dict:
    """Section 1: {line: Timing}; sets s.inv, the static inverse with the
    stencils (the "auto" layout)."""
    from precond_tpu_torch.ops.contact import build_contact_ell, build_contact_slots
    from precond_tpu_torch.ops.gridassembly import grid_collision_terms
    from precond_tpu_torch.ops.stencils import collision_terms, map_stencils
    from precond_tpu_torch.solver import prepare_grid

    o2s = s.maps.orig_to_sorted
    out = {}

    def line(name, label, fn, reps=5):
        t = out[name] = dc.measure(fn, s.dev, reps)
        log(f"{label} {_ms(t)}")
        return t["out"]

    line("prepare_grid plain", "prepare_grid plain      ",
         lambda: prepare_grid(s.dgr, s.drr, s.offsets, s.k, s.cfg))
    s.inv = line("prepare_grid +stencils", "prepare_grid +stencils  ",
                 lambda: prepare_grid(s.dgr, s.drr, s.offsets, s.k, s.cfg, s.st, o2s))
    terms = line("collision_terms", "  collision_terms       ",
                 lambda: collision_terms(map_stencils(s.st, o2s)))
    line("grid_collision_terms", "  grid_collision_terms  ",
         lambda: grid_collision_terms(terms, s.cfg, s.n))
    line("build_contact_ell", "  build_contact_ell     ",
         lambda: build_contact_ell(s.st, s.n, kc=KC).diag)
    line("build_contact_slots", "  build_contact_slots   ",
         lambda: build_contact_slots(s.st, s.n).w5)
    return out


def is_cm(inv) -> bool:
    from precond_tpu_torch.ops.cuda.packed_symv import DenseInverseCM, PackedInverseCM

    return isinstance(inv, (DenseInverseCM, PackedInverseCM))


def k_iterations(s, form: str, k: int) -> torch.Tensor:
    """K iterations of the script's composed PCG loop on s.inv with one
    contact SpMV form; returns x (probe_contact.py:153-201)."""
    from precond_tpu_torch.ops import gridstencil
    from precond_tpu_torch.ops.contact import slot_contact_spmv, stencil_contact_spmv
    from precond_tpu_torch.ops.gridapply import precondition_grid, precondition_grid_cm
    from precond_tpu_torch.utils import gridmorton as gm

    if is_cm(s.inv):
        def pre(r):
            return gm.morton_to_grid_cm(
                precondition_grid_cm(s.inv, gm.grid_to_morton_cm(r, s.k), s.cfg), s.k)

        def sp(v):
            q = gridstencil.spmv_t(s.ssys, v)
            if form == "scatter":
                q = q + stencil_contact_spmv(s.st, v.T).T
            elif form == "slots":
                q = q + slot_contact_spmv(s.st, s.cs, v.T).T
            return q

        bi = s.b.T.contiguous()
    else:
        def pre(r):
            return gm.morton_to_grid(precondition_grid(s.inv, gm.grid_to_morton(r, s.k), s.cfg), s.k)

        def sp(v):
            q = gridstencil.spmv(s.ssys, v)
            if form == "scatter":
                q = q + stencil_contact_spmv(s.st, v)
            elif form == "slots":
                q = q + slot_contact_spmv(s.st, s.cs, v)
            return q

        bi = s.b
    z0 = pre(bi)
    x, r, p, rz = torch.zeros_like(bi), bi, z0, torch.sum(bi * z0)
    for _ in range(k):
        q = sp(p)
        alpha = rz / torch.sum(p * q)
        x = x + alpha * p
        r = r - alpha * q
        z = pre(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def run_forms(s, k: int, log=dc.log) -> dict:
    """Section 2: {form: Timing with "ms" per iteration}."""
    log(f"static inv type: {type(s.inv).__name__} (cm={is_cm(s.inv)})")
    out = {}
    for form in FORMS:
        t = out[form] = dc.measure(lambda: k_iterations(s, form, k), s.dev)
        t["ms"] = t["best_s"] / k * 1e3
        log(f"iter[{form:7s}]          {t['ms']:8.4f} ms{t.note()}")
    return out


def spmv_forms(s, x: torch.Tensor) -> dict:
    """The contact operator on one [N,3] vector in its three forms: the
    contact ELL (contact_spmv), the rank-1 scatter and the slots."""
    from precond_tpu_torch.ops.contact import contact_spmv, slot_contact_spmv, stencil_contact_spmv

    return {"ell": contact_spmv(s.ce, x), "scatter": stencil_contact_spmv(s.st, x),
            "slots": slot_contact_spmv(s.st, s.cs, x)}


def solves(s, log=dc.log) -> dict:
    """Section 3: {"static" | "general": solve dict} (the least wall of 2
    solves after a warm one), and the general prepare's Timing."""
    from precond_tpu_torch.ops.apply import precondition_sorted
    from precond_tpu_torch.solver import prepare_with_system

    cfg = dataclasses.replace(s.cfg, solve_layout="rows")
    spmv = pc.contact_spmv(s, s.st)
    out = {}

    def solve(name, label, pre):
        _, best, r = dc.best_wall(lambda: pc.solve(s, spmv, pre, SOLVE_MAX_ITERS), s.dev, reps=2)
        r["wall_s"] = best
        out[name] = r
        log(f"{label} iters={r['iters']} rel={r['rel']:.2e} wall={best * 1e3:.1f} ms "
            f"({best * 1e3 / max(r['iters'], 1):.3f} ms/iter)")

    solve("static", "solve[static M]  ", pc.static_pre(s, s.st, cfg))
    t = out["prepare general"] = dc.measure(lambda: prepare_with_system(s.ell, s.maps, cfg, s.st), s.dev)
    log(f"prepare general +stencils {_ms(t)}")
    gs = t["out"][0]
    s2o, o2s = gs.sorted_to_orig.long(), gs.orig_to_sorted.long()
    solve("general", "solve[general M] ", lambda r: precondition_sorted(gs, r[s2o], cfg)[o2s])
    return out


def main(argv=None) -> int:
    def add(ap):
        ap.add_argument("grid", type=int, nargs="?", default=256,
                        help="side of the folded sheet (default 256)")
        ap.add_argument("--k", type=int, default=50, help="iterations per composed loop")

    dev, args = dc.parse_args(__doc__.splitlines()[0], argv, add)
    s = setup(args.grid, dev)
    dc.header(f"n={s.n} stencils={s.live} (slots={s.st.idx.numel()})", dev)
    prepare_walls(s)
    run_forms(s, args.k)
    solves(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
