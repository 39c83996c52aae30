#!/usr/bin/env python3
"""Fine-grained timings of the apply's stages at scale: the twin of
scripts/profile_apply_fine.py, in precond_tpu_torch.

The state is prepare_with_system's on the analytic tile order
(gridmorton.sort_maps), so the general apply (apply.precondition_sorted)
and the static grid apply (gridapply.precondition_grid) run on the same
inverse table: the packed symv kernel (K2) at 1024^2, the dense one (K3)
below packed_symv_min_blocks. Each line runs its op K times, each call on
the last one's output, eagerly with no host sync inside the chain; it is
the least of 2 reps after a warm call (as the JAX script takes), in ms per
op, with the chain's device busy share (torch_dissect_common).

  floor (r scale)                 r * 1.000001
  grid->morton transform          both row-major crossings
  restrict                        apply.restrict_residual_onehot
  symv                            the per-block symv (K3, or K2 on a PackedInverse)
  prolong full                    apply.prolong_and_collect_onehot
  prolong coarse-accum            its top-down coarse pre-sum
  prolong fine-distribute         its level-1 window shift and one-hot distribute
  precondition_sorted             the whole general apply
  grid restrict / grid prolong    gridapply's reshape-sum transfers
  precondition_grid               the whole static grid apply
  precondition_grid+crossings     with the crossings around it

The JAX script's symv line assumes a dense table and raises on a
PackedInverse; the twin applies the packed table there.

Env: BENCH_GRID (default 1024), PROF_K (default 50).

    python3 scripts/torch_profile_apply_fine.py [--device cpu]
"""

from __future__ import annotations

import functools
import os
import sys
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch_dissect_common as dc  # noqa: E402
from torch_profile_apply import block_symv  # noqa: E402


def setup(grid: int, dev: torch.device, ell=None) -> SimpleNamespace:
    """The JAX script's inputs on `dev`: the state prepared on the tile
    order, r0 [N,3] and mr0 [total,3] (default_rng(0), in that order). A
    caller that holds the mesh's block-ELL system may pass it (`ell`)."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.solver import SortMaps, prepare_with_system
    from precond_tpu_torch.utils import gridmorton as gm

    k = grid.bit_length() - 1
    cfg = SchwarzConfig()
    mesh = cloth.make_grid(grid, grid, **dc.MESH_KW)
    n = mesh.num_verts
    if ell is None:
        ell = cloth.assemble_system(mesh, device=dev)
    maps = SortMaps(*(torch.as_tensor(m, device=dev) for m in gm.sort_maps(k)))
    state, _ = prepare_with_system(ell, maps, cfg)
    rng = np.random.default_rng(0)
    total = cfg.total_capacity(n)
    r0 = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32), device=dev)
    mr0 = torch.as_tensor(rng.standard_normal((total, 3)).astype(np.float32), device=dev)
    return SimpleNamespace(grid=grid, k=k, n=n, total=total, offs=cfg.level_offsets(n), cfg=cfg,
                           state=state, inv=state.inv96, r0=r0, mr0=mr0, dev=dev)


def _pad_to_total(s, z):
    return F.pad(z, (0, 0, 0, s.total - z.shape[0]))


# the components, (x, *rest) -> same shape as x, as the JAX script's lambdas

def floor(s, r):
    return r * 1.000001


def crossings(s, r):
    from precond_tpu_torch.utils import gridmorton as gm

    return gm.morton_to_grid(gm.grid_to_morton(r, s.k), s.k) * 1.000001


def restrict(s, r, st):
    from precond_tpu_torch.ops.apply import restrict_residual_onehot

    return restrict_residual_onehot(r * 1.000001, st, s.cfg, s.n)[: s.n]


def symv_only(s, m, inv):
    from precond_tpu_torch.ops.hierarchy import BANK

    return block_symv(inv, m.reshape(-1, 3 * BANK)).reshape(-1, 3) * 1.000001


def prolong_only(s, m, st):
    from precond_tpu_torch.ops.apply import prolong_and_collect_onehot

    return _pad_to_total(s, prolong_and_collect_onehot(m * 1.000001, st, s.cfg, s.n))


def prolong_coarse_only(s, m, st):
    from precond_tpu_torch.utils.gather import take_fill

    pz = m * 1.000001
    for l in range(min(s.cfg.num_levels(s.n), s.cfg.max_applied_levels) - 2, 0, -1):
        seg = slice(s.offs[l], s.offs[l + 1])
        pz[seg] += take_fill(pz, st.going_next[seg])
    return pz


def prolong_fine_only(s, m, st):
    from precond_tpu_torch.ops.hierarchy import BANK
    from precond_tpu_torch.utils.gather import take_fill

    offs = s.offs
    cap0 = offs[1]
    b0 = cap0 // BANK
    cap1 = offs[2] - cap0
    pz1 = m[cap0: offs[2]] * 1.000001
    pb = st.restrict_pb[:b0] - cap0
    q = torch.clamp(torch.div(pb, BANK, rounding_mode="floor"), 0, cap1 // BANK - 1)
    r = pb - q * BANK
    pzb = torch.cat([pz1, pz1.new_zeros((BANK, 3))]).reshape(-1, BANK, 3)
    win = take_fill(pzb, torch.stack([q, q + 1], dim=1)).reshape(b0, 2 * BANK, 3)
    for bit in (16, 8, 4, 2, 1):
        shifted = torch.cat([win[:, bit:, :], win.new_zeros((b0, bit, 3))], dim=1)
        win = torch.where(((r & bit) > 0)[:, None, None], shifted, win)
    winshift = win[:, :BANK, :]
    contrib = torch.bmm(st.restrict_onehot[:b0].transpose(1, 2), winshift)
    return _pad_to_total(s, contrib.reshape(-1, 3))


def precondition_sorted(s, r, st):
    from precond_tpu_torch.ops.apply import precondition_sorted as apply

    return apply(st, r * 1.000001, s.cfg)


def grid_restrict(s, r):
    from precond_tpu_torch.ops.gridapply import restrict_residual_grid

    return restrict_residual_grid(r * 1.000001, s.cfg, s.n)[: s.n]


def grid_prolong(s, m):
    from precond_tpu_torch.ops.gridapply import prolong_and_collect_grid

    return _pad_to_total(s, prolong_and_collect_grid(m * 1.000001, s.cfg, s.n))


def precondition_grid(s, r, inv):
    from precond_tpu_torch.ops.gridapply import precondition_grid as apply

    return apply(inv, r * 1.000001, s.cfg)


def precondition_grid_crossings(s, r, inv):
    from precond_tpu_torch.ops.gridapply import precondition_grid as apply
    from precond_tpu_torch.utils import gridmorton as gm

    return gm.morton_to_grid(apply(inv, gm.grid_to_morton(r * 1.000001, s.k), s.cfg), s.k)


#: (line name, component, its arguments as fields of the setup)
COMPONENTS = (
    ("floor (r scale)", floor, ("r0",)),
    ("grid->morton transform", crossings, ("r0",)),
    ("restrict", restrict, ("r0", "state")),
    ("symv", symv_only, ("mr0", "inv")),
    ("prolong full", prolong_only, ("mr0", "state")),
    ("prolong coarse-accum", prolong_coarse_only, ("mr0", "state")),
    ("prolong fine-distribute", prolong_fine_only, ("mr0", "state")),
    ("precondition_sorted", precondition_sorted, ("r0", "state")),
    ("grid restrict", grid_restrict, ("r0",)),
    ("grid prolong", grid_prolong, ("mr0",)),
    ("precondition_grid", precondition_grid, ("r0", "inv")),
    ("precondition_grid+crossings", precondition_grid_crossings, ("r0", "inv")),
)


def run_components(s, k: int, log=dc.log) -> dict:
    """Times every component (ms per op) and prints the script's line for
    each; returns {name: Timing}."""
    out = {}
    for name, fn, names in COMPONENTS:
        run, args = dc.chain(functools.partial(fn, s), k), [getattr(s, a) for a in names]
        t = dc.measure(lambda: run(*args), s.dev, reps=2)
        t["ms"] = t["best_s"] / k * 1e3
        log(f"{name:36s} {t['ms']:9.3f} ms/op" + t.note())
        out[name] = t
    return out


def main(argv=None) -> int:
    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    k = dc.env_int("PROF_K", 50)
    s = setup(dc.env_int("BENCH_GRID", 1024), dev)
    dc.header(f"grid={s.grid} n={s.n} total={s.total} K={k}", dev)
    run_components(s, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
