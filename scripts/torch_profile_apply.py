#!/usr/bin/env python3
"""Per-component timings of the PCG iteration on the general path: the
twin of scripts/profile_apply.py, in precond_tpu_torch.

Each component runs K times chained through a data dependency (the next
input is the output, or the input nudged by 1e-30 * mean(output) where
the shapes differ), eagerly and with no host sync inside the chain; the
line is the least of 3 reps after a warm call, in us per op, and the
chain's device busy share (torch_dissect_common).

  inv96 full-read (sum)        one full read of the inverse table
  restrict                     apply.restrict_residual
  symv (einsum)                the per-block symv that JAX computes with an
                               einsum: here the dense symv kernel (K3), or the
                               packed one (K2) on a PackedInverse
  prolong                      apply.prolong_and_collect
  precondition_sorted          the whole apply
  spmv stencil (grid order)    gridstencil.spmv (the stencil kernel, K4)
  spmv ell (sorted order)      blockcsr.spmv, the general path's SpMV
  dot+axpy pair                PCG's vector ops

The state is prepare_with_system's on the Morton-sorted cloth (dense
table at 256^2, packed from packed_symv_min_blocks up, 1024^2). The JAX
script's full-read and symv lines assume a dense table and raise on a
PackedInverse; the twin reads and applies the packed table there.

Env: BENCH_GRID (default 256), PROF_K (default 100).

    python3 scripts/torch_profile_apply.py [--device cpu]
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

import torch_dissect_common as dc  # noqa: E402


def setup(grid: int, dev: torch.device) -> SimpleNamespace:
    """The JAX script's inputs on `dev`: the block-ELL and stencil systems,
    the Morton sort maps, the prepared state and sorted system, r0 [N,3]
    and mr0 [total,3] (default_rng(0), in that order)."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.solver import compute_sort_maps, prepare_with_system

    cfg = SchwarzConfig()
    mesh = cloth.make_grid(grid, grid, **dc.MESH_KW)
    n = mesh.num_verts
    ell = cloth.assemble_system(mesh, device=dev)
    ssys = cloth.assemble_system_stencil(mesh, device=dev)
    maps = compute_sort_maps(torch.as_tensor(mesh.positions, device=dev))
    state, ells = prepare_with_system(ell, maps, cfg)
    rng = np.random.default_rng(0)
    total = cfg.total_capacity(n)
    r0 = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32), device=dev)
    mr0 = torch.as_tensor(rng.standard_normal((total, 3)).astype(np.float32), device=dev)
    return SimpleNamespace(grid=grid, n=n, total=total, cfg=cfg, ell=ell, ssys=ssys, maps=maps,
                           state=state, ells=ells, inv=state.inv96, r0=r0, mr0=mr0, dev=dev)


def chain(op, k: int):
    """Run op k times with a data dependency (perturb input by output's mean)."""

    def run(x, *rest):
        for _ in range(k):
            y = op(x, *rest)
            x = x + 1e-30 * torch.mean(y) * torch.ones_like(x) if y.shape != x.shape else y
        return x

    return run


def table_sum(inv) -> torch.Tensor:
    """Sum of every stored float of a dense table or a PackedInverse."""
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse

    if isinstance(inv, PackedInverse):
        return torch.sum(inv.f) + torch.sum(inv.dg)
    return torch.sum(inv)


def block_symv(inv, rhs96):
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse, packed_symv
    from precond_tpu_torch.ops.cuda.symv import batched_symv

    if isinstance(inv, PackedInverse):
        return packed_symv(inv, rhs96)
    return batched_symv(inv, rhs96)


# the components, (x, *rest) -> y as the JAX script's lambdas; `s` carries
# the script's cfg, n and total

def full_read(s, x, inv):
    return x + table_sum(inv) * 0


def restrict(s, r, st):
    from precond_tpu_torch.ops.apply import restrict_residual

    return restrict_residual(r, st, s.cfg, s.n)[: r.shape[0]]


def symv(s, m, inv):
    from precond_tpu_torch.ops.hierarchy import BANK

    return block_symv(inv, m.reshape(-1, 3 * BANK)).reshape(-1, 3)


def prolong(s, m, st):
    import torch.nn.functional as F
    from precond_tpu_torch.ops.apply import prolong_and_collect

    return F.pad(prolong_and_collect(m, st, s.cfg, s.n), (0, 0, 0, s.total - s.n))


def precondition(s, r, st):
    from precond_tpu_torch.ops.apply import precondition_sorted

    return precondition_sorted(st, r, s.cfg)


def spmv_stencil(s, v, ssys):
    from precond_tpu_torch.ops import gridstencil

    return gridstencil.spmv(ssys, v)


def spmv_ell(s, v, ells):
    from precond_tpu_torch.ops import blockcsr

    return blockcsr.spmv(ells, v)


def dot_axpy(s, v, b):
    vf, bf = v.reshape(-1), b.reshape(-1)
    return v * (torch.dot(vf, bf) / torch.dot(bf, bf)) + b


#: (line name, component, its arguments as fields of the setup)
COMPONENTS = (
    ("inv96 full-read (sum)", full_read, ("r0_11", "inv")),
    ("restrict", restrict, ("r0", "state")),
    ("symv (einsum)", symv, ("mr0", "inv")),
    ("prolong", prolong, ("mr0", "state")),
    ("precondition_sorted", precondition, ("r0", "state")),
    ("spmv stencil (grid order)", spmv_stencil, ("r0", "ssys")),
    ("spmv ell (sorted order)", spmv_ell, ("r0", "ells")),
    ("dot+axpy pair", dot_axpy, ("r0", "r0x2")),
)


def args_of(s, names):
    """The arguments named in COMPONENTS, from a setup."""
    extra = {"r0_11": s.r0[:1, :1], "r0x2": s.r0 * 2.0}
    return [extra[a] if a in extra else getattr(s, a) for a in names]


def run_components(s, k: int, log=dc.log) -> dict:
    """Times every component (us per op) and prints the script's line for
    each; returns {name: Timing}."""
    out = {}
    for name, fn, names in COMPONENTS:
        run, args = chain(functools.partial(fn, s), k), args_of(s, names)
        t = dc.measure(lambda: run(*args), s.dev)
        t["ms"] = t["best_s"] / k * 1e3
        log(f"{name:32s} {t['best_s'] / k * 1e6:9.1f} us/op" + t.note())
        out[name] = t
    return out


def main(argv=None) -> int:
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse

    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    k = dc.env_int("PROF_K", 100)
    s = setup(dc.env_int("BENCH_GRID", 256), dev)
    blocks = s.inv.nb if isinstance(s.inv, PackedInverse) else s.inv.shape[0]
    dc.header(f"grid={s.grid} n={s.n} total={s.total} blocks={blocks} K={k}", dev)
    run_components(s, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
