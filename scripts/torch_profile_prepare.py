#!/usr/bin/env python3
"""Per-component timings of the general path's prepare: the twin of
scripts/profile_prepare.py, in precond_tpu_torch.

Each component runs K times, each call on an input nudged by 1e-30 *
mean(last output) (so no call can be skipped), eagerly with no host sync
inside the chain; the line is the least of 3 reps after a warm call, in ms
per op, with the chain's device busy share (torch_dissect_common).

  floor (scaled copy)      x * 1.000001 on the sorted diagonal
  permute ELL              blockcsr.permute
  build_hierarchy          hierarchy.build_hierarchy
  restriction_operators    hierarchy.restriction_operators
  assemble                 assembly.assemble_banked_hessian (ancestor-table form)
  invert panel             the batched 96x96 SPD inverse kernel (K1), the
                           port of invert_spd_blocks_panel's Pallas form
  prepare (single)         one solver.prepare_with_system (K = 1)
  sort maps (single)       one solver.compute_sort_maps (K = 1)

Before those, and before anything else of the prepare has run in the
process, two more lines split the first prepare's cost against the steady
"prepare (single)":

  prepare (first call)         the process's first prepare_with_system
  prepare (after empty_cache)  the next one, after torch.cuda.empty_cache():
                               it pays the caching allocator's growth again,
                               not the first launch of each kernel

The kernels are loaded (built by nvcc if the cache misses) before the first
call and the time is printed on its own line.

Env: BENCH_GRID (default 256), PROF_K (default 20).

    python3 scripts/torch_profile_prepare.py [--device cpu]
"""

from __future__ import annotations

import functools
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import torch_dissect_common as dc  # noqa: E402


def setup(grid: int, dev: torch.device, ell=None) -> SimpleNamespace:
    """The JAX script's mesh, block-ELL system and Morton sort maps on
    `dev`; component_inputs adds the sorted system, hierarchy and blocks.
    A caller that holds the mesh's block-ELL system may pass it (`ell`)."""
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.solver import compute_sort_maps

    cfg = SchwarzConfig()
    mesh = cloth.make_grid(grid, grid, **dc.MESH_KW)
    if ell is None:
        ell = cloth.assemble_system(mesh, device=dev)
    positions = torch.as_tensor(mesh.positions, device=dev)
    return SimpleNamespace(grid=grid, n=mesh.num_verts, cfg=cfg, ell=ell, positions=positions,
                           maps=compute_sort_maps(positions), dev=dev)


def component_inputs(s) -> SimpleNamespace:
    """Adds the script's ells (sorted system), hier and h96 to `s`."""
    from precond_tpu_torch.ops import hierarchy as hi
    from precond_tpu_torch.ops.assembly import assemble_banked_hessian
    from precond_tpu_torch.ops.blockcsr import permute

    s.ells = permute(s.ell, s.maps.sorted_to_orig, s.maps.orig_to_sorted)
    s.hier = hi.build_hierarchy(s.ells.idx, s.ells.mask, s.cfg, None)
    s.h96 = assemble_banked_hessian(s.ells, s.hier, s.cfg, None)
    return s


def prepare(s, ell, maps):
    from precond_tpu_torch.solver import prepare_with_system

    return prepare_with_system(ell, maps, s.cfg)


def first_prepares(s, log=dc.log) -> dict:
    """The process's first prepare and the one after empty_cache (ms), each
    one call ending in a device sync; loads the kernels first."""
    out = {}
    if s.dev.type == "cuda":
        from precond_tpu_torch.ops.cuda import _lib

        t0 = time.perf_counter()
        _lib.load()
        info = _lib.build_info
        log(f"{'kernels loaded':36s} {(time.perf_counter() - t0) * 1e3:9.3f} ms "
            f"(the library was {'loaded from the cache' if info['cached'] else 'built'} "
            f"in {info['seconds']:.2f} s)")
    for name in ("prepare (first call)", "prepare (after empty_cache)"):
        if s.dev.type == "cuda":
            torch.cuda.empty_cache()
        dc.sync(s.dev)
        t0 = time.perf_counter()
        state, _ = prepare(s, s.ell, s.maps)
        dc.first_value(state.inv96).cpu()
        out[name] = (time.perf_counter() - t0) * 1e3
        log(f"{name:36s} {out[name]:9.3f} ms/op")
    return out


def chain(op, k: int):
    def run(x, *rest):
        for _ in range(k):
            y = op(x, *rest)
            x = x * (1.0 + 1e-30 * torch.mean(y.to(torch.float32)).to(x.dtype))
        return x

    return run


# the components, (x, *rest) -> y as the JAX script's lambdas

def floor(s, x):
    return x * 1.000001


def permute_ell(s, d, e, m):
    from precond_tpu_torch.ops.blockcsr import permute

    return permute(e._replace(diag=d), m.sorted_to_orig, m.orig_to_sorted).blocks


def build_hierarchy(s, mskf, idx):
    from precond_tpu_torch.ops import hierarchy as hi

    return hi.build_hierarchy(idx, mskf > 0, s.cfg, None).going_next.to(torch.float32)


def restriction_operators(s, gnf):
    from precond_tpu_torch.ops import hierarchy as hi

    return hi.restriction_operators(gnf.to(torch.int32), s.cfg, s.n)[0]


def assemble(s, d, e, h):
    from precond_tpu_torch.ops.assembly import assemble_banked_hessian

    return assemble_banked_hessian(e._replace(diag=d), h, s.cfg, None)[:, 0, :]


def invert_panel(s, h):
    from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse

    return spd_inverse(h)[:, 0, :]


def prepare_single(s, e, m):
    return dc.first_value(prepare(s, e, m)[0].inv96)


def sort_maps_single(s, p):
    from precond_tpu_torch.solver import compute_sort_maps

    return compute_sort_maps(p).sorted_to_orig[:1].to(torch.float32)


#: (line name, component, its arguments as fields of the setup, chained)
COMPONENTS = (
    ("floor (scaled copy)", floor, ("ells_diag",), True),
    ("permute ELL", permute_ell, ("ells_diag", "ell", "maps"), True),
    ("build_hierarchy", build_hierarchy, ("ells_maskf", "ells_idx"), True),
    ("restriction_operators", restriction_operators, ("hier_gnf",), True),
    ("assemble", assemble, ("ells_diag", "ells", "hier"), True),
    ("invert panel", invert_panel, ("h96",), True),
    ("prepare (single)", prepare_single, ("ell", "maps"), False),
    ("sort maps (single)", sort_maps_single, ("positions",), False),
)


def args_of(s, names):
    """The arguments named in COMPONENTS, from a setup with component_inputs."""
    extra = {"ells_diag": s.ells.diag, "ells_idx": s.ells.idx,
             "ells_maskf": s.ells.mask.to(torch.float32),
             "hier_gnf": s.hier.going_next.to(torch.float32)}
    return [extra[a] if a in extra else getattr(s, a) for a in names]


def run_components(s, k: int, log=dc.log) -> dict:
    """Times every component (ms per op; the single ones one call each)
    and prints the script's line for each; returns {name: Timing}."""
    out = {}
    for name, fn, names, chained in COMPONENTS:
        op, args = functools.partial(fn, s), args_of(s, names)
        kk = k if chained else 1
        run = chain(op, k) if chained else op
        t = dc.measure(lambda: run(*args), s.dev)
        t["ms"] = t["best_s"] / kk * 1e3
        log(f"{name:36s} {t['ms']:9.3f} ms/op" + t.note())
        out[name] = t
    return out


def main(argv=None) -> int:
    dev = dc.parse_device(__doc__.splitlines()[0], argv)
    k = dc.env_int("PROF_K", 20)
    s = setup(dc.env_int("BENCH_GRID", 256), dev)
    dc.header(f"grid={s.grid} n={s.n} total={s.cfg.total_capacity(s.n)} K={k}", dev)
    first_prepares(s)
    run_components(component_inputs(s), k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
