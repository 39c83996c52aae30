#!/usr/bin/env python3
"""JAX package record for the general path on irregular Delaunay cloth, and
for the entry points of __graft_entry__.py.

For each mesh of scripts/torch_irregular_mesh.py (the recipe is there; the
PyTorch port builds its meshes from the same arrays), the JAX package's
general path as a user drives it: ClothMesh(..., grid=None) ->
assemble_system -> SchwarzPreconditioner allocate -> prepare -> PCG on the
block-ELL SpMV with the apply, to tol 1e-4, every iteration tested, the
rhs seed 0's standard normal; block-Jacobi on the same SpMV. It records
the ELL width and nnz (9 (N + stored off-diagonal blocks), bench.py's
nnz_spmv), the levels, capacities, packed or dense storage, the
level_headroom in effect and the retries, the iterations and residuals
(Schwarz's also recomputed as ||b - H x|| / ||b||),
and the mesh's digests. A mesh with a hub also gets a prepare at
level_headroom 0.3: the headroom its overflow retries land on, and that
solve's iterations.

Then JAX's entry() (jitted, as its __main__ runs it) and the JAX dryrun's
two steps on 2 and 4 virtual CPU devices (dryrun_multichip(n), its printed
iterations and residuals).

Prints a line per record, then one JSON line. Runs the JAX package on the
CPU; the PyTorch port never imports it.

    JAX_PLATFORMS=cpu python3 scripts/jax_irregular_record.py \\
        [--mesh 1024 --mesh 256:19]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import resource
import sys
import time
import warnings

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=4").strip()
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_irregular_mesh as tim  # noqa: E402
from precond_tpu.config import SchwarzConfig  # noqa: E402
from precond_tpu.models import cloth  # noqa: E402
from precond_tpu.ops import blockcsr  # noqa: E402
from precond_tpu.ops.apply import precondition  # noqa: E402
from precond_tpu.parallel.pcg import jacobi_preconditioner, pcg  # noqa: E402
from precond_tpu.solver import SchwarzPreconditioner  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def parse_mesh(spec: str):
    """'side' or 'side:hub_radius' -> (side, hub_radius)."""
    side, _, radius = spec.partition(":")
    return int(side), float(radius or 0.0)


def mesh_name(side: int, radius: float) -> str:
    return f"{side} hub" if radius else str(side)


def _prepared(mesh, ell, cfg):
    pre = SchwarzPreconditioner(cfg)
    pre.allocate(jnp.asarray(mesh.positions))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pre.prepare(ell)
    retries = sum("overflow" in str(w.message) for w in caught)
    return pre, retries


def _schwarz(pre, ell, b):
    cfg = pre.cfg_effective

    @jax.jit
    def solve(state, ell, b):
        return pcg(lambda p: blockcsr.spmv(ell, p), lambda r: precondition(state, r, cfg), b,
                   tol=1e-4, max_iters=2000)

    return solve(pre.state, ell, b)


def _true_rel(ell, x, b) -> float:
    """||b - H x|| / ||b||, recomputed (PCG's own residual is recursive)."""
    return float(jnp.linalg.norm(b - blockcsr.spmv(ell, x)) / jnp.linalg.norm(b))


def record_mesh(side: int, radius: float) -> dict:
    t0 = time.perf_counter()
    arrays = tim.irregular_cloth(side, radius)
    mesh = cloth.ClothMesh(**arrays)
    n = mesh.num_verts
    ell = cloth.assemble_system(mesh)
    mask = np.asarray(ell.mask)
    out = {"side": side, "hub_radius": radius, "n": n, "width": int(mask.shape[1]),
           "nnz": int(9 * (n + int(mask.sum()))), "digest": tim.digest(arrays),
           "springs_digest": tim.digest(dict(arrays, positions=np.zeros(0, np.float32))),
           "hub_degree": int(tim.mesh_degrees(arrays)[tim.hub_vertex(arrays)])}
    build_s = time.perf_counter() - t0
    pre, retries = _prepared(mesh, ell, SchwarzConfig())
    cfg = pre.cfg_effective
    out.update(levels=cfg.num_levels(n), capacities=list(cfg.level_capacities(n)),
               packed=cfg.use_packed_symv(n), headroom=cfg.level_headroom, retries=retries)
    b = jnp.asarray(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32))
    t1 = time.perf_counter()
    rs = _schwarz(pre, ell, b)
    jac = jax.jit(lambda ell, b: pcg(lambda p: blockcsr.spmv(ell, p),
                                     jacobi_preconditioner(ell.diag), b, tol=1e-4,
                                     max_iters=20000))(ell, b)
    out.update(schwarz_iters=int(rs.iterations), schwarz_rel=float(rs.rel_residual),
               schwarz_true_rel=_true_rel(ell, rs.x, b),
               jacobi_iters=int(jac.iterations), jacobi_rel=float(jac.rel_residual))
    if radius > 0:
        pre3, r3 = _prepared(mesh, ell, SchwarzConfig(level_headroom=0.3))
        r3s = _schwarz(pre3, ell, b)
        out["retry"] = {"from": 0.3, "headroom": pre3.cfg_effective.level_headroom,
                        "retries": r3, "capacities": list(pre3.cfg_effective.level_capacities(n)),
                        "iters": int(r3s.iterations), "rel": float(r3s.rel_residual)}
    print(f"[record] irregular {mesh_name(side, radius)}: {json.dumps(out)} (mesh and "
          f"system {build_s:.1f} s, prepare and solves {time.perf_counter() - t1:.1f} s, "
          f"max RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GB)",
          flush=True)
    return out


def record_graft() -> dict:
    import __graft_entry__ as graft

    fn, args = graft.entry()
    res = jax.jit(fn)(*args)
    out = {"entry": {"iters": int(res.iterations), "rel": float(res.rel_residual)}}
    pat = re.compile(r"dryrun_multichip\((\d+)\)( grid path)?: iters=(\d+) rel_residual=(\S+)")
    for n in (2, 4):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            graft.dryrun_multichip(n)
        steps = {}
        for m in pat.finditer(buf.getvalue()):
            steps["grid" if m.group(2) else "halo"] = {"iters": int(m.group(3)),
                                                       "rel": float(m.group(4))}
        out[f"dryrun_{n}"] = steps
    print(f"[record] graft entry: {json.dumps(out)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", action="append", help="side or side:hub_radius (repeatable)")
    args = ap.parse_args(argv)
    meshes = args.mesh or ["1024", "256:19"]
    out = {"versions": {"jax": jax.__version__, "numpy": np.__version__,
                        "scipy": __import__("scipy").__version__},
           "irregular": {}}
    for spec in meshes:
        side, radius = parse_mesh(spec)
        out["irregular"][mesh_name(side, radius)] = record_mesh(side, radius)
    out["graft"] = record_graft()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
