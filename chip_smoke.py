#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (precond_tpu_torch) on one CUDA card.

Drives three main paths of the multilevel additive Schwarz preconditioner
through the port's entry points — the general-mesh path (allocate ->
prepare -> PCG), the structured cloth-grid path (assemble_system_grid /
assemble_system_stencil -> prepare_grid -> comp-major PCG) and contact on
the general path (hash-grid detection -> stencils -> prepare(ell, stencils)
-> PCG with the contact SpMV) — builds every
hand-written kernel from ``precond_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version at the main paths' shapes, and checks
what comes out against references. It prints, in order:

  * the card, versions and kernel build time;
  * general 1024 (the packed-symv path) and general 256 (the dense-symv
    path): iterations, residuals, prepare ms, ms per iteration, peak device
    memory, launch counts, bitwise repeats, a profile;
  * cloth 1024 (comp-major + packed symv, the JAX bench's headline) and
    cloth 256 (comp-major + dense symv): the same, each against
    block-Jacobi on the same carries and SpMV;
  * grid_solve_step at 256 (row-major + dense);
  * collide 256 (general M): the JAX bench's folded sheet with VF/EE/EF
    contact detected on the card, against block-Jacobi and the JAX
    package's iteration record; set sizes, bitwise repeats of detection,
    prepare, apply and contact SpMV, timings and profiles;
  * small-input references: a dense solve on a one-bank mesh, the card
    against the CPU (plain versions) on 32x32 cloths for both paths and on
    a 64x64 fold for the collide path, and the analytic-hierarchy prepare
    against prepare_grid;
  * per kernel: error against its plain version with the tolerance, and
    kernel / plain / library times (CUDA events) beside the bound;
  * one JSON line of kernel records, the nvidia-smi name/power line, and a
    last JSON line {"ok": true, "device": {...}}.

Each path runs once with the launch counts set to 0 just before it and
read just after. Any failed check exits nonzero without the last line.
Needs a CUDA card and the repository checkout around this file.

    python3 chip_smoke.py [--grid 1024] [--dense-grid 256] [--cloth 1024] [--cloth-dense 256]
                          [--collide 256]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# H100 SXM data sheet, at the 700 W limit: HBM rate and f32 rate outside the
# tensor cores. Bounds are computed from these, not measured.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# where the main path runs: the card
DEVICE = "cuda"

# The JAX package's recorded iteration counts (Schwarz, Jacobi) for the same
# configurations (BASELINE.md:55 and BENCH_r05.json); iteration counts do not
# depend on the chip up to rounding.
JAX_RECORD_ITERS = {1024: (120, 544), 256: (112, 544)}
# the same for the cloth grid path (BASELINE.md:56-57), comp-major
JAX_RECORD_ITERS_CLOTH = {1024: (96, 544), 256: (88, 544)}
# accepted bands around the record: the JAX bench tests convergence every 8
# iterations, the port every iteration
CLOTH_BAND = (8, 16)
# The JAX package's (Schwarz, Jacobi, live stencils) for the collide sheet on
# the general M at 256 (N = 65,536), from scripts/jax_collide_general_record.py
# run on the CPU: the bench's recipe solved as ClothSim's general branch does,
# every iteration tested.
JAX_RECORD_COLLIDE = {256: (373, 755, 49152)}
# accepted relative bands (Schwarz, Jacobi) around that record
COLLIDE_BAND = (0.10, 0.05)


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(nbytes: float, flops: float):
    b = nbytes / PEAK_BYTES_PER_S * 1e3
    f = flops / PEAK_F32_FLOPS * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


def time_ms(fn, warmup: int, iters: int) -> float:
    """Mean ms per call over `iters` calls, CUDA events, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def same_bits(a, b) -> bool:
    """Bitwise equality of tensors, and of (named) tuples of them field by field."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, tuple):
        return type(a) is type(b) and len(a) == len(b) and all(map(same_bits, a, b))
    return a == b


def profile_phase(label: str, fn, reps: int, top: int = 8) -> None:
    """Device busy share and the top device activities of `reps` calls of
    `fn`, from torch.profiler's CUDA trace, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if not dev:
        log(f"[profile {label}] wall {wall_ms / reps:.3f} ms; device time not measured "
            f"(the trace holds no device activity)")
        return
    log(f"[profile {label}] wall {wall_ms / reps:.3f} ms, device busy {busy_ms / reps:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in dev) // reps} device activities")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile {label}]   {e.self_device_time_total / 1e3 / reps:9.3f} ms "
            f"x{e.count // reps:<5d} {e.key[:90]}")


def run_general(grid: int, expect_packed: bool, tol: float = 1e-4,
                profile: bool = False) -> dict:
    """The general-mesh main path on a grid x grid cloth forced through the
    arbitrary-mesh contract (the JAX bench's "general" config: z_wave 0.02,
    mass 1e-3, dt 1/60, rhs from seed 0)."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.blockcsr import spmv
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse
    from precond_tpu_torch.parallel.pcg import jacobi_preconditioner, pcg

    t0 = time.perf_counter()
    mesh = cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    ell = cloth.assemble_system(mesh, device=DEVICE)
    n = mesh.num_verts
    b = torch.as_tensor(
        np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32), device=DEVICE
    )
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cfg = SchwarzConfig()
    log(f"[general {grid}] N={n} levels={cfg.num_levels(n)} caps={cfg.level_capacities(n)} "
        f"blocks={cfg.num_blocks(n)} packed={cfg.use_packed_symv(n)} K={ell.max_degree} "
        f"(system built in {host_s:.2f} s)")

    # ---- the counted run: allocate -> prepare -> PCG through the entry points
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    pre = SchwarzPreconditioner(cfg, device=DEVICE)
    pre.allocate(mesh.positions)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pre.prepare(ell)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = pcg(lambda x: spmv(ell, x), pre.apply, b, tol=tol, max_iters=2000)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(_lib.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[general {grid}] launches in the counted run: {counts}")

    true_rel = float(torch.linalg.norm(b - spmv(ell, res.x)) / torch.linalg.norm(b))
    log(f"[general {grid}] schwarz: iters={res.iterations} rel_residual={float(res.rel_residual):.3e} "
        f"true_rel_residual={true_rel:.3e} allocate_ms={1e3 * (t1 - t0):.1f} "
        f"prepare_ms(first)={1e3 * (t2 - t1):.1f} solve_ms={1e3 * (t3 - t2):.1f} "
        f"ms_per_iter={1e3 * (t3 - t2) / max(res.iterations, 1):.3f} peak_mem_gb={peak_gb:.2f}")
    require(res.iterations < 2000 and float(res.rel_residual) <= tol,
            f"general {grid}: Schwarz PCG did not converge")
    require(torch.isfinite(res.x).all().item() and true_rel <= 10 * tol,
            f"general {grid}: solution not finite or true residual {true_rel:.3e} too large")
    require(isinstance(pre.state.inv96, PackedInverse) == expect_packed,
            f"general {grid}: expected packed={expect_packed}")
    require(counts["spd_inverse96"] == 1,
            f"general {grid}: the inverse kernel launched {counts['spd_inverse96']} times in one prepare")
    symv_name = "packed_symv96" if expect_packed else "symv96"
    require(counts[symv_name] >= 1, f"general {grid}: the {symv_name} kernel never launched")

    # ---- steady-state timings of the pieces (outside the counted run)
    prepare_ms = time_ms(lambda: pre.prepare(ell), warmup=0, iters=2)
    apply_ms = time_ms(lambda: pre.apply(b), warmup=2, iters=10)
    spmv_ms = time_ms(lambda: spmv(ell, b), warmup=2, iters=10)
    log(f"[general {grid}] steady: prepare_ms={prepare_ms:.1f} apply_ms={apply_ms:.3f} "
        f"spmv_ms={spmv_ms:.3f}")
    if profile:
        profile_phase(f"general {grid} prepare", lambda: pre.prepare(ell), reps=1)
        # 20 PCG iterations as the solve runs them, host sync included (tol 0
        # never converges, so exactly max_iters iterations run)
        profile_phase(f"general {grid} 20 PCG iterations",
                      lambda: pcg(lambda x: spmv(ell, x), pre.apply, b, tol=0.0, max_iters=20),
                      reps=1)

    # ---- block-Jacobi on the same system
    t0 = time.perf_counter()
    jac = pcg(lambda x: spmv(ell, x), jacobi_preconditioner(ell.diag), b, tol=tol, max_iters=20000)
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    log(f"[general {grid}] jacobi: iters={jac.iterations} rel_residual={float(jac.rel_residual):.3e} "
        f"solve_ms={1e3 * jac_s:.1f} ms_per_iter={1e3 * jac_s / max(jac.iterations, 1):.3f}")
    require(jac.iterations < 20000 and float(jac.rel_residual) <= tol,
            f"general {grid}: Jacobi PCG did not converge")
    rec = JAX_RECORD_ITERS.get(grid)
    if rec:
        log(f"[general {grid}] iterations schwarz/jacobi: port {res.iterations}/{jac.iterations}, "
            f"JAX package record {rec[0]}/{rec[1]} (its bench tests convergence every 8 iterations)")

    # ---- bitwise repeat: a fresh prepare and the apply must match exactly
    pre2 = SchwarzPreconditioner(cfg, device=DEVICE)
    pre2.allocate(mesh.positions)
    pre2.prepare(ell)
    same_state = same_bits(pre.state, pre2.state)
    same_apply = torch.equal(pre.apply(b), pre2.apply(b)) and torch.equal(pre.apply(b), pre.apply(b))
    log(f"[general {grid}] bitwise repeat: prepare={same_state} apply={same_apply}")
    require(same_state and same_apply, f"general {grid}: prepare/apply not bit-reproducible")
    del pre2

    return dict(grid=grid, n=n, pre=pre, ell=ell, counts=counts, iters=res.iterations,
                jacobi_iters=jac.iterations)


def main_path_h96(run: dict):
    """The main path's assembled [B,96,96] blocks (the inverse kernel's input)."""
    from precond_tpu_torch.ops import hierarchy as hi
    from precond_tpu_torch.ops.assembly import assemble_banked_hessian
    from precond_tpu_torch.ops.blockcsr import permute

    pre, ell = run["pre"], run["ell"]
    es = permute(ell, pre.maps.sorted_to_orig, pre.maps.orig_to_sorted)
    hier, mm = hi.build_hierarchy(es.idx, es.mask, pre.cfg_effective, None, with_merge_map=True)
    return assemble_banked_hessian(es, hier, pre.cfg_effective, None, merge_map=mm)


def run_cloth(grid: int, expect_packed: bool, tol: float = 1e-4, profile: bool = False) -> dict:
    """The structured cloth-grid main path at the JAX bench's `cloth` config
    (bench.py:283-317, 518-597): make_grid(grid, grid, z_wave 0.02, mass
    1e-3, dt 1/60), rhs from seed 0, tol 1e-4. assemble_system_grid +
    assemble_system_stencil -> prepare_grid (auto: comp-major) -> PCG on
    [3,N] carries with spmv_t (K4) and the comp-major apply between the cm
    crossings (K2 via packed_symv_cm, or K3 via dense_symv_cm)."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops import gridstencil
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.ops.cuda.packed_symv import DenseInverseCM, PackedInverseCM
    from precond_tpu_torch.ops.gridapply import precondition_grid_cm
    from precond_tpu_torch.parallel.pcg import pcg
    from precond_tpu_torch.solver import prepare_grid
    from precond_tpu_torch.utils import gridmorton as gm

    label = f"cloth {grid}"
    k = grid.bit_length() - 1
    t0 = time.perf_counter()
    mesh = cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    ssys = cloth.assemble_system_stencil(mesh, device=DEVICE)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, device=DEVICE)
    n = mesh.num_verts
    b = torch.as_tensor(
        np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32), device=DEVICE
    )
    bt = b.T.contiguous()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cfg = SchwarzConfig()
    log(f"[{label}] N={n} k={k} levels={cfg.num_levels(n)} blocks={cfg.num_blocks(n)} "
        f"packed={cfg.use_packed_symv(n)} cm={cfg.use_cm(n)} D={len(offsets)} "
        f"(systems built in {host_s:.2f} s)")

    def pre_op_of(inv):
        return lambda r: gm.morton_to_grid_cm(
            precondition_grid_cm(inv, gm.grid_to_morton_cm(r, k), cfg), k)

    def spmv(p):
        return gridstencil.spmv_t(ssys, p)

    # ---- the counted run: prepare_grid -> comp-major PCG
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    inv = prepare_grid(dgr, drr, offsets, k, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pre_op = pre_op_of(inv)
    res = pcg(spmv, pre_op, bt, tol=tol, max_iters=2000)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(_lib.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label}] launches in the counted run: {counts}")

    true_rel = float(torch.linalg.norm(bt - spmv(res.x)) / torch.linalg.norm(bt))
    log(f"[{label}] schwarz: iters={res.iterations} rel_residual={float(res.rel_residual):.3e} "
        f"true_rel_residual={true_rel:.3e} prepare_ms(first)={1e3 * (t1 - t0):.1f} "
        f"solve_ms={1e3 * (t2 - t1):.1f} ms_per_iter={1e3 * (t2 - t1) / max(res.iterations, 1):.3f} "
        f"peak_mem_gb={peak_gb:.2f} (held before the run: {held_gb:.2f})")
    require(res.iterations < 2000 and float(res.rel_residual) <= tol,
            f"{label}: Schwarz PCG did not converge")
    require(torch.isfinite(res.x).all().item() and true_rel <= 10 * tol,
            f"{label}: solution not finite or true residual {true_rel:.3e} too large")
    want = PackedInverseCM if expect_packed else DenseInverseCM
    require(isinstance(inv, want), f"{label}: expected a {want.__name__}, got {type(inv).__name__}")
    symv_name = "packed_symv96" if expect_packed else "symv96"
    require(counts["spd_inverse96"] == 1,
            f"{label}: the inverse kernel launched {counts['spd_inverse96']} times in one prepare")
    require(counts[symv_name] >= res.iterations,
            f"{label}: {symv_name} launched {counts[symv_name]} times in {res.iterations} iterations")
    require(counts["stencil_spmv"] >= res.iterations,
            f"{label}: stencil_spmv launched {counts['stencil_spmv']} times "
            f"in {res.iterations} iterations")

    # ---- steady-state timings of the pieces (outside the counted run)
    prepare_ms = time_ms(lambda: prepare_grid(dgr, drr, offsets, k, cfg), warmup=0, iters=2)
    apply_ms = time_ms(lambda: pre_op(bt), warmup=2, iters=10)
    spmv_ms = time_ms(lambda: spmv(bt), warmup=2, iters=10)
    log(f"[{label}] steady: prepare_ms={prepare_ms:.1f} apply_ms={apply_ms:.3f} "
        f"spmv_ms={spmv_ms:.3f}")
    if profile:
        profile_phase(f"{label} prepare", lambda: prepare_grid(dgr, drr, offsets, k, cfg), reps=1)
        profile_phase(f"{label} 20 PCG iterations",
                      lambda: pcg(spmv, pre_op, bt, tol=0.0, max_iters=20), reps=1)

    # ---- block-Jacobi on the same carries and the same K4 SpMV
    dinv_t = torch.linalg.inv(ssys.diag).permute(1, 2, 0).contiguous()   # [3,3,N]
    t0 = time.perf_counter()
    jac = pcg(spmv, lambda r: (dinv_t * r[None]).sum(dim=1), bt, tol=tol, max_iters=20000)
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    log(f"[{label}] jacobi: iters={jac.iterations} rel_residual={float(jac.rel_residual):.3e} "
        f"solve_ms={1e3 * jac_s:.1f} ms_per_iter={1e3 * jac_s / max(jac.iterations, 1):.3f}")
    require(jac.iterations < 20000 and float(jac.rel_residual) <= tol,
            f"{label}: Jacobi PCG did not converge")
    rec = JAX_RECORD_ITERS_CLOTH.get(grid)
    if rec:
        log(f"[{label}] iterations schwarz/jacobi: port {res.iterations}/{jac.iterations}, "
            f"JAX package record {rec[0]}/{rec[1]} (its bench tests convergence every 8 "
            f"iterations; bands +-{CLOTH_BAND[0]} / +-{CLOTH_BAND[1]})")
        require(abs(res.iterations - rec[0]) <= CLOTH_BAND[0],
                f"{label}: {res.iterations} Schwarz iterations, outside {rec[0]} +- {CLOTH_BAND[0]}")
        require(abs(jac.iterations - rec[1]) <= CLOTH_BAND[1],
                f"{label}: {jac.iterations} Jacobi iterations, outside {rec[1]} +- {CLOTH_BAND[1]}")

    # ---- bitwise repeat: a fresh prepare and the apply must match exactly
    inv2 = prepare_grid(dgr, drr, offsets, k, cfg)
    same_state = same_bits(inv, inv2)
    z = pre_op(bt)
    same_apply = torch.equal(z, pre_op_of(inv2)(bt)) and torch.equal(z, pre_op(bt))
    log(f"[{label}] bitwise repeat: prepare={same_state} apply={same_apply}")
    require(same_state and same_apply, f"{label}: prepare/apply not bit-reproducible")
    del inv2

    return dict(grid=grid, n=n, k=k, cfg=cfg, inv=inv, ssys=ssys, dgr=dgr, drr=drr,
                offsets=offsets, counts=counts, iters=res.iterations, jacobi_iters=jac.iterations)


def run_grid_solve_step(grid: int, tol: float = 1e-4) -> dict:
    """parallel.gridsharded.grid_solve_step on the cloth config: prepare_grid
    pinned to dense + rows, grid-order PCG with K4 behind the row-major
    spmv and K3 behind the row-major grid apply."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.parallel.gridsharded import grid_solve_step

    label = f"grid_solve_step {grid}"
    k = grid.bit_length() - 1
    mesh = cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    ssys = cloth.assemble_system_stencil(mesh, device=DEVICE)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, device=DEVICE)
    b = torch.as_tensor(
        np.random.default_rng(0).standard_normal((mesh.num_verts, 3)).astype(np.float32),
        device=DEVICE)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = grid_solve_step(ssys, dgr, drr, b, offsets, k, SchwarzConfig(), tol=tol, max_iters=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_lib.launch_counts)
    from precond_tpu_torch.ops import gridstencil

    true_rel = float(torch.linalg.norm(b - gridstencil.spmv(ssys, res.x)) / torch.linalg.norm(b))
    log(f"[{label}] iters={res.iterations} rel_residual={float(res.rel_residual):.3e} "
        f"true_rel_residual={true_rel:.3e} wall_ms={1e3 * wall:.1f} launches={counts}")
    require(float(res.rel_residual) <= tol and true_rel <= 10 * tol,
            f"{label}: did not converge")
    require(counts["spd_inverse96"] == 1 and counts["symv96"] >= res.iterations
            and counts["stencil_spmv"] >= res.iterations,
            f"{label}: a kernel of the path was not launched every iteration")
    return dict(counts=counts, iters=res.iterations)


def folded_sheet(grid: int):
    """The JAX bench's `collide` sheet (bench.py:220-227): a grid x grid cloth,
    z_wave 0, mass 1e-3, dt 1/60, the right half folded onto the left at a
    gap of 0.5 h. Returns (mesh, positions f32[N,3], h)."""
    import numpy as np
    from precond_tpu_torch.models import cloth

    mesh = cloth.make_grid(grid, grid, z_wave=0.0, mass=0.001, dt=1.0 / 60.0)
    h = 1.0 / max(grid - 1, 1)
    p = np.asarray(mesh.positions).copy()
    fold = p[:, 0] > 0.5
    p[:, 2] = np.where(fold, 0.5 * h, 0.0)
    p[:, 0] = np.where(fold, 1.0 - p[:, 0], p[:, 0])
    return mesh, p.astype(np.float32), h


def detect_collide(pos, faces, edges, h: float):
    """The bench's detection recipe (bench.py:248-270) on the tensors' device:
    VF/EE/EF at threshold 0.75 h, stiffness 1e3, a budget of n // 4 per set
    and a cap of 2, then build_stencils with the valid stencils kept (one
    host read) and padded to a multiple of 8. Returns (sets, infos, stencils,
    live count)."""
    import torch
    from precond_tpu_torch.models import collision as coll
    from precond_tpu_torch.ops.stencils import build_stencils

    n = pos.shape[0]
    kw = dict(threshold=0.75 * h, stiffness=1e3, max_pairs=n // 4)
    vf, i1 = coll.detect_vf_grid(pos, faces, per_vertex_cap=2, **kw)
    ee, i2 = coll.detect_ee_grid(pos, edges, per_edge_cap=2, **kw)
    ef, i3 = coll.detect_ef_grid(pos, edges, faces, per_edge_cap=2, **kw)
    st = build_stencils(edges, faces, ef=ef, ee=ee, vf=vf)
    keep = torch.nonzero(st.valid).reshape(-1)
    live = keep.numel()
    keep = torch.cat([keep, keep.new_zeros((-live) % 8)])
    st = type(st)(*(f[keep] for f in st))
    st.valid[live:] = False
    return (vf, ee, ef), (i1, i2, i3), st, live


def collide_system(pre, ell, st):
    """The solve's operator in sorted space: the sorted block-ELL, the
    stencils with ids mapped into sorted space (as ClothSim's general branch
    maps them, precond_tpu/models/simulator.py:628-633) and their contact
    slots, built once per prepare."""
    import torch
    from precond_tpu_torch.ops.blockcsr import permute
    from precond_tpu_torch.ops.contact import build_contact_slots

    n = ell.num_verts
    ells = permute(ell, pre.maps.sorted_to_orig, pre.maps.orig_to_sorted)
    mapped = st._replace(idx=pre.maps.orig_to_sorted[torch.clamp(st.idx, 0, n - 1).long()])
    return ells, mapped, build_contact_slots(mapped, n)


def collide_h96(pre, ell, st):
    """The collide prepare's assembled [B,96,96] blocks (K1's input)."""
    from precond_tpu_torch.ops import hierarchy as hi
    from precond_tpu_torch.ops.assembly import assemble_banked_hessian
    from precond_tpu_torch.ops.blockcsr import permute
    from precond_tpu_torch.ops.stencils import collision_terms, map_stencils, stencil_pairs

    es = permute(ell, pre.maps.sorted_to_orig, pre.maps.orig_to_sorted)
    mapped = map_stencils(st, pre.maps.orig_to_sorted)
    hier, mm = hi.build_hierarchy(es.idx, es.mask, pre.cfg_effective, stencil_pairs(mapped),
                                  with_merge_map=True)
    return assemble_banked_hessian(es, hier, pre.cfg_effective, collision_terms(mapped),
                                   merge_map=mm)


def run_collide(grid: int, tol: float = 1e-4, profile: bool = False) -> dict:
    """Contact on the general-mesh path, on the JAX bench's collide sheet:
    detection on the card -> stencils -> SchwarzPreconditioner(coarse_damping
    0.25).allocate / prepare(ell, stencils) -> PCG in sorted space on the
    block-ELL SpMV plus the slot contact SpMV (K1 once per prepare, K3 per
    apply), against block-Jacobi with the contact diagonal on the same
    operator."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.apply import precondition_sorted
    from precond_tpu_torch.ops.blockcsr import spmv as ell_spmv
    from precond_tpu_torch.ops.contact import contact_diag, slot_contact_spmv
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.parallel.pcg import jacobi_preconditioner, pcg

    label = f"collide {grid}"
    t0 = time.perf_counter()
    mesh, folded, h = folded_sheet(grid)
    n = mesh.num_verts
    ell = cloth.assemble_system(mesh, positions=folded, device=DEVICE)
    pos = torch.as_tensor(folded, device=DEVICE)
    faces = torch.as_tensor(mesh.faces, device=DEVICE)
    edges = torch.as_tensor(mesh.edges, device=DEVICE)
    b = torch.as_tensor(
        np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32), device=DEVICE)
    torch.cuda.synchronize()
    cfg = SchwarzConfig(coarse_damping=0.25)
    log(f"[{label}] N={n} levels={cfg.num_levels(n)} blocks={cfg.num_blocks(n)} "
        f"packed={cfg.use_packed_symv(n)} K={ell.max_degree} "
        f"(system built in {time.perf_counter() - t0:.2f} s)")

    # ---- the counted run: detect -> stencils -> allocate -> prepare -> PCG
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    sets, infos, st, live = detect_collide(pos, faces, edges, h)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peaks = [torch.cuda.max_memory_allocated() / 1e9]
    torch.cuda.reset_peak_memory_stats()
    pre = SchwarzPreconditioner(cfg, device=DEVICE)
    pre.allocate(folded)
    pre.prepare(ell, st)
    ells, mapped, slots = collide_system(pre, ell, st)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.reset_peak_memory_stats()

    def spmv(x):
        return ell_spmv(ells, x) + slot_contact_spmv(mapped, slots, x)

    def apply(r):
        return precondition_sorted(pre.state, r, pre.cfg_effective)

    bs = b[pre.maps.sorted_to_orig.long()]
    res = pcg(spmv, apply, bs, tol=tol, max_iters=2000)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(_lib.launch_counts)
    peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    peak_gb = max(peaks)
    log(f"[{label}] launches in the counted run: {counts}")

    nlive = [int((s[0] >= 0).sum()) for s in sets]
    truncated = [bool(i.truncated) for i in infos]
    dropped = [int(i.dropped) for i in infos]
    log(f"[{label}] sets: live VF/EE/EF {nlive[0]}/{nlive[1]}/{nlive[2]}, live stencils {live} "
        f"(JAX record {JAX_RECORD_COLLIDE[grid][2]}; BASELINE.md:51 ~49k for the JAX static "
        f"build); truncated {truncated}, dropped {dropped}; stencil slots {st.count}")
    true_rel = float(torch.linalg.norm(bs - spmv(res.x)) / torch.linalg.norm(bs))
    log(f"[{label}] schwarz: iters={res.iterations} rel_residual={float(res.rel_residual):.3e} "
        f"true_rel_residual={true_rel:.3e} detect_ms(first)={1e3 * (t1 - t0):.1f} "
        f"prepare_ms(first, with slots)={1e3 * (t2 - t1):.1f} solve_ms={1e3 * (t3 - t2):.1f} "
        f"ms_per_iter={1e3 * (t3 - t2) / max(res.iterations, 1):.3f} peak_mem_gb={peak_gb:.2f} "
        f"(detection {peaks[0]:.2f}, prepare {peaks[1]:.2f}, PCG {peaks[2]:.2f}; held before "
        f"the run: {held_gb:.2f})")
    require(live > 0, f"{label}: no live stencils")
    require(res.iterations < 2000 and float(res.rel_residual) <= tol,
            f"{label}: Schwarz PCG did not converge")
    require(torch.isfinite(res.x).all().item() and true_rel <= 10 * tol,
            f"{label}: solution not finite or true residual {true_rel:.3e} too large")
    require(isinstance(pre.state.inv96, torch.Tensor) and not cfg.use_packed_symv(n),
            f"{label}: expected the dense inverse")
    require(counts["spd_inverse96"] == 1,
            f"{label}: the inverse kernel launched {counts['spd_inverse96']} times in one prepare")
    require(counts["symv96"] >= res.iterations,
            f"{label}: symv96 launched {counts['symv96']} times in {res.iterations} iterations")

    # ---- block-Jacobi on the same operator, with the contact diagonal
    t0 = time.perf_counter()
    jac = pcg(spmv, jacobi_preconditioner(ells.diag + contact_diag(mapped, n)), bs, tol=tol,
              max_iters=20000)
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    log(f"[{label}] jacobi: iters={jac.iterations} rel_residual={float(jac.rel_residual):.3e} "
        f"solve_ms={1e3 * jac_s:.1f} ms_per_iter={1e3 * jac_s / max(jac.iterations, 1):.3f}")
    require(jac.iterations < 20000 and float(jac.rel_residual) <= tol,
            f"{label}: Jacobi PCG did not converge")
    rec_s, rec_j, _ = JAX_RECORD_COLLIDE[grid]
    band_s, band_j = COLLIDE_BAND
    log(f"[{label}] iterations schwarz/jacobi: port {res.iterations}/{jac.iterations}, JAX "
        f"package record {rec_s}/{rec_j} (scripts/jax_collide_general_record.py; bands "
        f"+-{100 * band_s:.0f}% / +-{100 * band_j:.0f}%)")
    require(abs(res.iterations - rec_s) <= band_s * rec_s,
            f"{label}: {res.iterations} Schwarz iterations, outside {rec_s} +- {100 * band_s:.0f}%")
    require(abs(jac.iterations - rec_j) <= band_j * rec_j,
            f"{label}: {jac.iterations} Jacobi iterations, outside {rec_j} +- {100 * band_j:.0f}%")
    require(res.iterations < jac.iterations, f"{label}: Schwarz is not ahead of Jacobi")

    # ---- bitwise repeats: detection (every set field), prepare, apply, contact SpMV
    sets2, infos2, st2, _ = detect_collide(pos, faces, edges, h)
    same_detect = same_bits(sets, sets2) and same_bits(infos, infos2) and same_bits(st, st2)
    pre2 = SchwarzPreconditioner(cfg, device=DEVICE)
    pre2.allocate(folded)
    pre2.prepare(ell, st2)
    same_state = same_bits(pre.state, pre2.state)
    z = apply(bs)
    same_apply = torch.equal(z, precondition_sorted(pre2.state, bs, cfg)) and torch.equal(z, apply(bs))
    _, mapped2, slots2 = collide_system(pre2, ell, st2)
    yc = slot_contact_spmv(mapped, slots, bs)
    same_contact = (same_bits(slots, slots2) and torch.equal(yc, slot_contact_spmv(mapped2, slots2, bs))
                    and torch.equal(yc, slot_contact_spmv(mapped, slots, bs)))
    log(f"[{label}] bitwise repeat: detection={same_detect} prepare={same_state} "
        f"apply={same_apply} contact_spmv={same_contact}")
    require(same_detect and same_state and same_apply and same_contact,
            f"{label}: detection/prepare/apply/contact SpMV not bit-reproducible")
    del pre2, sets2, st2, slots2, mapped2

    # ---- steady-state timings of the pieces (outside the counted run)
    detect_ms = time_ms(lambda: detect_collide(pos, faces, edges, h), warmup=1, iters=3)
    prepare_ms = time_ms(lambda: pre.prepare(ell, st), warmup=0, iters=3)
    slots_ms = time_ms(lambda: collide_system(pre, ell, st), warmup=1, iters=3)
    apply_ms = time_ms(lambda: apply(bs), warmup=2, iters=10)
    spmv_ms = time_ms(lambda: spmv(bs), warmup=2, iters=10)
    contact_ms = time_ms(lambda: slot_contact_spmv(mapped, slots, bs), warmup=2, iters=10)
    iter_ms = time_ms(lambda: pcg(spmv, apply, bs, tol=0.0, max_iters=20), warmup=1, iters=2) / 20
    log(f"[{label}] steady: detect_ms={detect_ms:.2f} prepare_ms={prepare_ms:.1f} "
        f"slots_ms={slots_ms:.2f} apply_ms={apply_ms:.3f} spmv_ms={spmv_ms:.3f} "
        f"(contact part {contact_ms:.3f}) ms_per_iter={iter_ms:.3f} "
        f"solve_wall_ms={prepare_ms + slots_ms + res.iterations * iter_ms:.1f}")
    if profile:
        profile_phase(f"{label} detection", lambda: detect_collide(pos, faces, edges, h), reps=1)
        profile_phase(f"{label} prepare", lambda: pre.prepare(ell, st), reps=1)
        profile_phase(f"{label} 20 PCG iterations",
                      lambda: pcg(spmv, apply, bs, tol=0.0, max_iters=20), reps=1)
    return dict(grid=grid, n=n, pre=pre, ell=ell, st=st, counts=counts, iters=res.iterations,
                jacobi_iters=jac.iterations, live=live)


# ---------------------------------------------------------------------------
# small-input references
# ---------------------------------------------------------------------------

def check_references() -> None:
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.blockcsr import to_dense
    from precond_tpu_torch.parallel.sharded import solve_step

    # one bank (32 vertices, one level): M^-1 is H^-1 exactly
    mesh = cloth.make_grid(4, 8, z_wave=0.02)
    ell = cloth.assemble_system(mesh, device=DEVICE)
    r = torch.as_tensor(np.random.default_rng(1).standard_normal((32, 3)).astype(np.float32),
                        device=DEVICE)
    pre = SchwarzPreconditioner(SchwarzConfig(), device=DEVICE)
    pre.allocate(mesh.positions)
    pre.prepare(ell)
    z = pre.apply(r).double()
    ref = torch.linalg.solve(to_dense(ell).double(), r.double().reshape(-1)).reshape(-1, 3)
    err = float((z - ref).abs().max() / ref.abs().max())
    log(f"[reference] one-bank apply vs dense f64 solve: rel err {err:.2e} (tol 1e-4)")
    require(err < 1e-4, "one-bank apply disagrees with the dense solve")

    # the card against the plain versions on the CPU, whole slice, 32x32
    mesh = cloth.make_grid(32, 32, z_wave=0.02)
    rn = np.random.default_rng(4).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    for symv in ("dense", "packed"):
        cfg = SchwarzConfig(symv_kernel=symv, packed_symv_block_b=128)
        out = {}
        for dev in ("cpu", DEVICE):
            pre = SchwarzPreconditioner(cfg, device=dev)
            pre.allocate(mesh.positions)
            pre.prepare(cloth.assemble_system(mesh, device=dev))
            out[dev] = pre.apply(rn).cpu()
        scale = float(out["cpu"].abs().max())
        err = float((out[DEVICE] - out["cpu"]).abs().max())
        ok = bool(torch.allclose(out[DEVICE], out["cpu"], rtol=1e-5, atol=1e-6 * scale))
        log(f"[reference] 32x32 {symv}: card vs CPU plain max abs err {err:.2e} "
            f"(rtol 1e-5, atol 1e-6*max|z| = {1e-6 * scale:.2e}) ok={ok}")
        require(ok, f"32x32 {symv} apply: card and CPU disagree")

    # the single-device solve step (the JAX entry() problem)
    mesh = cloth.make_grid(32, 32, z_wave=0.02)
    iters = {}
    for dev in ("cpu", DEVICE):
        from precond_tpu_torch.solver import compute_sort_maps

        ell = cloth.assemble_system(mesh, device=dev)
        maps = compute_sort_maps(torch.as_tensor(mesh.positions, device=dev))
        res = solve_step(ell, maps, rn, SchwarzConfig(), tol=1e-4, max_iters=100, device=dev)
        require(float(res.rel_residual) <= 1e-4, f"solve_step on {dev} did not converge")
        iters[dev] = res.iterations
    log(f"[reference] solve_step 32x32 iterations: cpu {iters['cpu']} card {iters[DEVICE]}")
    require(abs(iters["cpu"] - iters[DEVICE]) <= 2, "solve_step iterations differ card vs CPU")


def check_collide_references(grid: int = 64) -> None:
    """The collide path on a grid x grid fold on the card against the same
    path on the CPU (plain versions): the stencils as sets, the assembled
    h96 at check_references' tolerance, and the iteration counts."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.apply import precondition_sorted
    from precond_tpu_torch.ops.blockcsr import spmv as ell_spmv
    from precond_tpu_torch.ops.contact import slot_contact_spmv
    from precond_tpu_torch.parallel.pcg import pcg

    mesh, folded, h = folded_sheet(grid)
    n = mesh.num_verts
    b = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", DEVICE):
        pos, faces, edges = (torch.as_tensor(a, device=dev) for a in (folded, mesh.faces, mesh.edges))
        _, _, st, live = detect_collide(pos, faces, edges, h)
        ell = cloth.assemble_system(mesh, positions=folded, device=dev)
        pre = SchwarzPreconditioner(SchwarzConfig(coarse_damping=0.25), device=dev)
        pre.allocate(folded)
        pre.prepare(ell, st)
        ells, mapped, slots = collide_system(pre, ell, st)
        bs = torch.as_tensor(b, device=dev)[pre.maps.sorted_to_orig.long()]
        res = pcg(lambda x: ell_spmv(ells, x) + slot_contact_spmv(mapped, slots, x),
                  lambda r: precondition_sorted(pre.state, r, pre.cfg_effective), bs, tol=1e-4,
                  max_iters=2000)
        require(float(res.rel_residual) <= 1e-4, f"collide {grid} on {dev} did not converge")
        rows = torch.cat([st.idx, st.nverts[:, None], st.valid[:, None].to(st.idx.dtype)], dim=1)
        out[dev] = dict(stencils={tuple(r) for r in rows.cpu().tolist()}, live=live,
                        h96=collide_h96(pre, ell, st).cpu(), iters=res.iterations)
    cpu, card = out["cpu"], out[DEVICE]
    same_sets = cpu["stencils"] == card["stencils"] and cpu["live"] == card["live"]
    scale = float(cpu["h96"].abs().max())
    err = float((card["h96"] - cpu["h96"]).abs().max())
    ok = bool(torch.allclose(card["h96"], cpu["h96"], rtol=1e-5, atol=1e-6 * scale))
    log(f"[reference] collide {grid}: stencils equal as sets={same_sets} (live {card['live']}); "
        f"h96 card vs CPU max abs err {err:.2e} (rtol 1e-5, atol 1e-6*max|h| = {1e-6 * scale:.2e}) "
        f"ok={ok}; iterations cpu {cpu['iters']} card {card['iters']}")
    require(same_sets, f"collide {grid}: the card's stencils differ from the CPU's")
    require(ok, f"collide {grid}: the card's h96 disagrees with the CPU's")
    require(abs(cpu["iters"] - card["iters"]) <= 2, f"collide {grid}: iterations differ card vs CPU")


def check_grid_references() -> None:
    """The grid path on the card against the CPU plain versions (32x32, the
    three apply forms), and the analytic-hierarchy general prepare against
    prepare_grid on the card (64x64, tests/test_gridprep.py:92-125)."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.gridapply import precondition_grid, precondition_grid_cm
    from precond_tpu_torch.solver import SortMaps, prepare_grid, prepare_with_system
    from precond_tpu_torch.utils import gridmorton as gm

    mesh = cloth.make_grid(32, 32, z_wave=0.02)
    rn = np.random.default_rng(4).standard_normal((mesh.num_verts, 3)).astype(np.float32)
    forms = {
        "cm packed": SchwarzConfig(symv_kernel="packed", packed_symv_block_b=128),
        "cm dense": SchwarzConfig(),
        "rows dense": SchwarzConfig(symv_kernel="dense", solve_layout="rows"),
    }
    for name, cfg in forms.items():
        out = {}
        for dev in ("cpu", DEVICE):
            dg, dr, off = cloth.assemble_system_grid(mesh, device=dev)
            inv = prepare_grid(dg, dr, off, 5, cfg)
            r = torch.as_tensor(rn, device=dev)
            if cfg.solve_layout == "rows":
                z = gm.morton_to_grid(precondition_grid(inv, gm.grid_to_morton(r, 5), cfg), 5)
            else:
                z = gm.morton_to_grid_cm(
                    precondition_grid_cm(inv, gm.grid_to_morton_cm(r.T.contiguous(), 5), cfg), 5).T
            out[dev] = z.cpu()
        scale = float(out["cpu"].abs().max())
        err = float((out[DEVICE] - out["cpu"]).abs().max())
        ok = bool(torch.allclose(out[DEVICE], out["cpu"], rtol=1e-5, atol=1e-6 * scale))
        log(f"[reference] 32x32 grid {name}: card vs CPU plain max abs err {err:.2e} "
            f"(rtol 1e-5, atol 1e-6*max|z| = {1e-6 * scale:.2e}) ok={ok}")
        require(ok, f"32x32 grid {name} apply: card and CPU disagree")

    g, k = 64, 6
    mesh = cloth.make_grid(g, g, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    cfg = SchwarzConfig(symv_kernel="dense", solve_layout="rows")
    s2o, o2s = gm.sort_maps(k)
    maps = SortMaps(torch.as_tensor(s2o, device=DEVICE), torch.as_tensor(o2s, device=DEVICE))
    state, _ = prepare_with_system(cloth.assemble_system(mesh, device=DEVICE), maps, cfg,
                                   analytic_hier=True)
    dg, dr, off = cloth.assemble_system_grid(mesh, device=DEVICE)
    inv = prepare_grid(dg, dr, off, k, cfg)
    err = float((state.inv96 - inv).abs().max())
    ok = bool(torch.allclose(state.inv96, inv, rtol=2e-4, atol=1e-5))
    log(f"[reference] 64x64 prepare_with_system(analytic_hier=True) vs prepare_grid: "
        f"max abs err {err:.2e} (rtol 2e-4, atol 1e-5) ok={ok}")
    require(ok, "the analytic-hierarchy prepare disagrees with prepare_grid")


# ---------------------------------------------------------------------------
# kernels against their plain versions, at the main path's shapes
# ---------------------------------------------------------------------------

def _record(name, source, replaces, launches_by_path, path, max_abs, ms, plain_ms, bound,
            library_ms, **extra) -> dict:
    bms, by = bound
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches_by_path[path], max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms, shapes_of=path,
                launches_by_path=launches_by_path, **extra)


def check_spd_inverse_blocks(h96, label: str) -> float:
    """K1 on a main path's assembled blocks, per block (returns max abs err)."""
    import torch
    from precond_tpu_torch.ops.batched_inverse import invert_spd_blocks_panel
    from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse

    got = spd_inverse(h96, repair=False)
    plain = invert_spd_blocks_panel(h96, repair=False)
    truth = torch.linalg.inv(h96.double())
    max_abs = float((got - plain).abs().max())

    # Error of each block relative to that block's own max|inverse|, so the
    # small inverses of the coarse blocks and the identity-filled padding
    # blocks are held as tightly as the large ones. The blocks reach cond
    # ~1e7 and the f32 plain version itself reads ~2e-4 per block against
    # f64 (general 256 on the CPU); 1e-3 leaves 5x room over that.
    def per_block(x, ref):
        scale = ref.abs().amax(dim=(1, 2))
        return float(((x.double() - ref).abs().amax(dim=(1, 2)) / scale).max())

    err_kp = per_block(got, plain.double())
    err_k, err_p = per_block(got, truth), per_block(plain, truth)
    sym = torch.equal(got, got.transpose(1, 2))
    log(f"[K1 spd_inverse] {label} h96 B={h96.shape[0]}: kernel vs plain max abs {max_abs:.3e}, "
        f"per-block rel {err_kp:.2e}; per-block rel vs f64: kernel {err_k:.2e} plain {err_p:.2e} "
        f"(tol 1e-3 per block); bitwise symmetric={sym}")
    require(torch.isfinite(got).all().item() and sym and err_k < 1e-3 and err_kp < 1e-3,
            f"K1 disagrees on the {label} blocks")
    return max_abs


def ptxas_facts(kernel: str) -> str:
    """The registers and spills ptxas reported for `kernel` in the build log."""
    from precond_tpu_torch.ops.cuda import _lib

    log_ = _lib.build_info["log"]
    at = log_.find(kernel)
    lines = log_[at:].splitlines()[1:4] if at >= 0 else []
    return "; ".join(ln.replace("ptxas info    :", "").strip() for ln in lines
                     if "registers" in ln or "spill" in ln)


def k1_resources() -> str:
    """K1's registers and spills from the ptxas log of the build, and its
    dynamic shared memory per block and blocks per SM from the CUDA runtime."""
    from precond_tpu_torch.ops.cuda.spd_inverse import occupancy

    facts = ptxas_facts("spd_inverse96_kernel")
    smem, blocks = occupancy()
    return (f"ptxas: {facts or 'no entry in the build log'}; dynamic shared memory {smem} B "
            f"per thread block, {blocks} blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")


def kernel_spd_inverse(h96, launches_by_path: dict, path: str, small_h96, small_path: str) -> dict:
    import numpy as np
    import torch
    from precond_tpu_torch.ops.batched_inverse import invert_spd_blocks_panel
    from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse

    bsz = h96.shape[0]
    max_abs = check_spd_inverse_blocks(h96, path)

    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((4096, 96, 96)).astype(np.float32), device=DEVICE)
    spd = torch.bmm(q, q.transpose(1, 2)) + 96 * torch.eye(96, device=DEVICE)
    err = float((spd_inverse(spd) - invert_spd_blocks_panel(spd)).abs().max()
                / invert_spd_blocks_panel(spd).abs().max())
    log(f"[K1 spd_inverse] random SPD B=4096: kernel vs plain rel {err:.2e} (tol 1e-5)")
    require(err < 1e-5, "K1 disagrees on random SPD blocks")
    del q, spd

    # the cond ~1e7 batch of tests/test_pallas_chol.py:30-47, exactly
    srng = np.random.default_rng(1)
    d = np.exp(srng.uniform(0, 16, size=(4, 96))).astype(np.float32)
    qq, _ = np.linalg.qr(srng.standard_normal((4, 96, 96)))
    stiff = np.einsum("bik,bk,bjk->bij", qq, d, qq).astype(np.float32)
    stiff = torch.as_tensor(0.5 * (stiff + np.swapaxes(stiff, 1, 2)), device=DEVICE)
    inv = spd_inverse(stiff)
    ref = torch.linalg.inv(stiff.double())
    rel = float((inv.double() - ref).abs().max() / ref.abs().max())
    mineig = float(torch.linalg.eigvalsh(inv.double()).min())
    log(f"[K1 spd_inverse] cond~1e7 B=4: rel err vs f64 {rel:.2e} (tol 3e-2) min eig {mineig:.3e} (>0)")
    require(rel < 3e-2 and mineig > 0, "K1 fails the stiff PSD check")

    # the main-path call repairs inside the kernel (one launch)
    o1, o2 = spd_inverse(h96), spd_inverse(h96)
    same = torch.equal(o1, o2)
    log(f"[K1 spd_inverse] {path} B={bsz}: two launches (repair=True) bitwise equal={same}")
    require(same, "K1 is not bitwise repeatable from launch to launch")
    del o1, o2

    ms = time_ms(lambda: spd_inverse(h96), warmup=2, iters=10)
    ms_no_repair = time_ms(lambda: spd_inverse(h96, repair=False), warmup=2, iters=10)
    plain_ms = time_ms(lambda: invert_spd_blocks_panel(h96), warmup=1, iters=3)
    lib_ms = time_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(h96)), warmup=1, iters=2)

    # an SPD inverse does ~n^3 flop (Cholesky, triangular inverse and the
    # L^T L product, n^3/3 each), so the bytes bound it
    def k1_bound(b):
        return bound_ms(2 * b * 96 * 96 * 4, b * 96 ** 3)

    bound = k1_bound(bsz)
    log(f"[K1 spd_inverse] {path} B={bsz}: kernel {ms:.3f} ms (repair=True, the main-path call), "
        f"{ms_no_repair:.3f} ms (repair=False); plain {plain_ms:.3f} ms, "
        f"cholesky+cholesky_inverse {lib_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]})")
    log(f"[K1 spd_inverse] {path} B={bsz}: {100 * bound[0] / ms:.1f}% of the bound (repair=True), "
        f"{100 * bound[0] / ms_no_repair:.1f}% (repair=False)")

    sb = small_h96.shape[0]
    check_spd_inverse_blocks(small_h96, small_path)
    ms_small = time_ms(lambda: spd_inverse(small_h96), warmup=5, iters=50)
    ms_small_no_repair = time_ms(lambda: spd_inverse(small_h96, repair=False), warmup=5, iters=50)
    bound_small = k1_bound(sb)
    log(f"[K1 spd_inverse] {small_path} B={sb}: kernel {ms_small:.4f} ms (repair=True), "
        f"{ms_small_no_repair:.4f} ms (repair=False), bound {bound_small[0]:.4f} ms "
        f"({100 * bound_small[0] / ms_small:.1f}%)")
    log(f"[K1 spd_inverse] {k1_resources()}")
    return _record("spd_inverse96", "precond_tpu_torch/csrc/spd_inverse.cu",
                   "precond_tpu/ops/pallas/chol_inverse.py:194", launches_by_path, path,
                   max_abs, ms, plain_ms, bound, lib_ms, ms_no_repair=ms_no_repair,
                   ms_by_path={path: ms, small_path: ms_small},
                   ms_no_repair_by_path={path: ms_no_repair, small_path: ms_small_no_repair},
                   bound_ms_by_path={path: bound[0], small_path: bound_small[0]})


def _packed_ok(got, plain, label: str) -> float:
    scale = float(plain.abs().max())
    max_abs = float((got - plain).abs().max())
    ok = bool(((got - plain).abs() <= 2e-5 * plain.abs() + 2e-5 * scale).all())
    log(f"[K2 packed_symv] {label}: max abs {max_abs:.3e} "
        f"(tol 2e-5*|z| + 2e-5*max|z| = {2e-5 * scale:.3e}) ok={ok}")
    require(ok, f"K2 disagrees: {label}")
    return max_abs


def check_packed_symv_table(packed, label: str) -> float:
    """K2 (row-major entry) on a main path's packed table vs its plain version."""
    import numpy as np
    import torch
    from precond_tpu_torch.ops.cuda.packed_symv import packed_symv_ref, packed_symv_t

    bp = packed.f.shape[2]
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((96, bp)).astype(np.float32),
                        device=DEVICE)
    return _packed_ok(packed_symv_t(packed, x), packed_symv_ref(packed, x.T).T,
                      f"{label} inverse Bp={bp}, kernel vs plain")


def k2_resources() -> str:
    """K2's registers and spills from the ptxas log of the build, and its
    dynamic shared memory per thread block from the source's stage count
    (the kernel has no static shared memory for ptxas to report)."""
    import re

    from precond_tpu_torch.ops.cuda import _lib

    facts = ptxas_facts("packed_symv96_kernel")
    with open(os.path.join(_lib._CSRC, "packed_symv.cu")) as f:
        stages = int(re.search(r"constexpr int STAGES = (\d+);", f.read()).group(1))
    smem = (stages + 4) * 96 * 32 * 4 + (2 * stages + 4) * 8
    return (f"ptxas: {facts or 'no entry in the build log'}; dynamic shared memory "
            f"{smem} B per thread block ({stages} F stages + x and dg double-buffered, "
            f"boxes of 12,288 B, and {2 * stages + 4} mbarriers)")


def kernel_packed_symv_cm(run: dict, inv96, launches_by_path: dict, path: str) -> dict:
    """K2 through packed_symv_cm at the comp-major table of `run`, against
    packed_symv_ref on the same table (rhs laid out as packed_symv_cm lays
    it out) and the dense row-major apply of the unpermuted inverse."""
    import numpy as np
    import torch
    from precond_tpu_torch.ops.batched_inverse import apply_block_inverse
    from precond_tpu_torch.ops.cuda.packed_symv import (
        packed_symv_cm, packed_symv_ref, packed_symv_t, unpack_sym96)

    packed = run["inv"]
    nb, bp = packed.nb, packed.f.shape[2]
    rs3 = torch.as_tensor(np.random.default_rng(2).standard_normal((3, nb, 32)).astype(np.float32),
                          device=DEVICE)
    got = packed_symv_cm(packed, rs3)
    rhs_cm = rs3.permute(1, 0, 2).reshape(nb, 96)                   # DOF c*32+l
    plain = packed_symv_ref(packed, rhs_cm).reshape(nb, 3, 32).permute(1, 0, 2)
    max_abs = _packed_ok(got, plain, f"{path} comp-major table B={nb} Bp={bp}, "
                         "packed_symv_cm vs packed_symv_ref")
    rows = apply_block_inverse(inv96, rs3.permute(1, 2, 0).reshape(nb, 96))   # DOF l*3+c
    _packed_ok(got, rows.reshape(nb, 32, 3).permute(2, 0, 1),
               f"{path} packed_symv_cm vs the dense row-major apply of the unpermuted inverse")

    xt = rs3.new_zeros((96, bp))
    xt[:, :nb] = rs3.permute(0, 2, 1).reshape(96, nb)
    dense = unpack_sym96(packed, bp)
    xb = xt.T.contiguous()[:, :, None]
    ms = time_ms(lambda: packed_symv_t(packed, xt), warmup=5, iters=50)
    plain_ms = time_ms(lambda: packed_symv_ref(packed, rhs_cm), warmup=1, iters=5)
    lib_ms = time_ms(lambda: torch.bmm(dense, xb), warmup=3, iters=20)
    nbytes = (48 * 96 + 3 * 96) * 4 * bp
    bound = bound_ms(nbytes, 18432 * bp)
    log(f"[K2 packed_symv] {path} Bp={bp}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.bmm on the dense table {lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    log(f"[K2 packed_symv] {path} Bp={bp}: {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved, "
        f"{100 * bound[0] / ms:.1f}% of the bound")
    log(f"[K2 packed_symv] {k2_resources()}")
    z1, z2 = packed_symv_t(packed, xt), packed_symv_t(packed, xt)
    same = torch.equal(z1, z2)
    log(f"[K2 packed_symv] {path} Bp={bp}: two launches bitwise equal={same}")
    require(same, "K2 is not bitwise repeatable from launch to launch")
    return _record("packed_symv96", "precond_tpu_torch/csrc/packed_symv.cu",
                   "precond_tpu/ops/pallas/packed_symv.py:148", launches_by_path, path,
                   max_abs, ms, plain_ms, bound, lib_ms)


def check_symv(inv96, label: str):
    import numpy as np
    import torch
    from precond_tpu_torch.ops.batched_inverse import apply_block_inverse
    from precond_tpu_torch.ops.cuda.symv import batched_symv

    bsz = inv96.shape[0]
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal((bsz, 96)).astype(np.float32),
                          device=DEVICE)
    got = batched_symv(inv96, rhs)
    plain = apply_block_inverse(inv96, rhs)
    scale = float(plain.abs().max())
    max_abs = float((got - plain).abs().max())
    ok = bool(((got - plain).abs() <= 1e-5 * plain.abs() + 1e-5 * scale).all())
    log(f"[K3 symv] {label} inverse B={bsz}: kernel vs plain max abs {max_abs:.3e} "
        f"(tol 1e-5*|z| + 1e-5*max|z| = {1e-5 * scale:.3e}) ok={ok}")
    require(ok, f"K3 disagrees with its plain version on the {label} table")
    return max_abs, rhs


def kernel_symv(inv96, launches_by_path: dict, path: str) -> dict:
    import torch
    from precond_tpu_torch.ops.batched_inverse import apply_block_inverse
    from precond_tpu_torch.ops.cuda.symv import batched_symv

    bsz = inv96.shape[0]
    max_abs, rhs = check_symv(inv96, path)
    r3 = rhs[:, :, None]
    ms = time_ms(lambda: batched_symv(inv96, rhs), warmup=10, iters=200)
    plain_ms = time_ms(lambda: apply_block_inverse(inv96, rhs), warmup=10, iters=200)
    lib_ms = time_ms(lambda: torch.bmm(inv96, r3), warmup=10, iters=200)
    bound = bound_ms((96 * 96 + 2 * 96) * 4 * bsz, 2 * 96 * 96 * bsz)
    log(f"[K3 symv] {path} B={bsz}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.bmm {lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return _record("symv96", "precond_tpu_torch/csrc/symv.cu", "precond_tpu/ops/pallas/symv.py:30",
                   launches_by_path, path, max_abs, ms, plain_ms, bound, lib_ms)


def stencil_bsr(ssys):
    """The stencil system as a 3x3-block BSR matrix over vertex-major DOFs
    (the library yardstick's operand; the port never uses it)."""
    import warnings

    import torch

    nx, ny = ssys.grid
    n = nx * ny
    dev = ssys.diag_t.device
    v = torch.arange(n, device=dev)
    i, j = torch.div(v, ny, rounding_mode="floor"), v % ny
    cols = [v]
    for di, dj in ssys.offsets:
        ok = (i + di >= 0) & (i + di < nx) & (j + dj >= 0) & (j + dj < ny)
        cols.append(torch.where(ok, v + di * ny + dj, n))
    c, order = torch.sort(torch.stack(cols, dim=1), dim=1)       # off-grid (n) last
    blocks = torch.cat([ssys.diag_t[None], ssys.dirs_t]).permute(3, 0, 1, 2)  # [n,D+1,3,3]
    blocks = torch.take_along_dim(blocks, order[:, :, None, None], dim=1)
    keep = c < n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "BSR support is in beta"
        return torch.sparse_bsr_tensor(crow.to(torch.int32), c[keep].to(torch.int32),
                                       blocks[keep].contiguous(), size=(3 * n, 3 * n))


def _k4_check(diag_t, dirs_t, offsets, grid, label: str, seed: int) -> float:
    import numpy as np
    import torch
    from precond_tpu_torch.ops.cuda.stencil_spmv import stencil_spmv
    from precond_tpu_torch.ops.gridstencil import spmv_t_plain

    n = diag_t.shape[-1]
    xt = torch.as_tensor(np.random.default_rng(seed).standard_normal((3, n)).astype(np.float32),
                         device=DEVICE)
    got = stencil_spmv(diag_t, dirs_t, xt, offsets, grid)
    plain = spmv_t_plain(diag_t, dirs_t, xt, offsets, grid)
    scale = float(plain.abs().max())
    max_abs = float((got - plain).abs().max())
    ok = bool(torch.isfinite(got).all().item() and max_abs <= 5e-6 * scale)
    log(f"[K4 stencil_spmv] {label}: kernel vs plain max abs {max_abs:.3e} "
        f"(tol 5e-6*max|y| = {5e-6 * scale:.3e}) ok={ok}")
    require(ok, f"K4 disagrees with its plain version: {label}")
    return max_abs


def kernel_stencil_spmv(run: dict, launches_by_path: dict, path: str, small: dict) -> dict:
    """K4 at the cloth system's own planes and on the same system pinned
    along its first 32 grid rows, then kernel / plain / library times; the
    kernel also at the `small` run's planes."""
    import numpy as np
    import torch
    from precond_tpu_torch.ops.cuda.stencil_spmv import stencil_spmv
    from precond_tpu_torch.ops.gridstencil import pin_vertices, spmv_t_plain

    ssys = run["ssys"]
    nx, ny = ssys.grid
    n, nd = nx * ny, len(ssys.offsets)
    args = (ssys.diag_t, ssys.dirs_t)
    max_abs = _k4_check(*args, ssys.offsets, ssys.grid,
                        f"{path} planes N={n} D={nd}", seed=5)
    pinned = torch.zeros(n, dtype=torch.bool, device=DEVICE)
    pinned[: 32 * ny] = True
    ps = pin_vertices(ssys, pinned, 360.0)
    _k4_check(ps.diag_t, ps.dirs_t, ps.offsets, ps.grid,
              f"{path} pinned along its first 32 grid rows", seed=6)
    del ps

    xt = torch.as_tensor(np.random.default_rng(7).standard_normal((3, n)).astype(np.float32),
                         device=DEVICE)
    y = stencil_spmv(*args, xt, ssys.offsets, ssys.grid)
    ms = time_ms(lambda: stencil_spmv(*args, xt, ssys.offsets, ssys.grid), warmup=5, iters=50)
    plain_ms = time_ms(lambda: spmv_t_plain(*args, xt, ssys.offsets, ssys.grid), warmup=1, iters=5)

    # library yardstick: one cuSPARSE block-sparse matvec of the same H
    lib_ms, lib_note = None, ""
    bsr = stencil_bsr(ssys)
    xv = xt.T.contiguous().reshape(-1)
    for what, call in (("torch.mv(bsr)", lambda: torch.mv(bsr, xv)),
                       ("bsr @ x[:, None]", lambda: (bsr @ xv[:, None])[:, 0])):
        try:
            yl = call()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:   # the yardstick only; says why
            lib_note += f"{what}: {str(e).splitlines()[0][:160]}; "
            continue
        err = float((yl.reshape(n, 3).T - y).abs().max())
        log(f"[K4 stencil_spmv] library {what} on a {bsr.values().shape[0]}-block BSR: "
            f"max abs vs kernel {err:.3e}")
        require(err <= 1e-5 * float(y.abs().max()), "K4's library yardstick disagrees")
        lib_ms = time_ms(call, warmup=3, iters=20)
        lib_note = what
        break
    if lib_ms is None:
        log(f"[K4 stencil_spmv] library yardstick did not run: {lib_note}")
    del bsr

    def k4_bound(n_):
        return bound_ms((9 + 9 * nd) * 4 * n_ + 2 * 3 * 4 * n_, 2 * 9 * (nd + 1) * n_)

    bound = k4_bound(n)
    log(f"[K4 stencil_spmv] {path} N={n} D={nd}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {'%.4f ms' % lib_ms if lib_ms is not None else 'none'} ({lib_note}), "
        f"bound {bound[0]:.4f} ms ({bound[1]})")

    ss = small["ssys"]
    label = f"cloth {small['grid']}"
    _k4_check(ss.diag_t, ss.dirs_t, ss.offsets, ss.grid, f"{label} planes N={ss.num_verts}", seed=8)
    xs = torch.as_tensor(
        np.random.default_rng(9).standard_normal((3, ss.num_verts)).astype(np.float32), device=DEVICE)
    ms_small = time_ms(lambda: stencil_spmv(ss.diag_t, ss.dirs_t, xs, ss.offsets, ss.grid),
                       warmup=10, iters=200)
    bound_small = k4_bound(ss.num_verts)
    log(f"[K4 stencil_spmv] {label} N={ss.num_verts}: kernel {ms_small:.4f} ms, "
        f"bound {bound_small[0]:.4f} ms ({bound_small[1]})")
    return _record("stencil_spmv", "precond_tpu_torch/csrc/stencil_spmv.cu",
                   "precond_tpu/ops/pallas/stencil_spmv.py:49", launches_by_path, path,
                   max_abs, ms, plain_ms, bound, lib_ms, library_call=lib_note,
                   ms_by_path={path: ms, label: ms_small},
                   bound_ms_by_path={path: bound[0], label: bound_small[0]})


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=1024, help="side of the packed-path cloth")
    ap.add_argument("--dense-grid", type=int, default=256, help="side of the dense-path cloth")
    ap.add_argument("--cloth", type=int, default=1024,
                    help="side of the grid-path cloth (comp-major + packed)")
    ap.add_argument("--cloth-dense", type=int, default=256,
                    help="side of the grid-path cloth (comp-major + dense), and of grid_solve_step")
    ap.add_argument("--collide", type=int, default=256, choices=sorted(JAX_RECORD_COLLIDE),
                    help="side of the folded self-colliding sheet on the general path")
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "precond_tpu_torch")):
        print("chip_smoke.py needs the repository checkout around it "
              "(precond_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    log(f"[card] {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"python {sys.version.split()[0]}")
    import precond_tpu_torch  # noqa: F401  (sets TF32 off)
    from precond_tpu_torch.ops.cuda import _lib

    nvcc_v = subprocess.run([_lib._nvcc(), "--version"], capture_output=True, text=True, check=True)
    log(f"[card] nvcc: {nvcc_v.stdout.strip().splitlines()[-1]}")
    _lib.load()
    log(f"[build] {'cached' if _lib.build_info['cached'] else 'built'} in "
        f"{_lib.build_info['seconds']:.1f} s -> {os.path.relpath(_lib.build_info['path'], here)}")
    for line in _lib.build_info["log"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    log(f"[card] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    big = run_general(args.grid, expect_packed=True, profile=True)
    dense = run_general(args.dense_grid, expect_packed=False, profile=True)
    cl = run_cloth(args.cloth, expect_packed=True, profile=True)
    cl_dense = run_cloth(args.cloth_dense, expect_packed=False, profile=True)
    gss = run_grid_solve_step(args.cloth_dense)
    col = run_collide(args.collide, profile=True)
    check_references()
    check_grid_references()
    check_collide_references()

    runs = {f"general {args.grid}": big["counts"], f"general {args.dense_grid}": dense["counts"],
            f"cloth {args.cloth}": cl["counts"], f"cloth {args.cloth_dense}": cl_dense["counts"],
            f"grid_solve_step {args.cloth_dense}": gss["counts"],
            f"collide {args.collide}": col["counts"]}

    def by_path(name):
        return {path: counts[name] for path, counts in runs.items()}

    # slice-1 paths: each kernel against its plain version at their shapes
    check_spd_inverse_blocks(main_path_h96(big), f"general {args.grid}")
    check_packed_symv_table(big["pre"].state.inv96, f"general {args.grid}")
    check_symv(dense["pre"].state.inv96, f"general {args.dense_grid}")
    # the collide path's blocks (contact makes them stiff) and inverse
    check_spd_inverse_blocks(collide_h96(col["pre"], col["ell"], col["st"]), f"collide {args.collide}")
    check_symv(col["pre"].state.inv96, f"collide {args.collide}")
    del col
    # the records: the cloth paths' shapes, with every path's launches
    from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse
    from precond_tpu_torch.ops.gridassembly import assemble_grid_hessian

    h96 = assemble_grid_hessian(cl["dgr"], cl["drr"], cl["offsets"], cl["k"], cl["cfg"])
    h96_small = assemble_grid_hessian(cl_dense["dgr"], cl_dense["drr"], cl_dense["offsets"],
                                      cl_dense["k"], cl_dense["cfg"])
    head = f"cloth {args.cloth}"
    kernels = [kernel_spd_inverse(h96, by_path("spd_inverse96"), head, h96_small,
                                  f"cloth {args.cloth_dense}")]
    del h96_small
    kernels.append(kernel_packed_symv_cm(cl, spd_inverse(h96), by_path("packed_symv96"), head))
    del h96
    kernels.append(kernel_symv(cl_dense["inv"].m, by_path("symv96"), f"cloth {args.cloth_dense}"))
    kernels.append(kernel_stencil_spmv(cl, by_path("stencil_spmv"), head, cl_dense))
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
