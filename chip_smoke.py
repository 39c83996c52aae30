#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (precond_tpu_torch) on one CUDA card.

Drives the main paths of the multilevel additive Schwarz preconditioner
through the port's entry points — the general-mesh path (allocate ->
prepare -> PCG), the structured cloth-grid path (assemble_system_grid /
assemble_system_stencil -> prepare_grid -> comp-major PCG), contact on
the general and the grid paths (hash-grid detection -> stencils ->
prepare(ell, stencils) or prepare_grid(..., stencils, o2s) -> PCG with the
contact SpMV), the tet model on the 3-D box and general paths, and the two
simulators (ClothSim, SoftBodySim) frame by frame — builds every
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
  * collide 256 (grid M): the same sheet on the JAX bench's default build
    (prepare_grid with the stencils, comp-major PCG with the slot contact
    SpMV), against block-Jacobi and its JAX record;
  * the simulators: ClothSim on the folded sheet (3 frames against the JAX
    ClothSim record, frame 0's positions against the record's, a bitwise
    repeat of frame 1), 6 ClothSim drape frames at 1024 (comp-major
    against rows), and SoftBodySim at 16^3 (linear and corotational, 3
    frames each, card against CPU, K1 and K3 on its last prepare);
  * tet 64 (the static box path) and tet 48 (the general path): the JAX
    bench's tet config against block-Jacobi and BASELINE.md's iterations;
  * bf16 inverse storage (inverse_dtype="bfloat16", K3's bf16 entry):
    general 256 under both Morton sorts, the JAX oracle test's 24x24
    per_axis case, cloth 1024 and cloth 256, each held to the outcome of
    scripts/jax_bf16_record.py's JAX record (bf16 stalls CG at the bench's
    stiffness; where the record converges, a band around its count), with
    prepare ms, ms/iter and peak memory beside the f32 run;
  * small-input references: a dense solve on a one-bank mesh, the card
    against the CPU (plain versions) on 32x32 cloths for both paths and on
    a 64x64 fold for the collide path, the analytic-hierarchy prepare
    against prepare_grid, and on a 64x64 fold the grid prepare with
    stencils against the general prepare on the tile maps;
  * per kernel: error against its plain version with the tolerance on
    every path's blocks and tables, and kernel / plain / library times
    (CUDA events) beside the bound;
  * K3's bf16 entry against its plain version on the bf16 tables, with a
    bitwise repeat, and with NaN written above every table's diagonal
    (bitwise the same output: it reads only the lower triangle); its time
    beside the work, sector and dense bounds;
  * checkpoints on the card: save_solver / load_solver of general 1024
    (PackedInverse), cloth 1024 (PackedInverseCM), cloth 256
    (DenseInverseCM) and general 256 bf16 into fresh solvers (state and
    apply bitwise, a resumed solve the same), and one save_solver_sharded /
    load_solver_sharded round trip; file sizes and save / load ms;
  * profiling: PhaseTimer around a cloth 1024 prepare and solve
    (SolveMetrics JSON), and a device_trace of one PCG iteration whose
    trace must name K2's and K4's kernels;
  * K3-bf16 against torch.bmm(out_dtype=float32) in 10 interleaved pairs
    at B = 34,952 and 2,185 (medians and spreads), launched from the host
    and replayed from CUDA graphs;
  * multiple ranks, each rank a child process of this script on cuda:0
    (gloo stages its payloads through host memory; NCCL at one rank), each
    against its single-rank step: the sharded grid steps on 2 ranks (cloth
    1024 and the collide sheet, K4 and K3 per rank) and their collective
    DCP save, read back whole here (2 -> 1) and, from a one-rank save, onto
    2 ranks (1 -> 2); sharded_solve_step at general 1024 on 2 ranks (the
    ring halo) and 4 ranks (the all_to_all), packed (K2 per rank) and
    dense (K3 per rank), and on 1 NCCL rank; the halo PCG with contact on
    the collide sheet on 4 ranks. Per rank: iterations, x against the
    single-rank x, launch counts, prepare ms, ms/iter, time and bytes in
    collectives, peak memory, a bitwise repeat, and the rank's own fine
    table through K2 or K3 against the plain version;
  * the port's bench, bench_torch.run_config, on the seven configs of
    bench.py's default list with 1 solve rep: one "[bench] " line per
    config with bench.py's fields, its launch counts and wall; each row held
    to the JAX records' nnz counts (equal) and iteration bands, with both
    residuals at most 1e-4;
  * the dissection suite (scripts/torch_profile_*.py, torch_micro_bench.py,
    torch_parse_trace.py: the twins of the JAX package's measurement
    scripts) at the bench's sizes: the comp-major PCG iteration at cloth
    1024 and the row-major one at 256 with one stage stubbed at a time, the
    general apply at 1024 stage by stage, the general prepare, the grid
    prepare and the assembly component by component, the hot primitives,
    and a device trace of 5 comp-major iterations as a top-ops table; each
    line with its chain's device busy share. "[dissect ...]" lines, gated
    on finite times, bitwise repeats of the `full` iterations and K1-K4
    launched, then the phase's wall beside its 150 s budget;
  * the contact-regime probes (scripts/torch_probe_*.py: the twins of the
    JAX package's probe scripts) on the folded sheet: the stiffness,
    coarse-damping and Morton-sort scans at 128 with stiffness 1e3 and 1e4
    (iterations of the static grid M, the general M, each damping theta,
    both sorts and block-Jacobi, each held to the JAX record's band), the
    collide 256 split (prepare with and without the stencils, the contact
    terms alone, the composed loop per contact SpMV form, the static and
    general solves against their records, the three SpMV forms against
    each other), the streaming and patch crossings in the cloth 1024 loop
    (bit for bit) and the placement primitives' prices. "[probe ...]"
    lines, gated on the bands, bitwise repeats and K1-K4 launched, then
    the phase's wall beside its 120 s budget;
  * the north star, a 2048^2 cloth (4,194,304 vertices, 5 levels of which
    the apply uses 4), last: scripts/torch_scaling_capacity.py's halo path
    on one rank, capped at the JAX record's count (BASELINE.md's capped run:
    iterations equal, rel_residual within 1%), capped at 12, and to 1e-4 on
    the same state; scripts/torch_pod_solve.py on one rank in this process
    and as one NCCL rank per visible card in child processes (iterations
    within the halo band); the capacity run on 2 gloo ranks sharing the
    card (each rank's residual against one rank's, each rank's peak
    memory); the cloth 2048 bench row (1 rep: converged, nnz equal to the
    JAX host structure's); and K1, K2 and K4 at their 4M shapes against
    their plain versions, with times, bounds and library calls (the
    records' "north_star" entries). "[north star ...]" lines, then the
    phase's wall beside its 240 s budget;
  * one JSON line of kernel records, the nvidia-smi name/power line, and a
    last JSON line {"ok": true, "device": {...}}.

Each path runs once with the launch counts set to 0 just before it and
read just after (in every rank for the multi-rank paths). Any failed
check, and any rank that fails or outlasts its time limit, exits nonzero
without the last line. Needs a CUDA card and the repository checkout
around this file.

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
# every iteration tested, the detection run op by op (in one chunk) so that its
# contact sets are the ones the port reproduces bit for bit.
JAX_RECORD_COLLIDE = {256: (392, 738, 49152)}
# accepted relative bands (Schwarz, Jacobi) around that record
COLLIDE_BAND = (0.10, 0.05)
# The same sheet on the JAX bench's default grid build (BENCH_COLLIDE_M=static:
# prepare_grid with the stencils, comp-major PCG on spmv_t + the slot contact
# SpMV), from scripts/jax_collide_grid_record.py on the CPU, every iteration
# tested: (Schwarz, Jacobi, live stencils). Bands as COLLIDE_BAND.
JAX_RECORD_COLLIDE_GRID = {256: (372, 746, 49152)}
# The JAX ClothSim on that sheet as its rest shape (coarse_damping 0.25, a cap
# of 2, stiffness 1e3, threshold 0.75 h, budget n // 4, cell cap 8), per-frame
# iterations of its first 3 frames, from scripts/jax_clothsim_record.py on
# the CPU (op by op), whose frame start positions are in
# scripts/jax_clothsim_record_256.npz; accepted band +-10% per frame.
JAX_RECORD_CLOTHSIM = {256: (161, 114, 131)}
CLOTHSIM_BAND = 0.10
# The JAX bench's tet config (make_box(side^3, mass 0.05, youngs 5e6), linear):
# (Schwarz, Jacobi) iterations of BASELINE.md:52-53, tested every 8 iterations
# there, so the cloth bands apply. 64 rides the static box path, 48 the general.
JAX_RECORD_ITERS_TET = {64: (88, 256), 48: (88, 280)}
TET_BOX, TET_GENERAL = 64, 48
# examples/softbody_drop.py's scene at 16^3, card against CPU
SOFTBODY = 16
# The JAX package's bf16 records (inverse_dtype="bfloat16"), from
# scripts/jax_bf16_record.py on the CPU with this script's settings (the bench
# meshes, rhs from seed 0, tol 1e-4, every iteration tested, a cap of 2000):
# (Schwarz iterations, reached tol) per (path, side, Morton normalization).
# At the bench's stiffness bf16 storage stalls CG (BASELINE.md:281-282) under
# either sort; ("general", 24, "per_axis") is tests/test_precond_oracle.py's
# case (rhs seed 6, a cap of 1000), where bf16 converges (JAX f32: 96). The
# cloth 1024 entry is the record's at 512 (2000, rel 1.34): the JAX grid path
# stalls at 256 and 512 alike, and its CPU run at 1024 is not made (~15 GB).
JAX_RECORD_BF16 = {("general", 256, "isotropic"): (2000, False),
                   ("general", 256, "per_axis"): (2000, False),
                   ("general", 24, "per_axis"): (123, True),
                   ("cloth", 256, None): (2000, False),
                   ("cloth", 1024, None): (2000, False)}
# accepted band around a converged bf16 record: +-max(abs, rel * count)
BF16_BAND = (5, 0.10)
# The JAX bench's (nnz_spmv, nnz_apply) per (config, grid): BENCH_r04.json
# (cloth 256, 1024), BENCH_r05.json (general 256, tet 64) and tet 48's from
# the same count on the host structure. general 1024 is cloth 1024's mesh and
# block count (B = 34,952, packed), so it reads cloth 1024's counts. The
# counts do not depend on the chip; bench_torch.py must print them exactly.
JAX_RECORD_BENCH_NNZ = {("general", 256): (7621668, 20136960),
                        ("general", 1024): (122499108, 164414208),
                        ("cloth", 256): (7621668, 20136960),
                        ("cloth", 1024): (122499108, 164414208),
                        ("tet", 48): (12568608, 33979392),
                        ("tet", 64): (30010752, 41103552),
                        # the north star: counted on the JAX host structure as
                        # bench.py counts them (9 (n + ell.mask.sum()), 4704 nb):
                        #   JAX_PLATFORMS=cpu python -c "from precond_tpu.models import cloth;
                        #   from precond_tpu.config import SchwarzConfig as C;
                        #   m = cloth.make_grid(2048, 2048, z_wave=0.02, mass=0.001);
                        #   n = m.num_verts;
                        #   _, mask, _ = cloth.ell_structure_from_springs(n, m.springs);
                        #   print(9 * (n + int(mask.sum())), C().num_blocks(n) * 4704)"
                        # (the same command gives 1024's record above)
                        ("general", 2048): (490364964, 657666240),
                        ("cloth", 2048): (490364964, 657666240)}
# bench.py's default config list, which the bench phase runs in order
BENCH_SPECS = (("collide", 256), ("tet", 48), ("tet", 64), ("general", 256),
               ("general", 1024), ("cloth", 256), ("cloth", 1024))
# one solve rep: the phase's gates are nnz and iteration counts, not times,
# and the [dissect] phase needs the seconds (the script's limit is 1200 s)
BENCH_REPS = 1
# The north star (BASELINE.json:11): a 2048^2 cloth, N = 4,194,304 vertices,
# 5 hierarchy levels of which the apply uses 4. The JAX package's capped halo
# run there (BASELINE.md:141-158, round 5):
#   JAX_PLATFORMS=cpu python scripts/scaling_capacity.py --grid 2048 --path halo
# over 8 virtual CPU devices with a dense apply (41.1 GB of RSS): 8 capped
# iterations, rel_residual 0.2318, the rhs from seed 0. The port's halo path
# runs capped at the same count and must land within NORTH_STAR_REL of it.
NORTH_STAR = 2048
JAX_RECORD_NORTH_STAR_HALO = (8, 0.2318)
NORTH_STAR_REL = 0.01
# the capped 1-rank and 2-rank runs held to each other (the JAX script's
# default cap), to this relative distance in rel_residual
NORTH_STAR_CAP = 12
NORTH_STAR_RANKS_RTOL = 1e-4
# the bench rows the north-star phase runs, held to nnz and convergence only
NORTH_STAR_BENCH = (("cloth", NORTH_STAR),)
# K1's check against f64 inverses reads a seeded subset of the 139,810 blocks
NORTH_STAR_K1_F64_BLOCKS = 4096
# the phase's time budget (printed beside its wall)
NORTH_STAR_BUDGET_S = 240
# the pod solve's ranks, one per visible card
NORTH_STAR_POD_BACKEND = "nccl"


# The [dissect] phase: the twins of the JAX package's measurement suite
# (scripts/torch_profile_*.py, torch_micro_bench.py, torch_parse_trace.py)
# at the bench's sizes, with each JAX script's K. Sides of the cloth per part:
DISSECT = {"iteration_cm": 1024, "iteration": 256, "apply": 1024, "apply_fine": 1024,
           "prepare": 1024, "prepare_grid": 1024, "assembly": 256}
DISSECT_K = {"iteration_cm": 50, "iteration": 50, "apply": 100, "apply_fine": 50,
             "prepare": 20, "prepare_grid": 8, "assembly": 30}
# the device trace: `full` comp-major iterations at DISSECT["iteration_cm"],
# and the rows of its top-ops table
DISSECT_TRACE_ITERS = 5
DISSECT_TRACE_TOP = 12
# kernels the phase must launch (K3-bf16 stays with the bf16 phases)
DISSECT_KERNELS = ("spd_inverse96", "packed_symv96", "symv96", "stencil_spmv")
# the phase's time budget (printed beside its wall)
DISSECT_BUDGET_S = 150

# The [contact probes] phase: the twins of the JAX package's contact-regime
# probes (scripts/torch_probe_*.py) on the folded sheet. Sides per part:
PROBES = {"scans": 128, "contact": 256, "crossing_fix": 1024}
# the scans' stiffnesses here: the regimes the collide defaults rest on (1e5
# and 1e6 run by hand through the scripts)
PROBE_STIFFS = (1e3, 1e4)
# K of the composed loops (the JAX scripts' own)
PROBE_K = {"contact": 50, "crossing_fix": 50}
# The JAX package's iteration counts (PCG to 1e-4, check_every 8) per side
# and stiffness, from the JAX scripts' functions on the CPU, op by op:
#   JAX_PLATFORMS=cpu python3 scripts/jax_probe_record.py --scans 128 --stiff 1e3 1e4
# static / general / jacobi: probe_stiff.py; damped (theta 1, 0.5, 0.25,
# 0.125): probe_damping.py; per_axis / iso: probe_isosort.py with the per-axis
# sort its line 85 meant (its jacobi is probe_stiff's).
JAX_RECORD_PROBE_SCANS = {
    128: {1e3: dict(static=384, general=328, jacobi=664, damped=(384, 336, 320, 320),
                    per_axis=384, iso=328),
          1e4: dict(static=1136, general=504, jacobi=960, damped=(1136, 1016, 944, 936),
                    per_axis=1160, iso=504)}}
# probe_contact.py's section 3 at stiffness 1e3 (static grid M, general M on
# the tile maps, row-major, max_iters 2000):
#   JAX_PLATFORMS=cpu python3 scripts/jax_probe_record.py --contact 256
JAX_RECORD_PROBE_CONTACT = {256: dict(static=464, general=472)}
# accepted band around a record, by stiffness: +-max(rel * count, abs). At
# 1e3 the counts are robust to rounding (the port equals JAX at 16^2 in every
# solver); from 1e4 up any change of summation order moves them by one to
# four convergence tests (8-32 iterations: at 16^2 and 1e4 block-Jacobi takes
# 632 in JAX compiled, 640 in JAX op by op, 608 in the port, 632 in the port
# with the scatter contact SpMV), so those regimes get the wider band.
PROBE_BANDS = {1e3: (0.03, 16), 1e4: (0.12, 16), 1e5: (0.12, 16), 1e6: (0.12, 16)}
# the three contact SpMV forms against each other (the JAX contact tests'
# tolerance, relative to max|y|)
PROBE_SPMV_RTOL = 5e-6
# the phase's time budget (printed beside its wall)
PROBE_BUDGET_S = 120


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
    `fn`, from torch.profiler's CUDA trace, after one warm-up call
    (scripts/torch_dissect_common.profile_phase)."""
    _script("torch_dissect_common").profile_phase(label, fn, reps, top, log=log)


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
    held_gb = torch.cuda.memory_allocated() / 1e9
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

    return dict(grid=grid, n=n, pre=pre, ell=ell, b=b, counts=counts, iters=res.iterations,
                jacobi_iters=jac.iterations, prepare_ms=prepare_ms,
                ms_per_iter=1e3 * (t3 - t2) / max(res.iterations, 1), peak_gb=peak_gb,
                held_gb=held_gb, apply_ms=apply_ms)


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
                offsets=offsets, counts=counts, iters=res.iterations, jacobi_iters=jac.iterations,
                prepare_ms=prepare_ms, ms_per_iter=1e3 * (t2 - t1) / max(res.iterations, 1),
                peak_gb=peak_gb, held_gb=held_gb, apply_ms=apply_ms, b=b)


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
    gap of 0.5 h. Returns (mesh, positions f32[N,3], h)
    (scripts/torch_probe_common.folded_sheet)."""
    return _script("torch_probe_common").folded_sheet(grid)


def detect_collide(pos, faces, edges, h: float):
    """The bench's detection recipe (bench.py:248-270) on the tensors' device:
    VF/EE/EF at threshold 0.75 h, stiffness 1e3, a budget of n // 4 per set
    and a cap of 2, then build_stencils with the valid stencils kept (one
    host read) and padded to a multiple of 8. Returns (sets, infos, stencils,
    live count) (scripts/torch_probe_common.detect)."""
    return _script("torch_probe_common").detect(pos, faces, edges, h, 1e3)


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


def _in_band(label: str, what: str, got: int, rec: int, band: float) -> None:
    log(f"[{label}] {what}: port {got}, JAX record {rec} (band +-{100 * band:.0f}%)")
    require(abs(got - rec) <= band * rec, f"{label}: {got} {what}, outside {rec} +- {100 * band:.0f}%")


def run_collide_grid(grid: int, tol: float = 1e-4, profile: bool = False) -> dict:
    """Contact on the grid path: the JAX bench's default collide build
    (bench.py:210-281, 299-317, 389-414, 570-587, BENCH_COLLIDE_M=static) on
    the folded sheet: detection on the card -> prepare_grid(..., stencils,
    o2s) (DenseInverseCM) -> comp-major PCG on spmv_t (K4) plus the slot
    contact SpMV, with K3 behind the apply and K1 in the prepare; against
    block-Jacobi with the contact ELL's diagonal on the same operator."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops import gridstencil
    from precond_tpu_torch.ops.contact import build_contact_ell, build_contact_slots, slot_contact_spmv_t
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.ops.cuda.packed_symv import DenseInverseCM
    from precond_tpu_torch.ops.gridapply import precondition_grid_cm
    from precond_tpu_torch.ops.gridassembly import assemble_grid_hessian
    from precond_tpu_torch.ops.stencils import collision_terms, map_stencils
    from precond_tpu_torch.parallel.pcg import pcg
    from precond_tpu_torch.solver import prepare_grid
    from precond_tpu_torch.utils import gridmorton as gm

    label = f"collide {grid} (grid M)"
    k = grid.bit_length() - 1
    t0 = time.perf_counter()
    mesh, folded, h = folded_sheet(grid)
    n = mesh.num_verts
    ell = cloth.assemble_system(mesh, positions=folded, device=DEVICE)
    ssys = cloth.assemble_system_stencil(mesh, positions=folded, device=DEVICE)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, positions=folded, device=DEVICE)
    o2s = torch.as_tensor(gm.sort_maps(k)[1], device=DEVICE)
    pos, faces, edges = (torch.as_tensor(a, device=DEVICE) for a in (folded, mesh.faces, mesh.edges))
    bt = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32),
                         device=DEVICE).T.contiguous()
    torch.cuda.synchronize()
    cfg = SchwarzConfig(coarse_damping=0.25)
    log(f"[{label}] N={n} k={k} levels={cfg.num_levels(n)} blocks={cfg.num_blocks(n)} "
        f"D={len(offsets)} (systems built in {time.perf_counter() - t0:.2f} s)")

    def pre_op_of(inv):
        return lambda r: gm.morton_to_grid_cm(
            precondition_grid_cm(inv, gm.grid_to_morton_cm(r, k), cfg), k)

    # ---- the counted run: detect -> stencils -> prepare_grid -> comp-major PCG
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, st, live = detect_collide(pos, faces, edges, h)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    inv = prepare_grid(dgr, drr, offsets, k, cfg, st, o2s)
    slots = build_contact_slots(st, n)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def spmv(p):
        return gridstencil.spmv_t(ssys, p) + slot_contact_spmv_t(slots, p)

    pre_op = pre_op_of(inv)
    res = pcg(spmv, pre_op, bt, tol=tol, max_iters=2000)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(_lib.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label}] launches in the counted run: {counts}")
    true_rel = float(torch.linalg.norm(bt - spmv(res.x)) / torch.linalg.norm(bt))
    log(f"[{label}] schwarz: iters={res.iterations} rel_residual={float(res.rel_residual):.3e} "
        f"true_rel_residual={true_rel:.3e} live stencils {live} detect_ms(first)={1e3 * (t1 - t0):.1f} "
        f"prepare_ms(first, with slots)={1e3 * (t2 - t1):.1f} solve_ms={1e3 * (t3 - t2):.1f} "
        f"ms_per_iter={1e3 * (t3 - t2) / max(res.iterations, 1):.3f} peak_mem_gb={peak_gb:.2f} "
        f"(held before the run: {held_gb:.2f})")
    require(res.iterations < 2000 and float(res.rel_residual) <= tol,
            f"{label}: Schwarz PCG did not converge")
    require(torch.isfinite(res.x).all().item() and true_rel <= 10 * tol,
            f"{label}: solution not finite or true residual {true_rel:.3e} too large")
    require(isinstance(inv, DenseInverseCM), f"{label}: expected a DenseInverseCM, got {type(inv).__name__}")
    require(counts["spd_inverse96"] == 1,
            f"{label}: the inverse kernel launched {counts['spd_inverse96']} times in one prepare")
    for name in ("symv96", "stencil_spmv"):
        require(counts[name] >= res.iterations,
                f"{label}: {name} launched {counts[name]} times in {res.iterations} iterations")

    # ---- block-Jacobi on the same operator, with the contact ELL's diagonal
    dinv_t = torch.linalg.inv(ell.diag + build_contact_ell(st, n, kc=32).diag).permute(1, 2, 0).contiguous()

    def jac_op(r):
        return (dinv_t * r[None]).sum(dim=1)

    t0 = time.perf_counter()
    jac = pcg(spmv, jac_op, bt, tol=tol, max_iters=20000)
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    log(f"[{label}] jacobi: iters={jac.iterations} rel_residual={float(jac.rel_residual):.3e} "
        f"solve_ms={1e3 * jac_s:.1f} ms_per_iter={1e3 * jac_s / max(jac.iterations, 1):.3f}")
    require(jac.iterations < 20000 and float(jac.rel_residual) <= tol,
            f"{label}: Jacobi PCG did not converge")
    rec_s, rec_j, rec_live = JAX_RECORD_COLLIDE_GRID[grid]
    log(f"[{label}] live stencils: port {live}, JAX record {rec_live}")
    _in_band(label, "Schwarz iterations", res.iterations, rec_s, COLLIDE_BAND[0])
    _in_band(label, "Jacobi iterations", jac.iterations, rec_j, COLLIDE_BAND[1])

    # ---- bitwise repeats: prepare and apply
    inv2 = prepare_grid(dgr, drr, offsets, k, cfg, st, o2s)
    same_state = same_bits(inv, inv2)
    z = pre_op(bt)
    same_apply = torch.equal(z, pre_op_of(inv2)(bt)) and torch.equal(z, pre_op(bt))
    log(f"[{label}] bitwise repeat: prepare={same_state} apply={same_apply}")
    require(same_state and same_apply, f"{label}: prepare/apply not bit-reproducible")
    del inv2

    # ---- steady-state timings (outside the counted run)
    prepare_ms = time_ms(lambda: prepare_grid(dgr, drr, offsets, k, cfg, st, o2s), warmup=1, iters=3)
    slots_ms = time_ms(lambda: build_contact_slots(st, n), warmup=1, iters=3)
    apply_ms = time_ms(lambda: pre_op(bt), warmup=2, iters=10)
    spmv_ms = time_ms(lambda: spmv(bt), warmup=2, iters=10)
    contact_ms = time_ms(lambda: slot_contact_spmv_t(slots, bt), warmup=2, iters=10)
    iter_ms = time_ms(lambda: pcg(spmv, pre_op, bt, tol=0.0, max_iters=20), warmup=1, iters=2) / 20
    jac_iter_ms = time_ms(lambda: pcg(spmv, jac_op, bt, tol=0.0, max_iters=20), warmup=1, iters=2) / 20
    wall = prepare_ms + slots_ms + res.iterations * iter_ms
    log(f"[{label}] steady: prepare_ms={prepare_ms:.2f} slots_ms={slots_ms:.2f} apply_ms={apply_ms:.3f} "
        f"spmv_ms={spmv_ms:.3f} (contact part {contact_ms:.3f}) ms_per_iter={iter_ms:.3f} "
        f"solve_wall_ms={wall:.1f} against jacobi {jac.iterations} x {jac_iter_ms:.3f} = "
        f"{jac.iterations * jac_iter_ms:.1f} ms")
    if profile:
        profile_phase(f"{label} prepare", lambda: prepare_grid(dgr, drr, offsets, k, cfg, st, o2s), reps=1)
        profile_phase(f"{label} 20 PCG iterations",
                      lambda: pcg(spmv, pre_op, bt, tol=0.0, max_iters=20), reps=1)
    h96 = assemble_grid_hessian(dgr, drr, offsets, k, cfg, collision_terms(map_stencils(st, o2s)))
    return dict(grid=grid, n=n, counts=counts, iters=res.iterations, jacobi_iters=jac.iterations,
                live=live, inv=inv, h96=h96, ssys=ssys)


def check_collide_grid_reference(grid: int = 64) -> None:
    """The card's grid prepare with stencils against the card's general
    prepare on the tile maps (tests/test_gridprep.py:142-183's claim and
    tolerance): the contacts leave the hierarchy arithmetic, and the two
    inverses agree."""
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.gridapply import grid_going_next
    from precond_tpu_torch.solver import SortMaps, prepare_grid, prepare_with_system
    from precond_tpu_torch.utils import gridmorton as gm

    k = grid.bit_length() - 1
    mesh, folded, h = folded_sheet(grid)
    n = mesh.num_verts
    pos, faces, edges = (torch.as_tensor(a, device=DEVICE) for a in (folded, mesh.faces, mesh.edges))
    _, _, st, live = detect_collide(pos, faces, edges, h)
    cfg = SchwarzConfig(coarse_damping=0.25, solve_layout="rows")
    s2o, o2s = (torch.as_tensor(m, device=DEVICE) for m in gm.sort_maps(k))
    state, _ = prepare_with_system(cloth.assemble_system(mesh, positions=folded, device=DEVICE),
                                   SortMaps(s2o, o2s), cfg, st)
    dg, dr, off = cloth.assemble_system_grid(mesh, positions=folded, device=DEVICE)
    inv = prepare_grid(dg, dr, off, k, cfg, st, o2s)
    same_hier = torch.equal(state.going_next, grid_going_next(n, cfg, DEVICE))
    err = float((state.inv96 - inv).abs().max())
    ok = bool(torch.allclose(inv, state.inv96, rtol=2e-4, atol=1e-5))
    log(f"[reference] collide {grid} (grid M): {live} live stencils; general hierarchy on the tile "
        f"maps arithmetic={same_hier}; prepare_grid(st, o2s) vs prepare_with_system(st) max abs err "
        f"{err:.2e} (rtol 2e-4, atol 1e-5) ok={ok}")
    require(same_hier and ok, f"collide {grid}: the grid prepare with stencils disagrees with the general one")


class _PhaseClock:
    """Wall time of named calls inside a simulator frame: each wrapped call
    synchronizes the card before and after, and its ms are summed per name."""

    def __init__(self):
        self.ms = {}

    def wrap(self, name: str, fn):
        import torch

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out

        return timed


def clothsim_starts(grid: int, x0, dt: float, frames: int):
    """The JAX ClothSim record's start state of each frame: frame 0 starts at
    rest from x0, frame f from the positions scripts/jax_clothsim_record.py
    saved (x1, x2, ...) with the velocity (x_f - x_(f-1)) / dt in float32,
    bit for bit the record's. Returns [(positions, velocities)] as numpy."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(here, "scripts", f"jax_clothsim_record_{grid}.npz")) as z:
        xs = [np.asarray(x0, np.float32)] + [z[f"x{f}"] for f in range(1, frames)]
    out = [(xs[0], np.zeros_like(xs[0]))]
    for f in range(1, frames):
        out.append((xs[f], (xs[f] - xs[f - 1]) / np.float32(dt)))
    return out


def run_clothsim_collide(grid: int, frames: int = 3) -> dict:
    """ClothSim on the bench's folded sheet as its rest shape: every frame
    detects VF/EE/EF on the card, prepares the grid path with the stencils
    (K1) and solves comp-major (K4, K3 via the dense comp-major apply, the
    rank-1 stencil contact SpMV), against the JAX ClothSim record.

    The sheet's contacts tie exactly, so which ones a budget keeps is
    decided by the last bit of each distance: a frame that starts from a
    state differing in the last bits (another machine's rounding) keeps
    other contacts and is another system. So the card runs the frames
    freely (the counted run: timed, printed, converged; its frame 0 starts
    from the record's own state and is held to the record's x1), and then
    each frame again from the record's own start state (clothsim_starts),
    where its detection is the record's bit for bit; those frames are held
    to the record's iterations."""
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import simulator
    from precond_tpu_torch.ops.cuda import _lib

    label = f"ClothSim collide {grid}"
    mesh, folded, h = folded_sheet(grid)
    n = mesh.num_verts
    cfg = SchwarzConfig(coarse_damping=0.25, max_collision_per_vert=2)
    t0 = time.perf_counter()
    sim = simulator.ClothSim(mesh._replace(positions=folded), cfg, collision_stiffness=1e3,
                             collision_threshold=0.75 * h, collision_budget=n // 4,
                             collision_cell_cap=8, max_iters=2000, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[{label}] N={n} built in {time.perf_counter() - t0:.2f} s")
    clock = _PhaseClock()
    sim.contact.detect = clock.wrap("detect", sim.contact.detect)
    prepare_grid = simulator.prepare_grid
    simulator.prepare_grid = clock.wrap("prepare", prepare_grid)
    rec = JAX_RECORD_CLOTHSIM[grid]
    starts = clothsim_starts(grid, folded, mesh.dt, frames)
    states, iters = [sim.state], []
    try:
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        for f in range(frames):
            clock.ms.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = sim.step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            res, info = sim.last_solve, sim.last_detect_info
            det, prep = clock.ms.get("detect", 0.0), clock.ms.get("prepare", 0.0)
            log(f"[{label}] frame {f}: iters={res.iterations} rel_residual={float(res.rel_residual):.3e} "
                f"detect_ms={det:.1f} prepare_ms={prep:.1f} solve_ms={wall - det - prep:.1f} "
                f"(frame wall {wall:.1f}) truncated={bool(info.truncated)} dropped={int(info.dropped)} "
                f"z_mean={float(st.positions[:, 2].mean()):+.5f}")
            require(float(res.rel_residual) <= 1e-4 and torch.isfinite(st.positions).all().item(),
                    f"{label}: frame {f} did not converge or is not finite")
            iters.append(res.iterations)
            states.append(st)
    finally:
        simulator.prepare_grid = prepare_grid
    counts = dict(_lib.launch_counts)
    log(f"[{label}] launches over {frames} frames: {counts}; peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    require(counts["spd_inverse96"] == frames, f"{label}: K1 launched {counts['spd_inverse96']} times")
    for name in ("symv96", "stencil_spmv"):
        require(counts[name] >= sum(iters), f"{label}: {name} launched {counts[name]} times")
    # the counted run's frame 0 starts from the record's own state (the
    # folded sheet at rest): its positions against the record's x1
    x1 = torch.as_tensor(starts[1][0], device=DEVICE)
    scale = float(x1.abs().max())
    err = float((states[1].positions - x1).abs().max())
    log(f"[{label}] counted frame 0 against the record's x1: max abs diff {err:.3e} "
        f"(tol 2e-4*max|x| = {2e-4 * scale:.3e})")
    require(err <= 2e-4 * scale, f"{label}: the counted frame 0 disagrees with the JAX record")
    # frame 1 again from the same state: bit for bit
    sim.state = states[1]
    again = sim.step()
    same = torch.equal(again.positions, states[2].positions) and sim.last_solve.iterations == iters[1]
    log(f"[{label}] frame 1 repeated from the same state: bitwise equal={same}")
    require(same, f"{label}: frame 1 does not repeat bit for bit")

    # each frame from the record's start state, against the record
    for f, (x, v) in enumerate(starts):
        sim.state = type(sim.state)(torch.as_tensor(x, device=DEVICE), torch.as_tensor(v, device=DEVICE), f)
        sim.step()
        require(float(sim.last_solve.rel_residual) <= 1e-4, f"{label}: frame {f} did not converge")
        _in_band(label, f"frame {f} iterations from the record's start state",
                 sim.last_solve.iterations, rec[f], CLOTHSIM_BAND)
    return dict(counts=counts, iters=iters)


def run_clothsim_drape(grid: int, frames: int = 6) -> dict:
    """`frames` ClothSim frames at the headline width on the grid path,
    without contact: examples/cloth_drape.py's mesh (mass 0.02, k
    5e3/5e3/50), the top row pinned. Frame 0 starts at rest under a uniform
    load and converges in a few iterations; the frames after it swing, and
    their mean wall is what a drape user pays per frame. The default layout
    solves comp-major (K4, K2 through packed_symv_cm, K1); solve_layout=
    "rows" (K4, K2's row entry) must end at the same positions within
    2e-4 * max|x| (tests/test_simulator.py:122)."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.models.simulator import ClothSim
    from precond_tpu_torch.ops.cuda import _lib

    label = f"ClothSim {grid}"
    mesh = cloth.make_grid(grid, grid, mass=0.02, dt=1.0 / 60.0, k_struct=5e3, k_shear=5e3,
                           k_bend=50.0)
    pinned = np.arange(grid)
    out, counts = {}, {}
    for layout in ("auto", "rows"):
        t0 = time.perf_counter()
        sim = ClothSim(mesh, SchwarzConfig(solve_layout=layout), pinned=pinned, device=DEVICE)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        iters, walls = [], []
        for f in range(frames):
            t0 = time.perf_counter()
            st = sim.step()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            res = sim.last_solve
            require(float(res.rel_residual) <= 1e-4 and torch.isfinite(st.positions).all().item(),
                    f"{label} {layout}: frame {f} did not converge or is not finite")
            iters.append(res.iterations)
        counts[layout] = dict(_lib.launch_counts)
        swing = walls[1:]
        log(f"[{label} {layout}] built in {built:.2f} s; {frames} frames: iters={iters} "
            f"frame_ms={[round(w, 1) for w in walls]}; frames 1-{frames - 1} mean frame_ms="
            f"{sum(swing) / len(swing):.1f}, ms_per_iter={sum(swing) / sum(iters[1:]):.3f} "
            f"(with the prepare); peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"launches={counts[layout]}")
        require(counts[layout]["spd_inverse96"] == frames
                and counts[layout]["packed_symv96"] >= sum(iters)
                and counts[layout]["stencil_spmv"] >= sum(iters),
                f"{label} {layout}: a kernel of the path was not launched every iteration")
        out[layout] = st.positions
        del sim
    scale = float(out["rows"].abs().max())
    err = float((out["auto"] - out["rows"]).abs().max())
    log(f"[{label}] comp-major vs rows after {frames} frames: max abs diff {err:.3e} "
        f"(tol 2e-4*max|x| = {2e-4 * scale:.3e})")
    require(err <= 2e-4 * scale, f"{label}: the comp-major and row-major frames disagree")
    return dict(counts=counts["auto"], counts_rows=counts["rows"])


def run_tet(side: int, tol: float = 1e-4, profile: bool = False) -> dict:
    """The JAX bench's tet config (bench.py:121-209): make_box(side^3, mass
    0.05, youngs 5e6), linear material, rhs from seed 0, tol 1e-4. A
    power-of-two side rides the static box path (planes_from_ell ->
    prepare_box -> PCG on boxstencil.spmv with the grid apply between the box
    crossings: K1, K2's row-major entry); any other side the general path
    (SchwarzPreconditioner, sorted-space PCG on the block-ELL SpMV: K1, K3).
    Block-Jacobi runs on the same SpMV."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import tetmesh
    from precond_tpu_torch.ops import boxstencil
    from precond_tpu_torch.ops.apply import precondition_sorted
    from precond_tpu_torch.ops.blockcsr import permute, spmv as ell_spmv
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.ops.cuda.packed_symv import PackedInverse
    from precond_tpu_torch.ops.gridapply import precondition_grid
    from precond_tpu_torch.ops.gridassembly import assemble_box_hessian
    from precond_tpu_torch.parallel.pcg import jacobi_preconditioner, pcg
    from precond_tpu_torch.solver import prepare_box
    from precond_tpu_torch.utils import boxmorton as bm

    dims = (side, side, side)
    box = bm.supported(*dims)
    label = f"tet {side} ({'box' if box else 'general'})"
    t0 = time.perf_counter()
    mesh = tetmesh.make_box(*dims, mass=0.05, youngs=5e6)
    t1 = time.perf_counter()
    ell = tetmesh.assemble_system(mesh, device=DEVICE)
    n = mesh.num_verts
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32),
                        device=DEVICE)
    cfg = SchwarzConfig()
    if box:
        bsys = boxstencil.from_ell(ell, dims)
        dgr, drr = boxstencil.planes_from_ell(ell, dims)
    torch.cuda.synchronize()
    log(f"[{label}] N={n} T={len(mesh.tets)} K={ell.max_degree} levels={cfg.num_levels(n)} "
        f"blocks={cfg.num_blocks(n)} packed={cfg.use_packed_symv(n)} (make_box {t1 - t0:.2f} s, "
        f"system {time.perf_counter() - t1:.2f} s)")

    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    if box:
        inv = prepare_box(dgr, drr, boxstencil.BOX_OFFSETS, dims, cfg)

        def prepare():
            return prepare_box(dgr, drr, boxstencil.BOX_OFFSETS, dims, cfg)

        def spmv(x):
            return boxstencil.spmv(bsys, x)

        def pre_op(r):
            return bm.morton_to_box(precondition_grid(inv, bm.box_to_morton(r, *dims), cfg), *dims)

        bb, jdiag = b, ell.diag
    else:
        pre = SchwarzPreconditioner(cfg, device=DEVICE)
        pre.allocate(mesh.positions)
        pre.prepare(ell)
        inv = pre.state.inv96

        def prepare():
            pre.prepare(ell)
            return pre.state.inv96

        ells = permute(ell, pre.maps.sorted_to_orig, pre.maps.orig_to_sorted)

        def spmv(x):
            return ell_spmv(ells, x)

        def pre_op(r):
            return precondition_sorted(pre.state, r, pre.cfg_effective)

        bb, jdiag = b[pre.maps.sorted_to_orig.long()], ells.diag
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = pcg(spmv, pre_op, bb, tol=tol, max_iters=2000)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(_lib.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label}] launches in the counted run: {counts}")
    true_rel = float(torch.linalg.norm(bb - spmv(res.x)) / torch.linalg.norm(bb))
    log(f"[{label}] schwarz: iters={res.iterations} rel_residual={float(res.rel_residual):.3e} "
        f"true_rel_residual={true_rel:.3e} prepare_ms(first)={1e3 * (t1 - t0):.1f} "
        f"solve_ms={1e3 * (t2 - t1):.1f} ms_per_iter={1e3 * (t2 - t1) / max(res.iterations, 1):.3f} "
        f"peak_mem_gb={peak_gb:.2f}")
    require(res.iterations < 2000 and float(res.rel_residual) <= tol and true_rel <= 10 * tol
            and torch.isfinite(res.x).all().item(), f"{label}: Schwarz PCG did not converge")
    require(isinstance(inv, PackedInverse) == cfg.use_packed_symv(n), f"{label}: unexpected inverse form")
    symv_name = "packed_symv96" if cfg.use_packed_symv(n) else "symv96"
    require(counts["spd_inverse96"] == 1 and counts[symv_name] >= res.iterations,
            f"{label}: K1 once and {symv_name} every iteration expected")

    jac_op = jacobi_preconditioner(jdiag)
    t0 = time.perf_counter()
    jac = pcg(spmv, jac_op, bb, tol=tol, max_iters=20000)
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    log(f"[{label}] jacobi: iters={jac.iterations} rel_residual={float(jac.rel_residual):.3e} "
        f"solve_ms={1e3 * jac_s:.1f} ms_per_iter={1e3 * jac_s / max(jac.iterations, 1):.3f}")
    require(float(jac.rel_residual) <= tol, f"{label}: Jacobi PCG did not converge")
    rec = JAX_RECORD_ITERS_TET[side]
    log(f"[{label}] iterations schwarz/jacobi: port {res.iterations}/{jac.iterations}, JAX package "
        f"record {rec[0]}/{rec[1]} (BASELINE.md:52-53; bands +-{CLOTH_BAND[0]} / +-{CLOTH_BAND[1]})")
    require(abs(res.iterations - rec[0]) <= CLOTH_BAND[0] and abs(jac.iterations - rec[1]) <= CLOTH_BAND[1],
            f"{label}: iterations {res.iterations}/{jac.iterations} outside {rec} +- {CLOTH_BAND}")
    same = same_bits(inv, prepare())
    log(f"[{label}] bitwise repeat: prepare={same}")
    require(same, f"{label}: prepare not bit-reproducible")

    prepare_ms = time_ms(prepare, warmup=1, iters=2)
    iter_ms = time_ms(lambda: pcg(spmv, pre_op, bb, tol=0.0, max_iters=20), warmup=1, iters=2) / 20
    jac_iter_ms = time_ms(lambda: pcg(spmv, jac_op, bb, tol=0.0, max_iters=20), warmup=1, iters=2) / 20
    spmv_ms = time_ms(lambda: spmv(bb), warmup=2, iters=10)
    log(f"[{label}] steady: prepare_ms={prepare_ms:.1f} spmv_ms={spmv_ms:.3f} ms_per_iter={iter_ms:.3f} "
        f"solve_wall_ms={prepare_ms + res.iterations * iter_ms:.1f} against jacobi {jac.iterations} x "
        f"{jac_iter_ms:.3f} = {jac.iterations * jac_iter_ms:.1f} ms")
    if profile:
        profile_phase(f"{label} 20 PCG iterations",
                      lambda: pcg(spmv, pre_op, bb, tol=0.0, max_iters=20), reps=1)
    # the prepare's assembled blocks (K1's input)
    if box:
        h96 = assemble_box_hessian(dgr, drr, boxstencil.BOX_OFFSETS, dims, cfg)
    else:
        h96 = main_path_h96(dict(pre=pre, ell=ell))
    return dict(counts=counts, iters=res.iterations, jacobi_iters=jac.iterations, inv=inv, h96=h96)


class _LastCall:
    """Wraps fn and keeps the arguments and the result of its last call."""

    def __init__(self, fn):
        self.fn, self.args, self.out = fn, None, None

    def __call__(self, *args):
        self.out = self.fn(*args)
        self.args = args
        return self.out


def run_softbody(side: int = 16, frames: int = 3) -> dict:
    """SoftBodySim on examples/softbody_drop.py's scene (make_box(side^3, mass
    0.05, youngs 5e4), the top face pinned): `frames` frames of the linear
    material (the box path prepared once: K1, K3) and of the corotational
    one (prepare_box every frame), on the card and on the CPU (plain
    versions); every frame converges and the two agree within 2e-4 * max|x|.
    K1 and the apply kernel are held against their plain versions on the
    card's last prepare: PCG reaches the same x under any SPD
    preconditioner, so the positions alone would not see a wrong kernel."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import simulator, tetmesh
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.ops.gridassembly import assemble_box_hessian

    mesh = tetmesh.make_box(side, side, side, mass=0.05, youngs=5e4)
    top = np.flatnonzero(np.arange(mesh.num_verts) % side == side - 1)
    counts = {}
    prepare_box = simulator.prepare_box
    for material in ("linear", "corotational"):
        label = f"SoftBodySim {side} {material}"
        pos = {}
        for dev in ("cpu", DEVICE):
            last = simulator.prepare_box = _LastCall(prepare_box)
            try:
                _lib.reset_launch_counts()
                t0 = time.perf_counter()
                sim = simulator.SoftBodySim(mesh, SchwarzConfig(), pinned=top, material=material,
                                            device=dev)
                require(sim._box == (side, side, side), f"{label}: not on the box path")
                its = []
                for _ in range(frames):
                    st = sim.step()
                    require(float(sim.last_solve.rel_residual) <= 1e-4
                            and torch.isfinite(st.positions).all().item(),
                            f"{label} on {dev}: a frame did not converge")
                    its.append(sim.last_solve.iterations)
                if dev == DEVICE:
                    torch.cuda.synchronize()
                    counts[material] = dict(_lib.launch_counts)
            finally:
                simulator.prepare_box = prepare_box
            pos[dev] = st.positions.cpu()
            log(f"[{label}] {dev}: iterations per frame {its}, {time.perf_counter() - t0:.2f} s "
                f"with setup, z_mean {float(st.positions[:, 2].mean()):.5f}")
        # the scene has no contact: the prepare's blocks are the planes' alone
        require(len(last.args) < 6 or last.args[5] is None, f"{label}: unexpected contact terms")
        check_spd_inverse_blocks(assemble_box_hessian(*last.args[:5]), f"{label} (last prepare)")
        if isinstance(last.out, torch.Tensor):
            check_symv(last.out, f"{label} (last prepare)")
        else:
            check_packed_symv_table(last.out, f"{label} (last prepare)")
        scale = float(pos["cpu"].abs().max())
        err = float((pos[DEVICE] - pos["cpu"]).abs().max())
        log(f"[{label}] card vs CPU after {frames} frames: max abs diff {err:.3e} "
            f"(tol 2e-4*max|x| = {2e-4 * scale:.3e}); launches {counts[material]}")
        require(err <= 2e-4 * scale, f"{label}: the card and the CPU disagree")
        require(counts[material]["spd_inverse96"] >= 1 and counts[material]["symv96"] >= frames,
                f"{label}: K1 / K3 were not launched")
    return dict(counts=counts["corotational"], counts_linear=counts["linear"])


# ---------------------------------------------------------------------------
# bf16 inverse storage, checkpoints and profiling
# ---------------------------------------------------------------------------

def bf16_gate(label: str, res, tol: float, rec) -> bool:
    """Hold a bf16 solve to its JAX record's outcome: where JAX reached tol,
    the port must too, within BF16_BAND of its count; where JAX stalled at
    the cap, the port must not reach tol either. Returns whether it reached
    tol."""
    its, reached = rec
    rel = float(res.rel_residual)
    ok = rel <= tol
    if reached:
        band = max(BF16_BAND[0], int(BF16_BAND[1] * its))
        log(f"[{label}] reached tol in {res.iterations} iterations; JAX record {its} "
            f"(band +-{band})")
        require(ok, f"{label}: did not reach tol {tol} where the JAX record does")
        require(abs(res.iterations - its) <= band,
                f"{label}: {res.iterations} iterations, outside {its} +- {band}")
    else:
        log(f"[{label}] did NOT reach tol {tol}: {res.iterations} iterations, rel_residual "
            f"{rel:.3e}, as the JAX record stalls ({its} iterations without reaching tol); "
            f"bf16 storage stalls CG at this conditioning, so this solve is no pass")
        require(not ok, f"{label}: reached tol where the JAX record stalls")
    return ok


def run_general_bf16(grid: int, norm: str, f32=None, tol: float = 1e-4,
                     seed: int = 0, max_iters: int = 2000) -> dict:
    """The general-mesh path with bf16 inverse storage: the dense bf16 table
    and K3's bf16 entry (packed storage is f32 only). `f32` is the f32 run of
    the same mesh (its system is reused, its numbers printed beside)."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.blockcsr import spmv
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.parallel.pcg import pcg

    label = f"general {grid} bf16 {norm}"
    mesh = cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    ell = f32["ell"] if f32 is not None else cloth.assemble_system(mesh, device=DEVICE)
    n = mesh.num_verts
    b = torch.as_tensor(
        np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32), device=DEVICE)
    cfg = SchwarzConfig(inverse_dtype="bfloat16", morton_normalization=norm)
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    pre = SchwarzPreconditioner(cfg, device=DEVICE)
    pre.allocate(mesh.positions)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pre.prepare(ell)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = pcg(lambda x: spmv(ell, x), pre.apply, b, tol=tol, max_iters=max_iters)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(_lib.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    inv = pre.state.inv96
    log(f"[{label}] N={n} table {tuple(inv.shape)} {inv.dtype}; launches {counts}")
    require(isinstance(inv, torch.Tensor) and inv.dtype == torch.bfloat16,
            f"{label}: expected a dense bf16 table, got {type(inv).__name__}")
    require(counts["spd_inverse96"] == 1 and counts["symv96"] == 0
            and counts["symv96_bf16"] >= res.iterations,
            f"{label}: K1 once and K3-bf16 every iteration expected, got {counts}")
    bf16_gate(label, res, tol, JAX_RECORD_BF16[("general", grid, norm)])
    prepare_ms = time_ms(lambda: pre.prepare(ell), warmup=0, iters=2)
    apply_ms = time_ms(lambda: pre.apply(b), warmup=2, iters=10)
    ms_iter = 1e3 * (t3 - t2) / max(res.iterations, 1)
    line = (f"[{label}] prepare_ms(first)={1e3 * (t2 - t1):.1f} prepare_ms={prepare_ms:.1f} "
            f"apply_ms={apply_ms:.3f} ms_per_iter={ms_iter:.3f} peak_mem_gb={peak_gb:.2f} "
            f"(held before the run: {held_gb:.2f})")
    if f32 is not None:
        line += (f"; f32 (isotropic): prepare_ms={f32['prepare_ms']:.1f} "
                 f"apply_ms={f32['apply_ms']:.3f} ms_per_iter={f32['ms_per_iter']:.3f} "
                 f"peak_mem_gb={f32['peak_gb']:.2f} (held: {f32['held_gb']:.2f})")
    log(line)
    z = pre.apply(b)
    require(torch.equal(z, pre.apply(b)), f"{label}: apply not bit-reproducible")
    return dict(pre=pre, ell=ell, b=b, counts=counts, iters=res.iterations)


def run_cloth_bf16(f32: dict, tol: float = 1e-4) -> dict:
    """The grid path with bf16 inverse storage: a bf16 DenseInverseCM applied
    by K3's bf16 entry through dense_symv_cm, K4 behind the SpMV."""
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.ops import gridstencil
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.ops.cuda.packed_symv import DenseInverseCM
    from precond_tpu_torch.ops.gridapply import precondition_grid_cm
    from precond_tpu_torch.parallel.pcg import pcg
    from precond_tpu_torch.solver import prepare_grid
    from precond_tpu_torch.utils import gridmorton as gm

    grid, k, ssys = f32["grid"], f32["k"], f32["ssys"]
    dgr, drr, offsets = f32["dgr"], f32["drr"], f32["offsets"]
    label = f"cloth {grid} bf16"
    cfg = SchwarzConfig(inverse_dtype="bfloat16")
    bt = f32["b"].T.contiguous()

    def spmv(p):
        return gridstencil.spmv_t(ssys, p)

    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    inv = prepare_grid(dgr, drr, offsets, k, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()

    def pre_op(r):
        return gm.morton_to_grid_cm(precondition_grid_cm(inv, gm.grid_to_morton_cm(r, k), cfg), k)

    res = pcg(spmv, pre_op, bt, tol=tol, max_iters=2000)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(_lib.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(isinstance(inv, DenseInverseCM) and inv.m.dtype == torch.bfloat16,
            f"{label}: expected a bf16 DenseInverseCM, got {type(inv).__name__}")
    log(f"[{label}] N={f32['n']} table {tuple(inv.m.shape)} {inv.m.dtype}; launches {counts}")
    require(counts["spd_inverse96"] == 1 and counts["packed_symv96"] == 0
            and counts["symv96_bf16"] >= res.iterations
            and counts["stencil_spmv"] >= res.iterations,
            f"{label}: K1 once, K3-bf16 and K4 every iteration expected, got {counts}")
    bf16_gate(label, res, tol, JAX_RECORD_BF16[("cloth", grid, None)])
    prepare_ms = time_ms(lambda: prepare_grid(dgr, drr, offsets, k, cfg), warmup=0, iters=2)
    apply_ms = time_ms(lambda: pre_op(bt), warmup=2, iters=10)
    ms_iter = 1e3 * (t2 - t1) / max(res.iterations, 1)
    log(f"[{label}] prepare_ms(first)={1e3 * (t1 - t0):.1f} prepare_ms={prepare_ms:.1f} "
        f"apply_ms={apply_ms:.3f} ms_per_iter={ms_iter:.3f} peak_mem_gb={peak_gb:.2f} "
        f"(held before the run: {held_gb:.2f}); f32: prepare_ms={f32['prepare_ms']:.1f} "
        f"apply_ms={f32['apply_ms']:.3f} ms_per_iter={f32['ms_per_iter']:.3f} "
        f"peak_mem_gb={f32['peak_gb']:.2f} (held: {f32['held_gb']:.2f})")
    if grid == 1024:
        log(f"[{label}] dense bf16 apply_ms={apply_ms:.3f} against 0.395 with the earlier "
            f"symv96_bf16 design (PERF.md); host clock, so launch-bound: the device's "
            f"share of one apply follows")
        profile_phase(f"{label} apply", lambda: pre_op(bt), reps=20)
    z = pre_op(bt)
    require(torch.equal(z, pre_op(bt)), f"{label}: apply not bit-reproducible")
    return dict(inv=inv, counts=counts, iters=res.iterations)


def grid_holder(inv, k: int, cfg):
    """A SchwarzPreconditioner holding the grid path's state: the tile maps,
    the analytic hierarchy and a prepare_grid inverse (what a grid-path
    application checkpoints)."""
    import torch
    from precond_tpu_torch import SchwarzPreconditioner
    from precond_tpu_torch.ops import hierarchy as hi
    from precond_tpu_torch.ops.apply import ApplyState
    from precond_tpu_torch.ops.gridapply import analytic_hierarchy
    from precond_tpu_torch.solver import SortMaps
    from precond_tpu_torch.utils import gridmorton as gm

    n = 4**k
    hier = analytic_hierarchy(n, cfg, DEVICE)
    pre = SchwarzPreconditioner(cfg, device=DEVICE)
    pre.maps = SortMaps(gm.sort_index(k, device=DEVICE).to(torch.int32),
                        gm.sort_index(k, inverse=True, device=DEVICE).to(torch.int32))
    pre.state = ApplyState(pre.maps.sorted_to_orig, pre.maps.orig_to_sorted, hier.going_next,
                           hi.ancestor_node_ids(hier, cfg, n), inv, hier.overflow, hier.onehot,
                           hier.pos, hier.pb)
    pre.frame_index = 1
    return pre


def run_checkpoints(cases, sharded_case, tmp: str) -> None:
    """save_solver / load_solver of each case's solver into a fresh one on
    the card: the state and the apply bitwise equal, and a solve resumed from
    the saved x takes the same iterations to the same bits. Then one
    save_solver_sharded / load_solver_sharded round trip."""
    import torch
    from precond_tpu_torch import SchwarzPreconditioner
    from precond_tpu_torch.io import checkpoint, sharded
    from precond_tpu_torch.parallel.pcg import pcg

    def resume(pre, x0, spmv, make_op, b):
        return pcg(spmv, make_op(pre), b, x0=x0, tol=1e-4, max_iters=2000)

    for label, pre, spmv, make_op, b in cases:
        x_part = pcg(spmv, make_op(pre), b, tol=1e-4, max_iters=10).x
        path = os.path.join(tmp, label.replace(" ", "_") + ".npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_solver(path, pre, x=x_part)
        t1 = time.perf_counter()
        pre2 = SchwarzPreconditioner(pre.cfg, device=DEVICE)
        x2 = checkpoint.load_solver(path, pre2)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        same_state = same_bits(pre.state, pre2.state) and same_bits(pre.maps, pre2.maps)
        op, op2 = make_op(pre), make_op(pre2)
        same_apply = torch.equal(op(b), op2(b))
        r1, r2 = resume(pre, x_part, spmv, make_op, b), resume(pre2, x2, spmv, make_op, b)
        log(f"[checkpoint {label}] {type(pre.state.inv96).__name__}: file "
            f"{os.path.getsize(path) / 1e6:.1f} MB, save_ms={1e3 * (t1 - t0):.1f} "
            f"load_ms={1e3 * (t2 - t1):.1f}; state bitwise={same_state} apply bitwise={same_apply} "
            f"x bitwise={torch.equal(x2, x_part)}; resumed solve {r1.iterations} / "
            f"{r2.iterations} iterations, x bitwise={torch.equal(r1.x, r2.x)}")
        require(same_state and same_apply and torch.equal(x2, x_part),
                f"checkpoint {label}: the loaded solver differs")
        require(r1.iterations == r2.iterations and torch.equal(r1.x, r2.x),
                f"checkpoint {label}: the resumed solves differ")
        del pre2
        os.remove(path)

    label, pre, spmv, make_op, b = sharded_case
    path = os.path.join(tmp, "sharded")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded.save_solver_sharded(path, pre, x=b)
    t1 = time.perf_counter()
    pre2 = SchwarzPreconditioner(pre.cfg, device=DEVICE)
    x2 = sharded.load_solver_sharded(path, pre2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    same = (same_bits(pre.state, pre2.state) and same_bits(pre.maps, pre2.maps)
            and torch.equal(x2, b) and x2.device == b.device)
    same_apply = torch.equal(make_op(pre)(b), make_op(pre2)(b))
    log(f"[checkpoint sharded {label}] {type(pre.state.inv96).__name__}: {len(os.listdir(path))} "
        f"files, {size / 1e6:.1f} MB, save_ms={1e3 * (t1 - t0):.1f} load_ms={1e3 * (t2 - t1):.1f}; "
        f"state bitwise={same} apply bitwise={same_apply}; torch {torch.__version__}")
    require(same and same_apply, f"checkpoint sharded {label}: the loaded solver differs")


def run_profiling(cl: dict, trace_dir: str) -> None:
    """PhaseTimer around one cloth prepare and one solve (SolveMetrics JSON),
    and device_trace around one comp-major PCG iteration, whose Chrome trace
    must name K2's and K4's kernel symbols as CUDA kernel events."""
    import torch
    from precond_tpu_torch.ops import gridstencil
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.ops.gridapply import precondition_grid_cm
    from precond_tpu_torch.parallel.pcg import pcg
    from precond_tpu_torch.profiling import PhaseTimer, SolveMetrics, device_trace
    from precond_tpu_torch.solver import prepare_grid
    from precond_tpu_torch.utils import gridmorton as gm

    grid, k, cfg, ssys = cl["grid"], cl["k"], cl["cfg"], cl["ssys"]
    bt = cl["b"].T.contiguous()
    label = f"profiling cloth {grid}"

    def spmv(p):
        return gridstencil.spmv_t(ssys, p)

    timer = PhaseTimer()
    with timer.phase("prepare", sync=cl["dgr"]) as out:
        inv = prepare_grid(cl["dgr"], cl["drr"], cl["offsets"], k, cfg)
        out["sync"] = inv

    def pre_op(r):
        return gm.morton_to_grid_cm(precondition_grid_cm(inv, gm.grid_to_morton_cm(r, k), cfg), k)

    with timer.phase("iterate", sync=bt) as out:
        res = pcg(spmv, pre_op, bt, tol=1e-4, max_iters=2000)
        out["sync"] = res.x
    nnz = grid * grid + sum((grid - abs(di)) * (grid - abs(dj)) for di, dj in ssys.offsets)
    metrics = SolveMetrics(num_verts=grid * grid, nnz_blocks=nnz, iterations=res.iterations,
                           rel_residual=float(res.rel_residual), phase_ms=timer.as_dict())
    log(f"[{label}] SolveMetrics {metrics.to_json()}")
    require(res.iterations == cl["iters"] and float(res.rel_residual) <= 1e-4,
            f"{label}: the timed solve took {res.iterations} iterations, the counted run "
            f"{cl['iters']}")

    before = dict(_lib.launch_counts)
    with device_trace(trace_dir):
        pcg(spmv, pre_op, bt, tol=0.0, max_iters=1)
    launched = {k: v - before[k] for k, v in _lib.launch_counts.items() if v != before[k]}
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e.get("name", "") for e in kernels})
    found = {sym: sum(e.get("name", "").find(sym) >= 0 for e in kernels)
             for sym in ("packed_symv96_kernel", "stencil_spmv_kernel")}
    log(f"[{label}] device_trace of one PCG iteration: {os.path.getsize(path) / 1e6:.2f} MB, "
        f"{len(events)} events, {len(kernels)} CUDA kernel events of {len(names)} kernels; "
        f"K2 / K4 kernel events {found}, launches in the traced call {launched}")
    require(all(found.values()), f"{label}: the trace does not name K2's and K4's kernels")


# ---------------------------------------------------------------------------
# multiple ranks (slice 9): child processes of this script, one per rank
# ---------------------------------------------------------------------------

# a child job's time limit (every rank of it); the parent kills the job's
# ranks past it and fails
RANK_TIMEOUT = 420
# the JAX tests' x tolerance (tests/test_halo.py:46-48): rtol, atol * max|x|
X_RTOL, X_ATOL = 5e-3, 5e-4
# iteration bands against the single-rank count: tests/test_halo.py's 3 on
# the halo path, tests/test_gridsharded.py:38's +5 on the grid path
HALO_BAND, GRID_BAND = 3, 5
# the bench's general 256 solver and its known x (rows differ), which the
# checkpoint round trips carry
DCP_GRID = 256


def run_ranks(job: str, world: int, backend: str, out: str, extra=()) -> list:
    """Run `job` as `world` rank processes of this script sharing the card
    (cuda:0) through hosts.launch_local_ranks, with the time limit
    RANK_TIMEOUT: a rank that fails or outlasts it kills the others and
    fails the phase. Returns each rank's JSON result; prints each rank's
    log lines."""
    from precond_tpu_torch.parallel import hosts

    try:
        logs = hosts.launch_local_ranks(
            [sys.executable, os.path.abspath(__file__), "--rank-worker", job, "--backend", backend,
             "--out", out, *extra], world, RANK_TIMEOUT, out)
    except RuntimeError as e:
        raise SmokeFailure(f"{job} on {world} {backend} ranks: {e}") from None
    results = []
    for r in range(world):
        for line in logs[r].splitlines():
            if line.startswith("["):
                log(f"  [{job} rank {r}/{world}] {line}")
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _rows_ok(x, ref, start: int, stop: int) -> float:
    """Max |x - ref rows| / max|ref|; fails past the JAX tests' tolerance."""
    import torch

    want = ref[start:stop]
    scale = float(ref.abs().max())
    ok = bool(((x - want).abs() <= X_RTOL * want.abs() + X_ATOL * scale).all())
    require(ok and torch.isfinite(x).all().item(),
            f"rows {start}:{stop} of x differ from the single-rank x beyond rtol {X_RTOL}, "
            f"atol {X_ATOL} max|x|")
    return float((x - want).abs().max()) / scale


def _counted(group, fn, timer, timing: bool = True):
    """Run fn() as a counted run: launch counts, collective stats, the peak
    memory from zero and the phases of `timer` (which fn fills). With
    `timing` the device is synchronized around every collective, so the
    collective ms hold the device's share (and the run is slower); without
    it the phases are the step's own pace. Returns (result, counts, comm,
    peak_gb, phases_ms)."""
    import torch
    from precond_tpu_torch.ops.cuda import _lib

    group.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    group.stats.reset()
    group.timing = timing
    t0 = time.perf_counter()
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        group.timing = False
    comm = dict(calls=group.stats.calls, bytes=group.stats.bytes,
                ms=round(1e3 * group.stats.seconds, 3),
                wall_ms=round(1e3 * (time.perf_counter() - t0), 3))
    return (res, dict(_lib.launch_counts), comm, torch.cuda.max_memory_allocated() / 1e9,
            timer.as_dict())


def _summary(label: str, rank: int, world: int, runs: list, ref_iters: int, err: float,
             same: bool) -> dict:
    """runs: [(PcgResult, counts, comm, peak_gb, phases)] of the counted run
    (synchronized around each collective) and its repeat (unsynchronized:
    its ms/iter is the step's pace)."""
    (res, counts, comm, peak_gb, phases), (_, _, comm2, _, phases2) = runs
    iters = res.iterations
    it_ms = phases.get("iterate", 0.0) / max(iters, 1)
    it2_ms = phases2.get("iterate", 0.0) / max(iters, 1)
    out = dict(iters=iters, ref_iters=ref_iters, rel=float(res.rel_residual), err=err,
               counts={k: v for k, v in counts.items() if v}, comm=comm, peak_gb=round(peak_gb, 3),
               phases=phases, ms_per_iter=round(it_ms, 4), bitwise=same,
               comm_bytes_per_iter=comm["bytes"] // max(iters, 1), repeat_phases=phases2,
               repeat_ms_per_iter=round(it2_ms, 4), repeat_comm=comm2)
    log(f"[{label}] rank {rank}/{world}: iters={iters} (single rank {ref_iters}) "
        f"rel_residual={out['rel']:.3e} x vs single rank {err:.2e} of max|x|; counted run "
        f"(synced around each collective): phases_ms={phases} ms_per_iter={it_ms:.3f}, "
        f"collectives {comm['calls']} calls, {comm['ms']:.1f} ms, "
        f"{comm['bytes'] / 1e6:.2f} MB sent ({out['comm_bytes_per_iter'] / 1e6:.3f} MB/iter); "
        f"peak_mem_gb={peak_gb:.2f}; launches {out['counts']}; repeat (unsynced): "
        f"phases_ms={phases2} ms_per_iter={it2_ms:.3f}, host ms in collectives "
        f"{comm2['ms']:.1f}; bitwise={same}")
    return out


def job_general(group, args) -> dict:
    """The general-mesh step over the group: sharded_solve_step at general
    `size` (packed: K2 per rank; dense: K3 per rank), against solve_step on
    one rank; K2's or K3's per-rank table against its plain version; the
    checkpoint round trip from a one-rank save when asked."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.parallel import halo
    from precond_tpu_torch.parallel.comm import row_range
    from precond_tpu_torch.parallel.sharded import sharded_solve_step, solve_step
    from precond_tpu_torch.profiling import PhaseTimer
    from precond_tpu_torch.solver import compute_sort_maps, prepare_with_system

    mesh = cloth.make_grid(args.size, args.size, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    n = mesh.num_verts
    ell = cloth.assemble_system(mesh, device=DEVICE)
    maps = compute_sort_maps(torch.as_tensor(mesh.positions, device=DEVICE))
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32),
                        device=DEVICE)
    start, stop = row_range(n, group.world, group.rank)
    out = {}
    for variant in args.variants.split(","):
        cfg = SchwarzConfig(symv_kernel=variant)
        label = f"sharded general {args.size} {variant}, {group.world} {group.backend} ranks"
        one = solve_step(ell, maps, b, cfg, max_iters=2000, device=DEVICE)
        runs = []
        for timing in (True, False):   # the counted run and an unsynced repeat
            timer = PhaseTimer()
            step = sharded_solve_step(group, cfg, max_iters=2000, device=DEVICE, timer=timer)
            runs.append(_counted(group, lambda: step(ell, maps, b), timer, timing))
        res, counts, again = runs[0][0], runs[0][1], runs[1][0]
        same = again.iterations == res.iterations and torch.equal(again.x, res.x)
        err = _rows_ok(res.x, one.x, start, stop)
        packed = cfg.use_packed_symv(n)
        symv = "packed_symv96" if packed else "symv96"
        out[variant] = _summary(label, group.rank, group.world, runs, one.iterations, err, same)
        require(abs(res.iterations - one.iterations) <= HALO_BAND and float(res.rel_residual) <= 1e-4,
                f"{label}: {res.iterations} iterations against {one.iterations} on one rank")
        require(same, f"{label}: two runs are not bitwise equal")
        require(counts["spd_inverse96"] == 1 and counts[symv] == 2 * (res.iterations + 1),
                f"{label}: launches {counts}; expected K1 once and {symv} 2 x (iterations + 1)")
        # this rank's fine table (its own padded copy) against the plain version
        state, _ = prepare_with_system(ell, maps, cfg)
        rows = -(-n // (group.world * 32)) * group.world * 32
        la = halo.local_apply_state(halo.split_apply_state(state, cfg, n, group.world, rows=rows),
                                    group.rank, rows // group.world)
        tag = f"{label} rank {group.rank} fine table"
        out[variant]["table_err"] = (check_packed_symv_table(la.inv_fine, tag) if packed
                                     else check_symv(la.inv_fine, tag)[0])
        out[variant]["table_b"] = int(la.inv_fine.f.shape[2] if packed else la.inv_fine.shape[0])
        del state, la, one, res, again, runs
        torch.cuda.empty_cache()
    if args.dcp_load:
        out["dcp_from_one"] = dcp_load_rows(args.dcp_load, 3.0, group)
    return out


def job_collide(group, args) -> dict:
    """Contact on the halo path: the bench's folded sheet at `size`, detected
    on every rank, prepared with the stencils, solved by halo.solve_sorted
    with the sorted-space stencils replicated, against the single-rank
    sorted-space PCG (block-ELL + slot contact SpMV)."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.apply import precondition_sorted
    from precond_tpu_torch.ops.blockcsr import spmv as ell_spmv
    from precond_tpu_torch.ops.contact import slot_contact_spmv
    from precond_tpu_torch.parallel import halo
    from precond_tpu_torch.parallel.pcg import pcg
    from precond_tpu_torch.profiling import PhaseTimer

    label = f"halo collide {args.size} (general M), {group.world} {group.backend} ranks"
    mesh, folded, h = folded_sheet(args.size)
    n = mesh.num_verts
    ell = cloth.assemble_system(mesh, positions=folded, device=DEVICE)
    pos, faces, edges = (torch.as_tensor(a, device=DEVICE) for a in (folded, mesh.faces, mesh.edges))
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32),
                        device=DEVICE)
    cfg = SchwarzConfig(coarse_damping=0.25)
    _, _, st, live = detect_collide(pos, faces, edges, h)
    ref = SchwarzPreconditioner(cfg, device=DEVICE)
    ref.allocate(folded)
    ref.prepare(ell, st)
    ells, mapped, slots = collide_system(ref, ell, st)
    bs = b[ref.maps.sorted_to_orig.long()]
    one = pcg(lambda x: ell_spmv(ells, x) + slot_contact_spmv(mapped, slots, x),
              lambda r: precondition_sorted(ref.state, r, cfg), bs, tol=1e-4, max_iters=2000)
    def solve(timer):
        pre = SchwarzPreconditioner(cfg, device=DEVICE)
        pre.allocate(folded)
        with timer.phase("prepare") as ph:
            pre.prepare(ell, st)
            ph["sync"] = pre.state.going_next
        with timer.phase("tables"):
            hsys = halo.build_halo_system(ells, group.world)
            sap = halo.split_apply_state(pre.state, cfg, n, group.world)
        with timer.phase("iterate") as ph:
            res = halo.solve_sorted(group, cfg, hsys, sap, bs, max_iters=2000, stencils=mapped)
            ph["sync"] = res.x
        return res, hsys

    runs = []
    for timing in (True, False):   # the counted run and an unsynced repeat
        timer = PhaseTimer()
        runs.append(_counted(group, lambda: solve(timer), timer, timing))
    (res, hsys), counts = runs[0][0], runs[0][1]
    again = runs[1][0][0]
    runs = [(r[0][0],) + tuple(r[1:]) for r in runs]
    same = again.iterations == res.iterations and torch.equal(again.x, res.x)
    per = n // group.world
    err = _rows_ok(res.x, one.x, group.rank * per, (group.rank + 1) * per)
    out = _summary(label, group.rank, group.world, runs, one.iterations, err, same)
    out.update(live=live, halo=hsys.halo, exchange_rows=int(hsys.recv_perm.shape[1]))
    band = COLLIDE_BAND[0] * one.iterations
    require(abs(res.iterations - one.iterations) <= band and float(res.rel_residual) <= 1e-4,
            f"{label}: {res.iterations} iterations against {one.iterations} on one rank "
            f"(band +-{band:.0f})")
    require(same, f"{label}: two runs are not bitwise equal")
    require(counts["spd_inverse96"] == 1 and counts["symv96"] == 2 * (res.iterations + 1),
            f"{label}: launches {counts}")
    return out


def job_grid(group, args) -> dict:
    """The grid steps over the group: sharded_grid_solve_step on cloth `size`
    and sharded_grid_contact_solve_step on the folded sheet at `collide`
    (K4 and K3 per rank), each against its single-rank step; then the
    collective checkpoint save of this group when asked."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.contact import build_contact_ell
    from precond_tpu_torch.parallel import gridsharded as gsh
    from precond_tpu_torch.profiling import PhaseTimer
    from precond_tpu_torch.utils import gridmorton as gm

    out = {}
    for case, side in (("cloth", args.size), ("collide", args.collide)):
        k = side.bit_length() - 1
        n = side * side
        per = n // group.world
        if case == "cloth":
            label = f"sharded grid cloth {side}, {group.world} {group.backend} ranks"
            mesh = cloth.make_grid(side, side, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
            pos, cfg = None, SchwarzConfig()
        else:
            label = f"sharded grid collide {side} (grid M), {group.world} {group.backend} ranks"
            mesh, pos, h = folded_sheet(side)
            cfg = SchwarzConfig(coarse_damping=0.25)
        ssys = cloth.assemble_system_stencil(mesh, positions=pos, device=DEVICE)
        dgr, drr, offsets = cloth.assemble_system_grid(mesh, positions=pos, device=DEVICE)
        b = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32),
                            device=DEVICE)
        timer = PhaseTimer()   # the counted run's
        if case == "cloth":
            one = gsh.grid_solve_step(ssys, dgr, drr, b, offsets, k, cfg, max_iters=2000)

            def make(t):
                return lambda: gsh.sharded_grid_solve_step(
                    group, cfg, ssys.offsets, k, max_iters=2000, device=DEVICE,
                    timer=t)(ssys, dgr, drr, b)
        else:
            tens = (torch.as_tensor(a, device=DEVICE) for a in (pos, mesh.faces, mesh.edges))
            _, _, st, live = detect_collide(*tens, h)
            ce = build_contact_ell(st, n, kc=32)
            require(int(ce.dropped) == 0, f"{label}: the contact ELL dropped {int(ce.dropped)} pairs")
            o2s = torch.as_tensor(gm.sort_maps(k)[1], device=DEVICE)
            one = gsh.grid_contact_solve_step(ssys, dgr, drr, b, st, ce, o2s, offsets, k, cfg,
                                              max_iters=2000)

            def make(t):
                return lambda: gsh.sharded_grid_contact_solve_step(
                    group, cfg, offsets, k, max_iters=2000, device=DEVICE,
                    timer=t)(ssys, dgr, drr, b, st, ce, o2s)
        runs = [_counted(group, make(timer), timer)]
        timer = PhaseTimer()
        runs.append(_counted(group, make(timer), timer, False))   # an unsynced repeat
        res, counts, again = runs[0][0], runs[0][1], runs[1][0]
        same = again.iterations == res.iterations and torch.equal(again.x, res.x)
        scale = float(one.x.abs().max())
        want = one.x[group.rank * per: (group.rank + 1) * per]
        err = float((res.x - want).abs().max()) / scale
        out[case] = _summary(label, group.rank, group.world, runs, one.iterations, err, same)
        require(err <= X_ATOL and torch.isfinite(res.x).all().item(),
                f"{label}: x differs from the single-rank x by {err:.2e} of max|x| "
                f"(the JAX test's atol {X_ATOL})")
        require(res.iterations <= one.iterations + GRID_BAND and float(res.rel_residual) <= 1e-4,
                f"{label}: {res.iterations} iterations against {one.iterations} on one rank")
        require(same, f"{label}: two runs are not bitwise equal")
        require(counts["spd_inverse96"] == 1 and counts["stencil_spmv"] == res.iterations + 1
                and counts["symv96"] == 2 * (res.iterations + 1), f"{label}: launches {counts}")
        del one, res, again, runs, ssys, dgr, drr
        torch.cuda.empty_cache()
    if args.dcp_save:
        out["dcp_save"] = dcp_save_rows(args.dcp_save, group)
    return out


def _script(name: str):
    """scripts/<name>.py as a module (imported once), with scripts/ on
    sys.path, where the dissection twins import each other from."""
    import importlib

    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def _worker_module():
    """scripts/torch_multiprocess_worker.py, whose checkpoint helpers the DCP
    phases share with the CPU tests."""
    return _script("torch_multiprocess_worker")


def dcp_solver():
    """The solver state the checkpoint phases carry: general DCP_GRID's."""
    return _worker_module().dcp_solver(DEVICE, DCP_GRID)


def dcp_x(scale: float):
    """A known x whose rows all differ (a lost shard shows), on the card."""
    import torch

    return torch.as_tensor(_worker_module().dcp_x(scale, DCP_GRID * DCP_GRID), device=DEVICE)


def dcp_save_rows(path: str, group) -> dict:
    """Collective save: each rank writes only its rows of x (a DTensor
    Shard(0)) and the replicated solver state; then reads its rows back."""
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.io import sharded as shio
    from precond_tpu_torch.parallel.comm import row_range

    pre = dcp_solver()
    x = dcp_x(2.0)
    start, stop = row_range(x.shape[0], group.world, group.rank)
    group.barrier()
    t0 = time.perf_counter()
    shio.save_solver_sharded(path, pre, x=shio.shard_rows(x[start:stop], x.shape[0]))
    t1 = time.perf_counter()
    back = SchwarzPreconditioner(SchwarzConfig(), device=DEVICE)
    rows = shio.load_solver_sharded(path, back, x_rows=True)
    t2 = time.perf_counter()
    same = same_bits(back.state, pre.state) and bool((rows == x[start:stop]).all().item())
    log(f"[checkpoint DCP {group.world} ranks] rank {group.rank}: saved rows {start}:{stop} of x "
        f"and the state in {1e3 * (t1 - t0):.1f} ms, read them back in {1e3 * (t2 - t1):.1f} ms; "
        f"bitwise={same}")
    require(same, f"DCP {group.world} ranks: rank {group.rank}'s rows or state came back changed")
    return dict(save_ms=round(1e3 * (t1 - t0), 1), load_ms=round(1e3 * (t2 - t1), 1), same=same)


def dcp_load_rows(path: str, scale: float, group) -> dict:
    """Collective load of a one-rank save onto the group: each rank reads
    only its rows of x and the whole solver state."""
    import torch
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.io import sharded as shio
    from precond_tpu_torch.parallel.comm import row_range

    pre = dcp_solver()
    x = dcp_x(scale)
    start, stop = row_range(x.shape[0], group.world, group.rank)
    back = SchwarzPreconditioner(SchwarzConfig(), device=DEVICE)
    t0 = time.perf_counter()
    rows = shio.load_solver_sharded(path, back, x_rows=True)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    same = same_bits(back.state, pre.state) and torch.equal(rows, x[start:stop])
    log(f"[checkpoint DCP 1 -> {group.world} ranks] rank {group.rank}: rows {start}:{stop} of x and "
        f"the state in {ms:.1f} ms; bitwise={same}")
    require(same, f"DCP 1 -> {group.world}: rank {group.rank}'s rows or state differ")
    return dict(load_ms=round(ms, 1), same=same)


JOBS = {"general": job_general, "collide": job_collide, "grid": job_grid}


def rank_worker(args) -> int:
    """One rank of a child job: join the group, run the job, write JSON."""
    import torch

    from precond_tpu_torch.parallel import hosts

    torch.set_num_threads(max(1, (os.cpu_count() or 8) // args.world))
    group = hosts.initialize_hosts(args.init, args.world, args.rank, backend=args.backend,
                                   device=DEVICE)
    try:
        result = JOBS[args.rank_worker](group, args)
    finally:
        hosts.shutdown_hosts()
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def run_multirank(args, tmp: str) -> dict:
    """The multi-rank phases, each a child job: the grid steps on 2 gloo
    ranks (then their DCP save), the DCP round trips through this process
    (2 -> 1) and back (1 -> 2), the general step on 2 and 4 gloo ranks
    (packed and dense) and on 1 NCCL rank, and the halo collide on 4 gloo
    ranks. Returns the per-rank launch counts by path."""
    import torch
    from precond_tpu_torch import SchwarzPreconditioner
    from precond_tpu_torch.io import sharded as shio

    counts = {}

    def keep(label, results, pick):
        for r, res in enumerate(results):
            counts[f"{label} r{r}"] = pick(res)["counts"]

    save2 = os.path.join(tmp, "dcp_w2")
    grid = run_ranks("grid", 2, "gloo", os.path.join(tmp, "grid2"),
                     ("--size", str(args.cloth), "--collide", str(args.collide),
                      "--dcp-save", save2))
    keep(f"sharded grid cloth {args.cloth} (2 gloo)", grid, lambda r: r["cloth"])
    keep(f"sharded grid collide {args.collide} (2 gloo)", grid, lambda r: r["collide"])
    # 2 -> 1: this process, with no process group, reads both ranks' rows
    pre = dcp_solver()
    back = SchwarzPreconditioner(pre.cfg, device=DEVICE)
    t0 = time.perf_counter()
    x = shio.load_solver_sharded(save2, back)
    ms = 1e3 * (time.perf_counter() - t0)
    same = same_bits(back.state, pre.state) and torch.equal(x, dcp_x(2.0))
    log(f"[checkpoint DCP 2 -> 1] the 2-rank save read whole by one process in {ms:.1f} ms: "
        f"x ({x.shape[0]} rows from both ranks) and the state bitwise={same}")
    require(same, "DCP 2 -> 1: the rows or the state differ")
    save1 = os.path.join(tmp, "dcp_w1")
    shio.save_solver_sharded(save1, pre, x=dcp_x(3.0))
    del pre, back, x
    torch.cuda.empty_cache()

    gen2 = run_ranks("general", 2, "gloo", os.path.join(tmp, "general2"),
                     ("--size", str(args.grid), "--variants", "dense,packed", "--dcp-load", save1))
    gen4 = run_ranks("general", 4, "gloo", os.path.join(tmp, "general4"),
                     ("--size", str(args.grid), "--variants", "packed,dense"))
    for world, res in ((2, gen2), (4, gen4)):
        for v in ("packed", "dense"):
            keep(f"halo general {args.grid} {v} ({world} gloo)", res, lambda r, v=v: r[v])
    nccl = run_ranks("general", 1, "nccl", os.path.join(tmp, "general1"),
                     ("--size", str(args.grid), "--variants", "auto"))
    keep(f"sharded general {args.grid} (1 NCCL)", nccl, lambda r: r["auto"])
    col = run_ranks("collide", 4, "gloo", os.path.join(tmp, "collide4"),
                    ("--size", str(args.collide)))
    keep(f"halo collide {args.collide} (4 gloo)", col, lambda r: r)
    return counts


def bench_bands(config: str, grid: int):
    """Accepted (lo, hi) Schwarz and Jacobi iterations of a bench_torch row:
    the bands this script holds each path's own run to, around the same JAX
    records. The bench tests convergence every 8 iterations, so the collide
    sheet's relative bands (its record tests every iteration) end at the next
    multiple of 8. None where the JAX package has no iteration record (the
    north star: no JAX run converged at 2048^2)."""
    if grid == NORTH_STAR:
        return None
    if config == "collide":
        rec = JAX_RECORD_COLLIDE_GRID[grid][:2]
        return tuple((r * (1 - b), -(-r * (1 + b) // 8) * 8) for r, b in zip(rec, COLLIDE_BAND))
    rec = {"general": JAX_RECORD_ITERS, "cloth": JAX_RECORD_ITERS_CLOTH,
           "tet": JAX_RECORD_ITERS_TET}[config][grid]
    return tuple((r - b, r + b) for r, b in zip(rec, CLOTH_BAND))


def bench_row_faults(row: dict) -> list:
    """What is wrong with one bench_torch row, against the JAX records."""
    import math

    if "error" in row:
        return [f"error {row['error']}"]
    faults = []
    for key in ("schwarz_rel", "jacobi_rel"):
        if not (math.isfinite(row[key]) and row[key] <= 1e-4):
            faults.append(f"{key} {row[key]}")
    if not row["value"] > 0:
        faults.append(f"value {row['value']}")
    spec = (row["config"], row["grid"])
    for key, (lo, hi) in zip(("schwarz_iters", "jacobi_iters"), bench_bands(*spec) or ()):
        if not lo <= row[key] <= hi:
            faults.append(f"{key} {row[key]} outside [{lo:g}, {hi:g}]")
    want = JAX_RECORD_BENCH_NNZ.get(spec)
    if want and (row["nnz_spmv"], row["nnz_apply"]) != want:
        faults.append(f"nnz {row['nnz_spmv']} / {row['nnz_apply']}, JAX record {want[0]} / {want[1]}")
    return faults


def run_bench(specs, reps: int = BENCH_REPS) -> dict:
    """The port's bench (bench_torch.run_config) on each (config, grid), on
    the card, with `reps` solve reps; prints each row, its launch counts
    and wall, and fails if any row errs or leaves the JAX records. Returns
    the launch counts by path."""
    import bench_torch
    from precond_tpu_torch.ops.cuda import _lib

    counts, faults = {}, []
    saved = os.environ.get("BENCH_SOLVE_REPS")
    os.environ["BENCH_SOLVE_REPS"] = str(reps)
    try:
        for config, grid in specs:
            _lib.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                row = bench_torch.run_config(config, grid)
            except Exception as e:  # noqa: BLE001 -- every config runs; the fault fails below
                row = {"metric": "pcg_iteration_nnz_throughput", "config": config, "grid": grid,
                       "error": f"{type(e).__name__}: {e}"[:300]}
            wall = time.perf_counter() - t0
            path = f"bench {config} {grid}"
            counts[path] = dict(_lib.launch_counts)
            log(f"[bench] {json.dumps(row)}")
            bad = bench_row_faults(row)
            if "error" not in row and counts[path]["spd_inverse96"] < 1:
                bad.append("the inverse kernel never launched")
            log(f"[bench launches] {path}: {counts[path]}; run_config {wall:.1f} s; "
                f"{'; '.join(bad) if bad else 'held to the JAX records'}")
            faults += [f"{path}: {b}" for b in bad]
    finally:
        if saved is None:
            os.environ.pop("BENCH_SOLVE_REPS")
        else:
            os.environ["BENCH_SOLVE_REPS"] = saved
    require(not faults, "bench: " + "; ".join(faults))
    return counts


def dissect_faults(ms: dict, repeats: dict, launched: dict, trace_error=None) -> list:
    """What is wrong with a [dissect] run: a line whose time is not a
    finite positive number (ms by line), a `full` variant whose K-iteration
    result did not repeat bit for bit (repeats by script), a kernel of
    DISSECT_KERNELS launched no time in the phase (launched: summed counts),
    a trace that could not be parsed."""
    import math

    faults = [f"{name}: {v} ms" for name, v in ms.items() if not (math.isfinite(v) and v > 0)]
    faults += [f"{name}: the full variant's result does not repeat bit for bit"
               for name, same in repeats.items() if not same]
    faults += [f"{k} never launched" for k in DISSECT_KERNELS if launched.get(k, 0) < 1]
    if trace_error is not None:
        faults.append(f"trace: {trace_error}")
    return faults


def run_dissect(trace_dir: str, sizes: dict = DISSECT, ks: dict = DISSECT_K,
                device: str = DEVICE, micro_sizes=None) -> tuple:
    """The [dissect] phase: each twin of the JAX measurement suite through
    its module functions, its lines prefixed "[dissect <script> <side>]",
    with the launch counts set to 0 before each part and read after it; the
    `full` variants run again and must repeat bit for bit; a device_trace of
    DISSECT_TRACE_ITERS `full` comp-major iterations, parsed by
    torch_parse_trace. Returns (launch counts by path, faults)."""
    import gc

    import torch
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.profiling import device_trace

    dev = torch.device(device)
    dc = _script("torch_dissect_common")
    counts, ms, repeats = {}, {}, {}

    def part(name: str, side, fn):
        label = f"dissect {name}" + (f" {side}" if side else "")
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(lambda m: log(f"[{label}] {m}"))
        dc.sync(dev)
        counts[label] = dict(_lib.launch_counts)
        for line, t in out.items():
            ms[f"{label}: {line}"] = t["ms"]
        log(f"[{label}] launches {counts[label]}; {time.perf_counter() - t0:.1f} s")

    def iterations(name: str):
        """A PCG-iteration twin's variants, and the bitwise repeat of `full`."""
        mod = _script(f"torch_profile_{name}")
        side, k = sizes[name], ks[name]
        s = mod.setup(side, dev)

        def go(say):
            say(f"grid={s.grid} n={s.n} K={k} inv={type(s.inv).__name__}")
            out = mod.run_variants(s, k, log=say)
            again = mod.k_iterations(s, *mod.VARIANTS["full"], k)
            repeats[f"{name} {side}"] = same_bits(out["full"]["out"], again)
            say(f"full repeats bit for bit: {repeats[f'{name} {side}']}")
            return out

        part(name, side, go)
        return mod, s

    t_phase = time.perf_counter()
    cm, s = iterations("iteration_cm")
    trace_error = None
    _lib.reset_launch_counts()
    with device_trace(trace_dir):
        cm.k_iterations(s, *cm.VARIANTS["full"], DISSECT_TRACE_ITERS)
    counts[f"dissect trace {s.grid}"] = dict(_lib.launch_counts)
    parse = _script("torch_parse_trace")
    try:
        summary = parse.summarize(parse.load(os.path.join(trace_dir, "trace.json")),
                                  reps=DISSECT_TRACE_ITERS)
        for line in parse.table(summary, top=DISSECT_TRACE_TOP):
            log(f"[dissect trace {s.grid}] {line}")
    except SystemExit as e:
        trace_error = str(e)
        log(f"[dissect trace {s.grid}] {trace_error}")
    del s
    iterations("iteration")

    apply_mod = _script("torch_profile_apply")
    sa = apply_mod.setup(sizes["apply"], dev)
    part("apply", sizes["apply"], lambda say: apply_mod.run_components(sa, ks["apply"], log=say))
    fine = _script("torch_profile_apply_fine")
    sf = fine.setup(sizes["apply_fine"], dev,
                    ell=sa.ell if sizes["apply_fine"] == sizes["apply"] else None)
    part("apply_fine", sizes["apply_fine"],
         lambda say: fine.run_components(sf, ks["apply_fine"], log=say))
    del sf
    prep = _script("torch_profile_prepare")
    sp = prep.setup(sizes["prepare"], dev, ell=sa.ell if sizes["prepare"] == sizes["apply"] else None)
    del sa
    gc.collect()

    def prepare_part(say):
        firsts = prep.first_prepares(sp, log=say)
        out = prep.run_components(prep.component_inputs(sp), ks["prepare"], log=say)
        return {**{name: {"ms": v} for name, v in firsts.items()}, **out}

    part("prepare", sizes["prepare"], prepare_part)
    del sp
    gc.collect()
    for name in ("prepare_grid", "assembly"):
        mod = _script(f"torch_profile_{name}")
        sx = mod.setup(sizes[name], dev)
        part(name, sizes[name], lambda say: mod.run_lines(sx, ks[name], log=say))
        del sx
        gc.collect()
    micro = _script("torch_micro_bench")
    part("micro_bench", None,
         lambda say: micro.run(dev, micro_sizes or micro.SIZES, log=say))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launched = {}
    for c in counts.values():
        for k, v in c.items():
            launched[k] = launched.get(k, 0) + v
    faults = dissect_faults(ms, repeats, launched, trace_error)
    wall = time.perf_counter() - t_phase
    log(f"[dissect] {len(ms)} lines, kernels launched {launched}; phase wall {wall:.1f} s "
        f"(budget {DISSECT_BUDGET_S} s: {'within' if wall <= DISSECT_BUDGET_S else 'OVER'}); "
        f"{'; '.join(faults) if faults else 'every gate held'}")
    return counts, faults


def probe_band(rec: int, stiff: float) -> tuple:
    """The accepted (lo, hi) iterations around a record at a stiffness."""
    rel, floor = PROBE_BANDS[stiff]
    half = max(rel * rec, floor)
    return rec - half, rec + half


def scan_records(rec: dict) -> dict:
    """One stiffness's record as {(script, column): iterations}, in the
    twins' column names."""
    out = {("stiff", k): rec[k] for k in ("static", "general", "jacobi")}
    out.update({("damping", th): v for th, v in zip((1.0, 0.5, 0.25, 0.125), rec["damped"])})
    out[("damping", "jacobi")] = rec["jacobi"]
    out.update({("isosort", "axis"): rec["per_axis"], ("isosort", "iso"): rec["iso"],
                ("isosort", "jacobi"): rec["jacobi"]})
    return out


def probe_faults(iters: list, same: dict, launched: dict, ms: dict) -> list:
    """What is wrong with a [contact probes] run: an iteration count outside
    its band (iters: (label, got, record, stiffness)), a check that did not
    hold (same: label -> bool: bitwise repeats and variants, the contact
    SpMV forms' agreement), a kernel of DISSECT_KERNELS launched no time
    (launched: summed counts), a time that is not a finite positive number."""
    import math

    faults = []
    for label, got, rec, stiff in iters:
        lo, hi = probe_band(rec, stiff)
        if not lo <= got <= hi:
            faults.append(f"{label}: {got} iterations outside [{lo:g}, {hi:g}] (JAX {rec})")
    faults += [f"{label} does not hold" for label, ok in same.items() if not ok]
    faults += [f"{k} never launched" for k in DISSECT_KERNELS if launched.get(k, 0) < 1]
    faults += [f"{name}: {v} ms" for name, v in ms.items() if not (math.isfinite(v) and v > 0)]
    return faults


def run_contact_probes(sizes: dict = PROBES, stiffs=PROBE_STIFFS, ks: dict = PROBE_K,
                       scan_records_by_side: dict = JAX_RECORD_PROBE_SCANS,
                       contact_records: dict = JAX_RECORD_PROBE_CONTACT,
                       device: str = DEVICE, scatter_sizes=None) -> tuple:
    """The [contact probes] phase: the twins of the JAX contact-regime probes
    through their module functions, each part's lines prefixed "[probe
    <script> <side>]", with the launch counts set to 0 before each part and
    read after it: the three scans (stiffness, damping, Morton sort) at
    sizes["scans"], held to the JAX records' bands; probe_contact at
    sizes["contact"] (the prepare split, the composed loop per contact SpMV
    form, the static and general solves against their records, the three
    SpMV forms against each other, the slots loop repeated bit for bit);
    probe_crossing_fix at sizes["crossing_fix"] (the crossing variants bit
    for bit, the stream loop repeated); probe_scatter_cost's primitives.
    Returns (launch counts by path, faults)."""
    import gc

    import numpy as np
    import torch
    from precond_tpu_torch.ops.cuda import _lib

    dev = torch.device(device)
    dc = _script("torch_dissect_common")
    pc = _script("torch_probe_common")
    counts, iters, same, ms = {}, [], {}, {}

    def part(name: str, side, fn):
        label = f"probe {name}" + (f" {side}" if side else "")
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        fn(lambda m: log(f"[{label}] {m}"))
        dc.sync(dev)
        counts[label] = dict(_lib.launch_counts)
        log(f"[{label}] launches {counts[label]}; {time.perf_counter() - t0:.1f} s")

    t_phase = time.perf_counter()
    side = sizes["scans"]
    sheet = pc.setup(side, dev)
    recs = {st: scan_records(scan_records_by_side[side][st]) for st in stiffs}
    for name in ("stiff", "damping", "isosort"):
        mod = _script(f"torch_probe_{name}")

        def scan(say, mod=mod, name=name):
            say(f"n={sheet.n} stencils={sheet.live}")
            for stiff, row in mod.run(sheet, stiffs, log=say).items():
                for col, r in row.items():
                    iters.append((f"{name} {side} stiff {stiff:g} {col}", r["iters"],
                                  recs[stiff][(name, col)], stiff))
                    ms[f"{name} {side} stiff {stiff:g} {col}"] = r["ms_per_iter"]

        part(name, side, scan)
    del sheet
    gc.collect()

    contact = _script("torch_probe_contact")
    side, k = sizes["contact"], ks["contact"]
    s = contact.setup(side, dev)

    def contact_part(say):
        say(f"n={s.n} stencils={s.live} (slots={s.st.idx.numel()})")
        for name, t in contact.prepare_walls(s, log=say).items():
            ms[f"contact {side} {name}"] = t["best_s"] * 1e3
        forms = contact.run_forms(s, k, log=say)
        ms.update({f"contact {side} iter[{f}]": t["ms"] for f, t in forms.items()})
        same[f"contact {side}: the slots loop repeats bit for bit"] = same_bits(
            forms["slots"]["out"], contact.k_iterations(s, "slots", k))
        x = torch.as_tensor(np.random.default_rng(7).standard_normal((s.n, 3)).astype(np.float32),
                            device=dev)
        ys = contact.spmv_forms(s, x)
        scale = float(ys["slots"].abs().max())
        dropped = int(s.ce.dropped)
        for f in ("scatter", "ell"):
            err = float((ys[f] - ys["slots"]).abs().max())
            say(f"contact SpMV {f} against slots: max abs {err:.3e} (tol {PROBE_SPMV_RTOL:g} x "
                f"max|y| {scale:.3e}; contact ELL dropped {dropped})")
            if f == "scatter" or dropped == 0:
                same[f"contact {side}: the {f} contact SpMV against slots"] = \
                    err <= PROBE_SPMV_RTOL * scale
        out = contact.solves(s, log=say)
        ms[f"contact {side} prepare general"] = out["prepare general"]["best_s"] * 1e3
        for name in ("static", "general"):
            iters.append((f"contact {side} {name} M", out[name]["iters"],
                          contact_records[side][name], contact.STIFFNESS))

    part("contact", side, contact_part)
    del s
    gc.collect()

    cross = _script("torch_probe_crossing_fix")
    side, k = sizes["crossing_fix"], ks["crossing_fix"]
    sx = cross.setup(side, dev)

    def cross_part(say):
        say(f"grid={sx.grid} n={sx.n} K={k} inv={type(sx.inv).__name__} "
            f"inv_cm={type(sx.inv_cm).__name__}")
        out = cross.run(sx, k, log=say)
        for name, t in out.items():
            ms[f"crossing_fix {side} {name}"] = t["ms"]
            if name != "comp-major":
                same[f"crossing_fix {side}: {name} bit for bit as stream"] = t["same"]
        same[f"crossing_fix {side}: the stream loop repeats bit for bit"] = same_bits(
            out["stream"]["out"], cross.k_iterations(sx, cross._variants()["stream"], k))
        ref, cm = out["stream"]["out"], out["comp-major"]["out"]
        rel = float((cm.T - ref).abs().max() / ref.abs().max())
        say(f"comp-major x against stream: max abs {rel:.3e} of max|x|; first entry within "
            f"{cross.CM_RTOL:g} relative: {out['comp-major']['same']}")

    part("crossing_fix", side, cross_part)
    del sx
    gc.collect()

    scat = _script("torch_probe_scatter_cost")
    p, m = scatter_sizes or (scat.P, scat.M)
    sc = scat.setup(p, m, dev)

    def scatter_part(say):
        for name, t in scat.run(sc, log=say).items():
            if not isinstance(t, str):
                ms[f"scatter_cost {name}"] = t["ms"]

    part("scatter_cost", None, scatter_part)
    del sc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launched = {}
    for c in counts.values():
        for kname, v in c.items():
            launched[kname] = launched.get(kname, 0) + v
    faults = probe_faults(iters, same, launched, ms)
    wall = time.perf_counter() - t_phase
    log(f"[contact probes] {len(iters)} iteration counts in their bands: "
        f"{sum(1 for lb, g, r, st in iters if probe_band(r, st)[0] <= g <= probe_band(r, st)[1])}; "
        f"{len(same)} checks; kernels launched {launched}; phase wall {wall:.1f} s (budget "
        f"{PROBE_BUDGET_S} s: {'within' if wall <= PROBE_BUDGET_S else 'OVER'}); "
        f"{'; '.join(faults) if faults else 'every gate held'}")
    return counts, faults


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


def check_symv_bf16(inv, label: str):
    """K3's bf16 entry on a bf16 table against its plain version (the einsum
    of the widened table and the bf16-rounded rhs), and a bitwise repeat."""
    import numpy as np
    import torch
    from precond_tpu_torch.ops.batched_inverse import apply_block_inverse
    from precond_tpu_torch.ops.cuda.symv import batched_symv

    bsz = inv.shape[0]
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal((bsz, 96)).astype(np.float32),
                          device=DEVICE)
    got = batched_symv(inv, rhs)
    plain = apply_block_inverse(inv, rhs)
    scale = float(plain.abs().max())
    max_abs = float((got - plain).abs().max())
    same = torch.equal(got, batched_symv(inv, rhs))
    log(f"[K3-bf16 symv] {label} table B={bsz}: kernel vs plain max abs {max_abs:.3e} "
        f"(tol 1e-5*max|z| = {1e-5 * scale:.3e}); two launches bitwise equal={same}")
    require(max_abs <= 1e-5 * scale, f"K3-bf16 disagrees with its plain version on the {label} table")
    require(same, "K3-bf16 is not bitwise repeatable from launch to launch")
    return max_abs, rhs


def ab_pairs(fa, fb, pairs: int = 10, iters: int = 50, per: int = 1) -> dict:
    """`pairs` interleaved timings of fa (A) and fb (B), the order alternating
    AB, BA, ... so that drift on the card falls on both alike: the medians,
    spreads (max - min), the median of the per-pair B - A, and how many
    pairs A won. Each timing is `iters` calls; times are per call / `per`
    (`per` launches in each call, as in a replayed graph)."""
    import statistics

    a, b = [], []
    for i in range(pairs):
        for f in ((fa, fb) if i % 2 == 0 else (fb, fa)):
            (a if f is fa else b).append(time_ms(f, warmup=3, iters=iters) / per)
    diff = [y - x for x, y in zip(a, b)]
    return dict(a_median=statistics.median(a), a_spread=max(a) - min(a),
                b_median=statistics.median(b), b_spread=max(b) - min(b),
                b_minus_a_median=statistics.median(diff), a_won=sum(d > 0 for d in diff),
                pairs=pairs)


def graphed(fn, launches: int):
    """`fn` called `launches` times, captured in one CUDA graph; the result
    replays it, so a timing holds the device's time and no host launch cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return g.replay


def check_symv_bf16_lower_only(inv, rhs, label: str) -> None:
    """NaN written above the diagonal of every table must change no bit of
    K3-bf16's output: the kernel reads only the lower triangle and the
    diagonal, and counts no entry twice."""
    import torch
    from precond_tpu_torch.ops.cuda.symv import batched_symv

    upper = torch.triu(torch.ones(96, 96, dtype=torch.bool, device=inv.device), diagonal=1)
    poisoned = inv.masked_fill(upper, float("nan"))
    got = batched_symv(poisoned, rhs)
    finite = bool(torch.isfinite(got).all())
    same = torch.equal(got, batched_symv(inv, rhs))
    log(f"[K3-bf16 symv] {label} B={inv.shape[0]}: NaN above the diagonal: output finite={finite}, "
        f"bitwise equal to the clean table's={same}")
    require(finite and same, f"K3-bf16 read above the diagonal of the {label} table")


def k3bf16_bounds(b: int) -> dict:
    """K3-bf16's bounds at B tables (ms, H100 SXM data sheet): the work (the
    lower triangle and diagonal read once, 4,656 bf16, plus the f32 rhs read
    and z written), the same through 32-byte DRAM sectors (row i's
    ceil((i+1)/8) 16-byte chunks from a 192-byte-aligned start: 336
    sectors), and the dense table (the earlier design's bound)."""
    vec = 2 * 96 * 4
    flops = 2 * 96 * 96 * b
    work = bound_ms((4656 * 2 + vec) * b, flops)
    sectors = sum(-(-(16 * (i // 8 + 1)) // 32) for i in range(96))
    return dict(work=work, sector=bound_ms((32 * sectors + vec) * b, flops)[0],
                dense=bound_ms((96 * 96 * 2 + vec) * b, flops)[0], sectors=sectors)


def kernel_symv_bf16(inv, launches_by_path: dict, path: str, small_inv, small_path: str) -> dict:
    import torch
    from precond_tpu_torch.ops.batched_inverse import apply_block_inverse
    from precond_tpu_torch.ops.cuda.symv import batched_symv, bf16_grid

    def lib_ms(table, rhs):
        """torch.bmm with f32 output on the bf16 table and the rhs rounded
        beforehand (the rounding not timed): no single PyTorch call takes the
        f32 rhs. None where this torch has no bmm(out_dtype=...) on the card."""
        rb = rhs.to(torch.bfloat16)[:, :, None]
        try:
            out = torch.bmm(table, rb, out_dtype=torch.float32)
        except (RuntimeError, TypeError) as e:
            log(f"[K3-bf16 symv] no library time: torch.bmm(out_dtype=float32) is refused here "
                f"({str(e).splitlines()[0][:120]})")
            return None
        diff = float((out[:, :, 0] - batched_symv(table, rhs)).abs().max())
        log(f"[K3-bf16 symv] torch.bmm(out_dtype=float32) vs kernel max abs {diff:.3e}")
        return time_ms(lambda: torch.bmm(table, rb, out_dtype=torch.float32), warmup=10, iters=200)

    grid, per_sm = bf16_grid()
    log(f"[K3-bf16 symv] persistent grid {grid} thread blocks ({per_sm} per SM), one table "
        f"each at a time; ptxas: {ptxas_facts('symv96_bf16_kernel') or 'no entry in the build log'}")
    bsz = inv.shape[0]
    max_abs, rhs = check_symv_bf16(inv, path)
    check_symv_bf16_lower_only(inv, rhs, path)
    ms = time_ms(lambda: batched_symv(inv, rhs), warmup=10, iters=200)
    plain_ms = time_ms(lambda: apply_block_inverse(inv, rhs), warmup=3, iters=20)
    lib = lib_ms(inv, rhs)
    bounds = k3bf16_bounds(bsz)
    small_max_abs, small_rhs = check_symv_bf16(small_inv, small_path)
    check_symv_bf16_lower_only(small_inv, small_rhs, small_path)
    small_ms = time_ms(lambda: batched_symv(small_inv, small_rhs), warmup=10, iters=200)
    small_bounds = k3bf16_bounds(small_inv.shape[0])
    small_lib = lib_ms(small_inv, small_rhs)
    for label, b, t, bd, lb in ((path, bsz, ms, bounds, lib),
                                (small_path, small_inv.shape[0], small_ms, small_bounds, small_lib)):
        log(f"[K3-bf16 symv] {label} B={b}: kernel {t:.4f} ms; bounds: work {bd['work'][0]:.4f} ms "
            f"({bd['work'][1]}; {100 * bd['work'][0] / t:.1f}% reached), {bd['sectors']} sectors "
            f"{bd['sector']:.4f} ms ({100 * bd['sector'] / t:.1f}%), dense {bd['dense']:.4f} ms; "
            f"torch.bmm {lb if lb is None else f'{lb:.4f}'} ms"
            + (f"; plain {plain_ms:.4f} ms" if b == bsz else ""))
    # the kernel (A) against torch.bmm(out_dtype=float32) (B) in interleaved
    # pairs: launched from the host one by one as the main path does, and
    # replayed from CUDA graphs of 20 launches (the devices' times: at B =
    # 2,185 both calls take less time on the card than to launch from Python)
    ab, ab_dev = {}, {}
    if lib is not None:
        for table, rhs_ in ((inv, rhs), (small_inv, small_rhs)):
            rb = rhs_.to(torch.bfloat16)[:, :, None]

            def kern():
                return batched_symv(table, rhs_)

            def bmm():
                return torch.bmm(table, rb, out_dtype=torch.float32)

            key = str(table.shape[0])
            for how, out, res in (
                    ("host-launched", ab, ab_pairs(kern, bmm)),
                    ("graph-replayed", ab_dev,
                     ab_pairs(graphed(kern, 20), graphed(bmm, 20), iters=10, per=20))):
                out[key] = res
                log(f"[K3-bf16 symv] A/B B={table.shape[0]}, {res['pairs']} interleaved pairs, "
                    f"{how}: kernel median {res['a_median']:.4f} ms (spread "
                    f"{res['a_spread']:.4f}), torch.bmm median {res['b_median']:.4f} ms (spread "
                    f"{res['b_spread']:.4f}), bmm - kernel median {res['b_minus_a_median']:+.4f} "
                    f"ms, kernel won {res['a_won']}/{res['pairs']}")
            torch.cuda.synchronize()
    return _record("symv96_bf16", "precond_tpu_torch/csrc/symv_bf16.cu",
                   "precond_tpu/ops/batched_inverse.py:257", launches_by_path, path, max_abs, ms,
                   plain_ms, bounds["work"], lib,
                   bound_note=("the lower triangle and diagonal read once (the kernel's work); "
                               "sector_bound_ms through 32-byte sectors, dense_bound_ms the "
                               "whole table"),
                   sector_bound_ms=bounds["sector"], dense_bound_ms=bounds["dense"],
                   grid=dict(blocks=grid, per_sm=per_sm),
                   library_call=("torch.bmm(out_dtype=float32) on the bf16 table and the rhs "
                                 "rounded beforehand (no single call takes the f32 rhs)"
                                 if lib is not None else
                                 "none: torch.bmm(out_dtype=float32) is refused by this torch"),
                   small=dict(path=small_path, b=int(small_inv.shape[0]), ms=small_ms,
                              bound_ms=small_bounds["work"][0],
                              sector_bound_ms=small_bounds["sector"],
                              dense_bound_ms=small_bounds["dense"], max_abs_err=small_max_abs,
                              library_ms=small_lib),
                   ab_vs_library=ab, ab_vs_library_graphs=ab_dev)


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
# the north star: 2048^2 (BASELINE.json:11)
# ---------------------------------------------------------------------------

def north_star_halo(smi: str) -> dict:
    """scripts/torch_scaling_capacity.py's halo path on one rank (no process
    group) at 2048^2: prepare once, then PCG capped at the JAX record's
    count, capped at NORTH_STAR_CAP, and to 1e-4 (each a counted run).
    Returns the mesh and the assembled system (the pod reference reuses
    them), the results and the launch counts."""
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.parallel.comm import Group

    cap = _script("torch_scaling_capacity")
    group = Group.single(DEVICE)
    cfg = SchwarzConfig()
    label = f"north star halo {NORTH_STAR}"
    t0 = time.perf_counter()
    mesh_c = cap.mesh_of(NORTH_STAR)
    ell = cloth.assemble_system(mesh_c, device=DEVICE)
    n = mesh_c.num_verts
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    log(f"[{label}] N={n} levels={cfg.num_levels(n)} applied={cfg.max_applied_levels} "
        f"blocks={cfg.num_blocks(n)} packed={cfg.use_packed_symv(n)} (mesh and system built "
        f"in {host_s:.1f} s); {smi}")
    require(cfg.num_levels(n) == cfg.max_applied_levels + 1,
            f"{label}: expected one level more than the apply uses")

    counts = {}
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    prep = cap.halo_prepare(group, mesh_c, cfg, ell=ell)
    setup_s = time.perf_counter() - t0
    rec_it, rec_rel = JAX_RECORD_NORTH_STAR_HALO
    capped = cap.halo_solve(group, cfg, prep, 1e-4, rec_it)
    counts[f"{label} capped at {rec_it}"] = dict(_lib.launch_counts)
    rel_off = abs(capped["rel_residual"] - rec_rel) / rec_rel
    log(f"[{label}] prepare_ms={prep['prepare_ms']:.1f} (halo tables and split: "
        f"{setup_s - prep['prepare_ms'] / 1e3:.1f} s more); capped at {rec_it}: "
        f"iters={capped['iterations']} rel_residual={capped['rel_residual']:.6f}, JAX record "
        f"{rec_it} / {rec_rel} (off by {100 * rel_off:.3f}%, band {100 * NORTH_STAR_REL:g}%); "
        f"packed_apply={capped['packed_apply']} halo_mode={capped['halo_mode']}; "
        f"launches {counts[f'{label} capped at {rec_it}']}")
    require(capped["iterations"] == rec_it and rel_off <= NORTH_STAR_REL and capped["finite"],
            f"{label}: the capped run leaves the JAX record")
    require(capped["packed_apply"], f"{label}: the fine table is not packed (K2)")
    c = counts[f"{label} capped at {rec_it}"]
    require(c["spd_inverse96"] == 1 and c["packed_symv96"] >= 2 * (rec_it + 1),
            f"{label}: K1 / K2 did not launch as the path needs: {c}")

    _lib.reset_launch_counts()
    capped12 = cap.halo_solve(group, cfg, prep, 1e-4, NORTH_STAR_CAP)
    counts[f"{label} capped at {NORTH_STAR_CAP}"] = dict(_lib.launch_counts)
    log(f"[{label}] capped at {NORTH_STAR_CAP}: iters={capped12['iterations']} "
        f"rel_residual={capped12['rel_residual']:.8f}")
    require(capped12["iterations"] == NORTH_STAR_CAP and capped12["finite"],
            f"{label}: the run capped at {NORTH_STAR_CAP} did not run to its cap")
    _lib.reset_launch_counts()
    conv = cap.halo_solve(group, cfg, prep, 1e-4, 2000)
    counts[f"{label} to 1e-4"] = dict(_lib.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label}] to 1e-4: iters={conv['iterations']} rel_residual={conv['rel_residual']:.3e} "
        f"solve_ms={conv['solve_ms']:.1f} ms_per_iter={conv['iter_ms']:.3f} "
        f"prepare_ms={prep['prepare_ms']:.1f} peak_mem_gb={peak_gb:.2f} (held before: "
        f"{held_gb:.2f}); launches {counts[f'{label} to 1e-4']}; {smi}")
    require(conv["iterations"] < 2000 and conv["rel_residual"] <= 1e-4 and conv["finite"],
            f"{label}: PCG did not converge to 1e-4")
    check_packed_symv_table(prep["sap"].inv_fine, f"{label} fine table (row-major entry)")
    del prep
    return dict(mesh_c=mesh_c, ell=ell, capped=capped, capped12=capped12, conv=conv,
                peak_gb=peak_gb, counts=counts)


def north_star_pod(halo_run: dict, tmp: str, smi: str) -> dict:
    """scripts/torch_pod_solve.py: in this process on one rank (no process
    group; the reference), then as NCCL ranks, one per visible card, in child
    processes; their iterations within HALO_BAND of the reference."""
    import gc

    import torch
    from precond_tpu_torch.ops.cuda import _lib
    from precond_tpu_torch.parallel import hosts
    from precond_tpu_torch.parallel.comm import Group

    pod = _script("torch_pod_solve")
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    ref = pod.pod_solve(Group.single(DEVICE), NORTH_STAR, mesh_c=halo_run["mesh_c"],
                        ell=halo_run["ell"])
    counts[f"north star pod {NORTH_STAR} (1 rank)"] = dict(_lib.launch_counts)
    log(f"[north star pod {NORTH_STAR}] one rank, no process group: {json.dumps(ref)}")
    require(ref["iterations"] < 400 and ref["rel_residual"] <= 1e-4,
            "north star pod: the one-rank solve did not converge")
    del halo_run["ell"]
    gc.collect()
    torch.cuda.empty_cache()

    world = torch.cuda.device_count()
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_pod_solve.py")
    t0 = time.perf_counter()
    try:
        logs = hosts.launch_local_ranks([sys.executable, script, "--grid", str(NORTH_STAR),
                                         "--backend", NORTH_STAR_POD_BACKEND, "--device", DEVICE],
                                        world, RANK_TIMEOUT, os.path.join(tmp, "pod"))
    except RuntimeError as e:
        raise SmokeFailure(
            f"north star pod on {world} {NORTH_STAR_POD_BACKEND} ranks: {e}") from None
    lines = [ln for ln in logs[0].splitlines() if ln.startswith("{")]
    require(len(lines) == 1, "north star pod: rank 0 printed no result line")
    out = json.loads(lines[0])
    for r, c in enumerate(out["launches_per_rank"]):
        counts[f"north star pod {NORTH_STAR} ({world} {NORTH_STAR_POD_BACKEND}) r{r}"] = c
    log(f"[north star pod {NORTH_STAR}] {world} {NORTH_STAR_POD_BACKEND} rank(s), child "
        f"processes, {time.perf_counter() - t0:.1f} s: {json.dumps(out)}; {smi}")
    require(out["backend"] == NORTH_STAR_POD_BACKEND and out["ndev"] == world,
            f"north star pod: expected {world} {NORTH_STAR_POD_BACKEND} ranks, got "
            f"{out['ndev']} {out['backend']}")
    require(abs(out["iterations"] - ref["iterations"]) <= HALO_BAND
            and out["rel_residual"] <= 1e-4,
            f"north star pod: {out['iterations']} iterations on {world} NCCL ranks, one rank "
            f"{ref['iterations']} (band {HALO_BAND})")
    require(all(c["spd_inverse96"] >= 1 and c["packed_symv96"] >= 1
                for c in out["launches_per_rank"]),
            "north star pod: a rank did not launch K1 and K2")
    return dict(ref=ref, ranks=out, counts=counts)


def north_star_two_ranks(halo_run: dict, smi: str) -> dict:
    """scripts/torch_scaling_capacity.py's halo path capped at
    NORTH_STAR_CAP on 2 gloo ranks sharing the card (every rank prepares
    the whole system): each rank's iterations and residual against the
    one-rank run, each rank's peak memory."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_scaling_capacity.py")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script, "--grid", str(NORTH_STAR), "--path", "halo",
                           "--max-iters", str(NORTH_STAR_CAP), "--world", "2", "--backend", "gloo",
                           "--device", DEVICE, "--timeout", str(RANK_TIMEOUT)],
                          capture_output=True, text=True, timeout=RANK_TIMEOUT + 60)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise SmokeFailure(f"north star on 2 gloo ranks exited with {proc.returncode}: "
                           f"{(proc.stdout + proc.stderr)[-3000:]}")
    done = sorted((json.loads(ln) for ln in proc.stdout.splitlines()
                   if ln.startswith('{"stage": "halo_done"')), key=lambda d: d["rank"])
    require([d["rank"] for d in done] == [0, 1], "north star 2 ranks: a rank printed no result")
    ref = halo_run["capped12"]
    counts = {}
    for d in done:
        off = abs(d["rel_residual"] - ref["rel_residual"]) / ref["rel_residual"]
        counts[f"north star halo {NORTH_STAR} (2 gloo) r{d['rank']}"] = d["launches"]
        log(f"[north star 2 gloo ranks] rank {d['rank']}/2: iters={d['iterations']} "
            f"rel_residual={d['rel_residual']:.8f} (one rank {ref['rel_residual']:.8f}, off by "
            f"{off:.2e}, tol {NORTH_STAR_RANKS_RTOL:g}) halo_mode={d['halo_mode']} "
            f"peak_mem_gb={d['peak_gb']:.2f} rss_gb={d['rss_gb']} ms_per_iter={d['iter_ms']:.1f}; "
            f"launches {d['launches']}")
        require(d["iterations"] == NORTH_STAR_CAP and off <= NORTH_STAR_RANKS_RTOL and d["finite"],
                f"north star 2 gloo ranks: rank {d['rank']} differs from the one-rank run")
    together = sum(d["peak_gb"] for d in done)
    log(f"[north star 2 gloo ranks] both ranks on one card: {together:.2f} GB of peaks "
        f"together, {wall:.1f} s; {smi}")
    return dict(ranks=done, counts=counts)


def north_star_kernels(kernels: list, smi: str) -> None:
    """K1, K2 and K4 at their 4M shapes (the cloth 2048 grid path's blocks,
    comp-major table and planes), each against its plain version, with
    kernel / plain / library times (CUDA events) and the bound; added to the
    records under "north_star"."""
    import numpy as np
    import torch
    from precond_tpu_torch import SchwarzConfig
    from precond_tpu_torch.models import cloth
    from precond_tpu_torch.ops.batched_inverse import invert_spd_blocks_panel
    from precond_tpu_torch.ops.cuda.packed_symv import pack_sym96_cm
    from precond_tpu_torch.ops.cuda.spd_inverse import spd_inverse
    from precond_tpu_torch.ops.cuda.stencil_spmv import stencil_spmv
    from precond_tpu_torch.ops.gridassembly import assemble_grid_hessian
    from precond_tpu_torch.ops.gridstencil import spmv_t_plain

    g, k = NORTH_STAR, NORTH_STAR.bit_length() - 1
    path = f"north star cloth {g}"
    cfg = SchwarzConfig()
    mesh = cloth.make_grid(g, g, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    dgr, drr, offsets = cloth.assemble_system_grid(mesh, device=DEVICE)
    h96 = assemble_grid_hessian(dgr, drr, offsets, k, cfg)
    del dgr, drr
    by_name = {r["name"]: r for r in kernels}

    # ---- K1 on all 139,810 blocks; f64 on a seeded subset
    bsz = h96.shape[0]
    got = spd_inverse(h96)
    plain = invert_spd_blocks_panel(h96)
    max_abs = float((got - plain).abs().max())
    per_block = float(((got - plain).abs().amax(dim=(1, 2))
                       / plain.abs().amax(dim=(1, 2))).max())
    del plain
    pick = torch.as_tensor(np.sort(np.random.default_rng(11).choice(
        bsz, NORTH_STAR_K1_F64_BLOCKS, replace=False)), device=DEVICE)
    truth = torch.linalg.inv(h96[pick].double())
    scale = truth.abs().amax(dim=(1, 2))
    err64 = float(((got[pick].double() - truth).abs().amax(dim=(1, 2)) / scale).max())
    sym = torch.equal(got, got.transpose(1, 2))
    del truth
    log(f"[K1 spd_inverse] {path} h96 B={bsz}: kernel vs plain max abs {max_abs:.3e}, per-block "
        f"rel {per_block:.2e} (every block); vs f64 on {NORTH_STAR_K1_F64_BLOCKS} seeded blocks "
        f"{err64:.2e} (tol 1e-3 per block); bitwise symmetric={sym}")
    require(torch.isfinite(got).all().item() and sym and per_block < 1e-3 and err64 < 1e-3,
            f"K1 disagrees on the {path} blocks")
    ms = time_ms(lambda: spd_inverse(h96), warmup=1, iters=5)
    plain_ms = time_ms(lambda: invert_spd_blocks_panel(h96), warmup=1, iters=2)
    lib_ms = time_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(h96)), warmup=1, iters=2)
    bound = bound_ms(2 * bsz * 96 * 96 * 4, bsz * 96 ** 3)
    log(f"[K1 spd_inverse] {path} B={bsz}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"cholesky+cholesky_inverse {lib_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), "
        f"{100 * bound[0] / ms:.1f}% of the bound; {smi}")
    by_name["spd_inverse96"]["north_star"] = dict(
        path=path, shape=f"h96 f32[{bsz},96,96]", max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms,
        f64_blocks=NORTH_STAR_K1_F64_BLOCKS)
    del h96

    # ---- K2 on the comp-major table of the same inverse
    packed = pack_sym96_cm(got)
    rec = kernel_packed_symv_cm({"inv": packed}, got, {path: 0}, path)
    by_name["packed_symv96"]["north_star"] = dict(
        path=path, shape=f"F f32[48,96,{packed.f.shape[2]}]", max_abs_err=rec["max_abs_err"],
        ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], library_ms=rec["library_ms"])
    del got, packed

    # ---- K4 on the planes
    ssys = cloth.assemble_system_stencil(mesh, device=DEVICE)
    n, nd = g * g, len(ssys.offsets)
    args = (ssys.diag_t, ssys.dirs_t)
    max_abs = _k4_check(*args, ssys.offsets, ssys.grid, f"{path} planes N={n} D={nd}", seed=12)
    xt = torch.as_tensor(np.random.default_rng(13).standard_normal((3, n)).astype(np.float32),
                         device=DEVICE)
    y = stencil_spmv(*args, xt, ssys.offsets, ssys.grid)
    ms = time_ms(lambda: stencil_spmv(*args, xt, ssys.offsets, ssys.grid), warmup=5, iters=50)
    plain_ms = time_ms(lambda: spmv_t_plain(*args, xt, ssys.offsets, ssys.grid), warmup=1, iters=5)
    bsr = stencil_bsr(ssys)
    xv = xt.T.contiguous().reshape(-1)
    lib_ms, lib_note, yl = None, "torch.mv(bsr)", None
    try:
        yl = torch.mv(bsr, xv)
    except (RuntimeError, NotImplementedError) as e:   # the yardstick only; says why
        lib_note = f"torch.mv(bsr): {str(e).splitlines()[0][:160]}"
    if yl is not None:
        err = float((yl.reshape(n, 3).T - y).abs().max())
        require(err <= 1e-5 * float(y.abs().max()), "K4's library yardstick disagrees at 4M")
        lib_ms = time_ms(lambda: torch.mv(bsr, xv), warmup=3, iters=20)
    del bsr, yl
    bound = bound_ms((9 + 9 * nd) * 4 * n + 2 * 3 * 4 * n, 2 * 9 * (nd + 1) * n)
    log(f"[K4 stencil_spmv] {path} N={n} D={nd}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {'%.4f ms' % lib_ms if lib_ms is not None else 'none'} ({lib_note}), "
        f"bound {bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}% of the bound; {smi}")
    by_name["stencil_spmv"]["north_star"] = dict(
        path=path, shape=f"dirs_t f32[{nd},3,3,{n}]", max_abs_err=max_abs, ms=ms,
        plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)


def run_north_star(kernels: list, tmp: str, smi: str) -> dict:
    """The [north star] phase: the 4M-vertex halo path on one rank (against
    the JAX record, then to 1e-4), the pod solve on one rank and on NCCL
    ranks, the capacity run on 2 gloo ranks, the cloth 2048 bench row, and
    K1 / K2 / K4 at their 4M shapes. Returns the launch counts by path."""
    import gc

    import torch

    t0 = time.perf_counter()
    halo_run = north_star_halo(smi)
    pod = north_star_pod(halo_run, tmp, smi)
    del halo_run["mesh_c"]
    gc.collect()
    torch.cuda.empty_cache()
    two = north_star_two_ranks(halo_run, smi)
    bench_counts = run_bench(NORTH_STAR_BENCH, reps=1)
    north_star_kernels(kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    conv = halo_run["conv"]
    log(f"[north star] {NORTH_STAR}^2: halo 1 rank {conv['iterations']} iterations to 1e-4 at "
        f"{conv['iter_ms']:.3f} ms/iter, peak {halo_run['peak_gb']:.2f} GB; pod 1 rank "
        f"{pod['ref']['iterations']} at {pod['ref']['iter_ms']:.3f} ms/iter, "
        f"{pod['ranks']['ndev']} {NORTH_STAR_POD_BACKEND} {pod['ranks']['iterations']} at "
        f"{pod['ranks']['iter_ms']:.3f}; 2 gloo ranks peaks "
        f"{[d['peak_gb'] for d in two['ranks']]} GB; phase wall {wall:.1f} s (budget "
        f"{NORTH_STAR_BUDGET_S} s: {'within' if wall <= NORTH_STAR_BUDGET_S else 'OVER'}); {smi}")
    return {**halo_run["counts"], **pod["counts"], **two["counts"], **bench_counts}


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
                    help="side of the folded self-colliding sheet (general and grid paths, ClothSim)")
    # one rank of a multi-rank phase (the script starts these itself)
    ap.add_argument("--rank-worker", choices=sorted(JOBS), help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--backend", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--size", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--variants", default="auto", help=argparse.SUPPRESS)
    ap.add_argument("--dcp-save", help=argparse.SUPPRESS)
    ap.add_argument("--dcp-load", help=argparse.SUPPRESS)
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
    if args.rank_worker:
        return rank_worker(args)
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
    colg = run_collide_grid(args.collide, profile=True)
    sim_col = run_clothsim_collide(args.collide)
    sim_big = run_clothsim_drape(args.cloth)
    tet_box = run_tet(TET_BOX, profile=True)
    tet_gen = run_tet(TET_GENERAL, profile=True)
    soft = run_softbody(SOFTBODY)
    # bf16 inverse storage (K3's bf16 entry) at the bench's sizes
    gb_iso = run_general_bf16(args.dense_grid, "isotropic", dense)
    gb_pa = run_general_bf16(args.dense_grid, "per_axis", dense)
    gb_oracle = run_general_bf16(24, "per_axis", seed=6, max_iters=1000)
    cb_big = run_cloth_bf16(cl)
    cb_small = run_cloth_bf16(cl_dense)
    check_references()
    check_grid_references()
    check_collide_references()
    check_collide_grid_reference()

    runs = {f"general {args.grid}": big["counts"], f"general {args.dense_grid}": dense["counts"],
            f"cloth {args.cloth}": cl["counts"], f"cloth {args.cloth_dense}": cl_dense["counts"],
            f"grid_solve_step {args.cloth_dense}": gss["counts"],
            f"collide {args.collide}": col["counts"],
            f"collide {args.collide} (grid M)": colg["counts"],
            f"ClothSim collide {args.collide} (3 frames)": sim_col["counts"],
            f"ClothSim {args.cloth}": sim_big["counts"],
            f"ClothSim {args.cloth} rows": sim_big["counts_rows"],
            f"tet {TET_BOX} (box)": tet_box["counts"],
            f"tet {TET_GENERAL} (general)": tet_gen["counts"],
            f"SoftBodySim {SOFTBODY} linear (3 frames)": soft["counts_linear"],
            f"SoftBodySim {SOFTBODY} corotational (3 frames)": soft["counts"],
            f"general {args.dense_grid} bf16 isotropic": gb_iso["counts"],
            f"general {args.dense_grid} bf16 per_axis": gb_pa["counts"],
            "general 24 bf16 per_axis": gb_oracle["counts"],
            f"cloth {args.cloth} bf16": cb_big["counts"],
            f"cloth {args.cloth_dense} bf16": cb_small["counts"]}

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
    # the new paths' shapes: the grid collide blocks, the tet inverses and planes
    check_spd_inverse_blocks(colg["h96"], f"collide {args.collide} (grid M)")
    check_symv(colg["inv"].m, f"collide {args.collide} (grid M) comp-major")
    ss = colg["ssys"]
    _k4_check(ss.diag_t, ss.dirs_t, ss.offsets, ss.grid, f"collide {args.collide} (grid M) planes", seed=10)
    del colg, ss
    check_spd_inverse_blocks(tet_box["h96"], f"tet {TET_BOX} (box)")
    check_packed_symv_table(tet_box["inv"], f"tet {TET_BOX} (box)")
    check_spd_inverse_blocks(tet_gen["h96"], f"tet {TET_GENERAL} (general)")
    check_symv(tet_gen["inv"], f"tet {TET_GENERAL} (general)")
    del tet_box, tet_gen
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
    # K3's bf16 entry on the bf16 tables: cloth's B = 34,952 and general's 2,185
    check_symv_bf16(cb_small["inv"].m, f"cloth {args.cloth_dense} bf16")
    kernels.append(kernel_symv_bf16(cb_big["inv"].m, by_path("symv96_bf16"),
                                    f"cloth {args.cloth} bf16", gb_iso["pre"].state.inv96,
                                    f"general {args.dense_grid} bf16 isotropic"))
    del cb_small, gb_pa, gb_oracle

    # checkpoints: one state of each inverse type, on the card
    import tempfile

    from precond_tpu_torch.ops import gridstencil
    from precond_tpu_torch.ops.blockcsr import spmv as ell_spmv
    from precond_tpu_torch.ops.gridapply import precondition_grid_cm
    from precond_tpu_torch.utils import gridmorton as gm

    def general_case(label, run):
        ell = run["ell"]
        return (label, run["pre"], lambda x: ell_spmv(ell, x), lambda p: p.apply, run["b"])

    def grid_case(label, run, inv):
        k, ssys = run["k"], run["ssys"]

        def make_op(p):
            return lambda r: gm.morton_to_grid_cm(
                precondition_grid_cm(p.state.inv96, gm.grid_to_morton_cm(r, k), p.cfg_effective), k)

        return (label, grid_holder(inv, k, run["cfg"]), lambda x: gridstencil.spmv_t(ssys, x),
                make_op, run["b"].T.contiguous())

    with tempfile.TemporaryDirectory() as tmp:
        big_case = general_case(f"general {args.grid}", big)
        run_checkpoints([big_case,
                         grid_case(f"cloth {args.cloth}", cl, cl["inv"]),
                         grid_case(f"cloth {args.cloth_dense}", cl_dense, cl_dense["inv"]),
                         general_case(f"general {args.dense_grid} bf16", gb_iso)],
                        big_case, tmp)
    run_profiling(cl, os.path.join(here, "build", f"trace_cloth{args.cloth}"))

    # multiple ranks: child processes share the card, so this one lets go of
    # its own state first
    import gc

    del big, dense, cl, cl_dense, gss, sim_col, sim_big, soft, gb_iso, cb_big, big_case
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[multi-rank] parent holds {torch.cuda.memory_allocated() / 1e9:.2f} GB before the "
        f"rank processes start; {smi}")
    t_mr = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rank_counts = run_multirank(args, tmp)
    log(f"[multi-rank] all phases {time.perf_counter() - t_mr:.1f} s")
    t_bench = time.perf_counter()
    bench_counts = run_bench(BENCH_SPECS)
    log(f"[bench] all configs {time.perf_counter() - t_bench:.1f} s")
    dissect_counts, faults = run_dissect(os.path.join(here, "build", "trace_dissect"))
    require(not faults, "dissect: " + "; ".join(faults))
    probe_counts, faults = run_contact_probes()
    require(not faults, "contact probes: " + "; ".join(faults))
    with tempfile.TemporaryDirectory() as tmp:
        north_counts = run_north_star(kernels, tmp, smi)
    for rec in kernels:
        for path, c in {**rank_counts, **bench_counts, **dissect_counts, **probe_counts,
                        **north_counts}.items():
            rec["launches_by_path"][path] = c.get(rec["name"], 0)
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
