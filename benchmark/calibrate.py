"""Readings that the limits in limits/<workload>.json are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--fault-seeds 4 5 6] [--live-seeds 10]

For each seed it runs, in one process and at the cell's own size, the
frames a run checks (the first episode up to its last checked frame) and
prints the compared numbers. With --control-seeds it then builds the
control, the program with its bfloat16 inverse tables
(SchwarzConfig(inverse_dtype="bfloat16"), the precision below the float32
that the configuration states), and prints the same numbers for it. With
--fault-seeds it plants each fault of FAULTS that the cell can have, one at
a time, on the name it replaces in the simulator's module, and prints the
numbers of the faulty program. With --live-seeds (a cell with contact) it
runs one whole episode a seed and prints each frame's live contacts of
each set and its detection flags. The benchmark's own runs never run this.
Needs a card, like run.py.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Faults planted on a name of the simulator's module, each a wrapper of the
# real function. The first two stay finite and near the answer, so that
# they read where the bfloat16 control diverges; they wrap the simulator's
# pcg(spmv, precond, b, ...) and are planted under the harness's tap. The
# last three take one contact term out of the frame (cells with contact).


def _answer_x101(real):
    """The solve's answer 1% too long where it is produced."""
    def pcg(spmv, precond, b, *args, **kw):
        res = real(spmv, precond, b, *args, **kw)
        return res._replace(x=res.x * 1.01)
    return pcg


def _spmv_x101(real):
    """The system the PCG iterates on 1% too stiff: a uniformly wrong SpMV."""
    def pcg(spmv, precond, b, *args, **kw):
        return real(lambda p: spmv(p) * 1.01, precond, b, *args, **kw)
    return pcg


def _contact_spmv_zero(real):
    """The contact SpMV returns zero: the PCG iterates without contact."""
    def stencil_contact_spmv(st, x):
        return x.new_zeros(x.shape)
    return stencil_contact_spmv


def _prepare_without_contact(real):
    """The grid prepare called without the stencils: M has no contact terms."""
    def prepare_grid(diag_rows, dirs_rows, offsets, k, cfg, stencils=None, o2s=None):
        return real(diag_rows, dirs_rows, offsets, k, cfg)
    return prepare_grid


def _forces_zero(real):
    """The penalty forces return zero: b has no contact forces."""
    def contact_forces(st, x, rest_gap):
        return x.new_zeros(x.shape)
    return contact_forces


# name -> (the simulator module's name it replaces, wrapper, needs contact)
FAULTS = {
    "answer_x1.01": ("pcg", _answer_x101, False),
    "spmv_x1.01": ("pcg", _spmv_x101, False),
    "contact_spmv_zero": ("stencil_contact_spmv", _contact_spmv_zero, True),
    "m_without_contact": ("prepare_grid", _prepare_without_contact, True),
    "b_without_contact": ("contact_forces", _forces_zero, True),
}


def faults_for(cell) -> dict:
    """The faults of FAULTS that the cell can have."""
    contact = "contact" in cell.traffic
    return {k: v for k, v in FAULTS.items() if contact or not v[2]}


def readings(harness, check, scene_mod, cell, mesh, device, seeds, label, fault=None,
             **overrides):
    import torch
    from precond_tpu_torch.models import simulator

    sim = harness.make_sim(mesh, cell.config, scene_mod.make(cell.traffic, mesh, seeds[0]),
                           device, **overrides)
    for seed in seeds:
        scene = scene_mod.make(cell.traffic, mesh, seed)
        t0 = time.perf_counter()
        if fault is not None:
            name, wrap, _ = fault
            real = getattr(simulator, name)
            setattr(simulator, name, wrap(real))
        try:
            w = harness.window(sim, scene, device, 0.0)
        finally:
            if fault is not None:
                setattr(simulator, name, real)
        numbers, _, notes = check.judge(w.frames, mesh, scene, cell.config,
                                        sum(w.unconverged_flags), device, sum(w.overflow_flags))
        print(json.dumps({"reading": label, "seed": seed, "checked": sorted(w.frames),
                          "numbers": numbers, "frames_run": len(w.failed_flags),
                          "contact": notes, "seconds": time.perf_counter() - t0}), flush=True)
        del w
        gc.collect()
    del sim
    gc.collect()
    torch.cuda.empty_cache()


def live_contacts(harness, scene_mod, cell, mesh, device, seeds):
    """Each frame's live stencils of each set (EF, EE, VF) over one episode,
    counted by harness.Tap armed on every frame."""
    import torch

    sim = harness.make_sim(mesh, cell.config, scene_mod.make(cell.traffic, mesh, seeds[0]),
                           device)
    tap = harness.Tap()
    try:
        for seed in seeds:
            scene = scene_mod.make(cell.traffic, mesh, seed)
            harness.episode_runner(sim, scene, device)()
            frames = []
            for f in range(scene.episode_frames):
                tap.armed = True
                sim.step()
                tap.armed = False
                info = sim.last_detect_info
                frames.append({"frame": f, "live_ef_ee_vf": tap.live.tolist(),
                               "truncated": bool(info.truncated), "dropped": int(info.dropped),
                               "iterations": sim.last_solve.iterations})
            print(json.dumps({"reading": "live", "seed": seed, "frames": frames}), flush=True)
    finally:
        tap.close()
    del sim
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--live-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import check, harness, scene as scene_mod

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    cell = harness.load_cell(ROOT, args.workload)
    mesh = harness.build_mesh(ROOT, cell.config)
    if args.live_seeds:
        live_contacts(harness, scene_mod, cell, mesh, device, args.live_seeds)
    if args.seeds:
        readings(harness, check, scene_mod, cell, mesh, device, args.seeds, "program")
    if args.control_seeds:
        readings(harness, check, scene_mod, cell, mesh, device, args.control_seeds,
                 "control_bf16", inverse_dtype="bfloat16")
    if args.fault_seeds:
        for name, fault in faults_for(cell).items():
            readings(harness, check, scene_mod, cell, mesh, device, args.fault_seeds,
                     "fault_" + name, fault=fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
