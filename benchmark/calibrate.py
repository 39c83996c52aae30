"""Readings that the limits in limits/<workload>.json are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--fault-seeds 4 5 6]

For each seed it runs, in one process and at the cell's own size, the
frames a run checks (the first episode up to its last checked frame) and
prints the compared numbers. With --control-seeds it then builds the
control, the program with its bfloat16 inverse tables
(SchwarzConfig(inverse_dtype="bfloat16"), the precision below the float32
that the configuration states), and prints the same numbers for it. With
--fault-seeds it plants each fault of FAULTS under the simulator's PCG
entry, one at a time, and prints the numbers of the faulty program. The
benchmark's own runs never run this. Needs a card, like run.py.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Faults that stay finite and near the answer, so that they read where the
# bfloat16 control diverges. Each wraps the simulator's
# pcg(spmv, precond, b, ...) and is planted under the harness's tap.


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


FAULTS = {"answer_x1.01": _answer_x101, "spmv_x1.01": _spmv_x101}


def readings(harness, check, scene_mod, cell, mesh, device, seeds, label, fault=None,
             **overrides):
    import torch
    from precond_tpu_torch.models import simulator

    sim = harness.make_sim(mesh, cell.config, scene_mod.make(cell.traffic, mesh, seeds[0]),
                           device, **overrides)
    real = simulator.pcg
    for seed in seeds:
        scene = scene_mod.make(cell.traffic, mesh, seed)
        t0 = time.perf_counter()
        if fault is not None:
            simulator.pcg = fault(real)
        try:
            w = harness.window(sim, scene, device, 0.0)
        finally:
            simulator.pcg = real
        numbers, _ = check.judge(w.frames, mesh, scene, cell.config, sum(w.failed_flags), device)
        print(json.dumps({"reading": label, "seed": seed, "checked": sorted(w.frames),
                          "numbers": numbers, "frames_run": len(w.failed_flags),
                          "seconds": time.perf_counter() - t0}), flush=True)
        del w
        gc.collect()
    del sim
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
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
    readings(harness, check, scene_mod, cell, mesh, device, args.seeds, "program")
    if args.control_seeds:
        readings(harness, check, scene_mod, cell, mesh, device, args.control_seeds,
                 "control_bf16", inverse_dtype="bfloat16")
    for name, fault in FAULTS.items() if args.fault_seeds else ():
        readings(harness, check, scene_mod, cell, mesh, device, args.fault_seeds,
                 "fault_" + name, fault=fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
