#!/usr/bin/env python3
"""One rank of a multi-rank solve of the PyTorch port on gloo (CPU or a card).

    python3 scripts/torch_multiprocess_worker.py --init 127.0.0.1:PORT --world W --rank R \\
        --inputs DIR --out DIR [--device cpu] [--cases halo_dense,...,dcp]

The ranks compute on the card unless --device cpu is given.
tests/test_torch_multiprocess.py starts W of these through
parallel/hosts.launch_local_ranks. Each joins the process group
(parallel/hosts.initialize_hosts, gloo), reads every case's inputs
from DIR/<case>_w<W>.npz (written by the test from the JAX package's
state), runs the port's multi-rank entry on them and writes its own rows
of x, the iteration count and the residual to OUT/<case>_w<W>_r<R>.npz:

  halo_dense, halo_packed, halo_contact   halo.solve_sorted on the JAX
                                          package's HaloSystem and
                                          ShardedApply for W shards
  sharded_32, sharded_24                  sharded.sharded_solve_step (24x24
                                          is ragged on 4 ranks)
  grid_sym0, grid_sym1, grid_contact      gridsharded.sharded_grid_solve_step
                                          (sym both ways) and
                                          sharded_grid_contact_solve_step

and the collective checkpoint round trips (dcp): this group loads the
test's one-rank save (its own rows of x), saves its rows of a known x and a
solver state, and reads its rows back. The test runs the same cases at
world size 1 in its own process through run_case. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = ("halo_dense", "halo_packed", "halo_contact", "sharded_32", "sharded_24",
         "grid_sym0", "grid_sym1", "grid_contact")
DCP_ROWS = 256   # rows of the checkpointed x


def _stencils(d, prefix, dev):
    from precond_tpu_torch import convert

    return convert.stencils_from_numpy(*(d[f"{prefix}{f}"] for f in (
        "idx", "weight", "nverts", "nfirst", "stiff", "direction", "valid")), device=dev)


def run_case(group, case: str, d):
    """The port's multi-rank entry for `case` on inputs `d` (a dict of
    arrays), on the group's device; returns this rank's PcgResult."""
    import torch

    from precond_tpu_torch import SchwarzConfig, convert
    from precond_tpu_torch.ops.contact import build_contact_ell
    from precond_tpu_torch.parallel import gridsharded, halo, sharded

    device = group.device
    cfg = SchwarzConfig(symv_kernel=str(d["symv_kernel"]))
    if case.startswith("halo"):
        hsys = convert.halo_system_from_numpy(
            d["diag"], d["idx_ext"], d["blocks"], d["halo"], d["shard_rows"], d["send_idx"],
            d["recv_perm"], device=device)
        if "inv_fine_f" in d:
            inv_f = convert.PackedInverse(d["inv_fine_f"], d["inv_fine_dg"], d["inv_fine_nb"])
            inv_c = convert.PackedInverse(d["inv_coarse_f"], d["inv_coarse_dg"], d["inv_coarse_nb"])
        else:
            inv_f, inv_c = d["inv_fine"], d["inv_coarse"]
        sap = convert.sharded_apply_from_numpy(
            d["going_next_fine"], d["anc1"], inv_f, inv_c, d["going_next_coarse"], d["n"],
            d["total_coarse"], d["l1_live"], num_shards=group.world, device=device)
        st = _stencils(d, "st_", device) if "st_idx" in d else None
        b = torch.as_tensor(d["b"], device=device)
        return halo.solve_sorted(group, cfg, hsys, sap, b, tol=1e-4, max_iters=int(d["max_iters"]),
                                 stencils=st)
    if case.startswith("sharded"):
        ell = convert.block_ell_from_numpy(d["diag"], d["idx"], d["blocks"], d["mask"], device=device)
        maps = convert.sort_maps_from_numpy(d["s2o"], d["o2s"], device=device)
        step = sharded.sharded_solve_step(group, cfg, max_iters=int(d["max_iters"]), device=device)
        return step(ell, maps, d["b"])
    k, sym = int(d["k"]), bool(d["sym"])
    offsets = tuple(tuple(int(v) for v in o) for o in d["offsets"])
    ssys = convert.stencil_system_from_numpy(d["diag_t"], d["dirs_t"], offsets,
                                             (1 << k, 1 << k), sym=sym, device=device)
    dg, dr, full = convert.grid_blocks_from_numpy(d["diag_rows"], d["dirs_rows"],
                                                  d["full_offsets"], device=device)
    b = torch.as_tensor(d["b"], device=device)
    tol, iters = float(d["tol"]), int(d["max_iters"])
    if case == "grid_contact":
        st = _stencils(d, "st_", device)
        ce = build_contact_ell(st, b.shape[0], kc=16)
        o2s = torch.as_tensor(d["o2s"], device=device)
        step = gridsharded.sharded_grid_contact_solve_step(group, cfg, offsets, k, tol=tol,
                                                          max_iters=iters, device=device)
        return step(ssys, dg, dr, b, st, ce, o2s)
    step = gridsharded.sharded_grid_solve_step(group, cfg, offsets, k, tol=tol,
                                               max_iters=iters, sym=sym, device=device)
    return step(ssys, dg, dr, b)


def dcp_solver(device, grid: int = 16):
    """The solver whose state the checkpoint round trips carry: a prepared
    grid x grid cloth on `device` (every rank prepares the same, bit for
    bit; a CPU prepare and a card prepare may differ in the last bits)."""
    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.models import cloth

    mesh = cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001, dt=1.0 / 60.0)
    pre = SchwarzPreconditioner(SchwarzConfig(), device=device)
    pre.allocate(mesh.positions)
    pre.prepare(cloth.assemble_system(mesh, device=device))
    return pre


def dcp_x(scale: float, rows: int = DCP_ROWS) -> np.ndarray:
    """The checkpointed x: distinct rows, so a lost shard shows."""
    return (scale * np.arange(rows * 3, dtype=np.float32)).reshape(rows, 3)


def run_dcp(group, inputs: str, world: int) -> dict:
    """This group's checkpoint round trips; returns bools."""
    import torch

    from precond_tpu_torch import SchwarzConfig, SchwarzPreconditioner
    from precond_tpu_torch.io import sharded as shio
    from precond_tpu_torch.parallel.comm import row_range

    device = group.device
    start, stop = row_range(DCP_ROWS, group.world, group.rank)
    pre = dcp_solver(device)
    # a one-rank save, resharded onto this group: each rank reads its rows
    back = SchwarzPreconditioner(SchwarzConfig(), device=device)
    x1 = shio.load_solver_sharded(os.path.join(inputs, "ckpt_w1"), back, x_rows=True)
    from_one = torch.equal(x1.cpu(), torch.as_tensor(dcp_x(1.0)[start:stop])) and \
        torch.equal(back.state.inv96, pre.state.inv96)
    # this group's save: each rank writes only its rows of x
    x = torch.as_tensor(dcp_x(2.0)[start:stop], device=device)
    path = os.path.join(inputs, f"ckpt_w{world}")
    shio.save_solver_sharded(path, pre, x=shio.shard_rows(x, DCP_ROWS))
    again = SchwarzPreconditioner(SchwarzConfig(), device=device)
    rows = shio.load_solver_sharded(path, again, x_rows=True)
    whole = shio.load_solver_sharded(path, again)
    same = torch.equal(rows, x) and torch.equal(whole.cpu(), torch.as_tensor(dcp_x(2.0)))
    return {"dcp_from_one": from_one, "dcp_roundtrip": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", required=True, help="coordinator host:port")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--inputs", required=True, help="directory of the cases' npz inputs")
    ap.add_argument("--out", required=True, help="directory for this rank's results")
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the card; cpu for the plain versions)")
    ap.add_argument("--cases", default=",".join(CASES + ("dcp",)),
                    help="comma-separated cases to run (default: all, and dcp)")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")

    import torch

    torch.set_num_threads(1)
    from precond_tpu_torch.parallel import hosts

    group = hosts.initialize_hosts(args.init, args.world, args.rank, backend="gloo",
                                   device=args.device)
    try:
        for case in (c for c in CASES if c in cases):
            with np.load(os.path.join(args.inputs, f"{case}_w{args.world}.npz")) as f:
                d = dict(f)
            res = run_case(group, case, d)
            np.savez(os.path.join(args.out, f"{case}_w{args.world}_r{args.rank}.npz"),
                     x=res.x.cpu().numpy(), iterations=res.iterations,
                     rel_residual=float(res.rel_residual))
        if "dcp" in cases:
            flags = run_dcp(group, args.inputs, args.world)
            np.savez(os.path.join(args.out, f"dcp_w{args.world}_r{args.rank}.npz"), **flags)
    finally:
        hosts.shutdown_hosts()
    return 0


if __name__ == "__main__":
    sys.exit(main())
