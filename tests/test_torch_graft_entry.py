"""graft_entry_torch.py against __graft_entry__.py: the entry points.

entry(device="cpu") solves the JAX entry()'s 32 x 32 cloth to 1e-4 within
one convergence test (both test every iteration) of JAX's count, with x
within 1e-4 of JAX's in relative norm; without a card entry() raises.
dryrun_multichip(2, device="cpu") runs both steps on two gloo ranks, each
within one test of the JAX dryrun on two of conftest's virtual devices
(the two dryruns run side by side).
The dryrun's 32 x 8 cloth fills every rank's rows at 2, 4 and 8 ranks:
no padding, at least one 32-vertex bank each.
"""

import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
import graft_entry_torch as graft
from precond_tpu_torch import SchwarzConfig
from precond_tpu_torch.ops.hierarchy import BANK
from precond_tpu_torch.parallel import halo
from precond_tpu_torch.parallel.sharded import pad_sorted_system
from precond_tpu_torch.solver import prepare_with_system

torch.set_num_threads(2)

LINE = re.compile(r"dryrun_multichip\((\d+)\)( grid path)?: iters=(\d+) rel_residual=(\S+)")


def _steps(lines):
    """{'halo' | 'grid': [(iters, rel), ...]} from dryrun lines."""
    out = {"halo": [], "grid": []}
    for m in LINE.finditer("\n".join(lines)):
        out["grid" if m.group(2) else "halo"].append((int(m.group(3)), float(m.group(4))))
    return out


def test_entry_matches_jax():
    jfn, jargs = jax_graft.entry()
    jres = jax.jit(jfn)(*jargs)
    fn, args = graft.entry(device="cpu")
    res = fn(*args)
    assert args[0].diag.device.type == "cpu" and args[2].shape == (1024, 3)
    assert float(res.rel_residual) <= 1e-4 and float(jres.rel_residual) <= 1e-4
    assert abs(res.iterations - int(jres.iterations)) <= 1, (res.iterations, int(jres.iterations))
    xj = np.asarray(jres.x)
    assert np.linalg.norm(res.x.numpy() - xj) <= 1e-4 * np.linalg.norm(xj)


def test_entry_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.dryrun_multichip(2)


def test_dryrun_matches_jax(capsys):
    # The port's ranks are processes that write to their own logs: they run
    # while JAX's dryrun runs (and prints) in this one.
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(graft.dryrun_multichip, 2, device="cpu")
        jax_graft.dryrun_multichip(2)
        want = _steps(capsys.readouterr().out.splitlines())
        lines = port.result()
    got = _steps(lines)
    assert len(want["halo"]) == len(want["grid"]) == 1
    for step in ("halo", "grid"):
        assert len(got[step]) == 2, lines  # one line per rank
        (jit, jrel), = want[step]
        for it, rel in got[step]:
            assert np.isfinite(rel) and rel <= 1e-4
            assert abs(it - jit) <= 1, (step, it, jit)
    assert sum("launches: " in ln for ln in lines) == 4


@pytest.mark.parametrize("world", [2, 4, 8])
def test_dryrun_rows_fill_every_rank(world):
    ell, maps, _ = graft._build_problem(32, 8, device="cpu")
    n = ell.num_verts
    rows = -(-n // (world * BANK)) * world * BANK
    assert rows == n == 256
    cfg = SchwarzConfig()
    state, ell_sorted = prepare_with_system(ell, maps, cfg)
    hsys = halo.build_halo_system(pad_sorted_system(ell_sorted, rows), world)
    assert hsys.shard_rows == n // world >= BANK
    sap = halo.split_apply_state(state, cfg, n, world, rows=rows)
    assert sap is not None
