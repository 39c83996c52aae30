"""The port's process-group setup and collectives (parallel/hosts.py,
parallel/comm.py) in one process: the no-op at one process, the rank mesh
and row slabs (as tests/test_hosts.py checks the JAX package's), the
identity Group, a real one-rank gloo group, and the host exchange tables."""

import importlib.util
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from precond_tpu_torch.parallel import hosts
from precond_tpu_torch.parallel.comm import Group, exchange, exchange_plan, row_range


def test_initialize_noop_single_process():
    group = hosts.initialize_hosts(num_processes=1, device="cpu")
    assert (group.rank, group.world, group.backend) == (0, 1, None)
    assert not group.distributed and not dist.is_initialized()


def test_initialize_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hosts.initialize_hosts(num_processes=1)


def test_worker_defaults_to_the_card(monkeypatch, tmp_path):
    """scripts/torch_multiprocess_worker.py runs its rank on the card unless
    --device cpu is given."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_multiprocess_worker", os.path.join(root, "scripts", "torch_multiprocess_worker.py"))
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker.main(["--init", "127.0.0.1:1", "--world", "1", "--rank", "0",
                     "--inputs", str(tmp_path), "--out", str(tmp_path), "--cases", "dcp"])
    assert not dist.is_initialized()


def test_launch_local_ranks_passes_each_rank_its_flags(tmp_path):
    code = "import sys; print(' '.join(sys.argv[1:]))"
    logs = hosts.launch_local_ranks([sys.executable, "-c", code, "--x"], 3, 60, str(tmp_path))
    for r, text in enumerate(logs):
        flags = text.split()
        assert flags[0] == "--x" and flags[flags.index("--rank") + 1] == str(r)
        assert flags[flags.index("--world") + 1] == "3" and flags[1] == "--init"
    assert len({t.split()[2] for t in logs}) == 1   # one coordinator


@pytest.mark.parametrize("code,match", [
    ("import sys; sys.exit(3 if sys.argv[-1] == '1' else 0)", "rank 1 of 2 exited with 3"),
    ("import sys, time; time.sleep(0 if sys.argv[-1] == '0' else 60)", "timed out after 2 s"),
])
def test_launch_local_ranks_fails_for_any_rank(tmp_path, code, match):
    """A rank that fails or outlasts the limit fails the launch; the other
    ranks are killed, not waited for."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        hosts.launch_local_ranks([sys.executable, "-c", code], 2, 2, str(tmp_path))
    assert time.monotonic() - t0 < 30


def test_global_mesh_and_row_slabs():
    mesh = hosts.global_mesh()
    assert mesh.shape["x"] == 1 and mesh.ranks == (0,)
    group = Group.single("cpu")
    rows = torch.arange(8 * 32 * 3, dtype=torch.float32).reshape(8 * 32, 3)
    assert torch.equal(hosts.shard_rows_across_hosts(group, rows), rows)
    assert torch.equal(hosts.gather_rows(group, rows), rows)
    with pytest.raises(ValueError, match="bank-aligned"):
        hosts.shard_rows_across_hosts(group, rows[:100])


def test_single_group_is_the_identity():
    g = Group.single("cpu")
    x = torch.randn(4, 3)
    assert g.all_reduce_sum(x) is x and g.ring_shift(x, 1) is x
    assert g.all_to_all(x[None]).shape == (1, 4, 3) and g.all_gather_rows(x) is x
    assert g.stats.calls == 0
    with pytest.raises(ValueError, match="leading axis of 1"):
        g.all_to_all(x)


def test_group_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        Group(0, 2)
    with pytest.raises(ValueError, match="not in a world"):
        Group(2, 2)


def test_one_rank_gloo_group_goes_through_the_backend():
    """A backend named at one process makes a real group: the operations
    run through gloo (and are counted) and give the identity's values."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    g = hosts.initialize_hosts(f"127.0.0.1:{port}", 1, 0, backend="gloo", device="cpu")
    try:
        assert g.backend == "gloo" and g.distributed
        x = torch.randn(5, 3)
        assert torch.equal(g.all_reduce_sum(x), x)
        assert torch.equal(g.all_to_all(x[None]), x[None])
        assert torch.equal(g.all_gather_rows(x), x)
        assert torch.equal(g.all_reduce_sum(torch.tensor(2.5)), torch.tensor(2.5))
        assert g.stats.calls == 4 and g.stats.bytes == 3 * 60 + 4
        assert hosts.global_mesh().shape == {"x": 1}
    finally:
        hosts.shutdown_hosts()
    assert not dist.is_initialized()


@pytest.mark.parametrize("n,world", [(10, 4), (576, 4), (1024, 8), (3, 4), (7, 1)])
def test_row_range_is_torch_chunk(n, world):
    chunks = torch.arange(n).chunk(world)
    for r in range(world):
        start, stop = row_range(n, world, r)
        want = chunks[r] if r < len(chunks) else torch.arange(0)
        assert torch.equal(torch.arange(start, stop), want)


@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_exchange_plan_delivers_every_need(world):
    """Random need lists over equal slabs: the simulated all_to_all leaves
    each rank with its needs in its order; caps are 8-aligned."""
    rng = np.random.default_rng(world)
    per = 16
    x = torch.randn(world * per, 3)
    needs = [rng.choice(world * per, size=rng.integers(1, 30), replace=False)
             for _ in range(world)]
    send, recv = exchange_plan(needs, per, world)
    assert send.shape[2] % 8 == 0 and recv.shape[1] % 8 == 0
    for d in range(world):
        received = torch.cat([x[s * per: (s + 1) * per][torch.as_tensor(send[s, d]).long()]
                              for s in range(world)])
        got = received[torch.as_tensor(recv[d]).long()][: len(needs[d])]
        assert torch.equal(got, x[torch.as_tensor(needs[d])])
    if world == 1:
        got = exchange(Group.single("cpu"), x, torch.as_tensor(send[0]).long(),
                       torch.as_tensor(recv[0]).long())
        assert torch.equal(got[: len(needs[0])], x[torch.as_tensor(needs[0])])
