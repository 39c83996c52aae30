"""Multi-process setup (port of ``precond_tpu/parallel/hosts.py:20-52``) on
torch.distributed.

The JAX package wraps ``jax.distributed.initialize`` and a mesh over every
device of every process. Here each process is one rank: it computes on its
own device and meets the others through a :class:`comm.Group`. Nothing on
a machine tells a process of a cluster, so the caller names the
coordinator ("host:port"), the world size and its rank.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.hierarchy import BANK
from .comm import Group


def initialize_hosts(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> Group:
    """Join the process group and return this rank's Group.

    At one process (or none given) and no `backend` there is no process
    group: the Group is the identity on `device`. Otherwise
    ``init_process_group`` runs with ``init_method="tcp://<coordinator>"``
    (``env://`` when no coordinator is given, as under torchrun, whose
    WORLD_SIZE and RANK then stand in for a missing `num_processes` and
    `process_id`); naming a backend at one process makes a real one-rank
    group, whose collectives go through it. `backend` defaults to NCCL on a
    CUDA device and gloo on the CPU; several ranks sharing one card pass
    "gloo" (comm.py stages its payloads through host memory). `device` is
    the card unless the caller asks for the CPU; on a card the rank binds
    to device index LOCAL_RANK when torchrun sets it, else rank % device
    count (right only when every host runs as many ranks as it has cards,
    numbered host by host).
    """
    dev = resolve_device(device)
    if coordinator is None:
        if num_processes is None:
            num_processes = os.environ.get("WORLD_SIZE")
        if process_id is None:
            process_id = os.environ.get("RANK")
    num_processes = 1 if num_processes is None else int(num_processes)
    if num_processes <= 1 and backend is None:
        return Group.single(dev)
    process_id = 0 if process_id is None else int(process_id)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else process_id % torch.cuda.device_count()
        dev = torch.device("cuda", index)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(backend=backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    return Group.from_dist(dev)


def shutdown_hosts() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


class RankMesh(NamedTuple):
    """The 1-D rank mesh: one axis over every rank of the group. ``shape``
    maps the axis name to its size, as a JAX Mesh's does."""

    axis: str
    ranks: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.ranks)}


def global_mesh(axis: str = "x") -> RankMesh:
    """1-D mesh over every rank of the default process group (one rank
    without one)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return RankMesh(axis, tuple(range(world)))


def shard_rows_across_hosts(group: Group, rows: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous, bank-aligned slab of the global `rows`: every
    rank holds rows.shape[0] / world rows, a multiple of the 32-node bank."""
    n = rows.shape[0]
    if n % (group.world * BANK):
        raise ValueError(f"{n} rows do not split into {group.world} bank-aligned slabs "
                         f"(pad to a multiple of {group.world * BANK})")
    per = n // group.world
    return rows[group.rank * per: (group.rank + 1) * per]


def gather_rows(group: Group, local: torch.Tensor) -> torch.Tensor:
    """The global rows from every rank's equal slab, in rank order."""
    return group.all_gather_rows(local)


def free_port() -> int:
    """A TCP port on localhost that is free now (for a coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_ranks(argv: Sequence[str], world: int, timeout: float, log_dir: str,
                       env: Optional[dict] = None) -> List[str]:
    """Run `world` processes of `argv` on this host as the ranks of one group
    and return each rank's output.

    Rank r runs ``argv + ["--init", "127.0.0.1:<port>", "--world", world,
    "--rank", r]`` (a fresh port; each rank passes these to
    initialize_hosts) with its output in ``log_dir/rank<r>.log``. When a
    rank exits nonzero or `timeout` seconds pass, every rank still running
    is killed and RuntimeError names the rank, with the end of each log.
    """
    os.makedirs(log_dir, exist_ok=True)
    init = f"127.0.0.1:{free_port()}"
    paths = [os.path.join(log_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r, path in enumerate(paths):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [*argv, "--init", init, "--world", str(world), "--rank", str(r)],
                    stdout=f, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} of {world} exited with {codes[bad[0]]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = f"{world} ranks timed out after {timeout} s"
            else:
                time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    logs = []
    for path in paths:
        with open(path, errors="replace") as f:
            logs.append(f.read())
    if failed is not None:
        tails = "".join(f"\n--- rank {r} ---\n" + "\n".join(t.splitlines()[-40:])
                        for r, t in enumerate(logs))
        raise RuntimeError(f"{failed}{tails}")
    return logs
