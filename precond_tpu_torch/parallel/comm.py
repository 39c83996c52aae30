"""Collectives of one rank, the counterpart of what a ``shard_map`` body sees
(``lax.psum``, ``ppermute``, ``all_to_all``, ``axis_index``) on
torch.distributed.

A :class:`Group` is one rank's view of a 1-D process group: its rank, the
world size, the backend and the device its tensors live on. The multi-rank
solves (parallel/halo.py, sharded.py, gridsharded.py) compute on the rank's
own tensors and meet the other ranks only through these four operations.

* Without a process group (world size 1) every operation is the identity.
* With NCCL, CUDA tensors go to the collective as they are.
* With gloo and CUDA tensors, the payload is copied to host memory, sent,
  and copied back: gloo's transport does not take device tensors for every
  operation. This staging is explicit here and nowhere else; the compute,
  the rank-ordered sums included, never leaves the card. Several ranks sharing one card run this way,
  since NCCL refuses two ranks on one device.

The backend is the caller's choice (or ``hosts.initialize_hosts``'s); it is
never switched behind the caller's back. Sums over ranks gather every
rank's part and add them in rank order, so every rank gets the same bits
and a multi-rank solve repeats bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class CommStats:
    """What this rank's collectives cost: calls, the payload bytes this rank
    put into them, and host seconds inside them (staging copies included).
    A sum gathers every rank's part, so each rank receives world times the
    bytes it put in; an all_to_all or a ring shift receives about what it
    sent. With ``Group.timing`` on, a CUDA rank synchronizes its device
    before and after each call, so the seconds hold the device's share too
    (and the step runs slower)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


class Group:
    """One rank of a 1-D process group (see the module docstring)."""

    def __init__(self, rank: int = 0, world: int = 1, backend: Optional[str] = None,
                 device="cpu", timing: bool = False):
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        if (world > 1 or backend is not None) and not dist.is_initialized():
            raise ValueError("a backend or a world of more than one rank needs an "
                             "initialized process group (hosts.initialize_hosts)")
        self.rank, self.world = int(rank), int(world)
        #: None: no process group, every operation the identity
        self.backend = backend
        self.device = torch.device(device)
        self.timing = timing
        self.stats = CommStats()

    @classmethod
    def single(cls, device="cpu") -> "Group":
        """World size 1, no process group: every operation is the identity."""
        return cls(0, 1, None, device)

    @classmethod
    def from_dist(cls, device) -> "Group":
        """This process's rank of the initialized default process group."""
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized (hosts.initialize_hosts)")
        return cls(dist.get_rank(), dist.get_world_size(), dist.get_backend(), device)

    @property
    def distributed(self) -> bool:
        """True when the operations go through a process group."""
        return self.backend is not None

    # ---- staging and bookkeeping ---------------------------------------

    def _host_staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type != "cpu"

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """The payload as the backend takes it (gloo: a host copy)."""
        return x.detach().to("cpu") if self._host_staged(x) else x.detach().contiguous()

    def _begin(self, x: torch.Tensor, sent_bytes: int) -> float:
        self.stats.calls += 1
        self.stats.bytes += int(sent_bytes)
        if self.timing and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        return time.perf_counter()

    def _end(self, x: torch.Tensor, t0: float) -> None:
        if self.timing and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        self.stats.seconds += time.perf_counter() - t0

    # ---- the four operations ----------------------------------------------

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's x, added in rank order (``lax.psum``)."""
        if not self.distributed:
            return x
        t0 = self._begin(x, x.numel() * x.element_size())
        xs = self._out(x).reshape(-1)
        parts = [torch.empty_like(xs) for _ in range(self.world)]
        dist.all_gather(parts, xs)
        # only the transport is staged: the parts go back to x's device in
        # one copy, and the rank-ordered sum runs there
        stacked = torch.stack(parts).to(x.device)
        acc = stacked[0]
        for p in stacked[1:]:
            acc = acc + p
        out = acc.reshape(x.shape)
        self._end(x, t0)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [world, ...]: chunk d goes to rank d; returns [world, ...] whose
        chunk s came from rank s (``lax.all_to_all`` over the leading axis)."""
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all needs a leading axis of {self.world}, got {tuple(x.shape)}")
        if not self.distributed:
            return x
        t0 = self._begin(x, x.numel() * x.element_size())
        xs = self._out(x)
        out = torch.empty_like(xs)
        dist.all_to_all_single(out, xs)
        out = out.to(x.device)
        self._end(x, t0)
        return out

    def ring_shift(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Send x to rank (rank + shift) % world and return what rank
        (rank - shift) % world sent (``ppermute`` over a wrapped ring)."""
        if self.world == 1:
            return x
        t0 = self._begin(x, x.numel() * x.element_size())
        xs = self._out(x)
        out = torch.empty_like(xs)
        ops = [dist.P2POp(dist.isend, xs, (self.rank + shift) % self.world),
               dist.P2POp(dist.irecv, out, (self.rank - shift) % self.world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = out.to(x.device)
        self._end(x, t0)
        return out

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (equal shapes) stacked along the rows in rank order."""
        if not self.distributed:
            return x
        t0 = self._begin(x, x.numel() * x.element_size())
        xs = self._out(x)
        parts = [torch.empty_like(xs) for _ in range(self.world)]
        dist.all_gather(parts, xs)
        out = torch.cat(parts, dim=0).to(x.device)
        self._end(x, t0)
        return out

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def row_range(n: int, world: int, rank: int):
    """(start, stop) of rank's rows when n rows are split over world ranks as
    ``torch.chunk`` splits them (a DTensor ``Shard(0)``'s layout): chunks of
    ceil(n / world) rows, the last ones shorter or empty."""
    c = -(-n // world)
    start = min(rank * c, n)
    return start, min(start + c, n)


def exchange_plan(needs: List, rows_per: int, world: int):
    """Host tables of one all_to_all that hands each rank the rows it needs.

    needs[d] lists, in the order rank d wants them, the global rows rank d
    reads; global row g lives on rank g // rows_per at local row
    g % rows_per. Returns (send i32[world, world, S], recv_perm i32[world, R]):
    rank s sends its local rows send[s, d] to rank d (S-padded with row 0),
    and rank d reads need j at flat position recv_perm[d, j] of the received
    [world * S] rows (R-padded with 0). S and R are rounded up to multiples
    of 8, at least 1; for sorted, unique need lists these are the JAX
    package's sparse halo tables (parallel/halo.py).
    """
    needs = [np.asarray(x, np.int64).reshape(-1) for x in needs]
    r_cap = max(1, -(-max((len(x) for x in needs), default=0) // 8) * 8)
    srcs = [x // rows_per for x in needs]
    counts = np.stack([np.bincount(src, minlength=world) for src in srcs], axis=1)  # [s, d]
    s_cap = max(1, -(-int(counts.max(initial=0)) // 8) * 8)
    send = np.zeros((world, world, s_cap), np.int32)
    recv_perm = np.zeros((world, r_cap), np.int32)
    for d in range(world):
        order = np.argsort(srcs[d], kind="stable")   # by source rank, need order kept
        src = srcs[d][order]
        starts = np.searchsorted(src, np.arange(world))
        recv_perm[d, order] = src * s_cap + np.arange(len(order)) - starts[src]
        rows = needs[d][order] - src * rows_per
        for s in range(world):
            send[s, d, : counts[s, d]] = rows[starts[s]: starts[s] + counts[s, d]]
    return send, recv_perm


def exchange(group: Group, x_local: torch.Tensor, send: torch.Tensor,
             recv: torch.Tensor) -> torch.Tensor:
    """Run one plan of exchange_plan on this rank: send [world, S] (this
    rank's row of the plan's send table), recv [R] (its row of recv_perm).
    Returns the [R, ...] rows this rank needs, in its need order."""
    w, s_cap = send.shape
    xs = x_local[send.reshape(-1)].reshape((w, s_cap) + tuple(x_local.shape[1:]))
    received = group.all_to_all(xs)
    return received.reshape((w * s_cap,) + tuple(x_local.shape[1:]))[recv]

