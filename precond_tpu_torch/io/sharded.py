"""Sharded checkpoint / resume (port of ``precond_tpu/io/sharded.py``) on
torch.distributed.checkpoint (DCP) in place of orbax.

The npz path (io/checkpoint.py) funnels every array through host memory of
one process. DCP writes each shard from the rank that owns it and restores
into whatever tensors the caller hands it, so checkpoints scale with the
process group and survive a change of its size between save and load.

Without a process group, save and load run in DCP's single-process mode.
With one (parallel/hosts.initialize_hosts), both are collective: every
rank calls them with the same tree.

* A row-sharded leaf (a solve's x, or anything each rank holds only its
  rows of) is a DTensor with ``Shard(0)`` over the 1-D rank mesh
  (shard_rows). Each rank writes its own rows. A plain tensor is taken as
  REPLICATED: DCP's planner keeps one rank's copy and drops the others, so
  rows that differ between ranks must go in as a DTensor or be lost
  without an error.
* A restore may change the group size: a template leaf from rows_template
  reads this rank's rows (torch.chunk layout) out of whatever chunks were
  saved, from a plain tensor or from a DTensor of another world size;
  without a template every tensor comes back whole.

With gloo, the DTensors live on the CPU (the payload is host memory either
way). Restored rows come back on the CPU; load_solver_sharded moves them to
the solver's device.

Trees are nested dicts whose leaves are tensors or Python objects (ints,
strings); named tuples (SortMaps, ApplyState, the packed inverses) are
stored as dicts with their type's name under ``__type__``.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemReader
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

from ..ops.apply import ApplyState
from ..ops.cuda.packed_symv import DenseInverseCM, PackedInverse, PackedInverseCM
from ..parallel.comm import row_range
from ..solver import SchwarzPreconditioner, SortMaps
from .checkpoint import _fingerprint, check_fingerprint

_TUPLES = {t.__name__: t for t in (SortMaps, ApplyState, PackedInverse, PackedInverseCM,
                                   DenseInverseCM)}


def _no_dist() -> bool:
    return not (dist.is_available() and dist.is_initialized())


@contextlib.contextmanager
def _single_process():
    """DCP warns on every call in its no-dist mode, which is this module's
    intended mode without a process group."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _mesh_device(device: torch.device) -> str:
    return "cpu" if dist.get_backend() == "gloo" else device.type


def shard_rows(local: torch.Tensor, global_rows: int):
    """This rank's rows of a [global_rows, ...] tensor as a row-sharded leaf:
    a DTensor with Shard(0) over every rank (rows in row_range's torch.chunk
    layout). Without a process group, the tensor itself."""
    if _no_dist():
        return local
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    world, rank = dist.get_world_size(), dist.get_rank()
    start, stop = row_range(global_rows, world, rank)
    if local.shape[0] != stop - start:
        raise ValueError(f"rank {rank} holds {local.shape[0]} rows; a {global_rows}-row "
                         f"tensor over {world} ranks gives it {stop - start}")
    kind = _mesh_device(local.device)
    mesh = init_device_mesh(kind, (world,))
    shape = (global_rows,) + tuple(local.shape[1:])
    return DTensor.from_local(local.detach().to(kind).contiguous(), mesh, [Shard(0)],
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def rows_template(shape, dtype):
    """A template leaf that restores this rank's rows of a [shape[0], ...]
    tensor (the whole tensor without a process group), on the CPU."""
    if _no_dist():
        return torch.empty(shape, dtype=dtype)
    start, stop = row_range(shape[0], dist.get_world_size(), dist.get_rank())
    return shard_rows(torch.empty((stop - start,) + tuple(shape[1:]), dtype=dtype), shape[0])


def _is_dtensor(t) -> bool:
    # by name: importing torch.distributed.tensor is slow, and DTensors only
    # exist once shard_rows has imported it
    return type(t).__name__ == "DTensor"


def save_tree(path: str, tree: dict) -> None:
    """Write a nested dict of tensors (DTensors for row-sharded leaves) and
    Python objects; returns once the files are written. Collective when a
    process group is up."""
    with _single_process():
        dcp.save(tree, checkpoint_id=os.path.abspath(path), no_dist=_no_dist())


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *head, last = key.split(".")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _like(template: Any) -> Any:
    """Fresh tensors of each template tensor's shape, dtype, device and
    sharding (so a load never writes into the caller's template)."""
    if _is_dtensor(template):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(torch.empty_like(template.to_local()), template.device_mesh,
                                  template.placements, run_check=False, shape=template.shape,
                                  stride=template.stride())
    if isinstance(template, torch.Tensor):
        return torch.empty_like(template)
    if isinstance(template, dict):
        return {k: _like(v) for k, v in template.items()}
    return template


def _local(tree: Any) -> Any:
    """DTensor leaves -> this rank's rows."""
    if _is_dtensor(tree):
        return tree.to_local()
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    return tree


def load_tree(path: str, template: Optional[dict] = None, rows: Iterable[str] = ()) -> dict:
    """Restore a tree; collective when a process group is up.

    `template` carries the target structure plus, per tensor leaf, the
    device and dtype to restore into (rows_template leaves restore this
    rank's rows). Without a template, tensors are built from the
    checkpoint's metadata on the CPU, whole, except the dotted keys in
    `rows` (e.g. "x"), which come back as this rank's rows.
    """
    path = os.path.abspath(path)
    if template is None:
        meta = FileSystemReader(path).read_metadata()
        rows = set(rows)
        flat = {}
        for key, md in meta.state_dict_metadata.items():
            if isinstance(md, TensorStorageMetadata):
                shape, dtype = tuple(md.size), md.properties.dtype
                flat[key] = (rows_template(shape, dtype) if key in rows
                             else torch.empty(shape, dtype=dtype))
            else:
                flat[key] = None   # a Python object, filled in by the load
        with _single_process():
            dcp.load(flat, checkpoint_id=path, no_dist=_no_dist())
        return _local(_unflatten(flat))
    tree = _like(template)
    with _single_process():
        dcp.load(tree, checkpoint_id=path, no_dist=_no_dist())
    return _local(tree)


def _to_tree(v: Any) -> Any:
    if hasattr(v, "_asdict"):
        return {"__type__": type(v).__name__, **{k: _to_tree(x) for k, x in v._asdict().items()}}
    return v


def _from_tree(v: Any, device) -> Any:
    """Rebuild the named tuples; tensors move to `device` (None: stay)."""
    if isinstance(v, torch.Tensor):
        return v if device is None else v.to(device)
    if isinstance(v, dict) and "__type__" in v:
        cls = _TUPLES[v["__type__"]]
        return cls(**{k: _from_tree(v[k], device) for k in cls._fields})
    return v


def _solver_tree(pre: SchwarzPreconditioner, x) -> dict:
    tree: dict = {"frame_index": int(pre.frame_index)}
    if pre.maps is not None:
        tree["maps"] = _to_tree(pre.maps)
    if pre.state is not None:
        tree["state"] = _to_tree(pre.state)
    if x is not None:
        tree["x"] = x
    return tree


def save_solver_sharded(path: str, pre: SchwarzPreconditioner, x=None) -> None:
    """Solver state -> a DCP checkpoint directory + fingerprint json.

    With a process group every rank calls this: the solver state is
    replicated (every rank prepared the same), and `x` is a row-sharded
    leaf from shard_rows when each rank holds only its rows."""
    path = os.path.abspath(path)
    save_tree(path, _solver_tree(pre, x))
    if _no_dist() or dist.get_rank() == 0:
        with open(os.path.join(path, "fingerprint.json"), "w") as f:
            json.dump(_fingerprint(pre), f, sort_keys=True)
    if not _no_dist():
        dist.barrier()


def load_solver_sharded(path: str, pre: SchwarzPreconditioner,
                        template: Optional[dict] = None,
                        x_rows: bool = False) -> Optional[torch.Tensor]:
    """Restore solver state; validates the config/mesh fingerprint.

    `template`, if given, mirrors the saved tree (named tuples as dicts with
    their ``__type__``, as save_solver_sharded writes them) with tensors on
    the target devices and dtypes; without one, tensors land on
    ``pre.device``, and `x_rows` restores only this rank's rows of x
    (whatever group size saved it).
    """
    path = os.path.abspath(path)
    fp_file = os.path.join(path, "fingerprint.json")
    if os.path.exists(fp_file):
        with open(fp_file) as f:
            check_fingerprint(json.load(f), pre)
    tree = load_tree(path, template, rows=("x",) if x_rows else ())
    dev = None if template is not None else pre.device
    pre.frame_index = int(tree["frame_index"])
    if "maps" in tree:
        pre.maps = _from_tree(tree["maps"], dev)
    if "state" in tree:
        pre.state = _from_tree(tree["state"], dev)
    return _from_tree(tree["x"], dev) if "x" in tree else None
