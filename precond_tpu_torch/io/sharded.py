"""Sharded checkpoint / resume (port of ``precond_tpu/io/sharded.py``) on
torch.distributed.checkpoint (DCP) in place of orbax.

The npz path (io/checkpoint.py) funnels every array through host memory of
one process. DCP writes each shard from the process that owns it and
restores into whatever tensors the caller hands it, so checkpoints scale
with the process group.

This module runs in one process: without ``init_process_group`` DCP saves
and loads in its no-dist mode. With a process group, save and load are
collective over it; a restore resharded across ranks is not supported
yet.

Trees are nested dicts whose leaves are tensors or Python objects (ints,
strings); named tuples (SortMaps, ApplyState, the packed inverses) are
stored as dicts with their type's name under ``__type__``.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemReader
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

from ..ops.apply import ApplyState
from ..ops.cuda.packed_symv import DenseInverseCM, PackedInverse, PackedInverseCM
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


def save_tree(path: str, tree: dict) -> None:
    """Write a nested dict of tensors and Python objects; returns once the
    files are written."""
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
    """Fresh tensors of each template tensor's shape, dtype and device (so a
    load never writes into the caller's template)."""
    if isinstance(template, torch.Tensor):
        return torch.empty_like(template)
    if isinstance(template, dict):
        return {k: _like(v) for k, v in template.items()}
    return template


def load_tree(path: str, template: Optional[dict] = None) -> dict:
    """Restore a tree.

    `template` carries the target structure plus, per tensor leaf, the
    device and dtype to restore into (the port's counterpart of restoring
    into a sharding). Without a template, the tensors are built from the
    checkpoint's metadata and come back on the CPU.
    """
    path = os.path.abspath(path)
    if template is None:
        meta = FileSystemReader(path).read_metadata()
        flat = {}
        for key, md in meta.state_dict_metadata.items():
            if isinstance(md, TensorStorageMetadata):
                flat[key] = torch.empty(md.size, dtype=md.properties.dtype)
            else:
                flat[key] = None   # a Python object, filled in by the load
        with _single_process():
            dcp.load(flat, checkpoint_id=path, no_dist=_no_dist())
        return _unflatten(flat)
    tree = _like(template)
    with _single_process():
        dcp.load(tree, checkpoint_id=path, no_dist=_no_dist())
    return tree


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


def _solver_tree(pre: SchwarzPreconditioner, x: Optional[torch.Tensor]) -> dict:
    tree: dict = {"frame_index": int(pre.frame_index)}
    if pre.maps is not None:
        tree["maps"] = _to_tree(pre.maps)
    if pre.state is not None:
        tree["state"] = _to_tree(pre.state)
    if x is not None:
        tree["x"] = x
    return tree


def save_solver_sharded(path: str, pre: SchwarzPreconditioner,
                        x: Optional[torch.Tensor] = None) -> None:
    """Solver state -> a DCP checkpoint directory + fingerprint json."""
    path = os.path.abspath(path)
    save_tree(path, _solver_tree(pre, x))
    with open(os.path.join(path, "fingerprint.json"), "w") as f:
        json.dump(_fingerprint(pre), f, sort_keys=True)


def load_solver_sharded(path: str, pre: SchwarzPreconditioner,
                        template: Optional[dict] = None) -> Optional[torch.Tensor]:
    """Restore solver state; validates the config/mesh fingerprint.

    `template`, if given, mirrors the saved tree (named tuples as dicts with
    their ``__type__``, as save_solver_sharded writes them) with tensors on
    the target devices and dtypes; without one, tensors land on
    ``pre.device``.
    """
    path = os.path.abspath(path)
    fp_file = os.path.join(path, "fingerprint.json")
    if os.path.exists(fp_file):
        with open(fp_file) as f:
            check_fingerprint(json.load(f), pre)
    tree = load_tree(path, template)
    dev = None if template is not None else pre.device
    pre.frame_index = int(tree["frame_index"])
    if "maps" in tree:
        pre.maps = _from_tree(tree["maps"], dev)
    if "state" in tree:
        pre.state = _from_tree(tree["state"], dev)
    return _from_tree(tree["x"], dev) if "x" in tree else None
