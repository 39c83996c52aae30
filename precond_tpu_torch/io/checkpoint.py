"""Checkpoint / resume of solver state (port of ``precond_tpu/io/checkpoint.py``).

The reference rebuilds everything per frame; its only cross-frame state is
the frame counter and the 17-frame-stale Morton sort (cpp:44-52). For long
simulations the useful persistent state is exactly that plus the solution
vector: everything is flat arrays, so an npz round-trip suffices. For
sharded runs use io/sharded.py (torch.distributed.checkpoint).

The file format is the JAX package's: the same npz keys (``frame_index``,
``maps.*``, ``state.*``, ``x``, ``__inv_type__``, ``__dtypes__``,
``__fingerprint__``) and the same array layouts, so a file written by the
JAX package loads into the port. (The fingerprint is the port's config,
which lacks the JAX package's TPU-only switches; the JAX loader compares
whole fingerprints and so refuses a port-written file.) Where the port's
layout differs it is converted here: the port's DenseInverseCM [B,96,96] is written as the JAX
package's batch-minor [3,32,3,32,B], and PackedInverse.nb (an int here) as
an int32 scalar. bfloat16 tensors (cfg.inverse_dtype="bfloat16") are stored
as uint16 views with their dtype recorded in ``__dtypes__``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..convert import dense_inverse_cm_from_jax_layout, dense_inverse_cm_to_jax_layout
from ..ops.apply import ApplyState
from ..ops.cuda.packed_symv import DenseInverseCM, PackedInverse, PackedInverseCM
from ..solver import SchwarzPreconditioner, SortMaps

_INV_TYPES = {t.__name__: t for t in (PackedInverse, PackedInverseCM, DenseInverseCM)}


def _to_numpy(t: torch.Tensor, key: str, dtypes: Dict[str, str]) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        dtypes[key] = "bfloat16"
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray],
             dtypes: Dict[str, str]) -> None:
    if isinstance(tree, DenseInverseCM):
        tree = DenseInverseCM(m=dense_inverse_cm_to_jax_layout(tree))
    if hasattr(tree, "_asdict"):
        for k, v in tree._asdict().items():
            _flatten(f"{prefix}{k}.", v, out, dtypes)
        return
    key = prefix.rstrip(".")
    if isinstance(tree, torch.Tensor):
        out[key] = _to_numpy(tree, key, dtypes)
    elif isinstance(tree, int):
        out[key] = np.asarray(tree, np.int32)   # PackedInverse.nb: JAX's i32 scalar
    else:
        out[key] = np.asarray(tree)


def _restore(data, key: str, dtypes: Dict[str, str], device) -> torch.Tensor:
    a = data[key]
    if dtypes.get(key) == "bfloat16":
        return torch.as_tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    if key in dtypes:
        raise ValueError(f"checkpoint key {key!r} has dtype {dtypes[key]!r} the port cannot read")
    return torch.as_tensor(a, device=device)


def _fingerprint(pre: SchwarzPreconditioner) -> Dict[str, Any]:
    # cfg_effective (not cfg): overflow recovery may have grown
    # level_headroom, and the saved state's level geometry follows it.
    fp: Dict[str, Any] = dataclasses.asdict(pre.cfg_effective)
    if pre.maps is not None:
        fp["num_verts"] = int(pre.maps.sorted_to_orig.shape[0])
    return fp


def check_fingerprint(saved: Dict[str, Any], pre: SchwarzPreconditioner) -> None:
    """Refuse a saved fingerprint that disagrees with `pre`; restore a saved
    level_headroom into ``pre.cfg_effective``.

    Only the fields both packages' configs have are compared: a fingerprint
    written by the JAX package also holds its TPU-only switches
    (use_pallas_symv, pallas_inverse_group), which select no function here,
    and its inverse_kernel="pallas" computes the function of the port's
    "panel" kernel.
    """
    saved, mine = dict(saved), _fingerprint(pre)
    saved_n = saved.pop("num_verts", None)
    mine_n = mine.pop("num_verts", None)
    # level_headroom may legitimately differ: a checkpoint written after
    # overflow recovery restores its grown headroom into the receiver.
    saved_headroom = saved.pop("level_headroom", None)
    mine.pop("level_headroom", None)
    if saved.get("inverse_kernel") == "pallas":
        saved["inverse_kernel"] = "panel"
    common = sorted(set(saved) & set(mine))
    saved = {k: saved[k] for k in common}
    mine = {k: mine[k] for k in common}
    if saved != mine:
        raise ValueError(f"checkpoint config mismatch: saved {saved} vs solver {mine}")
    if saved_n is not None and mine_n is not None and saved_n != mine_n:
        raise ValueError(f"checkpoint mesh mismatch: saved num_verts={saved_n} vs {mine_n}")
    if saved_headroom is not None:
        pre.cfg_effective = dataclasses.replace(pre.cfg, level_headroom=saved_headroom)


def save_solver(path: str, pre: SchwarzPreconditioner,
                x: Optional[torch.Tensor] = None) -> None:
    """Persist sort maps, apply-state and (optionally) the solution vector."""
    arrays: Dict[str, np.ndarray] = {"frame_index": np.asarray(pre.frame_index)}
    dtypes: Dict[str, str] = {}
    if pre.maps is not None:
        _flatten("maps.", pre.maps, arrays, dtypes)
    if pre.state is not None:
        _flatten("state.", pre.state, arrays, dtypes)
        # record the CONCRETE inverse container type: PackedInverse and
        # PackedInverseCM have identical field names but different DOF
        # conventions — reconstructing the wrong one would silently apply
        # the wrong preconditioner
        arrays["__inv_type__"] = np.frombuffer(
            type(pre.state.inv96).__name__.encode(), dtype=np.uint8
        ).copy()
    if x is not None:
        _flatten("x", x, arrays, dtypes)
    arrays["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8).copy()
    arrays["__fingerprint__"] = np.frombuffer(
        json.dumps(_fingerprint(pre), sort_keys=True).encode(), dtype=np.uint8
    ).copy()
    np.savez_compressed(path, **arrays)


def load_solver(path: str, pre: SchwarzPreconditioner) -> Optional[torch.Tensor]:
    """Restore a solver checkpoint into `pre` (tensors on ``pre.device``);
    returns the solution if saved.

    Refuses a checkpoint whose config/mesh fingerprint disagrees with the
    receiving solver (``check_fingerprint``) — a mismatched N or level
    geometry would otherwise load silently and fail later with shape errors
    or wrong preconditioning.
    """
    dev = pre.device
    with np.load(path) as data:
        dtypes: Dict[str, str] = {}
        if "__dtypes__" in data:
            dtypes = json.loads(bytes(data["__dtypes__"].tobytes()).decode())
        if "__fingerprint__" in data:
            check_fingerprint(json.loads(bytes(data["__fingerprint__"].tobytes()).decode()), pre)
        pre.frame_index = int(data["frame_index"])
        if "maps.sorted_to_orig" in data:
            pre.maps = SortMaps(
                sorted_to_orig=_restore(data, "maps.sorted_to_orig", dtypes, dev),
                orig_to_sorted=_restore(data, "maps.orig_to_sorted", dtypes, dev),
            )
        if any(k in data for k in ("state.inv96", "state.inv96.f", "state.inv96.m")):
            inv_type = None
            if "__inv_type__" in data:
                inv_type = bytes(data["__inv_type__"].tobytes()).decode()
            fields = {}
            for f in ApplyState._fields:
                if f == "inv96" and "state.inv96.f" in data:
                    # packed-symmetric inverse (saved as its nested fields);
                    # dispatch on the RECORDED type — the row-major and
                    # comp-major packings share field names but not DOF
                    # conventions, so guessing would be silently wrong
                    cls = _INV_TYPES.get(inv_type or "PackedInverse")
                    if cls is None or cls is DenseInverseCM:
                        raise ValueError(f"checkpoint inv96 type {inv_type!r} does not match "
                                         "its saved packed fields")
                    fields[f] = cls(f=_restore(data, "state.inv96.f", dtypes, dev),
                                    dg=_restore(data, "state.inv96.dg", dtypes, dev),
                                    nb=int(data["state.inv96.nb"]))
                elif f == "inv96" and "state.inv96.m" in data:
                    fields[f] = dense_inverse_cm_from_jax_layout(
                        _restore(data, "state.inv96.m", dtypes, dev))
                else:
                    fields[f] = _restore(data, f"state.{f}", dtypes, dev)
            pre.state = ApplyState(**fields)
        return _restore(data, "x", dtypes, dev) if "x" in data else None
