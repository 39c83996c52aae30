"""Carry the JAX package's state across to the port, as numpy arrays.

The system has no weights; its state is the ELL system, the sort maps, the
collision sets and stencils, and the prepared apply state. These converters take that state as numpy arrays
(``np.asarray`` of each JAX field) so both packages can be run on the
identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.apply import ApplyState
from .ops.blockcsr import BlockEll
from .ops.cuda.packed_symv import DenseInverseCM, PackedInverse, PackedInverseCM
from .ops.gridstencil import StencilSystem
from .ops.stencils import EeSets, EfSets, Stencils, VfSets
from .solver import SortMaps


def _t(a, dev, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    return torch.as_tensor(np.ascontiguousarray(arr if dtype is None else arr.astype(dtype)),
                           device=dev)


def block_ell_from_numpy(diag, idx, blocks, mask, device=None) -> BlockEll:
    """BlockEll from its four arrays (f32 diag/blocks, i32 idx, bool mask)."""
    dev = resolve_device(device)
    return BlockEll(diag=_t(diag, dev, np.float32), idx=_t(idx, dev, np.int32),
                    blocks=_t(blocks, dev, np.float32), mask=_t(mask, dev, bool))


def sort_maps_from_numpy(sorted_to_orig, orig_to_sorted, device=None) -> SortMaps:
    dev = resolve_device(device)
    return SortMaps(_t(sorted_to_orig, dev, np.int32), _t(orig_to_sorted, dev, np.int32))


def apply_state_from_numpy(
    sorted_to_orig, orig_to_sorted, going_next, ancestors, inv96, overflow,
    restrict_onehot, restrict_pos, restrict_pb, device=None,
) -> ApplyState:
    """ApplyState from the JAX ApplyState's fields.

    `inv96` is either a dense [B,96,96] array or the JAX PackedInverse
    (any object with fields f [48,96,Bp], dg [96,Bp] and nb).
    """
    dev = resolve_device(device)
    if hasattr(inv96, "f"):
        inv = PackedInverse(f=_t(inv96.f, dev, np.float32), dg=_t(inv96.dg, dev, np.float32),
                            nb=int(np.asarray(inv96.nb)))
    else:
        inv = _t(inv96, dev)
    return ApplyState(
        sorted_to_orig=_t(sorted_to_orig, dev, np.int32),
        orig_to_sorted=_t(orig_to_sorted, dev, np.int32),
        going_next=_t(going_next, dev, np.int32),
        ancestors=_t(ancestors, dev, np.int32),
        inv96=inv,
        overflow=_t(overflow, dev, bool),
        restrict_onehot=_t(restrict_onehot, dev, np.float32),
        restrict_pos=_t(restrict_pos, dev, np.int32),
        restrict_pb=_t(restrict_pb, dev, np.int32),
    )


def stencil_system_from_numpy(diag_t, dirs_t, offsets, grid, sym=False,
                              device=None) -> StencilSystem:
    """StencilSystem from the JAX one's planes (diag_t [3,3,N], dirs_t
    [D,3,3,N]) and its static offsets, grid and sym."""
    dev = resolve_device(device)
    return StencilSystem(_t(diag_t, dev, np.float32), _t(dirs_t, dev, np.float32),
                         offsets, grid, sym=sym)


def grid_blocks_from_numpy(diag_rows, dirs_rows, offsets, device=None):
    """The row-major grid blocks (diag_rows [N,3,3], dirs_rows [D,N,3,3],
    offsets) of the JAX package's assemble_system_grid."""
    dev = resolve_device(device)
    return (_t(diag_rows, dev, np.float32), _t(dirs_rows, dev, np.float32),
            tuple(tuple(int(v) for v in o) for o in offsets))


def packed_inverse_cm_from_numpy(f, dg, nb, device=None) -> PackedInverseCM:
    """PackedInverseCM from the JAX one's fields (same layout)."""
    dev = resolve_device(device)
    return PackedInverseCM(f=_t(f, dev, np.float32), dg=_t(dg, dev, np.float32),
                           nb=int(np.asarray(nb)))


def dense_inverse_cm_from_numpy(m, device=None) -> DenseInverseCM:
    """DenseInverseCM from the JAX one's batch-minor table m [3,32,3,32,B]:
    the port stores the same comp-major blocks batch-major, [B,96,96]."""
    dev = resolve_device(device)
    arr = np.asarray(m, np.float32)
    b = arr.shape[-1]
    return DenseInverseCM(m=_t(np.transpose(arr, (4, 0, 1, 2, 3)).reshape(b, 96, 96), dev))


def _sets(cls, fields, dev):
    """A proximity set from numpy fields: ids int32, the rest f32."""
    return cls(*(_t(f, dev, np.int32 if i < 2 else np.float32) for i, f in enumerate(fields)))


def ef_sets_from_numpy(e_id, f_id, stiff, bary, normal, device=None) -> EfSets:
    """EfSets from the JAX EfSets' fields."""
    return _sets(EfSets, (e_id, f_id, stiff, bary, normal), resolve_device(device))


def ee_sets_from_numpy(e_id0, e_id1, stiff, bary, normal, device=None) -> EeSets:
    """EeSets from the JAX EeSets' fields."""
    return _sets(EeSets, (e_id0, e_id1, stiff, bary, normal), resolve_device(device))


def vf_sets_from_numpy(v_id, f_id, stiff, bary, normal, device=None) -> VfSets:
    """VfSets from the JAX VfSets' fields."""
    return _sets(VfSets, (v_id, f_id, stiff, bary, normal), resolve_device(device))


def stencils_from_numpy(idx, weight, nverts, nfirst, stiff, direction, valid,
                        device=None) -> Stencils:
    """Stencils from the JAX Stencils' fields."""
    dev = resolve_device(device)
    return Stencils(idx=_t(idx, dev, np.int32), weight=_t(weight, dev, np.float32),
                    nverts=_t(nverts, dev, np.int32), nfirst=_t(nfirst, dev, np.int32),
                    stiff=_t(stiff, dev, np.float32), direction=_t(direction, dev, np.float32),
                    valid=_t(valid, dev, bool))
