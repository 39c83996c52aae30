"""Carry the JAX package's state across to the port, as numpy arrays.

The system has no weights; its state is the ELL system (or its grid and box
stencil forms), the sort maps, the collision sets and stencils, the
prepared apply state and a simulator's positions and velocities. These converters take that state as numpy arrays
(``np.asarray`` of each JAX field) so both packages can be run on the
identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.apply import ApplyState
from .models.simulator import SimState
from .ops.blockcsr import BlockEll
from .ops.boxstencil import BoxStencilSystem
from .ops.cuda.packed_symv import DenseInverseCM, PackedInverse, PackedInverseCM
from .ops.gridstencil import StencilSystem
from .ops.stencils import EeSets, EfSets, Stencils, VfSets
from .parallel.halo import HaloSystem, ShardedApply
from .solver import SortMaps


def _t(a, dev, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if dtype is None and arr.dtype.name == "bfloat16":
        return bf16_from_numpy(arr, dev)
    return torch.as_tensor(np.ascontiguousarray(arr if dtype is None else arr.astype(dtype)),
                           device=dev)


def bf16_from_numpy(arr, dev) -> torch.Tensor:
    """A bf16 tensor from JAX's bf16 numpy array (the ``ml_dtypes.bfloat16``
    dtype, which torch cannot read): its 16-bit patterns, carried as int16
    and viewed back as bf16, so no bit changes and no ml_dtypes import is
    needed."""
    bits = np.array(arr).view(np.int16)   # a writable copy
    return torch.as_tensor(bits, device=dev).view(torch.bfloat16)


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

    `inv96` is a dense [B,96,96] array (f32, or JAX's bf16), the JAX
    PackedInverse or PackedInverseCM (fields f [48,96,Bp], dg [96,Bp], nb),
    or the JAX DenseInverseCM (field m [3,32,3,32,B]); the packed and
    comp-major forms are told apart by their type's name.
    """
    dev = resolve_device(device)
    kind = type(inv96).__name__
    if kind == "DenseInverseCM":
        inv = dense_inverse_cm_from_numpy(inv96.m, device=dev)
    else:
        inv = _inverse(inv96, dev)
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


def _inverse(inv, dev):
    """A dense [B,96,96] array, or the JAX PackedInverse / PackedInverseCM
    (fields f, dg, nb), as the port's table."""
    if hasattr(inv, "f"):
        cls = PackedInverseCM if type(inv).__name__ == "PackedInverseCM" else PackedInverse
        return cls(f=_t(inv.f, dev, np.float32), dg=_t(inv.dg, dev, np.float32),
                   nb=int(np.asarray(inv.nb)))
    return _t(inv, dev)


def halo_system_from_numpy(diag, idx_ext, blocks, halo, shard_rows, send_idx, recv_perm,
                           device=None) -> HaloSystem:
    """parallel.halo.HaloSystem from the JAX HaloSystem's fields (all
    shards'; parallel.halo.local_halo takes one rank's rows)."""
    dev = resolve_device(device)
    return HaloSystem(diag=_t(diag, dev, np.float32), idx_ext=_t(idx_ext, dev, np.int32),
                      blocks=_t(blocks, dev, np.float32), halo=int(halo),
                      shard_rows=int(shard_rows), send_idx=_t(send_idx, dev, np.int32),
                      recv_perm=_t(recv_perm, dev, np.int32))


def sharded_apply_from_numpy(going_next_fine, anc1, inv_fine, inv_coarse, going_next_coarse,
                             n, total_coarse, l1_live=0, num_shards=1,
                             device=None) -> ShardedApply:
    """parallel.halo.ShardedApply from the JAX ShardedApply's fields (all
    shards'; parallel.halo.local_apply_state takes one rank's part). The
    JAX type does not record the shard count its packed fine table was
    padded for: pass the `num_shards` given to its split_apply_state."""
    dev = resolve_device(device)
    return ShardedApply(going_next_fine=_t(going_next_fine, dev, np.int32),
                        anc1=_t(anc1, dev, np.int32), inv_fine=_inverse(inv_fine, dev),
                        inv_coarse=_inverse(inv_coarse, dev),
                        going_next_coarse=_t(going_next_coarse, dev, np.int32), n=int(n),
                        total_coarse=int(total_coarse), l1_live=int(l1_live),
                        num_shards=int(num_shards))


def stencil_system_from_numpy(diag_t, dirs_t, offsets, grid, sym=False,
                              device=None) -> StencilSystem:
    """StencilSystem from the JAX one's planes (diag_t [3,3,N], dirs_t
    [D,3,3,N]) and its static offsets, grid and sym."""
    dev = resolve_device(device)
    return StencilSystem(_t(diag_t, dev, np.float32), _t(dirs_t, dev, np.float32),
                         offsets, grid, sym=sym)


def box_stencil_system_from_numpy(diag_t, dirs_t, offsets, dims, device=None) -> BoxStencilSystem:
    """BoxStencilSystem from the JAX one's planes (diag_t [3,3,N], dirs_t
    [D,3,3,N]) and its static offsets and dims."""
    dev = resolve_device(device)
    return BoxStencilSystem(_t(diag_t, dev, np.float32), _t(dirs_t, dev, np.float32),
                            offsets, dims)


def sim_state_from_numpy(positions, velocities, step_count=0, device=None) -> SimState:
    """A simulator's SimState from the JAX one's fields."""
    dev = resolve_device(device)
    return SimState(_t(positions, dev, np.float32), _t(velocities, dev, np.float32),
                    int(step_count))


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
    """DenseInverseCM from the JAX one's batch-minor table m [3,32,3,32,B]
    (f32, or JAX's bf16, kept bf16)."""
    arr = np.asarray(m)
    bf16 = arr.dtype.name == "bfloat16"
    return dense_inverse_cm_from_jax_layout(
        _t(arr, resolve_device(device), None if bf16 else np.float32))


def dense_inverse_cm_from_jax_layout(m: torch.Tensor) -> DenseInverseCM:
    """The JAX layout [3,32,3,32,B] -> the port's DenseInverseCM, which
    stores the same comp-major blocks batch-major, [B,96,96]."""
    b = m.shape[-1]
    return DenseInverseCM(m=m.permute(4, 0, 1, 2, 3).reshape(b, 96, 96).contiguous())


def dense_inverse_cm_to_jax_layout(inv: DenseInverseCM) -> torch.Tensor:
    """The port's DenseInverseCM -> the JAX layout [3,32,3,32,B] (the inverse
    of dense_inverse_cm_from_jax_layout)."""
    b = inv.m.shape[0]
    return inv.m.reshape(b, 3, 32, 3, 32).permute(1, 2, 3, 4, 0).contiguous()


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
