#!/usr/bin/env python3
"""Comm-volume vs local-compute model of the multi-host target on H100s
(BASELINE.json:11: 4M vertices, >= 2 hosts, >= 80% nnz/s scaling
efficiency), built from the port's REAL halo exchange tables.

The twin of scripts/scaling_model.py, in precond_tpu_torch: for the 1M and
4M cloth systems at several shard counts it builds the Morton-sorted system
(models/cloth.assemble_system, utils/gridmorton.sort_maps,
ops/blockcsr.permute) and the halo tables (parallel/halo.build_halo_system)
and tabulates, per PCG iteration:

  * bytes exchanged for the SpMV halo (two ring shifts, or one all_to_all
    of the padded remote lists: whichever mode the Morton boundary needs);
  * bytes summed for the coarse-level restriction (the live level-1 span)
    and the CG dot products;
  * local HBM bytes each shard streams (ELL blocks + inverse table +
    vectors).

The mode and byte columns are the JAX script's, integer for integer.
Projected efficiency = t_local / (t_local + t_comm) with t_local = local
bytes / HBM rate and t_comm = comm bytes / link rate, NO overlap credited
(a lower bound). The rates are H100 SXM data-sheet figures, printed with
the table and not measured: HBM3 3.35 TB/s; NVLink 4 450 GB/s per
direction between the cards of one host; one NDR InfiniBand port
(400 Gb/s = 50 GB/s) per card between hosts. Both efficiencies are given:
BASELINE.json:11 asks for >= 2 hosts, where the inter-host link sets it.

Host work only (NumPy and torch on the CPU); nothing runs on a card.

    python3 scripts/torch_scaling_model.py
"""

from __future__ import annotations

import json
import os
import sys
import time


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from precond_tpu_torch import SchwarzConfig  # noqa: E402
from precond_tpu_torch.models import cloth  # noqa: E402
from precond_tpu_torch.ops import blockcsr  # noqa: E402
from precond_tpu_torch.parallel import halo  # noqa: E402
from precond_tpu_torch.utils import gridmorton as gm  # noqa: E402

# H100 SXM data sheet (not measured): HBM3 rate; NVLink 4 at 900 GB/s both
# ways = 450 GB/s per direction; one NDR InfiniBand port per card, 400 Gb/s.
HBM_GBPS = 3350.0
NVLINK_GBPS = 450.0
IB_GBPS = 50.0
# the JAX script's grids and shard counts
GRIDS = ((1024, (8, 16)), (2048, (8, 16, 32)))


def _eff(t_local: float, comm_bytes: int, link_gbps: float) -> float:
    return t_local / (t_local + comm_bytes / (link_gbps * 1e9))


def measure(grid: int, shards: int, cfg: SchwarzConfig) -> dict:
    """One row: the (grid x grid) cloth split over `shards` ranks."""
    n = grid * grid
    k = grid.bit_length() - 1
    mesh_c = cloth.make_grid(grid, grid, z_wave=0.02, mass=0.001)
    ell = cloth.assemble_system(mesh_c, device="cpu")
    s2o, o2s = (torch.as_tensor(m) for m in gm.sort_maps(k))
    ell_sorted = blockcsr.permute(ell, s2o, o2s)
    hsys = halo.build_halo_system(ell_sorted, shards)

    nnz_blocks = int(ell.mask.sum()) + n  # off-diagonal + diagonal 3x3 blocks
    levels = cfg.num_levels(n)
    offs = cfg.level_offsets(n)
    nblocks = offs[-1] // 32

    # ---- per-iteration comm bytes (per rank) ----------------------------
    if hsys.halo >= 0:
        # two ring shifts of `halo` rows of f32[3]
        spmv_bytes = 2 * hsys.halo * 3 * 4
        mode = f"ring halo={hsys.halo}"
    else:
        send = hsys.send_idx.numpy()
        # one all_to_all moves every padded slot of each rank's per-peer
        # lists; the ranks meet there, so the largest sender sets it
        per_shard_rows = send.shape[2] * shards
        spmv_bytes = per_shard_rows * 3 * 4
        real_rows = max(int((send[s] != 0).sum()) for s in range(shards))  # informational
        mode = f"sparse all_to_all (padded rows/shard={per_shard_rows}, live~{real_rows})"
    # the restriction's rank sum (a ring all-reduce moves ~2x the buffer per
    # rank) over the live level-1 span only (halo.local_apply's l1), plus 2
    # scalar dots. l1_live = n/32 exactly on the analytic orderings; the
    # general builder's worst case fills its 2x level-1 headroom.
    l1_live = n // 32
    psum_bytes = 2 * (l1_live + 1) * 3 * 4 + 2 * 2 * 4
    cap1 = offs[2] - offs[1] if levels > 1 else 0
    psum_bytes_worst = 2 * (cap1 + 1) * 3 * 4 + 2 * 2 * 4

    # ---- per-iteration local HBM bytes per rank --------------------------
    ell_bytes = nnz_blocks * 9 * 4 / shards          # block stream
    idx_bytes = nnz_blocks * 4 / shards
    packed = cfg.use_packed_symv(n)
    inv_bytes = nblocks * (4704 if packed else 9216) * 4 / shards
    vec_bytes = 6 * n * 3 * 4 / shards               # x, r, p, z, q, b streams
    local_bytes = ell_bytes + idx_bytes + inv_bytes + vec_bytes

    t_local = local_bytes / (HBM_GBPS * 1e9)
    comm = spmv_bytes + psum_bytes
    return {
        "grid": grid,
        "num_verts": n,
        "shards": shards,
        "mode": mode,
        "spmv_exchange_bytes": int(spmv_bytes),
        "coarse_psum_bytes": int(psum_bytes),
        "coarse_psum_bytes_worst": int(psum_bytes_worst),
        "local_hbm_bytes_per_shard": int(local_bytes),
        "packed_inverse": bool(packed),
        "t_local_us": round(t_local * 1e6, 1),
        "t_comm_nvlink_us": round(comm / (NVLINK_GBPS * 1e9) * 1e6, 2),
        "t_comm_ib_us": round(comm / (IB_GBPS * 1e9) * 1e6, 1),
        "eff_nvlink": round(_eff(t_local, comm, NVLINK_GBPS), 4),
        "eff_ib": round(_eff(t_local, comm, IB_GBPS), 4),
        "assumptions": {"hbm_GBps": HBM_GBPS, "nvlink_GBps": NVLINK_GBPS, "ib_GBps": IB_GBPS,
                        "source": "H100 SXM data sheet, not measured"},
    }


def main() -> int:
    cfg = SchwarzConfig()
    rows = []
    for grid, shard_list in GRIDS:
        for s in shard_list:
            t0 = time.perf_counter()
            r = measure(grid, s, cfg)
            r["build_s"] = round(time.perf_counter() - t0, 1)
            rows.append(r)
            print(json.dumps(r), flush=True)
    print(f"\nrates (H100 SXM data sheet, not measured): HBM {HBM_GBPS:g} GB/s, NVLink "
          f"{NVLINK_GBPS:g} GB/s per direction (one host), InfiniBand NDR {IB_GBPS:g} GB/s "
          f"per card (between hosts); no overlap credited")
    print("\n| grid | verts | shards | exchange mode | SpMV comm B/iter | psum B/iter | "
          "local HBM B/iter/shard | eff NVLink | eff IB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['grid']} | {r['num_verts'] / 1e6:.2f}M | {r['shards']} | {r['mode']} | "
              f"{r['spmv_exchange_bytes']:,} | {r['coarse_psum_bytes']:,} | "
              f"{r['local_hbm_bytes_per_shard']:,} | {r['eff_nvlink']:.1%} | {r['eff_ib']:.1%} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
