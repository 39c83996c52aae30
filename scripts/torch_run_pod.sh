#!/usr/bin/env bash
# Multi-host run of the 4M-vertex north-star config (BASELINE.json:11) on
# CUDA hosts: the twin of scripts/run_pod.sh for the PyTorch port.
#
# Run THIS SAME command on every host. One rank per card, NCCL. Arguments
# after the command go to scripts/torch_pod_solve.py (--tol, --device cpu).
#
# POD_AUTO=1 (default): torchrun (python3 -m torch.distributed.run) starts
# the host's ranks and sets their WORLD_SIZE / RANK / LOCAL_RANK
# (scripts/torch_pod_solve.py joins with env://):
#   POD_NNODES          hosts in the run (default 1)
#   POD_NPROC_PER_NODE  ranks on this host (default: its cards, nvidia-smi -L)
#   POD_RDZV            host0:port of the rendezvous (needed when POD_NNODES > 1;
#                       one host alone runs torchrun --standalone)
#
# POD_AUTO=0 (manual bring-up, one process per card, started by hand):
#   POD_COORDINATOR=host0:8476 POD_NPROC=<ranks in all> POD_PID=<this rank>
#   (and LOCAL_RANK=<card on this host>, else rank % cards picks it)
#
# The solve is the halo path of tests/test_torch_multiprocess.py and
# chip_smoke.py's north-star phase; the pod run changes only the fabric.
set -euo pipefail
cd "$(dirname "$0")/.."

: "${POD_GRID:=2048}"        # 2048x2048 cloth = 4.19M vertices
: "${POD_AUTO:=1}"
export POD_AUTO

if [[ "$POD_AUTO" == "1" ]]; then
  : "${POD_NNODES:=1}"
  : "${POD_NPROC_PER_NODE:=$(nvidia-smi -L | wc -l)}"
  if [[ "$POD_NNODES" == "1" ]]; then
    exec python3 -m torch.distributed.run --standalone --nproc_per_node="$POD_NPROC_PER_NODE" \
      scripts/torch_pod_solve.py --grid "$POD_GRID" "$@"
  fi
  exec python3 -m torch.distributed.run --nnodes="$POD_NNODES" \
    --nproc_per_node="$POD_NPROC_PER_NODE" --rdzv_backend=c10d --rdzv_id=precond_pod \
    --rdzv_endpoint="${POD_RDZV:?set POD_RDZV=host0:port}" \
    scripts/torch_pod_solve.py --grid "$POD_GRID" "$@"
fi
exec python3 scripts/torch_pod_solve.py --grid "$POD_GRID" "$@"
