#!/usr/bin/env bash
# Multi-process launch of murb_tpu_torch's distributed engines (the
# analogue of the reference's `srun -n 4 ./bin/murb ... --im mpi`, ref:
# README.md:93-95, and of scripts/run_multihost.sh for murb_tpu).
#
# Every process joins one torch.distributed group from MURB_COORDINATOR
# (host:port), MURB_NUM_PROCESSES and MURB_PROCESS_ID
# (murb_tpu_torch/parallel/mesh.py:maybe_init_distributed): NCCL with
# DEVICE=cuda (the default; process i takes card i mod the host's cards,
# SHARDS cards a process, 1 by default), gloo with DEVICE=cpu (SHARDS
# virtual CPU shards a process, 4 by default).  This script starts NPROC
# processes on this host, one run across all of them, and waits for
# every one (a failure stops the others).  On several hosts, run the
# python command below on each with MURB_COORDINATOR naming the first
# host and MURB_PROCESS_ID each process's global rank: nothing else is
# needed.  `--im shard+ring` then runs the pipelined ring (K14) across the
# hosts by default (ring_impl auto): each process boundary inside a host
# stays a CUDA IPC edge, and one that crosses hosts is staged through
# pinned host memory and sent by the ring's agent threads on a gloo side
# group that every process makes at the ring's first call
# (murb_tpu_torch/ops/ring.py).
#
#   NPROC=2 DEVICE=cpu N=10000 bash scripts/torch_run_multihost.sh
set -euo pipefail
cd "$(dirname "$0")/.."

NPROC=${NPROC:-2}
DEVICE=${DEVICE:-cuda}
if [ "$DEVICE" = cpu ]; then SHARDS=${SHARDS:-4}; else SHARDS=${SHARDS:-1}; fi
PORT=${PORT:-$(python - <<'PY'
import socket
s = socket.socket(); s.bind(("localhost", 0)); print(s.getsockname()[1])
PY
)}
N=${N:-10000}
ITERS=${ITERS:-10}
IM=${IM:-shard+proxy}

echo "coordinator localhost:$PORT, $NPROC processes of $SHARDS $DEVICE" \
     "shard(s), --im $IM"
pids=()
stop() { for p in "${pids[@]}"; do kill "$p" 2> /dev/null || true; done; }
trap stop EXIT
for ((i = 0; i < NPROC; i++)); do
    MURB_COORDINATOR="localhost:$PORT" \
    MURB_NUM_PROCESSES="$NPROC" \
    MURB_PROCESS_ID="$i" \
    python -m murb_tpu_torch -n "$N" -i "$ITERS" --im "$IM" --nv --gf \
        --scan --device "$DEVICE" --shards "$((NPROC * SHARDS))" &
    pids+=($!)
done
rc=0
for p in "${pids[@]}"; do
    if ! wait "$p"; then rc=1; stop; fi
done
trap - EXIT
exit $rc
