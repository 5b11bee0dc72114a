#!/bin/bash
# Multi-process partitioned training, one process per rank (counterpart
# of scripts/run_multiprocess.sh).
#
# One invocation per host, each naming its rank:
#   run_multiprocess.sh TGN REDDIT $NPROC $RANK $COORDINATOR_HOST:29741
# All ranks on this machine, each line prefixed [pI]; exits 1 if any
# rank fails:
#   run_multiprocess.sh TGN SYNTHETIC 2 all localhost:29741 [--device cpu]
# Extra flags go to every rank. $PYTHON names the interpreter (default
# python).
MODEL=${1:-TGN}
DATA=${2:-SYNTHETIC}
NPROC=${3:-2}
PROC_ID=${4:-all}
COORD=${5:-localhost:29741}
shift $(($# < 5 ? $# : 5))
cd "$(dirname "$0")/../.." || exit 1

run_one() {
  "${PYTHON:-python}" -m gnnflow_tpu_torch.scripts.offline_edge_prediction_multiprocess \
    --model "$MODEL" --data "$DATA" \
    --coordinator "$COORD" --num-processes "$NPROC" --process-id "$@"
}

if [ "$PROC_ID" = "all" ]; then
  pids=()
  for ((i = 0; i < NPROC; i++)); do
    # the subshell exits with the rank's status, not sed's
    (run_one "$i" "$@" 2>&1 | sed "s/^/[p$i] /"; exit "${PIPESTATUS[0]}") &
    pids+=($!)
  done
  status=0
  for p in "${pids[@]}"; do wait "$p" || status=1; done
  exit $status
else
  exec "${PYTHON:-python}" -m gnnflow_tpu_torch.scripts.offline_edge_prediction_multiprocess \
    --model "$MODEL" --data "$DATA" \
    --coordinator "$COORD" --num-processes "$NPROC" \
    --process-id "$PROC_ID" "$@"
fi
