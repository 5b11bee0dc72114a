#!/bin/bash
# Partitioned training over the cards of one machine (counterpart of
# scripts/run_partitioned.sh): the script spawns one rank per device.
# Usage: run_partitioned.sh <MODEL> <DATA> [NDEV] [script flags...]
#   NDEV defaults to the script's own: every card of this machine (1 with
#   --device cpu); e.g.
#   run_partitioned.sh TGAT SYNTHETIC 2 --num-partitions 4 --device cpu
# $PYTHON names the interpreter (default python).
MODEL=${1:-TGN}
DATA=${2:-SYNTHETIC}
NDEV=$3
shift $(($# < 3 ? $# : 3))
cd "$(dirname "$0")/../.." || exit 1
exec "${PYTHON:-python}" -m gnnflow_tpu_torch.scripts.offline_edge_prediction_partitioned \
  --model "$MODEL" --data "$DATA" ${NDEV:+--num-devices "$NDEV"} "$@"
