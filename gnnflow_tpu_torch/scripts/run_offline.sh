#!/bin/bash
# Offline training on one card (counterpart of scripts/run_offline.sh).
# Usage: run_offline.sh <MODEL> <DATA> [script flags...]
#   e.g. run_offline.sh TGN REDDIT --epoch 10
#        run_offline.sh TGN SYNTHETIC --device cpu
# Runs python -m gnnflow_tpu_torch.scripts.offline_edge_prediction from
# the repository root; the card unless --device cpu. $PYTHON names the
# interpreter (default python).
MODEL=${1:-TGN}
DATA=${2:-SYNTHETIC}
shift $(($# < 2 ? $# : 2))
cd "$(dirname "$0")/../.." || exit 1
exec "${PYTHON:-python}" -m gnnflow_tpu_torch.scripts.offline_edge_prediction \
  --model "$MODEL" --data "$DATA" "$@"
