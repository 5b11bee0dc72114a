"""Multi-process partitioned link-prediction training: one process per
rank, started by hand on each host.

    python -m gnnflow_tpu_torch.scripts.offline_edge_prediction_multiprocess \
        --coordinator HOST0:12345 --num-processes 2 --process-id $i

Counterpart of ``scripts/offline_edge_prediction_multiprocess.py``.
``--coordinator``, ``--num-processes`` and ``--process-id`` are the
process group's rendezvous (``tcp://`` at the coordinator), its world size
and this process's rank; a process that already runs a group joins it and
ignores them.  Every process streams the same edges through the same
deterministic partitioner (``hash`` or ``roundrobin``; the table's digest
is checked across the ranks) and ingests only the partition it owns, then
trains as :mod:`offline_edge_prediction_partitioned` does, one partition
per rank.  ``--max-steps`` cuts each epoch's train and eval batches (smoke
runs); rank 0 prints ``RESULT epoch=.. loss=.. ap=..`` after each epoch.
Memory is sharded over the ranks.

``--cache LRUCache|LFUCache|FIFOCache`` (``:159-200, 224-230, 278-297``):
the features stay in the sharded tables and reach the model through a
cache on each rank, whose misses are routed pulls (the reference's
KV-backed cache); every rank replays the whole stream into a local store,
samples each batch on the host and takes the prefetched step on the same
inputs as every other rank; rank 0 logs ``cache node hit .. edge hit ..``
after each epoch.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional

import torch
import torch.distributed as dist

from gnnflow_tpu_torch.parallel import dist_context
from gnnflow_tpu_torch.scripts.offline_edge_prediction_partitioned import (
    add_common_flags, train_partitioned)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="multi-process partitioned link-prediction training")
    add_common_flags(parser)
    parser.add_argument("--epoch", type=int, default=3)
    parser.add_argument("--coordinator", required=True,
                        help="HOST:PORT of rank 0's rendezvous")
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--partition-strategy", default="hash",
                        choices=["hash", "roundrobin"],
                        help="deterministic and state-free, so every "
                             "process derives the same table")
    parser.add_argument("--cache", default=None,
                        choices=["LRUCache", "LFUCache", "FIFOCache"],
                        help="features stay in the sharded tables and "
                             "reach the model through a cache whose misses "
                             "are routed pulls")
    parser.add_argument("--edge-cache-ratio", type=float, default=0.2)
    parser.add_argument("--node-cache-ratio", type=float, default=0.2)
    parser.add_argument("--synthetic-edges", type=int, default=50_000)
    parser.add_argument("--max-steps", type=int, default=0,
                        help="cut each epoch's train and eval batches")
    return parser


def main(argv=None) -> Optional[dict]:
    """Run the script; returns
    :func:`~gnnflow_tpu_torch.scripts.offline_edge_prediction_partitioned.
    train_partitioned`'s dict."""
    parser = make_parser()
    args = parser.parse_args(argv)
    joined = dist.is_initialized()
    ctx = dist_context.initialize(
        args.process_id, args.num_processes, args.device,
        None if joined else f"tcp://{args.coordinator}")
    if ctx.world_size != args.num_processes \
            or ctx.device.type != torch.device(args.device).type:
        parser.error(f"--num-processes {args.num_processes} --device "
                     f"{args.device} in a group of {ctx.world_size} ranks "
                     f"on {ctx.device.type}")
    logging.basicConfig(
        level=logging.INFO if ctx.rank == 0 else logging.WARNING,
        format=f"%(asctime)s p{ctx.rank} %(levelname)s %(message)s")
    logging.info("process %d of %d on %s", ctx.rank, ctx.world_size,
                 ctx.device)
    out = train_partitioned(args, ctx, ctx.world_size, args.synthetic_edges,
                            max_steps=args.max_steps, check_uniform=True,
                            result_lines=True)
    if not joined:
        dist_context.shutdown()
    return out


if __name__ == "__main__":
    main()
