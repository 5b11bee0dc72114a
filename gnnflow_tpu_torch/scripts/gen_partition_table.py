"""Offline partition-table generation.

    python -m gnnflow_tpu_torch.scripts.gen_partition_table \
        --data SYNTHETIC --num-partitions 4 --strategy fennel

Counterpart of ``scripts/gen_partition_table.py:23-62``: streams the first
``--ratio`` of the edges through a partitioner (Fennel by default, which
also lowers the edge cut) in chunks of ``--chunk``, prints the load factor
and edge cut, and saves the vertex-to-partition table as
``<out-dir>/<dataset>_<strategy>_partition.npz`` (default ``out-dir``:
``partition_data/`` at the repository root), the same file as the JAX
script's, which ``get_partitioner(..., partition_table=...)`` and the
``metis`` strategy load.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from gnnflow_tpu_torch.data import load_dataset, make_synthetic_dataset
from gnnflow_tpu_torch.parallel.partition import (get_partitioner,
                                                  partition_metrics)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="partition-table "
                                                 "generation")
    parser.add_argument("--data", default="SYNTHETIC")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--num-partitions", type=int, default=4)
    parser.add_argument("--strategy", default="fennel")
    parser.add_argument("--ratio", type=float, default=0.6,
                        help="fraction of the stream used (the reference "
                             "uses the first 60%%)")
    parser.add_argument("--chunk", type=int, default=100_000)
    parser.add_argument("--out-dir", default=None)
    return parser


def main(argv=None) -> str:
    """Write the table; returns the file's path."""
    args = make_parser().parse_args(argv)
    if args.data == "SYNTHETIC":
        _, _, _, full, _, _ = make_synthetic_dataset(
            num_src=2000, num_dst=500, num_edges=100_000, dim_edge=0)
    else:
        _, _, _, full = load_dataset(args.data, args.data_dir)
    n = int(len(full) * args.ratio)
    part = get_partitioner(args.strategy, args.num_partitions)
    for lo in range(0, n, args.chunk):
        sl = slice(lo, min(lo + args.chunk, n))
        part.partition(full.src[sl], full.dst[sl], full.time[sl],
                       full.eid[sl])
    m = partition_metrics(part, full.src[:n], full.dst[:n])
    print(f"strategy={args.strategy} partitions={args.num_partitions} "
          f"load_factor={m['load_factor']:.3f} "
          f"edge_cut={m['edge_cut'] * 100:.1f}%")
    out_dir = args.out_dir or os.path.join(ROOT, "partition_data")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{args.data.lower()}_{args.strategy}_partition.npz")
    np.savez(path, partition_table=part.get_partition_table())
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
