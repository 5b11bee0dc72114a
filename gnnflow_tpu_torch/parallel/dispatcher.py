"""Dataset dispatch into the partitioned store.

Counterpart of ``gnnflow_tpu/parallel/dispatcher.py:31-72``: the stream's
chunks go through the partitioner into the partitions' stores (with the
reversed edges where the data config is undirected), the feature tables
become sharded tables, and the train split is cut by ``ext_roll``.  Every
rank streams the same edges through its own deterministic partitioner and
ingests only the partitions it owns.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from gnnflow_tpu_torch.data import EdgeTable
from gnnflow_tpu_torch.parallel.dist_graph import PartitionedDynamicGraph
from gnnflow_tpu_torch.parallel.kvstore import ShardedFeatureStore
from gnnflow_tpu_torch.parallel.partition import Partitioner


def dispatch_full_dataset(
        full_data: EdgeTable, ext_roll: Optional[np.ndarray],
        partitioner: Partitioner, pgraph: PartitionedDynamicGraph,
        node_feats: Optional[np.ndarray] = None,
        edge_feats: Optional[np.ndarray] = None,
        ingestion_batch_size: int = 100_000, undirected: bool = False,
        device="cpu") -> Tuple[EdgeTable, ShardedFeatureStore]:
    """Stream ``full_data`` through ``partitioner`` into ``pgraph``; returns
    ``(train split, ShardedFeatureStore on device)``.  ``ext_roll`` marks
    train (0), val (1) and test (2) rows; every edge is ingested."""
    n = len(full_data)
    for lo in range(0, n, ingestion_batch_size):
        chunk = full_data[lo: lo + ingestion_batch_size]
        src, dst, ts, eid = chunk.src, chunk.dst, chunk.time, chunk.eid
        if undirected:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
            ts = np.concatenate([ts, ts])
            eid = np.concatenate([eid, eid])
        partitions, _ = partitioner.partition(src, dst, ts, eid)
        pgraph.add_partitioned_edges(partitions)
    pgraph.set_partition_table(partitioner.get_partition_table())
    logging.info("dispatched %d edges into %d partitions (sizes of this "
                 "rank's: %s)", n, partitioner.get_num_partitions(),
                 [pgraph.locals[p].num_edges() for p in pgraph.owned])
    store = ShardedFeatureStore(node_feats, edge_feats, pgraph.group, device)
    train = full_data
    if ext_roll is not None:
        train = full_data[:int(np.searchsorted(ext_roll, 1))]
    return train, store
