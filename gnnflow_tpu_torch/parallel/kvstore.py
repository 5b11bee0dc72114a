"""Feature tables sharded over the ranks of a process group.

Counterpart of ``gnnflow_tpu/parallel/kvstore.py:40-104``.  The JAX table
is one row-sharded array whose gathers GSPMD partitions; here each rank
holds one contiguous block of rows on its device, and a pull or a push
routes the ids to the ranks that hold them with ``all_to_all_single``
(:class:`~gnnflow_tpu_torch.parallel.dist_context.Route`), the
``KVStoreClient`` vocabulary of the reference.  Pulls and pushes are
collective: every rank of the group makes the same calls in the same
order, with any number of ids, none included.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gnnflow_tpu_torch.parallel.dist_context import (Route, group_rank,
                                                     group_size)


class ShardedTable:
    """A ``[N, dim]`` table split into ``W`` contiguous row blocks, padded
    with zero rows to a multiple of ``W`` (``kvstore.py:48-56``); rank r
    holds block r on ``device``.  ``data`` is the whole table, the same on
    every rank."""

    def __init__(self, data: np.ndarray, group=None, device="cpu"):
        data = np.asarray(data)
        self.group = group
        self.world_size = group_size(group)
        self.rank = group_rank(group)
        self.num_rows = data.shape[0]
        self.dim = data.shape[1]
        self.rows_per_rank = -(-self.num_rows // self.world_size)
        self.padded_rows = self.rows_per_rank * self.world_size
        lo = self.rank * self.rows_per_rank
        block = np.zeros((self.rows_per_rank, self.dim), data.dtype)
        part = data[lo: lo + self.rows_per_rank]
        block[: len(part)] = part
        self.local = torch.from_numpy(block).to(device)

    def pull(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``[n, dim]`` of the ids ``[n]``, each clipped into the
        padded table (``kvstore.py:60``)."""
        ids = ids.reshape(-1).long().clamp(0, self.padded_rows - 1) \
            .to(self.local.device)
        route = Route(ids // self.rows_per_rank, self.group)
        got = route.send(ids)
        rows = self.local[got - self.rank * self.rows_per_rank]
        return route.back(rows)

    def push(self, ids: torch.Tensor, rows: torch.Tensor) -> None:
        """Write ``rows`` [n, dim] at ``ids`` [n]; ids below 0 or past the
        padded table are dropped (``kvstore.py:63-70``)."""
        ids = ids.reshape(-1).long().to(self.local.device)
        keep = (ids >= 0) & (ids < self.padded_rows)
        dest = torch.where(keep, ids // self.rows_per_rank,
                           self.world_size)
        route = Route(dest, self.group)
        got_ids = route.send(ids)
        got_rows = route.send(rows.to(self.local))
        self.local[got_ids - self.rank * self.rows_per_rank] = got_rows

    def memory_usage(self) -> int:
        """Bytes of the whole padded table over the ranks."""
        return int(self.padded_rows * self.dim * self.local.element_size())


class ShardedFeatureStore:
    """The node and edge feature tables as :class:`ShardedTable` s (None
    where the stream has none)."""

    def __init__(self, node_feats: Optional[np.ndarray] = None,
                 edge_feats: Optional[np.ndarray] = None, group=None,
                 device="cpu"):
        self.node_table = (ShardedTable(node_feats, group, device)
                           if node_feats is not None else None)
        self.edge_table = (ShardedTable(edge_feats, group, device)
                           if edge_feats is not None else None)

    def memory_usage(self) -> Dict[str, int]:
        return {"node": self.node_table.memory_usage()
                if self.node_table else 0,
                "edge": self.edge_table.memory_usage()
                if self.edge_table else 0}
