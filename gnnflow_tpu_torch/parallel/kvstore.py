"""Feature tables and node memory sharded over the ranks of a process
group.

Counterpart of ``gnnflow_tpu/parallel/kvstore.py:40-120``.  The JAX table
is one row-sharded array whose gathers GSPMD partitions; here each rank
holds one contiguous block of rows on its device, and a pull or a push
routes the ids to the ranks that hold them with ``all_to_all_single``
(:class:`~gnnflow_tpu_torch.parallel.dist_context.Route`), the
``KVStoreClient`` vocabulary of the reference.  Pulls and pushes are
collective: every rank of the group makes the same calls in the same
order, with any number of ids, none included.
:func:`shard_memory_state` splits a TGN or APAN memory state the same way
(the reference's partitioned memory, ``kvstore.py:159-177``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gnnflow_tpu_torch.models.memory import MemoryShard, MemoryState
from gnnflow_tpu_torch.parallel.dist_context import (Route, all_gather_cat,
                                                     group_rank, group_size)


def _rows_per_rank(num_rows: int, world_size: int) -> int:
    return -(-num_rows // world_size)


class ShardedTable:
    """A ``[N, dim]`` table split into ``W`` contiguous row blocks, padded
    with zero rows to a multiple of ``W`` (``kvstore.py:48-56``); rank r
    holds block r on ``device``.  ``data`` is the whole table, the same on
    every rank; :meth:`from_block` builds a rank's share from its block
    alone."""

    def __init__(self, data: np.ndarray, group=None, device="cpu"):
        data = np.asarray(data)
        rows = _rows_per_rank(data.shape[0], group_size(group))
        lo = group_rank(group) * rows
        block = np.zeros((rows, data.shape[1]), data.dtype)
        part = data[lo: lo + rows]
        block[: len(part)] = part
        self._place(block, data.shape[0], group, device)

    @classmethod
    def from_block(cls, block: np.ndarray, num_rows: int, group=None,
                   device="cpu") -> "ShardedTable":
        """This rank's share of an ``[num_rows, dim]`` table from its block
        of ``ceil(num_rows / W)`` rows (zero rows past the table)."""
        table = cls.__new__(cls)
        table._place(np.asarray(block), num_rows, group, device)
        return table

    def _place(self, block: np.ndarray, num_rows: int, group,
               device) -> None:
        self.group = group
        self.world_size = group_size(group)
        self.rank = group_rank(group)
        self.num_rows = int(num_rows)
        self.dim = block.shape[1]
        self.rows_per_rank = _rows_per_rank(self.num_rows, self.world_size)
        if block.shape[0] != self.rows_per_rank:
            raise ValueError(f"a block of {block.shape[0]} rows for "
                             f"{self.num_rows} rows over {self.world_size} "
                             f"ranks ({self.rows_per_rank} each)")
        self.padded_rows = self.rows_per_rank * self.world_size
        self.local = torch.from_numpy(block).to(device)

    @property
    def shape(self):
        """``(num_rows, dim)`` of the whole table."""
        return (self.num_rows, self.dim)

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


def shard_memory_state(state: MemoryState, group=None) -> MemoryState:
    """Re-place a replicated :class:`~gnnflow_tpu_torch.models.memory.
    MemoryState` (the same on every rank) so that rank r holds rows
    ``[r·R, (r+1)·R)``, ``R = ceil(N / W)``, zero-padded as
    :class:`ShardedTable` is: ``mem``, ``mem_ts``, ``mail``, ``mail_ts``
    and, with S slots, every slot and the cursor (``kvstore.py:107-120``).
    A state that is sharded already is returned as it is."""
    if state.shard is not None:
        return state
    world, rank = group_size(group), group_rank(group)
    n = state.num_nodes
    rpr = _rows_per_rank(n, world)
    lo = rank * rpr
    blocks = {}
    for name, t in state.tensors().items():
        block = t.new_zeros((rpr,) + tuple(t.shape[1:]))
        part = t[lo: lo + rpr]
        block[: part.shape[0]] = part
        blocks[name] = block
    return MemoryState(**blocks, shard=MemoryShard(group, rank, world, rpr,
                                                   n))


def unshard_memory(state: MemoryState) -> MemoryState:
    """The whole state on every rank from a sharded one (an all-gather of
    each tensor; a collective)."""
    if state.shard is None:
        return state
    n, group = state.shard.num_nodes, state.shard.group
    return MemoryState(**{name: all_gather_cat(t, group)[:n]
                          for name, t in state.tensors().items()})
