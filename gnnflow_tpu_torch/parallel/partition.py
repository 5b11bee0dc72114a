"""Streaming vertex partitioners.

Counterpart of ``gnnflow_tpu/parallel/partition.py``, the same NumPy code
with the same assignments: vertex partitioning (edges follow their
source's partition; an int8 table with ``UNASSIGNED = -1``; the optional
``assign_with_dst_node`` mode of the neighbours' partitions), the hash
(splitmix64, process-independent), round-robin, least-loaded (edge count,
timestamp sum, timestamp average), Fennel, Fennel-edge and static
strategies, ``get_partitioner`` and ``partition_metrics``.  Inside a
partition the edges keep the JAX order: the chunk's edges whose source was
assigned, then the unseen ones, so a partition's store ingests them in the
same order and recent sampling breaks timestamp ties the same way.  The
port keeps its own copy, as it imports nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

UNASSIGNED = -1


def _hash_vertices(vertices, num_partitions: int) -> np.ndarray:
    """Deterministic vertex-id hash (splitmix64 finalizer).

    The reference uses Python's salted ``hash(str(v))``
    (``partition.py:312-326``), which differs across processes; partition
    tables here may be persisted (``gen_partition_table.py``) and reloaded
    elsewhere, so the hash must be process-independent."""
    with np.errstate(over="ignore"):
        x = np.asarray(vertices, dtype=np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(num_partitions)).astype(np.int8)


@dataclass
class Partition:
    """One partition's edge set (``partition.py:10-18``)."""

    src_nodes: np.ndarray
    dst_nodes: np.ndarray
    timestamps: np.ndarray
    eids: np.ndarray

    def __len__(self):
        return len(self.src_nodes)


def _concat(a: Partition, b: Partition) -> Partition:
    return Partition(np.concatenate([a.src_nodes, b.src_nodes]),
                     np.concatenate([a.dst_nodes, b.dst_nodes]),
                     np.concatenate([a.timestamps, b.timestamps]),
                     np.concatenate([a.eids, b.eids]))


class Partitioner:
    """Base vertex partitioner."""

    def __init__(self, num_partitions: int, local_world_size: int = 1,
                 assign_with_dst_node: bool = False,
                 partition_table: Optional[np.ndarray] = None):
        self._num_partitions = num_partitions
        self._local_world_size = local_world_size
        self._assign_with_dst_node = assign_with_dst_node
        self._partition_table = (
            np.asarray(partition_table, dtype=np.int8)
            if partition_table is not None
            else np.zeros(0, dtype=np.int8))
        self._part_sizes = np.zeros(num_partitions, dtype=np.int64)
        if partition_table is not None:
            for i in range(num_partitions):
                self._part_sizes[i] = int(
                    (self._partition_table == i).sum())

    def get_num_partitions(self) -> int:
        return self._num_partitions

    def get_partition_table(self) -> np.ndarray:
        return self._partition_table

    def _resize(self, max_node: int) -> None:
        if max_node < len(self._partition_table):
            return
        grown = np.full(max_node + 1, UNASSIGNED, dtype=np.int8)
        grown[: len(self._partition_table)] = self._partition_table
        self._partition_table = grown

    def _set(self, nodes: np.ndarray, pid) -> None:
        """Assign nodes to a partition, maintaining size counters."""
        prev = self._partition_table[nodes]
        self._partition_table[nodes] = pid
        # only newly assigned nodes increase partition sizes
        fresh = prev == UNASSIGNED
        if np.isscalar(pid) or getattr(pid, "ndim", 0) == 0:
            self._part_sizes[int(pid)] += int(fresh.sum())
        else:
            np.add.at(self._part_sizes, np.asarray(pid)[fresh], 1)

    def partition(self, src_nodes: np.ndarray, dst_nodes: np.ndarray,
                  timestamps: np.ndarray, eids: np.ndarray,
                  return_evenly_dataset: bool = False
                  ) -> Tuple[List[Partition], Optional[list]]:
        """Assign a chunk of edges; returns per-partition edge sets (and
        optionally the evenly-rebalanced per-worker datasets)."""
        src_nodes = np.asarray(src_nodes, dtype=np.int64)
        dst_nodes = np.asarray(dst_nodes, dtype=np.int64)
        timestamps = np.asarray(timestamps, dtype=np.float32)
        eids = np.asarray(eids, dtype=np.int64)
        max_node = int(max(src_nodes.max(), dst_nodes.max()))
        self._resize(max_node)
        self._on_chunk(src_nodes, dst_nodes)

        if self._assign_with_dst_node:
            # assign unseen srcs to the mode of their dsts' partitions
            # (partition.py:96-132)
            unassigned = self._partition_table[src_nodes] == UNASSIGNED
            for s in np.unique(src_nodes[unassigned]):
                dp = self._partition_table[dst_nodes[src_nodes == s]]
                dp = dp[dp >= 0]
                if len(dp):
                    vals, cnts = np.unique(dp, return_counts=True)
                    self._set(np.array([s]), int(vals[np.argmax(cnts)]))

        unassigned = self._partition_table[src_nodes] == UNASSIGNED

        partitions = []
        for i in range(self._num_partitions):
            m = self._partition_table[src_nodes] == i
            partitions.append(Partition(src_nodes[m], dst_nodes[m],
                                        timestamps[m], eids[m]))

        if unassigned.any():
            pt_unseen = self._partition_unseen(
                src_nodes[unassigned], dst_nodes[unassigned],
                timestamps[unassigned], eids[unassigned])
            for i in range(self._num_partitions):
                m = pt_unseen == i
                self._set(src_nodes[unassigned][m], i)
                partitions[i] = _concat(partitions[i], Partition(
                    src_nodes[unassigned][m], dst_nodes[unassigned][m],
                    timestamps[unassigned][m], eids[unassigned][m]))

        evenly = None
        if return_evenly_dataset:
            evenly = self._make_partitions_evenly(partitions)
        return partitions, evenly

    # -- hooks ----------------------------------------------------------

    def _on_chunk(self, src_nodes, dst_nodes) -> None:
        pass

    def _partition_unseen(self, src_nodes, dst_nodes, timestamps, eids
                          ) -> np.ndarray:
        """Partition ids for edges whose src was never seen.  Groups by
        src (``partition.py:281-303``) and delegates per-vertex."""
        order = np.argsort(src_nodes, kind="stable")
        uniq, starts, counts = np.unique(
            src_nodes[order], return_index=True, return_counts=True)
        groups = [order[s: s + c] for s, c in zip(starts, counts)]
        per_vertex = self._assign_vertices(
            uniq, [dst_nodes[g] for g in groups],
            [timestamps[g] for g in groups])
        out = np.zeros(len(src_nodes), dtype=np.int8)
        for pid, g in zip(per_vertex, groups):
            out[g] = pid
        return out

    def _assign_vertices(self, vertices, dst_lists, ts_lists) -> np.ndarray:
        raise NotImplementedError

    # -- rebalance (partition.py:173-260) -------------------------------

    def _make_partitions_evenly(self, partitions: List[Partition]):
        total = sum(len(p) for p in partitions)
        avg = total // self._num_partitions
        order = np.argsort([len(p) for p in partitions], kind="stable")
        sp = [partitions[i] for i in order]
        # cascade surplus from the largest down
        for i in reversed(range(1, self._num_partitions)):
            sp[i - 1] = _concat(sp[i - 1], Partition(
                sp[i].src_nodes[avg:], sp[i].dst_nodes[avg:],
                sp[i].timestamps[avg:], sp[i].eids[avg:]))
            sp[i] = Partition(sp[i].src_nodes[:avg], sp[i].dst_nodes[:avg],
                              sp[i].timestamps[:avg], sp[i].eids[:avg])
        sp[0] = Partition(sp[0].src_nodes[:avg], sp[0].dst_nodes[:avg],
                          sp[0].timestamps[:avg], sp[0].eids[:avg])
        restored = [None] * self._num_partitions
        for i, oi in enumerate(order):
            restored[oi] = sp[i]
        # interleave each partition across local workers
        out = []
        for p in restored:
            n = len(p) - (len(p) % self._local_world_size)
            workers = []
            for j in range(self._local_world_size):
                workers.append(Partition(
                    p.src_nodes[:n][j::self._local_world_size],
                    p.dst_nodes[:n][j::self._local_world_size],
                    p.timestamps[:n][j::self._local_world_size],
                    p.eids[:n][j::self._local_world_size]))
            out.append(workers)
        return out


class HashPartitioner(Partitioner):
    """Hash of the vertex id (``partition.py:312-326``)."""

    def _assign_vertices(self, vertices, dst_lists, ts_lists):
        return _hash_vertices(vertices, self._num_partitions)


class RoundRobinPartitioner(Partitioner):
    """Round-robin over unseen vertices (``partition.py:328-340``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._next = 0

    def _assign_vertices(self, vertices, dst_lists, ts_lists):
        out = (self._next + np.arange(len(vertices))) \
            % self._num_partitions
        self._next = int((self._next + len(vertices))
                         % self._num_partitions)
        return out.astype(np.int8)


class LeastLoadedPartitioner(Partitioner):
    """Greedy least-loaded assignment (``partition.py:342-416``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._metrics = np.zeros(self._num_partitions, dtype=np.float64)

    def _assign_vertices(self, vertices, dst_lists, ts_lists):
        out = np.zeros(len(vertices), dtype=np.int8)
        for i in range(len(vertices)):
            pid = int(np.argmin(self._metrics))
            out[i] = pid
            self._metrics[pid] += self._metric(dst_lists[i], ts_lists[i])
        return out

    def _metric(self, dsts, tss) -> float:
        raise NotImplementedError


class LeastLoadedPartitionerByEdgeCount(LeastLoadedPartitioner):
    def _metric(self, dsts, tss):
        return float(len(dsts))


class LeastLoadedPartitionerByTimestampSum(LeastLoadedPartitioner):
    def _metric(self, dsts, tss):
        return float(tss.sum())


class LeastLoadedPartitionerByTimestampAvg(LeastLoadedPartitioner):
    """Running-average timestamp load (``partition.py:389-416``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._counts = np.zeros(self._num_partitions, dtype=np.int64)

    def _assign_vertices(self, vertices, dst_lists, ts_lists):
        out = np.zeros(len(vertices), dtype=np.int8)
        for i in range(len(vertices)):
            pid = int(np.argmin(self._metrics))
            out[i] = pid
            k = len(dst_lists[i])
            tot = self._counts[pid] + k
            if tot > 0:
                self._metrics[pid] += (float(ts_lists[i].sum())
                                       - self._metrics[pid] * k) / tot
            self._counts[pid] += k
        return out


class FennelPartitioner(Partitioner):
    """Streaming Fennel/LDG (``partition.py:420-538``): score =
    |neighbors in partition| - alpha*gamma*size^(gamma-1), with a hard
    capacity ``upsilon * max_node / num_partitions``."""

    def __init__(self, *args, upsilon: float = 1.1, gamma: float = 1.5,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self._upsilon = upsilon
        self._gamma = gamma
        self._edges_partitioned = 0

    def _on_chunk(self, src_nodes, dst_nodes) -> None:
        self._edges_partitioned += len(src_nodes)

    def _assign_vertices(self, vertices, dst_lists, ts_lists):
        max_node = len(self._partition_table) - 1
        capacity = max_node * self._upsilon / self._num_partitions
        alpha = (self._num_partitions ** 0.5) * self._edges_partitioned \
            / max(max_node, 1) ** 1.5
        out = np.zeros(len(vertices), dtype=np.int8)
        for i, v in enumerate(vertices):
            local = self._partition_table[dst_lists[i]]
            nbr_counts = np.bincount(local[local >= 0],
                                     minlength=self._num_partitions)
            sizes = self._part_sizes.astype(np.float64)
            score = nbr_counts - alpha * self._gamma \
                * sizes ** (self._gamma - 1)
            score[sizes >= capacity] = -1
            pid = int(np.argmax(score))
            out[i] = pid
            self._set(np.array([int(v)]), pid)
        return out


class FennelEdgePartitioner(Partitioner):
    """The reference's custom Fennel variant (``partition.py:541-735``):
    locality = |neighbors in partition| + sum of their out-degrees;
    penalty = partition's edge count; hard cap at 1.25x average load;
    vertices visited in ascending neighborhood size."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self._out_degree = np.zeros(0, dtype=np.int64)
        self._edges_partitioned = 0
        self._edge_counts = np.zeros(self._num_partitions, dtype=np.int64)
        self._rng = np.random.RandomState(seed)

    def _resize(self, max_node: int) -> None:
        super()._resize(max_node)
        if max_node >= len(self._out_degree):
            grown = np.zeros(max_node + 1, dtype=np.int64)
            grown[: len(self._out_degree)] = self._out_degree
            self._out_degree = grown

    def _on_chunk(self, src_nodes, dst_nodes) -> None:
        self._edges_partitioned += len(src_nodes)
        assigned = self._partition_table[src_nodes] >= 0
        if assigned.any():
            uniq, cnt = np.unique(src_nodes[assigned], return_counts=True)
            self._out_degree[uniq] += cnt
            pids = self._partition_table[src_nodes[assigned]]
            np.add.at(self._edge_counts, pids, 1)

    def _partition_unseen(self, src_nodes, dst_nodes, timestamps, eids):
        order = np.argsort(src_nodes, kind="stable")
        uniq, starts, counts = np.unique(
            src_nodes[order], return_index=True, return_counts=True)
        groups = [order[s: s + c] for s, c in zip(starts, counts)]
        out = np.zeros(len(src_nodes), dtype=np.int8)
        # ascending neighborhood size (partition.py:713-722)
        visit = np.argsort([len(g) for g in groups], kind="stable")
        for gi in visit:
            v = int(uniq[gi])
            dsts = dst_nodes[groups[gi]]
            pid = self._fennel_edge(dsts)
            out[groups[gi]] = pid
            self._set(np.array([v]), pid)
            self._out_degree[v] += len(dsts)
            self._edge_counts[pid] += len(dsts)
        return out

    def _fennel_edge(self, dsts) -> int:
        local = self._partition_table[dsts]
        nbr_counts = np.bincount(local[local >= 0],
                                 minlength=self._num_partitions)
        scores = np.full(self._num_partitions, -np.inf)
        cap = 1.25 * self._edges_partitioned / self._num_partitions
        for i in range(self._num_partitions):
            if self._edge_counts[i] + len(dsts) > cap:
                continue
            in_part = np.unique(dsts[local == i])
            od = self._out_degree[in_part].sum() if len(in_part) else 0
            scores[i] = nbr_counts[i] + od - self._edge_counts[i]
        if not np.isfinite(scores).any():
            return int(np.argmin(self._edge_counts))
        best = np.flatnonzero(scores == scores.max())
        return int(self._rng.choice(best))

    def _assign_vertices(self, vertices, dst_lists, ts_lists):
        raise AssertionError("unused; _partition_unseen overridden")


class StaticPartitioner(Partitioner):
    """Preloaded (e.g. METIS) partition table (``partition.py:51-53``,
    generated offline as in ``scripts/gen_init_pt.py``); unseen vertices
    fall back to hash."""

    def _assign_vertices(self, vertices, dst_lists, ts_lists):
        return _hash_vertices(vertices, self._num_partitions)


def get_partitioner(partition_strategy: str, num_partitions: int,
                    local_world_size: int = 1,
                    assign_with_dst_node: bool = False,
                    partition_table: Optional[np.ndarray] = None):
    """Factory (``partition.py:738-768``)."""
    strategies = {
        "hash": HashPartitioner,
        "roundrobin": RoundRobinPartitioner,
        "edgecount": LeastLoadedPartitionerByEdgeCount,
        "timestampsum": LeastLoadedPartitionerByTimestampSum,
        "timestampavg": LeastLoadedPartitionerByTimestampAvg,
        "fennel": FennelPartitioner,
        "fennel_edge": FennelEdgePartitioner,
        "static": StaticPartitioner,
        "metis": StaticPartitioner,
    }
    if partition_strategy not in strategies:
        raise ValueError(f"Unknown strategy: {partition_strategy}")
    return strategies[partition_strategy](
        num_partitions, local_world_size, assign_with_dst_node,
        partition_table)


def partition_metrics(partitioner: Partitioner,
                      src_nodes: np.ndarray, dst_nodes: np.ndarray):
    """Load factor and edge-cut of the current table (the quality metrics
    of ``benchmarks/benchmark_partitioner.py:58-100``)."""
    pt = partitioner.get_partition_table()
    counts = np.bincount(pt[src_nodes][pt[src_nodes] >= 0],
                         minlength=partitioner.get_num_partitions())
    load_factor = counts.max() / max(counts.mean(), 1e-9)
    sp = pt[src_nodes]
    dp = pt[dst_nodes]
    both = (sp >= 0) & (dp >= 0)
    edge_cut = float((sp[both] != dp[both]).mean()) if both.any() else 0.0
    return {"load_factor": float(load_factor), "edge_cut": edge_cut,
            "partition_sizes": counts.tolist()}
