"""Dynamic graph store: a NumPy host mirror plus a torch device view.

Counterpart of ``gnnflow_tpu/dynamic_graph.py:78-545``.  Ingestion and
eviction sort and search through the native helper of ``ops/ingest.py``
(``csrc/ingest.cc``, the counterpart of ``gnnflow_tpu/csrc/ingest.cc``),
whatever the view's device.  Vertex ``v`` owns pool slots
``[row_off[v], row_off[v] + row_cap[v])`` holding ``row_len[v]`` edges
sorted by timestamp; a vertex whose region fills moves to a
region at the pool tail: a power of two of its edges (the default), a
multiple of ``minimum_block_size`` (``adaptive_block_size=False``) or
exactly its edges (``insertion_policy="replace"``).  Eviction
(:meth:`DynamicGraph.offload_old_blocks`) drops each vertex's edges older
than a timestamp by moving ``row_off`` forward, optionally spilling them
to a file that :meth:`DynamicGraph.restore_from_file` re-inserts;
:meth:`DynamicGraph.compact` repacks the live regions to the front of the
pool.  The host mirror is the source of truth;
:meth:`DynamicGraph.device_graph` copies it to torch tensors and keeps
that view until the mirror changes.  A store placed on the host
(``mem_resource_type`` ``host``, or its aliases ``unified``, ``pinned`` and
``shared``; ``dynamic_graph.py:97-131``) has its view on the CPU, where it
is sampled; the cache path moves its MFGs to the card.

The TPU lane tricks (the interleaved triple pool and pair table) have no
GPU meaning and are left out.  :func:`build_dynamic_graph` builds the
store from a data config (``dynamic_graph.py:547-575``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from gnnflow_tpu_torch.common import resolve_device
from gnnflow_tpu_torch.data import get_project_root_dir
from gnnflow_tpu_torch.ops import ingest


@dataclass
class DeviceGraph:
    """Device view of the store, consumed by the sampler.

    ``search_iters`` bounds the per-root binary search: the bit length of
    the largest vertex degree."""

    row_off: torch.Tensor  # [N] int32 start slot of each vertex's region
    row_len: torch.Tensor  # [N] int32 live edges in the region
    e_dst: torch.Tensor    # [C] int32 neighbour ids, ts-sorted per vertex
    e_ts: torch.Tensor     # [C] float32
    e_eid: torch.Tensor    # [C] int32
    search_iters: int = 32

    @property
    def node_capacity(self) -> int:
        return self.row_off.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_off.device

    def max_ts(self) -> float:
        """The latest edge timestamp in the view (one host sync)."""
        return float(self.e_ts.max())

    @property
    def pool_capacity(self) -> int:
        return self.e_dst.shape[0]


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def _exclusive_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    np.cumsum(x[:-1], out=out[1:])
    return out


def _ranged_arange(counts: np.ndarray) -> np.ndarray:
    """[0,1,..,c0-1, 0,1,..,c1-1, ...] for counts [c0, c1, ...]."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(_exclusive_cumsum(counts), counts))


# the reference's storage names (``gnnflow/dynamic_graph.py:53-62``) and
# the placement each gives (``dynamic_graph.py:97-102``)
STORAGE_ALIASES = {"cuda": "hbm", "unified": "host", "pinned": "host",
                   "shared": "host", "hbm": "hbm", "host": "host"}


class DynamicGraph:
    """Dynamic graph with incremental, time-ordered edge insertion.

    ``mem_resource_type`` places the device view: ``hbm`` (alias
    ``cuda``) on the card, ``host`` (aliases ``unified``, ``pinned``,
    ``shared``) on the CPU; ``placement`` holds the placement.
    A vertex whose region fills moves to a new region at the pool tail
    (``dynamic_graph.py:286-320``): with ``insertion_policy="insert"``
    (the default) and ``adaptive_block_size`` the next power of two of its
    edges, without ``adaptive_block_size`` the next multiple of
    ``minimum_block_size``, each at least ``minimum_block_size``; with
    ``"replace"`` exactly its edges, at least ``minimum_block_size`` (the
    reference's exact-fit reallocation in place).  No edge is lost either
    way.  ``blocks_to_preallocate`` grows the initial pool by that many
    minimum-size regions.  Given ``source_vertices``, ``target_vertices``
    and ``timestamps`` (and ``eids``, ``add_reverse``) the constructor
    ingests them (``:172-175``).  Evicted edges spill to ``spill_dir``
    (default ``graph_spill/`` at the repository root).  ``uploads``
    counts the device views built."""

    def __init__(self, initial_pool_size: int = 1 << 20,
                 maximum_pool_size: int = 1 << 26,
                 minimum_block_size: int = 16,
                 spill_dir: Optional[str] = None,
                 mem_resource_type: str = "hbm",
                 blocks_to_preallocate: int = 0,
                 insertion_policy: str = "insert",
                 adaptive_block_size: bool = True,
                 source_vertices: Optional[np.ndarray] = None,
                 target_vertices: Optional[np.ndarray] = None,
                 timestamps: Optional[np.ndarray] = None,
                 eids: Optional[np.ndarray] = None,
                 add_reverse: bool = False):
        placement = STORAGE_ALIASES.get(mem_resource_type.lower())
        if placement is None:
            raise ValueError(
                f"Invalid memory resource type: {mem_resource_type}")
        insertion_policy = insertion_policy.lower()
        if insertion_policy not in ("insert", "replace"):
            raise ValueError(f"Invalid insertion policy: {insertion_policy}")
        self.placement = placement
        self.insertion_policy = insertion_policy
        self.adaptive_block_size = bool(adaptive_block_size)
        self.minimum_block_size = int(max(1, minimum_block_size))
        self.maximum_pool_size = int(maximum_pool_size)
        self.spill_dir = spill_dir or os.path.join(get_project_root_dir(),
                                                   "graph_spill")

        cap = _next_pow2(max(int(initial_pool_size), 1024,
                             int(blocks_to_preallocate)
                             * self.minimum_block_size))
        self._pool_cap = cap
        self._dst = np.zeros(cap, dtype=np.int32)
        self._ts = np.zeros(cap, dtype=np.float32)
        self._eid = np.zeros(cap, dtype=np.int32)
        self._pool_used = 0

        ncap = 1024
        self._node_cap = ncap
        self._row_off = np.zeros(ncap, dtype=np.int64)
        self._row_len = np.zeros(ncap, dtype=np.int64)
        self._row_cap = np.zeros(ncap, dtype=np.int64)
        self._node_seen = np.zeros(ncap, dtype=bool)
        self._src_seen = np.zeros(ncap, dtype=bool)
        self._max_vertex_id = -1

        self._eid_seen = np.zeros(1024, dtype=bool)
        self._num_unique_eids = 0
        self._num_offloaded = 0
        self._max_degree = 0

        # the device view, rebuilt when the mirror changes (``_dirty``)
        self._device_graph: Optional[DeviceGraph] = None
        self._view_device: Optional[torch.device] = None
        self._dirty = True
        self.uploads = 0
        if source_vertices is not None and target_vertices is not None \
                and timestamps is not None:
            self.add_edges(source_vertices, target_vertices, timestamps,
                           eids, add_reverse)

    def _region_caps(self, lens: np.ndarray, policy: str) -> np.ndarray:
        """The capacity of a region for ``lens`` live edges: exact
        (``"replace"``), the next power of two (adaptive) or the next
        multiple of ``minimum_block_size``, each at least
        ``minimum_block_size`` (``dynamic_graph.py:298-313, 413-418``)."""
        mbs = self.minimum_block_size
        if policy == "replace":
            return np.maximum(lens, mbs)
        if self.adaptive_block_size:
            return np.maximum(
                mbs, 2 ** np.ceil(np.log2(np.maximum(lens, 1)))
                .astype(np.int64))
        return np.maximum(((lens + mbs - 1) // mbs) * mbs, mbs)

    # -- capacity ------------------------------------------------------

    def _ensure_node_capacity(self, max_id: int) -> None:
        if max_id < self._node_cap:
            return
        new_cap = _next_pow2(max_id + 1)
        for name in ("_row_off", "_row_len", "_row_cap",
                     "_node_seen", "_src_seen"):
            arr = getattr(self, name)
            grown = np.zeros(new_cap, dtype=arr.dtype)
            grown[: len(arr)] = arr
            setattr(self, name, grown)
        self._node_cap = new_cap

    def _ensure_pool_capacity(self, extra: int) -> None:
        need = self._pool_used + int(extra)
        if need <= self._pool_cap:
            return
        new_cap = self._pool_cap
        while new_cap < need:
            new_cap *= 2
        if new_cap > max(self.maximum_pool_size, self._pool_cap):
            raise MemoryError(
                f"edge pool would exceed maximum_pool_size "
                f"({new_cap} > {self.maximum_pool_size} edges)")
        for name in ("_dst", "_ts", "_eid"):
            arr = getattr(self, name)
            grown = np.zeros(new_cap, dtype=arr.dtype)
            grown[: len(arr)] = arr
            setattr(self, name, grown)
        self._pool_cap = new_cap

    def _ensure_eid_capacity(self, max_eid: int) -> None:
        if max_eid < len(self._eid_seen):
            return
        grown = np.zeros(_next_pow2(max_eid + 1), dtype=bool)
        grown[: len(self._eid_seen)] = self._eid_seen
        self._eid_seen = grown

    # -- insertion -----------------------------------------------------

    def add_edges(self, source_vertices: np.ndarray,
                  target_vertices: np.ndarray,
                  timestamps: np.ndarray,
                  eids: Optional[np.ndarray] = None,
                  add_reverse: bool = False) -> None:
        """Insert a batch of edges (need not be time-sorted).  eids default
        to sequential ids from ``num_edges()``; ``add_reverse`` also
        inserts every edge reversed, sharing its eid."""
        src = np.asarray(source_vertices, dtype=np.int64).ravel()
        dst = np.asarray(target_vertices, dtype=np.int64).ravel()
        ts = np.asarray(timestamps, dtype=np.float32).ravel()
        if not (len(src) == len(dst) == len(ts)):
            raise ValueError(
                "The number of source vertices, target vertices, and "
                "timestamps must be the same.")
        if len(src) == 0:
            return
        if (src < 0).any() or (dst < 0).any():
            raise ValueError("vertex ids must be non-negative")

        if eids is None:
            start = self.num_edges()
            eids = np.arange(start, start + len(src), dtype=np.int64)
        else:
            eids = np.asarray(eids, dtype=np.int64).ravel()

        if add_reverse:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
            ts = np.concatenate([ts, ts])
            eids = np.concatenate([eids, eids])

        self._ensure_eid_capacity(int(eids.max()))
        uniq_eids = np.unique(eids)
        self._num_unique_eids += int((~self._eid_seen[uniq_eids]).sum())
        self._eid_seen[uniq_eids] = True

        max_id = int(max(src.max(), dst.max()))
        self._ensure_node_capacity(max_id)
        self._max_vertex_id = max(self._max_vertex_id, max_id)
        self._node_seen[src] = True
        self._node_seen[dst] = True
        self._src_seen[src] = True

        # group by src, time-sorted within a group; stable, so equal
        # (src, ts) pairs keep arrival order
        order = ingest.group_sort_edges(src, ts)
        src, dst, ts, eids = src[order], dst[order], ts[order], eids[order]
        uniq, first_idx, counts = np.unique(
            src, return_index=True, return_counts=True)

        old_len = self._row_len[uniq]
        old_cap = self._row_cap[uniq]
        old_off = self._row_off[uniq]
        new_len = old_len + counts

        # reallocate vertices whose region is too small
        need = new_len > old_cap
        if need.any():
            vs = uniq[need]
            caps = self._region_caps(new_len[need], self.insertion_policy)
            total = int(caps.sum())
            self._ensure_pool_capacity(total)
            new_offs = self._pool_used + _exclusive_cumsum(caps)
            lens = self._row_len[vs]
            intra = _ranged_arange(lens)
            src_idx = np.repeat(self._row_off[vs], lens) + intra
            dst_idx = np.repeat(new_offs, lens) + intra
            self._dst[dst_idx] = self._dst[src_idx]
            self._ts[dst_idx] = self._ts[src_idx]
            self._eid[dst_idx] = self._eid[src_idx]
            self._row_off[vs] = new_offs
            self._row_cap[vs] = caps
            self._pool_used += total
            old_off = self._row_off[uniq]

        # append the new edges
        write_pos = np.repeat(old_off + old_len, counts) \
            + _ranged_arange(counts)
        self._dst[write_pos] = dst
        self._ts[write_pos] = ts
        self._eid[write_pos] = eids
        self._row_len[uniq] = new_len
        self._max_degree = max(self._max_degree, int(new_len.max()))

        # restore sortedness where the batch predates stored edges
        had_old = old_len > 0
        if had_old.any():
            last_old_ts = self._ts[(old_off + old_len - 1)[had_old]]
            first_new_ts = ts[first_idx[had_old]]
            for j in np.flatnonzero(had_old)[first_new_ts < last_old_ts]:
                v = uniq[j]
                ingest.resort_range(self._ts, self._dst, self._eid,
                                    int(self._row_off[v]),
                                    int(self._row_len[v]))
        self._dirty = True

    # -- eviction ------------------------------------------------------

    def offload_old_blocks(self, timestamp: float,
                           to_file: bool = False) -> int:
        """Evict every edge strictly older than ``timestamp``
        (``dynamic_graph.py:357-395``); returns the count.  A vertex's
        region shrinks from the front: ``row_off`` moves forward and
        ``row_len`` and ``row_cap`` shrink, so a vertex that fills again
        moves to the pool tail.  With ``to_file`` the evicted edges go to
        ``<spill_dir>/offload_<n>.npz`` (``src, dst, ts, eid``), ``n``
        the count of edges evicted before.  The largest degree seen (and
        so ``search_iters``) does not drop."""
        active = np.flatnonzero(self._row_len > 0)
        if len(active) == 0:
            return 0
        offs = self._row_off[active]
        lens = self._row_len[active]
        k = ingest.ranged_lower_bound(self._ts, offs, lens,
                                      np.float32(timestamp))
        total = int(k.sum())
        if total == 0:
            return 0
        if to_file:
            idx = np.repeat(offs, k) + _ranged_arange(k)
            os.makedirs(self.spill_dir, exist_ok=True)
            np.savez(os.path.join(self.spill_dir,
                                  f"offload_{self._num_offloaded}.npz"),
                     src=np.repeat(active, k), dst=self._dst[idx],
                     ts=self._ts[idx], eid=self._eid[idx])
        self._row_off[active] += k
        self._row_len[active] -= k
        self._row_cap[active] -= k
        self._num_offloaded += total
        self._dirty = True
        return total

    def restore_from_file(self, path: str) -> int:
        """Re-insert the edges of a spill file of
        :meth:`offload_old_blocks` (``dynamic_graph.py:397-405``); returns
        their count."""
        with np.load(path) as f:
            src, dst, ts, eid = f["src"], f["dst"], f["ts"], f["eid"]
        self.add_edges(src, dst, ts, eids=eid)
        return int(len(src))

    def compact(self) -> None:
        """Repack every region to the front of the pool, each at the
        power of two of its live edges (or, without
        ``adaptive_block_size``, the multiple of ``minimum_block_size``),
        at least ``minimum_block_size``, whatever the insertion policy
        (``dynamic_graph.py:407-433``), reclaiming what reallocation and
        eviction left behind."""
        active = np.flatnonzero(self._row_cap > 0)
        lens = self._row_len[active]
        caps = self._region_caps(lens, "insert")
        new_offs = _exclusive_cumsum(caps)
        intra = _ranged_arange(lens)
        src_idx = np.repeat(self._row_off[active], lens) + intra
        dst_idx = np.repeat(new_offs, lens) + intra
        for name in ("_dst", "_ts", "_eid"):
            arr = getattr(self, name)
            packed = np.zeros_like(arr)
            packed[dst_idx] = arr[src_idx]
            setattr(self, name, packed)
        self._row_off[active] = new_offs
        self._row_cap[active] = caps
        self._pool_used = int(caps.sum())
        self._dirty = True

    # -- introspection -------------------------------------------------

    def num_vertices(self) -> int:
        return int(self._node_seen.sum())

    def num_source_vertices(self) -> int:
        return int(self._src_seen.sum())

    def max_vertex_id(self) -> int:
        return self._max_vertex_id

    def num_edges(self) -> int:
        return self._num_unique_eids

    def out_degree(self, vertices: np.ndarray) -> np.ndarray:
        vertices = np.asarray(vertices, dtype=np.int64)
        deg = np.zeros(len(vertices), dtype=np.int64)
        ok = (vertices >= 0) & (vertices < self._node_cap)
        deg[ok] = self._row_len[vertices[ok]]
        return deg

    def nodes(self) -> np.ndarray:
        return np.flatnonzero(self._node_seen)

    def src_nodes(self) -> np.ndarray:
        return np.flatnonzero(self._src_seen)

    def edges(self) -> np.ndarray:
        return np.flatnonzero(self._eid_seen)

    def get_temporal_neighbors(self, vertex: int) \
            -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Neighbours of ``vertex``, newest first."""
        if vertex < 0 or vertex >= self._node_cap:
            z = np.zeros(0)
            return z.astype(np.int64), z.astype(np.float32), \
                z.astype(np.int64)
        o = int(self._row_off[vertex])
        sl = slice(o, o + int(self._row_len[vertex]))
        return (self._dst[sl][::-1].astype(np.int64),
                self._ts[sl][::-1].copy(),
                self._eid[sl][::-1].astype(np.int64))

    def avg_linked_list_length(self) -> float:
        # every vertex's history is one contiguous run
        return 1.0 if self.num_vertices() > 0 else 0.0

    def get_graph_memory_usage(self) -> int:
        itm = self._dst.itemsize + self._ts.itemsize + self._eid.itemsize
        return int(self._pool_used * itm)

    def get_metadata_memory_usage(self) -> int:
        return int(self._row_off.nbytes + self._row_len.nbytes
                   + self._row_cap.nbytes)

    # -- device view ---------------------------------------------------

    def device_graph(self, device="cuda", refresh: bool = False
                     ) -> DeviceGraph:
        """The host mirror on ``device`` as a :class:`DeviceGraph`: the
        view built by an earlier call until the mirror changes
        (``add_edges``, ``offload_old_blocks``, ``compact``,
        ``restore_from_file``), ``device`` changes or ``refresh`` is set
        (``dynamic_graph.py:506-545``).  The view is a copy, also on the
        CPU, so a later change of the mirror never shows through it.  A
        store placed on the host has its view on the CPU only: asking it
        for another device raises."""
        dev = resolve_device(device)
        if self.placement == "host" and dev.type != "cpu":
            raise ValueError(
                "this store is placed on the host (mem_resource_type="
                "'host'): its view is device_graph('cpu'), sampled on the "
                "CPU, and the cache path moves the MFGs to the card")
        if self._device_graph is not None and self._view_device == dev \
                and not (self._dirty or refresh):
            return self._device_graph

        def put(x):
            return torch.from_numpy(x).to(dev, copy=True)

        self._device_graph = DeviceGraph(
            row_off=put(self._row_off.astype(np.int32)),
            row_len=put(self._row_len.astype(np.int32)),
            e_dst=put(self._dst),
            e_ts=put(self._ts),
            e_eid=put(self._eid),
            search_iters=max(1, self._max_degree.bit_length()))
        self._view_device, self._dirty = dev, False
        self.uploads += 1
        return self._device_graph


def build_dynamic_graph(initial_pool_size: int, maximum_pool_size: int,
                        mem_resource_type: str, minimum_block_size: int,
                        insertion_policy: str, undirected: bool,
                        node_feature: bool = False,
                        edge_feature: bool = False,
                        blocks_to_preallocate: int = 0,
                        adaptive_block_size: bool = True,
                        dataset=None) -> DynamicGraph:
    """A :class:`DynamicGraph` from a data config's keys
    (:func:`gnnflow_tpu_torch.config.get_default_config`), as the JAX
    package's ``build_dynamic_graph`` (``dynamic_graph.py:547-575``):
    ``mem_resource_type`` places it (:data:`STORAGE_ALIASES`), and
    ``dataset``, an :class:`~gnnflow_tpu_torch.data.EdgeTable`, seeds it,
    each edge also reversed when ``undirected``.  The feature flags say
    which feature files a dataset has; they do not shape the store."""
    del node_feature, edge_feature
    seed = {}
    if dataset is not None:
        seed = dict(source_vertices=dataset.src,
                    target_vertices=dataset.dst,
                    timestamps=dataset.time, eids=dataset.eid)
    return DynamicGraph(initial_pool_size=initial_pool_size,
                        maximum_pool_size=maximum_pool_size,
                        minimum_block_size=minimum_block_size,
                        mem_resource_type=mem_resource_type,
                        blocks_to_preallocate=blocks_to_preallocate,
                        insertion_policy=insertion_policy,
                        adaptive_block_size=adaptive_block_size,
                        add_reverse=undirected, **seed)
