"""The partitioned graph store and distributed temporal sampling.

Counterpart of ``gnnflow_tpu/parallel/dist_graph.py``.  The JAX store is
stacked ``[P, ...]`` arrays sharded over a mesh axis, sampled inside one
SPMD program; here each rank of a process group holds a
:class:`~gnnflow_tpu_torch.dynamic_graph.DynamicGraph` per partition it
owns (:func:`~gnnflow_tpu_torch.parallel.dist_context.owned_partitions`:
``P / W`` contiguous ones, all of them at one rank) and the partition
table.  Edges follow their source's partition, so a root's whole history
lies in its owner's store; unassigned vertices (table entry -1, and ids
past the table) are owned by no partition and give fully masked rows
(``:20-21``).

A layer is sampled two ways, each collective over the group:

- **routed** (:func:`sample_layer_routed`, ``:308-545``): a stable sort
  of the rank's roots by owner rank, one exchange of the counts, then
  ``all_to_all_single`` with the real split sizes carries the roots, their
  timestamps and, under uniform sampling, their draws to the owners; each
  owner samples the roots it received in one pass over one view of its
  partitions (their pools one after the other, each vertex's run from the
  partition that owns it), and the rows return the same way and are put
  back in the roots' order.  The split
  sizes are exact, so no bucket overflows: JAX's capacity factor, its
  overflow side pass and its fallback exist for XLA's static shapes only
  (ROADMAP.md, "Not ported: TPU layout only").
- **replicated** (:func:`sample_layer_replicated`, ``:227-296``): every
  rank gathers all ranks' roots and samples them against that view with
  the roots of other ranks' partitions masked; a ``reduce_scatter``
  (sum) merges the rows in JAX's encoding, ``nid + 1`` and 0 where masked,
  since exactly one partition owns a root (``:267-280``).

Either gives the single store's MFGs bit for bit.  Snapshots route one at
a time, as JAX's do.  A rank with no roots still joins every exchange.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gnnflow_tpu_torch.common import INVALID_NID, MFG, STATIC_TS
from gnnflow_tpu_torch.dynamic_graph import DeviceGraph, DynamicGraph
from gnnflow_tpu_torch.ops.sampling import sample_layer
from gnnflow_tpu_torch.parallel.dist_context import (Route, all_gather_cat,
                                                     group_device, group_rank,
                                                     group_size,
                                                     owned_partitions)

@dataclass
class PartitionedDeviceGraph:
    """This rank's device view: its partitions' stores as one
    :class:`DeviceGraph` (``owned``: the pools one after the other, and
    each vertex's run in the partition that owns it; vertices of other
    ranks' partitions have none), the partition table ``[N]`` (int64, -1
    unassigned) on the device, the group, and the latest edge timestamp
    over all partitions of all ranks."""

    owned: DeviceGraph
    partition_table: torch.Tensor
    num_partitions: int
    world_size: int
    group: Optional[dist.ProcessGroup] = None
    latest_ts: float = 0.0
    _per_rank: int = field(init=False)

    def __post_init__(self):
        self._per_rank = self.num_partitions // self.world_size

    @property
    def device(self) -> torch.device:
        return self.partition_table.device

    def max_ts(self) -> float:
        return self.latest_ts

    def owner(self, roots: torch.Tensor) -> torch.Tensor:
        """The partition of each root, -1 for an invalid or unassigned one
        or an id past the table."""
        pt = self.partition_table
        inside = (roots >= 0) & (roots < pt.shape[0])
        return torch.where(inside, pt[roots.clamp(0, pt.shape[0] - 1)], -1)

    def owner_rank(self, roots: torch.Tensor) -> torch.Tensor:
        """The rank of each root's owner, ``world_size`` for none."""
        part = self.owner(roots)
        return torch.where(part >= 0, part // self._per_rank,
                           self.world_size)


def _merge(views: Dict[int, DeviceGraph], pt: np.ndarray) -> DeviceGraph:
    """One view of several partitions' CPU views: pools concatenated, and
    each vertex's offset and length taken from the partition that owns it
    (``pt``), so a root's run is the one of its own partition."""
    n = max([len(pt)] + [v.node_capacity for v in views.values()])
    table = torch.full((n,), -1, dtype=torch.long)
    table[:len(pt)] = torch.from_numpy(pt.astype(np.int64))
    row_off = torch.zeros(n, dtype=torch.int32)
    row_len = torch.zeros(n, dtype=torch.int32)
    base = 0
    for p, v in views.items():
        mine = (table[:v.node_capacity] == p).nonzero().squeeze(1)
        row_off[mine] = v.row_off[mine] + base
        row_len[mine] = v.row_len[mine]
        base += v.pool_capacity
    return DeviceGraph(
        row_off=row_off, row_len=row_len,
        e_dst=torch.cat([v.e_dst for v in views.values()]),
        e_ts=torch.cat([v.e_ts for v in views.values()]),
        e_eid=torch.cat([v.e_eid for v in views.values()]),
        search_iters=max(v.search_iters for v in views.values()))


class PartitionedDynamicGraph:
    """Host-side manager (``dist_graph.py:65-225``): one
    :class:`DynamicGraph` per partition this rank owns, plus the partition
    table.  The data config's store keys pass through to each partition,
    except the placement: a partition's view lies on the rank's device."""

    _GRAPH_KEYS = ("initial_pool_size", "maximum_pool_size",
                   "minimum_block_size", "blocks_to_preallocate",
                   "insertion_policy", "adaptive_block_size", "spill_dir")

    def __init__(self, num_partitions: int, group=None, **graph_kwargs):
        self.num_partitions = int(num_partitions)
        self.group = group
        self.rank, self.world_size = group_rank(group), group_size(group)
        self.owned = owned_partitions(self.num_partitions, self.rank,
                                      self.world_size)
        kw = {k: v for k, v in graph_kwargs.items() if k in self._GRAPH_KEYS}
        self.locals: List[Optional[DynamicGraph]] = [
            DynamicGraph(**kw) if p in self.owned else None
            for p in range(self.num_partitions)]
        self._pt = np.zeros(0, dtype=np.int8)
        self._view: Optional[PartitionedDeviceGraph] = None
        self._view_device: Optional[torch.device] = None
        self._dirty = True

    @property
    def partition_table(self) -> np.ndarray:
        return self._pt

    def set_partition_table(self, pt: np.ndarray) -> None:
        self._pt = np.asarray(pt)
        self._dirty = True

    def add_partitioned_edges(self, partitions) -> None:
        """Ingest ``Partitioner.partition``'s edge sets; partitions this
        rank does not own are skipped."""
        for pid, part in enumerate(partitions):
            if len(part) and pid in self.owned:
                self.locals[pid].add_edges(part.src_nodes, part.dst_nodes,
                                           part.timestamps, part.eids)
        self._dirty = True

    def _owned_graphs(self):
        return [self.locals[p] for p in self.owned]

    def num_edges(self) -> int:
        """Edges in this rank's partitions."""
        return sum(g.num_edges() for g in self._owned_graphs())

    def _all_reduce_max(self, value):
        if self.world_size == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64,
                         device=group_device(self.group))
        dist.all_reduce(t, dist.ReduceOp.MAX, group=self.group)
        return t.item()

    def max_vertex_id(self) -> int:
        """The largest vertex id over all ranks' partitions (an all-reduce
        MAX); -1 for an empty store."""
        local = max([g.max_vertex_id() for g in self._owned_graphs()] + [-1])
        return int(self._all_reduce_max(float(local)))

    def device_graph(self, device="cuda") -> PartitionedDeviceGraph:
        """This rank's partitions as one view (built on the CPU from their
        stores' CPU views, then moved) and the table, on ``device``; kept
        until the store changes.  Collective (the latest timestamp is an
        all-reduce MAX), so every rank calls it at the same points."""
        dev = torch.device(device)
        if self._view is not None and not self._dirty \
                and self._view_device == dev:
            return self._view
        merged = _merge({p: self.locals[p].device_graph("cpu")
                         for p in self.owned}, self._pt)
        latest = float(merged.e_ts.max()) if merged.e_ts.numel() else 0.0
        self._view = PartitionedDeviceGraph(
            owned=DeviceGraph(*(getattr(merged, f).to(dev) for f in (
                "row_off", "row_len", "e_dst", "e_ts", "e_eid")),
                search_iters=merged.search_iters),
            partition_table=torch.from_numpy(
                self._pt.astype(np.int64)).to(dev),
            num_partitions=self.num_partitions,
            world_size=self.world_size, group=self.group,
            latest_ts=self._all_reduce_max(latest))
        self._view_device, self._dirty = dev, False
        return self._view


def sample_layer_routed(pg: PartitionedDeviceGraph, roots: torch.Tensor,
                        root_ts: torch.Tensor, *, fanout: int,
                        strategy: str = "recent", snapshot_idx: int = 0,
                        num_snapshots: int = 1, window: float = 0.0,
                        prop_time: bool = False,
                        u: Optional[torch.Tensor] = None) -> MFG:
    """One owner-routed layer sample of this rank's ``roots`` [n] (see the
    module doc); ``u`` [n, fanout] are uniform draws.  Collective."""
    roots, root_ts = roots.long(), root_ts.float()
    route = Route(pg.owner_rank(roots), pg.group)
    mine = sample_layer(pg.owned, route.send(roots), route.send(root_ts),
                        fanout=fanout, strategy=strategy,
                        snapshot_idx=snapshot_idx,
                        num_snapshots=num_snapshots, window=window,
                        prop_time=prop_time,
                        u=route.send(u) if u is not None else None)
    ints = route.back(torch.stack([mine.nbr_nids, mine.nbr_eids,
                                   mine.nbr_mask.long()], -1))
    floats = route.back(torch.stack([mine.nbr_ts, mine.nbr_dts], -1))
    mask = ints[..., 2].bool()
    return MFG(root_nids=roots, root_ts=root_ts,
               nbr_nids=torch.where(mask, ints[..., 0], INVALID_NID),
               nbr_ts=floats[..., 0], nbr_dts=floats[..., 1],
               nbr_eids=ints[..., 1], nbr_mask=mask)


def sample_layer_replicated(pg: PartitionedDeviceGraph, roots: torch.Tensor,
                            root_ts: torch.Tensor, *, fanout: int,
                            strategy: str = "recent", snapshot_idx: int = 0,
                            num_snapshots: int = 1, window: float = 0.0,
                            prop_time: bool = False,
                            u: Optional[torch.Tensor] = None) -> MFG:
    """One replicated layer sample of this rank's ``roots`` [n] (see the
    module doc).  Collective."""
    roots, root_ts = roots.long(), root_ts.float()
    n, dev, group = roots.shape[0], roots.device, pg.group
    counts = all_gather_cat(torch.tensor([n], device=dev), group).tolist()
    nmax = max(counts)

    def gather(x, fill):
        pad = x.new_full((nmax - n,) + tuple(x.shape[1:]), fill)
        return all_gather_cat(torch.cat([x, pad]), group)

    all_roots = gather(roots, INVALID_NID)
    all_ts = gather(root_ts, 0.0)
    all_u = gather(u, 0.0) if u is not None else None
    mine = pg.owner_rank(all_roots) == group_rank(group)
    m = sample_layer(pg.owned, torch.where(mine, all_roots, INVALID_NID),
                     all_ts, fanout=fanout, strategy=strategy,
                     snapshot_idx=snapshot_idx, num_snapshots=num_snapshots,
                     window=window, prop_time=prop_time, u=all_u)
    k = m.nbr_mask
    acc_i = torch.stack([torch.where(k, m.nbr_nids + 1, 0),
                         torch.where(k, m.nbr_eids, 0), k.long()], -1)
    acc_f = torch.stack([torch.where(k, m.nbr_ts, 0.0),
                         torch.where(k, m.nbr_dts, 0.0)], -1)

    def merge(acc):
        if not dist.is_initialized():
            return acc
        out = acc.new_empty((nmax,) + tuple(acc.shape[1:]))
        dist.reduce_scatter_tensor(out, acc, group=group)
        return out[:n]

    ints, floats = merge(acc_i), merge(acc_f)
    mask = ints[..., 2] > 0
    return MFG(root_nids=roots, root_ts=root_ts,
               nbr_nids=torch.where(mask, ints[..., 0] - 1, INVALID_NID),
               nbr_ts=floats[..., 0], nbr_dts=floats[..., 1],
               nbr_eids=torch.where(mask, ints[..., 1], 0), nbr_mask=mask)


LAYER_FNS = {"routed": sample_layer_routed,
             "replicated": sample_layer_replicated}


def _sample_hops(layer_fn, pg, roots, root_ts, *, fanouts: Sequence[int],
                 strategy: str = "recent", num_snapshots: int = 1,
                 window: float = 0.0, prop_time: bool = False,
                 draw: Optional[Callable[[int, tuple], torch.Tensor]] = None
                 ) -> List[List[MFG]]:
    if strategy == "uniform" and draw is None:
        raise ValueError("uniform sampling needs draws")
    S = num_snapshots
    kw = dict(strategy=strategy, num_snapshots=S, window=window,
              prop_time=prop_time)
    per_snap = [(roots, root_ts)] * S
    mfgs: List[List[MFG]] = []
    for layer, fanout in enumerate(int(f) for f in fanouts):
        u = None
        if strategy == "uniform":         # the single store's draw shapes
            n = per_snap[0][0].shape[0]
            u = draw(layer, (S, n, fanout) if S > 1 else (n, fanout))
            u = u if S > 1 else u[None]
        layer_mfgs = [layer_fn(pg, r, t, fanout=fanout, snapshot_idx=s,
                               u=None if u is None else u[s], **kw)
                      for s, (r, t) in enumerate(per_snap)]
        per_snap = [(m.all_nodes(), m.all_ts()) for m in layer_mfgs]
        mfgs.append(layer_mfgs)
    mfgs.reverse()
    return mfgs


def sample_hops_routed(pg: PartitionedDeviceGraph, roots, root_ts, **kw
                       ) -> List[List[MFG]]:
    """Multi-layer, multi-snapshot routed sampling (``:635-670``), the
    arguments of :func:`~gnnflow_tpu_torch.ops.sampling.sample_hops`
    without ``compact_factor``: its MFGs, innermost layer first, on the
    same draws."""
    return _sample_hops(sample_layer_routed, pg, roots, root_ts, **kw)


def sample_hops_partitioned(pg: PartitionedDeviceGraph, roots, root_ts,
                            **kw) -> List[List[MFG]]:
    """Multi-layer, multi-snapshot replicated sampling (``:672-703``)."""
    return _sample_hops(sample_layer_replicated, pg, roots, root_ts, **kw)


def routed_load_stats(partition_table: np.ndarray, roots: np.ndarray,
                      num_partitions: int) -> dict:
    """Per-owner load of one batch of roots (``:590-632``): the routed
    root count of each partition and its coefficient of variation, the
    counterpart of the reference's per-worker sampling-time CV.  Returns
    ``{"counts": [P], "cv": float}``."""
    pt = np.asarray(partition_table)
    r = np.asarray(roots)
    r = r[(r >= 0) & (r < len(pt))]
    owner = pt[r]
    counts = np.bincount(owner[owner >= 0], minlength=num_partitions)
    mean = counts.mean()
    return {"counts": counts,
            "cv": float(counts.std() / mean) if mean > 0 else 0.0}


class DistributedTemporalSampler:
    """User-facing distributed sampler (``:705-768``): ``sample(roots,
    ts)`` over the partitioned store, ``mode`` ``"routed"`` or
    ``"replicated"``; uniform draws from its own generator, seeded with
    ``seed``; ``is_static`` samples at ``STATIC_TS``.  Collective: every
    rank samples its own roots in the same calls."""

    def __init__(self, pgraph: PartitionedDynamicGraph,
                 fanouts: Sequence[int], sample_strategy: str = "recent",
                 num_snapshots: int = 1, snapshot_time_window: float = 0.0,
                 prop_time: bool = False, seed: int = 1234,
                 is_static: bool = False, mode: str = "routed",
                 device="cuda"):
        if mode not in LAYER_FNS:
            raise ValueError(f"mode must be 'routed' or 'replicated', got "
                             f"{mode!r}")
        self._pgraph = pgraph
        self._fanouts = tuple(int(f) for f in fanouts)
        self._kw = dict(strategy=sample_strategy.lower(),
                        num_snapshots=int(num_snapshots),
                        window=float(snapshot_time_window),
                        prop_time=bool(prop_time))
        self._is_static = bool(is_static)
        self._mode = mode
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def sample(self, target_vertices: np.ndarray,
               timestamps: np.ndarray) -> List[List[MFG]]:
        pg = self._pgraph.device_graph(self.device)
        ts = (np.full(np.shape(target_vertices), STATIC_TS, np.float32)
              if self._is_static else np.asarray(timestamps, np.float32))
        roots = torch.from_numpy(np.asarray(target_vertices, np.int64))
        return _sample_hops(
            LAYER_FNS[self._mode], pg, roots.to(self.device),
            torch.from_numpy(ts).to(self.device), fanouts=self._fanouts,
            draw=lambda _, shape: torch.rand(shape, generator=self._gen,
                                             device=self.device),
            **self._kw)
