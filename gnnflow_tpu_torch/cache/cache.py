"""Feature caches: a card-resident cache over a host-resident master table
or over a table sharded over the ranks of a process group.

Counterpart of ``gnnflow_tpu/cache/cache.py``.  It serves the datasets
whose feature tables do not fit on the card (GDELT, MAG): the master
table stays in host memory (optionally a memory map), a fixed-capacity f32
buffer lives on the card, and each fetch gathers its hits from the buffer
while its misses go host to card through pinned staging buffers, in f32
or bf16 (``transfer_dtype``; the buffer stays f32).  A master with
``pull`` (:class:`~gnnflow_tpu_torch.parallel.kvstore.ShardedTable`, the
reference's KV store, ``cache.py:364-377``) serves the misses with one
routed pull on the device instead, in f32 whatever ``transfer_dtype``
says, as the JAX package's sharded master does (``cache.py:104-175``).
The pull is a collective: the host bookkeeping is identical on every
rank, which fetches the same ids, so every rank pulls the same misses in
the same order, and a fetch with no miss still joins the exchange.

Per kind (node, edge) the state is the reference's (``cache.py:108-134``):
the ``[capacity, dim]`` buffer on the card, and on the host a ``flag[N]``
bool, an id -> slot ``map`` and a slot -> id ``rmap`` as NumPy arrays (the
eviction decisions are host work), plus the running hit counters behind
``cache_node_ratio`` and ``cache_edge_ratio``.  The policies of
:mod:`gnnflow_tpu_torch.cache.policies` fill the buffer.

The device work of a fetch (the hit gather, the scatter of the misses,
the expansion to the query order, the mask) and of an insert is plain
PyTorch, as it is XLA in the JAX package (``cache.py:36-66``); its
power-of-two padding of shapes (``_bucket``), which bounds XLA's compiles,
has no purpose here.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from gnnflow_tpu_torch.common import MFG, resolve_device


def mfgs_to_host(mfgs: List[List[MFG]]):
    """Every MFG's id and mask arrays on the host, in one copy of their
    concatenation (``cache.py:73-101``).

    Returns ``(node_ids[s], node_valid[s], eids[l][s], emask[l][s])``:
    the innermost MFGs' instances and every MFG's neighbour slots, int64
    and bool NumPy arrays."""
    parts = []
    for mfg in mfgs[0]:
        parts += [mfg.all_nodes(), mfg.all_mask()]
    for layer in mfgs:
        for mfg in layer:
            parts += [mfg.nbr_eids, mfg.nbr_mask]
    flat = torch.cat([a.reshape(-1).long() for a in parts]).cpu().numpy()
    out, off = [], 0
    for a in parts:
        out.append(flat[off: off + a.numel()].reshape(tuple(a.shape)))
        off += a.numel()
    S = len(mfgs[0])
    node_ids = out[0: 2 * S: 2]
    node_valid = [v.astype(bool) for v in out[1: 2 * S: 2]]
    rest = out[2 * S:]
    eids, emask, i = [], [], 0
    for layer in mfgs:
        eids.append([rest[2 * (i + j)] for j in range(len(layer))])
        emask.append([rest[2 * (i + j) + 1].astype(bool)
                      for j in range(len(layer))])
        i += len(layer)
    return node_ids, node_valid, eids, emask


class _Staging:
    """Host buffers through which host arrays go to the device.

    On the card they are pinned and taken in a ring: a buffer is written
    again only after the copy that read it has finished (the CUDA event
    recorded after that copy, on the stream that made it).  Pinning that
    fails raises.  On the CPU every call gets a fresh tensor, which is
    itself the result."""

    def __init__(self, device: torch.device, slots: int = 8):
        self.device = device
        self._ring = [(None, None)] * slots
        self._next = 0

    def stage(self, shape, dtype: torch.dtype,
              fill: Callable[[torch.Tensor], None]) -> torch.Tensor:
        """A ``shape``, ``dtype`` tensor on the device holding what
        ``fill`` writes into a host tensor of that shape."""
        if self.device.type == "cpu":
            host = torch.empty(shape, dtype=dtype)
            fill(host)
            return host
        i = self._next
        buf, event = self._ring[i]
        if event is not None:
            event.synchronize()
        nbytes = math.prod(shape) * dtype.itemsize
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(1 << max(16, (nbytes - 1).bit_length()),
                              dtype=torch.uint8, pin_memory=True)
        host = buf[:nbytes].view(dtype).view(shape)
        fill(host)
        out = host.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._ring[i] = (buf, event)
        self._next = (i + 1) % len(self._ring)
        return out


def _host_rows(table) -> torch.Tensor:
    """The master table as a CPU float32 tensor, sharing memory with a
    contiguous float32 array or memory map (copied otherwise).  A
    read-only memory map is shared too: the cache only reads it."""
    arr = np.ascontiguousarray(table, dtype=np.float32)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array "
                                "is not writable")
        return torch.from_numpy(arr)


class _KindCache:
    """Cache state for one feature kind (node or edge) over a master table
    ``[num_rows, dim]``: a NumPy array or memory map on the host, or a
    sharded table with ``pull`` (``distributed``)."""

    def __init__(self, capacity: int, num_ids: int, dim: int, table,
                 transfer_dtype: str, device: torch.device,
                 staging: _Staging):
        if transfer_dtype not in ("float32", "bfloat16"):
            raise ValueError(transfer_dtype)
        self.capacity = int(capacity)
        self.num_ids = int(num_ids)
        self.dim = int(dim)
        self.distributed = hasattr(table, "pull")
        self._tdt = torch.float32 if self.distributed \
            else getattr(torch, transfer_dtype)
        self.table = table                       # master [N, dim]
        self._rows = None if self.distributed else _host_rows(table)
        self.device = device
        self._staging = staging
        self.buffer = torch.zeros((max(self.capacity, 1), self.dim),
                                  dtype=torch.float32, device=device)
        self.flag = np.zeros(num_ids, dtype=bool)
        self.map = np.full(num_ids, -1, dtype=np.int64)      # id -> slot
        self.rmap = np.full(max(self.capacity, 1), -1,
                            dtype=np.int64)                  # slot -> id
        self.hits = 0
        self.total = 0
        self._last_miss = (np.zeros(0, np.int64), None)

    @property
    def hit_ratio(self) -> float:
        return self.hits / self.total if self.total else 0.0

    def _pull(self, ids: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """Master rows of ``ids`` on the device in ``dtype`` (bf16 rounds
        to nearest even, as ``ml_dtypes`` does); a negative id counts from
        the end, as NumPy indexing does.  The rows are gathered straight
        into the staging buffer, outside the interpreter lock.  A sharded
        master pulls them, in f32 (a collective, also for no ids)."""
        if self.distributed:
            return self.table.pull(torch.from_numpy(
                np.asarray(ids, np.int64)).to(self.device)).float()
        n = self._rows.shape[0]
        idx = torch.from_numpy(np.where(ids < 0, ids + n, ids))

        def fill(out):
            if dtype == torch.float32:
                torch.index_select(self._rows, 0, idx, out=out)
            else:
                out.copy_(torch.index_select(self._rows, 0, idx))
        return self._staging.stage((len(ids), self.dim), dtype, fill)

    def _indices(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host index and mask arrays on the device, in one copy."""
        sizes = [len(a) for a in arrays]
        packed = self._staging.stage(
            (sum(sizes),), torch.int64,
            lambda out: np.concatenate(arrays, out=out.numpy(),
                                       casting="unsafe"))
        return list(packed.split(sizes))

    def seed(self, ids: np.ndarray) -> None:
        """Pre-fill the cache with ``ids`` (first-k or pre-sampled top-k,
        ``cache.py:161-173``), in f32 whatever the transfer dtype."""
        ids = np.asarray(ids, dtype=np.int64)[: self.capacity]
        ids = ids[ids < self.num_ids]
        k = len(ids)
        if k == 0 or self.capacity == 0:
            return
        self.buffer[:k] = self._pull(ids, torch.float32)
        self.flag[ids] = True
        self.map[ids] = np.arange(k)
        self.rmap[:k] = ids

    def fetch(self, ids: np.ndarray, inv: np.ndarray,
              valid: np.ndarray) -> torch.Tensor:
        """Features of the unique ``ids``, mapped back to the query order
        by ``inv``; rows where ``valid`` is False are zero.  Returns a
        device [len(inv), dim] f32 tensor.  Without capacity every row
        comes from the master table in f32 (``cache.py:204-216``)."""
        n = len(ids)
        self.total += n
        if self.capacity == 0 or n == 0:
            self._last_miss = (np.zeros(0, np.int64), None)
            if n == 0:
                return torch.zeros((len(inv), self.dim),
                                   device=self.device)
            out = self._pull(ids, torch.float32)
            iv, va = self._indices(inv, valid)
        else:
            hit = self.flag[ids]
            self.hits += int(hit.sum())
            hit_pos = np.flatnonzero(hit)
            miss_pos = np.flatnonzero(~hit)
            miss_ids = ids[miss_pos]
            miss = self._pull(miss_ids, self._tdt)
            hs, hp, mp, iv, va = self._indices(
                self.map[ids[hit_pos]], hit_pos, miss_pos, inv, valid)
            out = torch.empty((n, self.dim), dtype=torch.float32,
                              device=self.device)
            out.index_copy_(0, hp, self.buffer.index_select(0, hs))
            out.index_copy_(0, mp, miss.float())
            self._last_miss = (miss_ids, miss)
        return torch.where(va.bool()[:, None], out.index_select(0, iv), 0.0)

    def insert(self, victim_slots: np.ndarray) -> np.ndarray:
        """Place the last fetch's missed ids, in the transfer dtype's
        values, into ``victim_slots``; returns the slots used."""
        miss_ids, miss = self._last_miss
        if len(miss_ids) == 0 or self.capacity == 0:
            return np.zeros(0, np.int64)
        k = min(len(victim_slots), len(miss_ids))
        ids = miss_ids[:k]
        slots = np.asarray(victim_slots[:k], dtype=np.int64)
        old_ids = self.rmap[slots]
        live = old_ids >= 0
        self.flag[old_ids[live]] = False
        self.map[old_ids[live]] = -1
        (dev_slots,) = self._indices(slots)
        self.buffer.index_copy_(0, dev_slots, miss[:k].float())
        self.flag[ids] = True
        self.map[ids] = slots
        self.rmap[slots] = ids
        return slots

    def resize_ids(self, num_ids: int) -> None:
        if num_ids <= self.num_ids:
            return
        grown = np.zeros(num_ids, dtype=bool)
        grown[: len(self.flag)] = self.flag
        self.flag = grown
        grown = np.full(num_ids, -1, dtype=np.int64)
        grown[: len(self.map)] = self.map
        self.map = grown
        self.num_ids = num_ids

    def mem_size(self) -> int:
        return int(self.buffer.numel() * 4)


class Cache:
    """Base feature cache; the policies override :meth:`_update` (and
    :meth:`init_cache`).

    Parity with ``gnnflow/cache/cache.py:10-413``: capacities are ratio
    × table size; ``fetch_feature(mfgs, eids)`` returns per-snapshot node
    features for the innermost MFGs and per-(layer, snapshot) edge
    features, and keeps the batch's target-edge features (for TGN's
    mails) in ``target_edge_features``.  ``device`` holds the buffers
    (``cuda`` by default; raises without a card).  The master tables are
    NumPy arrays or memory maps, or sharded tables with ``pull`` on every
    rank of a group (misses are routed pulls), and are never written."""

    name = "Cache"

    def __init__(self, edge_cache_ratio: float, node_cache_ratio: float,
                 num_nodes: int, num_edges: int,
                 node_feats: Optional[np.ndarray],
                 edge_feats: Optional[np.ndarray],
                 dim_node: int = 0, dim_edge: int = 0,
                 transfer_dtype: str = "float32", device="cuda"):
        self.device = resolve_device(device)
        staging = _Staging(self.device)
        self.node_cache: Optional[_KindCache] = None
        self.edge_cache: Optional[_KindCache] = None
        if node_feats is not None:
            dim_node = node_feats.shape[1]
            self.node_cache = _KindCache(
                int(node_cache_ratio * num_nodes), num_nodes, dim_node,
                node_feats, transfer_dtype, self.device, staging)
        if edge_feats is not None:
            dim_edge = edge_feats.shape[1]
            self.edge_cache = _KindCache(
                int(edge_cache_ratio * num_edges), num_edges, dim_edge,
                edge_feats, transfer_dtype, self.device, staging)
        self.dim_node = dim_node
        self.dim_edge = dim_edge
        self.target_edge_features: Optional[torch.Tensor] = None

    # -- policy hooks ---------------------------------------------------

    def init_cache(self, **kwargs) -> None:
        """Default seeding: the first ids (``cache.py:161-173``)."""
        for kind in (self.node_cache, self.edge_cache):
            if kind is not None:
                kind.seed(np.arange(kind.capacity))

    def _update(self, kind: _KindCache, ids: np.ndarray,
                hit_mask: np.ndarray) -> None:
        """Admit misses and adjust the policy's state."""
        raise NotImplementedError

    def reset(self) -> None:
        """Zero the hit counters, so the logged ratios are per epoch (the
        reference calls ``cache.reset()`` at each epoch start)."""
        for kind in (self.node_cache, self.edge_cache):
            if kind is not None:
                kind.hits = 0
                kind.total = 0

    # -- fetch ----------------------------------------------------------

    @property
    def cache_node_ratio(self) -> float:
        return self.node_cache.hit_ratio if self.node_cache else 0.0

    @property
    def cache_edge_ratio(self) -> float:
        return self.edge_cache.hit_ratio if self.edge_cache else 0.0

    def get_mem_size(self) -> int:
        return sum(kind.mem_size() for kind in
                   (self.node_cache, self.edge_cache) if kind is not None)

    def _fetch_kind(self, kind: Optional[_KindCache], ids: np.ndarray,
                    valid: np.ndarray, out_shape) -> Optional[torch.Tensor]:
        """One query: its unique ids (an invalid slot counts as id 0, as
        ``cache.py:375`` counts it), the fetch, then the policy's update."""
        if kind is None:
            return None
        flat_valid = valid.reshape(-1)
        safe = np.where(flat_valid, ids.reshape(-1), 0)
        uniq, inv = np.unique(safe, return_inverse=True)
        hit_mask = kind.flag[uniq] if kind.capacity else \
            np.zeros(len(uniq), bool)
        out = kind.fetch(uniq, inv.reshape(-1), flat_valid)
        self._update(kind, uniq, hit_mask)
        return out.reshape(tuple(out_shape) + (kind.dim,))

    def fetch_feature(self, mfgs: List[List[MFG]],
                      eids: Optional[np.ndarray] = None,
                      target_edge_features: bool = True):
        """Features of sampled MFGs (``cache.py:383-419``): node features
        per snapshot, then edge features per layer and snapshot, then the
        target edges' (kept in ``self.target_edge_features``), in that
        order of policy updates.

        Returns ``(node_feats[s], edge_feats[l][s])``, None where the
        cache has no table of that kind."""
        node_ids, node_valid, eid_arrs, emask_arrs = mfgs_to_host(mfgs)
        nfs = [self._fetch_kind(self.node_cache, ids, valid, ids.shape)
               for ids, valid in zip(node_ids, node_valid)]
        efs = [[self._fetch_kind(self.edge_cache, ids, valid, ids.shape)
                for ids, valid in zip(eid_arrs[l], emask_arrs[l])]
               for l in range(len(mfgs))]
        if target_edge_features and eids is not None \
                and self.edge_cache is not None:
            ids = np.asarray(eids, dtype=np.int64)
            self.target_edge_features = self._fetch_kind(
                self.edge_cache, ids, np.ones_like(ids, dtype=bool),
                ids.shape)
        return nfs, efs
