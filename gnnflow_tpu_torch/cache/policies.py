"""Cache replacement policies.

Counterpart of ``gnnflow_tpu/cache/policies.py``, call for call: the
bookkeeping is the same NumPy (``np.argpartition`` picks the evicted
slots among tied counters, ``np.add.at`` and a stable ``np.argsort`` the
static top-k), so the hit ratios equal the JAX package's on one id
stream.
"""
from __future__ import annotations

import numpy as np

from gnnflow_tpu_torch.cache.cache import Cache, _KindCache


class FIFOCache(Cache):
    """Circular-pointer eviction (``fifo_cache.py:97-117``)."""

    name = "FIFOCache"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._ptr = {}

    def _update(self, kind: _KindCache, ids, hit_mask):
        num_miss = int((~hit_mask).sum())
        if num_miss == 0 or kind.capacity == 0:
            return
        ptr = self._ptr.get(id(kind), 0)
        k = min(num_miss, kind.capacity)
        slots = (ptr + np.arange(k)) % kind.capacity
        kind.insert(slots)
        self._ptr[id(kind)] = int((ptr + k) % kind.capacity)


class LRUCache(Cache):
    """Counter-decay LRU (``lru_cache.py:142-160``): every update all
    counters decrement, touched slots reset to 0, and the most-negative
    (least recent) slots are evicted."""

    name = "LRUCache"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._count = {}

    def _counters(self, kind: _KindCache) -> np.ndarray:
        c = self._count.get(id(kind))
        if c is None or len(c) != kind.capacity:
            c = np.zeros(max(kind.capacity, 1), dtype=np.int64)
            self._count[id(kind)] = c
        return c

    def _update(self, kind: _KindCache, ids, hit_mask):
        if kind.capacity == 0:
            return
        c = self._counters(kind)
        c -= 1
        hit_slots = kind.map[ids[hit_mask]]
        c[hit_slots] = 0
        num_miss = int((~hit_mask).sum())
        if num_miss == 0:
            return
        k = min(num_miss, kind.capacity)
        victims = np.argpartition(c, k - 1)[:k]  # most negative
        used = kind.insert(victims)
        c[used] = 0


class LFUCache(Cache):
    """Frequency counters: +1 on hit, inserts start at 1, evict
    least-frequent (``lfu_cache.py:154-171``)."""

    name = "LFUCache"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._count = {}

    def _counters(self, kind: _KindCache) -> np.ndarray:
        c = self._count.get(id(kind))
        if c is None or len(c) != kind.capacity:
            c = np.zeros(max(kind.capacity, 1), dtype=np.int64)
            self._count[id(kind)] = c
        return c

    def _update(self, kind: _KindCache, ids, hit_mask):
        if kind.capacity == 0:
            return
        c = self._counters(kind)
        hit_slots = kind.map[ids[hit_mask]]
        np.add.at(c, hit_slots, 1)
        num_miss = int((~hit_mask).sum())
        if num_miss == 0:
            return
        k = min(num_miss, kind.capacity)
        victims = np.argpartition(c, k - 1)[:k]
        used = kind.insert(victims)
        c[used] = 1


class GNNLabStaticCache(Cache):
    """Presampling-based static cache (``gnnlab_static_cache.py:87-182``):
    run the sampler over the training set counting node/edge access
    frequency, cache the top-k, never update at runtime."""

    name = "GNNLabStaticCache"

    def init_cache(self, sampler=None, train_data=None,
                   pre_sampling_rounds: int = 2, batch_size: int = 600,
                   **kwargs) -> None:
        if sampler is None or train_data is None:
            # easy misconfiguration: without a sampler + training set
            # there is nothing to pre-sample, and the "static" cache
            # quietly becomes first-k seeding (a much weaker policy)
            import logging
            logging.getLogger(__name__).warning(
                "GNNLabStaticCache.init_cache called without sampler/"
                "train_data — falling back to first-k seeding (pass both "
                "to get the presampled top-k policy)")
            super().init_cache()
            return
        node_counts = np.zeros(
            self.node_cache.num_ids if self.node_cache else 1,
            dtype=np.int64)
        edge_counts = np.zeros(
            self.edge_cache.num_ids if self.edge_cache else 1,
            dtype=np.int64)
        n = len(train_data)
        for _ in range(pre_sampling_rounds):
            for lo in range(0, n, batch_size):
                sl = slice(lo, min(lo + batch_size, n))
                roots = np.concatenate([train_data.src[sl],
                                        train_data.dst[sl]])
                ts = np.concatenate([train_data.time[sl],
                                     train_data.time[sl]])
                mfgs = sampler.sample(roots, ts)
                for layer in mfgs:
                    for mfg in layer:
                        mask = mfg.nbr_mask.cpu().numpy()
                        if self.node_cache is not None:
                            nids = mfg.nbr_nids.cpu().numpy()[mask]
                            np.add.at(node_counts, nids, 1)
                        if self.edge_cache is not None:
                            es = mfg.nbr_eids.cpu().numpy()[mask]
                            np.add.at(edge_counts, es, 1)
        if self.node_cache is not None:
            top = np.argsort(-node_counts, kind="stable")
            self.node_cache.seed(top[: self.node_cache.capacity])
        if self.edge_cache is not None:
            top = np.argsort(-edge_counts, kind="stable")
            self.edge_cache.seed(top[: self.edge_cache.capacity])

    def _update(self, kind, ids, hit_mask):
        pass  # static: never updated at runtime
