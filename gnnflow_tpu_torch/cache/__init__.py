from gnnflow_tpu_torch.cache.cache import Cache
from gnnflow_tpu_torch.cache.policies import (FIFOCache, GNNLabStaticCache,
                                              LFUCache, LRUCache)

CACHES = {c.name: c for c in
          (LRUCache, LFUCache, FIFOCache, GNNLabStaticCache)}

__all__ = ["Cache", "LRUCache", "LFUCache", "FIFOCache",
           "GNNLabStaticCache", "CACHES"]
