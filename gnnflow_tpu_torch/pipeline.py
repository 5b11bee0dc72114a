"""The sampling and feature-fetch prefetch pipeline.

Counterpart of ``gnnflow_tpu/pipeline.py``: a worker thread samples batch
k+1 and fetches its features through the cache while batch k steps (the
reference's sampling thread, ``scripts/offline_edge_prediction.py:
343-399``).  A fetch is host work: one copy of the sampled ids to the
host, ``np.unique`` and the policy's bookkeeping, the gather of the
missed rows and their copy to the card; the thread overlaps it with the
step's launches.  The NumPy and PyTorch calls it makes on large arrays
run outside the interpreter lock.

On the card the worker issues all its work on a CUDA stream of its own:
its copy of the ids to the host then waits on that stream only, and its
copies to the card go from the cache's pinned staging buffers.  It
records an event after each batch; the consumer's stream waits on it
before the step, and every tensor handed over is recorded on the
consumer's stream, so the caching allocator does not reuse its memory
while the step may still read it.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, Tuple

import torch


def _tensors(item) -> List[torch.Tensor]:
    """Every tensor of a fetched ``(mfgs, nfs, efs, tef)`` (MFGs of a
    store placed on the host are on the CPU)."""
    mfgs, nfs, efs, tef = item
    out = [t for layer in mfgs for m in layer for t in
           (m.root_nids, m.root_ts, m.nbr_nids, m.nbr_ts, m.nbr_dts,
            m.nbr_eids, m.nbr_mask)]
    out += [t for t in (nfs or []) if t is not None]
    out += [t for row in (efs or []) for t in row if t is not None]
    return out + ([tef] if tef is not None else [])


class FeaturePipeline:
    """Prefetches ``(batch, mfgs, node_feats, edge_feats,
    target_edge_feats)`` tuples with a worker thread and a queue of
    ``depth``.

    Usage::

        pipe = FeaturePipeline(sampler, cache, depth=2)
        for batch, mfgs, nfs, efs, tef in pipe.run(get_batches(...)):
            state, loss, *_ = trainer.train_step_prefetched(
                state, mfgs, nfs, efs, tef, batch)

    The cache's state (flags, counters, buffer) changes on the worker
    thread, so its eviction decisions run one batch ahead, as in the JAX
    package; do not call ``cache.fetch_feature`` elsewhere while a run is
    going.  A worker error is raised on the consumer; leaving the loop
    early drains the worker."""

    _SENTINEL = object()

    def __init__(self, sampler, cache, depth: int = 2):
        self.sampler = sampler
        self.cache = cache
        self.depth = int(depth)

    def run(self, batches: Iterable) -> Iterator[Tuple]:
        q: "queue.Queue" = queue.Queue(self.depth)
        err: list = []
        stop = threading.Event()
        cuda = self.cache.device.type == "cuda"
        stream = None
        if cuda:
            # the worker's stream starts after what the consumer issued
            # (the store's view, the cache's last writes)
            stream = torch.cuda.Stream(device=self.cache.device)
            stream.wait_stream(torch.cuda.current_stream())

        def fetch(batch):
            mfgs = self.sampler.sample(batch.target_nodes, batch.ts)
            nfs, efs = self.cache.fetch_feature(mfgs, batch.eids)
            return mfgs, nfs, efs, self.cache.target_edge_features

        def worker():
            try:
                for batch in batches:
                    if stop.is_set():
                        break
                    if cuda:
                        with torch.cuda.stream(stream):
                            item = fetch(batch)
                            event = torch.cuda.Event()
                            event.record(stream)
                    else:
                        item, event = fetch(batch), None
                    q.put((batch, item, event))
            except BaseException as e:  # raised on the consumer
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                got = q.get()
                if got is self._SENTINEL:
                    break
                batch, item, event = got
                if event is not None:
                    consumer = torch.cuda.current_stream()
                    consumer.wait_event(event)
                    for x in _tensors(item):
                        if x.is_cuda:
                            x.record_stream(consumer)
                yield (batch,) + item
        finally:
            # drain so the worker can exit, also after an early break
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
            if stream is not None:
                # later users of the cache (eval) run after its writes
                torch.cuda.current_stream().wait_stream(stream)
        if err:
            raise err[0]
