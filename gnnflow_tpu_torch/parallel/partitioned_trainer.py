"""The trainer over a partitioned store: multi-GPU training.

Counterpart of ``gnnflow_tpu/parallel/partitioned_trainer.py:36-242``.
The step is the port's :class:`~gnnflow_tpu_torch.train.Trainer` step over
a different placement:

- sampling goes through the partitioned store
  (:mod:`~gnnflow_tpu_torch.parallel.dist_graph`), owner-routed
  (``sampling_mode="routed"``, the default) or replicated;
- features come from :class:`~gnnflow_tpu_torch.parallel.kvstore.
  ShardedTable` s (``pull``), passed where the trainer takes its tables;
- the batch is sliced over the ranks, and the gradients and the memory
  write-back are handled as in :mod:`~gnnflow_tpu_torch.parallel.dp`;
- memory (TGN, APAN) is sharded over the ranks where the group has more
  than one (:meth:`_init_memory`, ``:104-112``;
  :func:`~gnnflow_tpu_torch.parallel.kvstore.shard_memory_state`): a pull
  is one routed exchange, and each rank writes back only the rows it
  owns, from the global batch.

The memory dedup is off unless asked for (``:74``), and runs over sharded
memory and sharded node features alike; the layer dedup, the snapshot
dedup and the block compaction stay (``_fast_paths``, ``:48-57``).

The ranks stay in step by design: every path calls :meth:`_sample_layer`
once per layer (each snapshot one routed exchange), also when one rank
falls back to the padded path and another does not, and a rank with no
valid roots joins every exchange with empty splits; the first-step
calibration samples the global batch on every rank, so it picks the same
knobs everywhere; the layer dedup's take of a step is the largest of the
ranks' (one all-reduce with the gradients), so the recalibration rule
reads the same histogram on every rank; a rank on the memory dedup and a
rank on its fallback make the same memory and node-feature pulls, in the
same order (``Trainer._mem_input``).
"""
from __future__ import annotations

from typing import List

from gnnflow_tpu_torch.common import MFG
from gnnflow_tpu_torch.models.memory import MemoryState
from gnnflow_tpu_torch.parallel.dist_graph import LAYER_FNS, _sample_hops
from gnnflow_tpu_torch.parallel.dp import DataParallel
from gnnflow_tpu_torch.parallel.kvstore import shard_memory_state
from gnnflow_tpu_torch.train import Trainer


class PartitionedTrainer(Trainer):
    """Trainer whose steps take a
    :class:`~gnnflow_tpu_torch.parallel.dist_graph.PartitionedDeviceGraph`
    as ``dg`` and sharded tables (or None) as the feature tables.  Every
    rank of ``group`` calls the same steps on the same global batches."""

    def __init__(self, model, sampling_mode: str = "routed", group=None,
                 **kwargs):
        if sampling_mode not in LAYER_FNS:
            raise ValueError(f"sampling_mode must be 'routed' or "
                             f"'replicated', got {sampling_mode!r}")
        kwargs.setdefault("dedup_factor", None)
        super().__init__(model, **kwargs)
        self.sampling_mode = sampling_mode
        self.dp = DataParallel(group)

    def _init_memory(self, num_nodes: int) -> MemoryState:
        """The trainer's memory, sharded over the group where it has more
        than one rank."""
        mem = super()._init_memory(num_nodes)
        if self.dp.world_size > 1:
            mem = shard_memory_state(mem, self.dp.group)
        return mem

    def _layer(self, dg, roots, ts, fanout, snapshot_idx, u) -> MFG:
        return LAYER_FNS[self.sampling_mode](
            dg, roots, ts, fanout=fanout, snapshot_idx=snapshot_idx, u=u,
            **self._window_kw())

    def _sample_layer(self, gen, dg, R, T, layer: int,
                      shared_roots: bool = False) -> List[MFG]:
        """Every snapshot of one layer, routed one at a time, on the
        single store's draws."""
        fanout = self.fanouts[layer]
        u = self._uniform(gen, tuple(R.shape) + (fanout,)) \
            if self.strategy == "uniform" else None
        return [self._layer(dg, R[s], T[s], fanout, s,
                            None if u is None else u[s])
                for s in range(self.num_snapshots)]

    def _sample(self, gen, dg, roots, ts,
                compact: bool = True) -> List[List[MFG]]:
        """The padded MFGs over the partitioned store; the block
        compaction of the sampling itself (``compact``) changes no MFG and
        is not taken here, as in JAX's routed sampler."""
        del compact
        return _sample_hops(LAYER_FNS[self.sampling_mode], dg, roots, ts,
                            fanouts=self.fanouts,
                            draw=lambda _, shape: self._uniform(gen, shape),
                            **self._window_kw())
