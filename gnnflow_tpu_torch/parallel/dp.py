"""Data-parallel training over a process group.

Counterpart of ``gnnflow_tpu/parallel/dp.py:19-56``.  JAX's data
parallelism is a placement, not a new meaning: every process holds the
same global batch, the batch axis is sharded, and the sharded step equals
the single-device step.  :func:`shard_trainer` keeps that meaning with one
process per device:

- **Slicing.** Rank r takes edges ``[r·B/W, (r+1)·B/W)`` of the global
  batch, in each of the ``2 + r`` blocks of the ``[src | dst | neg]``
  layout of ``_pad_batch`` (``data.py:387``); B must divide by W (the
  scripts round it down).
- **Loss and gradients.** ``link_pred_loss`` is a masked mean over the
  valid rows of the whole batch (``train.py:55-65``).  A padded last
  batch's valid rows are not spread evenly over the ranks, so each rank
  divides its masked sum by the global valid count, which it knows from
  the global batch without a collective; one all-reduce then sums the
  flattened gradients (and the loss, and the layer dedup's take) per
  step, and the host reads nothing of it but the take.  This is not
  ``DistributedDataParallel``, whose mean of per-rank means would weigh
  a short rank's rows wrongly.
- **Memory write-back.** The write-back keeps the last occurrence in the
  single-device order ``[src_all; dst_all; neg_all]``, so each rank's
  rows are all-gathered and put back in that order, block by block,
  before one ``update_mem_mail``,
  which writes every row of replicated memory, or a rank's own rows of
  sharded memory (:class:`~gnnflow_tpu_torch.parallel.
  partitioned_trainer.PartitionedTrainer`).
- **Knobs.** The memory dedup is switched off, with JAX's warning, and
  calibration is held from switching it on (``dp.py:35-51``).
- **State.** The parameters are broadcast from rank 0 once, so Adam steps
  identically on every rank; logits come back gathered, for the whole
  batch.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.distributed as dist

from gnnflow_tpu_torch.parallel.dist_context import (all_gather_cat,
                                                     group_rank, group_size)


class DataParallel:
    """The collectives of a data-parallel step over ``group`` (None: the
    default group; without a running group, one rank and no
    collectives)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = group_rank(group)
        self.world_size = group_size(group)

    def local_arrays(self, arrays):
        """This rank's slice of the global batch ``(target_nodes, ts, eids,
        valid)`` (device tensors), in every one of its blocks."""
        target_nodes, ts, eids, valid = arrays
        B, W = valid.shape[0], self.world_size
        if B % W:
            raise ValueError(f"batch {B} does not divide over {W} ranks; "
                             "round it down to a multiple")
        b = B // W
        lo = self.rank * b
        blocks = target_nodes.shape[0] // B
        sel = (torch.arange(blocks, device=valid.device)[:, None] * B + lo
               + torch.arange(b, device=valid.device)).reshape(-1)
        return (target_nodes[sel], ts[sel], eids[lo: lo + b],
                valid[lo: lo + b])

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if dist.is_initialized():
            dist.all_reduce(t, group=self.group)
        return t

    def reduce_step(self, params, loss: torch.Tensor,
                    take: Optional[int] = None):
        """Sum the gradients, the loss and the layer dedup's take over the
        ranks in one all-reduce, with no host read but the take's.  Every
        rank's step uses the same parameters (one model on one code path;
        a rank without valid rows runs it on padded ones), so the
        parameters that have a gradient agree.  Returns ``(loss, take)``:
        the global loss and the largest take of any rank (None where
        ``take`` is)."""
        params = [p for p in params if p.grad is not None]
        tail = torch.zeros(5, device=loss.device)
        if take is not None:
            tail[take] = 1.0
        tail[4] = loss.detach()
        flat = self._all_reduce(torch.cat(
            [p.grad.reshape(-1) for p in params] + [tail]))
        off = 0
        for p in params:
            p.grad = flat[off: off + p.numel()].view_as(p)
            off += p.numel()
        if take is not None:
            take = int(flat[-5:-1].nonzero().max())
        return flat[-1], take

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss (a sum of the ranks' shares)."""
        return self._all_reduce(loss.detach().reshape(1).clone())[0]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along dim 0, in rank order."""
        return all_gather_cat(t, self.group)

    def gather_write_back(self, last: dict, eids: torch.Tensor,
                          valid: torch.Tensor):
        """The write-back's inputs for the global batch: every rank's
        ``last_updated_*`` rows ``[src | dst | neg]`` (``2 + r`` blocks of
        the rank's ``len(eids)`` edges) in the single-device order
        ``[src_all | dst_all | neg_all]``, and the global eids and valid
        mask."""
        W = self.world_size
        k = last["last_updated_nid"].shape[0] // eids.shape[0]

        def blocks(t):
            g = self.gather(t)
            return g.reshape((W, k, -1) + tuple(t.shape[1:])) \
                .transpose(0, 1).reshape((-1,) + tuple(t.shape[1:]))

        return ({k: blocks(v) for k, v in last.items()},
                self.gather(eids), self.gather(valid))


def shard_trainer(trainer, group=None):
    """Make ``trainer``'s ``train_step`` and ``eval_step`` data parallel
    over ``group`` (see the module doc).  Mutates ``trainer`` in place and
    returns it."""
    if trainer.dedup_factor is not None:
        logging.getLogger(__name__).warning(
            "shard_trainer: disabling explicitly-set dedup_factor=%s "
            "(data-parallel steps run the memory updater per instance, as "
            "the JAX package's do)", trainer.dedup_factor)
        trainer.dedup_factor = None
    trainer._auto["dedup"] = False
    trainer.dp = DataParallel(group)
    if dist.is_initialized():
        src = dist.get_global_rank(group, 0) if group is not None else 0
        with torch.no_grad():
            for p in trainer.model.parameters():
                dist.broadcast(p.data, src, group=group)
        trainer.model.cast_weights()
    return trainer
