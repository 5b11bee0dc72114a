"""The train and eval steps of TGN streaming link prediction.

Counterpart of ``gnnflow_tpu/train.py``: ``link_pred_loss``
(``:49-65``), ``_gather_rows`` and ``fetch_features`` (``:92-137``), and a
``Trainer`` with ``init_state``, ``train_step`` and ``eval_step``
(``:1200-1265, 1371-1378, 1411-1417``).  A step samples the batch roots'
recent neighbours, gathers edge features, pulls memory rows, runs the
model (GRU memory update, temporal attention, edge predictor) and computes
the loss; a train step then back-propagates and takes an Adam step; both
write memory and mails back, computed with the parameters from before the
step.  PyTorch runs eagerly, so there is no ``jit``.

The exact (nid, ts) memory dedup (``dedup_factor``, ``:861-904``) and its
calibration on the first train step (``:451-623, 719-750``) are ported;
the JAX ``lax.cond`` between the dedup and the per-instance path is a
Python branch on the unique count, one host sync per step.  The
compaction knobs of other model families (``compact_factor``,
``layer_dedup``) come with the TGAT and DySAT slices; the GRU-table path
is an opt-in variant not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import itertools
import logging
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from gnnflow_tpu_torch.common import MFG, resolve_device
from gnnflow_tpu_torch.data import Batch
from gnnflow_tpu_torch.dynamic_graph import DeviceGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.ops.dedup import dedup_instances
from gnnflow_tpu_torch.ops.sampling import sample_hops


@dataclass
class TrainState:
    """Node memory, the optimizer over the model's parameters, the dropout
    generator (on the trainer's device), the count of train steps, and the
    unique (nid, ts) count of the last step's memory dedup (None when the
    step ran without it)."""
    memory: memory_lib.MemoryState
    optimizer: torch.optim.Optimizer
    dropout_gen: torch.Generator
    step: int = 0
    dedup_n_uniq: Optional[int] = None


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor):
    """Elementwise torch BCEWithLogitsLoss, written as the JAX package's."""
    return logits.clamp_min(0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))


def link_pred_loss(pos: torch.Tensor, neg: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Masked ``mean(BCE(pos, 1)) + mean(BCE(neg, 0))`` over valid rows."""
    w = valid.float()[:, None]
    denom = w.sum().clamp_min(1.0)
    return (bce_with_logits(pos, torch.ones_like(pos)) * w).sum() / denom \
        + (bce_with_logits(neg, torch.zeros_like(neg)) * w).sum() / denom


def _gather_rows(table: Optional[torch.Tensor], ids: torch.Tensor,
                 valid: torch.Tensor) -> Optional[torch.Tensor]:
    """Row gather with padded-id masking (invalid rows are zero)."""
    if table is None:
        return None
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1)
    rows = table[flat].reshape(ids.shape + (table.shape[1],))
    return torch.where(valid[..., None], rows, 0.0)


def fetch_features(mfgs: List[List[MFG]],
                   edge_feats: Optional[torch.Tensor]):
    """Per-layer, per-snapshot [B, F, dim_edge] edge features."""
    return [[_gather_rows(edge_feats, m.nbr_eids, m.nbr_mask)
             for m in layer] for layer in mfgs]


def dedup_cap(factor: float, num_all: int) -> int:
    """Rows of the memory dedup's compact table for ``num_all`` instances
    at ``factor`` (``train.py:786-788``): a multiple of 256, at most
    ``num_all``."""
    cap = int(math.ceil(float(factor) * num_all / 256.0))
    return min(cap * 256, num_all)


class Trainer:
    """Runs train and eval steps of a :class:`DGNN` over a
    :class:`DeviceGraph`.  The optimizer is Adam at ``lr`` with optax's
    defaults (``train.py:262``).

    ``dedup_factor`` sizes the compact table of the memory dedup as a
    fraction of the instances (``None``: off).  ``"auto"`` leaves it off
    until :meth:`calibrate` measures the stream, which the first
    :meth:`train_step` does; an explicit value, ``None`` included, is a
    decision calibration keeps (``train.py:168-195, 271-286``)."""

    def __init__(self, model: DGNN, *, fanouts, lr: float = 1e-4,
                 dedup_factor="auto", device="cuda"):
        # one layer: DGNN refuses every other depth
        (self.fanout,) = (int(f) for f in fanouts)
        self.model = model
        self.lr = lr
        self.device = resolve_device(device)
        self._auto_dedup = dedup_factor == "auto"
        self.dedup_factor = None if self._auto_dedup else dedup_factor
        # the model always has memory: calibrate iff the factor is left to it
        self._calibrated = not self._auto_dedup
        self.calibration: Optional[dict] = None

    def init_state(self, num_nodes: int, seed: int = 0) -> TrainState:
        """Zero memory for ``num_nodes`` nodes, a fresh Adam state and a
        dropout generator seeded with ``seed``, on the trainer's device."""
        return TrainState(
            memory=memory_lib.init_memory(
                num_nodes, self.model.dim_memory, self.model.dim_edge,
                self.device),
            optimizer=torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                       betas=(0.9, 0.999), eps=1e-8),
            dropout_gen=torch.Generator(device=self.device).manual_seed(seed))

    def _dedup_cap(self, num_all: int) -> int:
        return dedup_cap(self.dedup_factor, num_all)

    def _mem_input(self, state: TrainState, mfg: MFG):
        """The memory updater's input (``train.py:834-904``): the dedup's
        compact input when the factor is set and the batch's unique pairs
        fit its cap, else the per-instance pull, in bf16 under bf16
        compute when the node table is small next to the instance count
        (``:851-858``; timestamps stay f32).  Records the unique count in
        ``state.dedup_n_uniq``."""
        memory = state.memory
        state.dedup_n_uniq = None
        if self.dedup_factor:
            cap = self._dedup_cap(mfg.num_all)
            uniq_nid, uniq_ts, inv, n_uniq, sidx, rank_sorted = \
                dedup_instances(mfg.all_nodes(), mfg.all_ts(),
                                mfg.all_mask(), cap)
            state.dedup_n_uniq = int(n_uniq)      # the step's host sync
            if state.dedup_n_uniq <= cap:
                return memory_lib.DedupMemoryInput(
                    state=memory, uniq_nids=uniq_nid, uniq_ts=uniq_ts,
                    inv=inv, sidx=sidx, rank_sorted=rank_sorted)
        if self.model.compute_dtype == "bfloat16" \
                and 3 * memory.num_nodes <= mfg.num_all:
            return memory_lib.prepare_input(memory, mfg, torch.bfloat16)
        return memory_lib.prepare_input(memory, mfg)

    @torch.no_grad()
    def _inputs(self, state: TrainState, dg: DeviceGraph,
                edge_feats: Optional[torch.Tensor], batch: Batch):
        """Sample, gather edge features and pull memory rows for a batch:
        ``(mfgs, efs, mem_input, eids, valid)``."""
        dev = self.device
        target_nodes = torch.from_numpy(batch.target_nodes).to(dev)
        ts = torch.from_numpy(batch.ts).to(dev)
        eids = torch.from_numpy(batch.eids).to(dev)
        valid = torch.zeros(batch.batch_size, dtype=torch.bool)
        valid[: batch.num_valid] = True
        valid = valid.to(dev)
        mfgs = sample_hops(dg, target_nodes, ts, fanout=self.fanout)
        efs = fetch_features(mfgs, edge_feats)
        mem_input = self._mem_input(state, mfgs[0][0])
        return mfgs, efs, mem_input, eids, valid

    @torch.no_grad()
    def _write_back(self, state: TrainState, last, edge_feats, eids,
                    valid) -> None:
        # target-edge features for the mails
        tef = _gather_rows(edge_feats, eids, valid)
        memory_lib.update_mem_mail(
            state.memory, last["last_updated_nid"],
            last["last_updated_memory"], last["last_updated_ts"],
            edge_feats=tef, valid=valid)

    def train_step(self, state: TrainState, dg: DeviceGraph,
                   edge_feats: Optional[torch.Tensor], batch: Batch):
        """One train step (``train.py:1371-1378``): forward with dropout,
        loss, backward, an Adam step, then the write-back of memory
        computed with the pre-step parameters.  Updates the model's
        parameters, ``state.memory`` and the optimizer in place and remakes
        the model's compute-dtype weight copies.

        The first call calibrates the memory dedup when that was left to
        it (the JAX ``train_step``; ``eval_step`` never calibrates).

        Returns ``(state, loss, pos_logits [B], neg_logits [B])``,
        detached."""
        self._maybe_auto_calibrate(dg, batch.target_nodes, batch.ts)
        mfgs, efs, mem_input, eids, valid = self._inputs(state, dg,
                                                         edge_feats, batch)
        pos, neg, last = self.model(mfgs, efs, mem_input, train=True,
                                    generator=state.dropout_gen)
        loss = link_pred_loss(pos, neg, valid)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        self.model.cast_weights()
        self._write_back(state, last, edge_feats, eids, valid)
        state.step += 1
        return state, loss.detach(), pos[:, 0].detach(), neg[:, 0].detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, dg: DeviceGraph,
                  edge_feats: Optional[torch.Tensor], batch: Batch):
        """One eval step; updates ``state.memory`` in place.

        Returns ``(state, loss, pos_logits [B], neg_logits [B])``."""
        mfgs, efs, mem_input, eids, valid = self._inputs(state, dg,
                                                         edge_feats, batch)
        pos, neg, last = self.model(mfgs, efs, mem_input)
        loss = link_pred_loss(pos, neg, valid)
        self._write_back(state, last, edge_feats, eids, valid)
        return state, loss, pos[:, 0], neg[:, 0]

    def calibrate(self, dg: DeviceGraph, batches, *, max_batches: int = 3,
                  occ_batches=()) -> dict:
        """Pick ``dedup_factor`` from the measured (nid, ts) uniqueness of
        the memory instances (``train.py:451-513, 539-566, 584-623``).

        Samples up to ``max_batches`` of ``batches`` (batch objects or
        ``(roots, ts)`` pairs) and every ``(roots, ts)`` pair of
        ``occ_batches`` and takes the worst unique fraction ``u``: the
        factor becomes ``round(min(0.35, 2.5u + 0.02), 2)`` when
        ``u <= 0.08`` and None (off) above, if it was left on ``"auto"``.
        Returns ``{"uniq_frac": u, "dedup_factor": factor}``, also kept as
        ``self.calibration``."""
        self._calibrated = True
        fracs = [self._uniq_frac(dg, *(b if isinstance(b, tuple)
                                       else (b.target_nodes, b.ts)))
                 for b in itertools.islice(batches, max_batches)]
        fracs += [self._uniq_frac(dg, r, t) for r, t in occ_batches]
        stats = {"uniq_frac": max(fracs) if fracs else None}
        if fracs and self._auto_dedup:
            # the GRU dedup saves only the GRU gates and the pull; its
            # sort machinery pays only at extreme duplication
            u = stats["uniq_frac"]
            self.dedup_factor = round(min(0.35, 2.5 * u + 0.02), 2) \
                if u <= 0.08 else None
        stats["dedup_factor"] = self.dedup_factor
        self.calibration = stats
        return stats

    @torch.no_grad()
    def _uniq_frac(self, dg: DeviceGraph, roots, ts) -> float:
        """Unique valid (nid, ts bits) pairs of the sampled memory
        instances over all instances."""
        dev = self.device
        m = sample_hops(
            dg, torch.from_numpy(np.asarray(roots, np.int64)).to(dev),
            torch.from_numpy(np.asarray(ts, np.float32)).to(dev),
            fanout=self.fanout)[0][0]
        nid = m.all_nodes().cpu().numpy()
        mts = m.all_ts().cpu().numpy().view(np.int32)
        valid = m.all_mask().cpu().numpy()
        pairs = np.stack([nid[valid], mts[valid]], 1)
        return np.unique(pairs, axis=0).shape[0] / max(nid.size, 1)

    def _maybe_auto_calibrate(self, dg: DeviceGraph, roots, ts) -> None:
        """First-batch calibration (``train.py:719-750``): the batch, and
        the same roots with the batch's timestamps shifted to a third, two
        thirds and the end of the stream, since uniqueness grows as the
        histories do."""
        if self._calibrated:
            return
        ts_arr = np.asarray(ts, np.float32)
        t_hi = float(dg.e_ts.max())
        t_b = float(ts_arr.max())
        probes = [(roots, ts_arr + np.float32(q * t_hi - t_b))
                  for q in (0.33, 0.67, 1.0)]
        stats = self.calibrate(dg, [(roots, ts)], max_batches=1,
                               occ_batches=probes)
        logging.getLogger(__name__).info("auto-calibration: %s", stats)
