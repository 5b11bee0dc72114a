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

The dedup, GRU-table and calibration fast paths of the JAX trainer are
not ported: at TGN's config it takes none of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from gnnflow_tpu_torch.common import MFG, resolve_device
from gnnflow_tpu_torch.data import Batch
from gnnflow_tpu_torch.dynamic_graph import DeviceGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.ops.sampling import sample_hops


@dataclass
class TrainState:
    """Node memory, the optimizer over the model's parameters, the dropout
    generator (on the trainer's device) and the count of train steps."""
    memory: memory_lib.MemoryState
    optimizer: torch.optim.Optimizer
    dropout_gen: torch.Generator
    step: int = 0


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


class Trainer:
    """Runs train and eval steps of a :class:`DGNN` over a
    :class:`DeviceGraph`.  The optimizer is Adam at ``lr`` with optax's
    defaults (``train.py:262``)."""

    def __init__(self, model: DGNN, *, fanouts, lr: float = 1e-4,
                 device="cuda"):
        # one layer: DGNN refuses every other depth
        (self.fanout,) = (int(f) for f in fanouts)
        self.model = model
        self.lr = lr
        self.device = resolve_device(device)

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

    def _mem_input(self, memory: memory_lib.MemoryState, mfg: MFG):
        # bf16 compute pulls bf16 rows when the node table is small next
        # to the instance count (train.py:851-858); timestamps stay f32
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
        mem_input = self._mem_input(state.memory, mfgs[0][0])
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

        Returns ``(state, loss, pos_logits [B], neg_logits [B])``,
        detached."""
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
