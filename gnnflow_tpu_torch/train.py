"""The eval step of TGN streaming link prediction.

Counterpart of ``gnnflow_tpu/train.py``: ``link_pred_loss``
(``:49-65``), ``_gather_rows`` and ``fetch_features`` (``:92-137``), and a
``Trainer`` with ``init_state`` and ``eval_step`` (``:1200-1265,
1411-1417``).  One eval step samples the batch roots' recent neighbours,
gathers edge features, pulls memory rows, runs the model (GRU memory
update, temporal attention, edge predictor), computes the loss and writes
memory and mails back.  PyTorch runs eagerly, so there is no ``jit``.

Training (backward kernels, Adam, dropout) is the next slice; the dedup,
GRU-table and calibration fast paths of the JAX trainer are not ported.
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
    memory: memory_lib.MemoryState


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
    """Runs eval steps of a :class:`DGNN` over a :class:`DeviceGraph`."""

    def __init__(self, model: DGNN, *, fanouts, device="cuda"):
        # one layer: DGNN refuses every other depth
        (self.fanout,) = (int(f) for f in fanouts)
        self.model = model
        self.device = resolve_device(device)

    def init_state(self, num_nodes: int) -> TrainState:
        """Zero memory for ``num_nodes`` nodes on the trainer's device."""
        return TrainState(memory=memory_lib.init_memory(
            num_nodes, self.model.dim_memory, self.model.dim_edge,
            self.device))

    def _mem_input(self, memory: memory_lib.MemoryState, mfg: MFG):
        # bf16 compute pulls bf16 rows when the node table is small next
        # to the instance count (train.py:851-858); timestamps stay f32
        if self.model.compute_dtype == "bfloat16" \
                and 3 * memory.num_nodes <= mfg.num_all:
            return memory_lib.prepare_input(memory, mfg, torch.bfloat16)
        return memory_lib.prepare_input(memory, mfg)

    @torch.no_grad()
    def eval_step(self, state: TrainState, dg: DeviceGraph,
                  edge_feats: Optional[torch.Tensor], batch: Batch):
        """One eval step; updates ``state.memory`` in place.

        Returns ``(state, loss, pos_logits [B], neg_logits [B])``."""
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
        pos, neg, last = self.model(mfgs, efs, mem_input)
        loss = link_pred_loss(pos, neg, valid)
        # target-edge features for the mails
        tef = _gather_rows(edge_feats, eids, valid)
        memory_lib.update_mem_mail(
            state.memory, last["last_updated_nid"],
            last["last_updated_memory"], last["last_updated_ts"],
            edge_feats=tef, valid=valid)
        return state, loss, pos[:, 0], neg[:, 0]
