"""DGNN for the TGN configuration.

Counterpart of ``gnnflow_tpu/models/dgnn.py:45-202`` restricted to what
TGN runs: GRU memory updater, one temporal attention layer, one snapshot
and the edge predictor, for inference and training.  Other configurations
raise ``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from gnnflow_tpu_torch.common import MFG, resolve_device
from gnnflow_tpu_torch.models.memory import GRUMemoryUpdater
from gnnflow_tpu_torch.models.modules import (EdgePredictor,
                                              TemporalAttentionLayer)


class DGNN(nn.Module):
    """Dynamic GNN over padded MFGs (TGN: memory + one attention layer).

    Weights are drawn from ``torch.Generator().manual_seed(seed)`` on the
    CPU (so every device gets the same weights) and moved to ``device``.
    ``compute_dtype="bfloat16"`` runs matmuls in bf16 over f32 params,
    through bf16 copies of the weights (:meth:`cast_weights`), except the
    linear layers under autograd, which cast the live parameters."""

    def __init__(self, dim_node: int, dim_edge: int, dim_time: int,
                 dim_embed: int, num_layers: int, num_snapshots: int,
                 att_head: int, dropout: float, att_dropout: float,
                 use_memory: bool, dim_memory: Optional[int] = None,
                 memory_updater: str = "gru", mailbox_slots: int = 1,
                 compute_dtype: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        super().__init__()
        unsupported = {
            "use_memory=False (TGAT, DySAT)":
                (not use_memory, "modules to port, items 7-8"),
            "num_snapshots > 1": (num_snapshots != 1, "modules to port, item 8"),
            "num_layers > 1": (num_layers != 1, "modules to port, item 7"),
            "the transformer memory updater (APAN)":
                (memory_updater != "gru", "modules to port, item 9"),
            "mailbox_slots > 1": (mailbox_slots != 1, "modules to port, item 9"),
            "node features (dim_node > 0)":
                (dim_node != 0, "modules to port, item 10"),
        }
        for what, (bad, item) in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP.md, {item})")
        if dim_memory is None:
            raise ValueError("TGN needs dim_memory")
        if not (0.0 <= dropout < 1.0 and 0.0 <= att_dropout < 1.0):
            raise ValueError("dropout rates must lie in [0, 1)")
        dev = resolve_device(device)
        cd = getattr(torch, compute_dtype) if compute_dtype else None
        self.dim_node, self.dim_edge = dim_node, dim_edge
        self.dim_memory = dim_memory
        self.compute_dtype = compute_dtype
        self.dropout, self.att_dropout = dropout, att_dropout
        gen = torch.Generator().manual_seed(seed)
        self.updater = GRUMemoryUpdater(dim_edge, dim_time, dim_memory, gen,
                                        cd)
        self.layers = nn.ModuleDict({"l0h0": TemporalAttentionLayer(
            dim_memory, dim_edge, dim_time, dim_embed, att_head, gen, cd,
            dropout, att_dropout)})
        self.edge_predictor = EdgePredictor(dim_embed, gen)
        self.to(dev)
        self.cast_weights()

    def cast_weights(self) -> None:
        """Remake every submodule's compute-dtype weight copies; call after
        the weights change or move (``load_flax_params`` does)."""
        for m in self.modules():
            if m is not self and hasattr(m, "cast_weights"):
                m.cast_weights()

    def forward(self, mfgs: List[List[MFG]],
                edge_feats: List[List[Optional[torch.Tensor]]],
                mem_input: Dict[str, torch.Tensor],
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                expansions=None):
        """Returns ``(pos_logits, neg_logits, last_updated)``.

        ``mfgs[0][0]`` is the (only) layer; ``edge_feats[0][0]`` its
        [B, F, dim_edge] edge features; ``mem_input`` the pulled memory
        rows of its nodes (:func:`~gnnflow_tpu_torch.models.memory.prepare_input`).
        ``train=True`` applies dropout, drawn from ``generator`` (on the
        model's device); ``last_updated`` is detached either way.
        """
        if train and (self.dropout > 0 or self.att_dropout > 0) \
                and generator is None:
            raise ValueError("training with dropout needs a generator")
        if expansions is not None:
            raise NotImplementedError(
                "model compaction comes with the DySAT slice "
                "(ROADMAP.md, modules to port, item 8)")
        h0, last_updated = self.updater(mfgs[0][0], mem_input)
        embed = self.layers["l0h0"](mfgs[0][0], h0, edge_feats[0][0], train,
                                    generator)
        pos, neg = self.edge_predictor(embed)
        return pos, neg, last_updated
