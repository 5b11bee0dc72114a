"""DGNN for the TGN and TGAT configurations.

Counterpart of ``gnnflow_tpu/models/dgnn.py:45-202`` restricted to what
TGN and TGAT run: one snapshot, an optional GRU memory updater (TGN), a
stack of temporal attention layers ``l{l}h0`` and the edge predictor, for
inference and training.  Between layers a ``("rows", inv, sidx,
rank_sorted)`` expansion (the trainer's layer dedup) expands a compact
layer's output back to the next layer's instances
(``dgnn.py:166-179``).  Other configurations raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from gnnflow_tpu_torch.common import MFG, resolve_device
from gnnflow_tpu_torch.models.memory import GRUMemoryUpdater
from gnnflow_tpu_torch.models.modules import (EdgePredictor,
                                              TemporalAttentionLayer)
from gnnflow_tpu_torch.ops.segment_sum import expand_compact


class DGNN(nn.Module):
    """Dynamic GNN over padded MFGs (TGN: memory and one attention layer;
    TGAT: attention layers without memory or node input).

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
            "num_snapshots > 1": (num_snapshots != 1, "modules to port, item 8"),
            "memory with more than one layer":
                (use_memory and num_layers != 1, "modules to port, item 5"),
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
        if use_memory and dim_memory is None:
            raise ValueError("a model with memory needs dim_memory")
        if num_layers < 1:
            raise ValueError("num_layers must be at least 1")
        if not (0.0 <= dropout < 1.0 and 0.0 <= att_dropout < 1.0):
            raise ValueError("dropout rates must lie in [0, 1)")
        dev = resolve_device(device)
        cd = getattr(torch, compute_dtype) if compute_dtype else None
        self.dim_node, self.dim_edge = dim_node, dim_edge
        self.use_memory = use_memory
        self.dim_memory = dim_memory if use_memory else None
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        self.dropout, self.att_dropout = dropout, att_dropout
        gen = torch.Generator().manual_seed(seed)
        if use_memory:
            self.updater = GRUMemoryUpdater(dim_edge, dim_time, dim_memory,
                                            gen, cd)
        dim_in = dim_memory if use_memory else dim_node
        self.layers = nn.ModuleDict({f"l{l}h0": TemporalAttentionLayer(
            dim_in if l == 0 else dim_embed, dim_edge, dim_time, dim_embed,
            att_head, gen, cd, dropout, att_dropout)
            for l in range(num_layers)})
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
                mem_input: Optional[Dict[str, torch.Tensor]] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                expansions=None):
        """Returns ``(pos_logits, neg_logits, last_updated)``.

        ``mfgs[l][0]`` is layer ``l``'s MFG, innermost (deepest) first;
        ``edge_feats[l][0]`` its [B, F, dim_edge] edge features;
        ``mem_input`` the pulled memory rows of the innermost MFG's nodes
        (:func:`~gnnflow_tpu_torch.models.memory.prepare_input`; None
        without memory).  ``expansions[l]``, where given and not None, is
        a ``("rows", inv, sidx, rank_sorted)`` spec that expands layer
        ``l``'s compact output to layer ``l + 1``'s instances.
        ``train=True`` applies dropout, drawn from ``generator`` (on the
        model's device); ``last_updated`` is detached, and None without
        memory.
        """
        if train and (self.dropout > 0 or self.att_dropout > 0) \
                and generator is None:
            raise ValueError("training with dropout needs a generator")
        if expansions is not None and any(
                spec is not None and spec[0] != "rows"
                for spec in expansions):
            raise NotImplementedError(
                "block expansions come with the DySAT slice (ROADMAP.md, "
                "modules to port, item 8)")
        h, last_updated = None, None
        if self.use_memory:
            h, last_updated = self.updater(mfgs[0][0], mem_input)
        for l in range(self.num_layers):
            h = self.layers[f"l{l}h0"](mfgs[l][0], h, edge_feats[l][0],
                                       train, generator)
            spec = expansions[l] if expansions is not None else None
            if spec is not None and l < self.num_layers - 1:
                h = expand_compact(h, *spec[1:])
        pos, neg = self.edge_predictor(h)
        return pos, neg, last_updated
