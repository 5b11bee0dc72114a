"""DGNN for the TGN, TGAT, DySAT and APAN configurations.

Counterpart of ``gnnflow_tpu/models/dgnn.py:31-202`` restricted to what
these four run: an optional memory updater (one snapshot; the GRU of TGN
or the transformer of APAN, over one mail slot or several, with node
features added to its output), a
``num_layers x num_snapshots`` grid of temporal attention layers
``l{l}h{h}``, the snapshot combiner (DySAT: an RNN over the snapshots'
embeddings) and the edge predictor, for inference and training.  Between
layers an expansion spec expands a compact layer's output back to the
next layer's instances (``dgnn.py:166-183``): ``("rows", inv, sidx,
rank_sorted)`` from the layer and snapshot dedups, or ``("blocks", rank,
cap, fanout)`` from the block compaction of windowed snapshots.  A
model with memory runs its updater on the innermost MFG, whose output
feeds layer 0 only, over any number of layers.  ``remat_attention``
recomputes each attention layer in the backward pass
(:func:`_remat`), and ``neg_sample_ratio`` sizes the edge predictor's
negative blocks.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gnnflow_tpu_torch.common import MFG, resolve_device
from gnnflow_tpu_torch.models.memory import (GRUMemoryUpdater,
                                             TransformerMemoryUpdater)
from gnnflow_tpu_torch.models.modules import (EdgePredictor, Linear,
                                              TemporalAttentionLayer)
from gnnflow_tpu_torch.ops.segment_sum import expand_blocks, expand_rows_spec


class SimpleRNNCell(nn.Module):
    """The DySAT snapshot combiner (``dgnn.py:31-43``): a tanh RNN cell,
    ``tanh(ih(x) + hh(h))``, with f32 :class:`Linear` layers."""

    def __init__(self, features: int, gen: torch.Generator):
        super().__init__()
        self.ih = Linear(features, features, gen)
        self.hh = Linear(features, features, gen)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.ih(x) + self.hh(h))


class DGNN(nn.Module):
    """Dynamic GNN over padded MFGs (TGN: memory and one attention layer;
    APAN: the same with the transformer memory updater and a mailbox of
    ``mailbox_slots`` slots; TGAT: attention layers without memory, whose
    first takes the node features where ``dim_node > 0``; DySAT: the same
    over S snapshots, without time encoding, and the combiner).

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
                 device="cuda", attention_impl: str = "xla",
                 neg_sample_ratio: int = 1, remat_attention: bool = False):
        super().__init__()
        if use_memory and num_snapshots != 1:
            raise ValueError("memory is not supported for multiple "
                             "snapshots (dgnn.py:72-74)")
        if memory_updater not in ("gru", "transformer"):
            raise ValueError(f"unknown memory updater {memory_updater!r}")
        if mailbox_slots < 1:
            raise ValueError("mailbox_slots must be at least 1")
        if neg_sample_ratio < 1:
            raise ValueError("neg_sample_ratio must be at least 1")
        if use_memory and dim_memory is None:
            raise ValueError("a model with memory needs dim_memory")
        if num_layers < 1 or num_snapshots < 1:
            raise ValueError("num_layers and num_snapshots must be at "
                             "least 1")
        if not (0.0 <= dropout < 1.0 and 0.0 <= att_dropout < 1.0):
            raise ValueError("dropout rates must lie in [0, 1)")
        dev = resolve_device(device)
        cd = getattr(torch, compute_dtype) if compute_dtype else None
        self.dim_node, self.dim_edge = dim_node, dim_edge
        self.use_memory = use_memory
        self.dim_memory = dim_memory if use_memory else None
        self.memory_updater, self.mailbox_slots = memory_updater, mailbox_slots
        self.num_layers, self.num_snapshots = num_layers, num_snapshots
        self.compute_dtype = compute_dtype
        self.dropout, self.att_dropout = dropout, att_dropout
        self.neg_sample_ratio = int(neg_sample_ratio)
        self.remat_attention = bool(remat_attention)
        gen = torch.Generator().manual_seed(seed)
        if use_memory and memory_updater == "gru":
            self.updater = GRUMemoryUpdater(dim_node, dim_edge, dim_time,
                                            dim_memory, gen, cd)
        elif use_memory:
            self.updater = TransformerMemoryUpdater(
                dim_node, dim_edge, dim_time, dim_memory, att_head, gen, cd)
        dim_in = dim_memory if use_memory else dim_node
        self.layers = nn.ModuleDict({f"l{l}h{h}": TemporalAttentionLayer(
            dim_in if l == 0 else dim_embed, dim_edge, dim_time, dim_embed,
            att_head, gen, cd, dropout, att_dropout, attention_impl)
            for l in range(num_layers) for h in range(num_snapshots)})
        if num_snapshots > 1:
            self.combiner = SimpleRNNCell(dim_embed, gen)
        self.edge_predictor = EdgePredictor(dim_embed, gen,
                                            self.neg_sample_ratio)
        self.to(dev)
        self.cast_weights()

    def cast_weights(self) -> None:
        """Remake every submodule's compute-dtype weight copies; call after
        the weights change or move (``load_flax_params`` does)."""
        for m in self.modules():
            if m is not self and hasattr(m, "cast_weights"):
                m.cast_weights()

    def node_feat_dtype(self, train: bool) -> torch.dtype:
        """The dtype the trainer gathers node features in: f32 (the memory
        updater adds them, or their projection, in f32)."""
        return torch.float32

    def forward(self, mfgs: List[List[MFG]],
                edge_feats: List[List[Optional[torch.Tensor]]],
                mem_input: Optional[Dict[str, torch.Tensor]] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                expansions=None,
                node_feats: Optional[List[Optional[torch.Tensor]]] = None,
                return_embed: bool = False):
        """Returns ``(pos_logits, neg_logits, last_updated)``, or with
        ``return_embed`` ``(embed, last_updated)``: the [(2+r)·B,
        dim_embed] roots' embeddings after the snapshot combiner, before
        the edge predictor, in the last layer's output dtype
        (``dgnn.py:199-201``).

        ``mfgs[l][h]`` is layer ``l``'s MFG in snapshot ``h``, innermost
        (deepest) layer first; ``edge_feats[l][h]`` its [B, F, dim_edge]
        edge features; ``mem_input`` the pulled memory rows of the
        innermost MFG's nodes
        (:func:`~gnnflow_tpu_torch.models.memory.prepare_input`), or the
        raw state or the dedup's compact input that the updater pulls from
        itself (None without memory).  ``expansions[l]``, where given and
        not None, expands layer ``l``'s compact output to layer ``l + 1``'s
        instances: a ``("rows", inv, sidx, rank_sorted)`` spec (stacked
        [S, L] per snapshot, or one) or a ``("blocks", rank [S, B], cap,
        fanout)`` spec.  ``node_feats[h]`` is the innermost MFG's [B·(1+F),
        dim_node] node features in snapshot ``h`` (None, or a list of None,
        without node features, and on the memory dedup, whose updater
        gathers them itself): layer 0's input without memory, else added to
        the updater's output (``dgnn.py:155-159``).  ``train=True`` applies
        dropout, drawn from ``generator`` (on the model's device);
        ``last_updated`` is detached, and None without memory.
        """
        if train and (self.dropout > 0 or self.att_dropout > 0) \
                and generator is None:
            raise ValueError("training with dropout needs a generator")
        if expansions is not None and any(
                spec is not None and spec[0] not in ("rows", "blocks")
                for spec in expansions):
            raise ValueError("an expansion spec is ('rows', ...) or "
                             "('blocks', ...)")
        S = self.num_snapshots
        last_updated = None
        h_in = list(node_feats) if node_feats is not None else [None] * S
        if self.use_memory:
            h0, last_updated = self.updater(mfgs[0][0], mem_input, h_in[0])
            h_in = [h0]
        out = []
        for l in range(self.num_layers):
            spec = expansions[l] if expansions is not None else None
            next_h = []
            for h in range(S):
                layer = self.layers[f"l{l}h{h}"]
                args = (mfgs[l][h], h_in[h], edge_feats[l][h], train,
                        generator)
                rst = _remat(layer, *args) \
                    if self.remat_attention and torch.is_grad_enabled() \
                    else layer(*args)
                if l == self.num_layers - 1:
                    out.append(rst)
                    continue
                if spec is not None and spec[0] == "rows":
                    rst = expand_rows_spec(rst, spec, h)
                elif spec is not None:
                    _, rank, cap, fanout = spec
                    rst = expand_blocks(rst, rank[h], cap, fanout)
                next_h.append(rst)
            h_in = next_h
        embed = out[0]
        if S > 1:                    # the RNN over the snapshot axis
            embed = torch.zeros_like(out[0])
            for x in out:
                embed = self.combiner(embed, x)
        if return_embed:
            return embed, last_updated
        pos, neg = self.edge_predictor(embed)
        return pos, neg, last_updated


def _remat(layer: nn.Module, mfg: MFG, h_all, edge_feats, train: bool,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """``layer(mfg, h_all, edge_feats, train, generator)`` under
    ``torch.utils.checkpoint``, ``nn.remat``'s counterpart
    (``dgnn.py:75, 102-105``; ``train`` passed positionally, as the JAX
    site requires): nothing between the inputs and the output is kept, and
    the backward pass runs the layer again, the fused attention kernel
    included.  Dropout draws from the explicit ``generator``, which
    ``preserve_rng_state`` does not cover: its state is taken before the
    forward and set again around the recompute, so both draw the same
    masks, and restored after it."""
    start = generator.get_state() if generator is not None else None
    calls = [0]

    def run(h, ef):
        calls[0] += 1
        if calls[0] == 1 or generator is None:
            return layer(mfg, h, ef, train, generator)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return layer(mfg, h, ef, train, generator)
        finally:
            generator.set_state(after)

    return checkpoint(run, h_all, edge_feats, use_reentrant=False,
                      preserve_rng_state=False)
