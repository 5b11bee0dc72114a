"""The static baselines, GraphSAGE and GAT, over padded MFGs.

Counterpart of ``gnnflow_tpu/models/static.py``: ``SAGEConv`` (``:22-69``)
with its three aggregators, ``GATConv`` (``:72-132``) in the factorised
form that never projects the neighbour rows, ``ProductMLPPredictor``
(``:135-147``), ``SAGE`` (``:150-188``) and ``GAT`` (``:191-242``).  The
trainer samples them with ``is_static=True``: roots at the timestamp
``3.4e38``, so every edge of a root's history is a candidate.

Weights are drawn from ``torch.Generator().manual_seed(seed)`` on the CPU
and moved to ``device``; ``compute_dtype="bfloat16"`` runs the products in
bf16 over f32 parameters, through copies made by :meth:`cast_weights`, or
live casts while autograd records (as :class:`~gnnflow_tpu_torch.models.dgnn.DGNN`).
Layers are named ``l{l}h0``, as the DGNN's, and the Flax tree carries
across unchanged (:mod:`gnnflow_tpu_torch.models.weights`).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from gnnflow_tpu_torch.common import MFG, resolve_device
from gnnflow_tpu_torch.models.modules import Linear, MultiLinear, dropout
from gnnflow_tpu_torch.ops.segment_sum import expand_rows_spec

__all__ = ["SAGEConv", "GATConv", "ProductMLPPredictor", "SAGE", "GAT"]


class SAGEConv(nn.Module):
    """GraphSAGE convolution (``dglnn.SAGEConv``): ``mean`` is
    ``fc_self(h_dst) + fc_neigh(Σ m·h_src / max(deg, 1))`` (``fc_neigh``
    without bias); ``gcn`` is ``fc_neigh((Σ m·h_src + h_dst) / (deg + 1))``;
    ``pool`` takes the max over the valid slots of ``relu(fc_pool(h_src))``
    (0 where a destination has none) in place of the mean.  Runs in the
    compute dtype; ``h_all`` is [B·(1+F), dim_in], destinations first."""

    def __init__(self, dim_in: int, dim_out: int, aggregator: str,
                 gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if aggregator not in ("mean", "gcn", "pool"):
            raise ValueError(f"aggregator {aggregator} is not in "
                             f"['mean', 'gcn', 'pool']")
        self.aggregator = aggregator
        self.compute_dtype = compute_dtype
        if aggregator == "pool":
            self.fc_pool = MultiLinear(dim_in, dim_in, gen, compute_dtype)
        if aggregator == "gcn":
            self.fc_neigh = MultiLinear(dim_in, dim_out, gen, compute_dtype)
        else:
            self.fc_self = MultiLinear(dim_in, dim_out, gen, compute_dtype)
            self.fc_neigh = MultiLinear(dim_in, dim_out, gen, compute_dtype,
                                        use_bias=False)

    def forward(self, mfg: MFG, h_all: torch.Tensor) -> torch.Tensor:
        B, F = mfg.num_dst, mfg.fanout
        cd = self.compute_dtype or torch.float32
        h_dst = h_all[:B]
        h_src = h_all[B:].reshape(B, F, -1).to(cd)
        m = mfg.nbr_mask[..., None].to(cd)
        deg = m.sum(1)                                       # [B, 1]
        if self.aggregator == "gcn":
            h_neigh = ((h_src * m).sum(1) + h_dst.to(cd)) / (deg + 1.0)
            return self.fc_neigh([h_neigh])
        if self.aggregator == "mean":
            h_neigh = (h_src * m).sum(1) / deg.clamp_min(1.0)
        else:
            pooled = torch.where(mfg.nbr_mask[..., None],
                                 torch.relu(self.fc_pool([h_src])),
                                 float("-inf"))
            h_neigh = torch.where(deg > 0, pooled.amax(1), 0.0)
        return self.fc_self([h_dst]) + self.fc_neigh([h_neigh])


class GATConv(nn.Module):
    """Graph attention convolution (``dglnn.GATConv``): per head ``h``,
    ``e = LeakyReLU_0.2(a_l·W_h h_dst + a_r·W_h h_src)`` in f32, a softmax
    over the valid slots (a destination without one aggregates to 0),
    attention dropout, and ``Σ_f a·W_h h_src``.  Factorised as the JAX
    layer: ``a_r·W_h h_src = h_src·(W_h a_r)`` and ``Σ_f a·W_h h_src =
    (Σ_f a·h_src) W_h``, so only destination rows are projected.  Feature
    dropout applies to the whole input.  Returns the heads flat, [B,
    H·D]."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int,
                 gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None,
                 feat_drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.dim_out, self.num_heads = dim_out, num_heads
        self.compute_dtype = compute_dtype
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.fc = MultiLinear(dim_in, num_heads * dim_out, gen, compute_dtype,
                              use_bias=False)
        std = math.sqrt(2.0 / (num_heads + dim_out))        # Xavier normal
        self.attn_l = nn.Parameter(
            torch.randn((num_heads, dim_out), generator=gen) * std)
        self.attn_r = nn.Parameter(
            torch.randn((num_heads, dim_out), generator=gen) * std)
        self.cast_weights()

    @torch.no_grad()
    def cast_weights(self) -> None:
        """(Re)make the compute-dtype copies of ``attn_l`` and ``attn_r``
        (``fc`` keeps its own)."""
        cd = self.compute_dtype or torch.float32
        self.register_buffer("attn_l_c", self.attn_l.detach().to(cd),
                             persistent=False)
        self.register_buffer("attn_r_c", self.attn_r.detach().to(cd),
                             persistent=False)

    def forward(self, mfg: MFG, h_all: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, F = mfg.num_dst, mfg.fanout
        H, D = self.num_heads, self.dim_out
        cd = self.compute_dtype or torch.float32
        if train:
            h_all = dropout(h_all, self.feat_drop, generator)
        W, _ = self.fc.weights()
        if torch.is_grad_enabled():
            attn_l, attn_r = self.attn_l.to(cd), self.attn_r.to(cd)
        else:
            attn_l, attn_r = self.attn_l_c, self.attn_r_c
        h_dst = h_all[:B].to(cd)
        h_src = h_all[B:].reshape(B, F, -1).to(cd)
        z_dst = h_dst @ W                                    # [B, H·D]
        mask = mfg.nbr_mask
        outs = []
        for h in range(H):
            lo, hi = h * D, (h + 1) * D
            el = z_dst[:, lo:hi] @ attn_l[h]                 # [B]
            er = h_src @ (W[:, lo:hi] @ attn_r[h])           # [B, F]
            e = torch.nn.functional.leaky_relu((el[:, None] + er).float(),
                                               0.2)
            a = torch.softmax(torch.where(
                mask, e, torch.finfo(torch.float32).min), dim=1)
            a = torch.where(mask, a, 0.0)
            if train:
                a = dropout(a, self.attn_drop, generator)
            xa = (a.to(cd)[:, None, :] @ h_src)[:, 0]        # [B, din]
            outs.append(xa @ W[:, lo:hi])
        return torch.cat(outs, -1) if H > 1 else outs[0]


class ProductMLPPredictor(nn.Module):
    """The link predictor of SAGE and GAT: a 3-layer MLP on ``src * dst``;
    ``fc0`` and ``fc1`` run in the compute dtype, ``fc2`` in f32."""

    def __init__(self, dim: int, gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc0 = MultiLinear(dim, dim, gen, compute_dtype)
        self.fc1 = MultiLinear(dim, dim, gen, compute_dtype)
        self.fc2 = Linear(dim, 1, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc0([x]))
        x = torch.relu(self.fc1([x]))
        return self.fc2(x.float())


class _StaticModel(nn.Module):
    """What SAGE and GAT share: the trainer's view of a model (no memory,
    no edge features, one snapshot), the layer loop with the ``("rows",
    ...)`` expansion between layers, and the predictor on ``src·pos`` and
    ``src·neg``."""

    use_memory = False
    num_snapshots = 1
    dim_edge = 0

    def _setup(self, dim_node: int, dim_embed: int, num_layers: int,
               compute_dtype: Optional[str], seed: int):
        if num_layers < 1:
            raise ValueError("num_layers must be at least 1")
        self.dim_node, self.dim_embed = dim_node, dim_embed
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        self.cd = getattr(torch, compute_dtype) if compute_dtype else None
        return torch.Generator().manual_seed(seed)

    def _finish_setup(self, gen: torch.Generator, device) -> None:
        self.predictor = ProductMLPPredictor(self.dim_embed, gen, self.cd)
        self.to(resolve_device(device))
        self.cast_weights()

    def cast_weights(self) -> None:
        """Remake every submodule's compute-dtype weight copies; call after
        the weights change or move (``load_flax_params`` does)."""
        for m in self.modules():
            if m is not self and hasattr(m, "cast_weights"):
                m.cast_weights()

    def node_feat_dtype(self, train: bool) -> torch.dtype:
        """The dtype the trainer may gather node features in: the compute
        dtype, whose rounding every layer applies first, unless training
        applies feature dropout to the f32 input first (GAT)."""
        return self.cd or torch.float32

    def _layer(self, l: int, mfg: MFG, h: torch.Tensor, train: bool,
               generator) -> torch.Tensor:
        raise NotImplementedError

    def _between(self, h: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _last(self, h: torch.Tensor) -> torch.Tensor:
        return h

    def forward(self, mfgs: List[List[MFG]],
                edge_feats: Optional[list] = None, mem_input=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                expansions=None,
                node_feats: Optional[Sequence[torch.Tensor]] = None,
                return_embed: bool = False):
        """The trainer's arguments in :class:`DGNN`'s order (edge features
        and memory input are unused) and ``node_feats[0]``, the innermost
        MFG's [B·(1+F), dim_node] node features.  ``expansions[l]``, where
        given and not None, is a ``("rows", inv, sidx, rank_sorted)`` spec
        that expands layer ``l``'s compact output to layer ``l + 1``'s
        instances.  Returns ``(pos_logits, neg_logits, None)``, or with
        ``return_embed`` the last layer's rows in f32 and None
        (``static.py:183, 237``)."""
        if node_feats is None or node_feats[0] is None:
            raise ValueError("a static model needs node features")
        h = node_feats[0]
        for l in range(self.num_layers):
            h = self._layer(l, mfgs[l][0], h, train, generator)
            if l == self.num_layers - 1:
                h = self._last(h)
                break
            h = self._between(h)
            if expansions is not None and expansions[l] is not None:
                h = expand_rows_spec(h, expansions[l])
        if return_embed:
            return h.float(), None
        b = h.shape[0] // 3
        src, pos, neg = h[:b], h[b:2 * b], h[2 * b:]
        return self.predictor(src * pos), self.predictor(src * neg), None


class SAGE(_StaticModel):
    """GraphSAGE link prediction (``static.py:150-188``): ``num_layers``
    :class:`SAGEConv` layers of width ``dim_embed`` with ReLU between
    them, then :class:`ProductMLPPredictor`."""

    def __init__(self, dim_node: int, dim_embed: int, num_layers: int = 2,
                 aggregator: str = "mean",
                 compute_dtype: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        super().__init__()
        resolve_device(device)
        gen = self._setup(dim_node, dim_embed, num_layers, compute_dtype,
                          seed)
        self.layers = nn.ModuleDict({f"l{l}h0": SAGEConv(
            dim_node if l == 0 else dim_embed, dim_embed, aggregator, gen,
            self.cd) for l in range(num_layers)})
        self._finish_setup(gen, device)

    def _layer(self, l, mfg, h, train, generator):
        return self.layers[f"l{l}h0"](mfg, h)

    def _between(self, h):
        return torch.relu(h)


class GAT(_StaticModel):
    """GAT link prediction (``static.py:191-242``): ``num_layers``
    :class:`GATConv` layers with ``attn_head[l]`` heads of width
    ``dim_embed``, ELU over the flat heads between them; a last layer of
    more than one head takes the mean over its heads.  Feature and
    attention dropout apply in training, drawn from the generator passed
    to :meth:`forward`."""

    def __init__(self, dim_node: int, dim_embed: int, num_layers: int = 2,
                 attn_head: Sequence[int] = (8, 1), feat_drop: float = 0.0,
                 attn_drop: float = 0.0,
                 compute_dtype: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if num_layers != len(attn_head):
            raise ValueError("length of attn_head must equal num_layers")
        if not (0.0 <= feat_drop < 1.0 and 0.0 <= attn_drop < 1.0):
            raise ValueError("dropout rates must lie in [0, 1)")
        resolve_device(device)
        gen = self._setup(dim_node, dim_embed, num_layers, compute_dtype,
                          seed)
        self.attn_head = tuple(int(h) for h in attn_head)
        self.feat_drop, self.attn_drop = feat_drop, attn_drop
        self.layers = nn.ModuleDict({f"l{l}h0": GATConv(
            dim_node if l == 0 else self.attn_head[l - 1] * dim_embed,
            dim_embed, self.attn_head[l], gen, self.cd, feat_drop, attn_drop)
            for l in range(num_layers)})
        self._finish_setup(gen, device)

    def node_feat_dtype(self, train: bool) -> torch.dtype:
        if train and self.feat_drop > 0:
            return torch.float32
        return super().node_feat_dtype(train)

    def _layer(self, l, mfg, h, train, generator):
        if train and generator is None and (self.feat_drop > 0
                                            or self.attn_drop > 0):
            raise ValueError("training with dropout needs a generator")
        return self.layers[f"l{l}h0"](mfg, h, train, generator)

    def _between(self, h):
        return torch.nn.functional.elu(h)

    def _last(self, h):
        H, D = self.attn_head[-1], self.dim_embed
        if H == 1:
            return h
        # the mean over heads as the JAX layer computes it: a product with
        # the [H·D, D] averaging indicator, in the output's dtype
        i = torch.arange(H * D, device=h.device)
        mean_m = ((i[:, None] % D == torch.arange(D, device=h.device))
                  / H).to(h.dtype)
        return h @ mean_m
