"""Neural modules: linear layers, time encoding, fused GRU cell, temporal
attention and the edge predictor.

Counterpart of ``gnnflow_tpu/models/modules.py`` (``Linear``,
``MultiLinear``, ``TimeEncode``, ``FusedGRUCell``, ``masked_softmax``,
``TemporalAttentionLayer``, ``EdgePredictor``).  Kernels are stored
``[in, out]`` as in the Flax tree, so weights copy across unchanged
(:mod:`gnnflow_tpu_torch.models.weights`).  Initialisation is torch's
default: kernel and bias ``U(+-1/sqrt(fan_in))``, drawn from the
``torch.Generator`` the caller passes.

``compute_dtype`` (e.g. ``torch.bfloat16``) is the matmul dtype; parameters
stay float32, as in the JAX package's mixed precision.  ``MultiLinear``,
while autograd records, casts its live parameters on every call, so
gradients reach them through the cast as in JAX; without autograd (eval)
it reads copies made by ``cast_weights()``.  ``FusedGRUCell``'s kernels
always read such copies, and its autograd function routes their
gradients to the f32 parameters.  ``cast_weights()`` must be called after
the weights change (``Trainer.train_step`` does, after every optimizer
step).

Dropout (:func:`dropout`) draws from a ``torch.Generator`` the caller
passes; the JAX package's draws differ, so parity runs use rate 0.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from gnnflow_tpu_torch.common import MFG
from gnnflow_tpu_torch.ops.attention_fused import (
    masked_softmax, neighborhood_attention_autograd)
from gnnflow_tpu_torch.ops.gru_fused import gru_memory_fused_autograd
from gnnflow_tpu_torch.utils import profiling

__all__ = ["Linear", "MultiLinear", "TimeEncode", "FusedGRUCell",
           "masked_softmax", "dropout", "TemporalAttentionLayer",
           "EdgePredictor", "MLP", "ATTENTION_IMPLS"]

# ``attention_impl`` values of the JAX package (``modules.py:303-305``):
# "xla" and "pallas" both run the fused kernel here, "xla_factorized" the
# factorized attention where its gate holds
ATTENTION_IMPLS = ("xla", "pallas", "xla_factorized")


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout`` in training: keep each value with probability
    ``1 - p`` and scale the kept ones by ``1 / (1 - p)``; rate 0 is the
    identity.  The mask draws from ``generator``, on ``x``'s device."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _uniform(shape, fan_in: int, gen: torch.Generator) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.Parameter(
        (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound)


class Linear(nn.Module):
    """``x @ kernel + bias`` with ``kernel`` [in, out], in f32
    (``modules.py:34-62``); ``use_bias=False`` drops the bias."""

    def __init__(self, in_features: int, out_features: int,
                 gen: torch.Generator, use_bias: bool = True):
        super().__init__()
        self.kernel = _uniform((in_features, out_features), in_features, gen)
        self.bias = _uniform((out_features,), in_features, gen) \
            if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class MultiLinear(Linear):
    """``concat(parts) @ kernel + bias`` computed as a sum of per-part
    matmuls against row slices of one kernel (``modules.py:65-113``);
    the wide concatenation is never built.  Zero-width parts are skipped.
    Runs in ``compute_dtype`` when set: on the live parameters cast per call
    while autograd records, else on the copies made by
    :meth:`cast_weights`."""

    def __init__(self, in_features: int, out_features: int,
                 gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_bias: bool = True):
        super().__init__(in_features, out_features, gen, use_bias)
        self.compute_dtype = compute_dtype
        self.cast_weights()

    @torch.no_grad()
    def cast_weights(self) -> None:
        """(Re)make the compute-dtype copies of kernel and bias; call after
        the weights change or move."""
        cd = self.compute_dtype or torch.float32
        self.register_buffer("kernel_c", self.kernel.detach().to(cd), persistent=False)
        self.register_buffer("bias_c", None if self.bias is None
                             else self.bias.detach().to(cd), persistent=False)

    def weights(self):
        """``(kernel, bias)`` in the compute dtype: live casts of the
        parameters while autograd records, else the copies (bias None
        without one)."""
        if not torch.is_grad_enabled():
            return self.kernel_c, self.bias_c
        cd = self.compute_dtype
        if cd is None:
            return self.kernel, self.bias
        return self.kernel.to(cd), \
            None if self.bias is None else self.bias.to(cd)

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        cd = self.compute_dtype
        kernel, bias = self.weights()
        y = None
        off = 0
        for p in parts:
            d = p.shape[-1]
            if d == 0:
                continue
            t = (p if cd is None else p.to(cd)) @ kernel[off:off + d]
            y = t if y is None else y + t
            off += d
        return y if bias is None else y + bias


class TimeEncode(nn.Module):
    """``cos(dt * w + b)`` with ``w = 1/10^linspace(0, 9, d)``, ``b = 0``
    (``modules.py:251-273``)."""

    def __init__(self, dim_time: int):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(
            1.0 / 10 ** np.linspace(0, 9, dim_time, dtype=np.float32)))
        self.b = nn.Parameter(torch.zeros(dim_time))

    def forward(self, delta_time: torch.Tensor) -> torch.Tensor:
        return torch.cos(delta_time[..., None] * self.w + self.b)


class _GateParams(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 gen: torch.Generator):
        super().__init__()
        self.kernel = _uniform((in_features, out_features), in_features, gen)
        self.bias = _uniform((out_features,), in_features, gen)


class FusedGRUCell(nn.Module):
    """GRU cell (``torch.nn.GRUCell`` math) whose input is ``[mail |
    TimeEncode(dts)]``, run through the fused kernels
    (:func:`~gnnflow_tpu_torch.ops.gru_fused.gru_memory_fused_autograd`):
    ``modules.py:159-229`` with ``impl="pallas"``.  ``ih.kernel`` is
    [dim_mail + dim_time, 3F], ``hh.kernel`` [F, 3F], gate columns
    ``[r | z | n]``.  Gradients reach the parameters only: ``h``, ``x``
    and ``dts`` are state."""

    def __init__(self, fan_in: int, features: int, gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ih = _GateParams(fan_in, 3 * features, gen)
        self.hh = _GateParams(features, 3 * features, gen)
        self.compute_dtype = compute_dtype
        self.cast_weights()

    @torch.no_grad()
    def cast_weights(self) -> None:
        """(Re)make the compute-dtype copies of the two kernels that the
        fused kernel reads; call after the weights change or move."""
        cd = self.compute_dtype or torch.float32
        self.register_buffer("ki", self.ih.kernel.detach().to(cd).contiguous(),
                             persistent=False)
        self.register_buffer("kh", self.hh.kernel.detach().to(cd).contiguous(),
                             persistent=False)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                dts: Optional[torch.Tensor],
                time_enc: Optional[TimeEncode]) -> torch.Tensor:
        """The updated memory [N, F], f32; without a time part
        (``time_enc`` None) the plain cell (:meth:`plain`)."""
        if time_enc is None:
            return self.plain(h, x)
        with profiling.span("memory.gru"):
            return gru_memory_fused_autograd(
                h, x, dts, self.ih.kernel, self.ih.bias, self.hh.kernel,
                self.hh.bias, time_enc.w, time_enc.b, self.ki, self.kh,
                self.compute_dtype)

    def plain(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The cell without a time part, as JAX's ``FusedGRUCell`` computes
        it outside its Pallas kernel (``modules.py:198-229``): operands and
        biases cast to the compute dtype, the gates and ``z * h`` in it,
        the result f32.  No kernel runs: the JAX package's fused kernel
        needs a time part (``:198``).  Gradients reach the parameters
        through autograd (live casts while it records)."""
        cd = self.compute_dtype or torch.float32
        f = self.hh.kernel.shape[0]

        def w(p, copy):
            return p.to(cd) if torch.is_grad_enabled() else copy

        gi = x.to(cd) @ w(self.ih.kernel, self.ki) + self.ih.bias.to(cd)
        gh = h.to(cd) @ w(self.hh.kernel, self.kh) + self.hh.bias.to(cd)
        return gru_gates(gi, gh, h.to(cd), f).float()


def gru_gates(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor,
               f: int) -> torch.Tensor:
    """``torch.nn.GRUCell``'s gate math on the input and hidden gate
    projections ``[r | z | n]`` (``modules.py:220-229``), in their
    dtype."""
    r = torch.sigmoid(gi[:, :f] + gh[:, :f])
    z = torch.sigmoid(gi[:, f:2 * f] + gh[:, f:2 * f])
    n = torch.tanh(gi[:, 2 * f:] + r * gh[:, 2 * f:])
    return (1.0 - z) * n + z * h


class TemporalAttentionLayer(nn.Module):
    """Transformer attention over a padded MFG (``modules.py:289-446`` with
    ``attention_impl="pallas"``).

    Q from ``[h_dst | TE(0)]``; K/V from ``[h_src | edge feat | TE(dt)]``;
    the masked LeakyReLU softmax and weighted V sum run in the fused kernel
    (:func:`~gnnflow_tpu_torch.ops.attention_fused.neighborhood_attention_autograd`),
    except when training with ``att_dropout > 0``: the kernel has no
    dropout, so that case takes the plain attention with dropout on the
    softmax weights (``modules.py:369-370, 424-439``).  Then
    ``w_out([agg | h_dst])``, dropout (training), ReLU and LayerNorm in
    f32.

    Without node input (``dim_node == 0``, TGAT's innermost layer,
    ``modules.py:341-345, 441``) ``h_dst`` is [B, 0]: Q comes from TE(0)
    alone, so every Q row is the same (a contiguous [B, D] product, not a
    broadcast), K/V from ``[edge feat | TE(dt)]``, and ``w_out`` reads
    ``[agg]``.  Without time encoding (``dim_time == 0``, DySAT,
    ``modules.py:336-365``) there is no ``TimeEncode``: Q is ``w_q([h_dst])``,
    or with no node input either a [B, D] block of ones in the compute
    dtype with no ``w_q`` at all; K/V come from ``[h_src | edge feat]``.

    ``attention_impl="xla_factorized"`` with at most 4 heads
    (``modules.py:371-388``) runs :meth:`_attention_factorized` instead:
    K and V are never formed, and the parameters are the same ``w_kv``.
    ``"xla"`` and ``"pallas"`` both take the fused kernel."""

    def __init__(self, dim_node: int, dim_edge: int, dim_time: int,
                 dim_out: int, num_head: int, gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.0, att_dropout: float = 0.0,
                 attention_impl: str = "xla"):
        super().__init__()
        if dim_out % num_head:
            raise ValueError("dim_out must be a multiple of num_head")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        self.factorized = attention_impl == "xla_factorized" \
            and num_head <= 4
        self.dim_node, self.dim_time = dim_node, dim_time
        self.dim_out = dim_out
        self.num_head = num_head
        self.compute_dtype = compute_dtype
        self.dropout, self.att_dropout = dropout, att_dropout
        if dim_time > 0:
            self.time_enc = TimeEncode(dim_time)
        if dim_node + dim_time > 0:
            self.w_q = MultiLinear(dim_node + dim_time, dim_out, gen,
                                   compute_dtype)
        self.w_kv = MultiLinear(dim_node + dim_edge + dim_time, 2 * dim_out,
                                gen, compute_dtype)
        self.w_out = MultiLinear(dim_out + dim_node, dim_out, gen,
                                 compute_dtype)
        self.layer_norm = nn.LayerNorm(dim_out, eps=1e-5)

    def forward(self, mfg: MFG, h_all: Optional[torch.Tensor],
                edge_feats: Optional[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``h_all`` [B * (1 + F), dim_node] (dst rows, then neighbours),
        or None without node input."""
        B, F = mfg.num_dst, mfg.fanout
        dev = mfg.nbr_dts.device
        if self.dim_node > 0:
            h_dst = h_all[:B]
            h_src = h_all[B:].reshape(B, F, -1)
        else:
            h_dst = torch.zeros((B, 0), device=dev)
            h_src = torch.zeros((B, F, 0), device=dev)
        ef = edge_feats if edge_feats is not None \
            else h_src.new_zeros((B, F, 0))
        if self.dim_time > 0:
            tf = self.time_enc(mfg.nbr_dts)
            ztf = self.time_enc(torch.zeros(B, device=dev))
        else:
            tf, ztf = h_src.new_zeros((B, F, 0)), h_dst.new_zeros((B, 0))
        if hasattr(self, "w_q"):
            q = self.w_q([h_dst, ztf])
        else:                 # neither node input nor time: Q is ones
            q = torch.ones((B, self.dim_out), device=dev,
                           dtype=self.compute_dtype or torch.float32)
        D, H = self.dim_out, self.num_head
        dh = D // H
        if self.factorized:
            agg = self._attention_factorized(
                q, [h_src, ef, tf], mfg.nbr_mask,
                train and self.att_dropout > 0, generator)
            rst = self.w_out([agg, h_dst] if self.dim_node > 0 else [agg])
            if train:
                rst = dropout(rst, self.dropout, generator)
            return self.layer_norm(torch.relu(rst).float())
        kv = self.w_kv([h_src, ef, tf])
        with profiling.span("model.attention"):
            if train and self.att_dropout > 0:
                agg = self._attention_plain(q, kv, mfg.nbr_mask, generator)
            else:
                agg = neighborhood_attention_autograd(
                    q.reshape(B, H, dh), kv[..., :D].reshape(B, F, H, dh),
                    kv[..., D:].reshape(B, F, H, dh),
                    mfg.nbr_mask).reshape(B, D)
        rst = self.w_out([agg, h_dst] if self.dim_node > 0 else [agg])
        if train:
            rst = dropout(rst, self.dropout, generator)
        return self.layer_norm(torch.relu(rst).float())

    def _attention_plain(self, q, kv, mask, generator):
        """``modules.py:424-439``: per-head scores from ``q * k`` in the
        compute dtype summed in f32, LeakyReLU(0.2), masked softmax,
        dropout on the weights, then the weighted V sum in the compute
        dtype.  Returns [B, D]."""
        B, F = mask.shape
        D, H = self.dim_out, self.num_head
        dh = D // H
        qk = q[:, None, :] * kv[..., :D]                         # [B, F, D]
        att = qk.float().reshape(B, F, H, dh).sum(-1)            # [B, F, H]
        att = masked_softmax(torch.nn.functional.leaky_relu(att, 0.2),
                             mask[..., None], dim=1)
        att = dropout(att, self.att_dropout, generator)
        att = att.to(qk.dtype).repeat_interleave(dh, dim=-1)    # [B, F, D]
        return (kv[..., D:] * att).sum(1)


    def _attention_factorized(self, q, parts, mask, drop: bool,
                              generator):
        """``modules.py:448-501``: attention without forming K or V.  Per
        head ``h`` and K/V input part ``x_p``, the score adds ``x_p ·
        (q_h @ Wk_p_hᵀ)`` and the output ``(Σ_f a_h · x_p) @ Wv_p_h``; the
        K bias adds ``q_h · bk_h`` to every score and the V bias ``(Σ_f
        a_h) · bv_h``, which is 0 on a row with no valid neighbour.  The
        parts, ``w_kv``'s kernel and bias and ``q`` are in the compute
        dtype; scores go to f32 for the LeakyReLU(0.2) and the masked
        softmax, whose weights (dropout when ``drop``) return to the
        compute dtype.  Returns [B, D]."""
        cd = self.compute_dtype or torch.float32
        D, H = self.dim_out, self.num_head
        dh = D // H
        parts = [p.to(cd) for p in parts if p.shape[-1] > 0]
        kernel, bias = self.w_kv.weights()
        wk, wv, bk, bv = kernel[:, :D], kernel[:, D:], bias[:D], bias[D:]
        q = q.to(cd)
        aggs = []
        for h in range(H):
            lo, hi = h * dh, (h + 1) * dh
            qh = q[:, lo:hi]                                     # [B, dh]
            s = qh @ bk[lo:hi][:, None]                          # [B, 1]
            off = 0
            for p in parts:
                d = p.shape[-1]
                qt = qh @ wk[off:off + d, lo:hi].t()             # [B, d]
                s = s + (p * qt[:, None, :]).sum(-1)             # [B, F]
                off += d
            s = torch.nn.functional.leaky_relu(s.float(), 0.2)
            a = masked_softmax(s, mask, dim=1)
            if drop:
                a = dropout(a, self.att_dropout, generator)
            a = a.to(cd)
            agg = a.sum(1)[:, None] * bv[lo:hi]                  # [B, dh]
            off = 0
            for p in parts:
                d = p.shape[-1]
                xa = (p * a[:, :, None]).sum(1)                  # [B, d]
                agg = agg + xa @ wv[off:off + d, lo:hi]
                off += d
            aggs.append(agg)
        return torch.cat(aggs, -1)


class EdgePredictor(nn.Module):
    """``out_fc(relu(src_fc(src) + dst_fc(dst)))`` over ``[src | pos |
    neg]`` blocks (``modules.py:504-531``), in f32.  With ``neg_ratio``
    r the input is ``[(2+r)·B, d]`` and the source block is tiled r times
    against the ``r·B`` negatives: the negative logits are ``[r·B, 1]``."""

    def __init__(self, dim_embed: int, gen: torch.Generator,
                 neg_ratio: int = 1):
        super().__init__()
        self.neg_ratio = int(neg_ratio)
        self.src_fc = Linear(dim_embed, dim_embed, gen)
        self.dst_fc = Linear(dim_embed, dim_embed, gen)
        self.out_fc = Linear(dim_embed, 1, gen)

    def forward(self, h: torch.Tensor):
        r = self.neg_ratio
        b = h.shape[0] // (2 + r)
        s = self.src_fc(h[:b])
        s_neg = s.repeat(r, 1) if r > 1 else s
        return (self.out_fc(torch.relu(s + self.dst_fc(h[b:2 * b]))),
                self.out_fc(torch.relu(s_neg + self.dst_fc(h[2 * b:]))))


class MLP(nn.Module):
    """The node-classification head (``modules.py:534-544``):
    ``fc2(relu(fc1(x)))``, in f32."""

    def __init__(self, dim_in: int, dim_hid: int, num_class: int,
                 gen: torch.Generator):
        super().__init__()
        self.fc1 = Linear(dim_in, dim_hid, gen)
        self.fc2 = Linear(dim_hid, num_class, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))
