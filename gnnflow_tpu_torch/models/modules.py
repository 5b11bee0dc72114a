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

__all__ = ["Linear", "MultiLinear", "TimeEncode", "FusedGRUCell",
           "masked_softmax", "dropout", "TemporalAttentionLayer",
           "EdgePredictor"]


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
    (``modules.py:34-62``)."""

    def __init__(self, in_features: int, out_features: int,
                 gen: torch.Generator):
        super().__init__()
        self.kernel = _uniform((in_features, out_features), in_features, gen)
        self.bias = _uniform((out_features,), in_features, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class MultiLinear(Linear):
    """``concat(parts) @ kernel + bias`` computed as a sum of per-part
    matmuls against row slices of one kernel (``modules.py:65-113``);
    the wide concatenation is never built.  Zero-width parts are skipped.
    Runs in ``compute_dtype`` when set: on the live parameters cast per call
    while autograd records, else on the copies made by
    :meth:`cast_weights`."""

    def __init__(self, in_features: int, out_features: int,
                 gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, gen)
        self.compute_dtype = compute_dtype
        self.cast_weights()

    @torch.no_grad()
    def cast_weights(self) -> None:
        """(Re)make the compute-dtype copies of kernel and bias; call after
        the weights change or move."""
        cd = self.compute_dtype or torch.float32
        self.register_buffer("kernel_c", self.kernel.detach().to(cd), persistent=False)
        self.register_buffer("bias_c", self.bias.detach().to(cd), persistent=False)

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        cd = self.compute_dtype
        if torch.is_grad_enabled():
            kernel, bias = (self.kernel, self.bias) if cd is None \
                else (self.kernel.to(cd), self.bias.to(cd))
        else:
            kernel, bias = self.kernel_c, self.bias_c
        y = None
        off = 0
        for p in parts:
            d = p.shape[-1]
            if d == 0:
                continue
            t = (p if cd is None else p.to(cd)) @ kernel[off:off + d]
            y = t if y is None else y + t
            off += d
        return y + bias


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

    def forward(self, h: torch.Tensor, x: torch.Tensor, dts: torch.Tensor,
                time_enc: TimeEncode) -> torch.Tensor:
        return gru_memory_fused_autograd(
            h, x, dts, self.ih.kernel, self.ih.bias, self.hh.kernel,
            self.hh.bias, time_enc.w, time_enc.b, self.ki, self.kh,
            self.compute_dtype)


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
    f32."""

    def __init__(self, dim_node: int, dim_edge: int, dim_time: int,
                 dim_out: int, num_head: int, gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.0, att_dropout: float = 0.0):
        super().__init__()
        if dim_node <= 0 or dim_time <= 0:
            raise NotImplementedError(
                "attention without node input or time encoding comes with "
                "the TGAT/DySAT slices (ROADMAP.md, modules to port)")
        if dim_out % num_head:
            raise ValueError("dim_out must be a multiple of num_head")
        self.dim_out = dim_out
        self.num_head = num_head
        self.dropout, self.att_dropout = dropout, att_dropout
        self.time_enc = TimeEncode(dim_time)
        self.w_q = MultiLinear(dim_node + dim_time, dim_out, gen,
                               compute_dtype)
        self.w_kv = MultiLinear(dim_node + dim_edge + dim_time, 2 * dim_out,
                                gen, compute_dtype)
        self.w_out = MultiLinear(dim_out + dim_node, dim_out, gen,
                                 compute_dtype)
        self.layer_norm = nn.LayerNorm(dim_out, eps=1e-5)

    def forward(self, mfg: MFG, h_all: torch.Tensor,
                edge_feats: Optional[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, F = mfg.num_dst, mfg.fanout
        h_dst = h_all[:B]
        h_src = h_all[B:].reshape(B, F, -1)
        ef = edge_feats if edge_feats is not None \
            else h_src.new_zeros((B, F, 0))
        tf = self.time_enc(mfg.nbr_dts)
        ztf = self.time_enc(torch.zeros(B, device=h_all.device))
        q = self.w_q([h_dst, ztf])
        kv = self.w_kv([h_src, ef, tf])
        D, H = self.dim_out, self.num_head
        dh = D // H
        if train and self.att_dropout > 0:
            agg = self._attention_plain(q, kv, mfg.nbr_mask, generator)
        else:
            agg = neighborhood_attention_autograd(
                q.reshape(B, H, dh), kv[..., :D].reshape(B, F, H, dh),
                kv[..., D:].reshape(B, F, H, dh),
                mfg.nbr_mask).reshape(B, D)
        rst = self.w_out([agg, h_dst])
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


class EdgePredictor(nn.Module):
    """``out_fc(relu(src_fc(src) + dst_fc(dst)))`` over ``[src | pos |
    neg]`` blocks (``modules.py:504-531``), in f32."""

    def __init__(self, dim_embed: int, gen: torch.Generator):
        super().__init__()
        self.src_fc = Linear(dim_embed, dim_embed, gen)
        self.dst_fc = Linear(dim_embed, dim_embed, gen)
        self.out_fc = Linear(dim_embed, 1, gen)

    def forward(self, h: torch.Tensor):
        b = h.shape[0] // 3
        s = self.src_fc(h[:b])
        return (self.out_fc(torch.relu(s + self.dst_fc(h[b:2 * b]))),
                self.out_fc(torch.relu(s + self.dst_fc(h[2 * b:]))))
