"""The GRU memory updater's per-node gate projections and one gather.

Counterpart of ``gnnflow_tpu/ops/gru_gather.py:50-141``
(``gru_node_gather`` and its custom VJP).  The TGN memory updater runs its
GRU over ``L = B(1+F)`` instances whose memory and mail come from far
fewer node rows.  Matmul-then-gather is the same row math: the gate
projections ``mail @ W_ih[:dr]`` and ``mem @ W_hh`` are computed once per
node, packed with the memory values into one ``[N, 6f + f]`` table in the
compute dtype, and one row gather by instance node id reads them.  The
state is detached, so the only gradients owed are the two kernels':
``dW = X[nids]ᵀ · dgates``, with the raw rows gathered again (cast as in
the forward) and the products summed in f32, never a scatter-add into
node space.  The state's cotangents are dropped.

Plain PyTorch, as the JAX function is XLA: the gathers and products run
on cuBLAS and PyTorch's own kernels.  The JAX package carries the memory
timestamps as bf16 byte lanes of its table (TPU layout); here they stay an
f32 tensor beside it, gathered by the same ids.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


class _NodeGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mem_t, mail_t, mem_ts_t, ki_mail, kh, nids, cdt):
        f3, f = ki_mail.shape[1], kh.shape[0]
        mem_c = mem_t.to(cdt)
        table = torch.cat([mail_t.to(cdt) @ ki_mail.to(cdt),
                           mem_c @ kh.to(cdt), mem_c], 1)
        rows = table[nids]                       # the one row gather
        ctx.save_for_backward(mem_t, mail_t, nids)
        ctx.cdt = cdt
        return (rows[:, :f3], rows[:, f3:2 * f3], rows[:, 2 * f3:],
                mem_ts_t[nids])

    @staticmethod
    def backward(ctx, d_gi, d_gh, _d_mem, _d_ts):
        mem_t, mail_t, nids = ctx.saved_tensors
        cdt = ctx.cdt
        d_ki = d_kh = None
        # compute-dtype operands upcast first: their products are summed in
        # f32, as ``preferred_element_type=f32`` does
        if ctx.needs_input_grad[3] and d_gi is not None:
            x = mail_t.to(cdt)[nids].float()
            d_ki = x.t() @ d_gi.to(cdt).float()
        if ctx.needs_input_grad[4] and d_gh is not None:
            x = mem_t.to(cdt)[nids].float()
            d_kh = x.t() @ d_gh.to(cdt).float()
        return None, None, None, d_ki, d_kh, None, None


def gru_node_gather(mem_t: torch.Tensor, mail_t: torch.Tensor,
                    mem_ts_t: torch.Tensor, ki_mail: torch.Tensor,
                    kh: torch.Tensor, nids: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Gate pre-projection over the node tables, then one gather.

    Args:
        mem_t: [N, f] node memory (f32 or bf16 storage).
        mail_t: [N, dr] node mails.
        mem_ts_t: [N] f32 memory timestamps.
        ki_mail: [dr, 3f] f32, the mail rows of the input-gate kernel.
        kh: [f, 3f] f32 hidden-gate kernel.
        nids: [L] instance node ids, in range.
        compute_dtype: the products' dtype (None: f32); state and kernels
            are cast to it before the products, as the per-instance cell
            casts them, so the gathered rows equal that cell's.

    Returns ``(gi_mail [L, 3f], gh [L, 3f], mem_i [L, f])`` in the compute
    dtype and ``mem_ts_i [L]`` f32, exact.  Only ``ki_mail`` and ``kh``
    get gradients."""
    return _NodeGather.apply(mem_t, mail_t, mem_ts_t, ki_mail, kh, nids,
                             compute_dtype or torch.float32)


def gru_node_gather_ref(mem_t, mail_t, mem_ts_t, ki_mail, kh, nids,
                        compute_dtype=None):
    """Plain per-instance version of :func:`gru_node_gather`: gather the
    rows of ``nids``, then project them; its gradient comes from
    autograd."""
    cdt = compute_dtype or torch.float32
    mem_i = mem_t[nids].to(cdt)
    return (mail_t[nids].to(cdt) @ ki_mail.to(cdt), mem_i @ kh.to(cdt),
            mem_i, mem_ts_t[nids])
