"""The APAN memory updater's pre-projected K/V pull.

Counterpart of ``gnnflow_tpu/ops/apan_kv.py:48-128`` (``apan_table_pull``
and its custom VJP).  The mail part of the updater's K/V projection is
computed once per (node, slot) over the ``[N·S, dr]`` mailbox, which is
far smaller than the ``L`` instances that read it, and one gather by
instance node id then reads the projected rows with the node memory:
``mails[nids] @ W == (mails @ W)[nids]`` row for row.  The mailbox is
detached state, so the only gradient owed is the mail rows' of the
kernel, ``dW = Σ_{L,S} mails[nids]ᵀ · d_kv``, taken in f32 without a
scatter-add.

Plain PyTorch, as the JAX function is XLA; :func:`apan_table_pull_ref`
is the per-instance order (gather, then project) that the tests hold it
against.  The JAX package carries the timestamps as bf16 byte lanes of
its table (TPU layout); here they stay an f32 tensor beside it.

Over memory sharded across the ranks of a process group
(:func:`apan_table_pull_sharded`) no rank holds the table: each rank
projects its own block of mailbox rows and serves the projected rows to
the ranks that ask for them, through one routed exchange of the ids and
one of the rows; in the backward pass the K/V gradients travel back to
the rows' owners, and each rank takes the mail rows' ``dW`` of the rows
it owns, which the data-parallel all-reduce of the gradients then sums.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


class _TablePull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mem_cols, mails, mail_ts, kernel_mail, nids, cdt):
        N, S, dr = mails.shape
        dm, f2 = mem_cols.shape[1], kernel_mail.shape[1]
        kv = mails.reshape(N * S, dr).to(cdt) @ kernel_mail.to(cdt)
        table = torch.cat([mem_cols.to(cdt), kv.reshape(N, S * f2)], 1)
        rows = table[nids]                       # the one row gather
        ctx.save_for_backward(mails, nids)
        ctx.cdt = cdt
        return (rows[:, :dm], rows[:, dm:].reshape(-1, S, f2),
                mail_ts[nids])

    @staticmethod
    def backward(ctx, _d_mem, d_kv, _d_ts):
        mails, nids = ctx.saved_tensors
        dW = None
        if ctx.needs_input_grad[3] and d_kv is not None:
            dr, f2 = mails.shape[2], d_kv.shape[2]
            # the compute-dtype operands upcast first: their products are
            # then summed in f32, as ``preferred_element_type=f32`` does
            x = mails.to(ctx.cdt)[nids].reshape(-1, dr).float()
            dW = x.t() @ d_kv.reshape(-1, f2).float()
        return None, None, None, dW, None, None


def apan_table_pull(mem_cols: torch.Tensor, mails: torch.Tensor,
                    mail_ts: torch.Tensor, kernel_mail: torch.Tensor,
                    nids: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pull the memory and the mail-projected K/V rows of ``nids``.

    Args:
        mem_cols: [N, dm] f32 node memory.
        mails: [N, S, dr] f32 mailbox.
        mail_ts: [N, S] f32 mail timestamps.
        kernel_mail: [dr, 2·dm] f32, the mail rows of the updater's
            ``w_kv`` kernel; the only input that gets a gradient.
        nids: [L] instance node ids, in range.
        compute_dtype: the projection's dtype (None: f32).  Its result is
            rounded to it in the table, as the JAX function's is.

    Returns ``(mem_i [L, dm], kv_i [L, S, 2·dm])`` in the compute dtype
    and ``mail_ts_i [L, S]`` f32, exact."""
    return _TablePull.apply(mem_cols, mails, mail_ts, kernel_mail, nids,
                            compute_dtype or torch.float32)


class _ShardedTablePull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mem_cols, mails, mail_ts, kernel_mail, nids, cdt,
                shard):
        from gnnflow_tpu_torch.parallel.dist_context import Route
        R, S, dr = mails.shape
        f2 = kernel_mail.shape[1]
        route = Route(torch.div(nids, shard.rows_per_rank,
                                rounding_mode="floor"), shard.group)
        req = route.send(nids) - shard.lo
        kv = mails.reshape(R * S, dr).to(cdt) @ kernel_mail.to(cdt)
        rows = torch.cat([mem_cols.to(cdt), kv.reshape(R, S * f2)], 1)[req]
        dm = mem_cols.shape[1]
        w = (dm + S * f2) * rows.element_size()
        got = route.back(torch.cat([rows.view(torch.uint8),
                                    mail_ts[req].view(torch.uint8)], 1))
        rows = got[:, :w].contiguous().view(cdt)
        ctx.save_for_backward(mails, req)
        ctx.route, ctx.cdt = route, cdt
        return (rows[:, :dm], rows[:, dm:].reshape(-1, S, f2),
                got[:, w:].contiguous().view(torch.float32))

    @staticmethod
    def backward(ctx, _d_mem, d_kv, _d_ts):
        mails, req = ctx.saved_tensors
        dr, f2 = mails.shape[2], d_kv.shape[2]
        # every rank sends its instances' K/V gradients to the rows'
        # owners (a collective, so every rank runs it) and takes the dW
        # of the rows it owns
        got = ctx.route.send(d_kv.reshape(d_kv.shape[0], -1).contiguous())
        x = mails.to(ctx.cdt)[req].reshape(-1, dr).float()
        dW = x.t() @ got.reshape(-1, f2).float()
        return None, None, None, dW, None, None, None


def apan_table_pull_sharded(mem_cols: torch.Tensor, mails: torch.Tensor,
                            mail_ts: torch.Tensor, kernel_mail: torch.Tensor,
                            nids: torch.Tensor, shard,
                            compute_dtype: Optional[torch.dtype] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """:func:`apan_table_pull` over memory sharded across a process group:
    ``mem_cols``, ``mails`` and ``mail_ts`` are this rank's block of
    rows, ``shard`` says where it lies (``group``, ``lo``,
    ``rows_per_rank``: a
    :class:`~gnnflow_tpu_torch.models.memory.MemoryShard`) and ``nids``
    are global ids, in range.  A collective, forward and backward: every
    rank calls it, with any number of ids.  Returns what
    :func:`apan_table_pull` returns for ``nids``; the kernel's gradient
    on each rank is that of the rows it owns, so the gradients' sum over
    the ranks is the whole ``dW``."""
    return _ShardedTablePull.apply(mem_cols, mails, mail_ts, kernel_mail,
                                   nids, compute_dtype or torch.float32,
                                   shard)


def apan_table_pull_ref(mem_cols, mails, mail_ts, kernel_mail, nids,
                        compute_dtype=None):
    """Plain per-instance version of :func:`apan_table_pull`: gather the
    rows of ``nids``, then project each instance's mails; its gradient
    comes from autograd."""
    cdt = compute_dtype or torch.float32
    return (mem_cols[nids].to(cdt),
            mails[nids].to(cdt) @ kernel_mail.to(cdt), mail_ts[nids])
