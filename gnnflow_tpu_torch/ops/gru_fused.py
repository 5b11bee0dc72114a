"""Fused TimeEncode + GRU memory update, forward and backward.

Counterpart of ``gnnflow_tpu/ops/gru_pallas.py`` (``gru_memory_fused`` and
its custom VJP).  :func:`gru_memory_fused` (K1) and
:func:`gru_memory_fused_bwd` (K2) launch the CUDA kernels of
``csrc/gru_fused.cu`` for CUDA tensors and run their plain versions
(:func:`gru_memory_fused_ref`, :func:`gru_memory_fused_bwd_ref`) for CPU
tensors.  :func:`gru_memory_fused_autograd` joins the two under autograd,
with the TPU op's gradient contract: parameters only.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnflow_tpu_torch.ops import _build

_FLOATS = (torch.float32, torch.bfloat16)

# K2's fixed launch geometry: at most 264 row-tile blocks (two per SM of
# an H100), and the weight-gradient products split the rows in chunks of
# at least 8192 rows, at most 16 chunks.  Both depend only on N, so the
# partial sums, and the gradients, are the same in every run.
_ROW_BLOCKS = 264
_SPLIT_ROWS = 8192
_MAX_SPLITS = 16


def _cd(compute_dtype) -> torch.dtype:
    if compute_dtype is None:
        return torch.float32
    cd = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) \
        else compute_dtype
    if cd not in _FLOATS:
        raise ValueError(f"unsupported compute dtype {compute_dtype!r}")
    return cd


def gru_memory_fused_ref(mem, mail, dts, ki, bi, kh, bh, tw, tb,
                         compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version: ``h' = GRUCell(mem, [mail | cos(dts*tw+tb)])``.

    Matmul operands are rounded to ``compute_dtype`` and multiplied in f32
    (the Pallas kernel's bf16 products with f32 accumulation); biases are
    added in f32 after the products; ``z * mem`` uses mem as it arrived.
    Returns [N, F] float32."""
    cd = _cd(compute_dtype)
    f = mem.shape[1]

    def op(x):
        return x.to(cd).float()

    tf = torch.cos(dts.float()[:, None] * tw.float() + tb.float())
    x = torch.cat([op(mail), op(tf)], dim=1)
    gi = x @ op(ki) + bi.float()
    gh = op(mem) @ op(kh) + bh.float()
    r = torch.sigmoid(gi[:, :f] + gh[:, :f])
    z = torch.sigmoid(gi[:, f:2 * f] + gh[:, f:2 * f])
    n = torch.tanh(gi[:, 2 * f:] + r * gh[:, 2 * f:])
    return (1.0 - z) * n + z * mem.float()


def _check(mem, mail, dts, ki, bi, kh, bh, tw, tb, cd) -> None:
    """The kernels' contract for CUDA tensors (see gru_memory_fused)."""
    n, f = mem.shape
    dr = mail.shape[1]
    dt = tw.shape[0]
    dev = mem.device
    for name, t in (("mail", mail), ("dts", dts), ("ki", ki), ("bi", bi),
                    ("kh", kh), ("bh", bh), ("tw", tw), ("tb", tb)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, mem on {dev}")
    if mem.dtype not in _FLOATS or mail.dtype != mem.dtype:
        raise TypeError(f"mem/mail must share f32 or bf16, got "
                        f"{mem.dtype}/{mail.dtype}")
    if mem.dtype == torch.bfloat16 and cd != torch.bfloat16:
        raise TypeError("bf16 mem/mail need compute_dtype='bfloat16'")
    if dts.dtype != torch.float32:
        raise TypeError(f"dts must be float32, got {dts.dtype}")
    if mail.shape[0] != n or dts.shape != (n,):
        raise ValueError("mem, mail and dts must have N rows")
    if ki.shape != (dr + dt, 3 * f) or kh.shape != (f, 3 * f) \
            or bi.shape != (3 * f,) or bh.shape != (3 * f,) \
            or tb.shape != (dt,):
        raise ValueError("weight shapes do not match mem/mail/tw")
    if ki.dtype != cd or kh.dtype != cd:
        raise TypeError(f"ki/kh must be {cd}, got {ki.dtype}/{kh.dtype}")
    if any(t.dtype != torch.float32 for t in (bi, bh, tw, tb)):
        raise TypeError("bi, bh, tw and tb must be float32")
    if not all(t.is_contiguous() for t in (mem, mail, dts, ki, bi, kh, bh,
                                           tw, tb)):
        raise ValueError("every input must be contiguous")


def gru_memory_fused(mem, mail, dts, ki, bi, kh, bh, tw, tb,
                     compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Fused ``h' = GRUCell(mem, [mail | cos(dts*tw + tb)])``.

    Args:
        mem:  [N, F] memory rows, f32, or bf16 under bf16 compute.
        mail: [N, DR] mails, same dtype as ``mem``.
        dts:  [N] f32 time since each row's last memory update.
        ki:   [DR + DT, 3F] input kernel, rows ``[mail | time]``, gate
              columns ``[r | z | n]``.   bi: [3F] f32.
        kh:   [F, 3F] hidden kernel.      bh: [3F] f32.
        tw, tb: [DT] f32 TimeEncode parameters.
        compute_dtype: matmul operand dtype (None = f32, or "bfloat16").

    Returns [N, F] float32.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (``gru_memory_fused.launches`` counts
    launches), which takes ``ki`` and ``kh`` already in the compute dtype
    and every weight contiguous, so that a call launches nothing else."""
    if mem.device.type == "cpu":
        return gru_memory_fused_ref(mem, mail, dts, ki, bi, kh, bh, tw, tb,
                                    compute_dtype)
    cd = _cd(compute_dtype)
    _check(mem, mail, dts, ki, bi, kh, bh, tw, tb, cd)
    n, f = mem.shape
    h = torch.empty((n, f), dtype=torch.float32, device=mem.device)
    if n == 0:
        return h
    lib = _lib()
    err = lib.gru_fused_fwd(
        int(mem.dtype == torch.bfloat16), int(cd == torch.bfloat16),
        mem.data_ptr(), mail.data_ptr(), dts.data_ptr(), ki.data_ptr(),
        bi.data_ptr(), kh.data_ptr(), bh.data_ptr(), tw.data_ptr(),
        tb.data_ptr(), h.data_ptr(), n, f, mail.shape[1], tw.shape[0],
        torch.cuda.current_stream(mem.device).cuda_stream)
    _build.check(lib, err, "gru_fused_fwd")
    gru_memory_fused.launches += 1
    return h


gru_memory_fused.launches = 0


def gru_memory_fused_bwd_ref(mem, mail, dts, ki, bi, kh, bh, tw, tb, dh,
                             compute_dtype: Optional[str] = None):
    """Plain PyTorch version of the parameter gradients of
    :func:`gru_memory_fused_ref` for ``dh`` [N, F]
    (``gru_pallas.py:_bwd_kernel``).

    The gates are recomputed as in the forward; ``da`` and ``dah`` are f32;
    the weight gradients multiply operands rounded to ``compute_dtype``
    (``[mail | tf]``, mem, da, dah) in f32; the bias sums take the f32
    ``da`` and ``dah``; ``dtf = da kt^T`` (both rounded) feeds
    ``darg = -sin(dts*tw + tb) dtf``.  Returns f32
    ``(dki [DR+DT, 3F], dbi [3F], dkh [F, 3F], dbh [3F], dtw [DT],
    dtb [DT])``."""
    cd = _cd(compute_dtype)
    f = mem.shape[1]
    dr = mail.shape[1]

    def op(x):
        return x.to(cd).float()

    dts = dts.float()
    tf = torch.cos(dts[:, None] * tw.float() + tb.float())
    x = torch.cat([op(mail), op(tf)], dim=1)
    gi = x @ op(ki) + bi.float()
    mem_c = op(mem)
    gh = mem_c @ op(kh) + bh.float()
    r = torch.sigmoid(gi[:, :f] + gh[:, :f])
    z = torch.sigmoid(gi[:, f:2 * f] + gh[:, f:2 * f])
    ghn = gh[:, 2 * f:]
    n = torch.tanh(gi[:, 2 * f:] + r * ghn)

    dh = dh.float()
    dn = dh * (1.0 - z)
    da_n = dn * (1.0 - n * n)
    da_z = dh * (mem.float() - n) * z * (1.0 - z)
    da_r = da_n * ghn * r * (1.0 - r)
    da = torch.cat([da_r, da_z, da_n], dim=1)
    dah = torch.cat([da_r, da_z, da_n * r], dim=1)
    da_c = op(da)
    dki = x.t() @ da_c
    dkh = mem_c.t() @ op(dah)
    dtf = da_c @ op(ki[dr:]).t()
    darg = -torch.sin(dts[:, None] * tw.float() + tb.float()) * dtf
    return (dki, da.sum(0), dkh, dah.sum(0), (darg * dts[:, None]).sum(0),
            darg.sum(0))


def gru_memory_fused_bwd(mem, mail, dts, ki, bi, kh, bh, tw, tb, dh,
                         compute_dtype: Optional[str] = None):
    """Parameter gradients of :func:`gru_memory_fused` for ``dh`` [N, F]
    f32: ``(dki, dbi, dkh, dbh, dtw, dtb)``, all f32 (the TPU kernel's
    ``_call_bwd``).  mem, mail and dts get none: they are state.

    Inputs as for :func:`gru_memory_fused`.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (``gru_memory_fused_bwd.launches``
    counts calls), which sums its partials in a fixed order, so two calls on
    the same inputs give identical gradients."""
    if mem.device.type == "cpu":
        return gru_memory_fused_bwd_ref(mem, mail, dts, ki, bi, kh, bh, tw,
                                        tb, dh, compute_dtype)
    cd = _cd(compute_dtype)
    _check(mem, mail, dts, ki, bi, kh, bh, tw, tb, cd)
    n, f = mem.shape
    dr = mail.shape[1]
    dt = tw.shape[0]
    dev = mem.device
    if dh.device != dev or dh.dtype != torch.float32 or dh.shape != (n, f) \
            or not dh.is_contiguous():
        raise ValueError("dh must be a contiguous float32 [N, F] tensor on "
                         "mem's device")
    k_in = dr + dt
    f32 = dict(dtype=torch.float32, device=dev)
    alloc = torch.empty if n > 0 else torch.zeros   # the kernel fills them
    dk = alloc((k_in + f) * 3 * f, **f32)
    small = alloc(6 * f + 2 * dt, **f32)
    if n > 0:
        tiles = -(-n // 32)
        row_blocks = -(-tiles // -(-tiles // _ROW_BLOCKS))
        splits = max(1, min(_MAX_SPLITS, -(-n // _SPLIT_ROWS)))
        opd = dict(dtype=cd, device=dev)
        ktt = torch.empty((3 * f, dt), **opd)
        d_buf = torch.empty((n, 4 * f), **opd)
        tf_buf = torch.empty((n, dt), **opd)
        part_rows = torch.empty((row_blocks, 6 * f + 2 * dt), **f32)
        part_dk = torch.empty((splits, (k_in + f) * 3 * f), **f32)
        lib = _lib()
        err = lib.gru_fused_bwd(
            int(mem.dtype == torch.bfloat16), int(cd == torch.bfloat16),
            mem.data_ptr(), mail.data_ptr(), dts.data_ptr(), ki.data_ptr(),
            bi.data_ptr(), kh.data_ptr(), bh.data_ptr(), tw.data_ptr(),
            tb.data_ptr(), dh.data_ptr(), ktt.data_ptr(), d_buf.data_ptr(),
            tf_buf.data_ptr(), part_rows.data_ptr(), row_blocks,
            part_dk.data_ptr(), splits, dk.data_ptr(), small.data_ptr(), n,
            f, dr, dt, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "gru_fused_bwd")
        gru_memory_fused_bwd.launches += 1
    f3 = 3 * f
    return (dk[:k_in * f3].view(k_in, f3), small[:f3],
            dk[k_in * f3:].view(f, f3), small[f3:2 * f3],
            small[2 * f3:2 * f3 + dt], small[2 * f3 + dt:])


gru_memory_fused_bwd.launches = 0


class _GRUMemoryFused(torch.autograd.Function):
    """K1 forward, K2 backward; gradients reach the f32 parameters only
    (``gru_pallas.py:33-38``)."""

    @staticmethod
    def forward(ctx, mem, mail, dts, ki, bi, kh, bh, tw, tb, ki_c, kh_c,
                compute_dtype):
        ctx.save_for_backward(mem, mail, dts, ki_c, bi, kh_c, bh, tw, tb)
        ctx.compute_dtype = compute_dtype
        return gru_memory_fused(mem, mail, dts, ki_c, bi, kh_c, bh, tw, tb,
                                compute_dtype)

    @staticmethod
    def backward(ctx, dh):
        mem, mail, dts, ki_c, bi, kh_c, bh, tw, tb = ctx.saved_tensors
        dki, dbi, dkh, dbh, dtw, dtb = gru_memory_fused_bwd(
            mem, mail, dts, ki_c, bi, kh_c, bh, tw, tb, dh.contiguous(),
            ctx.compute_dtype)
        return (None, None, None, dki, dbi, dkh, dbh, dtw, dtb, None, None,
                None)


def gru_memory_fused_autograd(mem, mail, dts, ki, bi, kh, bh, tw, tb, ki_c,
                              kh_c, compute_dtype: Optional[str] = None
                              ) -> torch.Tensor:
    """:func:`gru_memory_fused` differentiable in the parameters.

    ``ki`` and ``kh`` are the f32 parameters, which receive the gradients;
    ``ki_c`` and ``kh_c`` are their copies in the compute dtype, which the
    kernels read.  mem, mail and dts receive no gradient (state)."""
    return _GRUMemoryFused.apply(mem, mail, dts, ki, bi, kh, bh, tw, tb,
                                 ki_c, kh_c, compute_dtype)


def _lib():
    lib = _build.load("gru_fused")
    if lib.gru_fused_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.gru_fused_fwd.argtypes = [i, i] + [p] * 10 + [i] * 4 + [p]
        lib.gru_fused_fwd.restype = i
        lib.gru_fused_bwd.argtypes = [i, i] + [p] * 14 + [i, p, i, p, p] \
            + [i] * 4 + [p]
        lib.gru_fused_bwd.restype = i
    return lib
