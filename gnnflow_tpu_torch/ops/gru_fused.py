"""Fused TimeEncode + GRU memory update (forward).

Counterpart of ``gnnflow_tpu/ops/gru_pallas.py`` (``gru_memory_fused``,
forward only; the backward kernel comes with the training slice).
:func:`gru_memory_fused` launches the CUDA kernel ``csrc/gru_fused.cu``
for CUDA tensors and runs :func:`gru_memory_fused_ref` for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnflow_tpu_torch.ops import _build

_FLOATS = (torch.float32, torch.bfloat16)


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
    h = torch.empty((n, f), dtype=torch.float32, device=dev)
    if n == 0:
        return h
    lib = _lib()
    err = lib.gru_fused_fwd(
        int(mem.dtype == torch.bfloat16), int(cd == torch.bfloat16),
        mem.data_ptr(), mail.data_ptr(), dts.data_ptr(), ki.data_ptr(),
        bi.data_ptr(), kh.data_ptr(), bh.data_ptr(), tw.data_ptr(),
        tb.data_ptr(), h.data_ptr(), n, f, dr, dt,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "gru_fused_fwd")
    gru_memory_fused.launches += 1
    return h


gru_memory_fused.launches = 0


def _lib():
    lib = _build.load("gru_fused")
    if lib.gru_fused_fwd.argtypes is None:
        p = ctypes.c_void_p
        lib.gru_fused_fwd.argtypes = [ctypes.c_int, ctypes.c_int] \
            + [p] * 10 + [ctypes.c_int] * 4 + [p]
        lib.gru_fused_fwd.restype = ctypes.c_int
    return lib
