"""Fused masked neighbourhood attention (forward).

Counterpart of ``gnnflow_tpu/ops/attention_pallas.py``
(``neighborhood_attention``, forward; its backward comes with the
training slice).  :func:`neighborhood_attention` launches the CUDA kernel
``csrc/attention_fused.cu`` for CUDA tensors and runs
:func:`neighborhood_attention_ref` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from gnnflow_tpu_torch.ops import _build

_NEG = -1e30


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = 1) -> torch.Tensor:
    """Softmax over ``dim`` with invalid entries excluded; rows with no
    valid entry give all zeros (``modules.py:276-286``, and the fill /
    clamp of ``attention_pallas.py:44-55``)."""
    masked = torch.where(mask, scores, _NEG)
    m = masked.amax(dim=dim, keepdim=True)
    e = torch.exp(masked - m) * mask
    return e / e.sum(dim=dim, keepdim=True).clamp_min(1e-10)


def neighborhood_attention_ref(q, k, v, mask) -> torch.Tensor:
    """Plain PyTorch version (``attention_pallas._reference_impl``).

    q: [B, H, dh]; k, v: [B, F, H, dh]; mask: [B, F] bool.  Scores and the
    weighted sum accumulate in f32 (as the Pallas kernel does); the output
    takes v's dtype."""
    s = (q.float()[:, None] * k.float()).sum(-1)                # [B, F, H]
    att = masked_softmax(torch.nn.functional.leaky_relu(s, 0.2),
                         mask[:, :, None], dim=1)
    return (v.float() * att[..., None]).sum(1).to(v.dtype)


def neighborhood_attention(q, k, v, mask) -> torch.Tensor:
    """Fused masked neighbour attention.

    Args:
        q: [B, H, dh] destination queries.
        k, v: [B, F, H, dh] neighbour keys / values, same dtype as q (f32
            or bf16).  Each (b, f) row of H*dh values must be contiguous;
            rows may be strided (column slices of one K/V projection).
        mask: [B, F] bool validity.

    Returns [B, H, dh] in v's dtype; rows with no valid slot are 0.  CPU
    tensors run the plain version; CUDA tensors launch the kernel
    (``neighborhood_attention.launches`` counts launches)."""
    if q.device.type == "cpu":
        return neighborhood_attention_ref(q, k, v, mask)
    B, F, H, dh = k.shape
    dev = q.device
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share f32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if q.shape != (B, H, dh) or v.shape != k.shape or mask.shape != (B, F):
        raise ValueError("shape mismatch between q, k, v and mask")
    if F > 32 or dh > 128:
        raise ValueError(f"kernel takes F <= 32 and dh <= 128, got "
                         f"F={F}, dh={dh}")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != dh \
                or t.stride(0) != F * t.stride(1):
            raise ValueError(f"{name}: each (b, f) row of H*dh values must "
                             "be contiguous, rows evenly strided")
    if not (q.is_contiguous() and mask.is_contiguous()):
        raise ValueError("q and mask must be contiguous")
    out = torch.empty((B, H, dh), dtype=v.dtype, device=dev)
    if B == 0:
        return out
    lib = _lib()
    err = lib.attention_fwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), mask.data_ptr(), out.data_ptr(), B, F, H, dh,
        k.stride(1), v.stride(1), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "attention_fwd")
    neighborhood_attention.launches += 1
    return out


neighborhood_attention.launches = 0


def _lib():
    lib = _build.load("attention_fused")
    if lib.attention_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.attention_fwd.argtypes = [i, p, p, p, p, p, i, i, i, i,
                                      ctypes.c_longlong, ctypes.c_longlong,
                                      p]
        lib.attention_fwd.restype = ctypes.c_int
    return lib
