"""Fused masked neighbourhood attention.

Counterpart of ``gnnflow_tpu/ops/attention_pallas.py``
(``neighborhood_attention`` and its custom VJP).
:func:`neighborhood_attention` launches the CUDA kernel
``csrc/attention_fused.cu`` for CUDA tensors and runs
:func:`neighborhood_attention_ref` for CPU tensors;
:func:`neighborhood_attention_autograd` adds the backward, which recomputes
through the plain version as the TPU op's VJP does (``:145-161``: XLA
there, no Pallas kernel).
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
        if _row_stride(t) is None:
            raise ValueError(f"{name}: each (b, f) row of H*dh values must "
                             "be contiguous, rows evenly strided")
    if not (q.is_contiguous() and mask.is_contiguous()):
        raise ValueError("q and mask must be contiguous")
    out = torch.empty((B, H, dh), dtype=v.dtype, device=dev)
    if B == 0:
        return out
    pl = plan(q, k, v, out)
    lib = _lib()
    err = lib.attention_fwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), mask.data_ptr(), out.data_ptr(), B, F, H, dh,
        _row_stride(k), _row_stride(v), *(pl[name] for name in _PLAN_ARGS),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "attention_fwd")
    neighborhood_attention.launches += 1
    return out


neighborhood_attention.launches = 0


class _NeighborhoodAttention(torch.autograd.Function):
    """K3 forward; the backward differentiates the plain version on the
    saved inputs (``attention_pallas.py:150-158``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return neighborhood_attention(q, k, v, mask)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask = ctx.saved_tensors
        neighborhood_attention_autograd.backward_calls += 1
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = neighborhood_attention_ref(q, k, v, mask)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None


def neighborhood_attention_autograd(q, k, v, mask) -> torch.Tensor:
    """:func:`neighborhood_attention` with gradients for q, k and v; rows
    with no valid slot get zero gradients.
    ``neighborhood_attention_autograd.backward_calls`` counts backward
    passes."""
    return _NeighborhoodAttention.apply(q, k, v, mask)


neighborhood_attention_autograd.backward_calls = 0


# dynamic shared memory a block of the staged path may take (kMaxSmem in
# the kernel), its warps, and the destinations a staged warp takes in turn
_SMEM_BUDGET = 200 * 1024
_MAX_WARPS = 4
_DESTS_PER_WARP = 4
_PLAN_ARGS = ("lanes_per_head", "staged", "fused", "w_kv", "w_q", "pitch",
              "v_off", "q_pitch", "slots", "slot_groups", "warps", "smem",
              "blocks")
# the kernel's unrolled slot widths: 10 is the TGN main path's fanout
_SLOTS = (8, 10, 16, 32)


def _row_stride(t):
    """Elements from one (b, f) row of ``t`` [B, F, H, dh] to the next, or
    None unless each row's H*dh values are contiguous and the rows evenly
    strided.  Strides of dimensions of size 1 do not matter: a view may
    give them any value."""
    B, F, H, dh = t.shape
    if (dh > 1 and t.stride(3) != 1) or (H > 1 and t.stride(2) != dh):
        return None
    row = t.stride(1) if F > 1 else t.stride(0) if B > 1 else H * dh
    if B > 1 and F > 1 and t.stride(0) != F * row:
        return None
    return row


def _pow2(n: int) -> int:
    """The least power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


def _lanes(dh: int, cols: int, heads: int) -> int:
    """Lanes a head takes: a power of two holding dh columns at ``cols`` a
    lane, and, where ``heads`` heads leave lanes of the warp idle, more
    (up to 32 / heads, rounded to a power of two)."""
    return max(_pow2(-(-dh // cols)), 32 // min(_pow2(heads), 32))


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def _widest(*values: int) -> int:
    """The widest copy, 16, 8 or 4 bytes, that divides every value (byte
    addresses, strides, sizes); 0 when none does."""
    return next((w for w in (16, 8, 4) if all(x % w == 0 for x in values)),
                0)


def plan(q, k, v, out) -> dict:
    """Path and shared-memory layout of K3 (``csrc/attention_fused.cu``)
    for these tensors, from their shapes, strides and addresses.

    - ``slot_groups``: 2 where two groups of 16 lanes, each holding
      every head at 8 columns a lane, can split the slots (staged, bf16,
      dh even, as on the TGN main path), else 1.
    - ``lanes_per_head``: the G lanes a head takes in a group of 32 /
      slot_groups lanes, a power of two holding dh columns at 4 *
      slot_groups a lane and, when heads are few, more.
    - ``fused``: v's rows follow k's in one row of 2*H*dh values (the
      layer's fused K/V projection), so one copy a slot fetches both.
    - ``w_kv``, ``w_q``: the widest copy (16, 8 or 4 bytes) that the k|v
      rows, and the q and out rows, allow.
    - ``staged``: both widths are at least 4, F > 0 and two stages of a
      warp (q row and ``slots`` slot rows) fit the budget; otherwise the
      direct path.
    - ``slots``: the kernel's unrolled slot width, the least of 8, 10,
      16 and 32 that holds F; a stage has that many slot rows.
    Byte sizes: ``pitch`` of a staged slot row and ``q_pitch``; ``v_off``
    in elements; ``warps`` a block, its dynamic shared memory ``smem``,
    and the grid's ``blocks``: a staged warp takes up to 4 destinations in
    turn, a direct one 1."""
    B, F, H, dh = k.shape
    es = k.element_size()
    row = H * dh * es
    k_row, v_row = _row_stride(k), _row_stride(v)
    fused = v.data_ptr() == k.data_ptr() + row and v_row == k_row
    kv = [k.data_ptr(), k_row * es]
    if fused:
        kv.append(2 * row)
        pitch, v_off = _ceil16(2 * row), H * dh
    else:
        kv += [row, v.data_ptr(), v_row * es]
        pitch, v_off = _ceil16(_ceil16(row) + row), _ceil16(row) // es
    w_kv = _widest(*kv)
    w_q = _widest(q.data_ptr(), out.data_ptr(), row)
    q_pitch = _ceil16(row)
    slots = next(n for n in _SLOTS if n >= F)
    per_warp = 2 * (q_pitch + slots * pitch)
    warps = min(_MAX_WARPS, _SMEM_BUDGET // per_warp)
    staged = w_kv >= 4 and w_q >= 4 and warps >= 1 and F > 0
    if not staged:
        warps = _MAX_WARPS
    # two slot groups of 16 lanes where a group holds every head at 8
    # columns a lane (two-value loads, so staged and dh even); in bf16
    # only: in f32 the wider lanes cost more (registers, 8-byte loads)
    # than the shuffles they save (measured on the H100)
    sg = 2 if (staged and dh % 2 == 0 and es == 2
               and _pow2(-(-dh // 8)) * _pow2(H) <= 16) else 1
    per_block = warps * (_DESTS_PER_WARP if staged else 1)
    return dict(lanes_per_head=_lanes(dh, 4 * sg, H * sg),
                staged=int(staged), fused=int(fused),
                w_kv=w_kv, w_q=w_q, pitch=pitch, v_off=v_off,
                q_pitch=q_pitch, slots=slots, slot_groups=sg, warps=warps,
                smem=warps * per_warp if staged else 0,
                blocks=-(-B // per_block))


def _lib():
    lib = _build.load("attention_fused")
    if lib.attention_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.attention_fwd.argtypes = [i, p, p, p, p, p, i, i, i, i,
                                      ctypes.c_longlong, ctypes.c_longlong,
                                      *[i] * (len(_PLAN_ARGS) - 1),
                                      ctypes.c_longlong, p]
        lib.attention_fwd.restype = ctypes.c_int
    return lib
