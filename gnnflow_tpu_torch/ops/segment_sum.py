"""Sorted segment sum (K4) and the dedup expansion it differentiates.

Counterpart of ``gnnflow_tpu/ops/segment_pallas.py``
(``sorted_segment_sum`` and ``expand_compact`` with its custom VJP,
``:119-205``).  :func:`sorted_segment_sum` launches the CUDA kernel of
``csrc/segment_sum.cu`` for CUDA tensors and runs
:func:`sorted_segment_sum_ref` for CPU tensors.  :func:`expand_compact`
gathers compact rows back to instances; its backward permutes the
cotangents into sorted order and reduces them with K4.

The TPU's 128-lane pad around the expansion (``segment_pallas.py:274-277``,
``memory.py:563-567``) is a lane rule; the kernel takes any width.
``expand_blocks`` and ``expand_rows_spec`` come with the DySAT and TGAT
slices.
"""
from __future__ import annotations

import ctypes

import torch

from gnnflow_tpu_torch.ops import _build


def sorted_segment_sum_ref(dhs: torch.Tensor, seg: torch.Tensor,
                           cap: int) -> torch.Tensor:
    """Plain PyTorch version: ``out[r] = sum of dhs[i] with seg[i] == r``,
    [cap, D] f32.  On the CPU ``index_add_`` adds the rows one after
    another, in the kernel's row order."""
    return dhs.new_zeros(cap, dhs.shape[1]).index_add_(0, seg.long(), dhs)


def sorted_segment_sum(dhs: torch.Tensor, seg: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """Sum the rows of ``dhs`` by segment.

    Args:
        dhs: [L, D] float32, contiguous.
        seg: [L] int32, contiguous, non-decreasing, values in ``[0, cap)``
            (the dense ranks of :func:`~gnnflow_tpu_torch.ops.dedup.dedup_instances`).
        cap: number of output rows.

    Returns [cap, D] float32; a rank that no row carries gives zeros.  CPU
    tensors run the plain version; CUDA tensors launch the kernel
    (``sorted_segment_sum.launches`` counts launches), whose sums run in
    a fixed order without atomics, so two launches give identical bits."""
    if dhs.device.type == "cpu":
        return sorted_segment_sum_ref(dhs, seg, cap)
    if seg.device != dhs.device:
        raise ValueError(f"seg is on {seg.device}, dhs on {dhs.device}")
    if dhs.dtype != torch.float32 or seg.dtype != torch.int32:
        raise TypeError(f"dhs must be float32 and seg int32, got "
                        f"{dhs.dtype}/{seg.dtype}")
    if dhs.dim() != 2 or seg.shape != (dhs.shape[0],):
        raise ValueError(f"dhs must be [L, D] and seg [L], got "
                         f"{tuple(dhs.shape)} and {tuple(seg.shape)}")
    if not (dhs.is_contiguous() and seg.is_contiguous()):
        raise ValueError("dhs and seg must be contiguous")
    L, D = dhs.shape
    if cap < 0 or cap >= 2 ** 31 - 1 or L >= 2 ** 31 - 1:
        raise ValueError(f"cap and L must fit in int32, got {cap}, {L}")
    f32 = dict(dtype=torch.float32, device=dhs.device)
    if L == 0:
        return torch.zeros((cap, D), **f32)
    out = torch.empty((cap, D), **f32)
    if cap == 0 or D == 0:
        return out
    lib = _lib()
    # per-chunk partial sums of the segments that cross chunk edges
    chunks = -(-L // lib.segment_sum_chunk_rows())
    part_first = torch.empty((chunks, D), **f32)
    part_last = torch.empty((chunks, D), **f32)
    err = lib.sorted_segment_sum(
        dhs.data_ptr(), seg.data_ptr(), out.data_ptr(),
        part_first.data_ptr(), part_last.data_ptr(), L, D, cap,
        torch.cuda.current_stream(dhs.device).cuda_stream)
    _build.check(lib, err, "sorted_segment_sum")
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0


class _ExpandCompact(torch.autograd.Function):
    """``up[inv]`` forward (``dedup.py:115-129`` without the 128-lane pad,
    which only steers a TPU gather); the transpose as
    ``segment_pallas.py:189-202``: ``dh[sidx]`` into sorted order, then K4
    over ``rank_sorted``."""

    @staticmethod
    def forward(ctx, up, inv, sidx, rank_sorted):
        ctx.save_for_backward(sidx, rank_sorted)
        ctx.cap = up.shape[0]
        return up[inv]

    @staticmethod
    def backward(ctx, dh):
        sidx, rank_sorted = ctx.saved_tensors
        dhs = dh[sidx].float().contiguous()
        d_up = sorted_segment_sum(dhs, rank_sorted, ctx.cap)
        return d_up.to(dh.dtype), None, None, None


def expand_compact(up: torch.Tensor, inv: torch.Tensor, sidx: torch.Tensor,
                   rank_sorted: torch.Tensor) -> torch.Tensor:
    """``up[inv]`` with the sorted-segment-sum transpose.

    ``up`` [cap, D] compact rows; ``inv`` [L] instance -> compact slot;
    ``sidx`` [L] sorted position -> instance; ``rank_sorted`` [L] int32,
    the non-decreasing compact slot per sorted position (all from
    :func:`~gnnflow_tpu_torch.ops.dedup.dedup_instances`).  Only ``up``
    receives a gradient."""
    return _ExpandCompact.apply(up, inv, sidx, rank_sorted)


def _lib():
    lib = _build.load("segment_sum")
    if lib.sorted_segment_sum.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.sorted_segment_sum.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.sorted_segment_sum.restype = i
        lib.segment_sum_chunk_rows.argtypes = []
        lib.segment_sum_chunk_rows.restype = i
    return lib
