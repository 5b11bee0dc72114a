"""Phase timers, profiler traces and device memory statistics.

Counterpart of ``gnnflow_tpu/utils/profiling.py``:

- :class:`PhaseTimer`: accumulating wall-clock phases (``sample``,
  ``feature``, ``train``), as the offline script logs them every epoch;
- :func:`trace`: a ``torch.profiler`` trace of a block, written for
  TensorBoard;
- :func:`device_memory_stats`: each CUDA device's allocator statistics.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    Usage::

        timer = PhaseTimer()
        with timer("sample"):
            ...
        timer.summary()  # {'sample': {'total': ..., 'count': ..., 'mean': ...}}

    The clock is the host's.  CUDA work is asynchronous, so on the card a
    phase times what the host spends dispatching it, unless something in
    the phase waits for the device (a copy to the host, an ``.item()``),
    as the JAX package's timer does."""

    def __init__(self):
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(phase, time.perf_counter() - t0)

    def add(self, phase: str, seconds: float) -> None:
        self._total[phase] += seconds
        self._count[phase] += 1

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total": self._total[k], "count": self._count[k],
                    "mean": self._total[k] / max(self._count[k], 1)}
                for k in self._total}

    def format(self) -> str:
        return " | ".join(f"{k} {v['total']:.3f}s/{v['count']}"
                          for k, v in sorted(self.summary().items()))


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (the CPU, and CUDA where
    there is a card) into a TensorBoard log under ``logdir``; nothing when
    ``logdir`` is None.  A profiler that cannot start raises."""
    if logdir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Bytes in use, the device's total and the peak in use, per CUDA
    device, from ``torch.cuda.memory_stats``; empty without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        }
    return out
