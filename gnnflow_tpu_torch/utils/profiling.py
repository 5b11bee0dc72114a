"""Phase timers, the program's tracer and device memory statistics.

Counterpart of ``gnnflow_tpu/utils/profiling.py``:

- :class:`PhaseTimer`: accumulating wall-clock phases (``sample``,
  ``feature``, ``train``), as the offline script logs them every epoch;
- :class:`Tracer`, :func:`span` and :func:`count`: spans at the
  program's layer boundaries and counters of its host waits, recorded in
  memory while a tracer is started (:func:`start_tracing`) and costing
  one ``None`` check while none is;
- :func:`device_memory_stats`: each CUDA device's allocator statistics.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, List, Optional


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


class Tracer:
    """The spans and counters recorded while this tracer is started.

    ``spans`` holds one ``(name, start_ns, end_ns, parent, step)`` per
    span, in the order they opened: ``parent`` is the index of the span
    that was open around it (-1: none), ``step`` the id of the train or
    eval step it belongs to (-1: none), shared by every span of one step.
    The clock is ``time.time_ns``, the wall clock that ``torch.profiler``
    gives its device timestamps on.  ``counters`` holds integer counts by
    name.  Spans nest as the ``with`` blocks of one thread do."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.counters: Dict[str, int] = {}
        self.steps = 0
        self._open: List[int] = []
        self._step = -1


class _Span:
    __slots__ = ("tracer", "name", "step", "index", "outer_step")

    def __init__(self, tracer: Tracer, name: str, step: bool):
        self.tracer, self.name, self.step = tracer, name, step

    def __enter__(self):
        t = self.tracer
        if self.step:
            self.outer_step = t._step
            t.steps += 1
            t._step = t.steps
        self.index = len(t.spans)
        t.spans.append((self.name, time.time_ns(), 0,
                        t._open[-1] if t._open else -1, t._step))
        t._open.append(self.index)

    def __exit__(self, *exc):
        t = self.tracer
        name, start, _, parent, step = t.spans[self.index]
        t.spans[self.index] = (name, start, time.time_ns(), parent, step)
        t._open.pop()
        if self.step:
            t._step = self.outer_step
        return False


_active: Optional[Tracer] = None
_NO_SPAN = contextlib.nullcontext()


def start_tracing(tracer: Optional[Tracer] = None) -> Tracer:
    """Record spans and counts into ``tracer`` (a new one where None)
    until :func:`stop_tracing`; starting a stopped tracer again goes on
    with its records."""
    global _active
    _active = tracer if tracer is not None else Tracer()
    return _active


def stop_tracing() -> Optional[Tracer]:
    """Stop recording; returns the tracer that was started, if any.  A
    span open across the stop still records its end."""
    global _active
    tracer, _active = _active, None
    return tracer


def span(name: str, step: bool = False):
    """A context that records a span ``name`` while a tracer is started;
    ``step=True`` opens a train or eval step, which gives its spans a new
    step id.  While none is started, the one shared no-op context: no
    clock is read and nothing is allocated."""
    tracer = _active
    if tracer is None:
        return _NO_SPAN
    return _Span(tracer, name, step)


def traced(name: str, step: bool = False):
    """Decorate a function to run inside :func:`span` ``(name, step)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            if _active is None:
                return fn(*args, **kw)
            with _Span(_active, name, step):
                return fn(*args, **kw)
        return run
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a tracer is started.

    ``host_sync.<site>`` counts the host's waits for the device at a
    site: a copy from pageable host memory, a read of a device value.  A
    site counts on every device, the CPU included, so a CPU run reads how
    often the same path waits on a card."""
    tracer = _active
    if tracer is not None:
        tracer.counters[name] = tracer.counters.get(name, 0) + n


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Bytes in use, the device's total and the peak in use, per CUDA
    device, from ``torch.cuda.memory_stats``; empty without CUDA."""
    import torch
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
