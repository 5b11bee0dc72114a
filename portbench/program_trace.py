"""One run of one cell with the program's own tracer on, beside the
benchmark's run:

    python3 -m portbench.program_trace --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

It is ``portbench.run`` with :class:`ProgramWindow` in place of the
harness's window: the program's tracer (``gnnflow_tpu_torch.utils.
profiling``) starts with the window, stops while it is paused and is
read when it stops.  With ``--trace 1`` the window's trace is a
:class:`ProgramTrace`: the breakdown's idle gaps and the device seconds
by span are named by the innermost span open on the host, the program's
spans included; the per-layer metrics of ``program_metrics.json`` (in
``BENCHMARK.json``'s form) are read beside the cell's own; and the
result line adds ``program``: the window's idle seconds by innermost
span, the share of idle time under a span of the program, and the
counters.  With ``--trace 0`` the tracer runs without the profiler, so
its end-to-end numbers against the benchmark's own untraced run give
what the tracer costs.

A program without the tracer runs as under ``portbench.run``, and the
metrics that read the tracer's records find nothing to read.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from portbench import harness, run

METRICS_FILE = os.path.join(harness.HERE, "program_metrics.json")


def _tracing():
    """The program's tracer module, or None where the program has none."""
    try:
        from gnnflow_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "start_tracing") else None


@dataclass
class ProgramTrace(harness.Trace):
    """A traced window with the program's records: its spans ``(name,
    start_ns, end_ns, parent, step)`` and counters, and the window's
    start and end on the same clock."""

    program_spans: List[tuple] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    window_ns: tuple = (0, 0)

    def all_spans(self) -> List[tuple]:
        """The benchmark's spans and the program's, as ``(name,
        start_ns, dur_ns)``."""
        return list(self.spans) + [(n, s, e - s) for n, s, e, _, _
                                   in self.program_spans]

    def _nested(self):
        """Every span as ``(start, end, name, parent)`` in opening order,
        with the parent that encloses it, and the host's timeline as
        ``(start, end, span)`` segments, each naming the innermost span
        open (-1: none).  Spans nest, as the ``with`` blocks of one
        thread do."""
        spans = sorted(((s, s + d, n) for n, s, d in self.all_spans()),
                       key=lambda x: (x[0], -x[1]))
        out, segs, stack, t = [], [], [], None

        def close_until(now):
            nonlocal t
            while stack and out[stack[-1]][1] <= now:
                i = stack.pop()
                end = max(out[i][1], t)
                segs.append((t, end, i))
                t = end

        for s, e, n in spans:
            close_until(s)
            if t is not None and s > t:
                segs.append((t, s, stack[-1] if stack else -1))
            t = s if t is None else max(t, s)
            out.append((s, e, n, stack[-1] if stack else -1))
            stack.append(len(out) - 1)
        close_until(float("inf"))
        return out, [g for g in segs if g[1] > g[0]]

    def by_span(self) -> Dict[str, float]:
        """Device seconds of each operation, by the innermost span open
        on the host at its start that holds the whole operation, and of
        the others (``outside spans``)."""
        spans, segs = self._nested()
        starts = [g[0] for g in segs]
        out: Dict[str, float] = {}
        for _, s, d in self.ops:
            k = bisect.bisect_right(starts, s) - 1
            i = segs[k][2] if k >= 0 and s < segs[k][1] else -1
            while i >= 0 and s + d > spans[i][1]:
                i = spans[i][3]
            name = spans[i][2] if i >= 0 else "outside spans"
            out[name] = out.get(name, 0.0) + d / 1e9
        return out

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The harness's longest gaps between device operations, each
        named by the innermost span open on the host at its start, the
        program's spans included."""
        return harness.Trace(self.window_s, self.ops, self.all_spans(),
                             self.paused).idle_gaps(n)

    def idle_intervals(self) -> List[tuple]:
        """``(start, end)`` of the window's idle time: no device operation
        and no pause."""
        lo, hi = self.window_ns
        busy = sorted([(s, s + d) for _, s, d in self.ops]
                      + [(s, s + d) for s, d in self.paused])
        out, t = [], lo
        for s, e in busy:
            if s > t:
                out.append((t, min(s, hi)))
            t = max(t, e)
            if t >= hi:
                break
        if t < hi:
            out.append((t, hi))
        return [(a, b) for a, b in out if b > a]

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the window by the innermost span open on the
        host, ``outside spans`` where none is."""
        spans, segs = self._nested()
        out: Dict[str, float] = {}
        k = 0
        for a, b in self.idle_intervals():
            while k < len(segs) and segs[k][1] <= a:
                k += 1
            t, j = a, k
            while t < b:
                if j < len(segs) and segs[j][0] <= t:
                    end, i = min(b, segs[j][1]), segs[j][2]
                    j += 1
                else:
                    end = min(b, segs[j][0]) if j < len(segs) else b
                    i = -1
                name = spans[i][2] if i >= 0 else "outside spans"
                out[name] = out.get(name, 0.0) + (end - t) / 1e9
                t = end
        return out

    def program_idle_s(self, names) -> Optional[float]:
        """Idle seconds under the program's spans ``names``; None when the
        program recorded no span."""
        if not self.program_spans or not self.ops:
            return None
        idle = self.idle_by_span()
        return sum(idle.get(n, 0.0) for n in names)

    def host_syncs(self) -> Optional[int]:
        """The program's ``host_sync.*`` counts in the window; None when
        it recorded nothing."""
        if not self.program_spans:
            return None
        return sum(v for k, v in self.counters.items()
                   if k.startswith("host_sync."))

    def summary(self) -> dict:
        """Idle seconds by innermost span, the share of idle time under a
        span of the program, and the counters."""
        idle = self.idle_by_span()
        mine = {n for n, _, _, _, _ in self.program_spans}
        total = sum(idle.values())
        return {"idle_s_by_span": dict(sorted(idle.items(),
                                              key=lambda kv: -kv[1])),
                "idle_s": total,
                "idle_named_pct": 100.0 * sum(
                    v for k, v in idle.items() if k in mine) / total
                if total else None,
                "spans": len(self.program_spans),
                "counters": dict(sorted(self.counters.items()))}


class ProgramWindow(harness.Window):
    """The harness's window with the program's tracer on from
    :meth:`start` to :meth:`stop`, off while the window is paused; in a
    traced run :meth:`trace` adds its records.  Each window started is
    appended to ``started``."""

    def __init__(self, traced: bool, device, started=None):
        super().__init__(traced, device)
        self.tracer = None
        self.window_ns = (0, 0)
        self.started = started
        self.last_trace: Optional[ProgramTrace] = None

    def start(self) -> None:
        super().start()
        prof = _tracing()
        if prof is not None:
            self.tracer = prof.start_tracing()
        self.window_ns = (time.time_ns(), 0)
        if self.started is not None:
            self.started.append(self)

    def stop(self) -> float:
        self.window_ns = (self.window_ns[0], time.time_ns())
        prof = _tracing()
        if prof is not None:
            prof.stop_tracing()
        return super().stop()

    @contextmanager
    def paused(self):
        with super().paused():
            prof = _tracing()
            tracer = prof.stop_tracing() if prof is not None else None
            try:
                yield
            finally:
                if tracer is not None:
                    prof.start_tracing(tracer)

    def trace(self) -> ProgramTrace:
        base = super().trace()
        tr = ProgramTrace(**base.__dict__, window_ns=self.window_ns)
        if self.tracer is not None:
            # a span still open has no end yet
            tr.program_spans = [x for x in self.tracer.spans if x[2] >= x[1]]
            tr.counters = dict(self.tracer.counters)
        self.last_trace = tr
        return tr


def metrics(workload: str) -> List[dict]:
    """The entries of ``program_metrics.json`` that apply to
    ``workload``."""
    return [m for m in harness.load_json(METRICS_FILE)
            if workload in m["workloads"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    cell.per_layer = cell.per_layer + metrics(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    print("card:", run._card(), flush=True)
    started: List[ProgramWindow] = []
    # the loops take their window from the harness when they are loaded
    harness.Window = lambda traced, device: ProgramWindow(traced, device,
                                                          started)
    result = run.execute(run.Ctx(cell, args.seed, args.seconds, args.trace,
                                 "cuda"))
    win = started[-1]
    program = {"tracer": win.tracer is not None}
    if win.tracer is not None:
        program.update(spans=len(win.tracer.spans), steps=win.tracer.steps,
                       counters=dict(sorted(win.tracer.counters.items())))
        if win.last_trace is not None:
            program.update(win.last_trace.summary())
    result["program"] = program
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
