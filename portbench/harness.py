"""What every cell shares: the benchmark's specification, the files a cell
names, the window and its spans, the traced run's profile, and the result
line.

A cell in ``BENCHMARK.json`` names a configuration and a traffic mix.  The
configuration is ``configs/<name>.json``; the traffic mix is
``traffic/<name>.json``, whose ``loop`` names the general driver in
``loops/`` that generates and serves it; a cell's limits are
``limits/<cell>.json``; a per-layer metric is ``metrics/<name>.py``, whose
``read(trace)`` gives its value or None; a configuration's ``counts``
names the module in ``counts/`` that counts the work its steps need.  So a
new cell, configuration, traffic mix or metric is new files and entries.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# published NVIDIA H100 SXM peaks (data sheet, dense), as the program's
# chip_smoke.py holds them at commit e51abea
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "gnnflow_tpu")


def least_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time of a piece of work on the card: the larger of its
    bytes over the memory's peak and its operations over the compute
    peak (chip_smoke.py's ``_bound``, in seconds)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    here: str = HERE


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files and
    the metrics it reports."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, "portbench")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if applies(m)
                 and m["moves"] in names]
    return Cell(name, load_json(os.path.join(root, conf["file"])),
                load_json(os.path.join(here, "traffic",
                                       w["traffic"] + ".json")),
                load_json(os.path.join(here, "limits", name + ".json")),
                int(w["chips"]), e2e, per_layer, here)


def loop_module(cell: Cell):
    return load_module(os.path.join(cell.here, "loops",
                                    cell.traffic["loop"] + ".py"),
                       "portbench_loop_" + cell.traffic["loop"])


def counts_module(cell: Cell):
    name = cell.config["counts"]
    return load_module(os.path.join(cell.here, "counts", name + ".py"),
                       "portbench_counts_" + name)


def read_metric(cell: Cell, name: str, trace) -> Optional[float]:
    mod = load_module(os.path.join(cell.here, "metrics", name + ".py"),
                      "portbench_metric_" + name.replace(".", "_"))
    return mod.read(trace)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_probe(device, mib: int = 64) -> dict:
    """The host's speed just after the window, to read a run's rate
    against: a copy in host memory, a copy from pageable host memory to
    the device (the path of the program's view uploads), both in GB/s,
    and a loop of the interpreter in millions of iterations a second;
    the best of three of each."""
    import numpy as np
    import torch
    a = np.ones(mib << 18, np.float32)
    b = np.empty_like(a)

    def best(fn) -> float:
        times = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return min(times)

    out = {"memcpy_GBps": a.nbytes / best(lambda: np.copyto(b, a)) / 1e9}
    if str(device).startswith("cuda"):
        def upload():
            torch.from_numpy(a).to(device)
            torch.cuda.synchronize()
        upload()
        out["pageable_h2d_GBps"] = a.nbytes / best(upload) / 1e9
    out["python_Mloops"] = 1.0 / best(lambda: sum(range(10 ** 6)))
    return {k: round(v, 3) for k, v in out.items()}


def p95(values: List[float]) -> float:
    """The 95th percentile (the inclusive method of ``statistics``)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


@dataclass
class Trace:
    """What a traced window gives the per-layer readers: the device's
    operations ``ops`` ``(name, start_ns, dur_ns)``, the benchmark's spans
    ``(name, start_ns, dur_ns)`` on the same clock, the window's length,
    the device's busy seconds, and the loop's own record: steps, work
    counted, span times taken with a synchronise."""

    window_s: float
    ops: List[tuple] = field(default_factory=list)
    spans: List[tuple] = field(default_factory=list)
    paused: List[tuple] = field(default_factory=list)
    steps: int = 0
    work: Dict[str, float] = field(default_factory=dict)
    span_ms: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union
        of the operations' intervals."""
        total, end = 0, None
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            e = s + d
            if end is None or s >= end:
                total += d
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def by_span(self) -> Dict[str, float]:
        """Device seconds of the operations that start and end inside a
        span, by the span's name, and of the others (``outside spans``):
        where the device's time goes, and a check that the two clocks
        agree."""
        out: Dict[str, float] = {}
        spans = sorted((st, st + du, nm) for nm, st, du in self.spans)
        starts = [a for a, _, _ in spans]
        for _, s, d in self.ops:
            i = bisect.bisect_right(starts, s) - 1
            name = spans[i][2] if i >= 0 and s + d <= spans[i][1] \
                else "outside spans"
            out[name] = out.get(name, 0.0) + d / 1e9
        return out

    def device_s(self, match) -> float:
        """Seconds of the operations whose name ``match`` accepts."""
        return sum(d for n, _, d in self.ops if match(n)) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0) + d
        return [[k[:120], v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device operations, each named by the
        innermost benchmark span open on the host at the gap's start."""
        ops = sorted(self.ops, key=lambda o: o[1])
        gaps, end = [], None
        for _, s, d in ops:
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = s + d if end is None else max(end, s + d)
        gaps = [(length - self._paused_in(at, at + length), at)
                 for length, at in gaps]
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:n]:
            open_ = [(st, nm) for nm, st, du in self.spans
                     if st <= at < st + du]
            name = max(open_)[1] if open_ else "outside spans"
            out.append([name, length / 1e9])
        return out


    def _paused_in(self, lo: int, hi: int) -> int:
        """Nanoseconds of ``[lo, hi)`` in which the window was paused."""
        return sum(max(0, min(hi, s + d) - max(lo, s))
                   for s, d in self.paused)


class Window:
    """The measured window: its clock, the benchmark's spans and, in a
    traced run, the profiler over it.

    The profiler records the device's operations only: recording every
    host operation as well would slow the host, which bounds these cells,
    by up to half again.  The spans are the benchmark's own, timed on the
    host's wall clock, which the profiler's timestamps share.

    A pause (:meth:`paused`) takes the harness's own bookkeeping between
    two stretches of measured work out of the window: its time, and in a
    traced run its device operations and idle time."""

    def __init__(self, traced: bool, device):
        self.traced = traced
        self.cuda = str(device).startswith("cuda")
        self.prof = None
        self.spans: List[tuple] = []
        self.pauses: List[tuple] = []        # (start_ns, dur_ns)
        self.paused_s = 0.0
        self.t0 = self.t1 = None

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def start(self) -> None:
        self.sync()
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            act = ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU
            self.prof = profile(activities=[act])
            self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        self.sync()
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
        return self.seconds

    @property
    def seconds(self) -> float:
        """The window's measured seconds, pauses left out."""
        return self.t1 - self.t0 - self.paused_s

    def elapsed(self) -> float:
        """Measured seconds so far, pauses left out."""
        return time.perf_counter() - self.t0 - self.paused_s

    @contextmanager
    def paused(self):
        """The block runs outside the measured window: the device
        finishes the work before it first, and the block's own after."""
        self.sync()
        t, ns = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.sync()
            self.paused_s += time.perf_counter() - t
            self.pauses.append((ns, time.time_ns() - ns))

    @contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t, time.time_ns() - t))

    def trace(self) -> Trace:
        """The traced window's device operations and spans."""
        tr = Trace(window_s=self.seconds, spans=self.spans,
                   paused=self.pauses)
        if self.prof is None:
            return tr
        from torch.autograd import DeviceType
        for e in self.prof.profiler.kineto_results.events():
            # a host range projected onto the device is no operation
            if e.device_type() != DeviceType.CPU \
                    and not e.is_user_annotation() \
                    and not tr._paused_in(e.start_ns(), e.start_ns() + 1):
                tr.ops.append((e.name(), e.start_ns(), e.duration_ns()))
        return tr


def kernel_names(source: str) -> List[str]:
    """The ``__global__`` functions of a CUDA source of the program."""
    import re
    with open(source) as f:
        text = f.read()
    return re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*"
                      r"\)\s+)?(?:void\s+)?(\w+)\s*\(", text)


def kernel_matcher(source: str):
    """A test of a profiler name: is it a kernel defined in ``source``."""
    import re
    names = kernel_names(source)
    pat = re.compile(r"(?:^|[\s:])(?:%s)\s*[<(]" % "|".join(names))
    return lambda n: bool(pat.search(n))


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
