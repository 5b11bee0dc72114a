"""What the per-layer metrics in ``metrics/`` compute from a traced
window (:class:`~portbench.harness.Trace`).  A reader that finds nothing
to read gives None, and the metric is left out of the result line."""
from __future__ import annotations

import os
import statistics
from typing import Optional

from portbench.harness import ROOT, kernel_matcher

CSRC = os.path.join(ROOT, "gnnflow_tpu_torch", "csrc")


def idle_pct(trace) -> Optional[float]:
    """Share of the window in which no operation ran on the device."""
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu_pct(trace) -> Optional[float]:
    """The operations the window's steps need over the window's time and
    the configuration's peak."""
    flops = trace.work.get("flops")
    if not flops or not trace.ops:
        return None
    return 100.0 * flops / (trace.window_s * trace.work["peak_flops"])


def launches_per_step(trace) -> Optional[float]:
    """Kernels the device ran in the window, over the steps."""
    n = sum(1 for name, _, _ in trace.ops
            if not name.startswith(("Memcpy", "Memset")))
    return n / trace.steps if n and trace.steps else None


def roofline_pct(trace, source: str, key: str) -> Optional[float]:
    """The least time of a kernel's work (``trace.work[key]``) over the
    device time of the kernels that ``csrc/<source>`` defines."""
    least = trace.work.get(key)
    spent = trace.device_s(kernel_matcher(os.path.join(CSRC, source)))
    if not least or spent <= 0:
        return None
    return 100.0 * least / spent


def span_p50_ms(trace, name: str) -> Optional[float]:
    """The median of a span the loop timed with a synchronise."""
    v = trace.span_ms.get(name)
    return statistics.median(v) if v else None
