"""One run of one cell of the port's benchmark.

    python -m portbench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Generates the cell's inputs from the seed, builds the program through its
own API, warms up (the check steps), measures for ``--seconds`` seconds,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output.  ``--trace 1`` profiles the
window (at most the traffic's ``trace_seconds``) and reports the
per-layer metrics and a breakdown instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()

from portbench import harness  # noqa: E402


class Ctx:
    """One run's settings and the hooks a loop reports to."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device, compute_dtype: str = "float32"):
        self.cell, self.seed, self.trace = cell, int(seed), bool(trace)
        self.device = device
        self.compute_dtype = compute_dtype
        self.window_seconds = min(float(seconds),
                                  cell.traffic["trace_seconds"]) \
            if trace else float(seconds)
        self.counts = harness.counts_module(cell)
        self.setup_s = None
        self.memory_peak = 0

    def mark(self, phase: str) -> None:
        """An earlier line: seconds since the process began, at the end of
        a phase of set-up."""
        print(f"setup {phase}: {time.perf_counter() - T_START:.3f} s",
              file=sys.stderr, flush=True)

    def setup_done(self) -> None:
        """Set-up ends: the clock stops, and what set-up left on the heap
        moves out of the collector's way."""
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - T_START
        gc.collect()
        gc.freeze()

    @property
    def cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    def read_memory_peak(self) -> None:
        if self.cuda:
            import torch
            self.memory_peak = int(torch.cuda.max_memory_allocated())


def execute(ctx: Ctx) -> dict:
    """Run the cell's loop; the result line's fields and the numbers
    compared with their limits."""
    out = harness.loop_module(ctx.cell).run(ctx)
    print("host probe:", harness.host_probe(ctx.device), file=sys.stderr,
          flush=True)
    # a number the run never reached (a window too short for its check)
    # is None, and not correct
    checks = {k: {"value": out["checks"].get(k), "limit": limit}
              for k, limit in ctx.cell.limits.items()}
    correct = all(harness.finite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    trace = out["trace"]
    if trace is None:
        for m in ctx.cell.end_to_end:
            v = ctx.setup_s if m["name"] == "setup_s" \
                else out["metrics"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in ctx.cell.per_layer:
            v = harness.read_metric(ctx.cell, m["name"], trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    device = {"platform": "gpu" if ctx.cuda else "cpu",
              "kind": _device_name(ctx), "count": ctx.cell.chips,
              "memory_peak_bytes": ctx.memory_peak}
    if trace is not None:
        print(f"device seconds by span: {trace.by_span()!r}",
              file=sys.stderr, flush=True)
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["device"] = device
    result["checks"] = checks
    return result


def _device_name(ctx: Ctx) -> str:
    if not ctx.cuda:
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the program's ``build/`` holds its own libraries."""
    build = os.path.join(harness.ROOT, "build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    print("card:", _card(), flush=True)
    ctx = Ctx(cell, args.seed, args.seconds, args.trace, "cuda")
    result = execute(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
