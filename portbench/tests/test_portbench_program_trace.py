"""The program's tracer seen from the benchmark (``portbench.program_trace``):
the readers over a made-up window split idle time by the innermost span,
pauses left out, and name gaps and device time by the innermost span when
spans nest; the nine readers of ``BENCHMARK.json`` read the same with the
program's spans present or absent; a run of each tiny cell reports the
new metrics, and a program without the tracer leaves them out.

On the card (``python -m pytest --noconftest -m cuda portbench/tests``):
a host sleep inside a span between two kernels is the gap the trace
names by that span, as long to 0.5 ms, so host spans and device
timestamps share a clock; and every synchronising call that PyTorch
flags in a tiny TGN's train and eval steps and the view's refresh comes
from a site the tracer counts."""
from __future__ import annotations

import json
import linecache
import time
import traceback
import warnings

import pytest

from portbench import harness, program_trace, run
from portbench.program_trace import ProgramTrace, ProgramWindow
from portbench.tests import tiny

MS = 1_000_000
NEW = {m["name"]: m for m in harness.load_json(program_trace.METRICS_FILE)}


def _window(program: bool) -> ProgramTrace:
    """100 ms: device operations at 0-10, 30-40 and 90-100 ms, a pause at
    70-80; the loop's ``train_step`` over all of it and, with
    ``program``, a train step at 5-95 holding the sampler (9-25), the
    memory pull (25-28) and the write-back (45-60)."""
    tr = ProgramTrace(window_s=0.09, steps=4, window_ns=(0, 100 * MS))
    tr.ops = [("gru_fused_fwd_kernel<float>(", 0, 10 * MS),
              ("Memcpy HtoD (Pageable -> Device)", 30 * MS, 10 * MS),
              ("attention_fwd_kernel<float>(", 90 * MS, 10 * MS)]
    tr.spans = [("train_step", 0, 100 * MS)]
    tr.paused = [(70 * MS, 10 * MS)]
    tr.work = {"flops": 6.7e9, "peak_flops": 67e12, "gru_least_s": 1e-3,
               "attn_least_s": 2e-3}
    tr.span_ms = {"ingest": [1.0, 2.0, 4.0], "score": [3.0]}
    if program:
        tr.program_spans = [
            ("trainer.train_step", 5 * MS, 95 * MS, -1, 1),
            ("sampler.sample", 9 * MS, 25 * MS, 0, 1),
            ("memory.pull", 25 * MS, 28 * MS, 0, 1),
            ("memory.write_back", 45 * MS, 60 * MS, 0, 1)]
        tr.counters = {"host_sync.batch_upload": 16,
                       "host_sync.write_back": 8,
                       "store.view_bytes": 3_000_000}
    return tr


def test_idle_splits_by_the_innermost_span_pauses_left_out():
    idle = _window(True).idle_by_span()
    assert idle == pytest.approx({"sampler.sample": 0.015,
                                  "memory.pull": 0.003,
                                  "trainer.train_step": 0.027,
                                  "memory.write_back": 0.015})
    assert sum(idle.values()) == pytest.approx(0.06)   # 70-80 is paused
    tr = _window(True)
    assert _read("sample_idle_pct.train", tr) == pytest.approx(
        100 * 0.015 / 0.09)
    assert _read("memory_idle_pct.train", tr) == pytest.approx(
        100 * 0.018 / 0.09)
    assert tr.summary()["idle_named_pct"] == pytest.approx(100.0)


def test_gaps_and_device_time_by_the_innermost_span():
    tr = _window(True)
    assert tr.idle_gaps() == [["trainer.train_step", 0.04],
                              ["sampler.sample", 0.02]]
    # the last operation outlasts the train step: its parent takes it
    assert tr.by_span() == pytest.approx({"train_step": 0.02,
                                          "trainer.train_step": 0.01})
    plain = _window(False)
    assert plain.idle_gaps() == [["train_step", 0.04], ["train_step", 0.02]]
    assert plain.by_span() == harness.Trace.by_span(plain) \
        == pytest.approx({"train_step": 0.03})


def test_counters_per_step_and_chunk():
    tr = _window(True)
    assert _read("host_syncs_per_step.train", tr) == 6.0
    assert _read("host_syncs_per_chunk.serve", tr) == 6.0
    assert _read("view_upload_mb_per_chunk.serve", tr) == 0.75


def _read(name, tr):
    cell = harness.load_cell(NEW[name]["workloads"][0])
    return harness.read_metric(cell, name, tr)


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_readers_find_nothing_without_the_tracer(name):
    base = _window(False)
    plain = harness.Trace(base.window_s, base.ops, base.spans, base.paused,
                          base.steps, base.work, base.span_ms)
    assert _read(name, plain) is None
    assert _read(name, base) is None


@pytest.mark.parametrize("cell", ["tgn-train", "tgn-serve"])
def test_accepted_readers_read_the_same(cell):
    c = harness.load_cell(cell)
    got = [[harness.read_metric(c, m["name"], _window(p))
            for m in c.per_layer] for p in (False, True)]
    assert len(got[0]) == len(c.per_layer) >= 4
    assert got[0] == got[1]
    assert any(v is not None for v in got[0])


def _execute(monkeypatch, name, started):
    monkeypatch.setattr(harness, "Window", lambda traced, device:
                        ProgramWindow(traced, device, started))
    cell = tiny.cell(name)
    cell.per_layer = cell.per_layer + program_trace.metrics(name)
    return run.execute(run.Ctx(cell, 2 ** 31 + 9, 0.5, True, "cpu"))


@pytest.mark.parametrize("name", ["tgn-train", "tgn-serve"])
def test_tiny_cell_reports_the_program(monkeypatch, name):
    started = []
    res = json.loads(json.dumps(_execute(monkeypatch, name, started)))
    assert res["correct"], res["checks"]
    tr = started[-1].last_trace
    assert {n for n, *_ in tr.program_spans} >= {
        "trainer.batch_upload", "sampler.sample", "memory.pull",
        "model.forward", "memory.write_back"}
    assert all(tr.window_ns[0] <= s <= e <= tr.window_ns[1]
               for _, s, e, _, _ in tr.program_spans)
    # the CPU's profile holds no device operation: the counters read
    counted = [m for m in NEW if name in NEW[m]["workloads"]
               and NEW[m]["source"] == "program_counter"]
    for m in counted:
        assert res["metrics"][m]["value"] > 0, m
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_program_without_tracer(monkeypatch):
    monkeypatch.setattr(program_trace, "_tracing", lambda: None)
    started = []
    res = _execute(monkeypatch, "tgn-serve", started)
    assert res["correct"] and started[-1].tracer is None
    assert not set(res["metrics"]) & set(NEW)


# ---- on the card --------------------------------------------------------

@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return "cuda"


@pytest.mark.cuda
def test_host_gap_named_on_the_device_clock(card):
    import torch
    from gnnflow_tpu_torch.utils import profiling
    x = torch.randn(256, 256, device=card)
    (x @ x).sum().item()                               # warm up
    win = ProgramWindow(True, card)
    win.start()
    with profiling.span("test.host"):
        (x @ x).sum().item()           # the profiler's first records
        time.sleep(0.001)
        y = x @ x
        after_a = time.time_ns()
        time.sleep(0.005)
        before_b = time.time_ns()
        z = y @ x
        torch.cuda.synchronize()
        after_sync = time.time_ns()
        time.sleep(0.001)
    win.stop()
    tr = win.trace()
    (name, gap), = tr.idle_gaps(1)
    ops = sorted((s, s + d) for _, s, d in tr.ops)
    end, longest = ops[0][1], (0, 0, 0)
    for s, e in ops[1:]:
        longest = max(longest, (s - end, end, s))
        end = max(end, e)
    # a kernel starts after its launch and ends before the synchronise
    # that waits for it returns: the device clock's offset from the
    # host's lies between the two readings
    bounds = ((end - after_sync) / 1e6, (longest[2] - before_b) / 1e6)
    wait_ms = (before_b - after_a) / 1e6
    print(f"gap {gap * 1e3:.4f} ms over a host wait of {wait_ms:.4f} ms; "
          f"device clock minus host clock within [{bounds[0]:.4f}, "
          f"{bounds[1]:.4f}] ms")
    assert name == "test.host"
    assert gap == pytest.approx(longest[0] / 1e9)
    assert abs(gap * 1e3 - wait_ms) < 0.5
    assert bounds[0] < 0.5 and bounds[1] > -0.5


def _counted_site(stack) -> bool:
    """A frame of the program whose function counts a host wait on its
    line or the three before it."""
    for f in stack:
        if "gnnflow_tpu_torch" not in f.filename:
            continue
        lines = [linecache.getline(f.filename, n)
                 for n in range(max(1, f.lineno - 3), f.lineno + 1)]
        if any('profiling.count("host_sync.' in s for s in lines):
            return True
    return False


@pytest.mark.cuda
def test_every_flagged_sync_is_counted(card):
    import numpy as np
    import torch
    from gnnflow_tpu_torch import data
    from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    from gnnflow_tpu_torch.utils import profiling
    train, val, _, full, _, ef = data.make_synthetic_dataset(
        num_src=120, num_dst=30, num_edges=2000, dim_edge=6, seed=3)
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src[:1500], full.dst[:1500], full.time[:1500],
                full.eid[:1500])
    model = DGNN(dim_node=0, dim_edge=6, dim_time=8, dim_embed=8,
                 num_layers=1, num_snapshots=1, att_head=2, dropout=0.2,
                 att_dropout=0.2, use_memory=True, dim_memory=8, device=card)
    trainer = Trainer(model, fanouts=[4], device=card)
    state = trainer.init_state(g.max_vertex_id() + 1, seed=2)
    neg = data.DstRandEdgeSampler(train.dst, seed=4)
    batches = data.get_batches(train, 64, neg)
    ef = torch.from_numpy(np.asarray(ef)).to(card)
    trainer.train_step(state, g.device_graph(card), ef, next(batches))
    torch.cuda.synchronize()
    flagged = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            flagged.append(traceback.extract_stack()[:-1])

    tracer = profiling.start_tracing()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            g.add_edges(full.src[1500:], full.dst[1500:], full.time[1500:],
                        full.eid[1500:])
            dg = g.device_graph(card)
            for _ in range(2):
                trainer.train_step(state, dg, ef, next(batches))
            trainer.eval_step(state, dg, ef,
                              next(data.get_batches(val, 64, neg)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        profiling.stop_tracing()
    counted = {k: v for k, v in tracer.counters.items()
               if k.startswith("host_sync.")}
    print("flagged:", len(flagged), "counted:", counted)
    assert flagged
    assert all(_counted_site(s) for s in flagged), \
        [traceback.format_list(s[-3:]) for s in flagged
         if not _counted_site(s)]
    assert len(flagged) == sum(counted.values())
