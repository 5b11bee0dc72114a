"""The port's tracer (``gnnflow_tpu_torch/utils/profiling.py``) on the CPU:
off, it hands out one shared no-op and reads no clock; on, a tiny TGN's
train and eval steps record the span tree of the program's layers, with
parents and step ids, and the host-wait counters by site; the store's
view refresh counts the bytes it uploads; and three train steps and an
eval step give bit-identical loss, parameters and memory with tracing on
and off."""
import time

import numpy as np
import pytest
import torch

from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.train import Trainer, tier_caps
from gnnflow_tpu_torch.utils import profiling

B = 64
CFG = dict(dim_node=0, dim_edge=6, dim_time=8, dim_embed=8, num_layers=1,
           num_snapshots=1, att_head=2, dropout=0.2, att_dropout=0.2,
           use_memory=True, dim_memory=8)

# the spans of one train step after the first, (name, parent's name);
# the first also calibrates, inside the step
TRAIN_TREE = [("trainer.train_step", None),
              ("trainer.batch_upload", "trainer.train_step"),
              ("sampler.sample", "trainer.train_step"),
              ("features.gather", "trainer.train_step"),
              ("memory.pull", "trainer.train_step"),
              ("model.forward", "trainer.train_step"),
              ("memory.gru", "model.forward"),
              ("model.attention", "model.forward"),
              ("trainer.optimizer", "trainer.train_step"),
              ("trainer.backward", "trainer.train_step"),
              ("trainer.optimizer", "trainer.train_step"),
              ("memory.write_back", "trainer.train_step")]
EVAL_TREE = [("trainer.eval_step", None)] + [
    (n, "trainer.eval_step" if p == "trainer.train_step" else p)
    for n, p in TRAIN_TREE[1:8]] + [("memory.write_back",
                                     "trainer.eval_step")]


@pytest.fixture(autouse=True)
def no_tracer_left():
    yield
    assert profiling.stop_tracing() is None, "a test left a tracer on"


def _stream():
    return data.make_synthetic_dataset(num_src=120, num_dst=30,
                                       num_edges=2000, dim_edge=6, seed=3)


def _run(traced: bool, steps: int = 3):
    """A fresh tiny TGN: ``steps`` train steps and one eval step; the
    tracer (None untraced), the losses, parameters and memory."""
    train, val, _, full, _, ef = _stream()
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid)
    torch.manual_seed(0)
    model = DGNN(**CFG, seed=1, device="cpu")
    trainer = Trainer(model, fanouts=[4], device="cpu")
    state = trainer.init_state(g.max_vertex_id() + 1, seed=2)
    neg = data.DstRandEdgeSampler(train.dst, seed=4)
    batches = data.get_batches(train, B, neg)
    ef = torch.from_numpy(ef)
    tracer = profiling.start_tracing() if traced else None
    try:
        dg = g.device_graph("cpu")
        losses = [trainer.train_step(state, dg, ef, next(batches))[1]
                  for _ in range(steps)]
        vb = next(data.get_batches(val, B, neg))
        losses.append(trainer.eval_step(state, dg, ef, vb)[1])
    finally:
        if traced:
            profiling.stop_tracing()
    return (tracer, trainer, losses,
            {k: p.detach().clone() for k, p in model.named_parameters()},
            {k: t.clone() for k, t in state.memory.tensors().items()})


@pytest.fixture(scope="module")
def runs():
    return _run(True), _run(False)


def _steps(tracer):
    """``{step id: [(name, parent's name)]}`` in opening order."""
    out = {}
    for name, _, _, parent, step in tracer.spans:
        out.setdefault(step, []).append(
            (name, tracer.spans[parent][0] if parent >= 0 else None))
    return out


def test_off_is_one_shared_noop_that_reads_no_clock(monkeypatch):
    assert profiling.span("a") is profiling.span("b", step=True)
    profiling.count("host_sync.x")                  # nothing to count into

    def no_clock():
        raise AssertionError("the tracer read the clock while off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    _run(False, steps=1)
    monkeypatch.undo()
    t = profiling.start_tracing()
    assert profiling.stop_tracing() is t
    assert t.spans == [] and t.counters == {} and t.steps == 0


def test_steps_record_the_span_tree(runs):
    (tracer, trainer, *_), _ = runs
    steps = _steps(tracer)
    # the view refresh and the batches' making ran outside the steps
    assert steps.pop(-1) == [("store.view_refresh", None)] \
        + [("data.get_batches", None)] * 4
    assert sorted(steps) == [1, 2, 3, 4] and tracer.steps == 4
    first = steps[1]
    assert first[:2] == [("trainer.train_step", None),
                         ("trainer.calibrate", "trainer.train_step")]
    assert [first[0]] + first[2:] == TRAIN_TREE
    assert steps[2] == steps[3] == TRAIN_TREE
    assert steps[4] == EVAL_TREE
    for name, start, end, parent, step in tracer.spans:
        assert start <= end, name
        if parent >= 0:
            p = tracer.spans[parent]
            assert p[1] <= start and end <= p[2] and p[4] == step, name


def test_host_syncs_counted_by_site(runs):
    (tracer, trainer, *_), _ = runs
    dedup = 1 if trainer.dedup_factor else 0
    # calibration: the view's latest time, then four probes (the batch
    # and three shifts), each two uploads and three reads of one MFG
    want = {"host_sync.batch_upload": 4 * 4, "host_sync.write_back": 2 * 4,
            "host_sync.calibrate": 1 + 4 * (2 + 3),
            "host_sync.view_upload": 5}
    if dedup:
        want["host_sync.memory_dedup"] = 4
    got = {k: v for k, v in tracer.counters.items()
           if k.startswith("host_sync.")}
    assert got == want


def test_view_refresh_counts_the_bytes_it_uploads():
    _, _, _, full, _, _ = _stream()
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src[:1000], full.dst[:1000], full.time[:1000],
                full.eid[:1000])
    tracer = profiling.start_tracing()
    try:
        v = g.device_graph("cpu")
        assert g.device_graph("cpu") is v              # no change, no upload
        g.add_edges(full.src[1000:], full.dst[1000:], full.time[1000:],
                    full.eid[1000:])
        g.offload_old_blocks(float(full.time[500]))
        w = g.device_graph("cpu")
    finally:
        profiling.stop_tracing()
    views = [getattr(x, f).nbytes for x in (v, w)
             for f in ("row_off", "row_len", "e_dst", "e_ts", "e_eid")]
    assert tracer.counters["store.view_bytes"] == sum(views)
    assert tracer.counters["host_sync.view_upload"] == 10
    assert [(n, tracer.spans[p][0] if p >= 0 else None)
            for n, _, _, p, _ in tracer.spans] == [
        ("store.view_refresh", None), ("store.add_edges", None),
        ("store.ingest_native", "store.add_edges"),
        ("store.ingest_native", "store.add_edges"),
        ("store.evict", None), ("store.ingest_native", "store.evict"),
        ("store.view_refresh", None)]


def test_stopped_tracer_resumes_and_traced_decorates():
    @profiling.traced("outer", step=True)
    def outer():
        with profiling.span("inner"):
            profiling.count("c", 2)

    t = profiling.start_tracing()
    outer()
    profiling.stop_tracing()
    outer()                                         # not recorded
    profiling.start_tracing(t)
    outer()
    profiling.stop_tracing()
    assert [(n, p, s) for n, _, _, p, s in t.spans] == [
        ("outer", -1, 1), ("inner", 0, 1), ("outer", -1, 2),
        ("inner", 2, 2)]
    assert t.counters == {"c": 4}


def test_tracing_changes_no_number(runs):
    (_, _, loss_on, params_on, mem_on), (_, _, loss_off, params_off,
                                         mem_off) = runs
    assert [float(x) for x in loss_on] == [float(x) for x in loss_off]
    assert np.isfinite([float(x) for x in loss_on]).all()
    for k in params_off:
        assert torch.equal(params_on[k], params_off[k]), k
    for k in mem_off:
        assert torch.equal(mem_on[k], mem_off[k]), k


TGAT_CFG = dict(CFG, num_layers=2, dropout=0.1, att_dropout=0.1,
                use_memory=False, dim_memory=None)
TGAT_FANOUTS = [4, 4]
LAYER_DEDUP = ["model.layer_dedup"]


def _tgat_run(traced: bool, layer_dedup, steps: int = 3):
    """A fresh tiny TGAT on the layer dedup at ``layer_dedup``: ``steps``
    train steps; the tracer (None untraced), the trainer, the losses,
    parameters, and each step's unique counts and outer instances."""
    train, _, _, full, _, ef = _stream()
    g = DynamicGraph(initial_pool_size=4096, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = DGNN(**TGAT_CFG, seed=1, device="cpu")
    trainer = Trainer(model, fanouts=TGAT_FANOUTS, sample_strategy="uniform",
                      layer_dedup=layer_dedup, device="cpu")
    state = trainer.init_state(g.max_vertex_id() + 1, seed=2)
    batches = data.get_batches(train, B, data.DstRandEdgeSampler(train.dst,
                                                                 seed=4))
    ef = torch.from_numpy(ef)
    dg = g.device_graph("cpu")
    tracer = profiling.start_tracing() if traced else None
    losses, n_uniq = [], []
    try:
        for _ in range(steps):
            losses.append(float(trainer.train_step(state, dg, ef,
                                                   next(batches))[1]))
            n_uniq.append(state.layer_dedup_n_uniq)
    finally:
        if traced:
            profiling.stop_tracing()
    return (tracer, trainer, losses,
            {k: p.detach().clone() for k, p in model.named_parameters()},
            n_uniq, 3 * B * (1 + TGAT_FANOUTS[0]))


@pytest.mark.parametrize("layer_dedup,overflow", [((0.4, 0.8), False),
                                                  (0.01, True)])
def test_layer_dedup_spans_and_counters(layer_dedup, overflow):
    """One ``model.layer_dedup`` span a boundary, under the sampler; the
    counters equal the trainer's own unique counts and the caps it took,
    or count the fallback; no host wait more than the boundary's one."""
    tracer, trainer, losses, params, n_uniq, rows = _tgat_run(True,
                                                              layer_dedup)
    steps = len(n_uniq)
    spans = [(n, tracer.spans[p][0], s) for n, _, _, p, s in tracer.spans
             if n in LAYER_DEDUP]
    assert spans == [("model.layer_dedup", "sampler.sample", i + 1)
                     for i in range(steps)]
    assert all(len(n) == 1 for n in n_uniq)
    caps = tier_caps(trainer._dedup_tiers(), rows)
    taken = [next((c for c in caps if n[0] <= c), None) for n in n_uniq]
    assert (None in taken) == overflow
    want = {"layer_dedup.rows": steps * rows,
            "layer_dedup.unique": sum(n[0] for n in n_uniq)}
    if overflow:
        want["layer_dedup.overflow"] = taken.count(None)
    if taken.count(None) < steps:
        want["layer_dedup.cap"] = sum(c for c in taken if c)
    got = {k: v for k, v in tracer.counters.items()
           if k.startswith("layer_dedup.")}
    assert got == want
    # the boundary's one sync; explicit knobs: no calibration
    assert {k: v for k, v in tracer.counters.items()
            if k.startswith("host_sync.")} == {
        "host_sync.batch_upload": 4 * steps,
        "host_sync.layer_dedup": steps}
    # the outer layer's roots, then the inner layer's: cap rows on the
    # dedup, every outer instance after a fallback
    assert tracer.counters["attention.slots"] == sum(
        3 * B * TGAT_FANOUTS[0] + (c or rows) * TGAT_FANOUTS[1]
        for c in taken)
    _, _, losses_off, params_off, n_off, _ = _tgat_run(False, layer_dedup)
    assert losses == losses_off and n_uniq == n_off
    for k in params_off:
        assert torch.equal(params[k], params_off[k]), k


def test_tgn_step_records_no_layer_dedup(runs):
    (tracer, *_), _ = runs
    assert not any(n in LAYER_DEDUP for n, *_ in tracer.spans)
    assert not any(k.startswith("layer_dedup.") for k in tracer.counters)
    # three train steps and an eval step, one layer of 3B roots each
    assert tracer.counters["attention.slots"] == 4 * 3 * B * 4
