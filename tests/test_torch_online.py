"""The serving slice: the port's data helpers, eviction, spill and
compaction, ``resize_memory``, ``Trainer.embed_step`` and a prequential
TGN loop against the JAX package, f32, at tiny sizes; the cached device
view; and both serving scripts on the CPU.

Tolerances:
- data helpers, samplers, the written datasets, the store after every
  eviction, insertion and compaction (``row_off``, ``row_len`` and the
  live ranges of ``e_dst``, ``e_ts``, ``e_eid``), the spill file, the
  restored store, recent sampling on the evicted store and
  ``resize_memory``: bit-identical.
- ``embed_step``: the eval-logit tolerances of each model's slice test:
  TGN 1e-4 (tests/test_torch_slice.py: f32 sum order, on random memory
  and mails), DySAT and GraphSAGE 1e-5 absolute
  (tests/test_torch_dysat.py, tests/test_torch_static.py).
- the prequential loop: per-chunk AP 1e-6 absolute; memory and mails
  1e-4 absolute, timestamps exact (tests/test_torch_slice.py).

The JAX side runs its plain (XLA) GRU and attention, the reference of
the Pallas kernels on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.models import memory as jmemory
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.ops import sampling as jsampling
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu.train import TrainState as JTrainState
from gnnflow_tpu.utils import average_precision_score as jap
from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.weights import flax_param_tree
from gnnflow_tpu_torch.ops import sampling
from gnnflow_tpu_torch.scripts import inference
from gnnflow_tpu_torch.scripts import online_edge_prediction as online
from gnnflow_tpu_torch.train import Trainer
from gnnflow_tpu_torch.utils import average_precision_score
from gnnflow_tpu_torch.utils.checkpoint import load_checkpoint
from torch_fixtures import one_cpu_thread  # noqa: F401
from torch_fixtures import CFG, _assert_mfgs_identical
from torch_parity import (DYSAT_CFG, DYSAT_FANOUTS, DYSAT_WIN, STATIC_FANOUTS,
                          _assert_memory, _assert_memory_equal,
                          _assert_stores_equal, _assert_tables_equal,
                          _filled_memory, _hop_stream, _jax_graph, _jax_memory,
                          _port_graph, _static_batch, _static_graphs,
                          _static_models, _static_stream)

B = 64


def _stream():
    """120 src, 30 dst, 2000 edges over t < ~2000, 6-dim edge features."""
    return data.make_synthetic_dataset(num_src=120, num_dst=30,
                                       num_edges=2000, dim_edge=6, seed=3)


# ---- (a): data helpers ----------------------------------------------------

def test_edge_table_helpers_match_jax():
    _, _, _, full, _, _ = _stream()
    jfull = jdata.EdgeTable(full.src, full.dst, full.time, full.eid)
    for a, b in ((full[:700], full[1500:]), (full[:0], full[5:9]),
                 (full[:3], full[:0])):
        ja = jdata.EdgeTable(a.src, a.dst, a.time, a.eid)
        jb = jdata.EdgeTable(b.src, b.dst, b.time, b.eid)
        _assert_tables_equal(a.concat(b), ja.concat(jb))
        assert a.max_node == ja.max_node and b.max_node == jb.max_node
    assert full[:0].max_node == -1 == jfull[:0].max_node


def test_negative_samplers_match_jax():
    _, _, _, full, _, _ = _stream()
    ours = data.DstRandEdgeSampler(full.dst[:300], seed=4)
    ref = jdata.DstRandEdgeSampler(full.dst[:300], seed=4)
    pairs = data.RandEdgeSampler(full.src[:300], full.dst[:300], seed=5)
    jpairs = jdata.RandEdgeSampler(full.src[:300], full.dst[:300], seed=5)
    for lo in (300, 900, 1500):
        assert np.array_equal(ours.sample(50), ref.sample(50))
        ours.add_dst_list(full.dst[lo: lo + 600])
        ref.add_dst_list(full.dst[lo: lo + 600])
        assert np.array_equal(ours.dst_list, ref.dst_list)
        for a, b in zip(pairs.sample(40), jpairs.sample(40)):
            assert np.array_equal(a, b)
    for s in (ours, ref, pairs, jpairs):
        s.reset_random_state()
    # a reset draws the seed's sequence again, over the grown list
    again = ours.sample(30)
    assert np.array_equal(again, ref.sample(30))
    assert np.array_equal(
        again, data.DstRandEdgeSampler(ours.dst_list, seed=4).sample(30))
    for a, b in zip(pairs.sample(40), jpairs.sample(40)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_written_dataset_reads_across(tmp_path, writer):
    """One package writes, both read: equal splits and feature files."""
    kw = dict(num_src=40, num_dst=15, num_edges=500, dim_node=3, dim_edge=4,
              seed=2, time_scale=3.3)
    (jdata if writer == "jax" else data).write_synthetic_dataset(
        str(tmp_path / "TINY"), **kw)
    ours = data.load_dataset("TINY", str(tmp_path))
    ref = jdata.load_dataset("TINY", str(tmp_path))
    made = data.make_synthetic_dataset(**kw)
    for a, b, c in zip(ours, ref, made[:4]):
        _assert_tables_equal(a, b)
        _assert_tables_equal(a, c)
    for a, b, c in zip(data.load_feat("TINY", str(tmp_path)),
                       jdata.load_feat("TINY", str(tmp_path)), made[4:]):
        assert a.tobytes() == b.tobytes() == c.tobytes()


# ---- (b): eviction, spill, restore, compaction ----------------------------

def test_eviction_matches_jax(tmp_path):
    """add → evict (spilled) → add (evicted vertices fill again and
    move) → evict → add → evict → compact, then restore the spill; each
    add out of order (a chunk's later half first, each half shuffled, so
    that regions holding later edges are re-sorted); the store, the
    evicted counts, the spill file and recent sampling after every step
    bit-equal to JAX's."""
    _, _, _, full, _, _ = _stream()
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4,
                     spill_dir=str(tmp_path / "port"))
    jg = JGraph(initial_pool_size=1024, minimum_block_size=4,
                spill_dir=str(tmp_path / "jax"))
    rng = np.random.RandomState(0)
    roots = np.concatenate([rng.randint(0, 150, 90), [-1, 149, 0]])

    def sample(t):
        dg, jdg = _assert_stores_equal(g, jg)
        ts = np.full(len(roots), t, np.float32)
        got = sampling.sample_layer(dg, torch.from_numpy(roots),
                                    torch.from_numpy(ts), fanout=6)
        want = jsampling.sample_layer(jdg, jnp.asarray(roots, jnp.int32),
                                      jnp.asarray(ts), fanout=6,
                                      search_iters=jdg.search_iters)
        _assert_mfgs_identical(got, want)

    evicted = []
    shuffle = np.random.RandomState(1)
    for lo, hi, horizon in ((0, 800, 300.0), (800, 1400, 500.0),
                            (1400, 2000, 400.0)):
        sl = full[lo:hi]
        mid = (lo + hi) // 2
        for part in (full[mid:hi], full[lo:mid]):
            p = shuffle.permutation(len(part))
            for x in (g, jg):
                x.add_edges(part.src[p], part.dst[p], part.time[p],
                            part.eid[p], add_reverse=True)
        sample(float(sl.time[-1]) + 1)
        cut = float(sl.time[-1]) - horizon
        spill = lo == 0
        n = g.offload_old_blocks(cut, to_file=spill)
        assert n == jg.offload_old_blocks(cut, to_file=spill)
        evicted.append(n)
        sample(float(sl.time[-1]) + 1)
    assert all(n > 0 for n in evicted)
    assert g._num_offloaded == jg._num_offloaded == sum(evicted)
    used = g._pool_used
    g.compact()
    jg.compact()
    assert g._pool_used < used
    sample(float(full.time[-1]))

    (f,), (jf,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert f == jf == "offload_0.npz"
    with np.load(tmp_path / "port" / f) as a, \
            np.load(tmp_path / "jax" / jf) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    n = g.restore_from_file(str(tmp_path / "port" / f))
    assert n == jg.restore_from_file(str(tmp_path / "jax" / jf)) \
        == evicted[0]
    assert g.num_edges() == jg.num_edges()
    sample(float(full.time[-1]))


def test_device_view_uploads_once_per_change(tmp_path):
    _, _, _, full, _, _ = _stream()
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4,
                     spill_dir=str(tmp_path))
    g.add_edges(full.src[:500], full.dst[:500], full.time[:500],
                full.eid[:500])
    view = g.device_graph("cpu")
    assert g.device_graph("cpu") is view
    assert g.device_graph(torch.device("cpu")) is view and g.uploads == 1
    before = view.e_dst.clone()

    changes = [
        lambda: g.add_edges(full.src[500:900], full.dst[500:900],
                            full.time[500:900], full.eid[500:900]),
        lambda: g.offload_old_blocks(float(full.time[300]), to_file=True),
        g.compact,
        lambda: g.restore_from_file(str(tmp_path / "offload_0.npz")),
    ]
    for i, change in enumerate(changes):
        change()
        new = g.device_graph("cpu")
        assert new is not view and g.uploads == i + 2
        assert g.device_graph("cpu") is new
        view = new
    # a view is a snapshot: the mirror's later changes never show through
    assert not torch.equal(view.e_dst, before)
    assert g.offload_old_blocks(0.0) == 0          # nothing older than 0
    assert g.device_graph("cpu") is view
    assert g.device_graph("cpu", refresh=True) is not view
    assert g.uploads == len(changes) + 2


# ---- (c): resize_memory ---------------------------------------------------

@pytest.mark.parametrize("slots", [1, 10])
def test_resize_memory_matches_jax(slots):
    rng = np.random.RandomState(slots)
    mem = _filled_memory(rng, 13, slots)
    grown = memory_lib.resize_memory(mem, 29)
    want = jmemory.resize_memory(_jax_memory(mem), 29)
    assert grown.num_nodes == want.num_nodes == 29
    assert grown.mailbox_slots == slots
    _assert_memory(grown, want, 0)
    assert memory_lib.resize_memory(grown, 29) is grown
    assert memory_lib.resize_memory(grown, 5) is grown


# ---- (d): embed_step ------------------------------------------------------

def _jax_state(jtrainer, model, memory=None):
    """A JAX train state holding the port model's weights and, with
    memory, the port state's memory: what ``embed_step`` and
    ``eval_step`` read, without compiling ``init_state``'s programs."""
    return JTrainState(
        params=jax.tree.map(jnp.asarray, flax_param_tree(model)),
        opt_state=None,
        memory=None if memory is None else _jax_memory(memory),
        key=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32),
        tier_takes=jnp.zeros((4,), jnp.int32)
        if jtrainer._layer_dedup_ok() else None)


def _tgn_sides(full):
    """The port's TGN trainer, state and store of ``full``, and the JAX
    trainer (plain GRU and attention), state and store with the same
    weights and memory."""
    jg = JGraph(initial_pool_size=4096, minimum_block_size=4)
    g = DynamicGraph(initial_pool_size=4096, minimum_block_size=4)
    for x in (g, jg):
        x.add_edges(full.src, full.dst, full.time, full.eid,
                    add_reverse=True)
    jtrainer = JTrainer(JDGNN(**CFG), fanouts=[4], dedup_factor=None,
                        gru_table=False)
    trainer = Trainer(DGNN(**CFG, device="cpu"), fanouts=[4],
                      dedup_factor=None, device="cpu")
    state = trainer.init_state(int(full.max_node) + 1)
    return g, jg, trainer, state, jtrainer, \
        _jax_state(jtrainer, trainer.model, state.memory)


def _embed_tgn():
    _, _, _, full, _, ef = _stream()
    g, jg, trainer, state, jtrainer, _ = _tgn_sides(full[:600])
    # memory and mails as a stream would leave them, the same on both sides
    state.memory = _filled_memory(np.random.RandomState(7),
                                  state.memory.num_nodes, 1,
                                  CFG["dim_memory"], CFG["dim_edge"])
    jstate = _jax_state(jtrainer, trainer.model, state.memory)
    b = list(data.get_batches(full[:600], B,
                              data.DstRandEdgeSampler(full.dst, 1)))[7]
    jef, tef, dg, jdg = (jnp.asarray(ef), torch.from_numpy(ef),
                         g.device_graph("cpu"), jg.device_graph())
    before = memory_lib.backup_memory(state.memory)
    got = trainer.embed_step(state, dg, tef, b)
    after = memory_lib.backup_memory(state.memory)
    assert all(torch.equal(before[k], after[k]) for k in before)
    return got, jtrainer.embed_step(jstate, jdg, None, jef, b), 1e-4


def _embed_dysat():
    train, _, _, full, _, ef = _hop_stream()
    jg, g = _jax_graph(full), _port_graph(full)
    jtrainer = JTrainer(JDGNN(**DYSAT_CFG), fanouts=list(DYSAT_FANOUTS),
                        sample_strategy="recent", compact_factor=None,
                        model_compact=False, layer_dedup=None, **DYSAT_WIN)
    jdg = jg.device_graph()
    model = DGNN(**DYSAT_CFG, device="cpu")
    jstate = _jax_state(jtrainer, model)
    trainer = Trainer(model, fanouts=list(DYSAT_FANOUTS),
                      sample_strategy="recent", compact_factor=None,
                      model_compact=False, layer_dedup=None, device="cpu",
                      **DYSAT_WIN)
    b = list(data.get_batches(train, B,
                              data.DstRandEdgeSampler(train.dst, 1)))[20]
    got = trainer.embed_step(trainer.init_state(g.max_vertex_id() + 1),
                             g.device_graph("cpu"), torch.from_numpy(ef), b)
    return got, jtrainer.embed_step(jstate, jdg, None, jnp.asarray(ef), b), \
        1e-5


def _embed_graphsage():
    train, _, _, full, nf, ef = _static_stream()
    g, jg = _static_graphs(full)
    model, jmodel = _static_models("sage")
    jtrainer = JTrainer(jmodel, fanouts=list(STATIC_FANOUTS),
                        sample_strategy="recent", is_static=True,
                        layer_dedup=None)
    jdg = jg.device_graph()
    jstate = _jax_state(jtrainer, model)
    trainer = Trainer(model, fanouts=list(STATIC_FANOUTS),
                      sample_strategy="recent", is_static=True,
                      layer_dedup=None, device="cpu")
    b = _static_batch(train, 2)
    got = trainer.embed_step(trainer.init_state(g.max_vertex_id() + 1),
                             g.device_graph("cpu"), torch.from_numpy(ef), b,
                             node_feats=torch.from_numpy(nf))
    return got, jtrainer.embed_step(jstate, jdg, jnp.asarray(nf),
                                    jnp.asarray(ef), b), 1e-5


@pytest.mark.parametrize("model", ["tgn", "dysat", "graphsage"])
def test_embed_step_matches_jax(model):
    """The embeddings of a batch's 3B roots; TGN's memory (random values)
    is not written back."""
    got, want, atol = {"tgn": _embed_tgn, "dysat": _embed_dysat,
                       "graphsage": _embed_graphsage}[model]()
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


# ---- (e): the prequential loop --------------------------------------------

def test_prequential_tgn_loop_matches_jax():
    """Four chunks of 120 edges after 600: score each on the graph of the
    past (two batches, the second padded), ingest it, add its
    destinations to the negative sampler, evict edges older than 250
    before the chunk's end; one set of weights.

    A query whose negative is its own destination scores its positive and
    negative from the same inputs: the port gives both the same bits, XLA
    sometimes rounds the two rows an ulp apart, and AP ranks such a pair
    by that ulp. The per-chunk AP is held over the other queries; these
    pairs are held as ties (port) and to 1e-6 (JAX)."""
    _, _, _, full, _, ef = _stream()
    g, jg, trainer, state, jtrainer, jstate = _tgn_sides(full[:600])
    jef, tef = jnp.asarray(ef), torch.from_numpy(ef)
    neg = data.DstRandEdgeSampler(full.dst[:600], seed=2)
    jneg = jdata.DstRandEdgeSampler(full.dst[:600], seed=2)
    evicted = []
    for step in range(4):
        chunk = full[600 + 120 * step: 720 + 120 * step]
        scores, jscores, labels = [], [], []
        for b, jb in zip(data.get_batches(chunk, B, neg),
                         jdata.get_batches(chunk, B, jneg)):
            _, _, pos, negs = trainer.eval_step(
                state, g.device_graph("cpu"), tef, b)
            jstate, _, jpos, jnegs = jtrainer.eval_step(
                jstate, jg.device_graph(), None, jef, jb)
            k = b.num_valid
            pos, negs = pos[:k].numpy(), negs[:k].numpy()
            jpos, jnegs = np.asarray(jpos)[:k], np.asarray(jnegs)[:k]
            np.testing.assert_allclose(np.concatenate([pos, negs]),
                                       np.concatenate([jpos, jnegs]),
                                       rtol=1e-4, atol=1e-4)
            tn = b.target_nodes
            same = tn[2 * B: 2 * B + k] == tn[B: B + k]
            assert np.array_equal(pos[same], negs[same])
            assert np.abs(jpos[same] - jnegs[same]).max(initial=0) <= 1e-6
            scores += [pos[~same], negs[~same]]
            jscores += [jpos[~same], jnegs[~same]]
            labels += [np.ones((~same).sum()), np.zeros((~same).sum())]
        t = np.concatenate(labels)
        ap = average_precision_score(t, np.concatenate(scores))
        assert abs(ap - jap(t, np.concatenate(jscores))) <= 1e-6, step
        _assert_memory_equal(state.memory, jstate.memory)
        cut = float(chunk.time[-1]) - 250.0
        for x, s in ((g, neg), (jg, jneg)):
            x.add_edges(chunk.src, chunk.dst, chunk.time, chunk.eid,
                        add_reverse=True)
            s.add_dst_list(chunk.dst)
        evicted.append(g.offload_old_blocks(cut))
        assert evicted[-1] == jg.offload_old_blocks(cut)
    assert all(n > 0 for n in evicted)
    # the first view, then one per chunk scored after its store changed:
    # an ingest and the eviction after it refresh the view once
    assert g.uploads == 1 + 3


# ---- (f): the scripts -----------------------------------------------------

ONLINE = ["--model", "TGN", "--synthetic-edges", "3000", "--epoch", "1",
          "--phase2-steps", "6", "--retrain-interval", "3",
          "--time-window", "600", "--device", "cpu"]


@pytest.fixture(scope="module")
def online_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("online") / "TGN_phase1.ckpt")
    fresh = online.main(ONLINE, checkpoint_path=path)
    resumed = online.main(ONLINE[:-6] + ["--retrain-interval", "0",
                                         "--device", "cpu"],
                          checkpoint_path=path)
    return path, fresh, resumed


def test_online_script_on_cpu(online_runs):
    path, fresh, resumed = online_runs
    assert not fresh["resumed"] and resumed["resumed"]
    for run in (fresh, resumed):
        assert len(run["aps"]) == len(run["aucs"]) == 6
        assert all(0.0 < x <= 1.0 for x in run["aps"] + run["aucs"])
        assert len(run["eval_ms"]) == len(run["ingest_ms"]) == 6
        assert run["uploads"] == run["store_changes"] + 1
    assert len(fresh["evicted"]) == 2 and all(n > 0 for n in fresh["evicted"])
    assert len(fresh["retrain_ms"]) == 2 and resumed["evicted"] == []
    assert fresh["phase1_s"] > 0 and resumed["phase1_s"] == 0
    # no retraining in the resumed run: its parameters are the checkpoint's
    saved = load_checkpoint(path)["params"]
    assert saved.keys() == resumed["params"].keys()
    for k, v in saved.items():
        assert torch.equal(resumed["params"][k], v), k


@pytest.mark.parametrize("case", ["tgn_dump", "dysat_windows",
                                  "missing_data"])
def test_inference_script_on_cpu(online_runs, tmp_path, case):
    ckpt = online_runs[0]
    common = ["--synthetic-edges", "3000", "--device", "cpu"]
    if case == "missing_data":       # no synthetic fallback, as in JAX
        with pytest.raises(ValueError, match="does not exist"):
            inference.main(["--data", "WIKI", "--data-dir", str(tmp_path),
                            *common])
        return
    if case == "dysat_windows":
        out = inference.main(["--model", "DySAT", "--batch-size", "200",
                              "--time-windows", "0", "60",
                              "--checkpoint", str(tmp_path / "none.ckpt"),
                              *common])
        assert out["windows"] == [0.0, 60.0] and not out["loaded"]
        assert len(out["ap"]) == len(out["auc"]) == 2
        assert all(0.0 < x <= 1.0 for x in out["ap"] + out["auc"])
        assert out["ap"][0] != out["ap"][1]     # the window took effect
        return
    npz = str(tmp_path / "emb.npz")
    out = inference.main(["--model", "TGN", "--checkpoint", ckpt,
                          "--dump-embeddings", npz, *common])
    assert out["loaded"] and len(out["ap"]) == 1
    test = data.make_synthetic_dataset(num_src=2000, num_dst=500,
                                       num_edges=3000, dim_edge=100,
                                       seed=42)[2]
    n = 2 * len(test)
    with np.load(npz) as d:
        # the JAX script's keys and shapes for the default window [0]
        assert sorted(d.files) == ["embeddings_w0", "labels_w0", "nids_w0",
                                   "scores_w0"]
        assert d["embeddings_w0"].shape == (n, 100)
        assert d["embeddings_w0"].dtype == np.float32
        assert np.isfinite(d["embeddings_w0"]).all()
        assert d["embeddings_w0"].std() > 0
        assert d["scores_w0"].shape == d["labels_w0"].shape == (n,)
        assert d["labels_w0"].sum() == len(test)
        want = np.concatenate([np.concatenate([test.src[lo: lo + 4000],
                                               test.dst[lo: lo + 4000]])
                               for lo in range(0, len(test), 4000)])
        assert np.array_equal(d["nids_w0"], want)
