"""The feature cache in gnnflow_tpu_torch against the JAX package, on the
CPU, on the tiny stream of tests/test_cache.py (100 sources, 30
destinations, 2,000 edges, 8-dim edge and 6-dim node features, undirected)
at batch 100 and fanout 5: ``mfgs_to_host``, ``TemporalSampler``, the four
policies in f32 and bf16 transfer, ``train_step_prefetched``, the
``FeaturePipeline``, the host-placed store, ``PhaseTimer`` and
``load_feat(memmap=True)``.

Tolerances: fetched features, hit ratios, the flag and slot maps and the
MFGs are equal bit for bit (the bookkeeping is the same NumPy calls, and
bf16 rows round to nearest even on both sides).  The prefetched TGN steps
(f32, dropout 0) hold losses and logits to 1e-4 and parameters to 1e-6
absolute and memory to 1e-4, as tests/test_torch_train.py holds the
resident step; against the port's own ``train_step`` on the same inputs
they are equal bit for bit.  The JAX states are built from the port's
weights (``flax_param_tree``), so no JAX ``init_state`` compiles.
"""
import logging
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu import cache as jcache
from gnnflow_tpu import data as jdata
from gnnflow_tpu.cache.cache import mfgs_to_host as jmfgs_to_host
from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.temporal_sampler import TemporalSampler as JSampler
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu.train import TrainState as JTrainState
from gnnflow_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from gnnflow_tpu_torch import cache, data
from gnnflow_tpu_torch.cache.cache import mfgs_to_host
from gnnflow_tpu_torch.dynamic_graph import STORAGE_ALIASES, DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.weights import flax_param_tree
from gnnflow_tpu_torch.pipeline import FeaturePipeline
from gnnflow_tpu_torch.temporal_sampler import TemporalSampler
from gnnflow_tpu_torch.train import Trainer
from gnnflow_tpu_torch.utils.profiling import (PhaseTimer,
                                               device_memory_stats)
from tests.test_torch_apan import _jax_memory
from tests.test_torch_kernels import one_cpu_thread  # noqa: F401
from tests.test_torch_tgat import _assert_mfgs_identical
from tests.test_torch_train import _assert_memory_equal, _flat

B = 100
POLICIES = ["LRUCache", "LFUCache", "FIFOCache", "GNNLabStaticCache"]


@pytest.fixture(scope="module")
def stream():
    """The stream of tests/test_cache.py:18-27 (byte-identical from the
    port's generator) and its store on both sides."""
    train, _, _, full, nf, ef = data.make_synthetic_dataset(
        num_src=100, num_dst=30, num_edges=2000, dim_edge=8, dim_node=6,
        seed=0)
    g = DynamicGraph(initial_pool_size=4096, minimum_block_size=8)
    jg = JGraph(initial_pool_size=4096, maximum_pool_size=1 << 22,
                mem_resource_type="hbm", minimum_block_size=8,
                insertion_policy="insert")
    for x in (g, jg):
        x.add_edges(full.src, full.dst, full.time, full.eid,
                    add_reverse=True)
    return dict(train=train, full=full, nf=nf, ef=ef, g=g, jg=jg,
                num_nodes=g.max_vertex_id() + 1)


def _batches(train, n):
    return list(zip(
        range(n),
        data.get_batches(train, B, data.DstRandEdgeSampler(train.dst, 1)),
        jdata.get_batches(train, B, jdata.DstRandEdgeSampler(train.dst, 1))))


def _jax_draws(jsampler):
    """The key the JAX sampler's next call draws from (its ``_next_key``
    without advancing it)."""
    _, sub = jax.random.split(jsampler._key)
    return sub


def _arrays(x):
    """The arrays of ``mfgs_to_host``'s nested lists, in order."""
    if isinstance(x, np.ndarray):
        return [x]
    return [a for y in x for a in _arrays(y)]


def _uniform(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(
        key, shape, dtype=jnp.float32)))


# ---- the sampler and mfgs_to_host -----------------------------------------

@pytest.mark.parametrize("mode", ["recent", "uniform", "static"])
def test_temporal_sampler_matches_jax(stream, mode):
    """Two layers (fanouts 5, 3): ``sample`` and ``sample_layer`` give
    MFGs equal to JAX's bit for bit, and ``mfgs_to_host`` the same arrays.
    Uniform draws are JAX's, passed to the port's sampler."""
    kw = dict(fanouts=[5, 3], is_static=mode == "static",
              sample_strategy="uniform" if mode == "uniform" else "recent")
    sampler = TemporalSampler(stream["g"], device="cpu", **kw)
    jsampler = JSampler(stream["jg"], **kw)
    assert (sampler.num_layers, sampler.num_snapshots, sampler.fanouts) == \
        (jsampler.num_layers, jsampler.num_snapshots, jsampler.fanouts)
    (_, b, jb), = _batches(stream["train"][600:], 1)
    if mode == "uniform":
        key = _jax_draws(jsampler)
        sampler._draw = lambda layer, shape: _uniform(
            jax.random.fold_in(key, layer), shape)
    got = sampler.sample(b.target_nodes, b.ts)
    want = jsampler.sample(jb.target_nodes, jb.ts)
    for layer, jlayer in zip(got, want):
        for m, jm in zip(layer, jlayer):
            _assert_mfgs_identical(m, jm)
    ours, ref = _arrays(mfgs_to_host(got)), _arrays(jmfgs_to_host(want))
    assert len(ours) == len(ref) == 2 + 2 * 2
    for x, y in zip(ours, ref):
        assert x.shape == y.shape and np.array_equal(x, y)
    if mode == "uniform":
        key = _jax_draws(jsampler)
        sampler._draw = lambda layer, shape: _uniform(key, shape)
    m = sampler.sample_layer(b.target_nodes, b.ts, 1, 0)
    jm = jsampler.sample_layer(jb.target_nodes, jb.ts, 1, 0)
    _assert_mfgs_identical(m, jm)


# ---- the four policies --------------------------------------------------

def _caches(stream, name, ratio=0.2, transfer_dtype="float32"):
    args = (ratio, ratio, stream["num_nodes"], len(stream["full"]),
            stream["nf"], stream["ef"])
    return (cache.CACHES[name](*args, transfer_dtype=transfer_dtype,
                               device="cpu"),
            jcache.CACHES[name](*args, transfer_dtype=transfer_dtype))


def _assert_cache_state(c, jc):
    assert c.cache_node_ratio == jc.cache_node_ratio
    assert c.cache_edge_ratio == jc.cache_edge_ratio
    for kind, jkind in ((c.node_cache, jc.node_cache),
                        (c.edge_cache, jc.edge_cache)):
        for f in ("flag", "map", "rmap"):
            assert np.array_equal(getattr(kind, f), getattr(jkind, f)), f
        assert kind.hits == jkind.hits and kind.total == jkind.total


def _assert_bits(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("transfer_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", POLICIES)
def test_cache_matches_jax(stream, name, transfer_dtype):
    """Five batches through each policy at ratio 0.2: node, edge and
    target-edge features equal JAX's bit for bit, and so do the hit
    ratios, ``flag``, ``map`` and ``rmap`` after the seeding and after
    every batch.  In f32 every fetch equals the direct gather."""
    c, jc = _caches(stream, name, transfer_dtype=transfer_dtype)
    sampler = TemporalSampler(stream["g"], [5], device="cpu")
    jsampler = JSampler(stream["jg"], [5])
    if name == "GNNLabStaticCache":
        c.init_cache(sampler=sampler, train_data=stream["train"],
                     pre_sampling_rounds=1, batch_size=200)
        jc.init_cache(sampler=jsampler, train_data=stream["train"],
                      pre_sampling_rounds=1, batch_size=200)
    else:
        c.init_cache()
        jc.init_cache()
    _assert_cache_state(c, jc)
    nf, ef = torch.from_numpy(stream["nf"]), torch.from_numpy(stream["ef"])
    for _, b, jb in _batches(stream["train"], 5):
        mfgs = sampler.sample(b.target_nodes, b.ts)
        nfs, efs = c.fetch_feature(mfgs, b.eids)
        jnfs, jefs = jc.fetch_feature(jsampler.sample(jb.target_nodes,
                                                      jb.ts), jb.eids)
        _assert_bits(nfs[0], jnfs[0])
        _assert_bits(efs[0][0], jefs[0][0])
        _assert_bits(c.target_edge_features, jc.target_edge_features)
        _assert_cache_state(c, jc)
        if transfer_dtype == "float32":
            m = mfgs[0][0]
            for got, table, ids, valid in (
                    (nfs[0], nf, m.all_nodes(), m.all_mask()),
                    (efs[0][0], ef, m.nbr_eids, m.nbr_mask)):
                want = torch.where(valid[..., None],
                                   table[ids.clamp(min=0)], 0.0)
                assert torch.equal(got, want)
            assert torch.equal(c.target_edge_features,
                               ef[torch.from_numpy(b.eids)])
    assert c.edge_cache.buffer.dtype == torch.float32
    assert c.get_mem_size() == jc.get_mem_size() > 0


def test_zero_capacity_passes_through(stream):
    """Without capacity every row comes from the master table in f32,
    also with bf16 transfer, as JAX's."""
    c, jc = _caches(stream, "FIFOCache", ratio=0.0,
                    transfer_dtype="bfloat16")
    c.init_cache()
    jc.init_cache()
    (_, b, jb), = _batches(stream["train"], 1)
    mfgs = TemporalSampler(stream["g"], [5], device="cpu").sample(
        b.target_nodes, b.ts)
    nfs, efs = c.fetch_feature(mfgs, b.eids)
    jnfs, jefs = jc.fetch_feature(JSampler(stream["jg"], [5]).sample(
        jb.target_nodes, jb.ts), jb.eids)
    _assert_bits(nfs[0], jnfs[0])
    _assert_bits(efs[0][0], jefs[0][0])
    m = mfgs[0][0]
    want = torch.where(m.nbr_mask[..., None], torch.from_numpy(
        stream["ef"])[m.nbr_eids], 0.0)
    assert torch.equal(efs[0][0], want)
    _assert_cache_state(c, jc)


def test_static_cache_without_sampler_warns_as_jax(stream, caplog):
    c, jc = _caches(stream, "GNNLabStaticCache")
    with caplog.at_level(logging.WARNING):
        c.init_cache()
        jc.init_cache()
    warned = [r.getMessage() for r in caplog.records
              if r.levelno == logging.WARNING]
    assert len(warned) == 2 and warned[0] == warned[1]
    assert "without sampler/train_data" in warned[0]
    _assert_cache_state(c, jc)


def test_cache_refuses_what_it_lacks(stream):
    # a master with ``pull`` (a sharded table) is taken, and its misses
    # come in f32 whatever the transfer dtype, as JAX's sharded master
    from gnnflow_tpu_torch.parallel import ShardedTable
    ef = stream["ef"][:10]
    c = cache.LRUCache(0.2, 0.2, 10, 10, None, ShardedTable(ef),
                       transfer_dtype="bfloat16", device="cpu")
    assert c.edge_cache.distributed and c.edge_cache._tdt == torch.float32
    ids = np.array([9, 0, 4])
    assert torch.equal(c.edge_cache._pull(ids, torch.bfloat16),
                       torch.from_numpy(ef[ids]))
    with pytest.raises(ValueError):
        cache.LRUCache(0.2, 0.2, 10, 10, None, stream["ef"],
                       transfer_dtype="float16", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cache.LRUCache(0.2, 0.2, 10, 10, None, stream["ef"])
        with pytest.raises(RuntimeError, match="CUDA"):
            TemporalSampler(stream["g"], [5])


# ---- the prefetched step ------------------------------------------------

TGN = dict(dim_edge=8, dim_time=8, dim_embed=8, num_layers=1,
           num_snapshots=1, att_head=2, dropout=0.0, att_dropout=0.0,
           use_memory=True, dim_memory=8)


def _jax_state(jtrainer, model, memory):
    """Committed to the device, as the step's outputs are, so that the
    step compiles once."""
    params = jax.tree.map(jnp.asarray, flax_param_tree(model))
    return jax.device_put(
        JTrainState(params=params, opt_state=jtrainer.tx.init(params),
                    memory=_jax_memory(memory), key=jax.random.PRNGKey(0),
                    step=jnp.zeros((), jnp.int32)), jax.devices()[0])


@pytest.mark.parametrize("dim_node, dedup", [(6, None), (0, 0.5)],
                         ids=["node-feats", "dedup"])
def test_prefetched_step_matches_jax(stream, dim_node, dedup):
    """Three TGN train steps through an LRU cache at 0.3 against JAX's
    ``train_step_prefetched``: with node features, and on the memory
    dedup at 0.5 without.  (Its eval form, ``train=False``, is held to
    the port's ``eval_step`` below.)"""
    nf = stream["nf"] if dim_node else None
    args = (0.3, 0.3, stream["num_nodes"], len(stream["full"]), nf,
            stream["ef"])
    c = cache.LRUCache(*args, device="cpu")
    jc = jcache.LRUCache(*args)
    c.init_cache()
    jc.init_cache()
    sampler = TemporalSampler(stream["g"], [5], device="cpu")
    jsampler = JSampler(stream["jg"], [5])
    model = DGNN(**TGN, dim_node=dim_node, device="cpu")
    trainer = Trainer(model, fanouts=[5], dedup_factor=dedup, device="cpu")
    state = trainer.init_state(stream["num_nodes"])
    jtrainer = JTrainer(JDGNN(**TGN, dim_node=dim_node), fanouts=[5],
                        dedup_factor=dedup, gru_table=False)
    jstate = _jax_state(jtrainer, model, state.memory)
    for _, b, jb in _batches(stream["train"], 3):
        mfgs = sampler.sample(b.target_nodes, b.ts)
        nfs, efs = c.fetch_feature(mfgs, b.eids)
        state, loss, pos, neg = trainer.train_step_prefetched(
            state, mfgs, nfs, efs, c.target_edge_features, b)
        jmfgs = jsampler.sample(jb.target_nodes, jb.ts)
        jnfs, jefs = jc.fetch_feature(jmfgs, jb.eids)
        jstate, jloss, jpos, jneg = jtrainer.train_step_prefetched(
            jstate, jmfgs, jnfs, jefs, jc.target_edge_features, jb)
        for got, want in ((loss, jloss), (pos, jpos), (neg, jneg)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
        got = _flat(flax_param_tree(model))
        want = _flat(jax.tree.map(np.asarray, jstate.params))
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-6,
                                       err_msg=str(name))
        _assert_memory_equal(state.memory, jstate.memory)
        if dedup:
            assert state.dedup_n_uniq is not None
    assert state.step == 3


@pytest.mark.parametrize("dedup", [None, 0.5])
def test_prefetched_step_equals_train_step(stream, dedup):
    """From one state, the prefetched step through an LRU cache at 0.3
    and the resident ``train_step`` (then ``eval_step``) give the same
    bits: the cache's features equal the direct gather's."""
    ef = torch.from_numpy(stream["ef"])
    runs = []
    for prefetched in (False, True):
        model = DGNN(**TGN, dim_node=0, device="cpu")
        trainer = Trainer(model, fanouts=[5], dedup_factor=dedup,
                          device="cpu")
        state = trainer.init_state(stream["num_nodes"])
        c = cache.LRUCache(0.3, 0, stream["num_nodes"], len(stream["full"]),
                           None, stream["ef"], device="cpu")
        c.init_cache()
        sampler = TemporalSampler(stream["g"], [5], device="cpu")
        dg = stream["g"].device_graph("cpu")
        out = []
        for i, b, _ in _batches(stream["train"], 4):
            if prefetched:
                mfgs = sampler.sample(b.target_nodes, b.ts)
                _, efs = c.fetch_feature(mfgs, b.eids)
                r = trainer.train_step_prefetched(
                    state, mfgs, None, efs, c.target_edge_features, b,
                    train=i < 3)
            else:
                step = trainer.train_step if i < 3 else trainer.eval_step
                r = step(state, dg, ef, b)
            out.append([t.clone() for t in r[1:]])
        out.append([p.detach().clone() for p in model.parameters()])
        out.append([state.memory.node_memory.clone(),
                    state.memory.mailbox.clone()])
        runs.append(out)
    for a, w in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, w))


# ---- the pipeline -------------------------------------------------------

def _fetch_all(sampler, c, batches):
    out = []
    for b in batches:
        mfgs = sampler.sample(b.target_nodes, b.ts)
        nfs, efs = c.fetch_feature(mfgs, b.eids)
        out.append((b, mfgs, nfs, efs, c.target_edge_features))
    return out


def test_pipeline_yields_the_serial_tuples(stream):
    batches = [b for _, b, _ in _batches(stream["train"], 6)]
    runs = []
    for piped in (False, True):
        c, _ = _caches(stream, "LRUCache")
        c.init_cache()
        sampler = TemporalSampler(stream["g"], [5], device="cpu")
        items = list(FeaturePipeline(sampler, c).run(iter(batches))) \
            if piped else _fetch_all(sampler, c, batches)
        runs.append((items, c.cache_node_ratio, c.cache_edge_ratio))
    (serial, *ratios), (piped, *pratios) = runs
    assert ratios == pratios and len(piped) == len(serial) == 6
    for (b, mfgs, nfs, efs, tef), (pb, pm, pn, pe, pt) in zip(serial, piped):
        assert pb is b
        _assert_mfgs_identical(pm[0][0], mfgs[0][0])
        assert torch.equal(pn[0], nfs[0]) and torch.equal(pe[0][0], efs[0][0])
        assert torch.equal(pt, tef)


def _worker_threads():
    return [t for t in threading.enumerate()
            if t is not threading.main_thread() and t.daemon]


def test_pipeline_raises_worker_errors_and_drains(stream):
    batches = [b for _, b, _ in _batches(stream["train"], 6)]
    c, _ = _caches(stream, "FIFOCache")
    sampler = TemporalSampler(stream["g"], [5], device="cpu")
    before = len(_worker_threads())

    class Failing:
        calls = 0

        def sample(self, *a):
            Failing.calls += 1
            if Failing.calls == 2:
                raise KeyError("sampler failed")
            return sampler.sample(*a)

    got = []
    with pytest.raises(KeyError, match="sampler failed"):
        for item in FeaturePipeline(Failing(), c).run(iter(batches)):
            got.append(item)
    assert len(got) == 1

    sampled = []

    class Counting:
        def sample(self, *a):
            sampled.append(1)
            return sampler.sample(*a)

    run = FeaturePipeline(Counting(), c, depth=1).run(iter(batches))
    next(run)
    run.close()                         # an early break
    deadline = time.time() + 10
    while len(_worker_threads()) > before and time.time() < deadline:
        time.sleep(0.01)
    assert len(_worker_threads()) == before
    assert len(sampled) < len(batches)


# ---- the store's placement ----------------------------------------------

@pytest.mark.parametrize("kind", sorted(STORAGE_ALIASES) + ["disk"])
def test_storage_aliases_match_jax(kind):
    if kind == "disk":
        with pytest.raises(ValueError):
            DynamicGraph(initial_pool_size=1024, mem_resource_type=kind)
        with pytest.raises(ValueError):
            JGraph(initial_pool_size=1024, mem_resource_type=kind)
        return
    g = DynamicGraph(initial_pool_size=1024, mem_resource_type=kind)
    jg = JGraph(initial_pool_size=1024, mem_resource_type=kind)
    assert g.placement == jg.placement


def test_host_store_samples_on_the_cpu(stream):
    """A store placed on the host is sampled on the CPU whatever the
    sampler's device; its MFGs equal the other store's."""
    full = stream["full"]
    g = DynamicGraph(initial_pool_size=4096, minimum_block_size=8,
                     mem_resource_type="unified")
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    sampler = TemporalSampler(g, [5], device="cpu")
    assert sampler.sample_device.type == "cpu"
    (_, b, _), = _batches(stream["train"], 1)
    got = sampler.sample(b.target_nodes, b.ts)[0][0]
    want = TemporalSampler(stream["g"], [5], device="cpu").sample(
        b.target_nodes, b.ts)[0][0]
    assert got.nbr_eids.device.type == "cpu"
    for f in ("root_nids", "nbr_nids", "nbr_ts", "nbr_eids", "nbr_mask"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises((ValueError, RuntimeError)):
        g.device_graph("cuda")


# ---- profiling and memory-mapped features -------------------------------

def test_phase_timer_and_profiling_match_jax():
    t, jt = PhaseTimer(), JPhaseTimer()
    for x in (t, jt):
        for phase, s in (("train", 0.5), ("sample", 0.25), ("train", 1.0)):
            x.add(phase, s)
    assert t.summary() == jt.summary() and t.format() == jt.format()
    with t("feature"):
        pass
    assert t.summary()["feature"]["count"] == 1
    t.reset()
    assert t.summary() == {}
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def test_memmap_features_feed_the_cache(stream, tmp_path):
    for name, t in (("node_features.npy", stream["nf"]),
                    ("edge_features.npy", stream["ef"])):
        (tmp_path / "D").mkdir(exist_ok=True)
        np.save(tmp_path / "D" / name, t)
    nf, ef = data.load_feat("D", str(tmp_path), memmap=True)
    jnf, jef = jdata.load_feat("D", str(tmp_path), memmap=True)
    for x, jx, t in ((nf, jnf, stream["nf"]), (ef, jef, stream["ef"])):
        assert isinstance(x, np.memmap) and not x.flags.writeable
        assert np.array_equal(x, jx) and np.array_equal(x, t)
    c = cache.FIFOCache(0.2, 0.2, stream["num_nodes"], len(stream["full"]),
                        nf, ef, device="cpu")
    c.init_cache()
    (_, b, _), = _batches(stream["train"], 1)
    mfgs = TemporalSampler(stream["g"], [5], device="cpu").sample(
        b.target_nodes, b.ts)
    _, efs = c.fetch_feature(mfgs, b.eids)
    m = mfgs[0][0]
    assert torch.equal(efs[0][0], torch.where(
        m.nbr_mask[..., None], torch.from_numpy(stream["ef"])[m.nbr_eids],
        0.0))
