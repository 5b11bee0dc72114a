"""Multi-GPU training on the CPU: the partitioners, the rank splits of
``get_batches``, partitioned sampling, and data-parallel and partitioned
training over two gloo ranks, against the JAX package.

- The 8 partitioners give JAX's tables, per-partition edge sets (in
  order) and ``partition_metrics`` over a 3-chunk stream (NumPy only).
- Routed and replicated ``sample_hops`` over P = 4 partitions in one
  process equal JAX's ``sample_hops_routed`` on a 4-device CPU mesh bit
  for bit (recent sampling, 2 layers, roots with duplicates, -1 and
  unassigned vertices; and a windowed 2-snapshot layer); under uniform
  sampling they equal the port's single store on the same draws, and
  ``DistributedTemporalSampler`` equals ``TemporalSampler`` from one
  seed.
- One spawn of two gloo ranks serves the module
  (``torch_ranks._training_ranks``: a ``file://`` rendezvous under
  ``tmp_path``; each rank on one thread; the rank functions import no
  jax, the references run in this process, meanwhile).  It runs 3 f32
  TGN train steps at dropout 0, the last batch padded with all its valid
  rows on rank 0, data parallel (``shard_trainer``) and on
  ``PartitionedTrainer`` (routed, P = 4 over W = 2, memory sharded over
  the ranks and gathered for the check): losses, logits, parameters and
  memory (with the mail cursors) held to JAX's ``Trainer``
  within 1e-5 (f32 sum order; timestamps exact); data parallel at three
  negatives per edge against the one-device trainer, within 1e-5; TGAT
  on the layer dedup
  in a step where rank 0 takes the lowest tier and rank 1 falls back,
  whose losses equal the padded run's within 1e-6; ``ShardedTable``'s
  pull and push against a plain gather and scatter; and one tiny epoch
  of each of the three training scripts in the running group.
"""
import os
import pickle
import time

import numpy as np
import pytest
import torch

from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.weights import flax_param_tree
from gnnflow_tpu_torch.ops.sampling import sample_hops
from gnnflow_tpu_torch.parallel import (DistributedTemporalSampler,
                                        PartitionedDynamicGraph,
                                        dispatch_full_dataset,
                                        get_partitioner, partition_metrics,
                                        sample_hops_partitioned,
                                        sample_hops_routed, spawn)
from gnnflow_tpu_torch.temporal_sampler import TemporalSampler
from torch_fixtures import one_cpu_thread  # noqa: F401
from torch_fixtures import B, CFG, FIELDS, _flat, _stream
from torch_ranks import _memory, _tgn_run, _train_batches, _training_ranks

STRATEGIES = ["hash", "roundrobin", "edgecount", "timestampsum",
              "timestampavg", "fennel", "fennel_edge", "static"]


# ---- partitioners and rank splits (NumPy) ----------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_partitioners_match_jax(strategy):
    from gnnflow_tpu.parallel import partition as jpart
    full = data.make_synthetic_dataset(num_src=150, num_dst=50,
                                       num_edges=1500, dim_edge=0,
                                       seed=3)[3]
    table = None
    if strategy == "static":
        table = np.full(120, -1, np.int8)
        table[::3] = np.arange(40) % 4
    ours = get_partitioner(strategy, 4, partition_table=table)
    ref = jpart.get_partitioner(strategy, 4, partition_table=table)
    for lo in (0, 500, 1000):
        c = full[lo: lo + 500]
        got, _ = ours.partition(c.src, c.dst, c.time, c.eid)
        want, _ = ref.partition(c.src, c.dst, c.time, c.eid)
        for a, b in zip(got, want):
            for name in ("src_nodes", "dst_nodes", "timestamps", "eids"):
                assert np.array_equal(getattr(a, name), getattr(b, name))
    assert np.array_equal(ours.get_partition_table(),
                          ref.get_partition_table())
    assert partition_metrics(ours, full.src, full.dst) == \
        jpart.partition_metrics(ref, full.src, full.dst)


@pytest.mark.parametrize("interleave", [False, True])
def test_get_batches_rank_splits_match_jax(interleave):
    from gnnflow_tpu import data as jdata
    full = _stream()[3][:230]
    for rank in range(3):
        kw = dict(num_chunks=4, rank=rank, world_size=3,
                  interleave_indices=interleave)
        got = list(data.get_batches(
            full, 32, data.DstRandEdgeSampler(full.dst, 1),
            rng=np.random.RandomState(7), **kw))
        want = list(jdata.get_batches(
            full, 32, jdata.DstRandEdgeSampler(full.dst, 1),
            rng=np.random.RandomState(7), **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert np.array_equal(a.target_nodes, b.target_nodes)
            assert np.array_equal(a.ts, b.ts)
            assert np.array_equal(a.eids, b.eids)
            assert a.num_valid == b.num_valid


# ---- partitioned sampling in one process -----------------------------

SAMPLING_CASES = {"history": dict(fanouts=[4, 3]),
                  "windowed": dict(fanouts=[3], num_snapshots=2,
                                   window=150.0)}
GRAPH_KW = dict(initial_pool_size=4096, minimum_block_size=8)


def _sampling_inputs():
    """A directed stream (destinations are never sources, so unassigned),
    its 4-way hash split, and 64 roots with duplicates, -1s and
    destinations."""
    full = data.make_synthetic_dataset(num_src=120, num_dst=40,
                                       num_edges=3000, dim_edge=0,
                                       seed=0)[3]
    rng = np.random.RandomState(0)
    roots = rng.randint(0, 160, 64)
    roots[:6] = [-1, -1, 7, 7, 7, 130]
    ts = (rng.rand(64) * full.time.max()).astype(np.float32)
    ts[3] = ts[2]
    return full, roots, ts


def _port_partitioned(full, view=True):
    pg = PartitionedDynamicGraph(4, **GRAPH_KW)
    dispatch_full_dataset(full, None, get_partitioner("hash", 4), pg)
    return pg.device_graph("cpu") if view else pg


def _jax_routed():
    """JAX's ``sample_hops_routed`` on a 4-device CPU mesh, per case."""
    import jax
    import jax.numpy as jnp
    from gnnflow_tpu.parallel import (PartitionedDynamicGraph as JPG,
                                      get_partitioner as jget, make_mesh,
                                      sample_hops_routed as jrouted)
    full, roots, ts = _sampling_inputs()
    mesh = make_mesh(4)
    jpg, jpart = JPG(4, mesh=mesh, **GRAPH_KW), jget("hash", 4)
    parts, _ = jpart.partition(full.src, full.dst, full.time, full.eid)
    jpg.add_partitioned_edges(parts)
    jpg.set_partition_table(jpart.get_partition_table())
    dg = jpg.device_graph()
    out = {}
    for name, case in SAMPLING_CASES.items():
        # jitted, as shard_map run eagerly compiles op by op (~10 s a
        # layer); at P = 4 the default capacity (4·b/P = b) holds every
        # root, so the overflow branches are dead and left out
        fn = jax.jit(lambda g, r, t, case=case: jrouted(
            g, mesh, r, t, strategy="recent", overflow_fallback=False,
            **case))
        mfgs = fn(dg, jnp.asarray(roots, jnp.int32), jnp.asarray(ts))
        out[name] = [[{f: np.asarray(getattr(m, f)) for f in FIELDS}
                      for m in layer] for layer in mfgs]
    return out


@pytest.mark.parametrize("mode", ["routed", "replicated"])
@pytest.mark.parametrize("case", sorted(SAMPLING_CASES))
def test_partitioned_sampling_matches_jax_routed(case, mode, refs):
    full, roots, ts = _sampling_inputs()
    fn = sample_hops_routed if mode == "routed" else sample_hops_partitioned
    got = fn(_port_partitioned(full), torch.from_numpy(roots),
             torch.from_numpy(ts), strategy="recent", **SAMPLING_CASES[case])
    want = refs["routed"][case]
    assert [len(x) for x in got] == [len(x) for x in want]
    for layer, wlayer in zip(got, want):
        for m, w in zip(layer, wlayer):
            for f in FIELDS:
                a = getattr(m, f).numpy()
                assert np.array_equal(a, w[f].astype(a.dtype)), (case, f)
    masked = (roots < 0) | (roots >= 120)     # -1 and destinations
    assert not got[-1][0].nbr_mask.numpy()[masked].any()
    assert got[-1][0].nbr_mask.numpy()[~masked].any()


@pytest.mark.parametrize("mode", ["routed", "replicated"])
@pytest.mark.parametrize("case", sorted(SAMPLING_CASES))
def test_partitioned_uniform_matches_single_store(case, mode):
    full, roots, ts = _sampling_inputs()
    g = DynamicGraph(**GRAPH_KW)
    g.add_edges(full.src, full.dst, full.time, full.eid)

    def draws():
        gen = torch.Generator().manual_seed(11)
        return lambda _, shape: torch.rand(shape, generator=gen)

    kw = dict(strategy="uniform", **SAMPLING_CASES[case])
    r, t = torch.from_numpy(roots), torch.from_numpy(ts)
    want = sample_hops(g.device_graph("cpu"), r, t, draw=draws(), **kw)
    fn = sample_hops_routed if mode == "routed" else sample_hops_partitioned
    got = fn(_port_partitioned(full), r, t, draw=draws(), **kw)
    for layer, wlayer in zip(got, want):
        for m, w in zip(layer, wlayer):
            for f in FIELDS:
                assert torch.equal(getattr(m, f), getattr(w, f)), (case, f)


@pytest.mark.parametrize("mode", ["routed", "replicated"])
@pytest.mark.parametrize("case", sorted(SAMPLING_CASES))
def test_distributed_sampler_matches_temporal_sampler(case, mode):
    """The user-facing samplers, uniform, from one seed: the same draws
    and so the same MFGs."""
    full, roots, ts = _sampling_inputs()
    g = DynamicGraph(**GRAPH_KW)
    g.add_edges(full.src, full.dst, full.time, full.eid)
    c = SAMPLING_CASES[case]
    kw = dict(fanouts=c["fanouts"], sample_strategy="uniform",
              num_snapshots=c.get("num_snapshots", 1),
              snapshot_time_window=c.get("window", 0.0), seed=3,
              device="cpu")
    want = TemporalSampler(g, compact_factor=None, **kw).sample(roots, ts)
    got = DistributedTemporalSampler(_port_partitioned(full, view=False),
                                     mode=mode, **kw).sample(roots, ts)
    for layer, wlayer in zip(got, want):
        for m, w in zip(layer, wlayer):
            for f in FIELDS:
                assert torch.equal(getattr(m, f), getattr(w, f)), (case, f)


# ---- two gloo ranks ----------------------------------------------------

def _jax_tgn():
    """JAX's TGN Trainer (plain GRU and attention) from the port model's
    seed-0 weights over the same 3 batches: per step the loss, logits and
    parameters, then the memory."""
    import jax
    import jax.numpy as jnp
    from gnnflow_tpu import data as jdata
    from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
    from gnnflow_tpu.models import memory as jmemory
    from gnnflow_tpu.models.dgnn import DGNN as JDGNN
    from gnnflow_tpu.train import Trainer as JTrainer
    from gnnflow_tpu.train import TrainState as JTrainState
    _, _, _, full, _, ef = _stream()
    g = JGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    trainer = JTrainer(JDGNN(**CFG), fanouts=[4],
                       sample_strategy="recent", dedup_factor=None,
                       gru_table=False, lr=1e-4, auto_calibrate=False)
    params = jax.tree.map(jnp.asarray,
                          flax_param_tree(DGNN(**CFG, device="cpu")))
    state = JTrainState(
        params=params, opt_state=trainer.tx.init(params),
        memory=jmemory.init_memory(full.max_node + 1, 8, 6),
        key=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    dg, jef = g.device_graph(), jnp.asarray(ef)
    steps = []
    for b in _train_batches(jdata.get_batches, jdata.DstRandEdgeSampler, full):
        state, loss, pos, neg = trainer.train_step(state, dg, None, jef, b)
        steps.append((float(loss), np.asarray(pos), np.asarray(neg),
                      _flat(jax.tree.map(np.asarray, state.params))))
    return {"steps": steps, "memory": _memory(state.memory)}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Starts the two ranks, then computes the JAX references here while
    they (and this module's tests up to ``ranks``) run: JAX's routed
    samples and its TGN run.  Stops ranks never joined at teardown."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    procs = spawn(_training_ranks, 2, "cpu", out_dir,
                  init_method="file://" + os.path.join(out_dir, "rdv"),
                  join=False)
    state = {"out_dir": out_dir, "procs": procs}
    try:
        state.update(routed=_jax_routed(), tgn=_jax_tgn())
        yield state
    finally:
        for p in procs.processes:
            if p.is_alive() and "ranks" not in state:
                p.terminate()
            p.join()


@pytest.fixture(scope="module")
def ranks(refs):
    """The two ranks' results and JAX's TGN reference."""
    deadline = time.monotonic() + 300
    while not refs["procs"].join(timeout=5):
        if time.monotonic() > deadline:
            raise TimeoutError("the two ranks ran past 300 s")
    got = []
    for r in range(2):
        with open(os.path.join(refs["out_dir"], f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    refs["ranks"] = got
    return got, refs["tgn"]


@pytest.mark.parametrize("kind", ["dp", "partitioned"])
def test_tgn_two_ranks_match_jax(kind, ranks):
    got, ref = ranks
    assert len(got[0][kind]["steps"]) == len(ref["steps"]) == 3
    for rank in range(2):
        run = got[rank][kind]
        for (loss, pos, neg, params), (jloss, jpos, jneg, jparams) in zip(
                run["steps"], ref["steps"]):
            np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(pos, jpos, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(neg, jneg, rtol=1e-5, atol=1e-5)
            assert params.keys() == jparams.keys()
            for name, w in jparams.items():
                np.testing.assert_allclose(params[name], w, rtol=0,
                                           atol=1e-5, err_msg=str(name))
        for name, w in ref["memory"].items():
            if name.endswith("_ts"):
                assert np.array_equal(run["memory"][name], w), name
            else:
                np.testing.assert_allclose(run["memory"][name], w,
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=name)
    # the ranks hold one state
    for a, b in zip(got[0][kind]["steps"], got[1][kind]["steps"]):
        assert a[0] == b[0]
        for name in a[3]:
            assert np.array_equal(a[3][name], b[3][name])


def test_tgn_dp_with_negatives_matches_one_device(ranks):
    """Data parallel at three negatives per edge: each rank slices all
    five blocks, the write-back gathers them back in the single-device
    order, and the negative logits come back in it (the one-device
    trainer is held to JAX's at this ratio in
    tests/test_torch_variants.py); within 1e-5, f32 sum order."""
    got, _ = ranks
    one = _tgn_run("one", ratio=3)
    for rank in range(2):
        run = got[rank]["dp_ratio3"]
        for s, o in zip(run["steps"], one["steps"]):
            assert s[2].shape == o[2].shape == (3 * B,)
            for a, b in zip(s[:3], o[:3]):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            for name, w in o[3].items():
                np.testing.assert_allclose(s[3][name], w, rtol=0,
                                           atol=1e-5, err_msg=str(name))
        for name, w in one["memory"].items():
            np.testing.assert_allclose(run["memory"][name], w, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_tgat_ranks_on_different_tiers_match_padded(ranks):
    got, _ = ranks
    r0, r1 = got[0]["tgat"], got[1]["tgat"]
    # rank 0 took the lowest tier, rank 1 fell back; the step counts the
    # worst take on both ranks
    assert r0["dedup"]["takes"][0] == 0 and r1["dedup"]["takes"][0] == 2
    assert r0["dedup"]["tier_takes"] == r1["dedup"]["tier_takes"]
    assert r0["dedup"]["tier_takes"][2] >= 1
    for r in (r0, r1):
        np.testing.assert_allclose(r["dedup"]["losses"],
                                   r["padded"]["losses"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["dedup"]["pos"], r["padded"]["pos"],
                                   rtol=1e-5, atol=1e-5)


def test_sharded_table_pull_push(ranks):
    got, _ = ranks
    table = np.arange(30, dtype=np.float32).reshape(10, 3)
    want = table.copy()
    for r in range(2):
        t = got[r]["table"]
        ids = np.asarray(t["ids"], np.int64)
        np.testing.assert_array_equal(
            t["pulled"].reshape(-1, 3), table[np.clip(ids, 0, 9)])
        for i, row in zip(t["push_ids"], t["rows"]):
            if 0 <= i < 10:
                want[i] = row
        assert t["bytes"] == 10 * 3 * 4
    for r in range(2):
        np.testing.assert_array_equal(got[r]["table"]["after"], want)
        np.testing.assert_array_equal(got[r]["table"]["local"],
                                      want[5 * r: 5 * r + 5])


@pytest.mark.parametrize("script", ["offline", "partitioned",
                                    "multiprocess"])
def test_scripts_run_on_two_ranks(script, ranks):
    got, _ = ranks
    a, b = (got[r]["scripts"][script] for r in range(2))
    assert len(a["val_ap"]) == 1 and 0.0 < a["val_ap"][0] <= 1.0
    assert a["val_ap"] == b["val_ap"]           # from the gathered logits
    if script == "offline":
        assert a["test_ap"] == b["test_ap"] and 0.0 < a["test_ap"] <= 1.0
        assert got[0]["scripts"]["checkpoint"]
    else:
        assert a["loss"] == b["loss"] and np.isfinite(a["loss"]).all()
        assert a["load_cv"] == b["load_cv"]
        parts = 2 if script == "multiprocess" else 4
        assert len(a["partition_sizes"]) + len(b["partition_sizes"]) \
            == parts
        assert min(a["partition_sizes"] + b["partition_sizes"]) > 0


def test_gen_partition_table_matches_jax(tmp_path):
    from gnnflow_tpu import data as jdata
    from gnnflow_tpu.parallel import partition as jpart
    from gnnflow_tpu_torch.scripts import gen_partition_table
    path = gen_partition_table.main(
        ["--num-partitions", "4", "--ratio", "0.1", "--chunk", "4000",
         "--out-dir", str(tmp_path)])
    assert os.path.basename(path) == "synthetic_fennel_partition.npz"
    full = jdata.make_synthetic_dataset(num_src=2000, num_dst=500,
                                        num_edges=100_000, dim_edge=0)[3]
    ref = jpart.get_partitioner("fennel", 4)
    for lo in range(0, 10_000, 4000):
        sl = slice(lo, min(lo + 4000, 10_000))
        ref.partition(full.src[sl], full.dst[sl], full.time[sl],
                      full.eid[sl])
    assert np.array_equal(np.load(path)["partition_table"],
                          ref.get_partition_table())
