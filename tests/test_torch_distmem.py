"""Distributed memory and features on the CPU: the loaders of part files,
TGN and APAN memory sharded over two gloo ranks, the memory dedup over
sharded node features, the cache over sharded masters, the multiprocess
script's ``--cache``, bf16 memory storage and the parity harness, against
the JAX package.

One spawn of two gloo ranks serves the module
(``torch_ranks._memory_ranks``, a ``file://`` rendezvous under
``tmp_path``, each rank on one thread; the rank functions import no jax),
beside one single-rank spawn of the multiprocess script; the JAX
references run in this process meanwhile.

Tolerances:
- loaders: bit-equal edge tables and feature rows (the same csv and npy
  files read by both packages).
- sharded memory: 4 f32 train steps (the last batch padded, all its valid
  rows on rank 0) through ``PartitionedTrainer`` on sharded memory equal
  the same trainer on replicated memory exactly (losses, logits,
  parameters, memory): a routed pull moves the same values and each rank
  writes its own rows of the same winners.  APAN runs on per-instance
  rows and on its K/V table pull, which over sharded memory each rank
  serves from its own block (the table's ``dW`` summed by the gradients'
  all-reduce; its mail rows' kernel gradient thus sums in another
  order, so that run is held to its replicated twin within 1e-6).  Against JAX's ``Trainer`` on
  the single store: losses, logits and parameters within 1e-5 (f32 sum
  order; Adam's first step is ``lr·sign(g)``); TGN's memory within 1e-5,
  APAN's within 1e-4 (its LayerNorm over 8 values magnifies f32 rounding,
  as ``tests/test_torch_apan.py`` states); timestamps and cursors exact.
  The dedup (factor 0.9, every step fits) is exact, so it is held to the
  same JAX run.
- ranks on different dedup branches: the dedup is exact, so both ranks'
  losses equal the per-instance run's within 1e-6, and each other's
  exactly.
- the cache over sharded masters: the same features (bit for bit) and
  hit ratios as JAX's host-master cache on the same samples.
- the multiprocess script with ``--cache``: two ranks equal one rank
  exactly (losses, APs, hit ratios), the learning rate given so that
  ``lr·sqrt(ranks)`` agrees.
- bf16 storage: 4 f32-compute TGN steps against JAX's
  ``memory_storage="bfloat16"``: losses and parameters within 1e-5, the
  stored memory and mails within one bf16 step of the value (2^-7
  relative: a value within f32 rounding of a rounding boundary may land
  on the other side), timestamps exact.
"""
import os
import pickle
import time

import numpy as np
import pytest
import torch

from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.weights import flax_param_tree
from gnnflow_tpu_torch.parallel import spawn
from gnnflow_tpu_torch.train import Trainer
from torch_fixtures import one_cpu_thread  # noqa: F401
from torch_fixtures import _flat
from torch_parity import _assert_tables_equal, jax_state
from torch_ranks import (CACHE_BATCHES, MEM_MODELS, MEM_TGN, _cache_stream,
                         _mem_batches, _mem_stream, _memory, _memory_one_rank,
                         _memory_ranks)


# ---- the JAX references -------------------------------------------------

def _jax_mem(name):
    """JAX's Trainer (plain GRU and attention) from the port model's
    seed-0 weights over the same batches on the single store: per step
    the loss, logits and parameters, then the memory."""
    import jax
    import jax.numpy as jnp
    from gnnflow_tpu import data as jdata
    from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
    from gnnflow_tpu.models.dgnn import DGNN as JDGNN
    from gnnflow_tpu.train import Trainer as JTrainer
    _, _, _, full, nf, ef = _mem_stream()
    g = JGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    cfg = MEM_MODELS[name]
    trainer = JTrainer(JDGNN(**cfg), fanouts=[4], sample_strategy="recent",
                       dedup_factor=None, gru_table=False, lr=1e-4,
                       auto_calibrate=False)
    state = jax_state(trainer, DGNN(**cfg, device="cpu"), full.max_node + 1)
    dg, jef = g.device_graph(), jnp.asarray(ef)
    jnf = jnp.asarray(nf) if name == "tgn" else None
    steps = []
    for b in _mem_batches(jdata.get_batches, jdata.DstRandEdgeSampler, full):
        state, loss, pos, neg = trainer.train_step(state, dg, jnf, jef, b)
        steps.append((float(loss), np.asarray(pos), np.asarray(neg),
                      _flat(jax.tree.map(np.asarray, state.params))))
    return {"steps": steps, "memory": _memory(state.memory)}


def _jax_cache():
    """JAX's host-master LRU and FIFO caches over the same samples (the
    JAX ``TemporalSampler``, which the port's equals bit for bit), and
    its zero-capacity cache."""
    from gnnflow_tpu import data as jdata
    from gnnflow_tpu.cache import FIFOCache as JFIFO
    from gnnflow_tpu.cache import LRUCache as JLRU
    from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
    from gnnflow_tpu.temporal_sampler import TemporalSampler as JSampler
    train, _, _, full, nf, ef = jdata.make_synthetic_dataset(
        num_src=100, num_dst=30, num_edges=2000, dim_edge=8, dim_node=6,
        seed=0)
    g = JGraph(initial_pool_size=4096, maximum_pool_size=1 << 22,
               mem_resource_type="hbm", minimum_block_size=8,
               insertion_policy="insert")
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    sampler = JSampler(g, fanouts=[5])
    kw = dict(edge_cache_ratio=0.2, node_cache_ratio=0.2,
              num_nodes=g.max_vertex_id() + 1, num_edges=len(full))
    out = {}
    for cls, name in ((JLRU, "LRUCache"), (JFIFO, "FIFOCache")):
        c = cls(node_feats=nf, edge_feats=ef, **kw)
        c.init_cache()
        got = []
        neg = jdata.DstRandEdgeSampler(train.dst, seed=1)
        for i, batch in enumerate(jdata.get_batches(train, 100, neg)):
            if i >= CACHE_BATCHES:
                break
            mfgs = sampler.sample(batch.target_nodes, batch.ts)
            nfs, efs = c.fetch_feature(mfgs, batch.eids)
            got.append((np.asarray(nfs[0]), np.asarray(efs[0][0]),
                        np.asarray(c.target_edge_features),
                        c.cache_node_ratio, c.cache_edge_ratio))
        out[name] = got
    c = JLRU(edge_cache_ratio=0, node_cache_ratio=0,
             num_nodes=g.max_vertex_id() + 1, num_edges=len(full),
             node_feats=nf, edge_feats=ef)
    c.init_cache()
    batch = next(iter(jdata.get_batches(
        train, 64, jdata.DstRandEdgeSampler(train.dst, seed=1))))
    mfgs = JSampler(g, fanouts=[4]).sample(batch.target_nodes, batch.ts)
    out["zero"] = np.asarray(c.fetch_feature(mfgs, batch.eids)[0][0])
    return out


def _write_parts(d):
    rng = np.random.RandomState(0)
    parts = [rng.randn(n, 5).astype(np.float32) for n in (13, 7, 22)]
    os.makedirs(d, exist_ok=True)
    for i, p in enumerate(parts):
        np.save(os.path.join(d, f"node_features_{i}.npy"), p)
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Starts the two ranks and the single rank, then computes the JAX
    references here while they run.  Stops processes never joined at
    teardown."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    parts = _write_parts(os.path.join(out_dir, "MAGLIKE"))
    procs = [spawn(_memory_ranks, 2, "cpu", out_dir,
                   init_method="file://" + os.path.join(out_dir, "rdv"),
                   join=False),
             spawn(_memory_one_rank, 1, "cpu", out_dir,
                   init_method="file://" + os.path.join(out_dir, "rdv1"),
                   join=False)]
    state = {"out_dir": out_dir, "procs": procs, "parts": parts}
    try:
        state.update(tgn=_jax_mem("tgn"), apan=_jax_mem("apan"),
                     cache=_jax_cache())
        yield state
    finally:
        for pc in procs:
            for p in pc.processes:
                if p.is_alive() and "ranks" not in state:
                    p.terminate()
                p.join()


@pytest.fixture(scope="module")
def ranks(refs):
    """The two ranks' results, the single rank's, and the references."""
    deadline = time.monotonic() + 300
    for pc in refs["procs"]:
        while not pc.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("the ranks ran past 300 s")
    got = []
    for name in ("rank0", "rank1", "one_rank"):
        with open(os.path.join(refs["out_dir"], f"{name}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    refs["ranks"] = got
    return got[:2], got[2], refs


# ---- loaders --------------------------------------------------------------

@pytest.mark.parametrize("index", [True, False], ids=["index", "no_index"])
def test_load_dataset_in_chunks_matches_jax(tmp_path, index):
    import pandas as pd
    from gnnflow_tpu import data as jdata
    full = data.make_synthetic_dataset(num_src=30, num_dst=10,
                                       num_edges=103, dim_edge=0)[3]
    (tmp_path / "FAKE").mkdir()
    pd.DataFrame({"src": full.src, "dst": full.dst, "time": full.time,
                  "ext_roll": np.repeat([0, 1, 2], [70, 20, 13])}).to_csv(
        tmp_path / "FAKE" / "edges.csv", index=index)
    got = list(data.load_dataset_in_chunks("FAKE", 25, str(tmp_path)))
    want = list(jdata.load_dataset_in_chunks("FAKE", 25, str(tmp_path)))
    assert [len(t) for t, _ in got] == [25, 25, 25, 25, 3]
    assert len(got) == len(want)
    for (t, r), (jt, jr) in zip(got, want):
        _assert_tables_equal(t, jt)
        assert np.array_equal(r, jr)
    assert np.array_equal(np.concatenate([t.eid for t, _ in got]),
                          np.arange(103))


def test_load_partitioned_dataset_matches_jax(tmp_path):
    import pandas as pd
    from gnnflow_tpu import data as jdata
    d = tmp_path / "FAKE"
    d.mkdir()
    for rank in range(2):
        for split, n in (("train", 10), ("val", 4), ("test", 4)):
            pd.DataFrame({"src": np.arange(n) + rank * 100,
                          "dst": np.arange(n) + 1,
                          "time": np.arange(n, dtype=np.float32) / 3,
                          "ext_roll": np.zeros(n, np.int64)}).to_csv(
                d / f"edges_{split}_2_{rank}.csv", index=split != "val")
    for rank, ptd in ((1, False), (0, True)):
        got = data.load_partitioned_dataset("FAKE", str(tmp_path), rank, 2,
                                            ptd)
        want = jdata.load_partitioned_dataset("FAKE", str(tmp_path), rank,
                                              2, ptd)
        assert (got[0] is None) == (want[0] is None) == ptd
        for t, jt in zip(got, want):
            if t is not None:
                _assert_tables_equal(t, jt)
    with pytest.raises(ValueError):
        data.load_partitioned_dataset("FAKE", str(tmp_path), 5, 2)


def test_load_sharded_node_feat_matches_jax(tmp_path):
    from gnnflow_tpu import data as jdata
    from gnnflow_tpu.parallel import make_mesh
    want = _write_parts(str(tmp_path / "MAGLIKE"))
    table, total = data.load_sharded_node_feat("MAGLIKE", device="cpu",
                                               data_dir=str(tmp_path))
    arr, jtotal = jdata.load_sharded_node_feat("MAGLIKE", make_mesh(8),
                                               data_dir=str(tmp_path))
    assert total == jtotal == 42 and table.shape == (42, 5)
    assert np.array_equal(table.local.numpy(), want)
    assert np.array_equal(np.asarray(arr)[:42], want)
    with pytest.raises(ValueError):
        data.load_sharded_node_feat("NOPE", device="cpu",
                                    data_dir=str(tmp_path))


def test_load_sharded_node_feat_two_ranks(ranks):
    got, _, refs = ranks
    want = refs["parts"]
    for r in range(2):
        t = got[r]["sharded_feat"]
        assert t["total"] == 42 and t["rows_per_rank"] == 21
        # each rank holds its block only, and pulls every row
        assert np.array_equal(t["local"], want[21 * r: 21 * r + 21])
        assert np.array_equal(t["pulled"], want)


# ---- sharded memory -------------------------------------------------------

def test_sharded_memory_state_ops(ranks):
    got, _, _ = ranks
    full = got[0]["memory_ops"]["full"]
    for r in range(2):
        m = got[r]["memory_ops"]
        assert m["lo"] == 6 * r and m["num_nodes"] == 11
        for k, v in full.items():
            block = np.zeros((6,) + v.shape[1:], v.dtype)
            block[: len(v[6 * r: 6 * r + 6])] = v[6 * r: 6 * r + 6]
            assert np.array_equal(m["local"][k], block), k
            assert np.array_equal(m["restored"][k], v), k
            grown = np.zeros((14,) + v.shape[1:], v.dtype)
            grown[:11] = v
            assert np.array_equal(m["grown"][k], grown), k
        assert m["grown_rows"] == 7 and m["reset_sum"] == 0.0


def _equal(a, b, what=None):
    assert np.array_equal(a, b), what


def _close(a, b, what=None):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=str(what))


@pytest.mark.parametrize("dedup", [None, 0.9], ids=["per_instance",
                                                    "dedup"])
@pytest.mark.parametrize("name", ["tgn", "apan", "apan_table"])
def test_sharded_memory_matches_replicated_and_jax(ranks, name, dedup):
    got, _, refs = ranks
    ref = refs[name.replace("_table", "")]
    # the sharded K/V table's dW sums each rank's rows apart before the
    # all-reduce adds them, so it rounds otherwise than the replicated
    # table's: 1e-6 absolute there, from the first step's parameters on
    same = _equal if name != "apan_table" else _close
    for rank in range(2):
        sharded = got[rank]["mem"][(name, dedup, True)]
        repl = got[rank]["mem"][(name, dedup, False)]
        assert sharded["local_rows"] == 40 and repl["local_rows"] == 80
        assert len(sharded["steps"]) == len(ref["steps"]) == 4
        for s, p, j in zip(sharded["steps"], repl["steps"], ref["steps"]):
            for a, b in zip(s[:3], p[:3]):
                same(a, b)
            for k in p[3]:
                same(s[3][k], p[3][k], k)
            if dedup:                       # every step fits the cap
                assert s[4] is not None and s[4] <= 96 * 5
            for a, b in zip(s[:3], j[:3]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            assert s[3].keys() == j[3].keys()
            for k, w in j[3].items():
                np.testing.assert_allclose(s[3][k], w, rtol=0, atol=1e-5,
                                           err_msg=str(k))
        for k, w in ref["memory"].items():
            same(sharded["memory"][k], repl["memory"][k], k)
            if k.endswith("_ts") or k.endswith("_ptr"):
                assert np.array_equal(sharded["memory"][k], w), k
            else:
                np.testing.assert_allclose(
                    sharded["memory"][k], w, rtol=0,
                    atol=1e-5 if name == "tgn" else 1e-4, err_msg=k)
    assert np.abs(got[0]["mem"][(name, dedup, True)]["memory"]
                  ["node_memory"]).sum() > 0
    # the ranks hold one state
    for a, b in zip(got[0]["mem"][(name, dedup, True)]["steps"],
                    got[1]["mem"][(name, dedup, True)]["steps"]):
        assert a[0] == b[0]
        for k in a[3]:
            assert np.array_equal(a[3][k], b[3][k])


@pytest.mark.parametrize("name", ["tgn", "apan_table"])
def test_ranks_on_different_dedup_branches_agree(ranks, name):
    got, _, _ = ranks
    r0, r1 = got[0]["branches"][name], got[1]["branches"][name]
    cap = r0["dedup"]["cap"]
    # rank 0 took the dedup, rank 1 its fallback, in one step
    assert r0["dedup"]["n_uniq"] <= cap < r1["dedup"]["n_uniq"]
    assert r0["dedup"]["losses"] == r1["dedup"]["losses"]
    assert np.array_equal(r0["dedup"]["pos"], r1["dedup"]["pos"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["dedup"]["losses"],
                                   r["per_instance"]["losses"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["dedup"]["pos"],
                                   r["per_instance"]["pos"], rtol=0,
                                   atol=1e-5)


# ---- the cache over sharded masters ----------------------------------------

@pytest.mark.parametrize("policy", ["LRUCache", "FIFOCache"])
def test_cache_over_sharded_masters_matches_jax(ranks, policy):
    got, _, refs = ranks
    want = refs["cache"][policy]
    for r in range(2):
        runs = got[r]["cache"][policy]
        assert len(runs) == len(want) == CACHE_BATCHES
        for g, w in zip(runs, want):
            for a, b in zip(g[:3], w[:3]):
                assert np.array_equal(a, b)
            assert g[3:] == w[3:]           # the hit ratios
    assert want[-1][4] > 0


def test_cache_over_sharded_masters_zero_capacity(ranks):
    got, _, refs = ranks
    _, _, _, _, nf, _ = _cache_stream()
    for r in range(2):
        feats, ids, valid = got[r]["cache"]["zero"]
        assert np.array_equal(feats, refs["cache"]["zero"])
        assert np.array_equal(
            feats, np.where(valid[:, None], nf[np.clip(ids, 0, None)], 0.0))


def test_multiprocess_cache_two_ranks_equal_one(ranks):
    got, one, _ = ranks
    a, b = (got[r]["mp_cache"] for r in range(2))
    for k in ("loss", "val_ap", "cache_node_hit", "cache_edge_hit"):
        assert a[k] == b[k] == one[k], k
        assert len(a[k]) == 1, k
    assert 0 < a["cache_edge_hit"][0] <= 1 and np.isfinite(a["loss"]).all()


# ---- bf16 storage ----------------------------------------------------------

def test_bf16_storage_rounds_and_refuses_odd_dims():
    with pytest.raises(ValueError, match="even"):
        memory_lib.init_memory(4, 3, 2, "cpu", storage="bfloat16")
    with pytest.raises(ValueError, match="even"):
        memory_lib.init_memory(4, 4, 1, "cpu", storage="bfloat16")
    mem = memory_lib.init_memory(4, 2, 0, "cpu", storage="bfloat16")
    assert mem.node_memory.dtype == mem.mailbox.dtype == torch.bfloat16
    assert mem.node_memory_ts.dtype == torch.float32
    assert mem.nbytes == 4 * (2 * 2 + 4 + 4 * 2 + 4 + 8)
    # 1 + 2^-8 lies halfway between two bf16 values: to nearest even
    vals = torch.tensor([[1 + 2 ** -8, 1 + 3 * 2 ** -8]] * 3)
    memory_lib.update_mem_mail(mem, torch.tensor([0, 1, 2]), vals,
                               torch.tensor([1.0, 2.0, 3.0]), None,
                               torch.tensor([True]))
    assert mem.node_memory[0].tolist() == [1.0, 1 + 2 ** -6]
    assert mem.mailbox[0].tolist() == [1.0, 1 + 2 ** -6, 1.0, 1 + 2 ** -6]


def test_bf16_storage_matches_jax():
    import jax
    import jax.numpy as jnp
    from gnnflow_tpu import data as jdata
    from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
    from gnnflow_tpu.models.dgnn import DGNN as JDGNN
    from gnnflow_tpu.train import Trainer as JTrainer
    cfg = dict(MEM_TGN, dim_node=0)
    _, _, _, full, _, ef = _mem_stream()
    jg = JGraph(initial_pool_size=1024, minimum_block_size=4)
    jg.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    jtrainer = JTrainer(JDGNN(**cfg), fanouts=[4], sample_strategy="recent",
                        dedup_factor=None, gru_table=False, lr=1e-4,
                        auto_calibrate=False, memory_storage="bfloat16")
    model = DGNN(**cfg, device="cpu")
    jstate = jax_state(jtrainer, model, full.max_node + 1)
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    trainer = Trainer(model, fanouts=[4], device="cpu", dedup_factor=None,
                      memory_storage="bfloat16")
    state = trainer.init_state(full.max_node + 1)
    f32 = Trainer(DGNN(**cfg, device="cpu"), fanouts=[4], device="cpu",
                  dedup_factor=None)
    fstate = f32.init_state(full.max_node + 1)
    assert 2 * state.memory.node_memory.nbytes \
        == fstate.memory.node_memory.nbytes
    jdg, jef, tef = jg.device_graph(), jnp.asarray(ef), torch.from_numpy(ef)
    for b, jb in zip(
            _mem_batches(data.get_batches, data.DstRandEdgeSampler, full),
            _mem_batches(jdata.get_batches, jdata.DstRandEdgeSampler, full)):
        jstate, jloss, _, _ = jtrainer.train_step(jstate, jdg, None, jef, jb)
        state, loss, _, _ = trainer.train_step(state, g.device_graph("cpu"),
                                               tef, b)
        fstate, floss, _, _ = f32.train_step(fstate, g.device_graph("cpu"),
                                             tef, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=1e-5)
        for k, w in _flat(jax.tree.map(np.asarray, jstate.params)).items():
            np.testing.assert_allclose(
                _flat(flax_param_tree(model))[k], w, rtol=0, atol=1e-5,
                err_msg=str(k))
        for k in ("node_memory", "mailbox"):
            got = getattr(state.memory, k).float().numpy()
            want = np.asarray(getattr(jstate.memory, k))
            assert getattr(state.memory, k).dtype == torch.bfloat16
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0,
                                       err_msg=k)
        for k in ("node_memory_ts", "mailbox_ts"):
            assert np.array_equal(getattr(state.memory, k).numpy(),
                                  np.asarray(getattr(jstate.memory, k))), k
    # bf16 storage moves the f32 run's loss by bf16 rounding only
    np.testing.assert_allclose(float(loss), float(floss), rtol=1e-2)
    assert state.memory.node_memory.abs().sum() > 0


# ---- the parity harness ----------------------------------------------------

def test_parity_run_no_data(tmp_path, capsys):
    import json
    from gnnflow_tpu_torch.scripts import parity_run
    out = tmp_path / "report.json"
    assert parity_run.main(["--data-dir", str(tmp_path), "--device", "cpu",
                            "--json-out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["summary"]["verdict"] == "NO-DATA"
    assert report["summary"]["skipped"] == len(report["cells"]) \
        == len(parity_run.EXPECTED_MIN_AP)
    assert '"verdict": "NO-DATA"' in capsys.readouterr().out


def test_parity_run_smoke_cell(tmp_path):
    import json
    from gnnflow_tpu_torch.scripts import parity_run
    out = tmp_path / "report.json"
    rc = parity_run.main(["--smoke", "--smoke-models", "TGN",
                          "--no-smoke-host-cells", "--smoke-epochs", "1",
                          "--smoke-edges", "3000", "--device", "cpu",
                          "--json-out", str(out)])
    report = json.loads(out.read_text())
    (cell,) = report["cells"]
    assert cell["status"] == "ok", cell.get("tail")
    assert 0.0 < cell["test_ap"] <= 1.0 and cell["model"] == "TGN"
    assert rc == (0 if cell["pass"] else 1)
    assert report["summary"]["verdict"] == ("PASS" if cell["pass"]
                                            else "FAIL")
