"""The ranks' work of the port's two-rank tests on the CPU: data
parallel and partitioned training (``tests/test_torch_parallel.py``), and
sharded memory, features and caches (``tests/test_torch_distmem.py``).
Those tests ``spawn`` the entry functions ``_training_ranks``,
``_memory_ranks`` and ``_memory_one_rank``, which a new process imports
by name.  This module imports torch, NumPy, the port and
``torch_fixtures`` only, neither JAX nor a test module, so a rank starts
without them.  Each rank pickles its results into the directory it is
given, and the test process holds them to the references it computes
meanwhile."""
import math
import os
import pickle

import numpy as np
import torch

from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.cache import FIFOCache, LRUCache
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.weights import flax_param_tree
from gnnflow_tpu_torch.parallel import (PartitionedDynamicGraph,
                                        PartitionedTrainer, ShardedTable,
                                        dispatch_full_dataset,
                                        get_partitioner, shard_memory_state,
                                        shard_trainer, unshard_memory)
from gnnflow_tpu_torch.temporal_sampler import TemporalSampler
from gnnflow_tpu_torch.train import Trainer
from torch_fixtures import B, CFG, _flat, _stream

MEMORY = ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts",
          "mailbox_ptr")


def _memory(mem):
    return {k: np.array(getattr(mem, k)) for k in MEMORY}


# ---- training: TGN data parallel and partitioned, TGAT's tiers -----------

TGAT = dict(CFG, num_layers=2, use_memory=False, dim_memory=None)


def _train_batches(get_batches, sampler, full, **kw):
    """Batches of 64, 64 and 20, all on rank 0."""
    return get_batches(full[:148], B, sampler(full.dst, 1), **kw)


def _tgn_run(kind, ratio=1):
    """3 TGN train steps on the rank's trainer (``"one"``: one device) at
    ``ratio`` negatives per edge: per step the loss, the logits and the
    parameters, then the memory."""
    _, _, _, full, _, ef = _stream()
    model = DGNN(**CFG, neg_sample_ratio=ratio, device="cpu")
    if kind in ("dp", "one"):
        g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
        g.add_edges(full.src, full.dst, full.time, full.eid,
                    add_reverse=True)
        trainer = Trainer(model, fanouts=[4], device="cpu",
                          dedup_factor=None, neg_sample_ratio=ratio)
        if kind == "dp":
            shard_trainer(trainer)
        dg, table = g.device_graph("cpu"), torch.from_numpy(ef)
    else:
        pg = PartitionedDynamicGraph(4, initial_pool_size=1024,
                                     minimum_block_size=4)
        _, store = dispatch_full_dataset(full, None,
                                         get_partitioner("hash", 4), pg,
                                         edge_feats=ef, undirected=True)
        trainer = PartitionedTrainer(model, fanouts=[4], device="cpu")
        dg, table = pg.device_graph("cpu"), store.edge_table
    state = trainer.init_state(full.max_node + 1)
    steps = []
    for b in _train_batches(data.get_batches, data.DstRandEdgeSampler, full,
                            neg_sample_ratio=ratio):
        state, loss, pos, neg = trainer.train_step(state, dg, table, b)
        steps.append((float(loss), pos.numpy(), neg.numpy(),
                      _flat(flax_param_tree(model))))
    # PartitionedTrainer shards memory over the ranks: the whole of it
    return {"steps": steps, "memory": _memory(unshard_memory(state.memory))}


def _tgat_tiers(ctx):
    """TGAT on the routed layer dedup, tiers (0.1, 0.2), and padded: two
    train steps and an eval step from one set of weights.  Global batch of
    512: rank 0's half repeats one (src, dst, neg, ts) row, so its unique
    pairs fit the lowest tier; rank 1's half is 256 distinct edges, whose
    768 roots alone overflow the top tier's 768 of 3,840 rows."""
    _, _, _, full, _, ef = _stream()
    pg = PartitionedDynamicGraph(4, initial_pool_size=1024,
                                 minimum_block_size=4)
    _, store = dispatch_full_dataset(full, None, get_partitioner("hash", 4),
                                     pg, edge_feats=ef, undirected=True)
    dg = pg.device_graph("cpu")
    neg = data.DstRandEdgeSampler(full.dst, 3)
    edges = full[100:356]
    src = np.concatenate([np.full(256, 3), edges.src])
    dst = np.concatenate([np.full(256, 65), edges.dst])
    ts = np.concatenate([np.full(256, full.time[300]), edges.time])
    eid = np.concatenate([np.full(256, 300), edges.eid])
    first = data._pad_batch(src, dst, neg.sample(512), ts.astype(np.float32),
                            eid, 512)
    batches = [first, next(data.get_batches(full[356:], 512, neg))]
    out = {}
    for name, ladder in (("dedup", (0.1, 0.2)), ("padded", None)):
        model = DGNN(**TGAT, device="cpu")
        trainer = PartitionedTrainer(model, fanouts=[4, 4], device="cpu",
                                     layer_dedup=ladder)
        state = trainer.init_state(full.max_node + 1)
        losses, takes = [], []
        for b in batches:
            state, loss, _, _ = trainer.train_step(state, dg,
                                                   store.edge_table, b)
            losses.append(float(loss))
            takes.append(state.last_take)
        _, loss, pos, _ = trainer.eval_step(state, dg, store.edge_table,
                                            batches[0])
        out[name] = {"losses": losses + [float(loss)], "takes": takes,
                     "tier_takes": state.tier_takes, "pos": pos.numpy()}
    return out


def _sharded_table(ctx):
    """Pulls and pushes of a 10 x 3 table over the two ranks (rows 0-4
    on rank 0): each rank's results, and the table after the pushes."""
    table = np.arange(30, dtype=np.float32).reshape(10, 3)
    st = ShardedTable(table)
    ids = [[-1, 0, 9, 12, 4, 4, 7], []][ctx.rank]
    pulled = st.pull(torch.tensor(ids, dtype=torch.long)).numpy()
    push_ids = [[1, 7], [-1, 3, 8, 15]][ctx.rank]
    rows = 100.0 * (1 + np.arange(len(push_ids) * 3, dtype=np.float32)
                    .reshape(-1, 3)) + ctx.rank
    st.push(torch.tensor(push_ids), torch.from_numpy(rows))
    after = st.pull(torch.arange(10)).numpy()
    return {"ids": ids, "pulled": pulled, "push_ids": push_ids,
            "rows": rows, "after": after, "bytes": st.memory_usage(),
            "local": st.local.numpy()}


def _scripts(ctx, out_dir):
    from gnnflow_tpu_torch.scripts import (
        offline_edge_prediction, offline_edge_prediction_multiprocess,
        offline_edge_prediction_partitioned)
    common = ["--model", "TGAT", "--epoch", "1", "--synthetic-edges", "1500",
              "--device", "cpu"]
    ckpt = os.path.join(out_dir, "TGAT_torch.ckpt")
    return {
        "offline": offline_edge_prediction.main(
            common + ["--data", "SYNTHETIC", "--synthetic-dim-edge", "16",
                      "--num-devices", "2"], checkpoint_path=ckpt),
        "partitioned": offline_edge_prediction_partitioned.main(
            common + ["--num-devices", "2", "--num-partitions", "4"]),
        "multiprocess": offline_edge_prediction_multiprocess.main(
            common + ["--coordinator", "unused:0", "--num-processes", "2",
                      "--process-id", str(ctx.rank), "--max-steps", "1"]),
        "checkpoint": os.path.exists(ckpt)}


def _training_ranks(ctx, out_dir):
    """Each rank's part of ``tests/test_torch_parallel.py``."""
    torch.set_num_threads(1)
    out = {"dp": _tgn_run("dp"), "partitioned": _tgn_run("partitioned"),
           "dp_ratio3": _tgn_run("dp", ratio=3),
           "tgat": _tgat_tiers(ctx), "table": _sharded_table(ctx),
           "scripts": _scripts(ctx, out_dir)}
    with open(os.path.join(out_dir, f"rank{ctx.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---- sharded memory, features and caches -------------------------------

MEM_TGN = dict(CFG, dim_node=6)
MEM_APAN = dict(MEM_TGN, dim_node=0, memory_updater="transformer",
                mailbox_slots=3)
# "apan_table": APAN on its K/V table pull, which each rank serves from
# its own block of sharded memory (JAX's reference is the same run: its
# trainer takes the table by default)
MEM_MODELS = {"tgn": MEM_TGN, "apan": MEM_APAN, "apan_table": MEM_APAN}
CACHE_BATCHES = 5
# one epoch: TGN's batch of 4000 pads the stream's 2,100 train edges into
# one step over 132,000 memory instances, ~4 s on one CPU thread
MP_CACHE = ["--model", "TGN", "--epoch", "1", "--synthetic-edges", "3000",
            "--device", "cpu", "--coordinator", "unused:0", "--cache",
            "LRUCache", "--edge-cache-ratio", "0.3"]
MP_LR = 1e-4


def _mem_stream():
    return data.make_synthetic_dataset(num_src=60, num_dst=20,
                                       num_edges=600, dim_edge=6,
                                       dim_node=6, seed=5)


def _mem_batches(get_batches, sampler, full):
    """Batches of 64, 64, 64 and 20, all on rank 0."""
    return get_batches(full[:212], B, sampler(full.dst, 1))


def _cache_stream():
    """``tests/test_cache_distributed.py``'s stream: 2,000 edges with 8-dim
    edge and 6-dim node features."""
    return data.make_synthetic_dataset(num_src=100, num_dst=30,
                                       num_edges=2000, dim_edge=8,
                                       dim_node=6, seed=0)


def _store(full, nf, ef):
    pg = PartitionedDynamicGraph(4, initial_pool_size=1024,
                                 minimum_block_size=4)
    _, store = dispatch_full_dataset(full, None, get_partitioner("hash", 4),
                                     pg, node_feats=nf, edge_feats=ef,
                                     undirected=True)
    return pg.device_graph("cpu"), store


def _mem_run(name, dedup, sharded):
    """4 f32 train steps of ``name`` through ``PartitionedTrainer`` on
    sharded or replicated memory: per step the loss, logits, parameters
    and the memory dedup's unique count; then the whole memory."""
    _, _, _, full, nf, ef = _mem_stream()
    dg, store = _store(full, nf if name == "tgn" else None, ef)
    model = DGNN(**MEM_MODELS[name], device="cpu")
    trainer = PartitionedTrainer(model, fanouts=[4], device="cpu",
                                 dedup_factor=dedup,
                                 apan_table=name == "apan_table")
    state = trainer.init_state(full.max_node + 1)
    assert (state.memory.shard is not None) == (trainer.dp.world_size > 1)
    if not sharded:
        state.memory = Trainer._init_memory(trainer, full.max_node + 1)
    steps = []
    for b in _mem_batches(data.get_batches, data.DstRandEdgeSampler, full):
        state, loss, pos, neg = trainer.train_step(
            state, dg, store.edge_table, b, node_feats=store.node_table)
        steps.append((float(loss), pos.numpy(), neg.numpy(),
                      _flat(flax_param_tree(model)), state.dedup_n_uniq))
    return {"steps": steps, "memory": _memory(unshard_memory(state.memory)),
            "local_rows": state.memory.node_memory.shape[0]}


def _branches(ctx, name):
    """TGN with sharded node features and sharded memory (or APAN on its
    K/V table over sharded memory, whose backward pass makes one more
    exchange) on the memory dedup at factor 0.1, on a global batch of
    512 whose first half (rank 0's) repeats one (src, dst, ts) row, so
    its unique pairs fit the cap, and whose second half (rank 1's) holds
    256 distinct edges, whose roots alone overflow it; a train step, then
    an eval step, and the same on the per-instance path."""
    _, _, _, full, nf, ef = _mem_stream()
    dg, store = _store(full, nf, ef)
    neg = data.DstRandEdgeSampler(full.dst, 3)
    edges = full[100:356]
    src = np.concatenate([np.full(256, 3), edges.src])
    dst = np.concatenate([np.full(256, 65), edges.dst])
    ts = np.concatenate([np.full(256, full.time[300]), edges.time])
    eid = np.concatenate([np.full(256, 300), edges.eid])
    batch = data._pad_batch(src, dst, neg.sample(512),
                            ts.astype(np.float32), eid, 512)
    out = {}
    nodes = store.node_table if name == "tgn" else None
    for path, factor in (("dedup", 0.1), ("per_instance", None)):
        model = DGNN(**MEM_MODELS[name], device="cpu")
        trainer = PartitionedTrainer(model, fanouts=[4], device="cpu",
                                     dedup_factor=factor)
        state = trainer.init_state(full.max_node + 1)
        state, loss, _, _ = trainer.train_step(
            state, dg, store.edge_table, batch, node_feats=nodes)
        n_uniq = state.dedup_n_uniq
        _, eloss, pos, _ = trainer.eval_step(
            state, dg, store.edge_table, batch, node_feats=nodes)
        out[path] = {"losses": [float(loss), float(eloss)],
                     "n_uniq": n_uniq, "pos": pos.numpy(),
                     "cap": trainer._dedup_cap(256 * 3 * 5)
                     if factor else None}
    return out


def _cache_graph():
    _, _, _, full, nf, ef = _cache_stream()
    g = DynamicGraph(initial_pool_size=4096, maximum_pool_size=1 << 22,
                     mem_resource_type="hbm", minimum_block_size=8)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    return g


def _cache_runs():
    """LRU and FIFO at ratio 0.2 over ``ShardedTable`` masters: 5 batches'
    features and hit ratios; then zero capacity on one batch."""
    train, _, _, full, nf, ef = _cache_stream()
    g = _cache_graph()
    sampler = TemporalSampler(g, [5], device="cpu")
    kw = dict(num_nodes=g.max_vertex_id() + 1, num_edges=len(full),
              device="cpu")
    out = {}
    for cls in (LRUCache, FIFOCache):
        c = cls(0.2, 0.2, node_feats=ShardedTable(nf),
                edge_feats=ShardedTable(ef), transfer_dtype="bfloat16",
                **kw)
        assert c.node_cache.distributed and c.edge_cache.distributed
        c.init_cache()
        got = []
        neg = data.DstRandEdgeSampler(train.dst, seed=1)
        for i, batch in enumerate(data.get_batches(train, 100, neg)):
            if i >= CACHE_BATCHES:
                break
            mfgs = sampler.sample(batch.target_nodes, batch.ts)
            nfs, efs = c.fetch_feature(mfgs, batch.eids)
            got.append((nfs[0].numpy(), efs[0][0].numpy(),
                        c.target_edge_features.numpy(), c.cache_node_ratio,
                        c.cache_edge_ratio))
        out[cls.__name__] = got
    c = LRUCache(0, 0, node_feats=ShardedTable(nf),
                 edge_feats=ShardedTable(ef), **kw)
    c.init_cache()
    batch = next(data.get_batches(train, 64,
                                  data.DstRandEdgeSampler(train.dst, seed=1)))
    mfgs = TemporalSampler(g, [4], device="cpu").sample(batch.target_nodes,
                                                        batch.ts)
    nfs, _ = c.fetch_feature(mfgs, batch.eids)
    out["zero"] = (nfs[0].numpy(), mfgs[0][0].all_nodes().numpy(),
                   mfgs[0][0].all_mask().numpy())
    return out


def _memory_ops(ctx):
    """``shard_memory_state`` of a filled 3-slot state of 11 nodes, its
    backup and restore, reset, and resize to 14 nodes."""
    full = memory_lib.init_memory(11, 4, 2, "cpu", 3)
    gen = torch.Generator().manual_seed(0)
    for t in full.tensors().values():
        t.copy_(torch.randint(1, 9, t.shape, generator=gen).to(t.dtype))
    st = shard_memory_state(full)
    bk = memory_lib.backup_memory(st)
    back = memory_lib.restore_memory(bk, "cpu", st.shard)
    grown = memory_lib.resize_memory(st, 14)
    out = {"local": _memory(st), "lo": st.shard.lo, "num_nodes":
           st.num_nodes, "restored": _memory(unshard_memory(back)),
           "grown": _memory(unshard_memory(grown)),
           "grown_rows": grown.node_memory.shape[0],
           "full": _memory(full)}
    memory_lib.reset_memory(st)
    out["reset_sum"] = float(sum(t.float().abs().sum()
                                 for t in st.tensors().values()))
    return out


def _sharded_feat(ctx, data_dir):
    table, total = data.load_sharded_node_feat("MAGLIKE", device="cpu",
                                               data_dir=data_dir)
    return {"local": table.local.numpy(), "total": total,
            "rows_per_rank": table.rows_per_rank,
            "pulled": table.pull(torch.arange(total)).numpy()}


def _mp_cache(ctx, lr):
    from gnnflow_tpu_torch.scripts import \
        offline_edge_prediction_multiprocess as mp
    return mp.main(MP_CACHE + ["--num-processes", str(ctx.world_size),
                               "--process-id", str(ctx.rank), "--lr",
                               repr(lr)])


def _memory_ranks(ctx, out_dir):
    """Each rank's part of ``tests/test_torch_distmem.py``."""
    torch.set_num_threads(1)
    out = {"mem": {(n, d, s): _mem_run(n, d, s)
                   for n in MEM_MODELS for d in (None, 0.9)
                   for s in (True, False)},
           "branches": {n: _branches(ctx, n) for n in ("tgn",
                                                       "apan_table")},
           "cache": _cache_runs(),
           "memory_ops": _memory_ops(ctx),
           "sharded_feat": _sharded_feat(ctx, out_dir),
           "mp_cache": _mp_cache(ctx, MP_LR)}
    with open(os.path.join(out_dir, f"rank{ctx.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _memory_one_rank(ctx, out_dir):
    torch.set_num_threads(1)
    out = _mp_cache(ctx, MP_LR * math.sqrt(2))
    with open(os.path.join(out_dir, "one_rank.pkl"), "wb") as f:
        pickle.dump(out, f)
