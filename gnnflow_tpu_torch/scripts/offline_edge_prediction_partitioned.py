"""Partitioned multi-GPU link-prediction training.

    python -m gnnflow_tpu_torch.scripts.offline_edge_prediction_partitioned \
        --model TGN --num-devices 2 [--device cpu]

Counterpart of ``scripts/offline_edge_prediction_partitioned.py``, with
its flags and ``--device`` in place of ``--platform``: a streaming
partitioner splits the graph into ``--num-partitions`` partitions (default
one per rank), each rank ingests the partitions it owns, the feature
tables are sharded over the ranks, and
:class:`~gnnflow_tpu_torch.parallel.partitioned_trainer.PartitionedTrainer`
trains data parallel over the partitioned store with routed (the default)
or replicated sampling.  Memory (TGN, APAN) is sharded over the ranks
(``:139-141``).  The batch is rounded down to a multiple of the
ranks and the learning rate is ``lr·sqrt(ranks)``.  The partition sizes
and the load factor and edge cut are logged once, and every epoch logs
the routed load's CV (the per-owner root counts of each batch), the layer
dedup's takes where it applies, and the validation AP and AUC over the
gathered logits.

``--num-devices N`` spawns N ranks (card r for rank r, or gloo ranks with
``--device cpu``), or joins a process group that is already running;
one rank runs without a group.  ``--capacity-factor`` sized the JAX
routed sampler's fixed buckets; the port's exchange sends exact counts,
so the flag is refused (ROADMAP.md, "Not ported: TPU layout only").
"""
from __future__ import annotations

import argparse
import logging
import math
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gnnflow_tpu_torch.cache import CACHES
from gnnflow_tpu_torch.config import get_default_config
from gnnflow_tpu_torch.data import (DstRandEdgeSampler, get_batches,
                                    load_dataset, load_feat,
                                    make_synthetic_dataset)
from gnnflow_tpu_torch.dynamic_graph import build_dynamic_graph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.factory import build_model
from gnnflow_tpu_torch.parallel import dist_context
from gnnflow_tpu_torch.parallel.dispatcher import dispatch_full_dataset
from gnnflow_tpu_torch.parallel.dist_graph import (PartitionedDynamicGraph,
                                                   routed_load_stats)
from gnnflow_tpu_torch.parallel.kvstore import shard_memory_state
from gnnflow_tpu_torch.parallel.partition import (get_partitioner,
                                                  partition_metrics)
from gnnflow_tpu_torch.parallel.partitioned_trainer import PartitionedTrainer
from gnnflow_tpu_torch.temporal_sampler import TemporalSampler
from gnnflow_tpu_torch.utils import average_precision_score, roc_auc_score

STRATEGIES = ["hash", "roundrobin", "edgecount", "timestampsum",
              "timestampavg", "fennel", "fennel_edge", "metis"]


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model", default="TGN")
    parser.add_argument("--data", default="SYNTHETIC")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--sampling-mode", default="routed",
                        choices=["routed", "replicated"],
                        help="routed: each root goes to its owner rank; "
                             "replicated: every rank samples all roots "
                             "against its partitions")
    parser.add_argument("--ingestion-batch-size", type=int,
                        default=100_000)
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, the kernels) or cpu (gloo, their "
                             "plain PyTorch versions)")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="partitioned multi-GPU link-prediction training")
    add_common_flags(parser)
    parser.add_argument("--epoch", type=int, default=5)
    parser.add_argument("--num-devices", type=int, default=None,
                        help="ranks (default: the cards of this host, or 1 "
                             "with --device cpu)")
    parser.add_argument("--num-partitions", type=int, default=None,
                        help="partitions, a multiple of the ranks (default: "
                             "one per rank)")
    parser.add_argument("--partition-strategy", default="hash",
                        choices=STRATEGIES)
    parser.add_argument("--capacity-factor", default=None)
    parser.add_argument("--synthetic-edges", type=int, default=100_000)
    return parser


def load_stream(args, num_edges: int):
    """``(train, val, full, ext_roll, node_feats, edge_feats)``: the
    dataset on disk, or the synthetic stream of the JAX script."""
    if args.data != "SYNTHETIC":
        train, val, test, full = load_dataset(args.data, args.data_dir)
        node_feats, edge_feats = load_feat(args.data, args.data_dir)
    else:
        train, val, test, full, node_feats, edge_feats = \
            make_synthetic_dataset(num_src=2000, num_dst=500,
                                   num_edges=num_edges, dim_edge=100,
                                   seed=args.seed)
    ext_roll = np.concatenate([np.zeros(len(train), np.int64),
                               np.ones(len(val), np.int64),
                               np.full(len(test), 2, np.int64)])
    return train, val, full, ext_roll, node_feats, edge_feats


def _configs(args):
    model_config, data_config = get_default_config(args.model, "synthetic")
    if args.data.lower() != "synthetic":
        model_config, data_config = get_default_config(args.model,
                                                       args.data.lower())
    return model_config, data_config


def _cached_stepper(args, trainer, data_config, full, store, num_nodes,
                    trainer_kwargs, device):
    """The multiprocess script's cache path
    (``scripts/offline_edge_prediction_multiprocess.py:159-200``): every
    rank replays the whole stream into a local store and samples it on
    the host (``TemporalSampler``); the feature masters stay the sharded
    tables behind the cache, whose misses are routed pulls.  Returns
    ``(cache, step)``: ``step(state, batch, train)`` is the prefetched
    step on inputs that are the same on every rank (the JAX run places
    them replicated), so it runs unsliced."""
    graph = build_dynamic_graph(**data_config)
    for lo in range(0, len(full), args.ingestion_batch_size):
        chunk = full[lo: lo + args.ingestion_batch_size]
        graph.add_edges(chunk.src, chunk.dst, chunk.time, chunk.eid,
                        add_reverse=data_config["undirected"])
    sampler = TemporalSampler(graph, device=device, **trainer_kwargs)
    cache = CACHES[args.cache](
        args.edge_cache_ratio, args.node_cache_ratio, num_nodes, len(full),
        store.node_table, store.edge_table, device=device)
    cache.init_cache()

    def step(state, batch, train):
        mfgs = sampler.sample(batch.target_nodes, batch.ts)
        nfs, efs = cache.fetch_feature(mfgs, batch.eids)
        return trainer.train_step_prefetched(
            state, mfgs, nfs, efs, cache.target_edge_features, batch,
            train=train)

    return cache, step


def train_partitioned(args, ctx, num_partitions: int, num_edges: int,
                      max_steps: int = 0, check_uniform: bool = False,
                      result_lines: bool = False) -> dict:
    """Dispatch, build and train over the partitioned store in the running
    group ``ctx`` (None: one rank, no group); every rank runs it.  With
    ``args.cache`` (the multiprocess script's ``--cache``) the steps go
    through the cache over the sharded tables (:func:`_cached_stepper`).
    Returns ``{"partition_sizes", "load_cv", "loss", "val_ap",
    "val_auc", "cache_node_hit", "cache_edge_hit"}`` (per epoch where a
    list; the hit ratios with the cache only)."""
    rank = 0 if ctx is None else ctx.rank
    world = 1 if ctx is None else ctx.world_size
    device = torch.device(args.device) if ctx is None else ctx.device
    model_config, data_config = _configs(args)
    _, val_data, full, ext_roll, node_feats, edge_feats = \
        load_stream(args, num_edges)

    partitioner = get_partitioner(args.partition_strategy, num_partitions)
    pg = PartitionedDynamicGraph(num_partitions, **data_config)
    dispatch = (dist_context.dispatch_full_dataset_multiprocess
                if check_uniform else dispatch_full_dataset)
    t0 = time.time()
    train_data, store = dispatch(
        full, ext_roll, partitioner, pg, node_feats=node_feats,
        edge_feats=edge_feats,
        ingestion_batch_size=args.ingestion_batch_size,
        undirected=data_config["undirected"], device=device)
    m = partition_metrics(partitioner, full.src, full.dst)
    sizes = [pg.locals[p].num_edges() for p in pg.owned]
    logging.info("dispatch done in %.1fs; partitions %s of %d hold %s "
                 "edges; load factor %.3f edge-cut %.1f%%",
                 time.time() - t0, list(pg.owned), num_partitions, sizes,
                 m["load_factor"], m["edge_cut"] * 100)

    num_nodes = pg.max_vertex_id() + 1
    dim_node = 0 if node_feats is None else node_feats.shape[1]
    dim_edge = 0 if edge_feats is None else edge_feats.shape[1]
    model, trainer_kwargs = build_model(args.model, model_config, dim_node,
                                        dim_edge, seed=args.seed,
                                        device=device)
    batch_size = model_config["batch_size"]
    batch_size -= batch_size % world
    trainer = PartitionedTrainer(model, sampling_mode=args.sampling_mode,
                                 lr=args.lr * math.sqrt(world),
                                 device=device, **trainer_kwargs)
    dg = pg.device_graph(device)
    state = trainer.init_state(num_nodes, seed=args.seed)
    if state.memory is not None:
        state.memory = shard_memory_state(state.memory, trainer.dp.group)
    pt = pg.partition_table
    cache = step = None
    if getattr(args, "cache", None):
        cache, step = _cached_stepper(args, trainer, data_config, full,
                                      store, num_nodes, trainer_kwargs,
                                      device)
        logging.info("cache mem size: %.2f MB", cache.get_mem_size() / 1e6)

    train_neg = DstRandEdgeSampler(train_data.dst, seed=args.seed)
    val_neg = DstRandEdgeSampler(full.dst, seed=args.seed + 1)
    out = {"partition_sizes": sizes, "load_cv": [], "loss": [],
           "val_ap": [], "val_auc": [], "cache_node_hit": [],
           "cache_edge_hit": []}
    for epoch in range(args.epoch):
        t0 = time.time()
        total, cvs, loss = 0, [], None
        if epoch > 0 and state.memory is not None:
            memory_lib.reset_memory(state.memory)
        if cache is not None:
            cache.reset()
        for i, batch in enumerate(get_batches(train_data, batch_size,
                                              train_neg)):
            if cache is not None:
                state, loss, _, _ = step(state, batch, True)
            else:
                if args.sampling_mode == "routed":
                    cvs.append(routed_load_stats(pt, batch.target_nodes,
                                                 num_partitions)["cv"])
                state, loss, _, _ = trainer.train_step(
                    state, dg, store.edge_table, batch,
                    node_feats=store.node_table)
            total += 3 * batch.num_valid
            if max_steps and i + 1 >= max_steps:
                break
        last = float(loss)                # a value fetch ends the timing
        dt = time.time() - t0
        if cvs:
            logging.info("epoch %d sampling load: CV %.3f (max %.3f) over "
                         "%d batches", epoch, float(np.mean(cvs)),
                         float(np.max(cvs)), len(cvs))
            out["load_cv"].append(float(np.mean(cvs)))
        tstats = trainer.tier_take_stats(state)
        if tstats and tstats["total"]:
            logging.info("epoch %d layer-dedup takes %s (tiers %s, "
                         "fallback rate %.2f)", epoch, tstats["counts"],
                         tstats["tiers"], tstats["fallback_rate"])
            state = trainer.maybe_recalibrate(
                state, dg,
                np.concatenate([train_data.src[-batch_size:],
                                train_data.dst[-batch_size:],
                                train_data.dst[-batch_size:]]),
                np.tile(train_data.time[-batch_size:], 3))
        scores, labels = [], []
        for i, batch in enumerate(get_batches(val_data, batch_size,
                                              val_neg)):
            if cache is not None:
                state, _, pos, neg = step(state, batch, False)
            else:
                state, _, pos, neg = trainer.eval_step(
                    state, dg, store.edge_table, batch,
                    node_feats=store.node_table)
            k = batch.num_valid
            scores += [pos[:k].float().cpu().numpy(),
                       neg[:k].float().cpu().numpy()]
            labels += [np.ones(k), np.zeros(k)]
            if max_steps and i + 1 >= max_steps:
                break
        y, t = np.concatenate(scores), np.concatenate(labels)
        ap, auc = average_precision_score(t, y), roc_auc_score(t, y)
        logging.info("epoch %d: %.2fs, %.0f samples/s, loss %.6f, val ap "
                     "%.4f auc %.4f", epoch, dt, total / dt, last, ap, auc)
        out["loss"].append(last)
        out["val_ap"].append(ap)
        out["val_auc"].append(auc)
        if cache is not None:
            logging.info("cache node hit %.3f edge hit %.3f",
                         cache.cache_node_ratio, cache.cache_edge_ratio)
            out["cache_node_hit"].append(cache.cache_node_ratio)
            out["cache_edge_hit"].append(cache.cache_edge_ratio)
        if result_lines and rank == 0:
            print(f"RESULT epoch={epoch} loss={last:.6f} ap={ap:.6f}",
                  flush=True)
    return out


def _rank_main(ctx, argv) -> None:
    main(argv)


def main(argv=None) -> Optional[dict]:
    """Run the script; returns :func:`train_partitioned`'s dict, or an
    empty dict in a process that spawned the ranks."""
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.capacity_factor is not None:
        parser.error("--capacity-factor: the port's routed exchange sends "
                     "exact split sizes, so no bucket overflows and there "
                     "is no capacity to size (ROADMAP.md, 'Not ported: TPU "
                     "layout only')")
    n_dev = args.num_devices
    if n_dev is None:
        n_dev = dist.get_world_size() if dist.is_initialized() else (
            torch.cuda.device_count()
            if torch.device(args.device).type == "cuda" else 1)
    if n_dev > 1 and not dist.is_initialized():
        dist_context.spawn(_rank_main, n_dev, args.device,
                           sys.argv[1:] if argv is None else list(argv))
        return {}
    ctx = None
    if dist.is_initialized():
        ctx = dist_context.initialize()            # the running group
        if ctx.world_size != n_dev \
                or ctx.device.type != torch.device(args.device).type:
            parser.error(f"--num-devices {n_dev} --device {args.device} in "
                         f"a running group of {ctx.world_size} ranks on "
                         f"{ctx.device.type}")
    rank = 0 if ctx is None else ctx.rank
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format=f"%(asctime)s r{rank} %(levelname)s "
                               f"%(message)s")
    parts = args.num_partitions or n_dev
    logging.info("%d ranks, %d partitions, %s sampling", n_dev, parts,
                 args.sampling_mode)
    return train_partitioned(args, ctx, parts, args.synthetic_edges)


if __name__ == "__main__":
    main()
