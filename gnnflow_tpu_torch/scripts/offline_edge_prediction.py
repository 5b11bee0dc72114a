"""Offline link-prediction training of TGN, TGAT, DySAT, APAN, GraphSAGE
or GAT on one card.

    python -m gnnflow_tpu_torch.scripts.offline_edge_prediction \
        --model TGN --data SYNTHETIC --epoch 3 [--device cpu]

Counterpart of ``scripts/offline_edge_prediction.py`` (its CLI at
``:43-93`` and its protocol at ``:123-381``):
chronological batches with a random
epoch start, memory reset at every epoch after the first, validation AP
and AUC after every epoch, a best-AP checkpoint with a memory backup,
early stopping, and a final test on the best checkpoint (the memory
backup carries APAN's mail slots and their cursor).  ``--calibrate``
calibrates the fast paths (the memory dedup of TGN and APAN, the
layer-dedup ladder of TGAT, GraphSAGE and GAT) on the last three train
batches before training, and
a config with
windowed snapshots (DySAT: the block compaction's factor and the
snapshot-dedup ladder) always does (``:209-219``); otherwise the trainer
calibrates on its first batch.  ``--snapshot-time-window`` overrides the
config's window.  After every epoch a model on the layer or snapshot
dedup logs its tier takes and calibrates again when more than 30% of at
least 20 steps since the last calibration fell back to the padded path
(``:341-356``).  Every epoch logs its phases (``PhaseTimer``).

The feature cache (``--cache LRUCache|LFUCache|FIFOCache|GNNLabStaticCache``
with ``--edge-cache-ratio`` and ``--node-cache-ratio``, ``:168-236,
258-263, 296-330, 361-363``): a
:class:`~gnnflow_tpu_torch.temporal_sampler.TemporalSampler` samples each
batch, the cache fetches its features, and
``Trainer.train_step_prefetched`` steps, in the phases ``sample``,
``feature`` and ``train``; eval goes the same way.  ``--pipeline``
samples and fetches batch k+1 on a worker thread while batch k trains;
``--cache-transfer-dtype bfloat16`` sends missed rows as bf16;
``--features-on-host`` (needs ``--cache``) keeps the feature tables off
the card.  ``--memory-storage bfloat16`` stores TGN's and APAN's memory
and mails in bf16 (``:80-82, 165``).  After every epoch the cache's hit
ratios are logged.  A store
that the data config places on the host (GDELT, MAG) is sampled on the
CPU and needs ``--cache``.  ``--remat-attention`` recomputes each
attention layer in the backward pass (``:136-137``).  ``--use-scan``
(``:270-296``; not with ``--cache``) stages an epoch's batches on the
device and trains them in one ``Trainer.train_steps_scan`` call, logging
the last loss.  One flag is new: ``--device`` (``cuda`` by default,
``cpu`` for the plain PyTorch path).  A model config with more than one
negative per edge is refused with an error: the script draws one
negative per edge, as JAX's, whose steps then fail on the roots'
shapes (ROADMAP.md §3).

``--num-devices N`` trains data parallel over N ranks
(:func:`~gnnflow_tpu_torch.parallel.dp.shard_trainer`; ``:163,
185-188``): every rank holds the same global batches, rounded down to a
multiple of N, and the learning rate is ``lr·sqrt(N)``.  The script spawns
N processes (card r for rank r, or gloo ranks with ``--device cpu``), or,
where a process group is already running (``torchrun``, or a caller that
started one), joins it.  Rank 0 logs and writes the checkpoint; the AP is
computed over the gathered logits.  The cache path runs its steps
unsharded on every rank, as the JAX script's.

Datasets: the reference's ``edges.csv`` under ``--data-dir``;
``--data SYNTHETIC`` (or a dataset missing on disk) generates a
deterministic synthetic stream, with 100-dim node features for the
static models (``:115-119``).  A dataset's node features reach every
model that has them.  The checkpoint is ``<MODEL>_torch.ckpt`` at the
repository root.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
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
from gnnflow_tpu_torch.parallel.dp import shard_trainer
from gnnflow_tpu_torch.pipeline import FeaturePipeline
from gnnflow_tpu_torch.temporal_sampler import TemporalSampler
from gnnflow_tpu_torch.train import Trainer
from gnnflow_tpu_torch.utils import (EarlyStopMonitor,
                                     average_precision_score, roc_auc_score)
from gnnflow_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from gnnflow_tpu_torch.utils.profiling import PhaseTimer

DATASETS = ["REDDIT", "GDELT", "LASTFM", "MAG", "MOOC", "WIKI", "SYNTHETIC"]
MODELS = ["TGN", "TGAT", "DySAT", "GRAPHSAGE", "GAT", "APAN"]
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="offline TGN/TGAT/DySAT/GRAPHSAGE/GAT/APAN "
                    "link-prediction training")
    parser.add_argument("--model", choices=MODELS, required=True)
    parser.add_argument("--data", choices=DATASETS, required=True)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--epoch", type=int, default=50)
    parser.add_argument("--lr", type=float, default=0.0001)
    parser.add_argument("--num-chunks", type=int, default=8)
    parser.add_argument("--print-freq", type=int, default=100)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--ingestion-batch-size", type=int, default=1000)
    parser.add_argument("--num-devices", type=int, default=1)
    parser.add_argument("--cache", default=None, choices=sorted(CACHES))
    parser.add_argument("--pipeline", action="store_true",
                        help="sample and fetch batch k+1 on a worker "
                             "thread while batch k trains (cache mode "
                             "only)")
    parser.add_argument("--edge-cache-ratio", type=float, default=0)
    parser.add_argument("--calibrate", action="store_true",
                        help="measure the (nid, ts) duplication on the last "
                             "three train batches and pick the dedup "
                             "factors before training")
    parser.add_argument("--cache-transfer-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="send missed rows host to card as bf16 (half "
                             "the bytes; values round to bf16)")
    parser.add_argument("--node-cache-ratio", type=float, default=0)
    parser.add_argument("--snapshot-time-window", type=float, default=0)
    parser.add_argument("--synthetic-edges", type=int, default=100_000)
    parser.add_argument("--synthetic-dim-edge", type=int, default=100)
    parser.add_argument("--features-on-host", action="store_true",
                        help="keep the feature tables on the host and "
                             "feed the model through the cache only "
                             "(requires --cache)")
    parser.add_argument("--memory-storage", default="float32",
                        choices=["float32", "bfloat16"],
                        help="store node memory and mails in bf16: half "
                             "the memory table's bytes, values rounded to "
                             "bf16")
    parser.add_argument("--remat-attention", action="store_true",
                        help="recompute the attention layers in the "
                             "backward pass (torch.utils.checkpoint)")
    parser.add_argument("--use-scan", action="store_true",
                        help="stage each epoch's batches on the device and "
                             "train them in one train_steps_scan call")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "PyTorch versions)")
    return parser


def _load_data(args):
    if args.data != "SYNTHETIC":
        try:
            train, val, test, full = load_dataset(args.data, args.data_dir)
            nf, ef = load_feat(args.data, args.data_dir)
            return train, val, test, full, nf, ef, args.data.lower()
        except ValueError:
            logging.warning("dataset %s not found on disk; generating a "
                            "synthetic stream instead", args.data)
    dim_node = 100 if args.model in ("GRAPHSAGE", "GAT") else 0
    train, val, test, full, nf, ef = make_synthetic_dataset(
        num_src=2000, num_dst=500, num_edges=args.synthetic_edges,
        dim_edge=args.synthetic_dim_edge, dim_node=dim_node, seed=args.seed)
    return train, val, test, full, nf, ef, "synthetic"


def _rank_main(ctx, argv, checkpoint_path) -> None:
    main(argv, checkpoint_path)


def main(argv=None, checkpoint_path: Optional[str] = None) -> dict:
    """Run the protocol; returns ``{"val_ap", "val_auc", "phases",
    "cache_node_hit", "cache_edge_hit"}`` (one per epoch run: the phase
    timer's summary and, with ``--cache``, the epoch's hit ratios),
    ``best_epoch``, ``test_ap`` and ``test_auc``.  The checkpoint goes to
    ``checkpoint_path`` (default ``<MODEL>_torch.ckpt`` at the repository
    root).  With ``--num-devices N > 1`` and no process group running,
    spawns N ranks that run it and returns an empty dict."""
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.features_on_host and not args.cache:
        parser.error("--features-on-host requires --cache (features "
                     "reach the model only through the cache buffer)")
    if args.num_devices > 1 and not dist.is_initialized():
        dist_context.spawn(_rank_main, args.num_devices, args.device,
                           sys.argv[1:] if argv is None else list(argv),
                           checkpoint_path)
        return {}
    ctx = None
    if args.num_devices > 1:
        ctx = dist_context.initialize()           # the running group
        if ctx.world_size != args.num_devices \
                or ctx.device.type != torch.device(args.device).type:
            parser.error(f"--num-devices {args.num_devices} --device "
                         f"{args.device} in a running group of "
                         f"{ctx.world_size} ranks on {ctx.device.type}")
    rank = 0 if ctx is None else ctx.rank
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(message)s")
    checkpoint_path = checkpoint_path or os.path.join(
        ROOT, f"{args.model}_torch.ckpt")
    device = args.device if ctx is None else ctx.device

    np.random.seed(args.seed)
    model_config, data_config = get_default_config(args.model, "synthetic")
    if args.data.lower() != "synthetic":
        model_config, data_config = get_default_config(args.model,
                                                       args.data.lower())
    if args.snapshot_time_window:
        model_config["snapshot_time_window"] = args.snapshot_time_window
    if args.remat_attention:
        model_config["remat_attention"] = True
    if model_config.get("neg_sample_ratio", 1) != 1:
        parser.error(
            f"the {args.model} config has neg_sample_ratio="
            f"{model_config['neg_sample_ratio']}, but this script draws one "
            "negative per edge (get_batches without neg_sample_ratio, as "
            "the JAX script's); train such a model through Trainer with "
            "get_batches(..., neg_sample_ratio=r)")
    train_data, val_data, test_data, full_data, node_feats, edge_feats, \
        dname = _load_data(args)
    logging.info("dataset %s: %d train / %d val / %d test edges",
                 dname, len(train_data), len(val_data), len(test_data))

    dgraph = build_dynamic_graph(**data_config)
    if dgraph.placement == "host" and not args.cache:
        # the fused step samples on the trainer's device; only the cache
        # path's sampler samples a store on the host
        parser.error(f"the {args.data} data config places the graph store "
                     "on the host (mem_resource_type='host'): it is "
                     "sampled on the CPU, so it needs --cache")
    t0 = time.time()
    step = args.ingestion_batch_size
    for lo in range(0, len(full_data), step):
        chunk = full_data[lo: lo + step]
        dgraph.add_edges(chunk.src, chunk.dst, chunk.time, chunk.eid,
                         add_reverse=data_config["undirected"])
    logging.info("graph built in %.2fs: %d vertices, %d edges, %.1f MiB",
                 time.time() - t0, dgraph.num_vertices(),
                 dgraph.num_edges(),
                 dgraph.get_graph_memory_usage() / (1 << 20))

    num_nodes = dgraph.max_vertex_id() + 1
    dim_node = 0 if node_feats is None else node_feats.shape[1]
    dim_edge = 0 if edge_feats is None else edge_feats.shape[1]
    model, trainer_kwargs = build_model(args.model, model_config, dim_node,
                                        dim_edge, seed=args.seed,
                                        device=device)
    batch_size = model_config["batch_size"]
    batch_size -= batch_size % args.num_devices
    lr = args.lr * math.sqrt(args.num_devices)
    trainer = Trainer(model, lr=lr, device=device,
                      memory_storage=args.memory_storage, **trainer_kwargs)
    # with --features-on-host the tables never reach the card
    efs, nfs = (None if t is None or args.features_on_host else
                torch.from_numpy(np.asarray(t, np.float32)).to(device)
                for t in (edge_feats, node_feats))
    dg = dgraph.device_graph("cpu" if dgraph.placement == "host"
                             else device)
    state = trainer.init_state(num_nodes, seed=args.seed)
    if ctx is not None:
        shard_trainer(trainer)
        logging.info("data-parallel over %d ranks", ctx.world_size)

    cache = None
    if args.cache:
        cache = CACHES[args.cache](
            args.edge_cache_ratio, args.node_cache_ratio, num_nodes,
            dgraph.num_edges(), node_feats, edge_feats,
            transfer_dtype=args.cache_transfer_dtype, device=device)
        sampler = TemporalSampler(dgraph, device=device, **trainer_kwargs)
        if args.cache == "GNNLabStaticCache":
            cache.init_cache(sampler=sampler, train_data=train_data,
                             pre_sampling_rounds=2, batch_size=batch_size)
        else:
            cache.init_cache()
        logging.info("cache mem size: %.2f MB", cache.get_mem_size() / 1e6)

    # windowed snapshots fill up over the stream, so their caps are
    # measured on the stream's last train batches
    windowed = (model_config.get("num_snapshots", 1) > 1
                and model_config.get("snapshot_time_window", 0) > 0)
    if args.calibrate or windowed:
        cal_neg = DstRandEdgeSampler(train_data.dst, seed=args.seed)
        cal = trainer.calibrate(dg, list(get_batches(train_data, batch_size,
                                                     cal_neg))[-3:])
        logging.info("calibration: %s", cal)

    train_neg = DstRandEdgeSampler(train_data.dst, seed=args.seed)
    val_neg = DstRandEdgeSampler(full_data.dst, seed=args.seed + 1)
    test_neg = DstRandEdgeSampler(full_data.dst, seed=args.seed + 2)
    rng = np.random.RandomState(args.seed)

    def cached_step(batch, train):
        mfgs = sampler.sample(batch.target_nodes, batch.ts)
        nf, ef = cache.fetch_feature(mfgs, batch.eids)
        return trainer.train_step_prefetched(
            state, mfgs, nf, ef, cache.target_edge_features, batch,
            train=train)

    def run_eval(data, neg_sampler):
        scores, labels = [], []
        loss_sum = 0.0
        for batch in get_batches(data, batch_size, neg_sampler):
            if cache is not None:
                _, loss, pos, neg = cached_step(batch, train=False)
            else:
                _, loss, pos, neg = trainer.eval_step(state, dg, efs, batch,
                                                      node_feats=nfs)
            k = batch.num_valid
            logits = torch.cat([pos[:k], neg[:k]]).float().cpu().numpy()
            scores.append(1 / (1 + np.exp(-logits)))
            labels.append(np.concatenate([np.ones(k), np.zeros(k)]))
            loss_sum += float(loss)
        y, t = np.concatenate(scores), np.concatenate(labels)
        return average_precision_score(t, y), roc_auc_score(t, y), loss_sum

    out = {"val_ap": [], "val_auc": [], "phases": [], "cache_node_hit": [],
           "cache_edge_hit": []}
    best_ap, best_e = 0.0, 0
    early_stopper = EarlyStopMonitor()
    timer = PhaseTimer()
    logging.info("starting training loop")
    for epoch in range(args.epoch):
        epoch_start = time.time()
        total_samples = 0
        it = 0
        if cache is not None:
            cache.reset()
        # the reference resets TGN memory at every epoch start after the
        # first, so the validation pass's state never leaks into training
        if epoch > 0 and state.memory is not None:
            memory_lib.reset_memory(state.memory)
        batches = get_batches(train_data, batch_size, train_neg,
                              num_chunks=args.num_chunks, rng=rng)
        if args.use_scan and cache is None:
            # stage the epoch's batches on the device, train in one call
            with timer("stage"):
                staged = list(batches)
                total_samples = 3 * sum(b.num_valid for b in staged)
                arrays = [torch.stack(t) for t in
                          zip(*map(trainer.batch_arrays, staged))]
            with timer("train"):
                state, losses = trainer.train_steps_scan(
                    state, dg, efs, *arrays, node_feats=nfs)
                logging.info("epoch %d: %d steps, last loss %.4f", epoch,
                             len(staged), float(losses[-1]))
            batches = []
        if cache is not None and args.pipeline:
            # batch k+1's sample and fetch overlap batch k's step
            batches = FeaturePipeline(sampler, cache, depth=2).run(batches)
        for item in batches:
            if cache is not None and args.pipeline:
                batch, mfgs, nf, ef, tef = item
                with timer("train"):
                    _, loss, _, _ = trainer.train_step_prefetched(
                        state, mfgs, nf, ef, tef, batch)
            elif cache is not None:
                batch = item
                with timer("sample"):
                    mfgs = sampler.sample(batch.target_nodes, batch.ts)
                with timer("feature"):
                    nf, ef = cache.fetch_feature(mfgs, batch.eids)
                with timer("train"):
                    _, loss, _, _ = trainer.train_step_prefetched(
                        state, mfgs, nf, ef, cache.target_edge_features,
                        batch)
            else:
                batch = item
                with timer("train"):
                    _, loss, _, _ = trainer.train_step(state, dg, efs, batch,
                                                       node_feats=nfs)
            total_samples += 3 * batch.num_valid
            it += 1
            if it % args.print_freq == 0:
                logging.info("epoch %d it %d loss %.4f", epoch, it,
                             float(loss))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        epoch_time = time.time() - epoch_start
        logging.info("epoch %d phases: %s", epoch, timer.format())
        out["phases"].append(timer.summary())
        timer.reset()
        # the layer dedup's takes; calibrate again when the stream drifted
        # so far that more than 30% of the steps fell back (min 20 steps)
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
        ap, auc, _ = run_eval(val_data, val_neg)
        out["val_ap"].append(ap)
        out["val_auc"].append(auc)
        logging.info("epoch %d: time %.2fs, throughput %.0f samples/s, "
                     "val ap %.4f auc %.4f", epoch, epoch_time,
                     total_samples / epoch_time, ap, auc)
        if cache is not None:
            logging.info("cache node hit %.3f edge hit %.3f",
                         cache.cache_node_ratio, cache.cache_edge_ratio)
            out["cache_node_hit"].append(cache.cache_node_ratio)
            out["cache_edge_hit"].append(cache.cache_edge_ratio)
        if ap > best_ap:
            best_ap, best_e = ap, epoch
            if rank == 0:
                save_checkpoint(checkpoint_path, model.state_dict(),
                                memory_lib.backup_memory(state.memory)
                                if state.memory is not None else None,
                                {"epoch": epoch, "ap": ap})
        if early_stopper.early_stop_check(ap):
            logging.info("early stop at epoch %d (best %d)", epoch, best_e)
            break

    logging.info("loading best checkpoint (epoch %d)...", best_e)
    if ctx is not None:
        dist.barrier()                 # rank 0 has written it
    ckpt = load_checkpoint(checkpoint_path)
    model.load_state_dict(ckpt["params"])
    model.cast_weights()
    if ckpt["memory"]:
        state.memory = memory_lib.restore_memory(ckpt["memory"],
                                                 trainer.device)
    ap, auc, _ = run_eval(test_data, test_neg)
    logging.info("Test ap:%.4f  test auc:%.4f", ap, auc)
    out.update(best_epoch=best_e, test_ap=ap, test_auc=auc)
    return out


if __name__ == "__main__":
    main()
