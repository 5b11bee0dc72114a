"""Online (prequential) link prediction on one card: ingestion,
sliding-window eviction and replay retraining.

    python -m gnnflow_tpu_torch.scripts.online_edge_prediction \
        --model TGN --data SYNTHETIC [--device cpu]

Counterpart of ``scripts/online_edge_prediction.py``. Phase 1 pretrains
on the first ``--phase1-ratio`` of the stream, or resumes from the
phase-1 checkpoint (parameters and a memory backup) where it exists.
Phase 2 runs ``--phase2-steps`` chunks of the rest; each chunk is
1. scored batch by batch with ``eval_step`` on the graph of the past
   only (prequential AP and AUC over time),
2. ingested: ``add_edges``, then ``add_dst_list`` of the negative
   sampler, then ``concat`` to the edges seen,
3. every ``--retrain-interval`` chunks, the edges older than the chunk's
   last time less ``--time-window`` are evicted (``--time-window > 0``)
   and the model retrains on the chunk and a ``--replay-ratio`` sample
   of older edges, in time order.
Memory covers every node of the stream from the start.

Two flags are new: ``--device`` (``cuda`` by default, ``cpu`` for the
plain PyTorch path) and ``--compute-dtype`` (``bfloat16`` runs the
model's products in bf16 over f32 parameters). The checkpoint is
``<MODEL>_torch_online_phase1.ckpt`` at the repository root. Per chunk the
script records eval ms per batch (CUDA events on the card), ingest ms
(with the device view's refresh, also timed alone), eviction ms and
retrain ms per step.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from gnnflow_tpu_torch.config import get_default_config
from gnnflow_tpu_torch.data import (DstRandEdgeSampler, get_batches,
                                    load_dataset, load_feat,
                                    make_synthetic_dataset)
from gnnflow_tpu_torch.dynamic_graph import build_dynamic_graph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.factory import build_model
from gnnflow_tpu_torch.train import Trainer
from gnnflow_tpu_torch.utils import average_precision_score, roc_auc_score
from gnnflow_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                save_checkpoint)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="online (prequential) link prediction with ingestion, "
                    "sliding-window eviction and replay retraining")
    parser.add_argument("--model", default="TGN")
    parser.add_argument("--data", default="SYNTHETIC")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--epoch", type=int, default=5,
                        help="epochs per retrain")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--phase1-ratio", type=float, default=0.3)
    parser.add_argument("--phase2-steps", type=int, default=100)
    parser.add_argument("--retrain-interval", type=int, default=10,
                        help="retrain every N incremental steps (0=never)")
    parser.add_argument("--replay-ratio", type=float, default=0.5)
    parser.add_argument("--time-window", type=float, default=0,
                        help="sliding window: evict edges older than "
                             "now - window before retraining (0=keep all)")
    parser.add_argument("--synthetic-edges", type=int, default=100_000)
    add_device_args(parser)
    return parser


def add_device_args(parser: argparse.ArgumentParser) -> None:
    """The two flags the serving scripts add to the JAX package's."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "PyTorch versions)")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="dtype of the model's products (parameters "
                             "stay f32)")


def load_stream(args, fallback: bool = True):
    """Configs and data for ``args.model`` on ``args.data``, as the JAX
    serving scripts load them: the dataset's defaults where the registry
    has it (else the synthetic ones), its ``edges.csv`` and feature files,
    or a synthetic stream (2,000 src, 500 dst, ``--synthetic-edges``,
    100-dim edge features) for ``SYNTHETIC`` and, with ``fallback``, for
    a dataset missing on disk (without, that raises ``ValueError``).
    Returns ``(model_config, data_config, (train, val, test, full),
    node_feats, edge_feats)``."""
    model_config, data_config = get_default_config(args.model, "synthetic")
    try:
        model_config, data_config = get_default_config(args.model,
                                                       args.data.lower())
    except ValueError:
        pass
    if args.compute_dtype != "float32":
        model_config["compute_dtype"] = args.compute_dtype
    if args.data != "SYNTHETIC":
        try:
            splits = load_dataset(args.data, args.data_dir)
            nf, ef = load_feat(args.data, args.data_dir)
            return model_config, data_config, splits, nf, ef
        except ValueError:
            if not fallback:
                raise
            logging.warning("dataset not found; using synthetic")
    train, val, test, full, nf, ef = make_synthetic_dataset(
        num_src=2000, num_dst=500, num_edges=args.synthetic_edges,
        dim_edge=100, seed=args.seed)
    return model_config, data_config, (train, val, test, full), nf, ef


class StepTimer:
    """Milliseconds of a span: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, t0) -> float:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            return t0.elapsed_time(ev)
        return (time.perf_counter() - t0) * 1e3


def main(argv=None, checkpoint_path: Optional[str] = None) -> dict:
    """Run both phases. Returns per phase-2 step ``aps``, ``aucs``,
    ``evicted`` (one entry per retrain), ``eval_ms`` (per batch),
    ``ingest_ms`` and, of it, ``refresh_ms`` (the device view's upload),
    ``evict_ms`` and ``retrain_ms`` (per train step), and
    ``resumed``, ``phase1_s``, ``uploads`` (device views built),
    ``store_changes`` (ingests and evictions that moved an edge) and
    ``params``, the model's state dict at the end. The phase-1 checkpoint
    is ``checkpoint_path`` (default ``<MODEL>_torch_online_phase1.ckpt``
    at the repository root)."""
    args = make_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = args.device
    model_config, data_config, (_, _, _, full), node_feats, edge_feats = \
        load_stream(args)

    n = len(full)
    p1_end = int(n * args.phase1_ratio)
    phase1 = full[:p1_end]
    chunk_size = max(1, (n - p1_end) // args.phase2_steps)
    undirected = data_config["undirected"]

    dgraph = build_dynamic_graph(**data_config)
    dgraph.add_edges(phase1.src, phase1.dst, phase1.time, phase1.eid,
                     add_reverse=undirected)

    dim_node = 0 if node_feats is None else node_feats.shape[1]
    dim_edge = 0 if edge_feats is None else edge_feats.shape[1]
    # memory must cover nodes that only appear later in the stream
    num_nodes = full.max_node + 1
    model, trainer_kwargs = build_model(args.model, model_config, dim_node,
                                        dim_edge, seed=args.seed,
                                        device=device)
    batch_size = min(model_config["batch_size"], max(256, chunk_size))
    trainer = Trainer(model, lr=args.lr, device=device, **trainer_kwargs)
    efs, nfs = (None if t is None else
                torch.from_numpy(np.asarray(t, np.float32)).to(device)
                for t in (edge_feats, node_feats))
    state = trainer.init_state(num_nodes, seed=args.seed)
    neg = DstRandEdgeSampler(phase1.dst, seed=args.seed)
    rng = np.random.RandomState(args.seed)
    timer = StepTimer(device)

    def train_on(data, epochs):
        loss, steps = None, 0
        for _ in range(epochs):
            for batch in get_batches(data, batch_size, neg, rng=rng):
                _, loss, _, _ = trainer.train_step(
                    state, dgraph.device_graph(device), efs, batch,
                    node_feats=nfs)
                steps += 1
        return float(loss), steps

    checkpoint_path = checkpoint_path or os.path.join(
        ROOT, f"{args.model}_torch_online_phase1.ckpt")
    out = {"aps": [], "aucs": [], "evicted": [], "eval_ms": [],
           "ingest_ms": [], "refresh_ms": [], "evict_ms": [],
           "retrain_ms": [],
           "resumed": os.path.exists(checkpoint_path), "phase1_s": 0.0}
    if out["resumed"]:
        ckpt = load_checkpoint(checkpoint_path)
        model.load_state_dict(ckpt["params"])
        model.cast_weights()
        if ckpt["memory"]:
            state.memory = memory_lib.resize_memory(
                memory_lib.restore_memory(ckpt["memory"], trainer.device),
                num_nodes)
        logging.info("phase 1: resumed from %s", checkpoint_path)
    else:
        logging.info("phase 1: pretraining on %d edges", len(phase1))
        t0 = time.perf_counter()
        loss, _ = train_on(phase1, args.epoch)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out["phase1_s"] = time.perf_counter() - t0
        logging.info("phase 1 done in %.1fs (loss %.4f)", out["phase1_s"],
                     loss)
        save_checkpoint(checkpoint_path, model.state_dict(),
                        memory_lib.backup_memory(state.memory)
                        if state.memory is not None else None)

    seen = phase1
    store_changes = 0
    for step in range(args.phase2_steps):
        lo = p1_end + step * chunk_size
        hi = min(lo + chunk_size, n)
        if lo >= n:
            break
        chunk = full[lo:hi]
        # 1) prequential evaluation: the graph holds only the past
        scores, labels = [], []
        t0, nb = timer.start(), 0
        for batch in get_batches(chunk, batch_size, neg):
            _, _, pos, negs = trainer.eval_step(
                state, dgraph.device_graph(device), efs, batch,
                node_feats=nfs)
            k = batch.num_valid
            scores += [pos[:k].float().cpu().numpy(),
                       negs[:k].float().cpu().numpy()]
            labels += [np.ones(k), np.zeros(k)]
            nb += 1
        out["eval_ms"].append(timer.stop(t0) / nb)
        y, t = np.concatenate(scores), np.concatenate(labels)
        ap, auc = average_precision_score(t, y), roc_auc_score(t, y)
        out["aps"].append(ap)
        out["aucs"].append(auc)
        # 2) ingest the chunk; the device view refreshes once
        t0 = timer.start()
        dgraph.add_edges(chunk.src, chunk.dst, chunk.time, chunk.eid,
                         add_reverse=undirected)
        neg.add_dst_list(chunk.dst)
        seen = seen.concat(chunk)
        t1 = timer.start()
        dgraph.device_graph(device)
        out["refresh_ms"].append(timer.stop(t1))
        out["ingest_ms"].append(timer.stop(t0))
        store_changes += 1
        # 3) retraining with replay, after the sliding window's eviction
        if args.retrain_interval and \
                (step + 1) % args.retrain_interval == 0:
            if args.time_window > 0:
                t0 = timer.start()
                evicted = dgraph.offload_old_blocks(
                    float(chunk.time[-1]) - args.time_window)
                dgraph.device_graph(device)
                out["evict_ms"].append(timer.stop(t0))
                out["evicted"].append(evicted)
                store_changes += evicted > 0
                logging.info("step %d: evicted %d old edges", step,
                             evicted)
            n_replay = int(len(chunk) * args.replay_ratio)
            if n_replay > 0 and len(seen) > len(chunk):
                idx = np.sort(rng.choice(len(seen) - len(chunk),
                                         size=n_replay, replace=False))
                retrain = seen[idx].concat(chunk)
                retrain = retrain[np.argsort(retrain.time, kind="stable")]
            else:
                retrain = chunk
            t0 = timer.start()
            loss, steps = train_on(retrain, args.epoch)
            out["retrain_ms"].append(timer.stop(t0) / max(steps, 1))
            logging.info("step %d: retrained on %d edges (loss %.4f)",
                         step, len(retrain), loss)
        if (step + 1) % 10 == 0:
            logging.info("step %d: AP %.4f (mean %.4f) AUC %.4f", step,
                         ap, np.mean(out["aps"]), auc)

    logging.info("phase 2 complete: mean AP %.4f mean AUC %.4f over %d "
                 "steps", np.mean(out["aps"]), np.mean(out["aucs"]),
                 len(out["aps"]))
    out.update(uploads=dgraph.uploads, store_changes=store_changes,
               params=model.state_dict())
    return out


if __name__ == "__main__":
    main()
