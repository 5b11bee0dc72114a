"""Evaluation of a checkpoint on the test split, over a sweep of snapshot
time windows, with an optional dump of the roots' embeddings.

    python -m gnnflow_tpu_torch.scripts.inference --model TGN \
        --data SYNTHETIC [--checkpoint PATH] [--dump-embeddings out.npz] \
        [--device cpu]

Counterpart of ``scripts/inference.py``: the whole stream is ingested,
the checkpoint (parameters and, with memory, its backup) is loaded, or a
warning says that the random initialisation is evaluated, and test AP and
AUC are computed for each ``--time-windows`` entry, which overrides the
config's ``snapshot_time_window`` where it is not 0. ``--dump-embeddings``
writes one npz: per window ``w``, ``embeddings_w{w}`` and ``nids_w{w}``
(each test batch's valid src rows, then its valid dst rows, from
``Trainer.embed_step``), ``scores_w{w}`` (logits, positives then
negatives per batch) and ``labels_w{w}``. ``--device`` and
``--compute-dtype`` are the online script's. The default checkpoint is
the offline script's, ``<MODEL>_torch.ckpt`` at the repository root.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from gnnflow_tpu_torch.data import DstRandEdgeSampler, get_batches
from gnnflow_tpu_torch.dynamic_graph import build_dynamic_graph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.factory import build_model
from gnnflow_tpu_torch.scripts.online_edge_prediction import (
    ROOT, StepTimer, add_device_args, load_stream)
from gnnflow_tpu_torch.train import Trainer
from gnnflow_tpu_torch.utils import average_precision_score, roc_auc_score
from gnnflow_tpu_torch.utils.checkpoint import load_checkpoint


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="test AP/AUC of a checkpoint over snapshot windows")
    parser.add_argument("--model", default="TGN")
    parser.add_argument("--data", default="SYNTHETIC")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--synthetic-edges", type=int, default=100_000)
    parser.add_argument("--time-windows", type=float, nargs="*", default=[0],
                        help="snapshot time windows to sweep")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--dump-embeddings", default=None,
                        help="npz path: per-window root embeddings, their "
                             "node ids, scores and labels")
    add_device_args(parser)
    return parser


def main(argv=None) -> dict:
    """Returns ``windows`` and, per window, ``ap``, ``auc``, ``eval_ms``
    and ``embed_ms`` (per batch; ``embed_ms`` only with
    ``--dump-embeddings``), and ``loaded``, whether a checkpoint was
    read."""
    args = make_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = args.device
    model_config, data_config, (_, _, test, full), node_feats, edge_feats \
        = load_stream(args, fallback=False)

    dgraph = build_dynamic_graph(**data_config)
    dgraph.add_edges(full.src, full.dst, full.time, full.eid,
                     add_reverse=data_config["undirected"])
    num_nodes = dgraph.max_vertex_id() + 1
    dim_node = 0 if node_feats is None else node_feats.shape[1]
    dim_edge = 0 if edge_feats is None else edge_feats.shape[1]
    efs, nfs = (None if t is None else
                torch.from_numpy(np.asarray(t, np.float32)).to(device)
                for t in (edge_feats, node_feats))
    ckpt_path = args.checkpoint or os.path.join(
        ROOT, f"{args.model}_torch.ckpt")
    timer = StepTimer(device)

    out = {"windows": list(args.time_windows), "ap": [], "auc": [],
           "eval_ms": [], "embed_ms": [],
           "loaded": os.path.exists(ckpt_path)}
    dump = {}
    for window in args.time_windows:
        cfg = dict(model_config)
        if window:
            cfg["snapshot_time_window"] = window
        model, trainer_kwargs = build_model(args.model, cfg, dim_node,
                                            dim_edge, seed=args.seed,
                                            device=device)
        trainer = Trainer(model, device=device, **trainer_kwargs)
        dg = dgraph.device_graph(device)
        batch_size = args.batch_size or cfg["batch_size"]
        state = trainer.init_state(num_nodes, seed=args.seed)
        if out["loaded"]:
            ckpt = load_checkpoint(ckpt_path)
            model.load_state_dict(ckpt["params"])
            model.cast_weights()
            if ckpt["memory"]:
                state.memory = memory_lib.resize_memory(
                    memory_lib.restore_memory(ckpt["memory"],
                                              trainer.device), num_nodes)
            logging.info("loaded checkpoint %s", ckpt_path)
        else:
            logging.warning("no checkpoint at %s; evaluating random init",
                            ckpt_path)

        neg = DstRandEdgeSampler(full.dst, seed=args.seed)
        scores, labels = [], []
        t0, nb = timer.start(), 0
        for batch in get_batches(test, batch_size, neg):
            _, _, pos, negs = trainer.eval_step(state, dg, efs, batch,
                                                node_feats=nfs)
            k = batch.num_valid
            scores += [pos[:k].float().cpu().numpy(),
                       negs[:k].float().cpu().numpy()]
            labels += [np.ones(k), np.zeros(k)]
            nb += 1
        out["eval_ms"].append(timer.stop(t0) / nb)
        y, t = np.concatenate(scores), np.concatenate(labels)
        ap, auc = average_precision_score(t, y), roc_auc_score(t, y)
        out["ap"].append(ap)
        out["auc"].append(auc)
        logging.info("window %s: test ap %.4f auc %.4f", window, ap, auc)

        if args.dump_embeddings:
            embeds, nids = [], []
            t0, nb = timer.start(), 0
            for batch in get_batches(test, batch_size, neg):
                e = trainer.embed_step(state, dg, efs, batch,
                                       node_feats=nfs).float().cpu().numpy()
                k, b = batch.num_valid, batch.batch_size
                embeds += [e[:k], e[b: b + k]]          # src, dst blocks
                nids += [batch.target_nodes[:k],
                         batch.target_nodes[b: b + k]]
                nb += 1
            out["embed_ms"].append(timer.stop(t0) / nb)
            dump[f"embeddings_w{window}"] = np.concatenate(embeds)
            dump[f"nids_w{window}"] = np.concatenate(nids)
            dump[f"scores_w{window}"] = y
            dump[f"labels_w{window}"] = t

    if args.dump_embeddings:
        np.savez(args.dump_embeddings, **dump)
        logging.info("saved embeddings to %s", args.dump_embeddings)
    return out


if __name__ == "__main__":
    main()
