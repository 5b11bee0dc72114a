"""Model factory: a model and the trainer's sampling arguments from a
config-registry entry.

Counterpart of ``gnnflow_tpu/models/factory.py:build_model``: GraphSAGE
and static GAT build :mod:`~gnnflow_tpu_torch.models.static`'s models,
every other registry model (TGN, TGAT, DySAT, APAN, and GAT without
``is_static``) the :class:`~gnnflow_tpu_torch.models.dgnn.DGNN`, which
also reads ``attention_impl``, ``neg_sample_ratio`` and
``remat_attention`` (``factory.py:36-58``); the DGNN family's trainer
kwargs carry the ratio.  As in JAX, GraphSAGE and static GAT are built
without it: their predictors split the roots in three
(``static.py:184, 238``).
"""
from __future__ import annotations

from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.static import GAT, SAGE

MODELS = ("tgn", "tgat", "dysat", "apan", "graphsage", "gat")


def build_model(name: str, model_config: dict, dim_node: int, dim_edge: int,
                *, seed: int = 0, device="cuda"):
    """Return ``(model, trainer_kwargs)`` for a registry model name; the
    weights are drawn from ``seed``."""
    name = name.lower()
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}")
    cfg = dict(model_config)
    kwargs = {"fanouts": cfg["fanouts"],
              "sample_strategy": cfg.get("sample_strategy", "recent"),
              "num_snapshots": cfg.get("num_snapshots", 1),
              "snapshot_time_window": cfg.get("snapshot_time_window", 0),
              "prop_time": cfg.get("prop_time", False),
              "is_static": cfg.get("is_static", False)}
    common = dict(compute_dtype=cfg.get("compute_dtype"), seed=seed,
                  device=device)
    if name == "graphsage":
        model = SAGE(dim_node=dim_node, dim_embed=cfg["dim_embed"],
                     num_layers=cfg["num_layers"],
                     aggregator=cfg.get("aggregator", "mean"), **common)
    elif name == "gat" and cfg.get("is_static", False):
        model = GAT(dim_node=dim_node, dim_embed=cfg["dim_embed"],
                    num_layers=cfg["num_layers"],
                    attn_head=[cfg.get("att_head", 8)]
                    * (cfg["num_layers"] - 1) + [1],
                    feat_drop=cfg.get("dropout", 0.0),
                    attn_drop=cfg.get("att_dropout", 0.0), **common)
    else:
        model = DGNN(dim_node=dim_node, dim_edge=dim_edge,
                     dim_time=cfg.get("dim_time", 0),
                     dim_embed=cfg["dim_embed"],
                     num_layers=cfg["num_layers"],
                     num_snapshots=cfg.get("num_snapshots", 1),
                     att_head=cfg.get("att_head", 2),
                     dropout=cfg.get("dropout", 0.0),
                     att_dropout=cfg.get("att_dropout", 0.0),
                     use_memory=cfg.get("use_memory", False),
                     dim_memory=cfg.get("dim_memory"),
                     memory_updater=cfg.get("memory_updater", "gru"),
                     mailbox_slots=cfg.get("mailbox_slots", 1),
                     attention_impl=cfg.get("attention_impl", "xla"),
                     neg_sample_ratio=cfg.get("neg_sample_ratio", 1),
                     remat_attention=cfg.get("remat_attention", False),
                     **common)
        kwargs["neg_sample_ratio"] = cfg.get("neg_sample_ratio", 1)
    return model, kwargs
