"""Model factory: a model and the trainer's sampling arguments from a
config-registry entry.

Counterpart of ``gnnflow_tpu/models/factory.py:build_model`` for TGN,
TGAT, DySAT and APAN.  The other registry models raise ``NotImplementedError``
naming the ROADMAP.md item that brings them, and so do configs the port
does not take yet (static sampling, more than one negative per edge).
"""
from __future__ import annotations

from gnnflow_tpu_torch.models.dgnn import DGNN

# registry models still to port -> their ROADMAP.md item
UNPORTED_MODELS = {"graphsage": "item 10", "gat": "item 10"}


def build_model(name: str, model_config: dict, dim_node: int, dim_edge: int,
                *, seed: int = 0, device="cuda"):
    """Return ``(model, trainer_kwargs)`` for a registry model name; the
    weights are drawn from ``seed`` (see :class:`DGNN`)."""
    name = name.lower()
    if name in UNPORTED_MODELS:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, modules to port, "
            f"{UNPORTED_MODELS[name]})")
    if name not in ("tgn", "tgat", "dysat", "apan"):
        raise ValueError(f"unknown model {name!r}")
    cfg = dict(model_config)
    unported = {"is_static": (False, "item 10"),
                "neg_sample_ratio": (1, "item 5")}
    for key, (ported, item) in unported.items():
        if cfg.get(key, ported) != ported:
            raise NotImplementedError(
                f"{key}={cfg[key]!r} is not ported yet (ROADMAP.md, modules "
                f"to port, {item})")
    model = DGNN(dim_node=dim_node, dim_edge=dim_edge,
                 dim_time=cfg.get("dim_time", 0), dim_embed=cfg["dim_embed"],
                 num_layers=cfg["num_layers"],
                 num_snapshots=cfg.get("num_snapshots", 1),
                 att_head=cfg.get("att_head", 2),
                 dropout=cfg.get("dropout", 0.0),
                 att_dropout=cfg.get("att_dropout", 0.0),
                 use_memory=cfg.get("use_memory", False),
                 dim_memory=cfg.get("dim_memory"),
                 memory_updater=cfg.get("memory_updater", "gru"),
                 mailbox_slots=cfg.get("mailbox_slots", 1),
                 compute_dtype=cfg.get("compute_dtype"), seed=seed,
                 device=device)
    return model, {"fanouts": cfg["fanouts"],
                   "sample_strategy": cfg.get("sample_strategy", "recent"),
                   "num_snapshots": cfg.get("num_snapshots", 1),
                   "snapshot_time_window": cfg.get("snapshot_time_window", 0),
                   "prop_time": cfg.get("prop_time", False)}
