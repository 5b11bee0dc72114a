"""Default model/dataset configuration registry.

Copy of ``gnnflow_tpu/config.py`` (same model families, datasets and
values), kept here so the port never imports the JAX package.
"""
from __future__ import annotations

import sys

MiB = 1 << 20
GiB = 1 << 30

MODELS = ["tgn", "tgat", "dysat", "graphsage", "gat", "apan"]
DATASETS = ["wiki", "reddit", "mooc", "lastfm", "gdelt", "mag", "synthetic"]


def get_default_config(model: str, dataset: str):
    """Return ``(model_config, data_config)`` for a model/dataset pair."""
    model, dataset = model.lower(), dataset.lower()
    if model not in MODELS or dataset not in DATASETS:
        raise ValueError("Invalid model or dataset.")
    mod = sys.modules[__name__]
    return (dict(getattr(mod, f"_{model}_default_config")),
            dict(getattr(mod, f"_{dataset}_default_config")))


_tgn_default_config = {
    "dropout": 0.2,
    "att_head": 2,
    "att_dropout": 0.2,
    "num_layers": 1,
    "fanouts": [10],
    "sample_strategy": "recent",
    "num_snapshots": 1,
    "snapshot_time_window": 0,
    "prop_time": False,
    "use_memory": True,
    "dim_time": 100,
    "dim_embed": 100,
    "dim_memory": 100,
    "batch_size": 4000,
}

_tgat_default_config = {
    "dropout": 0.1,
    "att_head": 2,
    "att_dropout": 0.1,
    "num_layers": 2,
    "fanouts": [10, 10],
    "sample_strategy": "uniform",
    "num_snapshots": 1,
    "snapshot_time_window": 0,
    "prop_time": False,
    "use_memory": False,
    "dim_time": 100,
    "dim_embed": 100,
    "batch_size": 600,
}

_dysat_default_config = {
    "dropout": 0.1,
    "att_head": 2,
    "att_dropout": 0.1,
    "num_layers": 2,
    "fanouts": [10, 10],
    "sample_strategy": "uniform",
    "num_snapshots": 3,
    "snapshot_time_window": 10000,
    "prop_time": True,
    "use_memory": False,
    "dim_time": 0,
    "dim_embed": 100,
    "batch_size": 600,
}

_graphsage_default_config = {
    "dim_embed": 100,
    "num_layers": 2,
    "aggregator": "mean",
    "fanouts": [15, 10],
    "sample_strategy": "uniform",
    "num_snapshots": 1,
    "snapshot_time_window": 0,
    "prop_time": False,
    "use_memory": False,
    "is_static": True,
    "batch_size": 1200,
}

_gat_default_config = {
    "dropout": 0.1,
    "att_head": 2,
    "att_dropout": 0.1,
    "num_layers": 2,
    "fanouts": [10, 10],
    "sample_strategy": "uniform",
    "num_snapshots": 1,
    "snapshot_time_window": 0,
    "prop_time": False,
    "use_memory": False,
    "dim_time": 0,
    "dim_embed": 100,
    "is_static": True,
    "batch_size": 600,
}

_apan_default_config = {
    "dropout": 0.1,
    "att_head": 2,
    "att_dropout": 0.1,
    "num_layers": 1,
    "fanouts": [10],
    "sample_strategy": "recent",
    "num_snapshots": 1,
    "snapshot_time_window": 0,
    "prop_time": False,
    "use_memory": True,
    "memory_updater": "transformer",
    "mailbox_slots": 10,
    "dim_time": 100,
    "dim_embed": 100,
    "dim_memory": 100,
    "batch_size": 4000,
}


def _data_cfg(init_edges, max_edges, storage, min_slack, undirected,
              node_feature, edge_feature):
    return {
        "initial_pool_size": init_edges,
        "maximum_pool_size": max_edges,
        "mem_resource_type": storage,
        "minimum_block_size": min_slack,
        "insertion_policy": "insert",
        "undirected": undirected,
        "node_feature": node_feature,
        "edge_feature": edge_feature,
    }


_wiki_default_config = _data_cfg(
    1 * MiB, 4 * MiB, "hbm", 18, True, False, True)
_reddit_default_config = _data_cfg(
    2 * MiB, 8 * MiB, "hbm", 62, False, True, True)
_mooc_default_config = _data_cfg(
    1 * MiB, 4 * MiB, "hbm", 59, False, False, True)
_lastfm_default_config = _data_cfg(
    2 * MiB, 8 * MiB, "hbm", 650, False, False, True)
_gdelt_default_config = _data_cfg(
    256 * MiB, 1 * GiB, "host", 123, False, True, True)
_mag_default_config = _data_cfg(
    512 * MiB, 4 * GiB, "host", 11, False, True, False)
_synthetic_default_config = _data_cfg(
    1 * MiB, 16 * MiB, "hbm", 16, True, True, True)
