"""A cell cut to a size that the CPU runs in seconds, for the benchmark's
tests: the same files, with the stream, the batch, the store's pool and
the chunks made small.

``tgat-train`` is no cell of ``BENCHMARK.json`` yet: here it is
``tgn-train`` with the registry's TGAT model (two layers of uniform
neighbours, no memory), so that the reference's two-layer, uniform path
stays held to the program."""
from __future__ import annotations

import copy

import torch

from portbench import harness

# the tests run side by side in several processes: one thread each keeps
# the CPU's cores from being asked for many times over
torch.set_num_threads(1)

# the registry's _tgat_default_config, over tgn-train's files
TGAT = {"model": "tgat", "dropout": 0.1, "att_dropout": 0.1,
        "num_layers": 2, "fanouts": [10, 10], "sample_strategy": "uniform",
        "use_memory": False, "batch_size": 600}
VARIANTS = {"tgat-train": ("tgn-train", TGAT)}


def cell(name: str, root: str = harness.ROOT) -> harness.Cell:
    base, over = VARIANTS.get(name, (name, {}))
    c = harness.load_cell(base, root)
    c.name = name
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    if over:
        c.config.update(copy.deepcopy(over))
        del c.config["dim_memory"]
    c.config["stream"].update(num_src=300, num_dst=40, num_edges=4000,
                              dim_edge=12)
    c.config["batch_size"] = 200 if c.config.get("use_memory") else 60
    c.config["data"].update(initial_pool_size=4096,
                            maximum_pool_size=1 << 20)
    if c.traffic["loop"] == "online_chunks":
        c.traffic.update(chunk=150, chunks=16, check_chunks=[0, 10],
                         check_drawn=[11, 14])
    return c
