"""The plain reference against the program on tiny shapes on the CPU
(every cell of the benchmark comes out correct), and the operation and
byte counts on shapes counted by hand."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import dgnn as ref
from portbench.run import Ctx, execute
from portbench.tests import tiny

CELLS = [w["name"] for w in harness.load_json(
    harness.os.path.join(harness.ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("name", CELLS + list(tiny.VARIANTS))
def test_cell_correct_on_cpu(name):
    res = execute(Ctx(tiny.cell(name), 11, 0.5, 0, "cpu"))
    assert res["correct"], res["checks"]
    for c in res["checks"].values():
        assert c["value"] < 1e-4


def test_store_samples_strictly_before_time_in_arrival_order():
    src = [0, 0, 0, 1, 0]
    dst = [5, 6, 7, 8, 9]
    ts = np.array([1.0, 2.0, 2.0, 1.0, 3.0], np.float32)
    store = ref.Store(src, dst, ts, np.arange(5), "cpu")
    nbr = store.sample(torch.tensor([0, 0, -1]),
                       torch.tensor([2.5, 2.0, 9.0]), 3)
    assert nbr["nid"].tolist() == [[7, 6, 5], [5, -1, -1], [-1, -1, -1]]
    u = torch.tensor([[0.0, 0.99], [0.5, 0.5]])
    pick = store.sample(torch.tensor([0, 1]), torch.tensor([9.0, 9.0]), 2,
                        u)
    assert pick["nid"].tolist() == [[9, 5], [8, 8]]
    assert pick["mask"].all()


def test_counts_on_hand_counted_shapes():
    from portbench.counts import dgnn as counts
    cfg = harness.load_json(harness.os.path.join(
        harness.HERE, "configs", "tgn-reddit.json"))
    cfg = dict(cfg, stream=dict(cfg["stream"], dim_edge=4), dim_time=2,
               dim_embed=2, dim_memory=2, fanouts=[2])
    # node 0 has two edges before t=5, node 1 none: 2 roots of the batch's
    # three blocks are valid (one edge), 2 valid slots
    store = ref.Store([0, 0], [1, 1], np.array([1.0, 2.0], np.float32),
                      [0, 1], "cpu")
    roots = np.array([0, 1, 1])
    ts = np.full(3, 5.0, np.float32)
    w = counts.work(cfg, store, [(roots, ts, 1)], False, "cpu")
    # GRU rows: (0, 5), (1, 5), (1, 1), (1, 2) are distinct: M = 4
    dr, dt, f = 2 * 2 + 4, 2, 2
    gru = 2.0 * 4 * ((dr + dt) * 3 * f + f * 3 * f)
    att = (2.0 * 3 * (2 + 2) * 2 + 2.0 * 2 * (2 + 4 + 2) * 4
           + 4.0 * 2 * 2 + 2.0 * 3 * (2 + 2) * 2)
    pred = 2.0 * 1 * 2 * 2 + 2.0 * 2 * 2 * 2 + 2.0 * 2 * 2 * 1
    assert w["flops"] == pytest.approx(gru + att + pred)
    nbytes = (2 * 3 * 2 + 2 * 2 * 2) * 4 + 3 * 2
    assert w["attn_least_s"] == pytest.approx(
        harness.least_s(nbytes, 4.0 * 2 * 2, "float32"))
    wt = counts.work(cfg, store, [(roots, ts, 1)], True, "cpu")
    assert wt["attn_least_s"] == 0.0       # attention dropout: no K3
    assert wt["flops"] > 2 * w["flops"]
    assert wt["gru_least_s"] > w["gru_least_s"] > 0


def test_leaf_gap_is_worst_leaf_against_the_median():
    ref_n = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.1, "b": 2.0, "c": 2e-9}
    # c is measured against the median leaf (2.0), not its own 1e-9
    assert ref.leaf_gap(got, ref_n, list(ref_n)) == pytest.approx(0.1)
