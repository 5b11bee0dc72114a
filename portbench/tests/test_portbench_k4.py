"""K4's least time (``counts/dgnn_k4.py``) on a boundary counted by hand,
and its roofline reader on synthetic traces."""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

from portbench import harness
from portbench.counts import dgnn, dgnn_k4
from portbench.reference import dgnn as ref


def _cfg():
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "tgat-reddit-b4000.json"))
    return dict(cfg, stream=dict(cfg["stream"], dim_edge=4), dim_time=2,
                dim_embed=2, fanouts=[2, 2], sample_strategy="recent")


def test_k4_least_s_on_a_hand_counted_boundary():
    cfg = _cfg()
    # node 0 has two edges before t=5 (to node 1 at 1 and 2), node 1 one
    # (to node 0 at 3)
    store = ref.Store([0, 0, 1], [1, 1, 0],
                      np.array([1.0, 2.0, 3.0], np.float32), [0, 1, 2], "cpu")
    # one edge (0 -> 0) and its negative 1: roots (0, 5) twice, (1, 5)
    roots = np.array([0, 0, 1])
    ts = np.full(3, 5.0, np.float32)
    w = dgnn_k4.work(cfg, store, [(roots, ts, 1)], True, "cpu")
    # valid rows at the boundary: 3 roots and 2 + 2 + 1 slots; distinct
    # (node, time): (0, 5), (1, 5), (1, 2), (1, 1), (0, 3)
    valid, uniq, D = 8, 5, 2
    nbytes = valid * D * 4 + valid * 4 + uniq * D * 4
    assert w["k4_least_s"] == pytest.approx(
        harness.least_s(nbytes, valid * D, "float32"))
    assert w["k4_least_s"] == pytest.approx(136 / harness.HBM_BYTES_PER_S)
    plain = dgnn.work(cfg, store, [(roots, ts, 1)], True, "cpu")
    assert {k: v for k, v in w.items() if k != "k4_least_s"} == plain
    # two batches count twice; eval runs no K4
    two = dgnn_k4.work(cfg, store, [(roots, ts, 1)] * 2, True, "cpu")
    assert two["k4_least_s"] == pytest.approx(2 * w["k4_least_s"])
    assert dgnn_k4.work(cfg, store, [(roots, ts, 1)], False,
                        "cpu")["k4_least_s"] == 0.0


def _reader():
    path = os.path.join(harness.HERE, "metrics", "k4_roofline_pct.train.py")
    spec = importlib.util.spec_from_file_location("k4_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_k4_roofline_reads_segment_sum_kernels_only():
    read = _reader()
    tr = harness.Trace(window_s=1.0, steps=2)
    tr.work = {"k4_least_s": 2e-5}
    other = ("void at::native::vectorized_elementwise_kernel<4>()", 0,
             1_000_000)
    tr.ops = [other]
    assert read(tr) is None
    tr.ops += [("void (anonymous namespace)::tiles_kernel<4>("
                "(anonymous namespace)::Args)", 2_000_000, 30_000),
               ("void (anonymous namespace)::spans_kernel<4>("
                "(anonymous namespace)::Args)", 2_100_000, 10_000)]
    assert read(tr) == pytest.approx(50.0)
    tr.work = {}
    assert read(tr) is None
