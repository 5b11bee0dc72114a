"""DySAT: the port against the JAX package, f32, on the tiny stream of
tests/test_torch_tgat.py (120 src, 30 dst, 5000 edges over t in [0, 5100);
edge and embedding dims 12/32, no time encoding; 3 snapshots of window
200 with ``prop_time``; fanouts [5, 5]; batch 240).

The JAX side builds only the padded DySAT program (``compact_factor=None``,
``model_compact=False``, ``layer_dedup=None``, ``attention_impl="xla"``)
and the calibration's probe sampler, never the block compaction's or the
snapshot dedup's programs: the port's fast paths are held against the JAX
padded losses, which they must equal since both paths are exact on recent
sampling.

Tolerances:
- windowed sampling, recent and uniform from the same draws, the packed
  roots of the block compaction and their ranks: bit-identical.
- ``expand_blocks``: forward and gradient bit-identical (gathers only).
- attention layer and DGNN outputs 1e-5 absolute (f32 sums in other
  orders); first-step gradients, per parameter, max abs error over max
  abs value 1e-5 (as tests/test_torch_tgat.py).
- train steps: losses rtol 1e-5, atol 1e-6; parameters after each Adam
  step (lr 1e-4) 1e-5 absolute, a tenth of one step (as
  tests/test_torch_tgat.py).
- calibration decisions: equal.
"""
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.models.modules import \
    TemporalAttentionLayer as JAttentionLayer
from gnnflow_tpu.ops import sampling as jsampling
from gnnflow_tpu.ops.segment_pallas import expand_blocks as jexpand_blocks
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu.train import _valid_mask as jvalid_mask
from gnnflow_tpu.train import fetch_features as jfetch_features
from gnnflow_tpu_torch import config, data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.factory import build_model
from gnnflow_tpu_torch.models.modules import TemporalAttentionLayer
from gnnflow_tpu_torch.models.weights import (_flax_path, flax_param_tree,
                                              load_flax_params)
from gnnflow_tpu_torch.ops import sampling
from gnnflow_tpu_torch.ops.segment_sum import expand_blocks
from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
from gnnflow_tpu_torch.train import (Trainer, compact_factor_for,
                                     fetch_features, link_pred_loss,
                                     tier_ladder)
from gnnflow_tpu_torch.utils.checkpoint import load_checkpoint
from torch_fixtures import graphs, one_cpu_thread  # noqa: F401
from torch_fixtures import _assert_mfgs_identical, _flat, _roots
from torch_parity import (DYSAT_CFG, DYSAT_FANOUTS, DYSAT_WIN, _hop_stream,
                          _jax_graph, _port_graph, jax_state)

B = 240
STEPS = 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX padded DySAT trainer's initial parameters and its losses
    and parameters after each of STEPS train steps (recent sampling,
    chronological batches)."""
    train, _, _, full, _, ef = _hop_stream()
    jg = _jax_graph(full)
    jdg = jg.device_graph()
    trainer = JTrainer(JDGNN(**DYSAT_CFG), fanouts=list(DYSAT_FANOUTS),
                       sample_strategy="recent", lr=1e-4,
                       compact_factor=None, model_compact=False,
                       layer_dedup=None, **DYSAT_WIN)
    assert trainer._calibrated            # nothing left to calibrate
    jef = jnp.asarray(ef)
    state = jax_state(trainer, DGNN(**DYSAT_CFG, device="cpu"),
                      jg.max_vertex_id() + 1)
    params0 = jax.tree.map(np.asarray, state.params)
    state0 = jax.tree.map(jnp.array, state)
    losses, params = [], []
    batches = jdata.get_batches(train, B,
                                jdata.DstRandEdgeSampler(train.dst, seed=1))
    for _, b in zip(range(STEPS), batches):
        state, loss, _, _ = trainer.train_step(state, jdg, None, jef, b)
        losses.append(float(loss))
        params.append(jax.tree.map(np.asarray, state.params))
    return dict(trainer=trainer, dg=jdg, ef=jef, state0=state0,
                params0=params0, losses=losses, params=params)


def _port_run(params0, steps=STEPS, **knobs):
    """The port's DySAT trainer from ``params0`` over ``steps`` train
    steps of the batches ``jax_run`` takes: losses, parameter trees, and
    per step the boundaries on the snapshot dedup and on the block
    compaction."""
    train, _, _, full, _, ef = _hop_stream()
    model = DGNN(**DYSAT_CFG, device="cpu")
    load_flax_params(model, params0)
    trainer = Trainer(model, fanouts=list(DYSAT_FANOUTS),
                      sample_strategy="recent", lr=1e-4, device="cpu",
                      **DYSAT_WIN, **knobs)
    g = _port_graph(full)
    dg = g.device_graph("cpu")
    state = trainer.init_state(g.max_vertex_id() + 1)
    tef = torch.from_numpy(ef)
    out = dict(trainer=trainer, state=state, losses=[], params=[],
               dedup=[], blocks=[])
    batches = data.get_batches(train, B,
                               data.DstRandEdgeSampler(train.dst, seed=1))
    for _, b in zip(range(steps), batches):
        state, loss, _, _ = trainer.train_step(state, dg, tef, b)
        out["losses"].append(float(loss))
        out["params"].append(flax_param_tree(model))
        out["dedup"].append(state.layer_dedup_compact)
        out["blocks"].append(state.block_compact)
    return out


def _draws(key, shape):
    return jax.random.uniform(key, shape, dtype=jnp.float32)


# ---- (a): windowed sampling ------------------------------------------------

@pytest.mark.parametrize("strategy, shared", [("recent", True),
                                              ("uniform", True),
                                              ("uniform", False)])
def test_sample_layer_snapshots_bit_identical(graphs, strategy,  # noqa: F811
                                              shared):
    """Three windows of 700 (the stream spans t < 5000), ``prop_time``;
    shared roots take the chained boundaries, others a row of roots and
    timestamps per snapshot."""
    ours, ref, hub_edge_ts = graphs
    roots, ts = _roots(hub_edge_ts)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    if shared:
        R, T = np.stack([roots] * 3), np.stack([ts] * 3)
    else:
        rng = np.random.RandomState(2)
        R = np.stack([roots, rng.permutation(roots), roots[::-1]])
        T = np.stack([ts, rng.permutation(ts), ts + 350.5])
    key = jax.random.PRNGKey(11)
    u = _draws(key, R.shape + (6,))
    kw = dict(fanout=6, strategy=strategy, num_snapshots=3, window=700.0,
              prop_time=True, shared_roots=shared)
    got = sampling.sample_layer_snapshots(
        dg, torch.from_numpy(R), torch.from_numpy(T),
        u=torch.from_numpy(np.array(u)) if strategy == "uniform" else None,
        **kw)
    want = jsampling.sample_layer_snapshots(
        jdg, jnp.asarray(R, jnp.int32), jnp.asarray(T), key=key,
        search_iters=jdg.search_iters, **kw)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _assert_mfgs_identical(a, b)
    assert 0 < sum(int(m.nbr_mask.sum()) for m in got) < R.size * 6


def test_snapshot_bounds_round_as_jax():
    """Edges placed exactly on the snapshot bounds ``ts - k·W`` as float32
    computes them with the product rounded first, and as one rounding of
    the exact value (an FMA) gives them, and one ulp to either side: each
    lands in the same snapshot on both sides, for shared roots (the
    chained bounds), rows of their own, and ``sample_layer``'s double
    product.  Some bounds differ between the two roundings, so an FMA in
    the port would move an edge.  400 rows: XLA on the CPU contracts the
    chained bound into an FMA when the program is as small as 8 rows, and
    rounds as the source is written at 400 (ROADMAP.md §3)."""
    W = np.float32(1234.567)
    rng = np.random.RandomState(8)
    root_ts = (rng.rand(8) * 1000 + 2000).astype(np.float32)
    edge_ts, differ = [], np.zeros(2, np.int64)
    for t in root_ts:
        for k in range(4):
            sep = np.float32(t - np.float32(np.float32(k) * W))
            fma = np.float32(np.float64(t) - k * np.float64(W))
            dbl = np.float32(t - np.float32(k * 1234.567))
            differ += [sep != fma, sep != dbl]
            for b in (sep, fma, dbl):
                edge_ts += [b, np.nextafter(b, np.float32(-np.inf)),
                            np.nextafter(b, np.float32(np.inf))]
    assert differ.min() > 0
    edge_ts = np.asarray(edge_ts, np.float32)
    n = len(edge_ts)
    ours = DynamicGraph(initial_pool_size=1 << 12, minimum_block_size=8)
    ref = JGraph(initial_pool_size=1 << 12, minimum_block_size=8)
    for g in (ours, ref):
        g.add_edges(np.zeros(n, np.int64), np.arange(1, n + 1), edge_ts,
                    add_reverse=False)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    root_ts = np.tile(root_ts, 50)
    roots = np.zeros(len(root_ts), np.int64)
    kw = dict(fanout=128, num_snapshots=3, window=1234.567, prop_time=False)
    for shared in (True, False):
        R, T = np.stack([roots] * 3), np.stack([root_ts] * 3)
        got = sampling.sample_layer_snapshots(
            dg, torch.from_numpy(R), torch.from_numpy(T),
            shared_roots=shared, **kw)
        want = jsampling.sample_layer_snapshots(
            jdg, jnp.asarray(R, jnp.int32), jnp.asarray(T),
            shared_roots=shared, search_iters=jdg.search_iters, **kw)
        for a, b in zip(got, want):
            _assert_mfgs_identical(a, b)
            assert a.nbr_mask.any()
    # snapshot 0: the bounds k = 3 and 2, whose products are inexact
    got = sampling.sample_layer(dg, torch.from_numpy(roots),
                                torch.from_numpy(root_ts), **kw)
    want = jsampling.sample_layer(jdg, jnp.asarray(roots, jnp.int32),
                                  jnp.asarray(root_ts),
                                  search_iters=jdg.search_iters, **kw)
    _assert_mfgs_identical(got, want)


@pytest.mark.parametrize("window, prop_time", [(500.0, True),
                                               (1234.5, False)])
def test_windowed_sample_layer_bit_identical(graphs, window,  # noqa: F811
                                             prop_time):
    """One snapshot with a window ``[ts - W, ts)``, uniform from the same
    draws."""
    ours, ref, hub_edge_ts = graphs
    roots, ts = _roots(hub_edge_ts)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    key = jax.random.PRNGKey(3)
    u = _draws(key, (len(roots), 4))
    got = sampling.sample_layer(dg, torch.from_numpy(roots),
                                torch.from_numpy(ts), fanout=4,
                                strategy="uniform", window=window,
                                prop_time=prop_time,
                                u=torch.from_numpy(np.array(u)))
    want = jsampling.sample_layer(jdg, jnp.asarray(roots, jnp.int32),
                                  jnp.asarray(ts), fanout=4,
                                  strategy="uniform", window=window,
                                  prop_time=prop_time, key=key,
                                  search_iters=jdg.search_iters)
    _assert_mfgs_identical(got, want)


def test_sample_deeper_compact_and_overflow_bit_identical(
        graphs):  # noqa: F811
    """The packed roots and their ranks below a first layer of three
    snapshots, uniform picks from the same draws over them; the overflow
    test on both sides of the largest valid-block count."""
    ours, ref, hub_edge_ts = graphs
    roots, ts = _roots(hub_edge_ts)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    kw = dict(num_snapshots=3, window=700.0, prop_time=True)
    R, T = np.stack([roots] * 3), np.stack([ts] * 3)
    first = sampling.sample_layer_snapshots(
        dg, torch.from_numpy(R), torch.from_numpy(T), fanout=3,
        shared_roots=True, **kw)
    jfirst = jsampling.sample_layer_snapshots(
        jdg, jnp.asarray(R, jnp.int32), jnp.asarray(T), fanout=3,
        shared_roots=True, search_iters=jdg.search_iters, **kw)
    most = max(int(m.nbr_mask.any(1).sum()) for m in first)
    assert 0 < most < len(roots)
    for cap, over in ((most, False), (most - 1, True)):
        assert bool(sampling.boundary_overflow(first, cap)) is over
        assert bool(jsampling.boundary_overflow(jfirst, cap)) is over
    cap = most + 5
    key = jax.random.PRNGKey(5)
    u = _draws(key, (3, len(roots) + cap * 3, 4))
    got, rank = sampling.sample_deeper_compact(
        dg, first, cap, fanout=4, strategy="uniform",
        u=torch.from_numpy(np.array(u)), **kw)
    want, jrank = jax.jit(lambda f: jsampling.sample_deeper_compact(
        jdg, f, cap, fanout=4, strategy="uniform", key=key,
        search_iters=jdg.search_iters, **kw))(jfirst)
    assert np.array_equal(rank.numpy(), np.asarray(jrank))
    assert (rank == cap).any() and (rank < cap).any()
    for a, b in zip(got, want):
        assert a.num_dst == len(roots) + cap * 3
        _assert_mfgs_identical(a, b)


@pytest.mark.parametrize("factor, strategy", [(0.9, "recent"),
                                              (0.05, "uniform")])
def test_compacted_sample_hops_equal_padded(graphs, factor,  # noqa: F811
                                            strategy):
    """Two layers of three snapshots sampled through the compacted second
    layer (``_sample_layer_compacted``) give the padded MFGs: at factor
    0.9 the packed roots fit and the recent picks expand back to the
    padded ones; at 0.05 a snapshot overflows and the layer samples
    padded, on the padded draws.  (The packed roots and uniform picks
    over them are held to JAX above.)"""
    ours, _, hub_edge_ts = graphs
    roots, ts = _roots(hub_edge_ts)
    dg = ours.device_graph("cpu")
    shapes = []

    def draw(layer, shape):
        shapes.append(shape)
        return torch.rand(shape, generator=torch.Generator().manual_seed(
            layer))

    kw = dict(fanouts=[4, 3], strategy=strategy, num_snapshots=3,
              window=700.0, prop_time=True, draw=draw)
    got = sampling.sample_hops(dg, torch.from_numpy(roots),
                               torch.from_numpy(ts), compact_factor=factor,
                               **kw)
    padded = sampling.sample_hops(dg, torch.from_numpy(roots),
                                  torch.from_numpy(ts), **kw)
    B, cap = len(roots), math.ceil(factor * len(roots))
    fits = not sampling.boundary_overflow(padded[1], cap)
    assert fits == (factor == 0.9)
    assert (strategy == "recent") or shapes == [(3, B, 4), (3, 5 * B, 3)] * 2
    for layer, player in zip(got, padded):
        assert len(layer) == 3
        for a, c in zip(layer, player):
            _assert_mfgs_identical(a, c)


# ---- (b): expand_blocks ----------------------------------------------------

def test_expand_blocks_matches_jax_custom_vjp():
    rng = np.random.RandomState(4)
    Bp, F, d, cap = 50, 3, 7, 30
    valid = rng.rand(Bp) < 0.55
    rank = np.where(valid, np.cumsum(valid) - 1, cap)
    assert valid.sum() <= cap
    rst = rng.randn(Bp + cap * F, d).astype(np.float32)
    g = rng.randn(Bp * (1 + F), d).astype(np.float32)
    x = torch.from_numpy(rst).requires_grad_()
    got = expand_blocks(x, torch.from_numpy(rank), cap, F)
    got.backward(torch.from_numpy(g))

    @jax.jit
    def fwd_bwd(r, ct):
        out, vjp = jax.vjp(lambda r_: jexpand_blocks(r_, jnp.asarray(rank),
                                                     cap, F), r)
        return out, vjp(ct)[0]

    want, want_grad = fwd_bwd(jnp.asarray(rst), jnp.asarray(g))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    assert not got[Bp:].reshape(Bp, -1)[torch.from_numpy(~valid)].any()
    assert np.array_equal(x.grad.numpy(), np.asarray(want_grad))


# ---- (c), (d): the layer without time encoding, and the model -------------

@pytest.mark.parametrize("dim_node", [0, 16])
def test_attention_without_time_matches_flax(dim_node):
    """``l0h*`` (no node input: Q is ones, no ``w_q``) and ``l1h*`` (node
    input: ``w_q([h_dst])``, ``w_out([agg, h_dst])``) without time
    encoding."""
    train, _, _, full, _, ef = _hop_stream()
    g = _port_graph(full)
    roots = np.concatenate([train.src[:300], train.dst[:300]])
    ts = np.tile(train.time[:300], 2).astype(np.float32) + 700.0
    kw = dict(fanout=5, num_snapshots=3, snapshot_idx=1, window=200.0,
              prop_time=True)
    m = sampling.sample_layer(g.device_graph("cpu"), torch.from_numpy(roots),
                              torch.from_numpy(ts), **kw)
    jm = jsampling.sample_layer(_jax_graph(full).device_graph(),
                                jnp.asarray(roots, jnp.int32),
                                jnp.asarray(ts), **kw)
    _assert_mfgs_identical(m, jm)
    assert 0 < int(m.nbr_mask.sum()) < m.nbr_mask.numel()
    ef_t = fetch_features([[m]], torch.from_numpy(ef))[0][0]
    h = np.random.RandomState(1).randn(600 * 6, dim_node).astype(np.float32)
    jh = jnp.asarray(h) if dim_node else None
    layer = JAttentionLayer(dim_node=dim_node, dim_edge=12, dim_time=0,
                            dim_out=32, num_head=2)
    jef = jnp.asarray(ef_t.numpy())
    params = jax.jit(layer.init)(jax.random.PRNGKey(3), jm, jh,
                                 jef)["params"]
    want = jax.jit(layer.apply)({"params": params}, jm, jh, jef)
    ours = TemporalAttentionLayer(dim_node, 12, 0, 32, 2, torch.Generator())
    assert hasattr(ours, "w_q") == (dim_node > 0)
    assert not hasattr(ours, "time_enc")
    flat = _flat(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        for name, p in ours.named_parameters():
            p.copy_(torch.from_numpy(flat.pop(_flax_path(name))))
    assert not flat                      # every Flax parameter carried
    for lin in ([ours.w_q] if dim_node else []) + [ours.w_kv, ours.w_out]:
        lin.cast_weights()
    with torch.no_grad():
        got = ours(m, torch.from_numpy(h) if dim_node else None, ef_t)
    assert got.shape == (600, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_dysat_logits_and_gradients_match_jax(jax_run):
    """One training forward and backward at dropout 0 on the first batch,
    padded: MFGs, logits, loss and every parameter's gradient, the
    combiner's included."""
    train, _, _, full, _, ef = _hop_stream()
    jtrainer, jdg, jef = jax_run["trainer"], jax_run["dg"], jax_run["ef"]
    b = next(iter(data.get_batches(
        train, B, data.DstRandEdgeSampler(train.dst, seed=1))))
    jmfgs = jtrainer._sample(jdg, jnp.asarray(b.target_nodes, jnp.int32),
                             jnp.asarray(b.ts, jnp.float32),
                             jax.random.PRNGKey(1))
    jnfs, jefs = jfetch_features(jmfgs, None, jef, None, DYSAT_CFG["dim_edge"])
    run = jax.jit(jtrainer._run_model, static_argnums=(5,))
    jloss, jpos, jneg, _, jgrads = run(jax_run["state0"], jmfgs, jefs,
                                       jax.random.PRNGKey(2), jvalid_mask(b),
                                       True, None, jnfs)

    model = DGNN(**DYSAT_CFG, device="cpu")
    load_flax_params(model, jax_run["params0"])
    trainer = Trainer(model, fanouts=list(DYSAT_FANOUTS), layer_dedup=None,
                      compact_factor=None, device="cpu", **DYSAT_WIN)
    g = _port_graph(full)
    st = trainer.init_state(g.max_vertex_id() + 1)
    mfgs, efs, _, _, valid, exps = trainer._inputs(
        st, g.device_graph("cpu"), torch.from_numpy(ef), b)
    assert exps is None
    for layer, jlayer in zip(mfgs, jmfgs):
        assert len(layer) == 3
        for m, jm in zip(layer, jlayer):
            _assert_mfgs_identical(m, jm)
    pos, neg, _ = model(mfgs, efs, None, train=True,
                        generator=st.dropout_gen)
    np.testing.assert_allclose(pos.detach().numpy(), np.asarray(jpos),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(neg.detach().numpy(), np.asarray(jneg),
                               rtol=0, atol=1e-5)
    loss = link_pred_loss(pos, neg, valid)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = DGNN(**DYSAT_CFG, device="cpu")  # a carrier for the gradients
    with torch.no_grad():
        for gp, p in zip(grads.parameters(), model.parameters()):
            gp.copy_(p.grad)
    got, want = _flat(flax_param_tree(grads)), _flat(jgrads)
    assert got.keys() == want.keys()
    assert ("combiner", "hh", "kernel") in want
    for name, w in want.items():
        scale = np.abs(w).max()
        err = np.abs(got[name] - w).max()
        assert err <= 1e-5 * max(scale, 1e-30), (name, err, scale)


# ---- (e), (f): training, padded and on the fast paths ----------------------

def test_padded_train_matches_jax(jax_run):
    ours = _port_run(jax_run["params0"], compact_factor=None,
                     model_compact=False, layer_dedup=None)
    np.testing.assert_allclose(ours["losses"], jax_run["losses"], rtol=1e-5,
                               atol=1e-6)
    for got_tree, want_tree in zip(ours["params"], jax_run["params"]):
        got, want = _flat(got_tree), _flat(want_tree)
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5,
                                       err_msg=str(name))
    assert ours["dedup"] == ours["blocks"] == [0] * STEPS


@pytest.mark.parametrize("knobs, dedup, blocks, takes", [
    # first-boundary unique counts 2047, 2531 and 2631 of 4320 instances;
    # caps 2304 (0.5) and 2816 (0.62)
    # the snapshot dedup: one tier that fits, a two-tier ladder, and a
    # forced fallback
    (dict(layer_dedup=0.5, compact_factor=None), [1, 0, 0], [0, 0, 0],
     [1, 2, 0, 0]),
    (dict(layer_dedup=(0.5, 0.62), compact_factor=None), [1, 1, 1],
     [0, 0, 0], [1, 2, 0, 0]),
    (dict(layer_dedup=0.01), [0, 0, 0], [0, 0, 0], [0, 3, 0, 0]),
    # the block compaction: it fits, and it overflows
    (dict(layer_dedup=None, compact_factor=0.9), [0, 0, 0], [1, 1, 1],
     [0, 0, 0, 0]),
    (dict(layer_dedup=None, compact_factor=0.01), [0, 0, 0], [0, 0, 0],
     [0, 0, 0, 0]),
])
def test_fast_paths_match_jax_padded(jax_run, knobs, dedup, blocks, takes):
    ours = _port_run(jax_run["params0"], **knobs)
    np.testing.assert_allclose(ours["losses"], jax_run["losses"], rtol=1e-5,
                               atol=1e-6)
    assert ours["dedup"] == dedup and ours["blocks"] == blocks
    assert ours["trainer"].tier_take_stats(ours["state"])["counts"] == takes


def test_padded_path_compacts_its_sampling(jax_run):
    """With the block compaction off, ``compact_factor`` still compacts
    the padded path's sampling; the steps are the JAX padded ones."""
    ours = _port_run(jax_run["params0"], compact_factor=0.9,
                     model_compact=False, layer_dedup=None)
    np.testing.assert_allclose(ours["losses"], jax_run["losses"], rtol=1e-5,
                               atol=1e-6)
    assert ours["blocks"] == [0] * STEPS


# ---- (g): calibration -------------------------------------------------------

@pytest.mark.parametrize("window, compact, ladder", [
    (20.0, True, False),     # the compaction (0.29) drops the ladder
    (200.0, False, True),    # occupancy 0.63: no compaction, a ladder
])
def test_calibration_matches_jax(window, compact, ladder):
    """The first-step calibration of both trainers (recent sampling) on
    the same batch: compaction factor, ladder and deep cap."""
    train, _, _, full, _, _ = _hop_stream()
    win = {**DYSAT_WIN, "snapshot_time_window": window}
    jtrainer = JTrainer(JDGNN(**DYSAT_CFG), fanouts=list(DYSAT_FANOUTS),
                        sample_strategy="recent", **win)
    trainer = Trainer(DGNN(**DYSAT_CFG, device="cpu"),
                      fanouts=list(DYSAT_FANOUTS), device="cpu", **win)
    assert trainer.compact_factor == jtrainer.compact_factor == 0.25
    assert trainer.model_compact and jtrainer.model_compact
    assert not trainer._calibrated and not jtrainer._calibrated
    b = list(data.get_batches(train, B,
                              data.DstRandEdgeSampler(train.dst, 1)))[6]
    jtrainer._maybe_auto_calibrate(_jax_graph(full).device_graph(),
                                   b.target_nodes, b.ts)
    trainer._maybe_auto_calibrate(_port_graph(full).device_graph("cpu"),
                                  b.target_nodes, b.ts)
    got = trainer.calibration
    assert trainer._calibrated and jtrainer._calibrated
    assert (trainer.compact_factor, trainer.layer_dedup,
            trainer.layer_dedup_deep) == (jtrainer.compact_factor,
                                          jtrainer.layer_dedup,
                                          jtrainer.layer_dedup_deep)
    assert (trainer.compact_factor is not None) == compact
    assert (trainer.layer_dedup is not None) == ladder
    assert got["compact_factor"] == trainer.compact_factor


@pytest.mark.parametrize("occ, want", [(0.1, 0.16), (0.45, 0.65),
                                       (0.59, 0.85), (0.6, None)])
def test_compact_factor_arithmetic(occ, want):
    """1.4x the worst occupancy + 0.02, at most 0.9; off from 0.6."""
    assert compact_factor_for(occ) == want


@pytest.mark.parametrize("fracs, layers, cf, dropped", [
    ([(0.30, 0.0), (0.40, 0.0)], 2, 0.3, True),
    ([(0.30, 0.0), (0.40, 0.0)], 2, 0.4, False),
    ([(0.30, 0.5), (0.40, 0.5)], 3, 0.35, True),
    ([(0.30, 0.5), (0.40, 0.5)], 3, 0.36, False),
])
def test_tier_ladder_against_block_compaction(fracs, layers, cf, dropped):
    """A ladder whose lowest tier (here 0.32) is at least 0.9 of the
    block compaction's factor is dropped; the deep cap stays, as JAX's
    calibrate leaves it (``train.py:681-695``)."""
    ladder, deep = tier_ladder(fracs, layers)
    assert ladder is not None and min(ladder) == 0.32
    assert tier_ladder(fracs, layers, cf) == ((None, deep) if dropped
                                              else (ladder, deep))
    assert (deep is None) == (layers == 2)


# ---- (h): the entry script, the factory and the weights -------------------

def test_entry_trains_dysat_on_cpu(tmp_path, caplog):
    path = str(tmp_path / "DySAT_torch.ckpt")
    with caplog.at_level(logging.INFO):
        out = entry.main(["--model", "DySAT", "--data", "SYNTHETIC",
                          "--epoch", "1", "--synthetic-edges", "3000",
                          "--synthetic-dim-edge", "16",
                          "--snapshot-time-window", "60",
                          "--device", "cpu"], checkpoint_path=path)
    assert len(out["val_ap"]) == 1
    for v in out["val_ap"] + out["val_auc"] + [out["test_ap"],
                                               out["test_auc"]]:
        assert 0.0 < v <= 1.0
    msgs = [r.getMessage() for r in caplog.records]
    cal = [m for m in msgs if m.startswith("calibration:")]
    assert len(cal) == 1 and "'compact_factor'" in cal[0]
    assert not any("auto-calibration" in m for m in msgs)
    assert any(m.startswith("Test ap:") for m in msgs)
    params = load_checkpoint(path)["params"]
    assert "combiner.hh.kernel" in params and "layers.l1h2.w_q.kernel" in \
        params and "layers.l0h0.w_q.kernel" not in params


def test_build_model_dysat():
    cfg, _ = config.get_default_config("dysat", "reddit")
    model, kw = build_model("DySAT", {**cfg, "compute_dtype": "bfloat16"}, 0,
                            172, seed=1, device="cpu")
    assert kw == {"fanouts": [10, 10], "sample_strategy": "uniform",
                  "num_snapshots": 3, "snapshot_time_window": 10000,
                  "prop_time": True, "is_static": False,
                  "neg_sample_ratio": 1}
    assert sorted(model.layers) == [f"l{l}h{h}" for l in range(2)
                                    for h in range(3)]
    for h in range(3):
        l0, l1 = model.layers[f"l0h{h}"], model.layers[f"l1h{h}"]
        assert not hasattr(l0, "w_q") and not hasattr(l0, "time_enc")
        assert l0.w_kv.kernel.shape == (172, 200)
        assert l0.w_out.kernel.shape == (100, 100)
        assert l1.w_q.kernel.shape == (100, 100)
        assert l1.w_kv.kernel.shape == (100 + 172, 200)
        assert l1.w_out.kernel.shape == (200, 100)
    assert model.combiner.ih.kernel.shape == (100, 100)
    trainer = Trainer(model, device="cpu", **kw)
    assert trainer.model_compact and trainer.compact_factor == 0.25
    assert trainer._layer_dedup_ok() and not trainer._calibrated
    with pytest.raises(ValueError, match="snapshots"):
        DGNN(**{**DYSAT_CFG, "use_memory": True, "dim_memory": 8},
             device="cpu")


def test_weights_round_trip_dysat(jax_run):
    want = _flat(jax_run["params0"])
    assert ("l0h1", "w_q", "kernel") not in want
    assert ("l1h1", "w_q", "kernel") in want
    assert not any("TimeEncode_0" in k for k in want)
    model = DGNN(**DYSAT_CFG, device="cpu")
    load_flax_params(model, jax_run["params0"])
    got = _flat(flax_param_tree(model))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == np.float32 and np.array_equal(got[name], w)
