"""TGAT: the port against the JAX package, f32, on the tiny stream of
tests/test_layer_dedup.py (120 src, 30 dst, 5000 edges; edge, time and
embedding dims 12/16/32; fanouts [5, 5]; batch 240).

The JAX side builds only the padded TGAT program (``layer_dedup=None``,
``attention_impl="xla"``) and the calibration's probe sampler, never the
layer dedup's tier ladder, whose compile makes tests/test_layer_dedup.py
the suite's long pole.

Tolerances:
- uniform sampling from the same draws, and recent sampling: MFGs
  bit-identical.
- the uniform picks' chi-square over 7 candidates, 70,000 seeded draws:
  below 22.46, the 0.999 quantile at 6 degrees of freedom.
- attention layer and DGNN outputs 1e-5 absolute (f32 sums in other
  orders); first-step gradients, per parameter, max abs error over max
  abs value 1e-5 (as tests/test_torch_train.py).
- train steps: losses rtol 1e-5 (as tests/test_layer_dedup.py: the layer
  dedup is exact on recent sampling); parameters after each Adam step
  (lr 1e-4) 1e-5 absolute, a tenth of one step.  Adam scales each
  element's step by that element's own gradient, so where a gradient
  element is small next to its parameter's largest (and the two sides'
  sum orders part by more, relatively) the step differs by a larger
  share of lr: 1.0e-6 measured on one of 1792 elements of
  ``l0h0/w_kv/kernel`` (all others within 1e-6).
- tier ladders and weight trees: equal.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.models.modules import \
    TemporalAttentionLayer as JAttentionLayer
from gnnflow_tpu.ops import sampling as jsampling
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
from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
from gnnflow_tpu_torch.train import (Trainer, fetch_features,
                                     link_pred_loss, tier_ladder)
from gnnflow_tpu_torch.utils.checkpoint import load_checkpoint
from torch_fixtures import graphs, one_cpu_thread  # noqa: F401
from torch_fixtures import _assert_mfgs_identical, _flat, _roots
from torch_parity import _hop_stream, _jax_graph, _port_graph, jax_state

CFG = dict(dim_node=0, dim_edge=12, dim_time=16, dim_embed=32, num_layers=2,
           num_snapshots=1, att_head=2, dropout=0.0, att_dropout=0.0,
           use_memory=False)
FANOUTS = (5, 5)
B = 240
STEPS = 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX padded TGAT trainer's initial parameters and its losses
    and parameters after each of STEPS train steps (recent sampling,
    chronological batches)."""
    train, _, _, full, _, ef = _hop_stream()
    jg = _jax_graph(full)
    jdg = jg.device_graph()
    model = JDGNN(**CFG)
    trainer = JTrainer(model, fanouts=list(FANOUTS),
                       sample_strategy="recent", lr=1e-4, layer_dedup=None)
    jef = jnp.asarray(ef)
    state = jax_state(trainer, DGNN(**CFG, device="cpu"),
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


def _port_run(params0, layer_dedup, fanouts=FANOUTS, steps=STEPS,
              cfg=CFG):
    """The port's trainer from ``params0`` (None: its own weights) over
    ``steps`` train steps of the batches ``jax_run`` takes: losses,
    parameter trees, and per step the boundaries that took a tier."""
    train, _, _, full, _, ef = _hop_stream()
    model = DGNN(**{**cfg, "num_layers": len(fanouts)}, device="cpu")
    if params0 is not None:
        load_flax_params(model, params0)
    trainer = Trainer(model, fanouts=list(fanouts), sample_strategy="recent",
                      lr=1e-4, layer_dedup=layer_dedup, device="cpu")
    g = _port_graph(full)
    dg = g.device_graph("cpu")
    state = trainer.init_state(g.max_vertex_id() + 1)
    tef = torch.from_numpy(ef)
    out = dict(trainer=trainer, state=state, losses=[], params=[],
               compact=[])
    batches = data.get_batches(train, B,
                               data.DstRandEdgeSampler(train.dst, seed=1))
    for _, b in zip(range(steps), batches):
        state, loss, _, _ = trainer.train_step(state, dg, tef, b)
        out["losses"].append(float(loss))
        out["params"].append(flax_param_tree(model))
        out["compact"].append(state.layer_dedup_compact)
    return out


# ---- (a), (b): uniform sampling -------------------------------------------

@pytest.mark.parametrize("fanout", [1, 4, 10])
def test_uniform_sample_layer_bit_identical(graphs, fanout):  # noqa: F811
    ours, ref, hub_edge_ts = graphs
    roots, ts = _roots(hub_edge_ts)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    key = jax.random.PRNGKey(fanout)
    u = jax.random.uniform(key, (len(roots), fanout), dtype=jnp.float32)
    got = sampling.sample_layer(dg, torch.from_numpy(roots),
                                torch.from_numpy(ts), fanout=fanout,
                                strategy="uniform",
                                u=torch.from_numpy(np.array(u)))
    want = jsampling.sample_layer(jdg, jnp.asarray(roots, jnp.int32),
                                  jnp.asarray(ts), fanout=fanout,
                                  strategy="uniform", key=key,
                                  search_iters=jdg.search_iters)
    _assert_mfgs_identical(got, want)
    assert not got.nbr_mask[:3].any()    # padded and history-less roots
    assert got.nbr_mask[3:6].all()


@pytest.mark.parametrize("strategy", ["uniform", "recent"])
def test_sample_hops_two_layers_bit_identical(graphs, strategy):  # noqa: F811
    ours, ref, hub_edge_ts = graphs
    roots, ts = _roots(hub_edge_ts)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    key = jax.random.PRNGKey(7)

    def draw(layer, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, layer), shape, dtype=jnp.float32)))

    got = sampling.sample_hops(dg, torch.from_numpy(roots),
                               torch.from_numpy(ts), fanouts=[4, 3],
                               strategy=strategy, draw=draw)
    want = jsampling.sample_hops(jdg, jnp.asarray(roots, jnp.int32),
                                 jnp.asarray(ts), fanouts=[4, 3],
                                 strategy=strategy, key=key,
                                 search_iters=jdg.search_iters)
    assert len(got) == len(want) == 2
    assert got[0][0].num_dst == 400 * 5 and got[1][0].num_dst == 400
    for a, b in zip(got, want):
        _assert_mfgs_identical(a[0], b[0])


def test_uniform_picks_are_uniform():
    """One root with 7 earlier edges, 7,000 copies of it, 10 slots each
    from seeded torch draws: each edge is picked 10,000 times in
    expectation; the chi-square statistic stays below the 0.999 quantile
    at 6 degrees of freedom (22.46).  A root with one candidate always
    picks it; with none, every slot is masked."""
    g = DynamicGraph(initial_pool_size=64, minimum_block_size=4)
    g.add_edges(np.array([0] * 7 + [1]), np.array([10 + i for i in range(8)]),
                np.arange(1, 9, dtype=np.float32), add_reverse=False)
    dg = g.device_graph("cpu")
    n, F = 7000, 10
    roots = torch.tensor([0] * n + [1, 2])
    ts = torch.full((n + 2,), 100.0)
    u = torch.rand(n + 2, F, generator=torch.Generator().manual_seed(0))
    m = sampling.sample_layer(dg, roots, ts, fanout=F, strategy="uniform",
                              u=u)
    picks = m.nbr_nids[:n].reshape(-1).numpy()
    counts = np.bincount(picks - 10, minlength=7)
    assert counts.shape == (7,) and counts.sum() == n * F
    expected = n * F / 7
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 22.46, (chi2, counts)
    assert m.nbr_mask[:n + 1].all() and (m.nbr_nids[n] == 17).all()
    assert not m.nbr_mask[n + 1].any()
    with pytest.raises(ValueError, match="draws|u of shape"):
        sampling.sample_layer(dg, roots, ts, fanout=F, strategy="uniform")


# ---- (c), (d): the attention layer and the model --------------------------

def test_attention_without_node_input_matches_flax():
    train, _, _, full, _, ef = _hop_stream()
    g = _port_graph(full)
    roots = np.concatenate([train.src[:300], train.dst[:300]])
    ts = np.tile(train.time[:300], 2).astype(np.float32)
    m = sampling.sample_layer(g.device_graph("cpu"), torch.from_numpy(roots),
                              torch.from_numpy(ts), fanout=5)
    jm = jsampling.sample_layer(_jax_graph(full).device_graph(),
                                jnp.asarray(roots, jnp.int32),
                                jnp.asarray(ts), fanout=5)
    _assert_mfgs_identical(m, jm)
    ef_t = fetch_features([[m]], torch.from_numpy(ef))[0][0]
    layer = JAttentionLayer(dim_node=0, dim_edge=12, dim_time=16, dim_out=32,
                            num_head=2)
    jef = jnp.asarray(ef_t.numpy())
    params = jax.jit(layer.init)(jax.random.PRNGKey(3), jm, None,
                                 jef)["params"]
    want = jax.jit(layer.apply)({"params": params}, jm, None, jef)
    ours = TemporalAttentionLayer(0, 12, 16, 32, 2, torch.Generator())
    flat = _flat(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        for name, p in ours.named_parameters():
            p.copy_(torch.from_numpy(flat.pop(_flax_path(name))))
    assert not flat                      # every Flax parameter carried
    for lin in (ours.w_q, ours.w_kv, ours.w_out):
        lin.cast_weights()
    with torch.no_grad():
        got = ours(m, None, ef_t)
    assert got.shape == (600, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_tgat_logits_and_gradients_match_jax(jax_run):
    """One training forward and backward at dropout 0 on the first batch:
    logits, loss and every parameter's gradient."""
    train, _, _, full, _, ef = _hop_stream()
    jtrainer, jdg, jef = jax_run["trainer"], jax_run["dg"], jax_run["ef"]
    b = next(iter(data.get_batches(
        train, B, data.DstRandEdgeSampler(train.dst, seed=1))))
    jmfgs = jtrainer._sample(jdg, jnp.asarray(b.target_nodes, jnp.int32),
                             jnp.asarray(b.ts, jnp.float32),
                             jax.random.PRNGKey(1))
    jnfs, jefs = jfetch_features(jmfgs, None, jef, None, CFG["dim_edge"])
    run = jax.jit(jtrainer._run_model, static_argnums=(5,))
    jloss, jpos, jneg, _, jgrads = run(jax_run["state0"], jmfgs, jefs,
                                       jax.random.PRNGKey(2), jvalid_mask(b),
                                       True, None, jnfs)

    model = DGNN(**CFG, device="cpu")
    load_flax_params(model, jax_run["params0"])
    trainer = Trainer(model, fanouts=list(FANOUTS), layer_dedup=None,
                      device="cpu")
    g = _port_graph(full)
    st = trainer.init_state(g.max_vertex_id() + 1)
    mfgs, efs, mem_input, _, valid, exps = trainer._inputs(
        st, g.device_graph("cpu"), torch.from_numpy(ef), b)
    assert mem_input is None and exps is None
    for layer, jlayer in zip(mfgs, jmfgs):
        _assert_mfgs_identical(layer[0], jlayer[0])
    pos, neg, last = model(mfgs, efs, None, train=True,
                           generator=st.dropout_gen)
    assert last is None
    np.testing.assert_allclose(pos.detach().numpy(), np.asarray(jpos),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(neg.detach().numpy(), np.asarray(jneg),
                               rtol=0, atol=1e-5)
    loss = link_pred_loss(pos, neg, valid)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = DGNN(**CFG, device="cpu")        # a carrier for the gradients
    with torch.no_grad():
        for gp, p in zip(grads.parameters(), model.parameters()):
            gp.copy_(p.grad)
    got, want = _flat(flax_param_tree(grads)), _flat(jgrads)
    assert got.keys() == want.keys()
    for name, w in want.items():
        scale = np.abs(w).max()
        err = np.abs(got[name] - w).max()
        assert err <= 1e-5 * max(scale, 1e-30), (name, err, scale)


def test_dgnn_refuses_block_expansions():
    """An expansion spec is ``("rows", ...)`` or ``("blocks", ...)``;
    any other kind is refused before a layer runs."""
    model = DGNN(**CFG, device="cpu")
    with pytest.raises(ValueError, match="expansion spec"):
        model([[None]] * 2, [[None]] * 2, expansions=[("bricks",), None])


# ---- (e), (f): training, padded and on the layer dedup --------------------

def test_padded_train_matches_jax(jax_run):
    ours = _port_run(jax_run["params0"], None)
    np.testing.assert_allclose(ours["losses"], jax_run["losses"], rtol=1e-5,
                               atol=1e-6)
    for got_tree, want_tree in zip(ours["params"], jax_run["params"]):
        got, want = _flat(got_tree), _flat(want_tree)
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5,
                                       err_msg=str(name))
    assert ours["compact"] == [0] * STEPS
    assert ours["trainer"].tier_take_stats(ours["state"])["total"] == 0


@pytest.mark.parametrize("ladder, compact, takes", [
    (0.5, [1, 1, 1], [3, 0, 0, 0]),             # one tier that fits
    ((0.3, 0.6), [1, 1, 1], None),              # a two-tier ladder
    (0.01, [0, 0, 0], [0, 3, 0, 0]),            # every step falls back
])
def test_layer_dedup_matches_jax_padded(jax_run, ladder, compact, takes):
    ours = _port_run(jax_run["params0"], ladder)
    np.testing.assert_allclose(ours["losses"], jax_run["losses"], rtol=1e-5,
                               atol=1e-6)
    assert ours["compact"] == compact
    stats = ours["trainer"].tier_take_stats(ours["state"])
    assert stats["total"] == STEPS
    if takes is not None:
        assert stats["counts"] == takes
    else:                                       # both tiers, no fallback
        assert stats["counts"][2:] == [0, 0] and stats["fallback_rate"] == 0


def test_three_layer_layer_dedup_matches_padded():
    """Two boundaries: the first on a ladder, the deeper one at its own
    cap; exact against the port's padded path."""
    padded = _port_run(None, None, fanouts=(4, 3, 3))
    dedup = _port_run(None, (0.3, 0.6), fanouts=(4, 3, 3))
    np.testing.assert_allclose(dedup["losses"], padded["losses"], rtol=1e-5,
                               atol=1e-6)
    assert dedup["compact"] == [2] * STEPS


# ---- (g), (h): calibration and the take feedback --------------------------

@pytest.mark.parametrize("fanouts", [(5, 5), (4, 3, 3)])
def test_tier_ladder_matches_jax_calibrate(fanouts):
    train, _, _, full, _, ef = _hop_stream()
    jtrainer = JTrainer(JDGNN(**{**CFG, "num_layers": len(fanouts)}),
                        fanouts=list(fanouts), sample_strategy="recent")
    model = DGNN(**{**CFG, "num_layers": len(fanouts)}, device="cpu")
    trainer = Trainer(model, fanouts=list(fanouts), device="cpu")
    assert not trainer._calibrated and not jtrainer._calibrated
    b = list(data.get_batches(train, B,
                              data.DstRandEdgeSampler(train.dst, 1)))[2]
    jtrainer._maybe_auto_calibrate(_jax_graph(full).device_graph(),
                                   b.target_nodes, b.ts)
    trainer._maybe_auto_calibrate(_port_graph(full).device_graph("cpu"),
                                  b.target_nodes, b.ts)
    assert trainer._calibrated and jtrainer._calibrated
    assert trainer.layer_dedup is not None
    assert trainer.layer_dedup == jtrainer.layer_dedup
    assert trainer.layer_dedup_deep == jtrainer.layer_dedup_deep
    assert (trainer.layer_dedup_deep is None) == (len(fanouts) == 2)


@pytest.mark.parametrize("fracs, layers, want", [
    ([(0.10, 0.0), (0.30, 0.0), (0.40, 0.0), (0.48, 0.0)], 2,
     ((0.32, 0.5, 0.63), None)),
    ([(0.10, 0.6), (0.30, 0.0), (0.40, 0.0), (0.48, 0.0)], 3,
     ((0.32, 0.78), 0.68)),
    ([(0.20, 0.0)], 2, (0.22, None)),
    ([(0.80, 0.0), (0.90, 0.0)], 2, (None, None)),
])
def test_tier_ladder_arithmetic(fracs, layers, want):
    """The ladder from fed fractions (``train.py:624-698``): quantile
    tiers +0.02, 0.08 apart and at most 0.7; a top tier 1.25x the worst
    +0.03 that only extends a ladder; two tiers at three layers; the deep
    cap 1.1x the deep worst +0.02; none above 0.7."""
    assert tier_ladder(fracs, layers) == want


def test_tier_take_stats_and_recalibration_on_forced_fallback():
    train, _, _, full, _, ef = _hop_stream()
    model = DGNN(**CFG, device="cpu")
    trainer = Trainer(model, fanouts=list(FANOUTS), device="cpu")
    g = _port_graph(full)
    dg, tef = g.device_graph("cpu"), torch.from_numpy(ef)
    state = trainer.init_state(g.max_vertex_id() + 1)
    batches = list(data.get_batches(
        train, B, data.DstRandEdgeSampler(train.dst, seed=1)))[:4]
    state, *_ = trainer.train_step(state, dg, tef, batches[0])
    ladder = trainer.layer_dedup              # calibrated on that step
    assert ladder is not None and sum(state.tier_takes) == 1
    trainer.layer_dedup = 0.01                # force the fallback
    state.tier_takes = [0] * 4
    for b in batches[1:]:
        state, *_ = trainer.train_step(state, dg, tef, b)
        assert state.layer_dedup_compact == 0
    trainer.eval_step(state, dg, tef, batches[0])   # eval counts no take
    stats = trainer.tier_take_stats(state)
    assert stats == {"counts": [0, 3, 0, 0], "total": 3, "tiers": (0.01,),
                     "fallback_rate": 1.0}
    roots = np.concatenate([train.src[-B:], train.dst[-B:], train.dst[-B:]])
    ts = np.tile(train.time[-B:], 3)
    # too few steps, or a rate at the threshold: nothing changes
    assert trainer.maybe_recalibrate(state, dg, roots, ts) is state
    assert trainer.layer_dedup == 0.01 and state.tier_takes[1] == 3
    trainer.maybe_recalibrate(state, dg, roots, ts, threshold=1.0,
                              min_steps=3)
    assert trainer.layer_dedup == 0.01
    state = trainer.maybe_recalibrate(state, dg, roots, ts, min_steps=3)
    assert trainer.layer_dedup not in (None, 0.01)
    assert trainer._calibrated and state.tier_takes == [0] * 4
    no_dedup = Trainer(DGNN(**{**CFG, "num_layers": 1}, device="cpu"),
                       fanouts=[5], device="cpu")
    assert no_dedup.tier_take_stats(no_dedup.init_state(150)) is None


# ---- (i), (j): the entry script, the factory and the weights --------------

def test_entry_trains_tgat_on_cpu(tmp_path, caplog):
    path = str(tmp_path / "TGAT_torch.ckpt")
    with caplog.at_level(logging.INFO):
        out = entry.main(["--model", "TGAT", "--data", "SYNTHETIC",
                          "--epoch", "1", "--synthetic-edges", "3000",
                          "--synthetic-dim-edge", "16", "--device", "cpu"],
                         checkpoint_path=path)
    assert len(out["val_ap"]) == 1
    for v in out["val_ap"] + out["val_auc"] + [out["test_ap"],
                                               out["test_auc"]]:
        assert 0.0 < v <= 1.0
    msgs = [r.getMessage() for r in caplog.records]
    assert any("auto-calibration" in m for m in msgs)
    assert any("layer-dedup takes" in m for m in msgs)
    assert any(m.startswith("Test ap:") for m in msgs)
    ckpt = load_checkpoint(path)
    assert ckpt["memory"] == {} and "layers.l1h0.w_out.kernel" in \
        ckpt["params"]


def test_build_model_tgat():
    cfg, _ = config.get_default_config("tgat", "reddit")
    model, kw = build_model("TGAT", {**cfg, "compute_dtype": "bfloat16"}, 0,
                            172, seed=1, device="cpu")
    assert kw == {"fanouts": [10, 10], "sample_strategy": "uniform",
                  "num_snapshots": 1, "snapshot_time_window": 0,
                  "prop_time": False, "is_static": False,
                  "neg_sample_ratio": 1}
    assert not model.use_memory and not hasattr(model, "updater")
    assert sorted(model.layers) == ["l0h0", "l1h0"]
    assert (model.dropout, model.att_dropout) == (0.1, 0.1)
    assert model.layers["l0h0"].w_kv.kernel.shape == (172 + 100, 200)
    assert model.layers["l1h0"].w_kv.kernel.shape == (100 + 172 + 100, 200)
    assert model.layers["l0h0"].w_out.kernel.shape == (100, 100)
    assert model.layers["l1h0"].w_out.kernel.shape == (200, 100)
    Trainer(model, device="cpu", **kw)


def test_weights_round_trip_l1h0(jax_run):
    want = _flat(jax_run["params0"])
    assert not any(k[0] == "updater" for k in want)
    assert ("l1h0", "w_out", "kernel") in want
    model = DGNN(**CFG, device="cpu")
    load_flax_params(model, jax_run["params0"])
    assert model.layers["l1h0"].w_out.kernel.shape == (64, 32)
    assert torch.equal(model.layers["l1h0"].w_out.kernel,
                       torch.from_numpy(want[("l1h0", "w_out", "kernel")]))
    got = _flat(flax_param_tree(model))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == np.float32 and np.array_equal(got[name], w)
