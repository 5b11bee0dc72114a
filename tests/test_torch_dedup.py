"""The exact (nid, ts) memory dedup: the port against the JAX package.

- ``dedup_instances`` equals the JAX function element for element
  (``uniq_nid``, ``uniq_ts`` by bits, ``inv``, ``n_uniq``,
  ``rank_sorted``), against both of its branches, with invalid rows, all
  rows invalid and more unique pairs than the cap; ``sidx`` is a
  permutation with ``inv[sidx] == rank_sorted`` (``lax.sort`` need not
  order ties as a stable sort does).
- K4's plain version against the Pallas kernel in interpret mode (D = 128)
  and ``np.add.at`` (D = 100), and ``expand_compact``'s gradient against
  ``jax.grad``: 1e-5, as ``tests/test_dedup.py`` (f32 sums in other
  orders).
- Train steps with the dedup against the JAX ``Trainer(dedup_factor=0.5)``
  at ``tests/test_torch_train.py``'s tolerances, against the port's own
  per-instance path at ``tests/test_dedup.py:137-140``'s (only the sum
  order of the expansion's transpose and of K2 over fewer rows differs),
  and the overflow fallback exactly equal to the per-instance path.
- ``calibrate`` picks JAX's unique fraction and factor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.ops.dedup import dedup_instances as jdedup
from gnnflow_tpu.ops.segment_pallas import expand_compact as jexpand
from gnnflow_tpu.ops.segment_pallas import sorted_segment_sum as jseg_sum
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu.train import _valid_mask as jvalid_mask
from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.memory import DedupMemoryInput
from gnnflow_tpu_torch.models.weights import (flax_param_tree,
                                              load_flax_params)
from gnnflow_tpu_torch.ops.dedup import dedup_instances
from gnnflow_tpu_torch.ops.segment_sum import (expand_compact,
                                               sorted_segment_sum,
                                               sorted_segment_sum_ref)
from gnnflow_tpu_torch.train import Trainer, link_pred_loss
from tests.test_torch_kernels import one_cpu_thread  # noqa: F401
from tests.test_torch_slice import B, _stream, interpret_attention  # noqa: F401
from tests.test_torch_train import CFG, _assert_memory_equal, _batches, _flat


def _pairs(case, L=1500, seed=0):
    """(nid, ts, valid) for a dedup case; ts from a few values, -0.0 and
    0.0 among them, nid -1 on some valid rows (padded roots)."""
    rng = np.random.RandomState(seed)
    nid = rng.randint(-1, 40, L).astype(np.int32)
    ts = np.array([0.0, -0.0, 1.5, 2.0, 7.0, 1e6],
                  np.float32)[rng.randint(0, 6, L)]
    valid = rng.rand(L) > 0.3
    if case == "all_invalid":
        valid[:] = False
    return nid, ts, valid


CASES = [("random", 512, False), ("random", 512, True),
         ("all_invalid", 256, False), ("all_invalid", 256, True),
         ("overflow", 64, False)]


@pytest.mark.parametrize("case,cap,use_pallas", CASES)
def test_dedup_instances_equals_jax(case, cap, use_pallas):
    nid, ts, valid = _pairs(case)
    want = [np.asarray(x) for x in jdedup(
        jnp.asarray(nid), jnp.asarray(ts), jnp.asarray(valid), cap,
        use_pallas=use_pallas)]
    got = [x.numpy() for x in dedup_instances(
        torch.from_numpy(nid), torch.from_numpy(ts), torch.from_numpy(valid),
        cap)]
    names = ("uniq_nid", "uniq_ts", "inv", "n_uniq", "sidx", "rank_sorted")
    g, w = dict(zip(names, got)), dict(zip(names, want))
    g["uniq_ts"], w["uniq_ts"] = (x.view(np.int32) for x in (g["uniq_ts"],
                                                           w["uniq_ts"]))
    for name in ("uniq_nid", "uniq_ts", "inv", "n_uniq", "rank_sorted"):
        assert np.array_equal(g[name], w[name]), name
    L = len(nid)
    assert np.array_equal(np.sort(g["sidx"]), np.arange(L))
    assert np.array_equal(g["inv"][g["sidx"]], g["rank_sorted"])
    n = int(g["n_uniq"])
    if case == "all_invalid":
        assert n == 0 and not g["rank_sorted"].any()
    elif case == "overflow":
        assert n > cap
    else:
        assert 0 < n <= cap


@pytest.mark.parametrize("L,cap,D,tail", [
    pytest.param(700, 300, 128, 0, id="700-300-128"),
    pytest.param(1000, 64, 128, 0, id="1000-64-128"),
    # the dedup's shape: the last rows on one rank (its invalid
    # instances), across the Pallas kernel's 2048-row windows, then ranks
    # that no row carries
    pytest.param(3000, 900, 128, 2000, id="3000-900-128-tail2000")])
def test_segment_sum_ref_matches_pallas(L, cap, D, tail):
    rng = np.random.RandomState(0)
    steps = rng.rand(L) < (cap / L * 0.9)
    seg = np.minimum(np.cumsum(steps), cap - 1).astype(np.int32)
    if tail:
        seg[L - tail:] = seg[L - tail - 1]
        assert seg[-1] < cap - 100         # empty ranks at the end
    dhs = rng.randn(L, D).astype(np.float32)
    want = np.asarray(jseg_sum(jnp.asarray(dhs), jnp.asarray(seg), cap,
                               True))
    got = sorted_segment_sum_ref(torch.from_numpy(dhs),
                                 torch.from_numpy(seg), cap)
    short = np.arange(cap) != seg[-1] if tail else slice(None)
    np.testing.assert_allclose(got.numpy()[short], want[short], rtol=1e-5,
                               atol=1e-5)
    if tail:
        # the 2000-term sum: f32 sums in two orders part by more than
        # 1e-5 where they cancel, so each is held to the exact (f64) sum
        # within 1e-5 of its terms' magnitudes
        terms = dhs[seg == seg[-1]].astype(np.float64)
        exact, mag = terms.sum(0), np.abs(terms).sum(0)
        for x in (got.numpy(), want):
            assert (np.abs(x[seg[-1]] - exact) <= 1e-5 * mag).all()
        assert not got[seg[-1] + 1:].any() and not want[seg[-1] + 1:].any()
    # on the CPU the wrapper is the plain version
    assert torch.equal(sorted_segment_sum(torch.from_numpy(dhs),
                                          torch.from_numpy(seg), cap), got)


def test_segment_sum_ref_matches_numpy_at_width_100():
    """The port's width (no lane pad), with empty ranks in the middle and
    at the end."""
    rng = np.random.RandomState(1)
    L, cap, D = 900, 400, 100
    seg = np.sort(rng.randint(0, cap - 20, L)).astype(np.int32)
    dhs = rng.randn(L, D).astype(np.float32)
    want = np.zeros((cap, D), np.float32)
    np.add.at(want, seg, dhs)
    got = sorted_segment_sum_ref(torch.from_numpy(dhs),
                                 torch.from_numpy(seg), cap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not got[cap - 20:].any()


def test_expand_compact_grad_matches_jax():
    """Gradient of ``<expand_compact(up), dh>`` against ``jax.grad`` of the
    JAX op (its VJP runs the Pallas kernel in interpret mode), with inputs
    from a real dedup."""
    nid, ts, valid = _pairs("random", L=600, seed=2)
    cap, D = 256, 128
    _, _, inv, _, sidx, rank_sorted = dedup_instances(
        torch.from_numpy(nid), torch.from_numpy(ts), torch.from_numpy(valid),
        cap)
    rng = np.random.RandomState(3)
    up = rng.randn(cap, D).astype(np.float32)
    dh = rng.randn(len(nid), D).astype(np.float32)
    g_want = jax.grad(lambda u: jnp.vdot(jexpand(
        u, jnp.asarray(inv.numpy(), jnp.int32),
        jnp.asarray(sidx.numpy(), jnp.int32),
        jnp.asarray(rank_sorted.numpy())), jnp.asarray(dh)))(jnp.asarray(up))
    tup = torch.from_numpy(up).requires_grad_()
    out = expand_compact(tup, inv, sidx, rank_sorted)
    assert torch.equal(out.detach(), torch.from_numpy(up)[inv])
    out.backward(torch.from_numpy(dh))
    np.testing.assert_allclose(tup.grad.numpy(), np.asarray(g_want),
                               rtol=1e-5, atol=1e-5)


def _jax_dedup_side(full, ef):
    g = JGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = JDGNN(**CFG, gru_impl="pallas", attention_impl="pallas")
    trainer = JTrainer(model, fanouts=[4], sample_strategy="recent",
                       dedup_factor=0.5, gru_table=False)
    dg = g.device_graph()
    state = trainer.init_state(jax.random.PRNGKey(0), dg, B, None,
                               jnp.asarray(ef),
                               num_nodes=g.max_vertex_id() + 1)
    return trainer, state, dg


def _port_trainer(full, params, dedup_factor, cfg=CFG, fanout=4, lr=1e-4):
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = DGNN(**cfg, device="cpu")
    if params is not None:
        load_flax_params(model, params)
    trainer = Trainer(model, fanouts=[fanout], lr=lr,
                      dedup_factor=dedup_factor, device="cpu")
    return trainer, trainer.init_state(g.max_vertex_id() + 1), \
        g.device_graph("cpu")


def test_dedup_first_step_gradients_match_jax(interpret_attention):
    """Gradients of one dedup forward/backward against the JAX trainer's
    ``_model_outputs(train=True)`` (its fast branch), after two eval
    batches have filled the memory."""
    _, _, _, full, _, ef = _stream()
    jtrainer, jstate, jdg = _jax_dedup_side(full, ef)
    jef = jnp.asarray(ef)
    trainer, state, dg = _port_trainer(
        full, jax.tree.map(np.asarray, jstate.params), 0.5)
    tef = torch.from_numpy(ef)
    ours, ref = _batches(full)
    for _, b, jb in zip(range(2), ours, ref):
        jstate, *_ = jtrainer.eval_step(jstate, jdg, None, jef, jb)
        trainer.eval_step(state, dg, tef, b)
    b, jb = next(ours), next(ref)
    jmfgs = jtrainer._sample(jdg, jnp.asarray(jb.target_nodes, jnp.int32),
                             jnp.asarray(jb.ts, jnp.float32),
                             jax.random.PRNGKey(1))
    run = jax.jit(jtrainer._model_outputs, static_argnums=(4,))
    jloss, *_, jgrads = run(jstate, jmfgs, jax.random.PRNGKey(2),
                            jvalid_mask(jb), True, None, jef)

    mfgs, efs, mem_input, _, valid = trainer._inputs(state, dg, tef, b)
    assert isinstance(mem_input, DedupMemoryInput)
    assert state.dedup_n_uniq <= trainer._dedup_cap(mfgs[0][0].num_all)
    pos, neg, _ = trainer.model(mfgs, efs, mem_input, train=True)
    loss = link_pred_loss(pos, neg, valid)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = DGNN(**CFG, device="cpu")        # a carrier for the gradients
    with torch.no_grad():
        for g, p in zip(grads.parameters(), trainer.model.parameters()):
            g.copy_(p.grad)
    got, want = _flat(flax_param_tree(grads)), _flat(jgrads)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert np.abs(w).max() > 0, name
        err = np.abs(got[name] - w).max() / np.abs(w).max()
        assert err <= 1e-5, (name, err)


def test_dedup_train_matches_jax(interpret_attention):
    """Four train steps with the dedup (the last batch padded): losses,
    logits, parameters by Flax name, memory and mailbox after each."""
    _, _, _, full, _, ef = _stream()
    jtrainer, jstate, jdg = _jax_dedup_side(full, ef)
    jef = jnp.asarray(ef)
    trainer, state, dg = _port_trainer(
        full, jax.tree.map(np.asarray, jstate.params), 0.5)
    tef = torch.from_numpy(ef)
    n = 0
    for b, jb in zip(*_batches(full)):
        n += 1
        jstate, jloss, jpos, jneg = jtrainer.train_step(jstate, jdg, None,
                                                        jef, jb)
        state, loss, pos, neg = trainer.train_step(state, dg, tef, b)
        assert state.dedup_n_uniq <= trainer._dedup_cap(3 * B * 5)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(pos.numpy(), np.asarray(jpos),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(neg.numpy(), np.asarray(jneg),
                                   rtol=1e-4, atol=1e-4)
        got = _flat(flax_param_tree(trainer.model))
        want = _flat(jax.tree.map(np.asarray, jstate.params))
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-6,
                                       err_msg=str(name))
        _assert_memory_equal(state.memory, jstate.memory)
    assert n == 4 and b.num_valid == 38


def _run_port(dedup_factor, steps=8, eval_steps=0):
    """``tests/test_dedup.py``'s stream and model on the port: ``steps``
    train steps of 400, then ``eval_steps`` eval batches of 400.  Returns
    losses, logits, the unique counts and the final memory."""
    train, _, _, full, _, ef = data.make_synthetic_dataset(
        num_src=150, num_dst=40, num_edges=4000, dim_edge=12, seed=7)
    cfg = dict(dim_node=0, dim_edge=12, dim_time=16, dim_embed=32,
               num_layers=1, num_snapshots=1, att_head=2, dropout=0.0,
               att_dropout=0.0, use_memory=True, dim_memory=32)
    trainer, state, dg = _port_trainer(full, None, dedup_factor, cfg,
                                       fanout=10, lr=1e-3)
    tef = torch.from_numpy(ef)
    out = dict(loss=[], logits=[], n_uniq=[])
    neg = data.DstRandEdgeSampler(train.dst, seed=1)
    for i, b in enumerate(data.get_batches(train, 400, neg)):
        if i >= steps + eval_steps:
            break
        step = trainer.train_step if i < steps else trainer.eval_step
        state, loss, pos, ng = step(state, dg, tef, b)
        out["loss"].append(float(loss))
        out["logits"].append(torch.cat([pos, ng]))
        out["n_uniq"].append(state.dedup_n_uniq)
    out["cap"] = trainer._dedup_cap(1200 * 11) if dedup_factor else None
    out["memory"] = state.memory
    return out


def _memory_close(a, b, rtol, atol):
    for name in ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_dedup_matches_per_instance_path():
    """Train steps, then eval batches, with and without the dedup."""
    plain = _run_port(None, eval_steps=3)
    dedup = _run_port(0.5, eval_steps=3)
    assert all(n is None for n in plain["n_uniq"])
    assert all(0 < n <= dedup["cap"] for n in dedup["n_uniq"])
    np.testing.assert_allclose(dedup["loss"], plain["loss"], rtol=2e-5,
                               atol=2e-6)
    for a, b in zip(dedup["logits"], plain["logits"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-6)
    _memory_close(dedup["memory"], plain["memory"], rtol=2e-4, atol=2e-5)


def test_dedup_overflow_equals_per_instance_path():
    """A cap below the unique count (256 rows) takes the per-instance path
    every step: the same values, bit for bit."""
    plain = _run_port(None, steps=4)
    tiny = _run_port(0.001, steps=4)
    assert tiny["cap"] == 256 and all(n > 256 for n in tiny["n_uniq"])
    assert tiny["loss"] == plain["loss"]
    for name in ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts"):
        assert torch.equal(getattr(tiny["memory"], name),
                           getattr(plain["memory"], name)), name


def _calibration_pair(full, ef, batch_size, fanout, monkeypatch):
    """The port's and the JAX trainer's first-batch auto-calibration on
    the same batch: ``(port stats, port factor, JAX stats, JAX factor)``."""
    jg = JGraph(initial_pool_size=1024, minimum_block_size=4)
    jg.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    jtrainer = JTrainer(JDGNN(**CFG), fanouts=[fanout],
                        sample_strategy="recent")
    seen = {}
    orig = jtrainer.calibrate

    def spy(*a, **k):
        seen.update(orig(*a, **k))
        return seen

    monkeypatch.setattr(jtrainer, "calibrate", spy)
    trainer, _, dg = _port_trainer(full, None, "auto", fanout=fanout)
    assert not trainer._calibrated and not jtrainer._calibrated
    b = list(data.get_batches(full, batch_size,
                              data.DstRandEdgeSampler(full.dst, 1)))[-2]
    jtrainer._maybe_auto_calibrate(jg.device_graph(), b.target_nodes, b.ts)
    trainer._maybe_auto_calibrate(dg, b.target_nodes, b.ts)
    assert trainer._calibrated and jtrainer._calibrated
    return trainer.calibration, trainer.dedup_factor, seen, \
        jtrainer.dedup_factor


def test_calibrate_keeps_dedup_off_on_synthetic_stream(monkeypatch):
    _, _, _, full, _, ef = _stream()
    stats, factor, jstats, jfactor = _calibration_pair(full, ef, B, 4,
                                                       monkeypatch)
    assert stats["uniq_frac"] == jstats["uniq_frac"] > 0.08
    assert factor is None and jfactor is None


def test_calibrate_picks_jax_factor_on_repeated_timestamps(monkeypatch):
    """Edges that share five timestamps among 40 nodes: few unique
    (nid, ts) pairs, so the dedup turns on at JAX's factor."""
    rng = np.random.RandomState(0)
    n = 3000
    src = rng.randint(0, 30, n).astype(np.int64)
    dst = rng.randint(30, 40, n).astype(np.int64)
    time = np.repeat(np.arange(1, 6, dtype=np.float32), n // 5)
    full = data.EdgeTable(src, dst, time, np.arange(n, dtype=np.int64))
    ef = rng.randn(n, CFG["dim_edge"]).astype(np.float32)
    stats, factor, jstats, jfactor = _calibration_pair(full, ef, 200, 10,
                                                       monkeypatch)
    assert stats["uniq_frac"] == jstats["uniq_frac"] <= 0.08
    assert factor == jfactor == stats["dedup_factor"] > 0


def test_eval_step_never_calibrates():
    _, _, _, full, _, ef = _stream()
    trainer, state, dg = _port_trainer(full, None, "auto")
    b = next(_batches(full)[0])
    trainer.eval_step(state, dg, torch.from_numpy(ef), b)
    assert not trainer._calibrated
    trainer.train_step(state, dg, torch.from_numpy(ef), b)
    assert trainer._calibrated and trainer.calibration is not None
