"""The opt-in variants of the port against the JAX package, on the CPU.

- ``get_batches`` at three negatives per edge, padded and not: bit-equal.
- TGN at ``neg_sample_ratio=3``: 3 train steps against JAX's
  ``Trainer.train_step`` (f32, dropout 0; losses 1e-4, parameters 1e-6
  absolute, memory 1e-4 and its timestamps exact, as
  ``tests/test_torch_train.py``), and the same steps on the memory dedup
  held to those JAX losses (the dedup is exact; no JAX dedup program is
  compiled).
- Memory over two layers: logits and gradients against JAX's
  ``_run_model`` (1e-5 of each gradient's largest value; the updater's
  time encoding 1e-4, see there), then 2 train
  steps against JAX's model, optax update and ``update_mem_mail`` on the
  roots' rows (JAX's own step fails on the two-layer write-back's shapes;
  see ``Trainer._root_rows``).
- ``gru_node_gather`` against the JAX custom VJP, forward and weight
  gradients, in f32 (1e-5) and bf16 (gathered rows bit-equal; gradients
  2e-2 of their largest: both sum bf16 products in f32, in other orders);
  ``Trainer(gru_table=True)`` steps against JAX's, and its three
  refusals.
- The factorized attention layer against Flax's (forward 1e-5, gradients
  1e-5 of their largest), with rows that have no valid neighbour.
- Remat steps bit-equal to the steps without remat at dropout 0.2 and
  attention dropout 0.2; ``train_steps_scan`` bit-equal to the per-step
  loop.
- The GRU and transformer updaters without time encoding against Flax
  (1e-5), the ``MLP``, an old split ``w_k``/``w_v`` tree, the REPLACE,
  fixed-block, preallocated and constructor-ingested stores (bit-equal:
  pools, offsets, capacities, recent samples) and ``auto_calibrate``.

JAX states are built from the port's weights (``flax_param_tree``), so
no JAX ``init_state`` compiles.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.models import memory as jmemory
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.models.modules import MLP as JMLP
from gnnflow_tpu.models.modules import \
    TemporalAttentionLayer as JAttention
from gnnflow_tpu.ops import sampling as jsampling
from gnnflow_tpu.ops.gru_gather import gru_node_gather as jgru_gather
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu.train import _valid_mask as jvalid_mask
from gnnflow_tpu.train import fetch_features as jfetch_features
from gnnflow_tpu.utils.checkpoint import migrate_params
from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import (DynamicGraph,
                                             build_dynamic_graph)
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.modules import MLP, TemporalAttentionLayer
from gnnflow_tpu_torch.models.weights import (flax_param_tree,
                                              load_flax_params)
from gnnflow_tpu_torch.ops import sampling
from gnnflow_tpu_torch.ops.gru_gather import (gru_node_gather,
                                              gru_node_gather_ref)
from gnnflow_tpu_torch.train import Trainer, link_pred_loss
from torch_fixtures import one_cpu_thread  # noqa: F401
from torch_fixtures import B, CFG, _assert_mfgs_identical, _flat, _stream
from torch_parity import (_assert_memory_equal, _assert_stores_equal,
                          _filled_memory, _jax_memory, _mfgs, jax_state)

R = 3                                  # negatives per edge


def _store(full, cls=DynamicGraph):
    g = cls(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    return g


def _tables(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel_err(got, want) -> float:
    """Largest error over the largest reference value (0 where both are
    0: a weight no path reaches, as ``w_q`` over one mail slot)."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _assert_params(model, params, atol):
    got, want = _flat(flax_param_tree(model)), _flat(params)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], np.asarray(w), rtol=0,
                                   atol=atol, err_msg=str(name))


# ---- batches ---------------------------------------------------------------

@pytest.mark.parametrize("pad", [True, False])
def test_get_batches_with_negatives_bit_equal(pad):
    full = _stream()[3][:230]
    got = list(data.get_batches(full, 64, data.DstRandEdgeSampler(
        full.dst, 1), neg_sample_ratio=R, pad=pad))
    want = list(jdata.get_batches(full, 64, jdata.DstRandEdgeSampler(
        full.dst, 1), neg_sample_ratio=R, pad=pad))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for f in ("target_nodes", "ts", "eids"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert a.num_valid == b.num_valid
        assert len(a.target_nodes) == (2 + R) * a.batch_size
    assert got[-1].batch_size == (64 if pad else 38)


# ---- TGN at three negatives per edge ----------------------------------------

def _tgn_pair(full, ef, cfg, ratio=1, fanouts=(4,), **knobs):
    """The port's TGN trainer on the CPU and JAX's holding its weights.
    JAX runs its default GRU and attention (``impl="xla"``), which compile
    far faster on the CPU than the Pallas kernels in interpret mode; the
    port's kernels' plain versions are held to those kernels in
    ``tests/test_torch_kernels.py``."""
    model = DGNN(**cfg, neg_sample_ratio=ratio, device="cpu")
    trainer = Trainer(model, fanouts=list(fanouts), device="cpu",
                      neg_sample_ratio=ratio, **knobs)
    g = _store(full)
    state = trainer.init_state(g.max_vertex_id() + 1)
    jmodel = JDGNN(**cfg, neg_sample_ratio=ratio)
    jtrainer = JTrainer(jmodel, fanouts=list(fanouts), dedup_factor=None,
                        neg_sample_ratio=ratio,
                        gru_table=knobs.get("gru_table", False))
    jg = _store(full, JGraph)
    jstate = jax_state(jtrainer, model, jg.max_vertex_id() + 1)
    return trainer, state, g.device_graph("cpu"), jtrainer, jstate, \
        jg.device_graph()


def _np_memory(jmem):
    """A host copy of a JAX memory state's four tensors (the next step
    donates the state)."""
    return SimpleNamespace(**{f: np.array(getattr(jmem, f)) for f in (
        "node_memory", "node_memory_ts", "mailbox", "mailbox_ts")})


def _ratio_batches(full, ratio=R, n=3):
    stream = full[:64 * n]
    return (list(data.get_batches(stream, B, data.DstRandEdgeSampler(
        full.dst, 1), neg_sample_ratio=ratio)),
        list(jdata.get_batches(stream, B, jdata.DstRandEdgeSampler(
            full.dst, 1), neg_sample_ratio=ratio)))


@pytest.fixture(scope="module")
def ratio_run():
    """JAX's 3 train steps at ratio 3 from the port's initial weights:
    ``(params0, [(loss, pos, neg, params, memory)])``."""
    _, _, _, full, _, ef = _stream()
    trainer, _, _, jtrainer, jstate, jdg = _tgn_pair(full, ef, CFG, R)
    params0 = flax_param_tree(trainer.model)
    out = []
    for jb in _ratio_batches(full)[1]:
        jstate, loss, pos, neg = jtrainer.train_step(
            jstate, jdg, None, jnp.asarray(ef), jb)
        out.append((float(loss), np.asarray(pos), np.asarray(neg),
                    jax.tree.map(np.asarray, jstate.params),
                    _np_memory(jstate.memory)))
    return params0, out


@pytest.mark.parametrize("dedup", [None, 1.0])
def test_tgn_ratio3_train_matches_jax(ratio_run, dedup):
    params0, want = ratio_run
    _, _, _, full, _, ef = _stream()
    model = DGNN(**CFG, neg_sample_ratio=R, device="cpu")
    load_flax_params(model, params0)
    trainer = Trainer(model, fanouts=[4], device="cpu", neg_sample_ratio=R,
                      dedup_factor=dedup)
    g = _store(full)
    state = trainer.init_state(g.max_vertex_id() + 1)
    dg, tef = g.device_graph("cpu"), torch.from_numpy(ef)
    for b, (jloss, jpos, jneg, jparams, jmem) in zip(_ratio_batches(full)[0],
                                                     want):
        state, loss, pos, neg = trainer.train_step(state, dg, tef, b)
        assert neg.shape == (R * B,) and pos.shape == (B,)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(pos.numpy(), jpos, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(neg.numpy(), jneg, rtol=1e-4, atol=1e-4)
        _assert_params(trainer.model, jparams, 1e-6)
        _assert_memory_equal(state.memory, jmem)
        if dedup:
            assert state.dedup_n_uniq is not None      # the dedup ran


def test_link_pred_loss_with_negatives_matches_jax():
    from gnnflow_tpu.train import link_pred_loss as jloss
    rng = np.random.RandomState(0)
    pos, neg = rng.randn(10, 1), rng.randn(30, 1)
    valid = np.arange(10) < 7
    got = link_pred_loss(*(torch.from_numpy(x).float()
                           for x in (pos, neg)), torch.from_numpy(valid), R)
    want = jloss(jnp.asarray(pos, jnp.float32), jnp.asarray(neg, jnp.float32),
                 jnp.asarray(valid), R)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_ratio_mismatch_and_short_batches_raise():
    with pytest.raises(ValueError, match="neg_sample_ratio"):
        Trainer(DGNN(**CFG, neg_sample_ratio=2, device="cpu"), fanouts=[4],
                device="cpu")
    _, _, _, full, _, ef = _stream()
    g = _store(full)
    trainer = Trainer(DGNN(**CFG, neg_sample_ratio=R, device="cpu"),
                      fanouts=[4], device="cpu", neg_sample_ratio=R)
    state = trainer.init_state(g.max_vertex_id() + 1)
    b = next(data.get_batches(full, B, data.DstRandEdgeSampler(full.dst, 1)))
    with pytest.raises(ValueError, match="neg_sample_ratio=3"):
        trainer.eval_step(state, g.device_graph("cpu"),
                          torch.from_numpy(ef), b)


# ---- memory over two layers ------------------------------------------------

CFG2 = {**CFG, "num_layers": 2}


def test_two_layer_memory_matches_jax():
    """2 train steps with the write-back of the roots; before the second,
    the logits and gradients of its forward, over the memory the first
    wrote."""
    _, _, _, full, _, ef = _stream()
    trainer, state, dg, jtrainer, jstate, jdg = _tgn_pair(
        full, ef, CFG2, fanouts=(3, 3))
    tef, jef = torch.from_numpy(ef), jnp.asarray(ef)
    n = 3 * B

    @jax.jit
    def jax_step(jstate, roots, ts, eids, valid):
        """JAX's ``_step`` but for its write-back, which takes the roots'
        rows here (the model, loss, gradients and optax update are
        JAX's)."""
        jmfgs = jtrainer._sample(jdg, roots, ts, jax.random.PRNGKey(1))
        _, jefs = jfetch_features(jmfgs, None, jef, None, CFG["dim_edge"])
        loss, pos, _, last, grads = jtrainer._run_model(
            jstate, jmfgs, jefs, jax.random.PRNGKey(2), valid, True,
            jtrainer._mem_input(jstate.memory, jmfgs[0][0]), [None])
        upd, opt = jtrainer.tx.update(grads, jstate.opt_state,
                                      jstate.params)
        memory = jmemory.update_mem_mail(
            jstate.memory, last["last_updated_nid"][:n],
            last["last_updated_memory"][:n], last["last_updated_ts"][:n],
            edge_feats=jnp.where(valid[:, None], jef[eids], 0), valid=valid)
        return jstate.replace(params=optax.apply_updates(jstate.params, upd),
                              opt_state=opt, memory=memory), \
            loss, pos, grads, jmfgs[0][0].num_dst

    batches = zip(*(list(x)[:2] for x in (
        data.get_batches(full, B, data.DstRandEdgeSampler(full.dst, 1)),
        jdata.get_batches(full, B, jdata.DstRandEdgeSampler(full.dst, 1)))))
    for i, (b, jb) in enumerate(batches):
        jstate, jloss, jpos, jgrads, num_dst = jax_step(
            jstate, jnp.asarray(jb.target_nodes, jnp.int32),
            jnp.asarray(jb.ts), jnp.asarray(jb.eids, jnp.int32),
            jvalid_mask(jb))
        assert num_dst == 3 * B * 4          # the outer MFG's instances
        if i == 1:                      # memory is written from here on
            mfgs, efs, mem_input, _, tvalid, _ = trainer._inputs(
                state, dg, tef, b)
            pos, neg, _ = trainer.model(mfgs, efs, mem_input, train=True,
                                        generator=state.dropout_gen)
            trainer.model.zero_grad(set_to_none=True)
            link_pred_loss(pos, neg, tvalid).backward()
            np.testing.assert_allclose(pos.detach().numpy(),
                                       np.asarray(jpos), rtol=0, atol=1e-5)
            got = _flat(flax_param_tree(_grads(trainer.model, CFG2)))
            for name, w in _flat(jgrads).items():
                # the updater's time-encoding bias sums 3,072 instances'
                # terms of both signs into values of 1e-5 to 2e-4, so the
                # f32 summation order shows (measured 2.5e-5)
                tol = 1e-4 if name[:2] == ("updater", "TimeEncode_0") \
                    else 1e-5
                assert np.abs(w).max() > 0, name
                assert _rel_err(got[name], w) <= tol, name
        state, loss, pos, neg = trainer.train_step(state, dg, tef, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-4)
        _assert_params(trainer.model, jax.tree.map(np.asarray,
                                                   jstate.params), 1e-6)
        _assert_memory_equal(state.memory, jstate.memory)
    assert state.memory.node_memory.abs().sum() > 0


def _grads(model, cfg):
    carrier = DGNN(**cfg, device="cpu")
    with torch.no_grad():
        for g, p in zip(carrier.parameters(), model.parameters()):
            g.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return carrier


# ---- the per-node GRU gate table --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_node_gather_matches_jax(dtype):
    rng = np.random.RandomState(0)
    n, f, dr, L = 30, 8, 22, 200
    arrs = [rng.randn(n, f), rng.randn(n, dr), rng.rand(n) * 500,
            rng.randn(dr, 3 * f) * 0.3, rng.randn(f, 3 * f) * 0.3]
    arrs = [a.astype(np.float32) for a in arrs]
    nids = rng.randint(0, n, L)
    cot = [rng.randn(L, 3 * f).astype(np.float32) for _ in range(2)]
    cd = getattr(torch, dtype)
    t = [torch.from_numpy(a) for a in arrs]
    t[3].requires_grad_(True)
    t[4].requires_grad_(True)
    out = gru_node_gather(*t, torch.from_numpy(nids), cd)
    ((out[0].float() * torch.from_numpy(cot[0])).sum()
     + (out[1].float() * torch.from_numpy(cot[1])).sum()).backward()
    @jax.jit
    def jvjp(*a):
        out, vjp = jax.vjp(lambda ki, kh: jgru_gather(
            *a[:3], ki, kh, a[5], dtype), a[3], a[4])
        return out, vjp((a[6].astype(dtype), a[7].astype(dtype),
                         jnp.zeros_like(out[2]), jnp.zeros_like(out[3])))

    jout, jd = jvjp(*map(jnp.asarray, arrs + [nids] + cot))
    ref = gru_node_gather_ref(*t[:5], torch.from_numpy(nids), cd)
    for a, b, r in zip(out, jout, ref):
        a32 = a.detach().float().numpy()
        assert a.dtype == r.dtype
        if dtype == "bfloat16":
            assert np.array_equal(a32, np.asarray(b, np.float32))
        else:
            np.testing.assert_allclose(a32, np.asarray(b), rtol=0,
                                       atol=1e-5)
        np.testing.assert_allclose(a32, r.detach().float().numpy(), rtol=0,
                                   atol=1e-5 if dtype == "float32" else 0.05)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip((t[3].grad, t[4].grad), jd):
        w = np.asarray(w)
        assert _rel_err(g.numpy(), w) <= tol


def test_gru_table_train_matches_jax():
    _, _, _, full, _, ef = _stream()
    trainer, state, dg, jtrainer, jstate, jdg = _tgn_pair(
        full, ef, CFG, gru_table=True)
    tef, jef = torch.from_numpy(ef), jnp.asarray(ef)
    for b, jb in zip(*(list(x)[:3] for x in (
            data.get_batches(full, B, data.DstRandEdgeSampler(full.dst, 1)),
            jdata.get_batches(full, B,
                              jdata.DstRandEdgeSampler(full.dst, 1))))):
        mfgs, *_ = trainer._inputs(state, dg, tef, b)
        assert isinstance(trainer._mem_input(state, mfgs[0][0], None),
                          memory_lib.RawMemoryInput)
        jstate, jloss, jpos, _ = jtrainer.train_step(jstate, jdg, None, jef,
                                                     jb)
        state, loss, pos, _ = trainer.train_step(state, dg, tef, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-4,
                                   atol=1e-4)
        _assert_params(trainer.model, jax.tree.map(np.asarray,
                                                   jstate.params), 1e-6)
        _assert_memory_equal(state.memory, jstate.memory)


@pytest.mark.parametrize("cfg", [
    {**CFG, "memory_updater": "transformer"},
    {**CFG, "mailbox_slots": 3},
    {**CFG, "use_memory": False}], ids=["apan", "slots", "no_memory"])
def test_gru_table_refusals_match_jax(cfg):
    with pytest.raises(ValueError, match="gru_table requires"):
        JTrainer(JDGNN(**cfg), fanouts=[4], gru_table=True)
    with pytest.raises(ValueError, match="gru_table requires"):
        Trainer(DGNN(**cfg, device="cpu"), fanouts=[4], device="cpu",
                gru_table=True)


# ---- attention and heads ----------------------------------------------------

@pytest.mark.parametrize("dims", [(8, 6, 8), (0, 6, 8)],
                         ids=["node_input", "no_node_input"])
def test_factorized_attention_matches_flax(dims):
    dn, de, dt = dims
    rng = np.random.RandomState(3)
    b, f, d = 12, 5, 8
    layer = TemporalAttentionLayer(dn, de, dt, d, 2,
                                   torch.Generator().manual_seed(0),
                                   attention_impl="xla_factorized")
    assert layer.factorized
    mfg, jmfg = _mfgs(rng, 25, b, f)
    mfg.nbr_mask[:2] = False                  # rows with no valid neighbour
    jmfg = jmfg.replace(nbr_mask=jnp.asarray(mfg.nbr_mask.numpy())) \
        if hasattr(jmfg, "replace") else jmfg._replace(
            nbr_mask=jnp.asarray(mfg.nbr_mask.numpy()))
    h = rng.randn(b * (1 + f), dn).astype(np.float32) if dn else None
    ef = rng.randn(b, f, de).astype(np.float32)
    cot = rng.randn(b, d).astype(np.float32)
    th = None if h is None else torch.from_numpy(h).requires_grad_(True)
    tef = torch.from_numpy(ef).requires_grad_(True)
    out = layer(mfg, th, tef)
    (out * torch.from_numpy(cot)).sum().backward()
    jlayer = JAttention(dim_node=dn, dim_edge=de, dim_time=dt, dim_out=d,
                        num_head=2, attention_impl="xla_factorized")
    params = _tables(flax_param_tree(layer))

    def f_(p, hh, ee):
        o = jlayer.apply({"params": p}, jmfg, hh, ee)
        return jnp.sum(o * cot), o

    jh = None if h is None else jnp.asarray(h)
    (_, jout), g = jax.jit(jax.value_and_grad(f_, argnums=(0, 2),
                                              has_aux=True))(
        params, jh, jnp.asarray(ef))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    grads = {k: p.grad for k, p in layer.named_parameters()}
    for k, w in _flat(g[0]).items():
        name = ".".join(("time_enc" if p == "TimeEncode_0" else
                         "layer_norm" if p == "LayerNorm_0" else
                         "weight" if p == "scale" else p) for p in k)
        assert _rel_err(grads[name].numpy(), w) <= 1e-5, name
    np.testing.assert_allclose(tef.grad.numpy(), np.asarray(g[1]), rtol=0,
                               atol=1e-5)
    # the factorized and the materialised attention agree
    layer.factorized = False
    np.testing.assert_allclose(layer(mfg, th, tef).detach().numpy(),
                               out.detach().numpy(), rtol=0, atol=1e-5)


def test_mlp_matches_flax():
    mlp = MLP(6, 10, 4, torch.Generator().manual_seed(1))
    x = np.random.RandomState(0).randn(7, 6).astype(np.float32)
    want = JMLP(dim_hid=10, num_class=4).apply(
        {"params": _tables(flax_param_tree(mlp))}, jnp.asarray(x))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-6)
    other = MLP(6, 10, 4, torch.Generator().manual_seed(2))
    load_flax_params(other, flax_param_tree(mlp))
    assert all(torch.equal(a, b) for a, b in zip(mlp.parameters(),
                                                 other.parameters()))


def test_split_kv_tree_loads_to_the_same_logits():
    """A tree of the old layout (split ``w_k``/``w_v``) loads fused, as
    JAX's ``migrate_params``, and gives the same eval logits."""
    _, _, _, full, _, ef = _stream()
    model = DGNN(**CFG, seed=3, device="cpu")
    tree = flax_param_tree(model)
    D = CFG["dim_embed"]
    kv = tree["l0h0"].pop("w_kv")
    tree["l0h0"]["w_k"] = {"kernel": kv["kernel"][:, :D],
                           "bias": kv["bias"][:D]}
    tree["l0h0"]["w_v"] = {"kernel": kv["kernel"][:, D:],
                           "bias": kv["bias"][D:]}
    jtree = migrate_params(jax.tree.map(np.copy, tree))
    other = DGNN(**CFG, seed=4, device="cpu")
    load_flax_params(other, tree)
    for name, w in _flat(jtree).items():
        assert np.array_equal(_flat(flax_param_tree(other))[name], w)
    g = _store(full)
    b = next(data.get_batches(full, B, data.DstRandEdgeSampler(full.dst, 1)))
    logits = []
    for m in (model, other):
        t = Trainer(m, fanouts=[4], device="cpu")
        _, _, pos, neg = t.eval_step(t.init_state(g.max_vertex_id() + 1),
                                     g.device_graph("cpu"),
                                     torch.from_numpy(ef), b)
        logits.append(torch.cat([pos, neg]))
    assert torch.equal(*logits)


# ---- remat and the scanned steps -------------------------------------------

def _steps(cfg, steps=3, scan=False, **model_kw):
    _, _, _, full, _, ef = _stream()
    model = DGNN(**cfg, seed=1, device="cpu", **model_kw)
    trainer = Trainer(model, fanouts=[4] * cfg["num_layers"], device="cpu")
    g = _store(full)
    state = trainer.init_state(g.max_vertex_id() + 1, seed=5)
    dg, tef = g.device_graph("cpu"), torch.from_numpy(ef)
    batches = list(data.get_batches(full[:64 * steps], B,
                                    data.DstRandEdgeSampler(full.dst, 1)))
    if scan:
        arrays = [torch.stack(t) for t in
                  zip(*map(trainer.batch_arrays, batches))]
        state, losses = trainer.train_steps_scan(state, dg, tef, *arrays)
    else:
        losses = torch.stack([trainer.train_step(state, dg, tef, b)[1]
                              for b in batches])
    return losses, list(model.parameters()), state


@pytest.mark.parametrize("cfg", [
    {**CFG, "dropout": 0.2, "att_dropout": 0.2},
    {**CFG, "use_memory": False, "num_layers": 2, "dropout": 0.2}],
    ids=["tgn_att_dropout", "tgat_two_layers"])
def test_remat_steps_equal_the_plain_steps(cfg):
    a, pa, sa = _steps(cfg)
    b, pb, sb = _steps(cfg, remat_attention=True)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert torch.equal(sa.dropout_gen.get_state(), sb.dropout_gen.get_state())


def test_train_steps_scan_bit_equal_to_the_loop():
    a, pa, sa = _steps(CFG)
    b, pb, sb = _steps(CFG, scan=True)
    assert b.shape == (3,) and torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    for f in memory_lib.TENSORS:
        assert torch.equal(getattr(sa.memory, f), getattr(sb.memory, f))


# ---- updaters without time encoding -----------------------------------------

@pytest.mark.parametrize("updater", ["gru", "transformer"])
def test_updaters_without_time_encoding_match_jax(updater):
    cfg = {**CFG, "dim_time": 0, "memory_updater": updater,
           "mailbox_slots": 1}
    model = DGNN(**cfg, device="cpu")
    assert not hasattr(model.updater, "time_enc")
    jmodel = JDGNN(**cfg, gru_impl="pallas")
    params = _tables(flax_param_tree(model))
    rng = np.random.RandomState(2)
    mem = _filled_memory(rng, 25, 1)
    mfg, jmfg = _mfgs(rng, 25)
    inputs = [(memory_lib.prepare_input(mem, mfg),
               jmemory.prepare_input(_jax_memory(mem), jmfg))]
    if updater == "transformer":
        inputs.append((memory_lib.RawMemoryInput(mem),
                       jmemory.RawMemoryInput(state=_jax_memory(mem))))
    cot = rng.randn(mfg.num_all, CFG["dim_memory"]).astype(np.float32)
    for inp, jinp in inputs:
        model.zero_grad(set_to_none=True)
        h, last = model.updater(mfg, inp)
        (h * torch.from_numpy(cot)).sum().backward()

        def f_(p):
            jh, jlast = jmodel.apply({"params": p}, jmfg, jinp, None,
                                     method=lambda m, *a: m.updater(*a))
            return jnp.sum(jh * cot), (jh, jlast)

        (_, (jh, jlast)), g = jax.jit(jax.value_and_grad(
            f_, has_aux=True))(params)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            last["last_updated_memory"].numpy(),
            np.asarray(jlast["last_updated_memory"]), rtol=0, atol=1e-5)
        got = _flat(flax_param_tree(_grads(model, cfg)))
        for name, w in _flat(g["updater"]).items():
            assert _rel_err(got[("updater",) + name], w) <= 1e-5, name


# ---- stores -----------------------------------------------------------------

STORE_KW = [dict(insertion_policy="replace"),
            dict(adaptive_block_size=False),
            dict(blocks_to_preallocate=600),
            dict(insertion_policy="replace", adaptive_block_size=False)]


@pytest.mark.parametrize("kw", STORE_KW,
                         ids=["replace", "fixed", "preallocated",
                              "replace_fixed"])
def test_store_variants_bit_equal_to_jax(kw):
    """Chunks out of time order (vertices re-sorted), the constructor's
    ingestion of the first chunk, then compaction: pools, offsets,
    capacities and recent samples after every step."""
    full = _stream()[3]
    first, rest = full[:300], [full[900:1300], full[300:900]]
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4,
                     source_vertices=first.src, target_vertices=first.dst,
                     timestamps=first.time, eids=first.eid,
                     add_reverse=True, **kw)
    jg = JGraph(initial_pool_size=1024, minimum_block_size=4,
                source_vertices=first.src, target_vertices=first.dst,
                timestamps=first.time, eids=first.eid, add_reverse=True,
                **kw)
    roots = np.concatenate([np.random.RandomState(0).randint(0, 80, 60),
                            [-1, 0]])

    def check():
        dg, jdg = _assert_stores_equal(g, jg)
        assert g._pool_cap == jg._pool_cap
        ts = np.full(len(roots), float(full.time[-1]) + 1, np.float32)
        _assert_mfgs_identical(
            sampling.sample_layer(dg, torch.from_numpy(roots),
                                  torch.from_numpy(ts), fanout=6),
            jsampling.sample_layer(jdg, jnp.asarray(roots, jnp.int32),
                                   jnp.asarray(ts), fanout=6,
                                   search_iters=jdg.search_iters))

    check()
    for sl in rest:
        for x in (g, jg):
            x.add_edges(sl.src, sl.dst, sl.time, sl.eid, add_reverse=True)
        check()
    for x in (g, jg):
        x.compact()
    check()


def test_replace_policy_resorts_out_of_order_edges():
    """``tests/test_round2_fixes.py:51``: a later batch with older edges
    is re-sorted into the vertex's exact-fit region."""
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4,
                     insertion_policy="replace")
    g.add_edges([0, 0], [1, 2], [5.0, 6.0], [0, 1])
    g.add_edges([0, 0, 0], [3, 4, 5], [1.0, 2.0, 9.0], [2, 3, 4])
    n, t, _ = g.get_temporal_neighbors(0)
    np.testing.assert_array_equal(t, [9.0, 6.0, 5.0, 2.0, 1.0])
    np.testing.assert_array_equal(n, [5, 2, 1, 4, 3])
    assert g._row_cap[0] == 5


def test_build_dynamic_graph_seeds_from_a_dataset():
    full = _stream()[3][:400]
    from gnnflow_tpu.dynamic_graph import build_dynamic_graph as jbuild
    kw = dict(initial_pool_size=1024, maximum_pool_size=1 << 20,
              mem_resource_type="cuda", minimum_block_size=4,
              insertion_policy="replace", undirected=True,
              blocks_to_preallocate=300, adaptive_block_size=False)
    g, jg = build_dynamic_graph(**kw, dataset=full), jbuild(**kw,
                                                             dataset=full)
    _assert_stores_equal(g, jg)
    assert g.num_edges() == jg.num_edges() == 400


# ---- calibration switch -----------------------------------------------------

@pytest.mark.parametrize("cfg, fanouts, kw", [
    (CFG, [4], {}),
    ({**CFG, "use_memory": False, "num_layers": 2}, [4, 4], {}),
    ({**CFG, "use_memory": False, "num_layers": 2, "num_snapshots": 3,
      "dim_time": 0}, [4, 4], dict(num_snapshots=3,
                                   snapshot_time_window=5.0))],
    ids=["tgn", "tgat", "dysat"])
@pytest.mark.parametrize("auto", [False, "auto"])
def test_auto_calibrate_switch_matches_jax(cfg, fanouts, kw, auto):
    t = Trainer(DGNN(**cfg, device="cpu"), fanouts=fanouts, device="cpu",
                auto_calibrate=auto, **kw)
    jt = JTrainer(JDGNN(**cfg), fanouts=fanouts, auto_calibrate=auto, **kw)
    for k in ("dedup_factor", "compact_factor", "layer_dedup",
              "model_compact", "_calibrated"):
        assert getattr(t, k) == getattr(jt, k), k
