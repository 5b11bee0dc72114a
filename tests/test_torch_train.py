"""TGN training: the port's Trainer.train_step against the JAX
Trainer.train_step (gru_impl="pallas", attention_impl="pallas", the Pallas
kernels in interpret mode), same weights via load_flax_params, f32,
dropout 0, on a tiny stream; then dropout, and eval after training.

Tolerances (f32):
- first-step gradients, per parameter, as max abs error over max abs
  value: 1e-5.  The two sides sum in other orders (f32; measured at most
  7.3e-7).
- losses 1e-4 and memory and mails 1e-4 absolute, as the eval slice
  (tests/test_torch_slice.py); timestamps exact.
- parameters after each Adam step (lr 1e-4): 1e-6 absolute.  An Adam
  update is lr * m / (sqrt(v) + eps), so gradients that agree to ~1e-6
  relative move the parameters alike to ~lr * 1e-6; the rest is the
  rounding of parameters of size ~1 (6e-8, the largest difference
  measured).  XLA on the CPU contracts
  ``dts * tw + tb`` into one FMA while the port rounds twice (see
  tests/test_torch_kernels.py); tb starts at 0, where the two agree, and
  the tiny stream keeps dts below 600.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.train import _valid_mask as jvalid_mask
from gnnflow_tpu.train import fetch_features as jfetch_features
from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.modules import dropout
from gnnflow_tpu_torch.models.weights import (flax_param_tree,
                                              load_flax_params)
from gnnflow_tpu_torch.ops.attention_fused import neighborhood_attention_ref
from gnnflow_tpu_torch.train import Trainer, link_pred_loss
from tests.test_torch_kernels import one_cpu_thread  # noqa: F401
from tests.test_torch_slice import B, _stream, interpret_attention  # noqa: F401
from tests.test_torch_slice import _jax_side

CFG = dict(dim_node=0, dim_edge=6, dim_time=8, dim_embed=8, num_layers=1,
           num_snapshots=1, att_head=2, dropout=0.0, att_dropout=0.0,
           use_memory=True, dim_memory=8)


def _port_side(full, params, cfg=CFG, compute_dtype=None, seed=0):
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = DGNN(**cfg, compute_dtype=compute_dtype, device="cpu")
    if params is not None:
        load_flax_params(model, params)
    trainer = Trainer(model, fanouts=[4], device="cpu")
    return trainer, trainer.init_state(g.max_vertex_id() + 1, seed), \
        g.device_graph("cpu")


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _batches(full, n_edges=230):
    """Batches of 64, 64, 64 and 38 (the last padded), ours and JAX's."""
    stream = full[:n_edges]
    return (data.get_batches(stream, B, data.DstRandEdgeSampler(full.dst, 1)),
            jdata.get_batches(stream, B,
                              jdata.DstRandEdgeSampler(full.dst, 1)))


def _assert_memory_equal(m, jm):
    for name in ("node_memory", "mailbox"):
        np.testing.assert_allclose(getattr(m, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name in ("node_memory_ts", "mailbox_ts"):
        assert np.array_equal(getattr(m, name).numpy(),
                              np.asarray(getattr(jm, name))), name


def test_first_step_gradients_match_jax(interpret_attention):
    """Parameter gradients of one training forward/backward against the
    JAX trainer's ``_run_model(train=True)``, after two eval batches have
    filled the memory."""
    _, _, _, full, _, ef = _stream()
    jtrainer, jstate, jdg = _jax_side(full, ef, CFG)
    jef = jnp.asarray(ef)
    trainer, state, dg = _port_side(full, jax.tree.map(np.asarray,
                                                       jstate.params))
    tef = torch.from_numpy(ef)
    ours, ref = _batches(full)
    for _, b, jb in zip(range(2), ours, ref):
        jstate, *_ = jtrainer.eval_step(jstate, jdg, None, jef, jb)
        trainer.eval_step(state, dg, tef, b)
    b, jb = next(ours), next(ref)

    jmfgs = jtrainer._sample(jdg, jnp.asarray(jb.target_nodes, jnp.int32),
                             jnp.asarray(jb.ts, jnp.float32),
                             jax.random.PRNGKey(1))
    jnfs, jefs = jfetch_features(jmfgs, None, jef, None, CFG["dim_edge"])
    jmem = jtrainer._mem_input(jstate.memory, jmfgs[0][0])
    run = jax.jit(jtrainer._run_model, static_argnums=(5,))
    jloss, *_, jgrads = run(jstate, jmfgs, jefs, jax.random.PRNGKey(2),
                            jvalid_mask(jb), True, jmem, jnfs)

    mfgs, efs, mem_input, _, valid = trainer._inputs(state, dg, tef, b)
    pos, neg, _ = trainer.model(mfgs, efs, mem_input, train=True,
                                generator=state.dropout_gen)
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
        assert np.abs(w).max() > 0, name     # every parameter is trained
        err = np.abs(got[name] - w).max() / np.abs(w).max()
        assert err <= 1e-5, (name, err)


def test_tgn_train_matches_jax(interpret_attention):
    """Four train steps (the last batch padded): losses, logits, parameters
    by Flax name, memory and mailbox after every step."""
    _, _, _, full, _, ef = _stream()
    jtrainer, jstate, jdg = _jax_side(full, ef, CFG)
    jef = jnp.asarray(ef)
    trainer, state, dg = _port_side(full, jax.tree.map(np.asarray,
                                                       jstate.params))
    tef = torch.from_numpy(ef)
    n = 0
    for b, jb in zip(*_batches(full)):
        n += 1
        jstate, jloss, jpos, jneg = jtrainer.train_step(jstate, jdg, None,
                                                        jef, jb)
        state, loss, pos, neg = trainer.train_step(state, dg, tef, b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(pos.numpy(), np.asarray(jpos),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(neg.numpy(), np.asarray(jneg),
                                   rtol=1e-4, atol=1e-4)
        got = _flat(flax_param_tree(trainer.model))
        want = _flat(jax.tree.map(np.asarray, jstate.params))
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-6,
                                       err_msg=str(name))
        _assert_memory_equal(state.memory, jstate.memory)
    assert n == 4 and b.num_valid == 38 and state.step == 4
    assert int(jstate.step) == 4


def _train(cfg, seed, steps=2, compute_dtype=None):
    _, _, _, full, _, ef = _stream()
    trainer, state, dg = _port_side(full, None, cfg, compute_dtype, seed)
    tef = torch.from_numpy(ef)
    losses = []
    for _, b in zip(range(steps), _batches(full)[0]):
        state, loss, _, _ = trainer.train_step(state, dg, tef, b)
        losses.append(float(loss))
    return trainer, state, losses


def test_dropout_same_seed_same_step():
    cfg = {**CFG, "dropout": 0.2, "att_dropout": 0.2}
    t1, _, l1 = _train(cfg, seed=7)
    t2, _, l2 = _train(cfg, seed=7)
    _, _, l3 = _train(cfg, seed=8)
    _, _, l0 = _train(CFG, seed=7)
    assert l1 == l2
    assert l1 != l3 and l1 != l0          # dropout draws, and is active
    for p, q in zip(t1.model.parameters(), t2.model.parameters()):
        assert torch.equal(p, q)


def test_eval_ignores_dropout():
    _, _, _, full, _, ef = _stream()
    outs = []
    for cfg in ({**CFG, "dropout": 0.3, "att_dropout": 0.3}, CFG):
        trainer, state, dg = _port_side(full, None, cfg)
        b = next(_batches(full)[0])
        outs.append(trainer.eval_step(state, dg, torch.from_numpy(ef), b))
    for a, c in zip(outs[0][1:], outs[1][1:]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keeps_share_and_scales(dtype):
    x = torch.ones(200_000, dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.2, gen)
    kept = y != 0
    # binomial std of the kept share: sqrt(0.8 * 0.2 / 2e5) = 9e-4
    assert abs(kept.float().mean().item() - 0.8) < 5e-3
    assert torch.all(y[kept] == torch.tensor(1.25, dtype=dtype))
    assert dropout(x, 0.0, gen) is x


def test_training_with_dropout_needs_a_generator():
    _, _, _, full, _, ef = _stream()
    trainer, state, dg = _port_side(full, None, {**CFG, "dropout": 0.2})
    mfgs, efs, mem_input, _, _ = trainer._inputs(
        state, dg, torch.from_numpy(ef), next(_batches(full)[0]))
    with pytest.raises(ValueError, match="generator"):
        trainer.model(mfgs, efs, mem_input, train=True)


def test_plain_attention_at_rate_zero_matches_kernel_path():
    """The training route around the kernel (att_dropout > 0) computes the
    same attention as the kernel's plain version when no value drops."""
    layer = DGNN(**CFG, device="cpu").layers["l0h0"]
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(50, 8).astype(np.float32))
    kv = torch.from_numpy(rng.randn(50, 4, 16).astype(np.float32))
    mask = torch.from_numpy(rng.rand(50, 4) < 0.7)
    mask[2] = False
    got = layer._attention_plain(q, kv, mask, None)
    want = neighborhood_attention_ref(
        q.reshape(50, 2, 4), kv[..., :8].reshape(50, 4, 2, 4),
        kv[..., 8:].reshape(50, 4, 2, 4), mask).reshape(50, 8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert not got[2].any()


def test_eval_after_train_reads_stepped_weights():
    """After train steps, eval_step equals that of a model freshly loaded
    with the stepped parameters: no stale bf16 weight copies."""
    _, _, _, full, _, ef = _stream()
    trainer, state, _ = _train(CFG, seed=0, steps=2,
                               compute_dtype="bfloat16")
    fresh, fstate, dg = _port_side(full, flax_param_tree(trainer.model),
                                   compute_dtype="bfloat16")
    for name in ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts"):
        getattr(fstate.memory, name).copy_(getattr(state.memory, name))
    b = list(_batches(full)[0])[2]
    tef = torch.from_numpy(ef)
    _, loss, pos, neg = trainer.eval_step(state, dg, tef, b)
    _, floss, fpos, fneg = fresh.eval_step(fstate, dg, tef, b)
    assert torch.equal(pos, fpos) and torch.equal(neg, fneg)
    assert torch.equal(loss, floss)


def test_flax_param_tree_round_trip():
    _, _, _, full, _, ef = _stream()
    _, jstate, _ = _jax_side(full, ef, CFG)
    jparams = jax.tree.map(np.asarray, jstate.params)
    model = DGNN(**CFG, device="cpu")
    load_flax_params(model, jparams)
    tree = flax_param_tree(model)
    want = _flat(jparams)
    got = _flat(tree)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == np.float32 and np.array_equal(got[name], w)
