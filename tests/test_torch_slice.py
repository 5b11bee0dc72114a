"""TGN streaming inference: the port's Trainer.eval_step against the JAX
Trainer.eval_step (gru_impl="pallas", attention_impl="pallas"), same
weights via load_flax_params, f32, over 4 batches of a tiny stream (the
last one padded).  After every batch: logits and loss within 1e-4 (f32
sum order, compounded through the memory the batches write), the memory
table within 1e-4 and its timestamps exact.  The write-back's winner mask
is identical to the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.ops import attention_pallas
from gnnflow_tpu.ops.segment import unique_keep_last_mask as jkeep_last
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.weights import load_flax_params
from gnnflow_tpu_torch.ops.segment import unique_keep_last_mask
from gnnflow_tpu_torch.train import Trainer

CFG = dict(dim_node=0, dim_edge=6, dim_time=8, dim_embed=8, num_layers=1,
           num_snapshots=1, att_head=2, dropout=0.2, att_dropout=0.2,
           use_memory=True, dim_memory=8)
B = 64


@pytest.fixture
def interpret_attention(monkeypatch):
    # modules.py:404-410 calls the Pallas kernel without ``interpret``,
    # which the CPU backend refuses; run it in interpret mode
    orig = attention_pallas.neighborhood_attention
    monkeypatch.setattr(attention_pallas, "neighborhood_attention",
                        lambda q, k, v, m, interpret=False:
                        orig(q, k, v, m, True))


def _stream():
    return data.make_synthetic_dataset(num_src=60, num_dst=20,
                                       num_edges=600, dim_edge=6, seed=5)


def _jax_side(full, ef, cfg=CFG):
    g = JGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = JDGNN(**cfg, gru_impl="pallas", attention_impl="pallas")
    trainer = JTrainer(model, fanouts=[4], sample_strategy="recent",
                       dedup_factor=None, gru_table=False)
    dg = g.device_graph()
    state = trainer.init_state(jax.random.PRNGKey(0), dg, B, None,
                               jnp.asarray(ef),
                               num_nodes=g.max_vertex_id() + 1)
    return trainer, state, dg


def test_tgn_eval_matches_jax(interpret_attention):
    _, _, _, full, _, ef = _stream()
    jtrainer, jstate, jdg = _jax_side(full, ef)
    jef = jnp.asarray(ef)

    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = DGNN(**CFG, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, jstate.params))
    trainer = Trainer(model, fanouts=[4], device="cpu")
    state = trainer.init_state(g.max_vertex_id() + 1)
    dg, tef = g.device_graph("cpu"), torch.from_numpy(ef)

    stream = full[:230]                  # batches of 64, 64, 64 and 38
    ours = data.get_batches(stream, B, data.DstRandEdgeSampler(full.dst, 1))
    ref = jdata.get_batches(stream, B, jdata.DstRandEdgeSampler(full.dst, 1))
    n = 0
    for b, jb in zip(ours, ref):
        n += 1
        jstate, jloss, jpos, jneg = jtrainer.eval_step(jstate, jdg, None,
                                                       jef, jb)
        state, loss, pos, neg = trainer.eval_step(state, dg, tef, b)
        np.testing.assert_allclose(pos.numpy(), np.asarray(jpos),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(neg.numpy(), np.asarray(jneg),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-4)
        jm, m = jstate.memory, state.memory
        for name in ("node_memory", "mailbox"):
            np.testing.assert_allclose(getattr(m, name).numpy(),
                                       np.asarray(getattr(jm, name)),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        for name in ("node_memory_ts", "mailbox_ts"):
            assert np.array_equal(getattr(m, name).numpy(),
                                  np.asarray(getattr(jm, name))), name
    assert n == 4 and b.num_valid == 38
    assert state.memory.node_memory.abs().sum() > 0


def test_weight_loader_rejects_other_trees():
    model = DGNN(**CFG, device="cpu")
    tree = {name: p.detach().numpy() for name, p in
            model.named_parameters()}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(model, {"edge_predictor": {}})
    with pytest.raises(KeyError, match="extra"):
        load_flax_params(model, {"bogus": np.zeros(1), **{
            "edge_predictor": {"src_fc": {"kernel": tree[
                "edge_predictor.src_fc.kernel"]}}}})


@pytest.mark.parametrize("kw", [dict(num_snapshots=3),
                                dict(memory_updater="transformer"),
                                dict(use_memory=False),
                                dict(num_layers=2)])
def test_unported_configs_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DGNN(**{**CFG, **kw}, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keep_last_mask_identical(seed):
    rng = np.random.RandomState(seed)
    nids = rng.randint(-1, 40, 300).astype(np.int32)   # -1: padded rows
    valid = (rng.rand(300) < 0.8) & (nids >= 0)
    got = unique_keep_last_mask(torch.from_numpy(nids),
                                torch.from_numpy(valid))
    want = jkeep_last(jnp.asarray(nids), jnp.asarray(valid))
    assert np.array_equal(got.numpy(), np.asarray(want))
