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
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.ops.segment import unique_keep_last_mask as jkeep_last
from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.weights import (flax_param_tree,
                                              load_flax_params)
from gnnflow_tpu_torch.ops.segment import unique_keep_last_mask
from gnnflow_tpu_torch.train import Trainer
from torch_fixtures import one_cpu_thread  # noqa: F401
from torch_fixtures import B, _stream
from torch_parity import interpret_attention  # noqa: F401
from torch_parity import _filled_memory, _jax_memory, _jax_side

CFG = dict(dim_node=0, dim_edge=6, dim_time=8, dim_embed=8, num_layers=1,
           num_snapshots=1, att_head=2, dropout=0.2, att_dropout=0.2,
           use_memory=True, dim_memory=8)


def test_tgn_eval_matches_jax(interpret_attention):
    _, _, _, full, _, ef = _stream()
    jtrainer, jstate, jdg = _jax_side(full, ef, CFG,
                                      DGNN(**CFG, device="cpu"))
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


@pytest.mark.parametrize("kw", [dict(num_layers=3),
                                dict(memory_updater="transformer",
                                     dim_time=0),
                                dict(dim_time=0),
                                dict(num_layers=2)])
def test_unported_configs_raise(kw):
    """Configurations that earlier slices refused (memory over more than
    one layer, memory updaters without time encoding) build and compute
    JAX's eval logits on a sampled batch over filled memory, within 1e-5
    (f32), the JAX ``DGNN`` holding the port's weights."""
    from gnnflow_tpu.common import MFG as JMFG
    from gnnflow_tpu.models import memory as jmemory
    from gnnflow_tpu.train import fetch_features as jfetch
    from gnnflow_tpu_torch.models import memory as memory_lib
    cfg = {**CFG, **kw, "dropout": 0.0, "att_dropout": 0.0}
    _, _, _, full, _, ef = _stream()
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = DGNN(**cfg, device="cpu")
    trainer = Trainer(model, fanouts=[3] * cfg["num_layers"], device="cpu")
    state = trainer.init_state(g.max_vertex_id() + 1)
    b = next(data.get_batches(full[300:], 16,
                              data.DstRandEdgeSampler(full.dst, 1)))
    mfgs, efs, *_ = trainer._inputs(state, g.device_graph("cpu"),
                                    torch.from_numpy(ef), b)
    mem = _filled_memory(np.random.RandomState(0), state.memory.num_nodes,
                         1)
    pos, neg, _ = model(mfgs, efs, memory_lib.prepare_input(mem, mfgs[0][0]))
    jmfgs = [[JMFG(*(jnp.asarray(np.asarray(getattr(m, f)), jnp.int32
                                 if getattr(m, f).dtype == torch.int64
                                 else None)
                     for f in ("root_nids", "root_ts", "nbr_nids", "nbr_ts",
                               "nbr_dts", "nbr_eids", "nbr_mask")))]
             for (m,) in mfgs]
    _, jefs = jfetch(jmfgs, None, jnp.asarray(ef), None, cfg["dim_edge"])
    jpos, jneg, _ = jax.jit(JDGNN(**cfg).apply)(
        {"params": jax.tree.map(jnp.asarray, flax_param_tree(model))},
        jmfgs, [None], jefs,
        jmemory.prepare_input(_jax_memory(mem), jmfgs[0][0]))
    for a, w in ((pos, jpos), (neg, jneg)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keep_last_mask_identical(seed):
    rng = np.random.RandomState(seed)
    nids = rng.randint(-1, 40, 300).astype(np.int32)   # -1: padded rows
    valid = (rng.rand(300) < 0.8) & (nids >= 0)
    got = unique_keep_last_mask(torch.from_numpy(nids),
                                torch.from_numpy(valid))
    want = jkeep_last(jnp.asarray(nids), jnp.asarray(valid))
    assert np.array_equal(got.numpy(), np.asarray(want))
