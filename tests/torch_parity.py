"""What the port's CPU parity tests share: the streams, stores, states
and inputs they build on both sides, and the checks that hold the port's
results to the JAX package's.  This module imports JAX and the JAX
package, so the card tests do not import it; what they share is in
``torch_fixtures``.  The test files import it as a sibling module
(pytest puts ``tests/`` on ``sys.path``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.common import MFG as JMFG
from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.models import memory as jmemory
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.models.static import GAT as JGAT
from gnnflow_tpu.models.static import SAGE as JSAGE
from gnnflow_tpu.ops import attention_pallas
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu.train import TrainState as JTrainState
from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.common import MFG
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.static import GAT, SAGE
from gnnflow_tpu_torch.models.weights import flax_param_tree
from torch_fixtures import B


# ---- TGN on a tiny stream ------------------------------------------------

@pytest.fixture
def interpret_attention(monkeypatch):
    # modules.py:404-410 calls the Pallas kernel without ``interpret``,
    # which the CPU backend refuses; run it in interpret mode
    orig = attention_pallas.neighborhood_attention
    monkeypatch.setattr(attention_pallas, "neighborhood_attention",
                        lambda q, k, v, m, interpret=False:
                        orig(q, k, v, m, True))


def jax_state(jtrainer, model, num_nodes):
    """The JAX train state that ``init_state`` returns, but holding the
    port ``model``'s weights (``flax_param_tree``): Adam's zero state,
    zero memory for ``num_nodes`` nodes (models with memory), key 0,
    step 0.  It compiles none of ``init_state``'s programs (~4 s a
    model on the CPU)."""
    params = jax.tree.map(jnp.asarray, flax_param_tree(model))
    return JTrainState(
        params=params, opt_state=jtrainer.tx.init(params),
        memory=jtrainer._init_memory(num_nodes)
        if jtrainer.model.use_memory else None,
        key=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32),
        tier_takes=jnp.zeros((4,), jnp.int32)
        if jtrainer._layer_dedup_ok() else None)


def _jax_side(full, ef, cfg, model=None):
    """The JAX TGN trainer, its state and store of ``full``; the state
    from ``init_state``, or holding the port ``model``'s weights
    (:func:`jax_state`)."""
    g = JGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    jmodel = JDGNN(**cfg, gru_impl="pallas", attention_impl="pallas")
    trainer = JTrainer(jmodel, fanouts=[4], sample_strategy="recent",
                       dedup_factor=None, gru_table=False)
    dg = g.device_graph()
    if model is not None:
        return trainer, jax_state(trainer, model,
                                  g.max_vertex_id() + 1), dg
    state = trainer.init_state(jax.random.PRNGKey(0), dg, B, None,
                               jnp.asarray(ef),
                               num_nodes=g.max_vertex_id() + 1)
    return trainer, state, dg


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


# ---- memory states and MFGs, the same on both sides -----------------------

MEMORY_FIELDS = ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts",
                 "mailbox_ptr")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_memory(mem):
    """The JAX state holding the port's state's values."""
    return jmemory.restore_memory({f: _np(getattr(mem, f)).astype(np.float32)
                                   for f in MEMORY_FIELDS})


def _assert_memory(mem, jmem, atol):
    for f in MEMORY_FIELDS:
        got, want = _np(getattr(mem, f)).astype(np.float32), \
            _np(getattr(jmem, f))
        if f.endswith(("_ts", "_ptr")) or atol == 0:
            assert np.array_equal(got, want), f
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=f)


def _filled_memory(rng, n, slots, dm=8, de=6):
    """A state of ``n`` nodes with random memory and mails, timestamps
    below 1e3, a few slots never written (ts 0) and random cursors."""
    mem = memory_lib.init_memory(n, dm, de, "cpu", slots)
    for f in ("node_memory", "mailbox"):
        t = getattr(mem, f)
        t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32)))
    mem.node_memory_ts.copy_(torch.from_numpy(
        (rng.rand(n) * 500).astype(np.float32)))
    mts = (rng.rand(*mem.mailbox_ts.shape) * 500).astype(np.float32)
    mts[rng.rand(*mts.shape) < 0.2] = 0.0
    mem.mailbox_ts.copy_(torch.from_numpy(mts))
    if slots > 1:
        mem.mailbox_ptr.copy_(torch.from_numpy(rng.randint(0, 7, n)))
    return mem


def _mfgs(rng, n, b=12, f=5):
    """The same MFG on both sides: repeated ids, invalid slots, small
    timestamps (below 1e3)."""
    nbr = rng.randint(0, n, (b, f))
    mask = rng.rand(b, f) < 0.7
    nbr[~mask] = -1
    root_ts = (rng.rand(b) * 400 + 500).astype(np.float32)
    nbr_ts = np.where(mask, root_ts[:, None] - rng.rand(b, f) * 300,
                      0).astype(np.float32)
    nbr_ts[:, 1] = nbr_ts[:, 0]                     # repeated (nid, ts)
    nbr[:, 1] = nbr[:, 0]
    cols = (rng.randint(0, n, b), root_ts, nbr, nbr_ts,
            (root_ts[:, None] - nbr_ts).astype(np.float32),
            np.zeros((b, f), np.int64), mask)
    return MFG(*[torch.from_numpy(np.asarray(c)) for c in cols]), \
        JMFG(*[jnp.asarray(c, jnp.int32 if np.asarray(c).dtype == np.int64
                           else None) for c in cols])


# ---- stores and edge tables ------------------------------------------------

def _assert_stores_equal(g, jg):
    dg, jdg = g.device_graph("cpu"), jg.device_graph()
    off, ln = dg.row_off.numpy(), dg.row_len.numpy()
    assert np.array_equal(off, np.asarray(jdg.row_off))
    assert np.array_equal(ln, np.asarray(jdg.row_len))
    assert np.array_equal(g._row_cap, jg._row_cap)
    assert g._pool_used == jg._pool_used
    assert dg.search_iters == jdg.search_iters
    live = np.concatenate([np.arange(o, o + n) for o, n in zip(off, ln)
                           if n > 0] or [np.zeros(0, np.int64)])
    for name in ("e_dst", "e_ts", "e_eid"):
        a = getattr(dg, name).numpy()[live]
        b = np.asarray(getattr(jdg, name))[live]
        assert a.tobytes() == b.astype(a.dtype).tobytes(), name
    return dg, jdg


def _assert_tables_equal(a, b):
    for field in ("src", "dst", "time", "eid"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


# ---- two hops on a 5,000-edge stream: TGAT and DySAT ----------------------

DYSAT_CFG = dict(dim_node=0, dim_edge=12, dim_time=0, dim_embed=32,
                 num_layers=2, num_snapshots=3, att_head=2, dropout=0.0,
                 att_dropout=0.0, use_memory=False)
DYSAT_WIN = dict(num_snapshots=3, snapshot_time_window=200.0,
                 prop_time=True)
DYSAT_FANOUTS = (5, 5)


def _hop_stream():
    return data.make_synthetic_dataset(num_src=120, num_dst=30,
                                       num_edges=5000, dim_edge=12, seed=5,
                                       time_scale=1.0)


def _port_graph(full):
    g = DynamicGraph(initial_pool_size=4096, minimum_block_size=8)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    return g


def _jax_graph(full):
    g = JGraph(initial_pool_size=4096, minimum_block_size=8)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    return g


# ---- the static models (GraphSAGE and GAT) ---------------------------------

DIM_NODE, EMBED, STATIC_FANOUTS = 16, 16, (4, 3)
STATIC = {"sage": dict(aggregator="mean"), "gat": dict(attn_head=(2, 1))}


def _static_stream():
    return data.make_synthetic_dataset(num_src=200, num_dst=60,
                                       num_edges=3000, dim_node=DIM_NODE,
                                       dim_edge=8, seed=11)


def _static_graphs(full):
    g = DynamicGraph(initial_pool_size=8192, minimum_block_size=8)
    jg = JGraph(initial_pool_size=8192, minimum_block_size=8)
    for x in (g, jg):
        x.add_edges(full.src, full.dst, full.time, full.eid,
                    add_reverse=True)
    return g, jg


def _static_models(name, compute_dtype=None, **kw):
    kw = {**STATIC[name], **kw}
    cls, jcls = (SAGE, JSAGE) if name == "sage" else (GAT, JGAT)
    return cls(DIM_NODE, EMBED, compute_dtype=compute_dtype, device="cpu",
               **kw), \
        jcls(dim_node=DIM_NODE, dim_embed=EMBED, compute_dtype=compute_dtype,
             **kw)


def _static_batch(train, i=0):
    return list(data.get_batches(
        train, B, data.DstRandEdgeSampler(train.dst, seed=1)))[i]
