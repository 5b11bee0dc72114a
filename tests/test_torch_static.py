"""GraphSAGE, GAT and node features: the port against the JAX package on
a tiny stream (200 src, 60 dst, 3000 edges, 16-dim node features, 8-dim
edge features that the static models do not read; fanouts [4, 3],
embedding 16, GAT heads (2, 1); batch 64), with the weights carried
across by ``load_flax_params``.

Sampling is static: roots at the timestamp 3.4e38.  Uniform draws are
the JAX keys' (``fold_in(key, layer)``), passed to the port's sampler, so
both sides sample the same MFGs.  Train steps use recent sampling, which
needs no draws, as tests/test_torch_tgat.py does; the JAX side builds only
the padded program, never the layer dedup.

Tolerances:
- MFGs: bit-identical.
- layers and logits in f32: 1e-5 absolute (f32 sums in other orders);
  gradients per parameter, max abs error over max abs value, 1e-5.
- bf16 (the JAX bf16 program on the CPU): logits and loss 1e-3 absolute
  (measured 1.8e-4); kernel and attention-vector gradients 4e-2 of each
  parameter's largest (measured 2.5e-2: GATConv's factorised sums round
  once in a product where the JAX program rounds each term; SAGE's match
  exactly).  Bias gradients 0.5 of their largest (measured 0.31): the JAX
  program sums the 128 rows' bf16 cotangents of a bias in bf16, adding up
  to 2^-8 relative at each of 127 additions, the port in f32.
- train steps (f32, dropout 0, Adam at lr 1e-4): losses rtol 1e-5;
  parameters 1e-5 absolute, a tenth of a step.
- the layer dedup against the JAX padded losses: rtol 1e-5, as
  tests/test_layer_dedup.py holds its static cases.
- the memory updaters with node features: 1e-5 absolute, as
  tests/test_torch_apan.py; TGN train steps with node features on the
  memory dedup against the per-instance pull: losses, logits and memory
  1e-5, parameters 1e-6 (one program, f32 sum order only).
- calibration fractions, ladders and weight trees: equal.
"""
from collections.abc import Mapping
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu import data as jdata
from gnnflow_tpu.common import MFG as JMFG
from gnnflow_tpu.models import memory as jmemory
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.models.static import GATConv as JGATConv
from gnnflow_tpu.models.static import SAGEConv as JSAGEConv
from gnnflow_tpu.ops import sampling as jsampling
from gnnflow_tpu.ops.dedup import dedup_instances as jdedup
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu.train import _valid_mask as jvalid_mask
from gnnflow_tpu.train import fetch_features as jfetch_features
from gnnflow_tpu_torch import config, data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.factory import build_model
from gnnflow_tpu_torch.models.static import GAT, SAGE, GATConv, SAGEConv
from gnnflow_tpu_torch.models.weights import (_flax_path, flax_param_tree,
                                              load_flax_params)
from gnnflow_tpu_torch.ops import sampling
from gnnflow_tpu_torch.ops.dedup import dedup_instances
from gnnflow_tpu_torch.train import (STATIC_SAMPLE_TS, Trainer,
                                     fetch_node_features, link_pred_loss)
from torch_fixtures import one_cpu_thread  # noqa: F401
from torch_fixtures import B, _assert_mfgs_identical, _flat, _stream
from torch_parity import (DIM_NODE, EMBED, STATIC, STATIC_FANOUTS, _batches,
                          _filled_memory, _jax_memory, _mfgs, _static_batch,
                          _static_graphs, _static_models, _static_stream,
                          jax_state)

STEPS = 4


def _static_mfgs(g, jg, b, key):
    """Both packages' uniform samples of ``b``'s roots at the static
    timestamp, the port's on the JAX key's draws; asserted identical."""
    roots = np.asarray(b.target_nodes)
    ts = np.full(len(roots), STATIC_SAMPLE_TS, np.float32)

    def draw(layer, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, layer), shape, dtype=jnp.float32)))

    mfgs = sampling.sample_hops(g.device_graph("cpu"),
                                torch.from_numpy(roots), torch.from_numpy(ts),
                                fanouts=list(STATIC_FANOUTS),
                                strategy="uniform", draw=draw)
    jdg = jg.device_graph()
    jmfgs = jsampling.sample_hops(jdg, jnp.asarray(roots, jnp.int32),
                                  jnp.asarray(ts),
                                  fanouts=list(STATIC_FANOUTS),
                                  strategy="uniform", key=key,
                                  search_iters=jdg.search_iters)
    for a, w in zip(mfgs, jmfgs):
        _assert_mfgs_identical(a[0], w[0])
    return mfgs, jmfgs


def _shapes(tree, prefix=()):
    """``{path: shape}`` of a parameter tree, arrays or traced shapes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


def _copy_params(module, params):
    """Flax parameters into a port module by name, then its weight copies
    remade; every Flax parameter must be used."""
    flat = _flat(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(np.array(flat.pop(_flax_path(name)))))
    assert not flat
    for m in module.modules():
        if hasattr(m, "cast_weights"):
            m.cast_weights()


# ---- the layers -----------------------------------------------------------

@pytest.mark.parametrize("layer", ["mean", "gcn", "pool", "gat"])
def test_static_layer_matches_flax(layer):
    """One layer over a uniform static sample of the 192 roots of the last,
    padded batch (fanout 4; padded roots have no neighbour), f32: SAGEConv
    in each aggregator, GATConv with two heads."""
    train, _, _, full, nf, _ = _static_stream()
    g, jg = _static_graphs(full)
    b = _static_batch(train, -1)
    assert b.num_valid < B
    mfgs, jmfgs = _static_mfgs(g, jg, b, jax.random.PRNGKey(3))
    mfgs, jmfgs = mfgs[-1:], jmfgs[-1:]              # the outermost layer
    h = fetch_node_features(mfgs, torch.from_numpy(nf))[0]
    jh = jfetch_features(jmfgs, jnp.asarray(nf), None, DIM_NODE)[0][0]
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    if layer == "gat":
        jconv = JGATConv(EMBED, 2)
        conv = GATConv(DIM_NODE, EMBED, 2, torch.Generator())
    else:
        jconv = JSAGEConv(EMBED, layer)
        conv = SAGEConv(DIM_NODE, EMBED, layer, torch.Generator())
    params = jax.jit(jconv.init)(jax.random.PRNGKey(5), jmfgs[0][0],
                                 jh)["params"]
    want = jax.jit(jconv.apply)({"params": params}, jmfgs[0][0], jh)
    _copy_params(conv, params)
    with torch.no_grad():
        got = conv(mfgs[0][0], h)
    assert got.shape == ((192, 2 * EMBED) if layer == "gat" else (192, EMBED))
    assert not mfgs[0][0].nbr_mask.all() and mfgs[0][0].nbr_mask.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_gat_last_layer_of_two_heads_matches_flax():
    """A last GAT layer of H = 2 takes the mean over its heads."""
    train, _, _, full, nf, _ = _static_stream()
    g, jg = _static_graphs(full)
    mfgs, jmfgs = _static_mfgs(g, jg, _static_batch(train),
                               jax.random.PRNGKey(4))
    model, jmodel = _static_models("gat", attn_head=(2, 2))
    jnfs = jfetch_features(jmfgs, jnp.asarray(nf), None, DIM_NODE)[0]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jmfgs,
                                  jnfs)["params"]
    jpos, jneg, _ = jax.jit(jmodel.apply)({"params": params}, jmfgs, jnfs)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    assert model.layers["l1h0"].fc.kernel.shape == (2 * EMBED, 2 * EMBED)
    with torch.no_grad():
        pos, neg, last = model(mfgs, None, node_feats=fetch_node_features(
            mfgs, torch.from_numpy(nf)))
    assert last is None and pos.shape == (B, 1)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(neg.numpy(), np.asarray(jneg), rtol=0,
                               atol=1e-5)


# ---- the models: logits and gradients -------------------------------------

@pytest.mark.parametrize("name", ["sage", "gat"])
@pytest.mark.parametrize("cd", [None, "bfloat16"], ids=["f32", "bf16"])
def test_static_logits_and_gradients_match_jax(jax_runs, name, cd):
    """One training forward and backward (dropout 0) on a uniform static
    sample: logits, loss and every parameter's gradient."""
    train, _, _, full, nf, ef = _static_stream()
    g, jg = _static_graphs(full)
    model, jmodel = _static_models(name, cd)
    # the unstepped state of ``jax_runs``' f32 trainer; its parameter tree
    # is the bf16 model's too (parameters stay f32)
    jtrainer = JTrainer(jmodel, fanouts=list(STATIC_FANOUTS), is_static=True,
                        layer_dedup=None)
    jstate = jax_runs[name]["state0"]
    b = _static_batch(train, 1)
    mfgs, jmfgs = _static_mfgs(g, jg, b, jax.random.PRNGKey(1))
    jnfs, jefs = jfetch_features(jmfgs, jnp.asarray(nf), None, DIM_NODE)
    run = jax.jit(jtrainer._run_model, static_argnums=(5,))
    jloss, jpos, jneg, _, jgrads = run(jstate, jmfgs, jefs,
                                       jax.random.PRNGKey(2), jvalid_mask(b),
                                       True, None, jnfs)
    load_flax_params(model, jax.tree.map(np.asarray, jstate.params))
    nfs = fetch_node_features(mfgs, torch.from_numpy(nf),
                              model.node_feat_dtype(True))
    assert nfs[0].dtype == (torch.bfloat16 if cd else torch.float32)
    pos, neg, _ = model(mfgs, None, train=True, node_feats=nfs)
    valid = torch.from_numpy(np.array(jvalid_mask(b)))
    loss = link_pred_loss(pos, neg, valid)
    loss.backward()
    tol, gtol, btol = (1e-5, 1e-5, 1e-5) if cd is None else (1e-3, 4e-2, 0.5)
    np.testing.assert_allclose(pos.detach().float().numpy(),
                               np.asarray(jpos, np.float32), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(neg.detach().float().numpy(),
                               np.asarray(jneg, np.float32), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=tol)
    got = {_flax_path(n): p.grad.numpy() for n, p in model.named_parameters()}
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, k
        t = btol if k[-1] == "bias" else gtol
        assert np.abs(got[k] - w).max() <= t * scale, k


# ---- training, padded and on the layer dedup ------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """Per model: the JAX padded static trainer (recent sampling, f32,
    dropout 0), its initial state and parameters, and its losses and
    parameters after each of STEPS train steps."""
    train, _, _, full, nf, ef = _static_stream()
    _, jg = _static_graphs(full)
    out = {}
    for name in STATIC:
        model, jmodel = _static_models(name)
        jtrainer = JTrainer(jmodel, fanouts=list(STATIC_FANOUTS),
                            sample_strategy="recent", lr=1e-4,
                            is_static=True, layer_dedup=None)
        jdg = jg.device_graph()
        state = jax_state(jtrainer, model, jg.max_vertex_id() + 1)
        run = dict(params0=jax.tree.map(np.asarray, state.params),
                   state0=jax.tree.map(jnp.array, state),
                   losses=[], params=[])
        batches = jdata.get_batches(
            train, B, jdata.DstRandEdgeSampler(train.dst, seed=1))
        for _, b in zip(range(STEPS), batches):
            state, loss, _, _ = jtrainer.train_step(
                state, jdg, jnp.asarray(nf), jnp.asarray(ef), b)
            run["losses"].append(float(loss))
            run["params"].append(jax.tree.map(np.asarray, state.params))
        out[name] = run
    return out


def _port_run(name, params0, layer_dedup):
    train, _, _, full, nf, ef = _static_stream()
    g, _ = _static_graphs(full)
    model = _static_models(name)[0]
    load_flax_params(model, params0)
    trainer = Trainer(model, fanouts=list(STATIC_FANOUTS),
                      sample_strategy="recent", lr=1e-4,
                      layer_dedup=layer_dedup, is_static=True,
                      device="cpu")
    dg = g.device_graph("cpu")
    state = trainer.init_state(g.max_vertex_id() + 1)
    out = dict(trainer=trainer, state=state, losses=[], params=[],
               compact=[])
    batches = data.get_batches(train, B,
                               data.DstRandEdgeSampler(train.dst, seed=1))
    for _, b in zip(range(STEPS), batches):
        state, loss, _, _ = trainer.train_step(
            state, dg, torch.from_numpy(ef), b,
            node_feats=torch.from_numpy(nf))
        out["losses"].append(float(loss))
        out["params"].append(flax_param_tree(model))
        out["compact"].append(state.layer_dedup_compact)
    return out


@pytest.mark.parametrize("name", ["sage", "gat"])
def test_static_train_matches_jax(jax_runs, name):
    want = jax_runs[name]
    ours = _port_run(name, want["params0"], None)
    np.testing.assert_allclose(ours["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    for got_tree, want_tree in zip(ours["params"], want["params"]):
        got, w = _flat(got_tree), _flat(want_tree)
        assert got.keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5,
                                       err_msg=str(k))
    assert ours["compact"] == [0] * STEPS


@pytest.mark.parametrize("name", ["sage", "gat"])
@pytest.mark.parametrize("factor, compact, takes", [
    (0.5, [1, 0, 1, 0], [2, 2, 0, 0]),          # two fit, two overflow
    (0.01, [0] * STEPS, [0, STEPS, 0, 0]),      # every step falls back
])
def test_static_layer_dedup_matches_jax_padded(jax_runs, name, factor,
                                               compact, takes):
    """The port's counterparts of tests/test_layer_dedup.py's static
    cases: the layer dedup at 0.5 (steps 1 and 3 fit the cap; 2 and 4,
    whose first boundary holds more than half unique pairs, fall back),
    and at 0.01, where every step falls back, both against the JAX padded
    losses."""
    ours = _port_run(name, jax_runs[name]["params0"], factor)
    np.testing.assert_allclose(ours["losses"], jax_runs[name]["losses"],
                               rtol=1e-5, atol=1e-6)
    assert ours["compact"] == compact
    assert ours["trainer"].tier_take_stats(ours["state"])["counts"] == takes


@pytest.mark.parametrize("name", ["sage", "gat"])
def test_static_calibration_matches_jax(name):
    """The first train batch's calibration: the four probes (the batch and
    its timestamps shifted across the stream) all sample at the static
    timestamp, so they are one batch; the fractions and the ladder are
    JAX's."""
    train, _, _, full, nf, ef = _static_stream()
    g, jg = _static_graphs(full)
    model, jmodel = _static_models(name)
    trainer = Trainer(model, fanouts=list(STATIC_FANOUTS),
                      sample_strategy="recent", is_static=True, device="cpu")
    jtrainer = JTrainer(jmodel, fanouts=list(STATIC_FANOUTS),
                        sample_strategy="recent", is_static=True)
    assert not trainer._calibrated and not jtrainer._calibrated
    b = _static_batch(train, 2)
    jdg = jg.device_graph()
    ts = np.asarray(b.ts, np.float32)
    t_hi, t_b = float(np.asarray(jdg.e_ts).max()), float(ts.max())
    want = jtrainer.calibrate(
        jdg, [(b.target_nodes, ts)], max_batches=1,
        occ_batches=[(b.target_nodes, ts + np.float32(q * t_hi - t_b))
                     for q in (0.33, 0.67, 1.0)])
    trainer._maybe_auto_calibrate(g.device_graph("cpu"), b.target_nodes,
                                  b.ts)
    got = trainer.calibration
    assert got == want
    assert got["layer_dedup"] is not None and got["uniq_frac"] is None
    assert trainer.layer_dedup == jtrainer.layer_dedup
    assert trainer._calibrated and sum(trainer.init_state(300).tier_takes) \
        == 0


@pytest.mark.parametrize("case", ["mean", "gcn", "pool", "gat"])
def test_static_weights_round_trip(jax_runs, case):
    """A Flax tree of each static model into the port and back: the same
    names, shapes and values (``l{l}h0/{fc_self,fc_neigh,fc_pool}``,
    ``l{l}h0/fc`` with ``attn_l``/``attn_r``, ``predictor/fc{0,1,2}``).
    The trees of SAGE (mean) and GAT are ``jax_runs``' initial ones."""
    name = "gat" if case == "gat" else "sage"
    kw = {} if case == "gat" else dict(aggregator=case)
    model, jmodel = _static_models(name, **kw)
    if case in ("mean", "gat"):
        tree = jax_runs[name]["params0"]
    else:
        train, _, _, full, nf, _ = _static_stream()
        g, jg = _static_graphs(full)
        _, jmfgs = _static_mfgs(g, jg, _static_batch(train),
                                jax.random.PRNGKey(0))
        jnfs = jfetch_features(jmfgs, jnp.asarray(nf), None, DIM_NODE)[0]
        tree = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), jmfgs, jnfs)["params"])
    want = _flat(tree)
    own = {_flax_path(n): p.shape for n, p in model.named_parameters()}
    assert own == {k: v.shape for k, v in want.items()}
    assert (("l0h0", "fc_neigh", "bias") in want) == (case == "gcn")
    assert (("l1h0", "attn_r") in want) == (case == "gat")
    load_flax_params(model, tree)
    got = _flat(flax_param_tree(model))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], w), k


def test_build_model_static_and_gat_without_is_static():
    cfg, _ = config.get_default_config("graphsage", "reddit")
    model, kw = build_model("GRAPHSAGE", {**cfg, "compute_dtype": "bfloat16"},
                            128, 172, seed=1, device="cpu")
    assert isinstance(model, SAGE) and model.dim_edge == 0
    assert kw == {"fanouts": [15, 10], "sample_strategy": "uniform",
                  "num_snapshots": 1, "snapshot_time_window": 0,
                  "prop_time": False, "is_static": True}
    assert model.layers["l0h0"].fc_self.kernel.shape == (128, 100)
    assert Trainer(model, device="cpu", **kw)._layer_dedup_ok()
    cfg, _ = config.get_default_config("gat", "reddit")
    model, kw = build_model("GAT", cfg, 128, 172, device="cpu")
    assert isinstance(model, GAT) and model.attn_head == (2, 1)
    assert (model.feat_drop, model.attn_drop) == (0.1, 0.1)
    assert model.layers["l1h0"].fc.kernel.shape == (200, 100)
    assert model.node_feat_dtype(True) == torch.float32
    dgnn, kw = build_model("GAT", {**cfg, "is_static": False}, 128, 172,
                           device="cpu")
    assert isinstance(dgnn, DGNN) and not kw["is_static"]
    # the layer dedup: for a DGNN only when not static (train.py:306-307)
    assert Trainer(dgnn, device="cpu", **kw)._layer_dedup_ok()
    assert not Trainer(dgnn, device="cpu",
                       **{**kw, "is_static": True})._layer_dedup_ok()


# ---- node features in the DGNN models -------------------------------------

@pytest.fixture(scope="module")
def updater_models():
    """``(updater, dim_node) ->`` a JAX TGN or APAN DGNN, its initial
    parameters, the port's DGNN with them and its mail slots; each built
    once."""
    built = {}

    def get(updater, dim_node):
        if (updater, dim_node) not in built:
            built[updater, dim_node] = _updater_models(updater, dim_node)
        return built[updater, dim_node]
    return get


def _updater_models(updater, dim_node):
    cfg = dict(dim_node=dim_node, dim_edge=6, dim_time=8, dim_embed=8,
               num_layers=1, num_snapshots=1, att_head=2, dropout=0.0,
               att_dropout=0.0, use_memory=True, dim_memory=8,
               memory_updater=updater,
               mailbox_slots=3 if updater == "transformer" else 1)
    jmodel = JDGNN(**cfg)
    b, f = 6, 5
    mfg = JMFG(jnp.zeros(b, jnp.int32), jnp.zeros(b),
               jnp.zeros((b, f), jnp.int32), jnp.zeros((b, f)),
               jnp.zeros((b, f)), jnp.zeros((b, f), jnp.int32),
               jnp.ones((b, f), bool))
    mem = jmemory.init_memory(10, 8, 6, mailbox_slots=cfg["mailbox_slots"])
    # the JAX tree's names and shapes (traced, not compiled) are the
    # port's; both sides then run on the port's seeded weights
    shapes = jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0)}, [[mfg]],
        [jnp.zeros((b * (1 + f), dim_node))], [[jnp.zeros((b, f, 6))]],
        jmemory.prepare_input(mem, mfg))["params"]
    model = DGNN(**cfg, device="cpu")
    params = flax_param_tree(model)
    assert _shapes(params) == _shapes(shapes)
    return jmodel, params, model, cfg["mailbox_slots"]


@pytest.mark.parametrize("updater, path, dim_node", [
    ("gru", "per_instance", 12), ("gru", "dedup", 12),
    ("gru", "per_instance", 8),                 # dim_node == dim_memory
    ("transformer", "table", 12), ("transformer", "per_instance", 12),
    ("transformer", "dedup", 12)])
def test_memory_updater_node_features_match_jax(updater_models, updater,
                                                path, dim_node):
    """The GRU (TGN) and transformer (APAN) updaters with node features,
    through ``node_feat_proj`` (none where the widths agree): output and
    ``last_updated`` on each input; on the dedup the unique pairs'
    features come from the table."""
    rng = np.random.RandomState(2)
    jmodel, params, model, slots = updater_models(updater, dim_node)
    assert (model.updater.node_feat_proj is None) == (dim_node == 8)
    table = rng.randn(25, dim_node).astype(np.float32)
    mem = _filled_memory(rng, 25, slots)
    jmem = _jax_memory(mem)
    mfg, jmfg = _mfgs(rng, 25)
    nf = fetch_node_features([[mfg]], torch.from_numpy(table))[0]
    jnf = jfetch_features([[jmfg]], jnp.asarray(table), None, dim_node)[0][0]
    if path == "table":
        inp, jinp = memory_lib.RawMemoryInput(mem), \
            jmemory.RawMemoryInput(state=jmem)
    elif path == "per_instance":
        inp = memory_lib.prepare_input(mem, mfg)
        jinp = jmemory.prepare_input(jmem, jmfg)
    else:
        d = dedup_instances(mfg.all_nodes(), mfg.all_ts(), mfg.all_mask(),
                            256)
        jd = jdedup(jmfg.all_nodes(), jmfg.all_ts(), jmfg.all_mask(), 256)
        inp = memory_lib.DedupMemoryInput(mem, d[0], d[1], d[2], d[4], d[5],
                                          node_feats=torch.from_numpy(table))
        jinp = jmemory.DedupMemoryInput(
            state=jmem, uniq_nids=jd[0], uniq_ts=jd[1], inv=jd[2],
            sidx=jd[4], rank_sorted=jd[5], node_feats=jnp.asarray(table),
            dim_node=dim_node)
        nf, jnf = None, None
    h, last = model.updater(mfg, inp, nf)
    jh, jlast = jax.jit(lambda p, m, i, n: jmodel.apply(
        {"params": p}, m, i, n, method=lambda mdl, *a: mdl.updater(*a)))(
            params, jmfg, jinp, jnf)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5)
    for k, v in last.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jlast[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_tgat_with_node_input_matches_jax():
    """TGAT whose first layer takes 16-dim node features: logits, loss and
    gradients of one training forward and backward on a uniform sample
    (f32, dropout 0)."""
    train, _, _, full, nf, ef = _static_stream()
    g, jg = _static_graphs(full)
    cfg = dict(dim_node=DIM_NODE, dim_edge=8, dim_time=8, dim_embed=EMBED,
               num_layers=2, num_snapshots=1, att_head=2, dropout=0.0,
               att_dropout=0.0, use_memory=False)
    jtrainer = JTrainer(JDGNN(**cfg), fanouts=list(STATIC_FANOUTS),
                        sample_strategy="uniform", layer_dedup=None)
    jdg = jg.device_graph()
    b = _static_batch(train, 1)
    key = jax.random.PRNGKey(6)
    jmfgs = jtrainer._sample(jdg, jnp.asarray(b.target_nodes, jnp.int32),
                             jnp.asarray(b.ts), key)
    jnfs, jefs = jfetch_features(jmfgs, jnp.asarray(nf), jnp.asarray(ef),
                                 DIM_NODE, 8)
    params = jax.tree.map(np.asarray, jax.jit(JDGNN(**cfg).init)(
        jax.random.PRNGKey(0), jmfgs, jnfs, jefs)["params"])
    model = DGNN(**cfg, device="cpu")
    load_flax_params(model, params)
    assert model.layers["l0h0"].w_q.kernel.shape == (DIM_NODE + 8, EMBED)
    run = jax.jit(lambda p, m, e, v, n: jtrainer._run_model(
        SimpleNamespace(params=p), m, e, jax.random.PRNGKey(2), v, True,
        None, n))
    jloss, jpos, _, _, jgrads = run(params, jmfgs, jefs, jvalid_mask(b),
                                    jnfs)
    trainer = Trainer(model, fanouts=list(STATIC_FANOUTS),
                      sample_strategy="uniform", layer_dedup=None,
                      device="cpu")
    trainer._uniform = lambda gen, shape, n=iter(range(2)): \
        torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, next(n)), shape, dtype=jnp.float32)))
    st = trainer.init_state(g.max_vertex_id() + 1)
    tnf = torch.from_numpy(nf)
    mfgs, efs, _, _, valid, _ = trainer._inputs(
        st, g.device_graph("cpu"), torch.from_numpy(ef), b, node_feats=tnf)
    for a, w in zip(mfgs, jmfgs):
        _assert_mfgs_identical(a[0], w[0])
    pos, neg, _ = model(mfgs, efs, train=True,
                        node_feats=trainer._node_inputs(mfgs, None, tnf,
                                                        True))
    loss = link_pred_loss(pos, neg, valid)
    loss.backward()
    np.testing.assert_allclose(pos.detach().numpy(), np.asarray(jpos),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    for n, p in model.named_parameters():
        w = want.pop(_flax_path(n))
        assert np.abs(p.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max(), n
    assert not want


def _tgn_node_run(dedup_factor):
    """The port's TGN (12-dim node features through ``node_feat_proj``)
    over the four train batches of tests/test_torch_train.py: the dedup's
    unique counts, and losses, logits, parameters and memory after each
    step."""
    _, _, _, full, _, ef = _stream()
    nf = np.random.RandomState(3).randn(int(full.dst.max()) + 1, 12) \
        .astype(np.float32)
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = DGNN(dim_node=12, dim_edge=6, dim_time=8, dim_embed=8,
                 num_layers=1, num_snapshots=1, att_head=2, dropout=0.0,
                 att_dropout=0.0, use_memory=True, dim_memory=8, seed=4,
                 device="cpu")
    assert model.updater.node_feat_proj.kernel.shape == (12, 8)
    trainer = Trainer(model, fanouts=[4], dedup_factor=dedup_factor,
                      device="cpu")
    state = trainer.init_state(g.max_vertex_id() + 1)
    dg, steps = g.device_graph("cpu"), []
    for b in _batches(full)[0]:
        state, loss, pos, _ = trainer.train_step(
            state, dg, torch.from_numpy(ef), b,
            node_feats=torch.from_numpy(nf))
        steps.append(dict(loss=float(loss), pos=pos.numpy(),
                          n_uniq=state.dedup_n_uniq,
                          params=_flat(flax_param_tree(model)),
                          memory=state.memory.node_memory.clone()))
    return steps


def test_tgn_node_features_dedup_matches_per_instance():
    """Four TGN train steps with node features on the memory dedup
    (factor 1.0: every step fits) against the per-instance pull: the dedup
    gathers the unique pairs' features from the table, adds their
    projection before the expansion (backward K4 on the card) and writes
    back the memory without them.  Exact but for f32 sum order: losses,
    logits and memory 1e-5, parameters 1e-6.  (The updater's node
    features on both inputs are held against JAX above.)"""
    padded, dedup = _tgn_node_run(None), _tgn_node_run(1.0)
    assert len(dedup) == 4
    for a, d in zip(padded, dedup):
        assert a["n_uniq"] is None and 0 < d["n_uniq"] < 64 * 3 * 5
        np.testing.assert_allclose(d["loss"], a["loss"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(d["pos"], a["pos"], rtol=0, atol=1e-5)
        for k, w in a["params"].items():
            np.testing.assert_allclose(d["params"][k], w, rtol=0, atol=1e-6,
                                       err_msg=str(k))
        np.testing.assert_allclose(d["memory"].numpy(), a["memory"].numpy(),
                                   rtol=0, atol=1e-5)
    assert padded[-1]["memory"].abs().sum() > 0


def test_static_eval_reads_no_edge_features():
    """A static model has no edge features: the trainer gathers none, and
    its eval step runs with the edge-feature table absent."""
    train, _, _, full, nf, ef = _static_stream()
    g, _ = _static_graphs(full)
    trainer = Trainer(_static_models("sage")[0], fanouts=list(STATIC_FANOUTS),
                      layer_dedup=None, is_static=True, device="cpu")
    st = trainer.init_state(g.max_vertex_id() + 1)
    dg, tnf = g.device_graph("cpu"), torch.from_numpy(nf)
    b = _static_batch(train)
    mfgs, efs, *_ = trainer._inputs(st, dg, torch.from_numpy(ef), b,
                                    node_feats=tnf)
    assert all(e is None for layer in efs for e in layer)
    assert float(mfgs[-1][0].root_ts.min()) == STATIC_SAMPLE_TS
    with_ef = trainer.eval_step(st, dg, torch.from_numpy(ef), b,
                                node_feats=tnf)[1]
    without = trainer.eval_step(st, dg, None, b, node_feats=tnf)[1]
    assert float(with_ef) == float(without) and np.isfinite(float(without))
