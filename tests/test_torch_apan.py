"""APAN: the port against the JAX package, f32, on numpy-seeded inputs
and the tiny stream of tests/test_torch_slice.py (batch 64; edge, time,
memory and embedding dims 6/8/8/8; 3 mail slots; fanout 5; dropout 0),
with the weights carried across by ``load_flax_params``.

Tolerances:
- the circular mailbox write: bit-equal (it only moves values).
- ``apan_table_pull`` in f32: forward within 1e-6 of the JAX function
  (exact gathers of f32 products summed in other orders); in bf16 within
  1e-2 (a product one bf16 ulp apart).  The kernel's gradient within 1e-5
  relative of the JAX custom VJP's and of the port's plain per-instance
  version's (f32 sums over L·S rows in other orders).
- the updater on its table, per-instance and dedup inputs (3 slots; the
  first two also with 1): output and ``last_updated`` within 1e-5
  absolute.
- four train steps against the JAX ``Trainer``: losses, logits and
  parameters within 1e-5 (an Adam step is lr 1e-4; its first step is
  ``lr·sign(g)``, so a gradient element near 0 whose two sums part takes
  a different share of it: 5.8e-6 measured); memory and mails within 1e-4,
  as tests/test_torch_train.py holds TGN's; timestamps and slot cursors
  equal.  Memory cannot be held tighter in f32: each step's memory comes
  out of a LayerNorm over 8 values and feeds the next step's mails, and
  on the fourth step a rescaling of the parameters by ``1 + 1e-7·N(0,
  1)`` alone moves one step's memory by 2.5e-5 to 3.9e-5 in the port
  (measured from JAX's state at that step); the port and JAX part by
  1.3e-5 there.
- the calibration: the same unique fraction and factor as JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu.common import MFG as JMFG
from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.models import memory as jmemory
from gnnflow_tpu.models.dgnn import DGNN as JDGNN
from gnnflow_tpu.ops.apan_kv import apan_table_pull as japan_pull
from gnnflow_tpu.ops.dedup import dedup_instances as jdedup
from gnnflow_tpu.train import Trainer as JTrainer
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.weights import (flax_param_tree,
                                              load_flax_params)
from gnnflow_tpu_torch.ops.apan_kv import (apan_table_pull,
                                           apan_table_pull_ref)
from gnnflow_tpu_torch.ops.dedup import dedup_instances
from gnnflow_tpu_torch.train import Trainer, dedup_factor_for
from torch_fixtures import one_cpu_thread  # noqa: F401
from torch_fixtures import _flat, _stream
from torch_parity import interpret_attention  # noqa: F401
from torch_parity import (_assert_memory, _batches, _filled_memory,
                          _jax_memory, _mfgs, _np, jax_state)

S = 3
APAN = dict(dim_node=0, dim_edge=6, dim_time=8, dim_embed=8, num_layers=1,
            num_snapshots=1, att_head=2, dropout=0.0, att_dropout=0.0,
            use_memory=True, dim_memory=8, memory_updater="transformer",
            mailbox_slots=S)


@pytest.mark.parametrize("slots", [1, S])
def test_update_mem_mail_bit_equal_to_jax(slots):
    """Five write-backs with repeated, negative (padded roots) and padded
    (invalid batch rows) ids."""
    rng = np.random.RandomState(slots)
    n, b, dm, de = 40, 30, 8, 6
    mem = memory_lib.init_memory(n, dm, de, "cpu", slots)
    jmem = jmemory.init_memory(n, dm, de, mailbox_slots=slots)
    jupdate = jax.jit(jmemory.update_mem_mail)
    for step in range(5):
        nid = rng.randint(0, 12, 3 * b)          # few ids: many repeats
        nid[rng.rand(3 * b) < 0.1] = -1
        memv = rng.randn(3 * b, dm).astype(np.float32)
        ts = (rng.rand(3 * b) * 100 + 100 * step).astype(np.float32)
        ef = rng.randn(b, de).astype(np.float32)
        valid = np.arange(b) < b - 4 * (step % 2)
        memory_lib.update_mem_mail(mem, torch.from_numpy(nid),
                                   torch.from_numpy(memv),
                                   torch.from_numpy(ts),
                                   torch.from_numpy(ef),
                                   torch.from_numpy(valid))
        jmem = jupdate(jmem, jnp.asarray(nid, jnp.int32), jnp.asarray(memv),
                       jnp.asarray(ts), jnp.asarray(ef), jnp.asarray(valid))
        _assert_memory(mem, jmem, atol=0)
    if slots > 1:
        # the cursor advanced once per written node per step
        assert 0 < int(mem.mailbox_ptr.max()) <= 5
    else:
        assert not mem.mailbox_ptr.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apan_table_pull_matches_jax(dtype):
    rng = np.random.RandomState(0)
    n, dm, dr, L = 30, 8, 22, 200
    mem = rng.randn(n, dm).astype(np.float32)
    mails = rng.randn(n, S, dr).astype(np.float32)
    mts = (rng.rand(n, S) * 900).astype(np.float32)
    kern = (rng.randn(dr, 2 * dm) * 0.3).astype(np.float32)
    nids = rng.randint(0, n, L)
    d_kv = rng.randn(L, S, 2 * dm).astype(np.float32)
    table = np.concatenate([mails, mts[..., None]], -1).reshape(n * S, -1)

    def jfn(k):
        return japan_pull(jnp.asarray(mem), jnp.asarray(table), k,
                          jnp.asarray(nids, jnp.int32), S, dr, dtype)

    jout, vjp = jax.vjp(jfn, jnp.asarray(kern))
    cdt = getattr(torch, dtype)
    (jdw,) = vjp((jnp.zeros_like(jout[0]),
                  jnp.asarray(d_kv).astype(jout[1].dtype),
                  jnp.zeros_like(jout[2])))
    kt = torch.from_numpy(kern).requires_grad_()
    args = (torch.from_numpy(mem), torch.from_numpy(mails),
            torch.from_numpy(mts))
    out = apan_table_pull(*args, kt, torch.from_numpy(nids), cdt)
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert out[0].dtype == out[1].dtype == cdt
    assert out[2].dtype == torch.float32
    for got, want in zip(out, jout):
        np.testing.assert_allclose(_np(got.float()),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    assert np.array_equal(_np(out[2]), np.asarray(jout[2]))
    out[1].backward(torch.from_numpy(d_kv).to(cdt))
    dw = kt.grad.numpy()
    assert kt.grad.dtype == torch.float32
    scale = np.abs(np.asarray(jdw)).max()
    assert np.abs(dw - np.asarray(jdw)).max() <= 1e-5 * scale
    if dtype == "float32":
        kr = torch.from_numpy(kern).requires_grad_()
        ref = apan_table_pull_ref(*args, kr, torch.from_numpy(nids))
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.detach().numpy(),
                                       want.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)
        ref[1].backward(torch.from_numpy(d_kv))
        assert np.abs(dw - kr.grad.numpy()).max() <= 1e-5 * scale


@pytest.fixture(scope="module")
def models():
    """A JAX APAN DGNN with its initial parameters, and the port's DGNN
    with the same weights."""
    return _models()


def _models(cfg=APAN):
    jmodel = JDGNN(**cfg, gru_impl="pallas", attention_impl="pallas")
    init = JDGNN(**cfg, gru_impl="pallas").init     # the same tree
    params = jax.tree.map(np.asarray, jax.jit(init)(
        {"params": jax.random.PRNGKey(0)}, *_dummy_inputs(cfg))["params"])
    model = DGNN(**cfg, device="cpu")
    load_flax_params(model, params)
    return jmodel, params, model


def _dummy_inputs(cfg, b=6, f=5):
    mfg = JMFG(jnp.zeros(b, jnp.int32), jnp.zeros(b), jnp.zeros((b, f),
               jnp.int32), jnp.zeros((b, f)), jnp.zeros((b, f)),
               jnp.zeros((b, f), jnp.int32), jnp.ones((b, f), bool))
    mem = jmemory.init_memory(10, cfg["dim_memory"], cfg["dim_edge"],
                              mailbox_slots=cfg["mailbox_slots"])
    return [[mfg]], [None], [[jnp.zeros((b, f, cfg["dim_edge"]))]], \
        jmemory.prepare_input(mem, mfg)


@pytest.mark.parametrize("path", ["table", "per_instance", "dedup",
                                  "table_one_slot", "per_instance_one_slot"])
def test_transformer_updater_matches_jax(interpret_attention, models,
                                        path):
    rng = np.random.RandomState(1)
    slots = 1 if path.endswith("one_slot") else S
    jmodel, params, model = models if slots == S else \
        _models({**APAN, "mailbox_slots": 1})
    path = path.replace("_one_slot", "")
    mem = _filled_memory(rng, 25, slots)
    jmem = _jax_memory(mem)
    mfg, jmfg = _mfgs(rng, 25)
    if path == "table":
        inp, jinp = memory_lib.RawMemoryInput(mem), \
            jmemory.RawMemoryInput(state=jmem)
    elif path == "per_instance":
        inp = memory_lib.prepare_input(mem, mfg)
        jinp = jmemory.prepare_input(jmem, jmfg)
    else:
        cap = 256
        d = dedup_instances(mfg.all_nodes(), mfg.all_ts(), mfg.all_mask(),
                            cap)
        jd = jdedup(jmfg.all_nodes(), jmfg.all_ts(), jmfg.all_mask(), cap)
        assert int(d[3]) == int(jd[3]) < mfg.num_all
        inp = memory_lib.DedupMemoryInput(mem, d[0], d[1], d[2], d[4], d[5])
        jinp = jmemory.DedupMemoryInput(
            state=jmem, uniq_nids=jd[0], uniq_ts=jd[1], inv=jd[2],
            sidx=jd[4], rank_sorted=jd[5])
    h, last = model.updater(mfg, inp)
    jh, jlast = jax.jit(lambda p, m, i: jmodel.apply(
        {"params": p}, m, i, None, method=lambda mdl, *a: mdl.updater(*a)))(
            params, jmfg, jinp)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               rtol=0, atol=1e-5)
    for k, v in last.items():
        np.testing.assert_allclose(_np(v), np.asarray(jlast[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert not last["last_updated_memory"].requires_grad


def _jax_trainer(full, ef, cfg, **knobs):
    g = JGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = JDGNN(**cfg, gru_impl="pallas", attention_impl="pallas")
    trainer = JTrainer(model, fanouts=[5], sample_strategy="recent",
                       gru_table=False, **knobs)
    state = jax_state(trainer, DGNN(**cfg, device="cpu"),
                      g.max_vertex_id() + 1)
    return trainer, state, g.device_graph()


def _port_trainer(full, params, cfg, **knobs):
    g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4)
    g.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    model = DGNN(**cfg, device="cpu")
    if params is not None:
        load_flax_params(model, params)
    trainer = Trainer(model, fanouts=[5], device="cpu", **knobs)
    return trainer, trainer.init_state(g.max_vertex_id() + 1), \
        g.device_graph("cpu")


@pytest.mark.parametrize("knobs", [
    pytest.param(dict(dedup_factor=None), id="table"),
    pytest.param(dict(dedup_factor=0.7), id="dedup"),
    pytest.param(dict(dedup_factor=None, apan_table=False),
                 id="per_instance")])
def test_apan_train_matches_jax(interpret_attention, knobs):
    """Four train steps (the last batch padded): losses, logits,
    parameters by Flax name, and the memory with every mail slot and
    cursor, after every step (tolerances in the module docstring)."""
    _, _, _, full, _, ef = _stream()
    jtrainer, jstate, jdg = _jax_trainer(full, ef, APAN, **knobs)
    trainer, state, dg = _port_trainer(
        full, jax.tree.map(np.asarray, jstate.params), APAN, **knobs)
    assert trainer.apan_table == jtrainer.apan_table
    jef, tef = jnp.asarray(ef), torch.from_numpy(ef)
    fast = 0
    for b, jb in zip(*_batches(full)):
        jstate, jloss, jpos, jneg = jtrainer.train_step(jstate, jdg, None,
                                                        jef, jb)
        state, loss, pos, neg = trainer.train_step(state, dg, tef, b)
        fast += state.dedup_n_uniq is not None \
            and state.dedup_n_uniq <= trainer._dedup_cap(64 * 3 * 6)
        for got, want in ((loss, jloss), (pos, jpos), (neg, jneg)):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                       atol=1e-5)
        got = _flat(flax_param_tree(trainer.model))
        want = _flat(jax.tree.map(np.asarray, jstate.params))
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5,
                                       err_msg=str(name))
        _assert_memory(state.memory, jstate.memory, atol=1e-4)
    assert fast == (4 if knobs["dedup_factor"] else 0)
    assert int(state.memory.mailbox_ptr.max()) > S   # the slots wrapped


def test_gru_with_slots_reads_the_latest_mail(interpret_attention):
    """A GRU model (TGN's updater) over a 3-slot mailbox: four train steps
    against the JAX trainer's (tolerances of the APAN train test); the GRU
    reads slot (ptr - 1) mod S."""
    cfg = {**APAN, "memory_updater": "gru"}
    _, _, _, full, _, ef = _stream()
    jtrainer, jstate, jdg = _jax_trainer(full, ef, cfg, dedup_factor=None)
    trainer, state, dg = _port_trainer(
        full, jax.tree.map(np.asarray, jstate.params), cfg,
        dedup_factor=None)
    jef, tef = jnp.asarray(ef), torch.from_numpy(ef)
    for b, jb in zip(*_batches(full)):
        jstate, jloss, jpos, _ = jtrainer.train_step(jstate, jdg, None, jef,
                                                     jb)
        state, loss, pos, _ = trainer.train_step(state, dg, tef, b)
        for got, want in ((loss, jloss), (pos, jpos)):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                       atol=1e-5)
        _assert_memory(state.memory, jstate.memory, atol=1e-4)
    # the latest slot, not slot 0, once the cursors have moved on
    mem = state.memory
    pulled = memory_lib.prepare_input_at(mem, torch.arange(mem.num_nodes))
    latest = memory_lib._latest_mail(pulled)
    slot = (mem.mailbox_ptr - 1) % S
    assert torch.equal(latest, mem.mailbox[torch.arange(mem.num_nodes),
                                           slot])
    assert (slot != 0).any()


@pytest.mark.parametrize("u, gru, transformer", [
    (0.04, 0.12, 0.08), (0.08, 0.22, 0.13), (0.2, None, 0.28),
    (0.48, None, 0.63), (0.6, None, None)])
def test_dedup_factor_rules(u, gru, transformer):
    assert dedup_factor_for(u, "gru") == gru
    assert dedup_factor_for(u, "transformer") == transformer


def test_calibrate_takes_the_transformer_rule():
    """The first-batch calibration of an APAN trainer against JAX's on the
    same probes (the batch, and its timestamps shifted to a third, two
    thirds and the end of the stream): a unique fraction that would keep
    TGN's dedup off turns APAN's on."""
    _, _, _, full, _, ef = _stream()
    jtrainer = JTrainer(JDGNN(**APAN), fanouts=[5], sample_strategy="recent")
    jg = JGraph(initial_pool_size=1024, minimum_block_size=4)
    jg.add_edges(full.src, full.dst, full.time, full.eid, add_reverse=True)
    seen = {}
    orig = jtrainer.calibrate
    jtrainer.calibrate = lambda *a, **k: seen.update(orig(*a, **k)) or seen
    trainer, _, dg = _port_trainer(full, None, APAN)
    b = list(_batches(full, len(full))[0])[-2]
    jtrainer._maybe_auto_calibrate(jg.device_graph(), b.target_nodes, b.ts)
    trainer._maybe_auto_calibrate(dg, b.target_nodes, b.ts)
    stats = trainer.calibration
    assert stats["uniq_frac"] == seen["uniq_frac"]
    assert 0.08 < stats["uniq_frac"] <= 0.5
    assert trainer.dedup_factor == jtrainer.dedup_factor == \
        seen["dedup_factor"] == dedup_factor_for(stats["uniq_frac"],
                                                 "transformer")
