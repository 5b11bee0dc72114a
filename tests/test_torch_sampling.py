"""gnnflow_tpu_torch recent sampling is bit-identical to
gnnflow_tpu.ops.sampling.sample_layer: padded roots, roots without
history, a root ts equal to an edge ts (strict <), degrees above the
fanout, above 128 and above 16384 (the JAX search's third level), and
each of the JAX pick gathers (fanout <= 43, <= 128, above).

The layer sample's kernel (``csrc/temporal_sample.cu``): on the CPU the
wrapper runs the plain version and launches nothing, the plain version's
edge cases the kernel is held to, and the wrapper's refusals before any
launch.  On a card the kernel against the plain version, bit for bit;
these cases run where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_sampling.py
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DeviceGraph, DynamicGraph
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.ops import sampling
from gnnflow_tpu_torch.train import Trainer
from gnnflow_tpu_torch.utils import profiling
from torch_fixtures import cuda, one_cpu_thread  # noqa: F401

FIELDS = ("root_nids", "root_ts", "nbr_nids", "nbr_ts", "nbr_dts",
          "nbr_eids", "nbr_mask")


def _jax():
    """The JAX side of the parity tests, imported only where they run."""
    jnp = pytest.importorskip("jax.numpy")
    from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
    from gnnflow_tpu.ops import sampling as jsampling
    return SimpleNamespace(jnp=jnp, JGraph=JGraph, jsampling=jsampling)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.RandomState(0)
    n_edges = 24000
    src = rng.randint(0, 60, n_edges)
    src[:17000] = 3                      # hub: degree > 16384
    src[17000:17300] = 8                 # degree > 128
    dst = rng.randint(0, 200, n_edges)
    dst[dst == 77] = 78                  # node 77: no history
    ts = np.floor(rng.rand(n_edges) * 5000).astype(np.float32)  # ties
    ours = DynamicGraph(initial_pool_size=1 << 16, minimum_block_size=8)
    ref = _jax().JGraph(initial_pool_size=1 << 16, minimum_block_size=8)
    for lo in range(0, n_edges, 6000):
        sl = slice(lo, lo + 6000)
        ours.add_edges(src[sl], dst[sl], ts[sl], add_reverse=True)
        ref.add_edges(src[sl], dst[sl], ts[sl], add_reverse=True)
    _, hub_ts, _ = ours.get_temporal_neighbors(3)
    return ours, ref, float(hub_ts[len(hub_ts) // 2])


def _roots(hub_edge_ts):
    rng = np.random.RandomState(1)
    roots = rng.randint(0, 250, 400).astype(np.int64)
    ts = (rng.rand(400) * 5200).astype(np.float32)
    roots[:6] = [-1, -1, 77, 3, 3, 8]    # padded, no history, hub, >128
    ts[3] = hub_edge_ts                  # equal to a stored edge ts
    ts[4] = 1e9                          # after every edge
    roots[6:10] = 3
    ts[6:10] = np.floor(ts[6:10])        # likely equal to edge ts too
    return roots, ts


@pytest.mark.parametrize("fanout", [1, 4, 10, 50, 150])
def test_sample_layer_bit_identical(graphs, fanout):
    jnp, jsampling = _jax().jnp, _jax().jsampling
    ours, ref, hub_edge_ts = graphs
    roots, ts = _roots(hub_edge_ts)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    assert dg.search_iters == jdg.search_iters > 14
    got = sampling.sample_layer(dg, torch.from_numpy(roots),
                                torch.from_numpy(ts), fanout=fanout)
    want = jsampling.sample_layer(jdg, jnp.asarray(roots, jnp.int32),
                                  jnp.asarray(ts), fanout=fanout,
                                  search_iters=jdg.search_iters)
    for name in FIELDS:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert np.array_equal(a, b.astype(a.dtype)), name
        if a.dtype.kind == "f":
            assert a.tobytes() == b.tobytes(), name
    assert not got.nbr_mask[:3].any()    # padded and history-less roots
    assert got.nbr_mask[3:6].all()


@pytest.mark.parametrize("fanout", [4, 10])
def test_sample_hops_one_layer(graphs, fanout):
    jnp, jsampling = _jax().jnp, _jax().jsampling
    ours, ref, hub_edge_ts = graphs
    roots, ts = _roots(hub_edge_ts)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    got = sampling.sample_hops(dg, torch.from_numpy(roots),
                               torch.from_numpy(ts), fanouts=[fanout])
    want = jsampling.sample_hops(jdg, jnp.asarray(roots, jnp.int32),
                                 jnp.asarray(ts), fanouts=[fanout],
                                 search_iters=jdg.search_iters)
    assert len(got) == len(want) == 1 and len(got[0]) == 1
    for name in ("all_nodes", "all_ts", "all_mask"):
        a = getattr(got[0][0], name)().numpy()
        b = np.asarray(getattr(want[0][0], name)())
        assert np.array_equal(a, b.astype(a.dtype)), name


# ---- the layer sample's kernel and its plain version ----------------------

def _hand_graph(runs, device="cpu", gap=3):
    """A DeviceGraph whose node i holds the sorted timestamps ``runs[i]``
    (neighbour ``1000 + slot``, edge id ``slot``), ``gap`` unused slots
    before each run and after the last; unused slots hold ts -7."""
    row_off, row_len, ts = [], [], []
    for r in runs:
        ts += [-7.0] * gap
        row_off.append(len(ts))
        row_len.append(len(r))
        ts += list(r)
    ts += [-7.0] * gap
    slot = np.arange(len(ts))
    return DeviceGraph(
        row_off=torch.tensor(row_off, dtype=torch.int32, device=device),
        row_len=torch.tensor(row_len, dtype=torch.int32, device=device),
        e_dst=torch.from_numpy((1000 + slot).astype(np.int32)).to(device),
        e_ts=torch.tensor(ts, dtype=torch.float32, device=device),
        e_eid=torch.from_numpy(slot.astype(np.int32)).to(device),
        search_iters=max(1, max(map(len, runs)).bit_length()))


def test_wrapper_runs_the_plain_version_on_cpu(monkeypatch):
    def no_kernel():
        raise AssertionError("the kernel was loaded for CPU tensors")
    monkeypatch.setattr(sampling, "_lib", no_kernel)
    g = _hand_graph([[1.0, 2.0, 3.0], []])
    before = sampling.sample_runs.launches
    tracer = profiling.start_tracing()
    try:
        m = sampling.sample_layer(g, torch.tensor([0, 1, -1]),
                                  torch.tensor([9.0, 9.0, 9.0]), fanout=2)
    finally:
        profiling.stop_tracing()
    assert sampling.sample_runs.launches == before
    assert "sampler.kernel_rows" not in tracer.counters
    assert m.nbr_eids.tolist() == [[5, 4], [0, 0], [0, 0]]


ULP_BELOW_1 = float(np.nextafter(np.float32(1), np.float32(0)))


@pytest.mark.parametrize("strategy", ["recent", "uniform"])
def test_plain_edge_cases(strategy):
    """What the kernel is held to: an edge at exactly the end is left out,
    padded roots and empty runs give masked rows, and a draw of 1.0 (or
    one ulp below) takes the oldest candidate."""
    g = _hand_graph([[1.0, 2.0, 2.0, 3.0, 5.0], [], [4.0]])
    roots = torch.tensor([0, 0, 1, -1, 2, 0])
    ts = torch.tensor([3.0, 5.0, 10.0, 10.0, 4.0, 0.5])
    u = torch.tensor([[ULP_BELOW_1, 1.0, 0.0]] * 6)
    m = sampling.sample_layer(g, roots, ts, fanout=3, strategy=strategy,
                              u=u if strategy == "uniform" else None)
    valid = [[True] * 3, [True] * 3] + [[False] * 3] * 4
    # run 0 starts at slot 3; before 3.0 its candidates are slots 3-5,
    # before 5.0 slots 3-6
    want = [[5, 4, 3], [6, 5, 4]] if strategy == "recent" else \
        [[3, 3, 5], [3, 3, 6]]
    assert m.nbr_mask.tolist() == valid
    assert m.nbr_eids[:2].tolist() == want
    assert m.nbr_nids[2:].eq(-1).all() and m.nbr_eids[2:].eq(0).all()
    assert m.nbr_ts[2:].eq(0).all() and m.nbr_dts[2:].eq(0).all()
    assert m.nbr_ts[:2].lt(m.root_ts[:2, None]).all()


def _meta_args():
    g = DeviceGraph(*(torch.empty(n, dtype=d, device="meta") for n, d in (
        (4, torch.int32), (4, torch.int32), (16, torch.int32),
        (16, torch.float32), (16, torch.int32))))
    roots = torch.empty(6, dtype=torch.int64, device="meta")
    ts = torch.empty(6, dtype=torch.float32, device="meta")
    u = torch.empty(6, 3, dtype=torch.float32, device="meta")
    return dict(g=g, roots=roots, root_ts=ts, start=None, end=ts,
                fanout=3, strategy="uniform", prop_time=False, u=u)


REFUSALS = {
    "roots-int32": (TypeError, "roots must be torch.int64",
                    lambda a: dict(a, roots=a["roots"].int())),
    "graph-int64": (TypeError, "row_off", lambda a: dict(
        a, g=dataclasses.replace(a["g"], row_off=a["g"].row_off.long()))),
    "u-shape": (ValueError, "needs u of shape",
                lambda a: dict(a, u=a["u"][:, :2])),
    "u-missing": (ValueError, "needs u of shape",
                  lambda a: dict(a, u=None)),
    "roots-strided": (ValueError, "contiguous", lambda a: dict(
        a, roots=torch.empty(12, dtype=torch.int64, device="meta")[::2])),
    "end-shape": (ValueError, "end must have shape",
                  lambda a: dict(a, end=a["end"][:5])),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_before_launch(monkeypatch, case):
    """Off the CPU the wrapper checks dtypes, shapes and strides before it
    loads or launches anything (meta tensors stand in for a card's)."""
    def no_kernel():
        raise AssertionError("reached the launch")
    monkeypatch.setattr(sampling, "_lib", no_kernel)
    exc, match, change = REFUSALS[case]
    with pytest.raises(exc, match=match):
        sampling.sample_runs(**change(_meta_args()))


# ---- on the card -----------------------------------------------------------

W = 17.0      # integer window over integer timestamps: edges on boundaries


@pytest.fixture(scope="module")
def card_graph():
    """Runs of every length the search treats apart (0, 1, 2, 31, 32, 33,
    1,025), a hub of 100,000 edges (``search_iters`` 17) and 300 runs of
    0-200, integer timestamps with ties; and 2,000 roots, padded ones, roots
    at exactly an edge's timestamp, before and after every edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    rng = np.random.RandomState(5)
    lengths = [0, 1, 2, 31, 32, 33, 1025, 100_000] + \
        list(rng.randint(0, 200, 300))
    span = [rng.randint(5, 3000) for _ in lengths]
    runs = [np.sort(rng.randint(0, s, n)).astype(np.float32)
            for n, s in zip(lengths, span)]
    g = _hand_graph(runs, "cuda")
    assert g.search_iters == 17
    B = 2000
    roots = rng.randint(0, len(runs), B)
    roots[rng.rand(B) < 0.05] = -1
    roots[:len(runs)] = np.arange(len(runs))
    ts = np.array([rng.uniform(-5, span[r] + 5) if r >= 0 else 1.0
                   for r in roots], np.float32)
    on_edge = rng.rand(B) < 0.4
    for i in np.flatnonzero(on_edge & (roots >= 0)):
        if lengths[roots[i]]:
            ts[i] = runs[roots[i]][rng.randint(lengths[roots[i]])] \
                + W * rng.randint(0, 3)
    ts[rng.rand(B) < 0.03] = 1e9
    ts[rng.rand(B) < 0.03] = -1e9
    return g, torch.from_numpy(roots).cuda(), torch.from_numpy(ts).cuda()


def _draws(shape, seed):
    u = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    flat = u.reshape(-1)
    flat[::97] = ULP_BELOW_1
    flat[::89] = 1.0
    flat[::83] = 0.0
    return torch.from_numpy(u).cuda()


def _layer_samples(g, roots, ts, fanout, strategy, prop_time):
    """Every window form on the same inputs: full history, a window, one
    snapshot of three, and three snapshots not shared and shared."""
    uni = strategy == "uniform"
    kw = dict(fanout=fanout, strategy=strategy, prop_time=prop_time)
    B = roots.shape[0]
    u1 = _draws((B, fanout), 1) if uni else None
    u3 = _draws((3, B, fanout), 3) if uni else None
    R = torch.stack([roots, roots.flip(0), roots.roll(7)])
    T = torch.stack([ts, ts.flip(0) + 3 * W, ts.roll(7)])
    return {
        "full": [sampling.sample_layer(g, roots, ts, u=u1, **kw)],
        "window": [sampling.sample_layer(g, roots, ts, window=W, u=u1,
                                         **kw)],
        "snapshot-1-of-3": [sampling.sample_layer(
            g, roots, ts, snapshot_idx=1, num_snapshots=3, window=W, u=u1,
            **kw)],
        "snapshots": sampling.sample_layer_snapshots(
            g, R, T, num_snapshots=3, window=W, u=u3, **kw),
        "snapshots-shared": sampling.sample_layer_snapshots(
            g, roots[None].expand(3, -1), ts[None].expand(3, -1),
            num_snapshots=3, window=W, shared_roots=True, u=u3, **kw)}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [1, 10, 50, 150])
@pytest.mark.parametrize("strategy,prop_time", [
    ("recent", False), ("recent", True), ("uniform", False),
    ("uniform", True)])
def test_kernel_matches_plain_on_card(card_graph, monkeypatch, fanout,
                                      strategy, prop_time):
    g, roots, ts = card_graph
    before = sampling.sample_runs.launches
    got = _layer_samples(g, roots, ts, fanout, strategy, prop_time)
    assert sampling.sample_runs.launches == before + len(got)
    monkeypatch.setattr(sampling, "sample_runs", sampling.sample_runs_ref)
    want = _layer_samples(g, roots, ts, fanout, strategy, prop_time)
    torch.cuda.synchronize()
    for form, mfgs in got.items():
        for s, (a, b) in enumerate(zip(mfgs, want[form])):
            for name in FIELDS:
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype and x.shape == y.shape
                assert torch.equal(_bits(x), _bits(y)), (form, s, name)
    # the cases reach what they are meant to
    full = got["full"][0]
    assert full.nbr_mask.any() and not full.nbr_mask.all()
    assert not full.nbr_mask[roots < 0].any()


@pytest.mark.cuda
def test_one_launch_per_layer_sample_on_card(cuda):
    g = _hand_graph([[1.0, 2.0, 3.0], [], [4.0]], "cuda")
    before = sampling.sample_runs.launches
    sampling.sample_layer(g, torch.tensor([0, 1, 2, -1], device=cuda),
                          torch.full((4,), 9.0, device=cuda), fanout=5)
    assert sampling.sample_runs.launches == before + 1
    # a traced TGN train step samples its 3 x 4000 roots in one launch
    B = 4000
    train, _, _, full, _, ef = data.make_synthetic_dataset(
        num_src=2000, num_dst=500, num_edges=3 * B, dim_edge=8, seed=3,
        train_frac=0.9, val_frac=0.05)
    store = DynamicGraph(initial_pool_size=1 << 15, minimum_block_size=8)
    store.add_edges(full.src, full.dst, full.time, full.eid)
    model = DGNN(dim_node=0, dim_edge=8, dim_time=8, dim_embed=8,
                 num_layers=1, num_snapshots=1, att_head=2, dropout=0.1,
                 att_dropout=0.1, use_memory=True, dim_memory=8, seed=1,
                 device=cuda)
    trainer = Trainer(model, fanouts=[10], device=cuda)
    state = trainer.init_state(store.max_vertex_id() + 1, seed=2)
    neg = data.DstRandEdgeSampler(train.dst, seed=4)
    batches = data.get_batches(train, B, neg)
    dg, ef = store.device_graph(cuda), torch.from_numpy(ef).to(cuda)
    trainer.train_step(state, dg, ef, next(batches))   # calibrates
    tracer = profiling.start_tracing()
    try:
        before = sampling.sample_runs.launches
        trainer.train_step(state, dg, ef, next(batches))
        torch.cuda.synchronize()
    finally:
        profiling.stop_tracing()
    assert tracer.counters["sampler.kernel_rows"] == 3 * B
    assert sampling.sample_runs.launches == before + 1
