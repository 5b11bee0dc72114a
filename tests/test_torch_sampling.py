"""gnnflow_tpu_torch recent sampling is bit-identical to
gnnflow_tpu.ops.sampling.sample_layer: padded roots, roots without
history, a root ts equal to an edge ts (strict <), degrees above the
fanout, above 128 and above 16384 (the JAX search's third level), and
each of the JAX pick gathers (fanout <= 43, <= 128, above)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.ops import sampling as jsampling
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.ops import sampling
from tests.test_torch_kernels import one_cpu_thread  # noqa: F401

FIELDS = ("root_nids", "root_ts", "nbr_nids", "nbr_ts", "nbr_dts",
          "nbr_eids", "nbr_mask")


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
    ref = JGraph(initial_pool_size=1 << 16, minimum_block_size=8)
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
