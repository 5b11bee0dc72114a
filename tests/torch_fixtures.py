"""What the port's tests share that needs no JAX to import: the
fixtures, the tiny TGN stream and its configuration, the sampling store,
and checks on MFGs and parameter trees.  This module imports neither JAX
nor the tests' ``conftest.py``, so the card cases can import it where JAX
is not installed (``python -m pytest --noconftest``), and so can the
ranks that ``torch_ranks`` runs; the sampling store imports the JAX
package only when a CPU parity test asks for it.  The test files import
it as a sibling module (pytest puts ``tests/`` on ``sys.path``), since
``tests`` itself may not import as a package there."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnnflow_tpu_torch import data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph

FIELDS = ("root_nids", "root_ts", "nbr_nids", "nbr_ts", "nbr_dts",
          "nbr_eids", "nbr_mask")
# TGN on a tiny stream, the parity tests' and the two-rank tests'
CFG = dict(dim_node=0, dim_edge=6, dim_time=8, dim_embed=8, num_layers=1,
           num_snapshots=1, att_head=2, dropout=0.0, att_dropout=0.0,
           use_memory=True, dim_memory=8)
B = 64


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Run the plain versions on one CPU thread.  On a CPU host with
    AVX-512 and AMX, the first multi-threaded f32 matmul of a process that
    also runs JAX has returned one thread's 64-row block ~1e-4 off (3 of
    10 processes); on one thread the values are the same in every
    process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stream():
    return data.make_synthetic_dataset(num_src=60, num_dst=20,
                                       num_edges=600, dim_edge=6, seed=5)


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


def _flat(tree, prefix=()):
    """A nested parameter tree as ``{path: array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_mfgs_identical(got, want):
    """A port MFG equal to a JAX one field by field, floats bit for bit."""
    for name in FIELDS:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert np.array_equal(a, b.astype(a.dtype)), name
        if a.dtype.kind == "f":
            assert a.tobytes() == b.tobytes(), name
