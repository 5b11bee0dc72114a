"""gnnflow_tpu_torch: import hygiene, and the data layer against the JAX
package (config, metrics, synthetic data, batches, negative sampler and
the dynamic graph's host mirror must be identical for the same seed)."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gnnflow_tpu import config as jconfig
from gnnflow_tpu import data as jdata
from gnnflow_tpu.dynamic_graph import DynamicGraph as JGraph
from gnnflow_tpu.utils import metrics as jmetrics
from gnnflow_tpu_torch import config, data
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.utils import metrics
from torch_fixtures import one_cpu_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gnnflow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pandas", "sklearn",
             "gnnflow_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_no_jax_or_reference_package():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_port_leaves_jax_out_of_sys_modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"print([m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]", out


def test_config_identical():
    for m in jconfig.MODELS:
        for d in jconfig.DATASETS:
            assert config.get_default_config(m, d) == \
                jconfig.get_default_config(m, d)


def test_metrics_identical():
    rng = np.random.RandomState(0)
    y = rng.rand(500) < 0.5
    s = np.round(rng.randn(500), 1)          # ties exercise the grouping
    assert metrics.average_precision_score(y, s) == \
        jmetrics.average_precision_score(y, s)
    assert metrics.roc_auc_score(y, s) == jmetrics.roc_auc_score(y, s)


@pytest.mark.parametrize("kw", [
    dict(num_src=50, num_dst=20, num_edges=700, dim_node=6, dim_edge=5,
         seed=3),
    dict(num_src=40, num_dst=30, num_edges=300, dim_node=0, dim_edge=0,
         seed=9, bipartite=False, time_scale=4.0),
])
def test_synthetic_dataset_identical(kw):
    ours = data.make_synthetic_dataset(**kw)
    ref = jdata.make_synthetic_dataset(**kw)
    for a, b in zip(ours[:4], ref[:4]):
        for field in ("src", "dst", "time", "eid"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for a, b in zip(ours[4:], ref[4:]):
        assert (a is None and b is None) or a.tobytes() == b.tobytes()


@pytest.mark.parametrize("num_chunks", [0, 4])
def test_batches_and_negatives_identical(num_chunks):
    full = data.make_synthetic_dataset(num_src=30, num_dst=10,
                                       num_edges=230, seed=1)[3]
    ours = data.get_batches(full, 64, data.DstRandEdgeSampler(full.dst, 2),
                            num_chunks=num_chunks,
                            rng=np.random.RandomState(5))
    ref = jdata.get_batches(full, 64, jdata.DstRandEdgeSampler(full.dst, 2),
                            num_chunks=num_chunks,
                            rng=np.random.RandomState(5))
    n = 0
    for a, b in zip(ours, ref):
        n += 1
        assert a.num_valid == b.num_valid
        for field in ("target_nodes", "ts", "eids"):
            assert getattr(a, field).tobytes() == getattr(b, field).tobytes()
    assert n >= 3


def _edge_batches():
    rng = np.random.RandomState(4)
    batches = []
    t = 0.0
    for size in (300, 250, 400):
        src = rng.randint(0, 90, size)
        dst = rng.randint(0, 140, size)
        ts = t + np.cumsum(rng.exponential(1.0, size)).astype(np.float32)
        t = float(ts[-1])
        batches.append((src, dst, ts))
    # a late batch that predates stored edges: forces the per-vertex resort
    src = rng.randint(0, 90, 80)
    batches.append((src, rng.randint(0, 140, 80),
                    rng.rand(80).astype(np.float32) * t))
    return batches


@pytest.mark.parametrize("min_block", [1, 4, 16])
def test_dynamic_graph_host_mirror_identical(min_block):
    kw = dict(initial_pool_size=1024, minimum_block_size=min_block)
    ours, ref = DynamicGraph(**kw), JGraph(**kw)
    for src, dst, ts in _edge_batches():
        ours.add_edges(src, dst, ts, add_reverse=True)
        ref.add_edges(src, dst, ts, add_reverse=True)
    for name in ("_dst", "_ts", "_eid", "_row_off", "_row_len", "_row_cap",
                 "_node_seen", "_src_seen", "_eid_seen"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for fn in ("num_vertices", "num_source_vertices", "max_vertex_id",
               "num_edges", "avg_linked_list_length",
               "get_graph_memory_usage", "get_metadata_memory_usage"):
        assert getattr(ours, fn)() == getattr(ref, fn)(), fn
    for fn in ("nodes", "src_nodes", "edges"):
        assert np.array_equal(getattr(ours, fn)(), getattr(ref, fn)()), fn
    probe = np.array([0, 5, 89, 139, 500, -1])
    assert np.array_equal(ours.out_degree(probe), ref.out_degree(probe))
    for v in (0, 7, 120, 4000):
        for a, b in zip(ours.get_temporal_neighbors(v),
                        ref.get_temporal_neighbors(v)):
            assert np.array_equal(a, b)
    dg, jdg = ours.device_graph("cpu"), ref.device_graph()
    assert dg.search_iters == jdg.search_iters
    for name in ("row_off", "row_len", "e_dst", "e_ts", "e_eid"):
        assert np.array_equal(getattr(dg, name).numpy(),
                              np.asarray(getattr(jdg, name))), name


def test_entry_points_refuse_missing_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this check needs a process without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        DynamicGraph().device_graph()


# ---- the root conftest.py: one JAX compilation cache a run ---------------

CACHE_VARS = ("JAX_COMPILATION_CACHE_DIR", "JAX_COMPILATION_CACHE_MAX_SIZE")


def _fresh_python(code, tmp_path, **env):
    """The last line that ``code`` prints in a new interpreter at the
    root of the repository, without this run's cache variables but those
    in ``env``, its temporary files under ``tmp_path``."""
    base = {k: v for k, v in os.environ.items() if k not in CACHE_VARS}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**base, "TMPDIR": str(tmp_path), **env},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("preset", [False, True], ids=["unset", "set"])
def test_root_conftest_gives_each_run_a_cache(tmp_path, preset):
    """Importing the root ``conftest.py`` points JAX at a new, empty
    directory, unless the variable names one already (an xdist worker's
    or a child's, inherited from the run), and imports no JAX."""
    given = str(tmp_path / "given")
    code = ("import json, os, sys\n"
            "import conftest\n"
            "d = os.environ['JAX_COMPILATION_CACHE_DIR']\n"
            "print(json.dumps([d, os.path.isdir(d) and os.listdir(d),\n"
            "    int(os.environ['JAX_COMPILATION_CACHE_MAX_SIZE']),\n"
            "    'jax' in sys.modules]))")
    env = {"JAX_COMPILATION_CACHE_DIR": given} if preset else {}
    d, listing, max_size, jax_imported = _fresh_python(code, tmp_path, **env)
    if preset:
        assert d == given and listing is False
    else:
        assert os.path.dirname(d) == str(tmp_path) and listing == []
    assert max_size > 0 and not jax_imported


def test_root_conftest_refuses_jax_imported_first(tmp_path):
    code = ("import json\n"
            "import jax\n"
            "try:\n"
            "    import conftest\n"
            "except RuntimeError as e:\n"
            "    print(json.dumps(str(e)))")
    assert "JAX_COMPILATION_CACHE_DIR" in _fresh_python(code, tmp_path)


def test_compilation_cache_serves_a_fresh_closure(tmp_path):
    """One program compiled through two fresh ``jax.jit`` closures, as a
    second ``Trainer`` compiles its steps: the first compile writes one
    entry, the second loads it, and the outputs are the same bits."""
    code = ("import json, os\n"
            "import numpy as np\n"
            "import jax, jax.numpy as jnp\n"
            "hits = []\n"
            "jax.monitoring.register_event_listener(\n"
            "    lambda e, **_: hits.append(e) if e.endswith('cache_hits')\n"
            "    else None)\n"
            "x = np.random.RandomState(0).randn(64, 64).astype(np.float32)\n"
            "outs = [np.asarray(jax.jit(lambda a: jnp.tanh(a @ a).sum(0))\n"
            "                   (x)) for _ in range(2)]\n"
            "d = os.environ['JAX_COMPILATION_CACHE_DIR']\n"
            "print(json.dumps([[f for f in os.listdir(d)\n"
            "                   if f.endswith('-cache')], len(hits),\n"
            "                  outs[0].tobytes() == outs[1].tobytes()]))")
    entries, hits, same = _fresh_python(
        code, tmp_path, JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
        JAX_COMPILATION_CACHE_MAX_SIZE=str(1 << 30),
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    assert len(entries) == 1 and hits == 1 and same
