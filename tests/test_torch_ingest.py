"""The store's native ingestion helper (``gnnflow_tpu_torch/ops/ingest.py``
over ``csrc/ingest.cc``) against the JAX package's ``gnnflow_tpu.csrc``
and against its own plain NumPy versions, and the store's use of it.

Tolerance: bit equality everywhere (orders, counts, pools).  JAX's
functions run its built ``libingest.so`` where there is one and its NumPy
fallback otherwise; both give the same bits.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gnnflow_tpu import csrc as jcsrc
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.ops import _build, ingest
from torch_fixtures import one_cpu_thread  # noqa: F401


def _sort_case(name):
    rng = np.random.RandomState(7)
    n = 3000
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    if name == "single":
        return np.array([5], np.int64), np.array([2.5], np.float32)
    src = rng.randint(0, 200, n)
    if name == "sparse_ids":
        src = rng.choice(np.array([0, 3, 999_983, 1_000_000, 41]), n)
    if name == "one_source":
        src = np.full(n, 17)
    ts = np.sort(rng.rand(n) * 1e4).astype(np.float32)
    if name in ("shuffled", "sparse_ids", "one_source"):
        ts = rng.permutation(ts)
    if name == "equal_ts":
        ts = np.full(n, 3.0, np.float32)
    return src.astype(np.int64), ts


@pytest.mark.parametrize("name", ["chronological", "shuffled", "equal_ts",
                                  "one_source", "sparse_ids", "empty",
                                  "single"])
def test_group_sort_matches_jax_and_plain(name):
    src, ts = _sort_case(name)
    got = ingest.group_sort_edges(src, ts)
    assert got.dtype == np.int64 and got.shape == src.shape
    assert np.array_equal(got, ingest.group_sort_edges_ref(src, ts))
    assert np.array_equal(got, jcsrc.group_sort_edges(src, ts))


def _pool():
    """A time-sorted pool of 40 ranges with ties, some of length 0."""
    rng = np.random.RandomState(3)
    lengths = rng.randint(0, 30, 40)
    lengths[[0, 7, 39]] = 0
    off = np.concatenate([[5], 5 + np.cumsum(lengths + 2)[:-1]])
    pool = rng.rand(int(off[-1] + lengths[-1] + 4)).astype(np.float32) * 9
    for o, n in zip(off, lengths):
        pool[o:o + n] = np.sort(rng.randint(0, 6, n)).astype(np.float32)
    return pool, off.astype(np.int64), lengths.astype(np.int64)


@pytest.mark.parametrize("target", [-1.0, 0.0, 2.0, 2.5, 5.0, 7.0, 1e9])
def test_ranged_lower_bound_matches_jax_and_plain(target):
    """Below every entry, equal to entries (ties give the first), between
    them and above every entry; zero-length ranges give 0."""
    pool, off, lengths = _pool()
    t = np.float32(target)
    got = ingest.ranged_lower_bound(pool, off, lengths, t)
    assert got.dtype == np.int64
    assert np.array_equal(got, ingest.ranged_lower_bound_ref(
        pool, off, lengths, t))
    assert np.array_equal(got, jcsrc.ranged_lower_bound(pool, off, lengths,
                                                        t))
    want = [int((pool[o:o + n] < t).sum()) for o, n in zip(off, lengths)]
    assert got.tolist() == want
    assert not got[lengths == 0].any()


def test_resort_range_in_place_and_stable():
    rng = np.random.RandomState(11)
    ts = rng.randint(0, 8, 500).astype(np.float32)
    dst = np.arange(500, dtype=np.int32)
    eid = rng.randint(0, 10_000, 500).astype(np.int32)
    off, length = 37, 300
    pools = [tuple(a.copy() for a in (ts, dst, eid)) for _ in range(3)]
    ingest.resort_range(*pools[0], off, length)
    ingest.resort_range_ref(*pools[1], off, length)
    jcsrc.resort_range(*pools[2], off, length)
    for a, b, c in zip(*pools):
        assert a.tobytes() == b.tobytes() == c.tobytes()
    rts, rdst, reid = pools[0]
    sl = slice(off, off + length)
    assert np.all(np.diff(rts[sl]) >= 0)
    # stable: equal times keep their order (dst was increasing)
    for t in np.unique(rts[sl]):
        assert np.all(np.diff(rdst[sl][rts[sl] == t]) > 0)
    outside = np.r_[0:off, off + length:500]
    assert np.array_equal(rts[outside], ts[outside])
    assert np.array_equal(reid[outside], eid[outside])


@settings(max_examples=40, deadline=None, database=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(0, 300),
       st.integers(1, 60), st.integers(1, 20))
def test_helper_equals_plain_on_random_streams(seed, n, num_src, num_ts):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, num_src, n).astype(np.int64)
    ts = rng.randint(0, num_ts, n).astype(np.float32)
    order = ingest.group_sort_edges(src, ts)
    assert np.array_equal(order, np.lexsort((ts, src)))
    # the grouped stream is the pool: one range per source
    counts = np.bincount(src, minlength=num_src)
    off = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    pool = ts[order]
    target = np.float32(rng.randint(-1, num_ts + 1))
    assert np.array_equal(
        ingest.ranged_lower_bound(pool, off, counts, target),
        ingest.ranged_lower_bound_ref(pool, off, counts, target))
    a = [ts.copy(), src.astype(np.int32), np.arange(n, dtype=np.int32)]
    b = [x.copy() for x in a]
    lo = rng.randint(0, n + 1)
    hi = rng.randint(lo, n + 1)
    ingest.resort_range(*a, lo, hi - lo)
    ingest.resort_range_ref(*b, lo, hi - lo)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


def test_store_reaches_only_the_helper(monkeypatch):
    """Ingestion from the constructor, out-of-order chunks into both
    insertion policies and eviction run the built helper: ``np.lexsort``
    and the plain versions raise if called."""
    calls = {}
    for name in ("group_sort_edges", "ranged_lower_bound", "resort_range"):
        fn = getattr(ingest, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(ingest, name, counted)

        def refuse(*args, _name=name):
            raise AssertionError(f"{_name}'s plain version was called")
        monkeypatch.setattr(ingest, name + "_ref", refuse)

    def no_lexsort(*args, **kwargs):
        raise AssertionError("np.lexsort was called")
    monkeypatch.setattr(np, "lexsort", no_lexsort)

    rng = np.random.RandomState(5)
    src, dst = rng.randint(0, 50, 600), rng.randint(0, 50, 600)
    ts = np.sort(rng.rand(600) * 100).astype(np.float32)
    for policy in ("insert", "replace"):
        g = DynamicGraph(initial_pool_size=1024, minimum_block_size=4,
                         insertion_policy=policy, source_vertices=src[200:],
                         target_vertices=dst[200:], timestamps=ts[200:],
                         add_reverse=True)
        g.add_edges(src[:200], dst[:200], ts[:200], add_reverse=True)
        assert g.offload_old_blocks(50.0) > 0
        for v in g.nodes():
            assert np.all(np.diff(g.get_temporal_neighbors(v)[1]) <= 0)
    assert calls["group_sort_edges"] == 4
    assert calls["ranged_lower_bound"] == 2
    assert calls["resort_range"] > 0


@pytest.mark.parametrize("cxx", ["/bin/false", "/nonexistent/g++"])
def test_failed_build_raises(cxx, tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="csrc/ingest.cc|failed"):
        _build.build_host("ingest", build_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())
    assert "ingest" not in _build.sources()   # the nvcc build never sees it


def test_bindings_convert_or_refuse():
    rng = np.random.RandomState(2)
    src, ts = rng.randint(0, 30, 400), rng.rand(400) * 50
    # int32 ids, float64 and strided times are converted
    got = ingest.group_sort_edges(src.astype(np.int32), ts[::-1][::-1])
    assert np.array_equal(got, np.lexsort((ts.astype(np.float32), src)))
    with pytest.raises(ValueError, match="non-negative"):
        ingest.group_sort_edges(np.array([1, -1]), np.zeros(2))
    with pytest.raises(ValueError, match="entries"):
        ingest.group_sort_edges(np.array([1, 2]), np.zeros(3))
    pool, off, lengths = _pool()
    with pytest.raises(ValueError, match="scalar"):
        ingest.ranged_lower_bound(pool, off, lengths, np.zeros(len(off)))
    with pytest.raises(ValueError, match="outside"):
        ingest.ranged_lower_bound(pool, off + len(pool), lengths, 1.0)
    p32 = [np.zeros(10, np.float32), np.zeros(10, np.int32),
           np.zeros(10, np.int32)]
    with pytest.raises(TypeError, match="pool_dst"):
        ingest.resort_range(p32[0], np.zeros(10, np.int64), p32[2], 0, 5)
    with pytest.raises(TypeError, match="pool_ts"):
        ingest.resort_range(np.zeros(20, np.float32)[::2], *p32[1:], 0, 5)
    with pytest.raises(ValueError, match="outside"):
        ingest.resort_range(*p32, 8, 5)
