"""Datasets, negative sampling and batch iteration.

Counterpart of ``gnnflow_tpu/data.py`` (``EdgeTable``, ``load_dataset``,
``load_feat``, ``make_synthetic_dataset``, ``write_synthetic_dataset``,
``DstRandEdgeSampler``, ``RandEdgeSampler``, ``Batch``, ``get_batches``).
The same seed gives byte-identical arrays, so both packages can run one
stream.  ``load_dataset`` reads, and ``write_synthetic_dataset`` writes,
the reference's ``edges.csv`` with NumPy instead of pandas, which the
port does not import, and so do the chunked and partitioned loaders
(``load_dataset_in_chunks``, ``load_partitioned_dataset``) and the
sharded node-feature load (``load_sharded_node_feat``, ``data.py:103-204``).
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np


def get_project_root_dir() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@dataclass
class EdgeTable:
    """A chronological edge list."""

    src: np.ndarray   # int64 [E]
    dst: np.ndarray   # int64 [E]
    time: np.ndarray  # float32 [E]
    eid: np.ndarray   # int64 [E]

    def __len__(self) -> int:
        return len(self.src)

    def __getitem__(self, sl) -> "EdgeTable":
        return EdgeTable(self.src[sl], self.dst[sl], self.time[sl],
                         self.eid[sl])

    @property
    def max_node(self) -> int:
        """The largest node id, -1 for an empty table."""
        if len(self) == 0:
            return -1
        return int(max(self.src.max(), self.dst.max()))

    def concat(self, other: "EdgeTable") -> "EdgeTable":
        return EdgeTable(np.concatenate([self.src, other.src]),
                         np.concatenate([self.dst, other.dst]),
                         np.concatenate([self.time, other.time]),
                         np.concatenate([self.eid, other.eid]))


def _header(f) -> List[str]:
    """The column names of an ``edges.csv`` header line; an unnamed first
    column (the written index) is ``eid``, as pandas' ``Unnamed: 0``
    renamed (``data.py:94-100``)."""
    header = f.readline().rstrip("\r\n").split(",")
    return ["eid" if h in ("", "Unnamed: 0") else h for h in header]


def _parse_edges(path: str, names: List[str], lines,
                 offset: int = 0) -> Tuple[EdgeTable, np.ndarray]:
    """The edges and ``ext_roll`` column of comma separated ``lines``
    under ``names``; without an ``eid`` column the edge id is the row
    number counted from ``offset``."""
    cols = np.loadtxt(lines, delimiter=",", dtype=np.float64, ndmin=2)
    if cols.shape[1] != len(names):
        raise ValueError(f"{path}: {cols.shape[1]} columns, header names "
                         f"{len(names)}")
    col = {n: cols[:, i] for i, n in enumerate(names)}
    eid = col["eid"] if "eid" in col \
        else np.arange(offset, offset + len(cols))
    return EdgeTable(src=col["src"].astype(np.int64),
                     dst=col["dst"].astype(np.int64),
                     time=col["time"].astype(np.float32),
                     eid=eid.astype(np.int64)), \
        col["ext_roll"].astype(np.int64)


def _read_edges_csv(path: str) -> Tuple[EdgeTable, np.ndarray]:
    """The edges and ``ext_roll`` column of a pandas-written ``edges.csv``:
    a header row, comma separated numbers; the edge id is the unnamed
    first column where there is one, else the row number."""
    with open(path) as f:
        names = _header(f)
        return _parse_edges(path, names, f)


def _data_dir(data_dir: Optional[str]) -> str:
    return data_dir if data_dir is not None \
        else os.path.join(get_project_root_dir(), "data")


def load_dataset(dataset: str, data_dir: Optional[str] = None) \
        -> Tuple[EdgeTable, EdgeTable, EdgeTable, EdgeTable]:
    """Load ``<data_dir>/<dataset>/edges.csv`` and split it by
    ``ext_roll`` (``data.py:82-100``): ``(train, val, test, full)``."""
    if data_dir is None:
        data_dir = os.path.join(get_project_root_dir(), "data")
    path = os.path.join(data_dir, dataset, "edges.csv")
    if not os.path.exists(path):
        raise ValueError(f"{path} does not exist")
    full, ext_roll = _read_edges_csv(path)
    train_end = int(np.searchsorted(ext_roll, 1))
    val_end = int(np.searchsorted(ext_roll, 2))
    return full[:train_end], full[train_end:val_end], full[val_end:], full


def load_dataset_in_chunks(dataset: str, chunksize: int,
                           data_dir: Optional[str] = None
                           ) -> Iterator[Tuple[EdgeTable, np.ndarray]]:
    """Stream ``<data_dir>/<dataset>/edges.csv`` in chunks of
    ``chunksize`` rows (``data.py:103-115``): ``(EdgeTable, ext_roll)``
    per chunk; without an index column the edge ids continue across the
    chunks."""
    path = os.path.join(_data_dir(data_dir), dataset, "edges.csv")
    offset = 0
    with open(path) as f:
        names = _header(f)
        while True:
            lines = list(itertools.islice(f, chunksize))
            if not lines:
                return
            yield _parse_edges(path, names, lines, offset)
            offset += len(lines)


def load_partitioned_dataset(dataset: str, data_dir: Optional[str] = None,
                             rank: int = 0, world_size: int = 1,
                             partition_train_data: bool = False):
    """This rank's pre-partitioned splits,
    ``edges_{train,val,test}_<world_size>_<rank>.csv``
    (``data.py:137-157``): ``(train, val, test)`` edge tables, train None
    with ``partition_train_data``.  Raises ``ValueError`` for a missing
    file."""
    base = os.path.join(_data_dir(data_dir), dataset)

    def read(split):
        path = os.path.join(base, f"edges_{split}_{world_size}_{rank}.csv")
        if not os.path.exists(path):
            raise ValueError(f"{path} does not exist")
        return _read_edges_csv(path)[0]

    train = None if partition_train_data else read("train")
    return train, read("val"), read("test")


def load_sharded_node_feat(dataset: str, group=None, device="cuda",
                           data_dir: Optional[str] = None):
    """The node features of per-machine part files
    ``node_features_<i>.npy`` as a :class:`~gnnflow_tpu_torch.parallel.
    kvstore.ShardedTable` over ``group`` (``data.py:160-204``):
    ``(table, total_rows)``.  Each part is memory-mapped and only the rows
    that overlap this rank's block are copied into it (f32, zero rows past
    the table), so no rank materialises the whole table.  Raises
    ``ValueError`` where there is no part."""
    from gnnflow_tpu_torch.common import resolve_device
    from gnnflow_tpu_torch.parallel.dist_context import (group_rank,
                                                         group_size)
    from gnnflow_tpu_torch.parallel.kvstore import ShardedTable
    base = os.path.join(_data_dir(data_dir), dataset)
    parts = []
    while os.path.exists(os.path.join(base,
                                      f"node_features_{len(parts)}.npy")):
        parts.append(np.load(os.path.join(
            base, f"node_features_{len(parts)}.npy"), mmap_mode="r"))
    if not parts:
        raise ValueError(f"no node_features_*.npy parts under {base}")
    offs = np.cumsum([0] + [p.shape[0] for p in parts])
    total, dim = int(offs[-1]), parts[0].shape[1]
    rows = -(-total // group_size(group))
    lo = group_rank(group) * rows
    block = np.zeros((rows, dim), np.float32)
    for k, p in enumerate(parts):
        s, e = max(lo, int(offs[k])), min(lo + rows, int(offs[k + 1]))
        if s < e:
            block[s - lo: e - lo] = p[s - offs[k]: e - offs[k]]
    return ShardedTable.from_block(block, total, group,
                                   resolve_device(device)), total


def load_feat(dataset: str, data_dir: Optional[str] = None,
              memmap: bool = False):
    """``(node_feats, edge_feats)`` from ``node_features.npy`` and
    ``edge_features.npy``, None where a file is missing
    (``data.py:118-134``); with ``memmap`` each is a read-only memory map
    of its file."""
    if data_dir is None:
        data_dir = os.path.join(get_project_root_dir(), "data")
    mmap_mode = "r" if memmap else None
    out = []
    for name in ("node_features.npy", "edge_features.npy"):
        path = os.path.join(data_dir, dataset, name)
        out.append(np.load(path, mmap_mode=mmap_mode)
                   if os.path.exists(path) else None)
    return tuple(out)


def make_synthetic_dataset(
        num_src: int = 1000, num_dst: int = 200, num_edges: int = 20000,
        dim_node: int = 0, dim_edge: int = 32, seed: int = 0,
        train_frac: float = 0.70, val_frac: float = 0.15,
        bipartite: bool = True, time_scale: float = 1.0,
        recurrence: float = 0.8):
    """Temporal-interaction stream with learnable structure (JODIE-like:
    sources ``[0, num_src)`` revisit a few preferred destinations).

    Returns ``(train, val, test, full, node_feats, edge_feats)``.
    """
    rng = np.random.RandomState(seed)
    src = rng.randint(0, num_src, size=num_edges).astype(np.int64)

    num_pref = 4
    popularity = 1.0 / (np.arange(num_dst) + 1.0)
    popularity /= popularity.sum()
    pref = rng.choice(num_dst, size=(num_src, num_pref), p=popularity)

    revisit = rng.rand(num_edges) < recurrence
    pref_pick = pref[src, rng.randint(0, num_pref, size=num_edges)]
    rand_pick = rng.choice(num_dst, size=num_edges, p=popularity)
    dst = np.where(revisit, pref_pick, rand_pick).astype(np.int64)
    if bipartite:
        dst = dst + num_src

    time = np.cumsum(rng.exponential(time_scale, size=num_edges)) \
        .astype(np.float32)
    eid = np.arange(num_edges, dtype=np.int64)

    full = EdgeTable(src, dst, time, eid)
    train_end = int(num_edges * train_frac)
    val_end = int(num_edges * (train_frac + val_frac))

    num_nodes = num_src + num_dst if bipartite else max(num_src, num_dst)
    if dim_node > 0:
        dst_base = rng.randn(num_dst, dim_node).astype(np.float32)
        src_base = dst_base[pref].mean(axis=1)
        noise = 0.1 * rng.randn(num_nodes, dim_node).astype(np.float32)
        if bipartite:
            node_feats = np.concatenate([src_base, dst_base]) + noise
        else:
            node_feats = noise
            node_feats[:num_src] += src_base[:num_src]
    else:
        node_feats = None
    if dim_edge > 0:
        dst_emb = rng.randn(num_dst, dim_edge).astype(np.float32)
        di = (dst - num_src) if bipartite else dst
        # row chunks: randn consumes the stream in C order, so this equals
        # one call without materializing the whole f64 intermediate
        edge_feats = np.empty((num_edges, dim_edge), np.float32)
        step = max(1, (1 << 24) // dim_edge)
        for lo in range(0, num_edges, step):
            hi = min(lo + step, num_edges)
            edge_feats[lo:hi] = dst_emb[di[lo:hi]]
            edge_feats[lo:hi] += (
                0.1 * rng.randn(hi - lo, dim_edge)).astype(np.float32)
    else:
        edge_feats = None
    return (full[:train_end], full[train_end:val_end], full[val_end:], full,
            node_feats, edge_feats)


def write_synthetic_dataset(dataset_dir: str, **kwargs) -> None:
    """Write :func:`make_synthetic_dataset` (``kwargs``) in the reference's
    on-disk format (``data.py:287-305``): ``edges.csv`` with the index
    column and ``src,dst,time,ext_roll`` (0 train, 1 val, 2 test), and
    ``node_features.npy`` / ``edge_features.npy`` where the stream has
    them.  A time is written as its exact float64 value, which reads back
    to the same float32."""
    train, val, _, full, node_feats, edge_feats = \
        make_synthetic_dataset(**kwargs)
    os.makedirs(dataset_dir, exist_ok=True)
    ext_roll = np.zeros(len(full), dtype=np.int64)
    ext_roll[len(train):len(train) + len(val)] = 1
    ext_roll[len(train) + len(val):] = 2
    with open(os.path.join(dataset_dir, "edges.csv"), "w") as f:
        f.write(",src,dst,time,ext_roll\n")
        for lo in range(0, len(full), 1 << 16):
            sl = slice(lo, lo + (1 << 16))
            f.writelines(
                f"{i},{s},{d},{t!r},{r}\n" for i, s, d, t, r in zip(
                    range(lo, lo + len(full.src[sl])),
                    full.src[sl].tolist(), full.dst[sl].tolist(),
                    full.time[sl].astype(np.float64).tolist(),
                    ext_roll[sl].tolist()))
    if node_feats is not None:
        np.save(os.path.join(dataset_dir, "node_features.npy"), node_feats)
    if edge_feats is not None:
        np.save(os.path.join(dataset_dir, "edge_features.npy"), edge_feats)


class DstRandEdgeSampler:
    """Uniformly sample negative destinations from the set of seen dsts."""

    def __init__(self, dst_list, seed: Optional[int] = None):
        self.seed = seed
        self.dst_list = np.unique(dst_list)
        self.random_state = np.random.RandomState(seed)

    def sample(self, size: int) -> np.ndarray:
        idx = self.random_state.randint(0, len(self.dst_list), size)
        return self.dst_list[idx]

    def reset_random_state(self) -> None:
        self.random_state = np.random.RandomState(self.seed)

    def add_dst_list(self, dst) -> None:
        """Add destinations seen since (the online script's ingest)."""
        self.dst_list = np.unique(np.concatenate((self.dst_list, dst)))


class RandEdgeSampler:
    """Sample random (src, dst) pairs from the seen sources and
    destinations (``data.py:329-346``)."""

    def __init__(self, src_list, dst_list, seed: Optional[int] = None):
        self.seed = seed
        self.src_list = np.unique(src_list)
        self.dst_list = np.unique(dst_list)
        self.random_state = np.random.RandomState(seed)

    def sample(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        src_idx = self.random_state.randint(0, len(self.src_list), size)
        dst_idx = self.random_state.randint(0, len(self.dst_list), size)
        return self.src_list[src_idx], self.dst_list[dst_idx]

    def reset_random_state(self) -> None:
        self.random_state = np.random.RandomState(self.seed)


@dataclass
class Batch:
    """One link-prediction batch: ``target_nodes`` is ``[src | dst |
    neg]`` ((2+r)·B with ``r`` negatives per edge, the ``r`` negative
    blocks one after the other), ``ts`` the timestamps repeated for each
    block.  Short slices are padded (node id -1, eid 0) and ``num_valid <
    batch_size``."""

    target_nodes: np.ndarray  # int64 [(2+r)B]
    ts: np.ndarray            # float32 [(2+r)B]
    eids: np.ndarray          # int64 [B]
    num_valid: int            # valid positive edges (<= B)

    @property
    def batch_size(self) -> int:
        return len(self.eids)


def _pad_batch(src, dst, neg, ts, eid, batch_size: int) -> Batch:
    n = len(src)
    neg = np.atleast_2d(np.asarray(neg, dtype=np.int64))
    if n < batch_size:
        pad = batch_size - n
        pad_nid = np.full(pad, -1, dtype=np.int64)
        src = np.concatenate([src, pad_nid])
        dst = np.concatenate([dst, pad_nid])
        neg = np.concatenate(
            [neg, np.full((neg.shape[0], pad), -1, np.int64)], axis=1)
        ts = np.concatenate([ts, np.zeros(pad, dtype=np.float32)])
        eid = np.concatenate([eid, np.zeros(pad, dtype=np.int64)])
    r = neg.shape[0]
    target_nodes = np.concatenate([src, dst, neg.reshape(-1)])
    ts_all = np.tile(ts, 2 + r)
    return Batch(target_nodes.astype(np.int64), ts_all.astype(np.float32),
                 eid.astype(np.int64), n)


def get_batches(data: EdgeTable, batch_size: int,
                neg_sampler: Optional[DstRandEdgeSampler] = None,
                num_chunks: int = 0,
                rng: Optional[np.random.RandomState] = None,
                pad: bool = True,
                rank: int = 0, world_size: int = 1,
                neg_sample_ratio: int = 1,
                interleave_indices: bool = False) -> Iterator[Batch]:
    """Iterate fixed-size batches over a chronological edge table
    (``data.py:393-451``).

    ``num_chunks > 0`` skips a random multiple of ``batch_size //
    num_chunks`` edges at the front (the reference's random epoch start).

    ``world_size > 1`` splits the batches over ranks: by default rank r
    takes every ``world_size``-th whole batch, counted from the start, so
    each rank's stream stays chronological; ``interleave_indices`` gives
    ``DistributedBatchSampler``'s split, rank r taking the edges whose
    index is ``r`` modulo ``world_size`` (counted from the start) and
    packing ``batch_size`` of them per batch.

    ``neg_sample_ratio`` r draws ``r·k`` negatives for a slice of ``k``
    edges in one call, laid out ``[r, k]`` (so ``target_nodes`` is
    ``[(2+r)·B]``); ``pad=False`` leaves a short last slice unpadded.
    """
    start = 0
    if num_chunks > 0:
        if rng is None:
            rng = np.random.RandomState()
        start = rng.randint(0, num_chunks) * (batch_size // num_chunks)
    n = len(data)

    def selections():
        if interleave_indices and world_size > 1:
            idx = np.arange(start + ((rank - start) % world_size), n,
                            world_size)
            for lo in range(0, len(idx), batch_size):
                yield idx[lo: lo + batch_size]
        else:
            for i, lo in enumerate(range(start, n, batch_size)):
                if i % world_size == rank:
                    yield np.arange(lo, min(lo + batch_size, n))

    for sel in selections():
        k = len(sel)
        if neg_sampler is not None:
            neg = neg_sampler.sample(neg_sample_ratio * k) \
                .reshape(neg_sample_ratio, k)
        else:
            neg = np.full((neg_sample_ratio, k), -1, dtype=np.int64)
        yield _pad_batch(data.src[sel], data.dst[sel], neg, data.time[sel],
                         data.eid[sel], batch_size if pad else k)
