"""The store's ingestion helper: the grouping sort of incoming edges, the
per-range lower bound of eviction and the re-sort of one vertex region.

Counterpart of ``gnnflow_tpu/csrc/__init__.py`` and
``gnnflow_tpu/csrc/ingest.cc``.  Each binding calls the C++ of
``csrc/ingest.cc``, built with the host compiler at first use
(``_build.build_host``) and loaded with ``ctypes``, on NumPy arrays, for
a store on any device: the store's arrays live on the host.  A failed
build raises; there is no NumPy fallback.  Beside each binding stands
its plain NumPy version (``*_ref``), which the store never calls.
"""
from __future__ import annotations

import ctypes

import numpy as np

from gnnflow_tpu_torch.ops import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load_host("ingest")
    if lib.group_sort_edges.argtypes is None:
        # raw pointers: each binding checks dtype, shape and contiguity
        # itself, which costs less than ``ndpointer``'s checks per call
        n, p = ctypes.c_int64, ctypes.c_void_p
        lib.group_sort_edges.argtypes = [n, p, p, p]
        lib.group_sort_edges.restype = None
        lib.ranged_lower_bound.argtypes = [n, p, p, p, ctypes.c_float, p]
        lib.ranged_lower_bound.restype = None
        lib.resort_range.argtypes = [n, n, p, p, p]
        lib.resort_range.restype = None
    return lib


def _vector(x, dtype, what: str) -> np.ndarray:
    """``x`` as a contiguous 1-D array of ``dtype`` (a copy only where it
    is not one already)."""
    x = np.ascontiguousarray(x, dtype=dtype)
    if x.ndim != 1:
        raise ValueError(f"{what} must be 1-D, got shape {x.shape}")
    return x


def group_sort_edges(src: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """The order that groups edges by source, time-sorted inside a group,
    ties in arrival order: int64 ``[n]``, equal to
    ``np.lexsort((ts, src))``.  ``src`` (int64 ids, non-negative) and
    ``ts`` (float32) are converted where they are not so already."""
    src = _vector(src, np.int64, "src")
    ts = _vector(ts, np.float32, "ts")
    if len(src) != len(ts):
        raise ValueError(f"src has {len(src)} entries, ts {len(ts)}")
    if len(src) and src.min() < 0:
        raise ValueError("src ids must be non-negative")
    out = np.empty(len(src), dtype=np.int64)
    _lib().group_sort_edges(len(src), src.ctypes.data, ts.ctypes.data,
                            out.ctypes.data)
    return out


def group_sort_edges_ref(src: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Plain version of :func:`group_sort_edges`."""
    return np.lexsort((ts, src))


def ranged_lower_bound(pool_ts: np.ndarray, off: np.ndarray,
                       lengths: np.ndarray, target) -> np.ndarray:
    """Per range ``[off[i], off[i] + lengths[i])`` of the time-sorted
    float32 pool, the count of entries below the scalar ``target`` (its
    float32 value): int64 ``[len(off)]``.  A binary search per range."""
    if np.ndim(target) != 0:
        raise ValueError("target must be a scalar")
    pool_ts = _vector(pool_ts, np.float32, "pool_ts")
    off = _vector(off, np.int64, "off")
    lengths = _vector(lengths, np.int64, "lengths")
    if len(off) != len(lengths):
        raise ValueError(f"off has {len(off)} entries, lengths "
                         f"{len(lengths)}")
    if len(off) and (off.min() < 0 or lengths.min() < 0
                     or (off + lengths).max() > len(pool_ts)):
        raise ValueError(f"ranges outside the pool of {len(pool_ts)} "
                         f"entries")
    out = np.empty(len(off), dtype=np.int64)
    _lib().ranged_lower_bound(len(off), pool_ts.ctypes.data, off.ctypes.data,
                              lengths.ctypes.data, float(np.float32(target)),
                              out.ctypes.data)
    return out


def ranged_lower_bound_ref(pool_ts: np.ndarray, off: np.ndarray,
                           lengths: np.ndarray, target) -> np.ndarray:
    """Plain version of :func:`ranged_lower_bound`: a vectorised binary
    search over every range at once."""
    target = np.float32(target)
    lo = np.zeros(len(off), dtype=np.int64)
    hi = lengths.astype(np.int64).copy()
    while (lo < hi).any():
        mid = (lo + hi) // 2
        go = pool_ts[off + np.minimum(mid, lengths - 1)] < target
        act = lo < hi
        lo = np.where(act & go, mid + 1, lo)
        hi = np.where(act & ~go, mid, hi)
    return lo


def resort_range(pool_ts: np.ndarray, pool_dst: np.ndarray,
                 pool_eid: np.ndarray, off: int, length: int) -> None:
    """Stable re-sort by time of the region ``[off, off + length)``, in
    place: ``pool_ts`` float32 and ``pool_dst``, ``pool_eid`` int32, each
    contiguous (the store's pools; an in-place sort cannot convert)."""
    for name, arr, dtype in (("pool_ts", pool_ts, np.float32),
                             ("pool_dst", pool_dst, np.int32),
                             ("pool_eid", pool_eid, np.int32)):
        if arr.dtype != dtype or arr.ndim != 1 \
                or not arr.flags["C_CONTIGUOUS"] or not arr.flags.writeable:
            raise TypeError(f"{name} must be a writeable contiguous 1-D "
                            f"{np.dtype(dtype)} array, got {arr.dtype} "
                            f"{arr.shape}")
    off, length = int(off), int(length)
    if off < 0 or length < 0 \
            or off + length > min(len(pool_ts), len(pool_dst), len(pool_eid)):
        raise ValueError(f"region [{off}, {off + length}) outside the pool")
    _lib().resort_range(off, length, pool_ts.ctypes.data,
                        pool_dst.ctypes.data, pool_eid.ctypes.data)


def resort_range_ref(pool_ts: np.ndarray, pool_dst: np.ndarray,
                     pool_eid: np.ndarray, off: int, length: int) -> None:
    """Plain version of :func:`resort_range`."""
    sl = slice(off, off + length)
    perm = np.argsort(pool_ts[sl], kind="stable")
    pool_ts[sl] = pool_ts[sl][perm]
    pool_dst[sl] = pool_dst[sl][perm]
    pool_eid[sl] = pool_eid[sl][perm]
