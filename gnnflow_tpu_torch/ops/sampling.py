"""Temporal neighbour sampling over the flat T-CSR store.

Counterpart of ``gnnflow_tpu/ops/sampling.py`` (``snapshot_window``,
``sample_layer``, ``sample_layer_snapshots``, ``boundary_overflow``,
``sample_deeper_compact``, ``sample_hops``).  A layer sample is a
vectorised binary search per root for its window's start and end inside
that root's sorted run, then a gather of ``fanout`` edges before the end.
Plain indexing and binary searches take the place of the TPU's one-hot
lane gathers and coarse window counts (``_gather_scalars``,
``_gather_windows``, ``_window_count*``, ``_coarsen``); the results are
bit-identical.

Strategies: the most recent edges, or uniform picks.  Uniform picks take
their draws ``u`` as an argument (the JAX package draws them from a PRNG
key inside the function), so the same draws give identical MFGs on both
sides.  Windows: the full history (one snapshot, window 0), a window
``[ts - W, ts)``, or ``S`` disjoint snapshot windows of width ``W`` ending
at the root's timestamp (DySAT).  ``prop_time`` gives every valid
neighbour its root's timestamp.

The window bounds are computed in float32 as the JAX source writes them,
each product rounded before the subtraction, so an edge one ulp from a
boundary falls in the same snapshot on both sides.  (XLA on the CPU keeps
that rounding at the shapes the tests use; in a program of a few rows it
contracts the chained bound into one FMA.)
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from gnnflow_tpu_torch.common import INVALID_NID, MFG
from gnnflow_tpu_torch.dynamic_graph import DeviceGraph

Draw = Callable[[int, tuple], torch.Tensor]


def _lower_bound(e_ts: torch.Tensor, off: torch.Tensor, ln: torch.Tensor,
                 target: torch.Tensor, iters: int) -> torch.Tensor:
    """First ``i`` in ``[0, ln)`` with ``e_ts[off + i] >= target``, else
    ``ln``; ``off``, ``ln`` and ``target`` broadcast together.  ``iters``
    must be at least the bit length of ``max(ln)``."""
    off, ln, target = torch.broadcast_tensors(off, ln, target)
    lo = torch.zeros_like(ln)
    hi = ln.clone()
    last = e_ts.shape[0] - 1
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = e_ts[(off + mid).clamp(0, last)] < target
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _root_off_len(g: DeviceGraph, roots: torch.Tensor):
    """``(off, len)`` of each root's run; invalid roots have length 0."""
    valid = roots >= 0
    nid = torch.where(valid, roots, 0)
    return g.row_off[nid].long(), torch.where(valid, g.row_len[nid].long(), 0)


def snapshot_window(root_ts: torch.Tensor, snapshot_idx: int,
                    num_snapshots: int, window: float):
    """``(start, end)`` per root (``sampling.py:340-356``): snapshot ``s``
    of ``S`` is ``[ts - (S - s)·W, ts - (S - s - 1)·W)``; one snapshot
    with window 0 is the full history (start 0).  The products are taken
    in double, as Python computes them there, and rounded to float32."""
    f32 = dict(dtype=torch.float32, device=root_ts.device)
    if num_snapshots == 1:
        end = root_ts
        start = (torch.zeros_like(root_ts) if abs(window) < 1e-6
                 else root_ts - torch.tensor(window, **f32))
    else:
        end = root_ts - torch.tensor(
            (num_snapshots - snapshot_idx - 1) * window, **f32)
        start = root_ts - torch.tensor(
            (num_snapshots - snapshot_idx) * window, **f32)
    return start, end


def _picks(g: DeviceGraph, roots, root_ts, off, s_idx, e_idx, *,
           fanout: int, strategy: str, prop_time: bool,
           u: Optional[torch.Tensor]):
    """The padded neighbour fields of roots whose candidates are the
    slots ``[s_idx, e_idx)`` of their runs (any leading shape)."""
    if strategy == "recent":
        # slot k takes the k-th most recent candidate
        k = torch.arange(fanout, device=roots.device)
        pick = e_idx[..., None] - 1 - k
        mask = pick >= s_idx[..., None]
    else:
        want = tuple(roots.shape) + (fanout,)
        if u is None or tuple(u.shape) != want or u.dtype != torch.float32:
            raise ValueError(f"uniform sampling needs u of shape {want} "
                             f"and float32")
        # slot k takes candidate min(int(u * nc), nc - 1) back from the
        # newest; u * nc in f32, truncated as astype(int32) does
        nc = (e_idx - s_idx)[..., None]
        r = torch.minimum((u * nc.float()).long(), (nc - 1).clamp_min(0))
        pick = e_idx[..., None] - 1 - r
        mask = (nc > 0).expand(want).contiguous()
    idx = (off[..., None] + pick).clamp(0, g.e_dst.shape[0] - 1)
    edge_ts = torch.where(mask, g.e_ts[idx], 0.0)
    rts = root_ts[..., None]
    nbr_ts = torch.where(mask, rts, 0.0) if prop_time else edge_ts
    return dict(nbr_nids=torch.where(mask, g.e_dst[idx].long(), INVALID_NID),
                nbr_ts=nbr_ts,
                nbr_dts=torch.where(mask, rts - edge_ts, 0.0),
                nbr_eids=torch.where(mask, g.e_eid[idx].long(), 0),
                nbr_mask=mask)


def sample_layer(g: DeviceGraph, roots: torch.Tensor, root_ts: torch.Tensor,
                 *, fanout: int, strategy: str = "recent",
                 snapshot_idx: int = 0, num_snapshots: int = 1,
                 window: float = 0.0, prop_time: bool = False,
                 u: Optional[torch.Tensor] = None) -> MFG:
    """Sample ``fanout`` edges of each root inside its snapshot window
    (:func:`snapshot_window`) into a padded MFG (``sampling.py:359-442``).

    ``strategy="recent"``: slot k takes the k-th most recent candidate.
    ``strategy="uniform"``: slot k takes, with replacement, the candidate
    ``min(int(u[:, k] * nc), nc - 1)`` back from the newest of the root's
    ``nc`` candidates, and every slot of a root with a candidate is valid;
    ``u`` is [B, fanout] float32 in [0, 1).

    ``roots`` may hold ``INVALID_NID`` (padded rows): they give fully
    masked rows.  Edges at exactly a window's end are excluded (strict
    ``<``)."""
    if strategy not in ("recent", "uniform"):
        raise ValueError(f"strategy must be 'recent' or 'uniform', got "
                         f"{strategy!r}")
    roots = roots.long()
    root_ts = root_ts.float()
    off, ln = _root_off_len(g, roots)
    start, end = snapshot_window(root_ts, snapshot_idx, num_snapshots,
                                 window)
    if num_snapshots == 1 and abs(window) < 1e-6:
        # the full history: every run starts at slot 0
        s_idx = torch.zeros_like(ln)
        e_idx = _lower_bound(g.e_ts, off, ln, end, g.search_iters)
    else:
        s_idx, e_idx = _lower_bound(g.e_ts, off, ln, torch.stack([start, end]),
                                    g.search_iters)
    return MFG(root_nids=roots, root_ts=root_ts,
               **_picks(g, roots, root_ts, off, s_idx, e_idx, fanout=fanout,
                        strategy=strategy, prop_time=prop_time, u=u))


def sample_layer_snapshots(g: DeviceGraph, roots: torch.Tensor,
                           root_ts: torch.Tensor, *, fanout: int,
                           strategy: str = "recent", num_snapshots: int = 1,
                           window: float = 0.0, prop_time: bool = False,
                           shared_roots: bool = False,
                           u: Optional[torch.Tensor] = None) -> List[MFG]:
    """All snapshots of one layer in one pass (``sampling.py:449-551``):
    ``roots`` and ``root_ts`` are [S, B], row ``s`` sampled in snapshot
    ``s``; uniform draws ``u`` are [S, B, fanout].  Returns S MFGs.

    ``shared_roots=True`` states that every row holds the same roots (the
    first layer); their runs are then looked up once and the S snapshots'
    2S bounds become the S + 1 chained boundaries ``ts - (S - j)·W``.  The
    bounds are float32 products, rounded, then subtracted, as the JAX
    function computes them."""
    if strategy not in ("recent", "uniform"):
        raise ValueError(f"strategy must be 'recent' or 'uniform', got "
                         f"{strategy!r}")
    S, B = roots.shape
    roots = roots.long()
    root_ts = root_ts.float()
    dev = roots.device
    W = torch.tensor(window, dtype=torch.float32, device=dev)
    if shared_roots and num_snapshots > 1:
        off1, ln1 = _root_off_len(g, roots[0])
        j = torch.arange(S + 1, dtype=torch.float32, device=dev)[:, None]
        bounds = _lower_bound(g.e_ts, off1, ln1,
                              root_ts[0][None] - (num_snapshots - j) * W,
                              g.search_iters)               # [S + 1, B]
        s_idx, e_idx = bounds[:S], bounds[1:]
        off = off1[None].expand(S, B)
    else:
        off, ln = _root_off_len(g, roots)
        if num_snapshots == 1:
            end = root_ts
            start = (torch.zeros_like(root_ts) if abs(window) < 1e-6
                     else root_ts - W)
        else:
            snap = torch.arange(S, dtype=torch.float32, device=dev)[:, None]
            end = root_ts - (num_snapshots - snap - 1) * W
            start = root_ts - (num_snapshots - snap) * W
        s_idx, e_idx = _lower_bound(g.e_ts, off, ln,
                                    torch.stack([start, end]),
                                    g.search_iters)         # [2, S, B]
    f = _picks(g, roots, root_ts, off, s_idx, e_idx, fanout=fanout,
               strategy=strategy, prop_time=prop_time, u=u)
    return [MFG(root_nids=roots[s], root_ts=root_ts[s],
                **{k: v[s] for k, v in f.items()}) for s in range(S)]


def _block_valid(prev: Sequence[MFG]) -> torch.Tensor:
    """[S, B] bool: does a root's neighbour block hold a valid slot."""
    return torch.stack([m.nbr_mask.any(1) for m in prev])


def boundary_overflow(prev_mfgs: Sequence[MFG], cap: int) -> torch.Tensor:
    """0-d bool (``sampling.py:655-661``): does any snapshot of
    ``prev_mfgs`` have more than ``cap`` valid neighbour blocks.  Needs
    the parent layer's masks only, so it is known before deeper
    sampling."""
    return (_block_valid(prev_mfgs).sum(1) > cap).any()


def _nth_valid_block(csum: torch.Tensor, cap: int) -> torch.Tensor:
    """``csum`` [S, B]: inclusive per-snapshot counts of valid blocks.
    Returns [S, cap]: the index of the ``q``-th valid block of each
    snapshot, ``B`` where there are fewer (``sampling.py:554-568``)."""
    q = torch.arange(1, cap + 1, dtype=csum.dtype, device=csum.device)
    return torch.searchsorted(csum.contiguous(),
                              q.expand(csum.shape[0], cap).contiguous())


def _packed_roots(prev: Sequence[MFG], cap: int):
    """The compact root set of the layer below ``prev`` (``[S, B + cap·F]``
    ids and timestamps: the B parent roots, then the first ``cap`` valid
    F-wide neighbour blocks of each snapshot, invalid beyond), with the
    [S, B] ``rank`` of each parent block in it (``cap``: not packed)."""
    S, B, F = len(prev), prev[0].num_dst, prev[0].fanout
    csum = torch.cumsum(_block_valid(prev).long(), 1)
    blk = _nth_valid_block(csum, cap)                         # [S, cap]
    gn = torch.cat([torch.stack([m.nbr_nids for m in prev]),
                    torch.full((S, 1, F), INVALID_NID, dtype=torch.long,
                               device=blk.device)], 1)
    gt = torch.cat([torch.stack([m.nbr_ts for m in prev]),
                    torch.zeros((S, 1, F), device=blk.device)], 1)
    ix = blk[:, :, None].expand(S, cap, F)
    Rc = torch.cat([torch.stack([m.root_nids for m in prev]),
                    torch.gather(gn, 1, ix).reshape(S, cap * F)], 1)
    Tc = torch.cat([torch.stack([m.root_ts for m in prev]),
                    torch.gather(gt, 1, ix).reshape(S, cap * F)], 1)
    rank = torch.where(_block_valid(prev), csum - 1, cap)
    return Rc, Tc, rank


def sample_deeper_compact(g: DeviceGraph, prev_mfgs: Sequence[MFG],
                          cap: int, *, fanout: int = 0,
                          strategy: str = "recent", num_snapshots: int = 1,
                          window: float = 0.0, prop_time: bool = False,
                          u: Optional[torch.Tensor] = None,
                          sample_fn=None) -> Tuple[List[MFG], torch.Tensor]:
    """Sample the layer below ``prev_mfgs`` over its compact root set
    (``sampling.py:664-713``): the MFGs have ``num_dst = B + cap·F``, and
    the caller expands the layer's output with ``expand_blocks`` and the
    returned ``rank`` [S, B].  Exact only when
    :func:`boundary_overflow` is False.

    ``sample_fn(Rc, Tc) -> list of MFG``, when given, samples the packed
    roots in place of :func:`sample_layer_snapshots` (and its ``u``)."""
    Rc, Tc, rank = _packed_roots(prev_mfgs, cap)
    if sample_fn is not None:
        return sample_fn(Rc, Tc), rank
    return sample_layer_snapshots(
        g, Rc, Tc, fanout=fanout, strategy=strategy,
        num_snapshots=num_snapshots, window=window, prop_time=prop_time,
        u=u), rank


def _sample_layer_compacted(g: DeviceGraph, prev: Sequence[MFG], cap: int,
                            draw: Optional[Callable[[tuple], torch.Tensor]],
                            **kw) -> List[MFG]:
    """The padded MFGs of the layer below ``prev``, sampled over the
    compact root set and expanded back by a row gather
    (``sampling.py:571-652``), or sampled padded when a snapshot has more
    than ``cap`` valid blocks: a Python branch on one host sync where the
    JAX function has ``lax.cond``.  ``draw(shape)`` gives uniform draws
    for the branch taken."""
    S, B1, F = len(prev), prev[0].num_dst, prev[0].fanout
    R_full = torch.stack([m.all_nodes() for m in prev])
    T_full = torch.stack([m.all_ts() for m in prev])
    if bool(boundary_overflow(prev, cap)):
        u = draw(tuple(R_full.shape) + (kw["fanout"],)) if draw else None
        return sample_layer_snapshots(g, R_full, T_full, u=u, **kw)
    Rc, Tc, rank = _packed_roots(prev, cap)
    u = draw(tuple(Rc.shape) + (kw["fanout"],)) if draw else None
    mc = sample_layer_snapshots(g, Rc, Tc, u=u, **kw)
    out = []
    for s, m in enumerate(mc):
        def expand(fc, fill):
            F2 = fc.shape[1]
            tail = torch.cat([fc[B1:].reshape(cap, F * F2),
                              torch.full((1, F * F2), fill, dtype=fc.dtype,
                                         device=fc.device)])
            return torch.cat([fc[:B1], tail[rank[s]].reshape(B1 * F, F2)])
        out.append(MFG(root_nids=R_full[s], root_ts=T_full[s],
                       nbr_nids=expand(m.nbr_nids, INVALID_NID),
                       nbr_ts=expand(m.nbr_ts, 0.0),
                       nbr_dts=expand(m.nbr_dts, 0.0),
                       nbr_eids=expand(m.nbr_eids, 0),
                       nbr_mask=expand(m.nbr_mask, False)))
    return out


def sample_hops(g: DeviceGraph, roots: torch.Tensor, root_ts: torch.Tensor,
                *, fanouts: Sequence[int], strategy: str = "recent",
                num_snapshots: int = 1, window: float = 0.0,
                prop_time: bool = False,
                compact_factor: Optional[float] = None,
                draw: Optional[Draw] = None) -> List[List[MFG]]:
    """Layer-major MFGs, ``[[mfg per snapshot]]`` per layer, innermost
    (deepest) first, as ``sampling.py:716-775`` returns them: the roots of
    layer ``i + 1`` in snapshot ``s`` are layer ``i``'s ``all_nodes()`` at
    ``all_ts()`` in snapshot ``s``.

    With more than one snapshot, each layer samples its snapshots in one
    pass (the first on shared roots); ``compact_factor`` then samples
    deeper layers over at most ``ceil(f · B)`` valid neighbour blocks of
    their parent and expands the MFGs back (:func:`_sample_layer_compacted`;
    an overflow samples padded, so the MFGs are the same).

    Uniform sampling takes layer ``i``'s draws from ``draw(i, shape)``,
    ``[B, F]`` or ``[S, B, F]``, its own stream for each layer, as
    ``fold_in(key, i)`` gives there."""
    if strategy == "uniform" and draw is None:
        raise ValueError("uniform sampling needs draws")
    kw = dict(strategy=strategy, num_snapshots=num_snapshots, window=window,
              prop_time=prop_time)
    S = num_snapshots
    mfgs: List[List[MFG]] = []
    layer_mfgs: List[MFG] = []
    for layer, fanout in enumerate(int(f) for f in fanouts):
        ldraw = (lambda shape, layer=layer: draw(layer, shape)) \
            if strategy == "uniform" else None
        if S > 1:
            if layer > 0 and compact_factor is not None:
                B = layer_mfgs[0].num_dst
                cap = min(B, max(1, math.ceil(compact_factor * B)))
                layer_mfgs = _sample_layer_compacted(g, layer_mfgs, cap,
                                                     ldraw, fanout=fanout,
                                                     **kw)
            else:
                if layer == 0:
                    R = roots.long()[None].expand(S, -1)
                    T = root_ts.float()[None].expand(S, -1)
                else:
                    R = torch.stack([m.all_nodes() for m in layer_mfgs])
                    T = torch.stack([m.all_ts() for m in layer_mfgs])
                u = ldraw(tuple(R.shape) + (fanout,)) if ldraw else None
                layer_mfgs = sample_layer_snapshots(
                    g, R, T, fanout=fanout, shared_roots=layer == 0, u=u,
                    **kw)
        else:
            r, t = (roots, root_ts) if layer == 0 else \
                (layer_mfgs[0].all_nodes(), layer_mfgs[0].all_ts())
            u = ldraw((r.shape[0], fanout)) if ldraw else None
            layer_mfgs = [sample_layer(g, r, t, fanout=fanout, u=u, **kw)]
        mfgs.append(layer_mfgs)
    mfgs.reverse()
    return mfgs
