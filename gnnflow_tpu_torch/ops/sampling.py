"""Temporal neighbour sampling over the flat T-CSR store.

Counterpart of ``gnnflow_tpu/ops/sampling.py`` (``sample_layer``,
``sample_hops``).  A layer sample is a vectorised binary
search per root for the window end inside that root's sorted run, then a
gather of the ``fanout`` most recent edges before it.  Plain indexing takes
the place of the TPU's one-hot lane gathers (``_gather_scalars``,
``_gather_windows``); the results are bit-identical.

The port carries what TGN and TGAT sample: the most recent edges or
uniform picks over the full history (one snapshot, window 0,
``prop_time`` off), over any number of layers.  Windowed snapshots come
with the DySAT slice (ROADMAP.md).  Uniform picks take their draws ``u``
as an argument (the JAX package draws them from a PRNG key inside the
function), so the same draws give identical MFGs on both sides.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from gnnflow_tpu_torch.common import INVALID_NID, MFG
from gnnflow_tpu_torch.dynamic_graph import DeviceGraph


def _lower_bound(e_ts: torch.Tensor, off: torch.Tensor, ln: torch.Tensor,
                 target: torch.Tensor, iters: int) -> torch.Tensor:
    """First ``i`` in ``[0, ln)`` with ``e_ts[off + i] >= target``, else
    ``ln``.  ``iters`` must be at least the bit length of ``max(ln)``."""
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


def sample_layer(g: DeviceGraph, roots: torch.Tensor, root_ts: torch.Tensor,
                 *, fanout: int, strategy: str = "recent",
                 u: Optional[torch.Tensor] = None) -> MFG:
    """Sample ``fanout`` edges before ``root_ts`` of each root into a
    padded MFG (``sampling.py:375-446``).

    ``strategy="recent"``: slot k takes the k-th most recent edge.
    ``strategy="uniform"``: slot k takes, with replacement, the candidate
    ``min(int(u[:, k] * nc), nc - 1)`` back from the newest of the root's
    ``nc`` candidates, and every slot of a root with a candidate is valid
    (``:414-429``); ``u`` is [B, fanout] float32 in [0, 1).

    ``roots`` may hold ``INVALID_NID`` (padded rows): they give fully
    masked rows.  Edges at exactly ``root_ts`` are excluded (strict ``<``).
    """
    if strategy not in ("recent", "uniform"):
        raise ValueError(f"strategy must be 'recent' or 'uniform', got "
                         f"{strategy!r}")
    roots = roots.long()
    root_ts = root_ts.float()
    valid_root = roots >= 0
    nid = torch.where(valid_root, roots, 0)
    off = g.row_off[nid].long()
    ln = torch.where(valid_root, g.row_len[nid].long(), 0)
    e_idx = _lower_bound(g.e_ts, off, ln, root_ts, g.search_iters)

    if strategy == "recent":
        # slot k takes the k-th most recent edge before root_ts
        k = torch.arange(fanout, device=roots.device)[None, :]
        pick = e_idx[:, None] - 1 - k
        mask = pick >= 0
    else:
        if u is None or tuple(u.shape) != (roots.shape[0], fanout) \
                or u.dtype != torch.float32:
            raise ValueError(f"uniform sampling needs u of shape "
                             f"{(roots.shape[0], fanout)} and float32")
        # window 0: the candidates are [0, e_idx); u * nc in f32,
        # truncated as astype(int32) does
        nc = e_idx[:, None]
        r = torch.minimum((u * nc.float()).long(), (nc - 1).clamp_min(0))
        pick = e_idx[:, None] - 1 - r
        mask = (nc > 0).expand(-1, fanout).contiguous()
    idx = (off[:, None] + pick).clamp(0, g.e_dst.shape[0] - 1)
    edge_ts = torch.where(mask, g.e_ts[idx], 0.0)
    return MFG(
        root_nids=roots, root_ts=root_ts,
        nbr_nids=torch.where(mask, g.e_dst[idx].long(), INVALID_NID),
        nbr_ts=edge_ts,
        nbr_dts=torch.where(mask, root_ts[:, None] - edge_ts, 0.0),
        nbr_eids=torch.where(mask, g.e_eid[idx].long(), 0),
        nbr_mask=mask)


def sample_hops(g: DeviceGraph, roots: torch.Tensor, root_ts: torch.Tensor,
                *, fanouts: Sequence[int], strategy: str = "recent",
                draw: Optional[Callable[[int, tuple], torch.Tensor]] = None
                ) -> List[List[MFG]]:
    """Layer-major MFGs of one snapshot, ``[[mfg]]`` per layer, innermost
    (deepest) first, as ``sampling.py:716-775`` returns them: the roots of
    layer ``i + 1`` are layer ``i``'s ``all_nodes()`` at ``all_ts()``.

    Uniform sampling takes layer ``i``'s draws from ``draw(i, (B, F))``,
    its own stream for each layer, as ``fold_in(key, i)`` gives there."""
    mfgs: List[List[MFG]] = []
    r, t = roots, root_ts
    for layer, fanout in enumerate(fanouts):
        u = None
        if strategy == "uniform":
            if draw is None:
                raise ValueError("uniform sampling needs draws")
            u = draw(layer, (r.shape[0], int(fanout)))
        m = sample_layer(g, r, t, fanout=int(fanout), strategy=strategy,
                         u=u)
        mfgs.append([m])
        r, t = m.all_nodes(), m.all_ts()
    mfgs.reverse()
    return mfgs
