"""Temporal neighbour sampling over the flat T-CSR store.

Counterpart of ``gnnflow_tpu/ops/sampling.py`` (``sample_layer``,
``sample_hops``).  A layer sample is a vectorised binary
search per root for the window end inside that root's sorted run, then a
gather of the ``fanout`` most recent edges before it.  Plain indexing takes
the place of the TPU's one-hot lane gathers (``_gather_scalars``,
``_gather_windows``); the results are bit-identical.

This slice carries what TGN samples: the most recent edges over the
full history (one snapshot, window 0, ``prop_time`` off), one layer.
Uniform sampling, windowed snapshots and deeper layers come with the TGAT
and DySAT slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import List

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
                 *, fanout: int) -> MFG:
    """Sample the ``fanout`` most recent edges before ``root_ts`` of each
    root into a padded MFG.

    ``roots`` may hold ``INVALID_NID`` (padded rows): they give fully
    masked rows.  Edges at exactly ``root_ts`` are excluded (strict ``<``).
    """
    roots = roots.long()
    root_ts = root_ts.float()
    valid_root = roots >= 0
    nid = torch.where(valid_root, roots, 0)
    off = g.row_off[nid].long()
    ln = torch.where(valid_root, g.row_len[nid].long(), 0)
    e_idx = _lower_bound(g.e_ts, off, ln, root_ts, g.search_iters)

    # slot k takes the k-th most recent edge before root_ts
    k = torch.arange(fanout, device=roots.device)[None, :]
    pick = e_idx[:, None] - 1 - k
    mask = pick >= 0
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
                *, fanout: int) -> List[List[MFG]]:
    """Layer-major MFGs of one layer and one snapshot, ``[[mfg]]``, as
    ``sampling.py:716-775`` returns them."""
    return [[sample_layer(g, roots, root_ts, fanout=fanout)]]
