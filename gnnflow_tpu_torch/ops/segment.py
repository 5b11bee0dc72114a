"""Deterministic winner selection for state write-back.

Counterpart of ``gnnflow_tpu/ops/segment.py:15-33``.  A scatter with
duplicate indices writes in no fixed order on CUDA, so write-back selects
the last occurrence of each id explicitly and scatters winners only.
"""
from __future__ import annotations

import torch


def unique_keep_last_mask(nids: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Boolean mask selecting, for each distinct id, its last occurrence.
    Rows with ``valid`` False are never winners."""
    m = nids.shape[0]
    # invalid rows go to a sentinel bucket so they cannot shadow real ids
    keyed = torch.where(valid, nids, torch.iinfo(nids.dtype).max)
    perm = torch.argsort(keyed, stable=True)
    sorted_ids = keyed[perm]
    is_last = torch.ones(m, dtype=torch.bool, device=nids.device)
    is_last[:-1] = sorted_ids[:-1] != sorted_ids[1:]
    mask = torch.empty_like(is_last)
    mask[perm] = is_last
    return mask & valid
