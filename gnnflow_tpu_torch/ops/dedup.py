"""Exact (nid, ts) instance deduplication for the memory/GRU path.

Counterpart of ``gnnflow_tpu/ops/dedup.py:35-129``.  The memory updater's
output for an instance is a pure function of its ``(nid, ts)`` pair and
the memory state, and the ``L = B·(1+F)`` instances of a TGN batch repeat
pairs heavily, so the GRU can run over the unique pairs only and the
results expand back.  This module sorts the pairs, ranks the unique ones
and scatters the winners into a ``cap``-row compact table, as the JAX
package does off the TPU (the scatter branch, ``dedup.py:103-110``).  Its
TPU branch (``:80-102``) extracts winners with the sorted segment sum to
avoid slow TPU scatters; that is a TPU workaround and is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INT32_MAX = 2 ** 31 - 1
_INT64_MAX = 2 ** 63 - 1


def dedup_instances(nid: torch.Tensor, ts: torch.Tensor, valid: torch.Tensor,
                    cap: int) -> Tuple[torch.Tensor, ...]:
    """Deduplicate ``(nid, ts)`` instance pairs.

    Args:
        nid: [L] node ids in int32 range (below 2^31 - 1; invalid rows may
            hold anything in that range, ``INVALID_NID`` included).
        ts: [L] float32 timestamps, compared by their bits (-0.0 != 0.0).
        valid: [L] bool; invalid rows join no unique pair.
        cap: capacity of the compact table.

    Returns ``(uniq_nid [cap] int64, uniq_ts [cap] f32, inv [L] int64,
    n_uniq, sidx [L] int64, rank_sorted [L] int32)``, as
    ``dedup.py:48-59``: unused compact rows hold 0 and 0.0; ``inv`` maps
    each instance to its slot, clipped to ``cap - 1`` (meaningful when
    ``n_uniq <= cap``); ``n_uniq`` is a 0-d int64 tensor on ``nid``'s
    device (0 when no row is valid); ``inv[sidx[p]] == rank_sorted[p]``
    with ``rank_sorted`` non-decreasing.

    ``lax.sort`` on the key pair (nid, ts bits) becomes one stable sort of
    an int64 key ``nid * 2^32 + (tsb + 2^31)``, which orders exactly as
    the signed pair; invalid rows take the largest key, so they sort last
    and, clipped, join the last rank as in the JAX package."""
    L = nid.shape[0]
    dev = nid.device
    tsb = ts.float().contiguous().view(torch.int32).long()
    key = torch.where(valid, nid.long() * 2 ** 32 + (tsb + 2 ** 31),
                      _INT64_MAX)
    skey, sidx = torch.sort(key, stable=True)
    s1 = torch.div(skey, 2 ** 32, rounding_mode="floor")   # nid, signed
    s2 = skey - s1 * 2 ** 32 - 2 ** 31                     # ts bits
    change = torch.ones(L, dtype=torch.bool, device=dev)
    change[1:] = skey[1:] != skey[:-1]
    first = change & (s1 != _INT32_MAX)
    rank = torch.cumsum(first, 0) - 1             # [-1 .. n_uniq - 1]
    n_uniq = rank[-1] + 1
    rank_sorted = rank.clamp(0, cap - 1)
    inv = torch.empty(L, dtype=torch.int64, device=dev)
    inv[sidx] = rank_sorted
    # winners land on their rank; every other row on one extra slot that
    # is dropped, so no kept slot is written twice
    slot = torch.where(first & (rank < cap), rank, cap)
    uniq_nid = torch.zeros(cap + 1, dtype=torch.int64, device=dev) \
        .scatter_(0, slot, s1)[:cap]
    uniq_tsb = torch.zeros(cap + 1, dtype=torch.int64, device=dev) \
        .scatter_(0, slot, s2)[:cap]
    uniq_ts = uniq_tsb.to(torch.int32).view(torch.float32)
    return (uniq_nid, uniq_ts, inv, n_uniq, sidx,
            rank_sorted.to(torch.int32))
