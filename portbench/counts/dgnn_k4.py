"""The work of a DGNN step (:mod:`portbench.counts.dgnn`) and, for a model
of two or more layers on the layer dedup, the least time of K4, the
sorted segment sum that carries the gradient of the deduplicated inner
layer back to the boundary's rows in the backward pass.

Each boundary's valid rows (the outer layer's valid roots and valid
neighbour slots) count as read once at ``dim_embed`` f32 values and once
as an int32 segment id; each distinct ``(node, time)`` row among them is
written once; one addition per value read.  This is chip_smoke.py's K4
bound (commit e51abea) restricted to valid rows.  The rows come from the
same draws as the step's work: the sampler's calls are recorded as
:func:`portbench.counts.dgnn.work` makes them.
"""
from __future__ import annotations

from portbench.counts import dgnn
from portbench.harness import least_s

F32, I32 = 4, 4


class _Recorded:
    """The store, with ``(roots, valid slots)`` of each sample call kept."""

    def __init__(self, store):
        self.store, self.calls = store, []

    def sample(self, roots, ts, fanout, u=None):
        nbr = self.store.sample(roots, ts, fanout, u)
        self.calls.append((len(roots), int(nbr["mask"].sum())))
        return nbr


def k4_least_s(calls, num_layers: int, dim: int) -> float:
    """K4's least time over the recorded sample calls, ``num_layers`` a
    batch, outermost first: at each boundary the valid rows are the
    outer level's roots and valid slots, and the distinct rows are the
    next level's roots."""
    total = 0.0
    for b in range(0, len(calls), num_layers):
        levels = calls[b:b + num_layers]
        for (roots, slots), (uniq, _) in zip(levels, levels[1:]):
            valid = roots + slots
            nbytes = valid * (dim * F32 + I32) + uniq * dim * F32
            total += least_s(nbytes, float(valid * dim), "float32")
    return total


def work(cfg, store, batches, train: bool, device, seed: int = 0) -> dict:
    """:func:`portbench.counts.dgnn.work` and ``k4_least_s``, K4's least
    time (0 outside training: the forward pass expands without K4)."""
    rec = _Recorded(store)
    out = dgnn.work(cfg, rec, batches, train, device, seed)
    out["k4_least_s"] = k4_least_s(rec.calls, cfg["num_layers"],
                                   cfg["dim_embed"]) if train else 0.0
    return out
