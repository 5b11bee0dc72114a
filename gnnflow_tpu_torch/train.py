"""The train and eval steps of TGN, TGAT, DySAT, APAN, GraphSAGE and GAT
link prediction.

Counterpart of ``gnnflow_tpu/train.py``: ``link_pred_loss``
(``:49-65``), ``_gather_rows`` and ``fetch_features`` (``:92-137``), and a
``Trainer`` with ``init_state``, ``train_step``, ``eval_step`` and
``embed_step`` (``:1200-1265, 1371-1417``), with ``train_step_arrays``
and ``train_steps_scan`` (``:1341-1370``) on batches already on the
device.  A step samples the batch roots'
neighbours over every layer (most recent or uniform; static models at the
timestamp ``3.4e38``), gathers edge and node features, pulls memory rows
(TGN, APAN), runs the model (GRU or transformer memory update, temporal
attention layers, edge predictor; or the static layers and their
predictor) and computes the loss over ``r`` negatives per edge; a train
step then back-propagates and takes an optimizer step (Adam by default);
with memory, both write memory and mails back, computed with the
parameters from before the step.
PyTorch runs eagerly, so there is no ``jit``.

Three exact fast paths are ported, each a Python branch on a count where
the JAX package has ``lax.cond``, so one host sync per decision:

- the (nid, ts) memory dedup (``dedup_factor``, ``:861-904``) for models
  with memory, GRU or transformer, calibrated on the first train step
  (``:451-623, 719-750``);
- the layer dedup (``layer_dedup``, ``_layer_dedup_outputs``,
  ``:992-1091``) for models of two or more layers without memory (TGAT,
  and the static GraphSAGE and GAT):
  a deeper layer samples only the unique (nid, ts) roots of its parent
  layer and its output expands back at the boundary.  A ladder of tiers
  takes the tightest cap that fits at the first boundary; deeper
  boundaries take one cap; an overflow runs the remaining layers padded.
  ``calibrate`` picks the ladder (``:514-538, 624-698``), and
  ``tier_take_stats`` and ``maybe_recalibrate`` follow the takes
  (``:752-785``).  With windowed snapshots (DySAT) the same knob runs the
  snapshot dedup (``_snapshot_dedup_outputs``, ``:1093-1198``): each
  snapshot dedups its parent's instances, and one sync per boundary reads
  the largest unique count over the snapshots;
- the block compaction of windowed snapshots (``model_compact``,
  ``compact_factor``, ``_model_compact_outputs``, ``:906-990``): a deeper
  layer samples only the valid neighbour blocks of its parent, packed
  into ``ceil(compact_factor · B)`` slots per snapshot, and its output
  expands back with ``expand_blocks``; a snapshot with more valid blocks
  runs the remaining layers padded.

A step takes the snapshot dedup, then the block compaction, then the
layer dedup, then the padded path, the first that is set
(``:1209-1236``).  ``train_step_prefetched`` (``:1267-1339``) is the
feature cache's step: it takes MFGs sampled outside it and features a
cache fetched, and runs only the memory dedup.  ``gru_table`` gives the
GRU memory updater the raw state, from which it projects the gates once
per node (``train.py:242-258, 848-850``).
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from gnnflow_tpu_torch.common import INVALID_NID, MFG, resolve_device
from gnnflow_tpu_torch.data import Batch
from gnnflow_tpu_torch.dynamic_graph import DeviceGraph
from gnnflow_tpu_torch.models import memory as memory_lib
from gnnflow_tpu_torch.models.dgnn import DGNN
from gnnflow_tpu_torch.models.static import GAT, SAGE
from gnnflow_tpu_torch.ops.dedup import dedup_instances
from gnnflow_tpu_torch.ops.sampling import (boundary_overflow,
                                             sample_deeper_compact,
                                             sample_hops, sample_layer,
                                             sample_layer_snapshots)
from gnnflow_tpu_torch.utils import profiling

# the sampling generator's seed is this plus init_state's seed, so its
# draws are not the dropout generator's
SAMPLE_SEED_OFFSET = 2 ** 32

# the roots' timestamp of static sampling (``train.py:1206-1207``), which
# is not STATIC_TS, the float32 maximum
STATIC_SAMPLE_TS = float(np.float32(3.4e38))


@dataclass
class TrainState:
    """Node memory (None without memory), the optimizer over the model's
    parameters, the dropout and the sampling generators (on the trainer's
    device), the count of train steps, and what the last step's dedups
    saw: the memory dedup's unique (nid, ts) count (None when the step ran
    without it); the layer (or snapshot) dedup's unique count at each
    boundary it examined (the largest over the snapshots) and the number
    of boundaries that took a tier (each one expansion per snapshot,
    whose backward is one K4 launch each); the number of boundaries that
    ran on the block compaction.  ``tier_takes`` is the layer dedup's take
    histogram over train steps (models it applies to; else None): index
    = tier caps the first boundary's unique count exceeded, 3 and up
    clamped to 3 (``train.py:40-46``)."""
    memory: Optional[memory_lib.MemoryState]
    optimizer: torch.optim.Optimizer
    dropout_gen: torch.Generator
    sample_gen: torch.Generator
    step: int = 0
    dedup_n_uniq: Optional[int] = None
    tier_takes: Optional[List[int]] = None
    last_take: Optional[int] = None
    layer_dedup_n_uniq: Optional[List[int]] = None
    layer_dedup_compact: int = 0
    block_compact: int = 0


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor):
    """Elementwise torch BCEWithLogitsLoss, written as the JAX package's."""
    return logits.clamp_min(0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))


def link_pred_loss(pos: torch.Tensor, neg: torch.Tensor,
                   valid: torch.Tensor, neg_ratio: int = 1,
                   num_valid: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Masked ``mean(BCE(pos, 1)) + mean(BCE(neg, 0))`` over valid rows
    (``train.py:55-65``); ``neg`` holds ``neg_ratio`` negatives per
    positive ([r·B, 1]), masked as their edge.  ``num_valid`` (a
    data-parallel rank's share of a global batch: the global batch's
    valid count, a tensor) divides the masked sums instead of the rank's
    own count."""
    w = valid.float()[:, None]
    wn = w.repeat(neg_ratio, 1) if neg_ratio > 1 else w
    denom = (w.sum() if num_valid is None else num_valid.float()) \
        .clamp_min(1.0)
    return (bce_with_logits(pos, torch.ones_like(pos)) * w).sum() / denom \
        + (bce_with_logits(neg, torch.zeros_like(neg)) * wn).sum() \
        / (denom * neg_ratio)


def _gather_rows(table, ids: torch.Tensor, valid: torch.Tensor,
                 dtype: Optional[torch.dtype] = None
                 ) -> Optional[torch.Tensor]:
    """Row gather with padded-id masking (invalid rows are zero), cast to
    ``dtype`` where given.  ``table`` is a tensor or a sharded table with
    ``pull`` (:class:`~gnnflow_tpu_torch.parallel.kvstore.ShardedTable`,
    a collective)."""
    if table is None:
        return None
    rows = memory_lib.table_rows(table, ids.reshape(-1))
    if dtype is not None:
        rows = rows.to(dtype)
    rows = rows.reshape(ids.shape + (rows.shape[1],))
    return torch.where(valid[..., None], rows, 0.0)


@profiling.traced("features.gather")
def fetch_features(mfgs: List[List[MFG]],
                   edge_feats: Optional[torch.Tensor]):
    """Per-layer, per-snapshot [B, F, dim_edge] edge features."""
    return [[_gather_rows(edge_feats, m.nbr_eids, m.nbr_mask)
             for m in layer] for layer in mfgs]


def fetch_node_features(mfgs: List[List[MFG]],
                        node_feats: Optional[torch.Tensor],
                        dtype: torch.dtype = torch.float32):
    """Per-snapshot [B·(1+F), dim_node] node features of the innermost
    MFGs' instances, invalid rows zero (``train.py:124-128``), cast to
    ``dtype``; None without a table."""
    if node_feats is None:
        return None
    with profiling.span("features.gather"):
        return [_gather_rows(node_feats, m.all_nodes(), m.all_mask(), dtype)
                for m in mfgs[0]]


def _mfg_to(mfg: MFG, device: torch.device) -> MFG:
    """``mfg`` with every tensor on ``device``'s type of device."""
    if mfg.root_nids.device.type == device.type:
        return mfg
    fields = dataclasses.fields(mfg)
    profiling.count("host_sync.mfg_upload", len(fields))
    return MFG(**{f.name: getattr(mfg, f.name).to(device)
                  for f in fields})


def dedup_cap(factor: float, num_all: int) -> int:
    """Rows of the memory dedup's compact table for ``num_all`` instances
    at ``factor`` (``train.py:786-788``): a multiple of 256, at most
    ``num_all``."""
    cap = int(math.ceil(float(factor) * num_all / 256.0))
    return min(cap * 256, num_all)


def tier_caps(factors: Sequence[float], num_all: int) -> List[int]:
    """Distinct ascending 256-aligned caps of a layer-dedup tier ladder
    for ``num_all`` instances (``train.py:800-807``)."""
    caps: List[int] = []
    for f in factors:
        c = min(num_all, -(-math.ceil(f * num_all) // 256) * 256)
        if not caps or c > caps[-1]:
            caps.append(c)
    return caps


def dedup_factor_for(uniq_frac: float, updater: str) -> Optional[float]:
    """The memory dedup's factor from the worst measured unique fraction
    of the memory instances (``train.py:603-622``); None (off) above the
    updater's gate.  The GRU's dedup saves only the gates and the pull, so
    its sort machinery pays only at extreme duplication: ``round(min(0.35,
    2.5u + 0.02), 2)`` up to ``u = 0.08``.  The transformer's shrinks the
    whole updater (pull, K/V, attention, LayerNorm): ``round(min(0.7,
    1.25u + 0.03), 2)`` up to ``u = 0.5``."""
    if updater == "gru":
        return round(min(0.35, 2.5 * uniq_frac + 0.02), 2) \
            if uniq_frac <= 0.08 else None
    return round(min(0.7, 1.25 * uniq_frac + 0.03), 2) \
        if uniq_frac <= 0.5 else None


def compact_factor_for(occupancy: float) -> Optional[float]:
    """The block compaction's factor from the worst measured occupancy of
    deeper layers' neighbour slots (``train.py:595-600``): 1.4x headroom
    + 0.02, at most 0.9; None (off) at 0.6 and above."""
    return round(min(0.9, 1.4 * occupancy + 0.02), 2) \
        if occupancy < 0.6 else None


def tier_ladder(boundary_frac, num_layers: int,
                compact_factor: Optional[float] = None):
    """The layer dedup's ``(layer_dedup, layer_dedup_deep)`` from measured
    unique fractions (``train.py:624-698``): ``boundary_frac`` holds one
    ``(first-boundary fraction, worst deeper-boundary fraction)`` pair per
    probe batch.

    Two low tiers come from the 0.45 and 0.75 quantiles of the first
    boundary's fraction (+0.02, kept at or below 0.7 and 0.08 apart), a
    top tier covering the worst boundary with a 1.25x margin only extends
    a ladder (at or below 0.85); models of three or more layers keep the
    lowest and the top tier.  Deeper boundaries take one cap, 1.1x their
    worst fraction + 0.02 (at most 0.85).  A ladder of one tier is a
    float; none is None (off).  With windowed snapshots the block
    compaction's ``compact_factor`` is passed: a ladder whose lowest tier
    is at least 0.9 of it is dropped, since the compaction is then as
    tight (``:692-695``); the deep cap stays set, as there."""
    b1s = sorted(b for b, _ in boundary_frac)
    deep_worst = max(m for _, m in boundary_frac)
    worst = max(deep_worst, b1s[-1])
    qs = [b1s[min(len(b1s) - 1, int(q * len(b1s)))] for q in (0.45, 0.75)]
    cands = [round(min(0.92, u + 0.02), 2) for u in qs] \
        + [round(min(0.92, 1.25 * worst + 0.03), 2)]
    tiers: List[float] = []
    for f in cands[:-1]:
        if f <= 0.7 and (not tiers or f >= tiers[-1] + 0.08):
            tiers.append(f)
    if tiers and cands[-1] <= 0.85 and cands[-1] >= tiers[-1] + 0.08:
        tiers.append(cands[-1])
    if num_layers > 2 and len(tiers) > 2:
        tiers = [tiers[0], tiers[-1]]
    deep = (round(min(0.85, 1.1 * deep_worst + 0.02), 2)
            if tiers and deep_worst > 0 else None)
    ladder = (None if not tiers
              else tiers[0] if len(tiers) == 1 else tuple(tiers))
    if ladder is not None and compact_factor is not None \
            and min(tiers) >= 0.9 * compact_factor:
        ladder = None
    return ladder, deep


def _uniq_pairs_frac(layer: Sequence[MFG]) -> float:
    """The largest over a layer's snapshots of the unique valid (nid, ts
    bits) pairs of an MFG's instances over all its instances."""
    frac = 0.0
    for m in layer:
        profiling.count("host_sync.calibrate", 3)
        nid = m.all_nodes().cpu().numpy()
        mts = m.all_ts().cpu().numpy().view(np.int32)
        valid = m.all_mask().cpu().numpy()
        pairs = np.stack([nid[valid], mts[valid]], 1)
        frac = max(frac, np.unique(pairs, axis=0).shape[0]
                   / max(nid.size, 1))
    return frac


class Trainer:
    """Runs train and eval steps of a :class:`DGNN`, :class:`SAGE` or
    :class:`GAT` over a :class:`DeviceGraph`.  The optimizer is Adam at
    ``lr`` with optax's defaults (``train.py:262``), or ``optimizer(params)``
    where given: a callable from the model's parameters to a
    ``torch.optim.Optimizer``.  ``neg_sample_ratio`` is the negatives per
    edge and must be the model's (``train.py:263-269``); a batch then holds
    ``(2 + r)·B`` roots.

    ``fanouts`` has one entry per model layer, outermost first;
    ``sample_strategy`` is ``"recent"`` or ``"uniform"`` (draws from the
    state's sampling generator).  ``num_snapshots`` windows of
    ``snapshot_time_window`` each end at a root's timestamp (one snapshot:
    the window ``[ts - W, ts)``, or the full history at 0); ``prop_time``
    gives neighbours their root's timestamp.  ``is_static`` samples the
    batch roots at the timestamp ``3.4e38`` (deeper layers at their parent
    edges' timestamps), as the static models are trained.

    ``dedup_factor`` sizes the compact table of the memory dedup as a
    fraction of the instances (``None``: off; models with memory only).
    ``apan_table`` gives the transformer memory updater the raw state, from
    which it pulls pre-projected K/V rows, instead of per-instance rows
    (``"auto"``: on for the transformer updater, ``train.py:232-241``).
    ``layer_dedup`` is the layer (or, with windowed snapshots, snapshot)
    dedup's factor or ascending ladder of factors (``None``: off; DGNNs of
    two or more layers without memory, not static, and static SAGE and GAT
    of two or more layers).  ``model_compact`` runs the block compaction
    of windowed snapshots at ``compact_factor``, which with windowed
    snapshots also compacts the padded path's sampling.
    ``"auto"``: ``compact_factor`` 0.25 and ``model_compact`` on for
    windowed snapshots and two or more layers without memory, until
    :meth:`calibrate` measures the stream, which the first
    :meth:`train_step` does; the dedups stay off until then.  An explicit
    value, ``None`` included, is a decision calibration keeps
    (``train.py:165-218, 271-286``).  ``auto_calibrate`` (``"auto"``: when
    a knob is left to it) says whether the first :meth:`train_step`
    calibrates; False keeps the knobs at their defaults.
    ``memory_storage="bfloat16"`` stores memory and mails in bf16
    (``train.py:264, 396``): half the memory table's bytes, values rounded
    to bf16 at the write-back.  ``gru_table`` (``"auto"``: off, as in JAX)
    runs the GRU memory updater on the per-node gate table where the node
    table is at most twice the instances (``train.py:242-258,
    848-850``); it needs memory, the GRU updater and one mail slot."""

    def __init__(self, model: DGNN, *, fanouts, sample_strategy="recent",
                 num_snapshots: int = 1, snapshot_time_window: float = 0.0,
                 prop_time: bool = False, lr: float = 1e-4,
                 compact_factor="auto", dedup_factor="auto",
                 model_compact="auto", layer_dedup="auto",
                 apan_table="auto", is_static: bool = False,
                 memory_storage: str = "float32", device="cuda",
                 optimizer=None, neg_sample_ratio: int = 1,
                 gru_table="auto", auto_calibrate="auto"):
        self.fanouts = tuple(int(f) for f in fanouts)
        if len(self.fanouts) != model.num_layers:
            raise ValueError(f"{len(self.fanouts)} fanouts for a model of "
                             f"{model.num_layers} layers")
        if sample_strategy not in ("recent", "uniform"):
            raise ValueError(f"sample_strategy must be 'recent' or "
                             f"'uniform', got {sample_strategy!r}")
        if int(num_snapshots) != model.num_snapshots:
            raise ValueError(f"{num_snapshots} snapshots for a model of "
                             f"{model.num_snapshots}")
        if memory_storage not in memory_lib.STORAGES:
            raise ValueError(f"memory_storage must be 'float32' or "
                             f"'bfloat16', got {memory_storage!r}")
        self.memory_storage = memory_storage
        self.strategy = sample_strategy
        self.num_snapshots = int(num_snapshots)
        self.window = float(snapshot_time_window)
        self.prop_time = bool(prop_time)
        self.is_static = bool(is_static)
        self.model = model
        self.lr = lr
        self.optimizer = optimizer
        self.neg_ratio = int(neg_sample_ratio)
        model_ratio = int(getattr(model, "neg_sample_ratio", 1))
        if model_ratio != self.neg_ratio:
            raise ValueError(f"model neg_sample_ratio={model_ratio} != "
                             f"trainer neg_sample_ratio={self.neg_ratio}")
        self.gru_table = False if gru_table == "auto" else bool(gru_table)
        if self.gru_table and (
                not model.use_memory
                or getattr(model, "memory_updater", "gru") != "gru"
                or getattr(model, "mailbox_slots", 1) != 1):
            raise ValueError(
                "gru_table requires use_memory with the GRU updater and "
                "a single-slot mailbox (the per-node gate pre-projection "
                "is GRU math; APAN's transformer updater and multi-slot "
                "mailboxes have no table form)")
        self.device = resolve_device(device)
        self._auto = {"compact": compact_factor == "auto",
                      "dedup": dedup_factor == "auto",
                      "layer_dedup": layer_dedup == "auto"}
        windowed = self._windowed()
        self.compact_factor = (0.25 if windowed else None) \
            if self._auto["compact"] else compact_factor
        self.model_compact = bool(
            windowed and len(self.fanouts) >= 2 and not model.use_memory
            if model_compact == "auto" else model_compact)
        self.dedup_factor = None if self._auto["dedup"] else dedup_factor
        self.apan_table = (model.use_memory
                           and model.memory_updater == "transformer") \
            if apan_table == "auto" else bool(apan_table)
        self.layer_dedup = None if self._auto["layer_dedup"] \
            else layer_dedup
        # deeper boundaries' own cap factor; None: the ladder's largest
        self.layer_dedup_deep = None
        if self.layer_dedup is not None and not self._layer_dedup_ok():
            raise ValueError("layer_dedup requires a DGNN of two or more "
                             "layers without memory (TGAT), with one "
                             "snapshot or windowed ones (DySAT), or a static "
                             "SAGE or GAT of two or more layers")
        # the data-parallel collectives (parallel/dp.py), None on one device
        self.dp = None
        if auto_calibrate == "auto":
            auto_calibrate = (
                (windowed and (self._auto["compact"]
                               or self._auto["layer_dedup"]))
                or (model.use_memory and self._auto["dedup"])
                or (self._layer_dedup_ok() and self._auto["layer_dedup"]))
        self._calibrated = not auto_calibrate
        self.calibration: Optional[dict] = None

    def _windowed(self) -> bool:
        return self.num_snapshots > 1 and self.window > 0

    def _layer_dedup_ok(self) -> bool:
        """Does the layer dedup apply (``train.py:291-310``): two or more
        layers, and a DGNN without memory, not static, with one snapshot
        or windowed ones, or a static SAGE or GAT.  Static deeper layers
        sample at their parent edges' timestamps, so the key stays (nid,
        ts)."""
        if len(self.fanouts) < 2:
            return False
        if isinstance(self.model, (SAGE, GAT)):
            return self.is_static
        return (not self.is_static and not self.model.use_memory
                and (self.num_snapshots == 1 or self.window > 0))

    def init_state(self, num_nodes: int, seed: int = 0) -> TrainState:
        """Zero memory for ``num_nodes`` nodes and the model's mail slots
        (models with memory), a fresh optimizer state, a dropout generator
        seeded with ``seed`` and a sampling generator seeded with
        ``SAMPLE_SEED_OFFSET + seed``, on the trainer's device."""
        memory = None
        if self.model.use_memory:
            memory = self._init_memory(num_nodes)
        return TrainState(
            memory=memory,
            optimizer=torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                       betas=(0.9, 0.999), eps=1e-8)
            if self.optimizer is None
            else self.optimizer(self.model.parameters()),
            dropout_gen=torch.Generator(device=self.device).manual_seed(seed),
            sample_gen=torch.Generator(device=self.device).manual_seed(
                SAMPLE_SEED_OFFSET + seed),
            tier_takes=[0] * 4 if self._layer_dedup_ok() else None)

    def _init_memory(self, num_nodes: int) -> memory_lib.MemoryState:
        """The memory state of :meth:`init_state`, in ``memory_storage``
        (``train.py:390-396``); :class:`~gnnflow_tpu_torch.parallel.
        partitioned_trainer.PartitionedTrainer` shards it."""
        return memory_lib.init_memory(
            num_nodes, self.model.dim_memory, self.model.dim_edge,
            self.device, self.model.mailbox_slots, self.memory_storage)

    def _dedup_cap(self, num_all: int) -> int:
        return dedup_cap(self.dedup_factor, num_all)

    def _dedup_tiers(self) -> tuple:
        """``layer_dedup`` as an ascending tuple of factors."""
        ld = self.layer_dedup
        if ld is None:
            return ()
        if isinstance(ld, (tuple, list)):
            return tuple(sorted(float(f) for f in ld))
        return (float(ld),)

    def _uniform(self, gen: torch.Generator, shape) -> torch.Tensor:
        """Uniform sampling's draws in [0, 1), float32, on ``gen``'s
        device."""
        return torch.rand(shape, generator=gen, device=gen.device)

    def _window_kw(self) -> dict:
        return dict(strategy=self.strategy, num_snapshots=self.num_snapshots,
                    window=self.window, prop_time=self.prop_time)

    def _sample_layer(self, gen, dg, R, T, layer: int,
                      shared_roots: bool = False) -> List[MFG]:
        """Every snapshot of one layer on [S, B] roots at [S, B]
        timestamps, with [S, B, F] uniform draws (``train.py:426-449``):
        S MFGs."""
        fanout = self.fanouts[layer]
        u = self._uniform(gen, tuple(R.shape) + (fanout,)) \
            if self.strategy == "uniform" else None
        if self.num_snapshots == 1:
            return [sample_layer(dg, R[0], T[0], fanout=fanout,
                                 u=None if u is None else u[0],
                                 **self._window_kw())]
        return sample_layer_snapshots(dg, R, T, fanout=fanout, u=u,
                                      shared_roots=shared_roots,
                                      **self._window_kw())

    def _sample(self, gen, dg, roots, ts,
                compact: bool = True) -> List[List[MFG]]:
        """Padded MFGs of every layer and snapshot, innermost first;
        windowed snapshots sample deeper layers compacted at
        ``compact_factor`` unless ``compact`` is False (calibration)."""
        return sample_hops(dg, roots, ts, fanouts=self.fanouts,
                           compact_factor=self.compact_factor if compact
                           else None,
                           draw=lambda _, shape: self._uniform(gen, shape),
                           **self._window_kw())

    def _chain(self, state: TrainState, dg, roots, ts, boundary):
        """The MFGs of a fast path, from the outer layer in: the first
        layer samples the batch roots (shared by the snapshots); at each
        deeper boundary ``boundary(layer, prev, sample)`` returns the next
        layer's S MFGs over a compact root set, sampled with
        ``sample(R, T)`` from [S, n] roots and timestamps, and the spec
        that expands its output back; or None, after which the remaining
        layers sample padded.  Returns ``(mfgs, expansions, compact)``,
        innermost first, and the number of boundaries on the fast path."""
        gen, S = state.sample_gen, self.num_snapshots
        mlist = [self._sample_layer(gen, dg, roots[None].expand(S, -1),
                                    ts[None].expand(S, -1), 0,
                                    shared_roots=True)]
        exps = [None]
        layer, L = 1, len(self.fanouts)
        while layer < L:
            step = boundary(layer, mlist[-1], lambda R, T, li=layer:
                            self._sample_layer(gen, dg, R, T, li))
            if step is None:
                break
            mlist.append(step[0])
            exps.append(step[1])
            layer += 1
        compact = layer - 1
        for li in range(layer, L):          # padded after an overflow
            prev = mlist[-1]
            mlist.append(self._sample_layer(
                gen, dg, torch.stack([m.all_nodes() for m in prev]),
                torch.stack([m.all_ts() for m in prev]), li))
            exps.append(None)
        return mlist[::-1], exps[::-1], compact

    def _model_compact_mfgs(self, state: TrainState, dg, roots, ts):
        """The block compaction's MFGs (``train.py:906-990``): each
        boundary packs each snapshot's valid neighbour blocks of the
        parent into ``ceil(compact_factor · B)`` slots (one host sync for
        the overflow) and the next layer samples the packed roots, whose
        output a ``("blocks", rank [S, B], cap, F)`` spec expands back.
        Returns ``(mfgs, expansions)``, innermost first."""
        def boundary(layer, prev, sample):
            B, F = prev[0].num_dst, prev[0].fanout
            cap = min(B, max(1, math.ceil(float(self.compact_factor) * B)))
            profiling.count("host_sync.boundary_overflow")
            if bool(boundary_overflow(prev, cap)):  # the boundary's sync
                return None
            inner, rank = sample_deeper_compact(dg, prev, cap,
                                                sample_fn=sample)
            return inner, ("blocks", rank, cap, F)

        mfgs, exps, state.block_compact = self._chain(state, dg, roots, ts,
                                                      boundary)
        return mfgs, exps

    def _dedup_mfgs(self, state: TrainState, dg, roots, ts):
        """The layer dedup's MFGs (``train.py:992-1091``), and with
        windowed snapshots the snapshot dedup's (``:1093-1198``): each
        boundary dedups each snapshot's parent instances at its largest
        cap, one host sync reads the largest unique count over the
        snapshots, and the next layer samples each snapshot's unique
        (nid, ts) pairs at the tightest cap that holds them all (unused
        rows invalid), or, at an overflow, every remaining layer padded.
        The first boundary takes the tier ladder, deeper ones
        ``layer_dedup_deep`` or the ladder's top.

        Returns ``(mfgs, expansions, take)``: MFGs and stacked [S, L]
        ``("rows", inv, sidx, rank_sorted)`` specs, innermost first (the
        spec of layer ``l`` expands its output to layer ``l + 1``'s
        instances), and the first boundary's histogram index."""
        factors = self._dedup_tiers()
        take, n_uniqs = [3], []

        def boundary(layer, prev, sample):
            with profiling.span("model.layer_dedup"):
                caps = tier_caps(factors if layer == 1 else
                                 [self.layer_dedup_deep or factors[-1]],
                                 prev[0].num_all)
                dd = [dedup_instances(m.all_nodes(), m.all_ts(),
                                      m.all_mask(), caps[-1]) for m in prev]
                profiling.count("host_sync.layer_dedup")
                n = int(torch.stack([d[3] for d in dd]).max())  # one sync
                n_uniqs.append(n)
                if layer == 1:
                    take[0] = min(sum(n > c for c in caps), 3)
                cap = next((c for c in caps if n <= c), None)
                profiling.count("layer_dedup.rows",
                                len(prev) * prev[0].num_all)
                profiling.count("layer_dedup.unique", n)
                if cap is None:
                    profiling.count("layer_dedup.overflow")
                    return None
                profiling.count("layer_dedup.cap", cap)
            slot = torch.arange(cap, device=roots.device)
            R = torch.stack([torch.where(slot < d[3], d[0][:cap],
                                         INVALID_NID) for d in dd])
            T = torch.stack([d[1][:cap] for d in dd])
            return sample(R, T), ("rows",) + tuple(
                torch.stack([d[i] for d in dd]) for i in (2, 4, 5))

        mfgs, exps, state.layer_dedup_compact = self._chain(
            state, dg, roots, ts, boundary)
        state.layer_dedup_n_uniq = n_uniqs
        return mfgs, exps, take[0]

    @profiling.traced("memory.pull")
    def _mem_input(self, state: TrainState, mfg: MFG,
                   node_feats: Optional[torch.Tensor], dedup: bool = True):
        """The memory updater's input (``train.py:834-904``): the dedup's
        compact input, with the node-feature table, when ``dedup`` and the
        factor are set and the batch's unique pairs fit its cap; else the
        raw state for the transformer updater's table path
        (``apan_table``, the sharded table over sharded memory; not over
        a bf16-stored state, which takes the per-instance pull, as JAX's
        packed state does, ``:842``); else the raw state for the GRU's
        gate table (``gru_table``, one mail slot, a node table at most
        twice the instances, ``:848-850``; not over a sharded state,
        which no rank holds whole); else the per-instance pull, in bf16
        under bf16 compute when the node table is small next to the
        instance count or is stored in bf16 (``:851-858``; timestamps stay
        f32).  With ``dedup``, records the unique count in
        ``state.dedup_n_uniq``.

        Over sharded memory or node features every pull is a collective,
        and ranks may take different branches here (each counts its own
        slice's pairs): both branches pull memory once, then node features
        once (the dedup's inside the updater), APAN's through its K/V
        table on both or on neither (which adds one exchange in the
        backward pass), so the ranks stay in step."""
        memory = state.memory
        if dedup:
            state.dedup_n_uniq = None
        if dedup and self.dedup_factor:
            cap = self._dedup_cap(mfg.num_all)
            uniq_nid, uniq_ts, inv, n_uniq, sidx, rank_sorted = \
                dedup_instances(mfg.all_nodes(), mfg.all_ts(),
                                mfg.all_mask(), cap)
            profiling.count("host_sync.memory_dedup")
            state.dedup_n_uniq = int(n_uniq)      # the step's host sync
            if state.dedup_n_uniq <= cap:
                return memory_lib.DedupMemoryInput(
                    state=memory, uniq_nids=uniq_nid, uniq_ts=uniq_ts,
                    inv=inv, sidx=sidx, rank_sorted=rank_sorted,
                    node_feats=node_feats,
                    table=self.apan_table or memory.shard is None)
        if self.apan_table and self.model.memory_updater == "transformer" \
                and memory_lib.table_ok(memory):
            return memory_lib.RawMemoryInput(memory)
        if self.gru_table and memory.mailbox_slots == 1 \
                and memory.shard is None \
                and memory.num_nodes <= 2 * mfg.num_all:
            return memory_lib.RawMemoryInput(memory)
        if self.model.compute_dtype == "bfloat16" \
                and (memory.storage == "bfloat16"
                     or 3 * memory.num_nodes <= mfg.num_all):
            return memory_lib.prepare_input(memory, mfg, torch.bfloat16)
        return memory_lib.prepare_input(memory, mfg)

    @profiling.traced("trainer.batch_upload")
    def batch_arrays(self, batch: Batch):
        """``(target_nodes, ts, eids, valid)`` of ``batch`` on the
        trainer's device; ``valid`` [B] masks padded rows."""
        dev = self.device
        valid = torch.zeros(batch.batch_size, dtype=torch.bool)
        valid[: batch.num_valid] = True
        profiling.count("host_sync.batch_upload", 4)
        return (torch.from_numpy(batch.target_nodes).to(dev),
                torch.from_numpy(batch.ts).to(dev),
                torch.from_numpy(batch.eids).to(dev), valid.to(dev))

    def _check_roots(self, target_nodes: torch.Tensor,
                     valid: torch.Tensor) -> None:
        blocks = 2 + self.neg_ratio
        if target_nodes.shape[-1] != blocks * valid.shape[-1]:
            raise ValueError(
                f"a batch of {valid.shape[-1]} edges has "
                f"{target_nodes.shape[-1]} roots, but neg_sample_ratio="
                f"{self.neg_ratio} needs {blocks}·B: draw the batches with "
                f"get_batches(..., neg_sample_ratio={self.neg_ratio})")

    @torch.no_grad()
    def _inputs(self, state: TrainState, dg: DeviceGraph,
                edge_feats: Optional[torch.Tensor], batch,
                train: bool = False,
                node_feats: Optional[torch.Tensor] = None):
        """Sample, gather edge features and pull memory rows for a batch (a
        :class:`Batch`, or ``(target_nodes, ts, eids, valid)`` on the
        device): ``(mfgs, efs, mem_input, eids, valid, expansions)``;
        ``mem_input``
        is None without memory, ``expansions`` None on the padded path.
        Edge features are not gathered for a model without them: the JAX
        step drops that gather as dead code.
        The path is the first that is set of the snapshot dedup, the block
        compaction, the layer dedup and the padded path
        (``train.py:1209-1236``).  The layer or snapshot dedup's take is
        kept in ``state.last_take``, and a train batch counts it in
        ``state.tier_takes`` (a data-parallel step counts the worst
        rank's, after its all-reduce)."""
        target_nodes, ts, eids, valid = self.batch_arrays(batch) \
            if isinstance(batch, Batch) else batch
        self._check_roots(target_nodes, valid)
        if self.is_static:
            ts = torch.full_like(ts, STATIC_SAMPLE_TS)
        expansions, take = None, None
        state.layer_dedup_n_uniq, state.layer_dedup_compact = None, 0
        state.block_compact = 0
        compaction = self.model_compact and self.compact_factor is not None
        with profiling.span("sampler.sample"):
            if self.layer_dedup is not None and (self.num_snapshots > 1
                                                 or not compaction):
                mfgs, expansions, take = self._dedup_mfgs(state, dg,
                                                          target_nodes, ts)
            elif compaction:
                mfgs, expansions = self._model_compact_mfgs(
                    state, dg, target_nodes, ts)
            else:
                mfgs = self._sample(state.sample_gen, dg, target_nodes, ts)
        state.last_take = take
        if train and take is not None and self.dp is None:
            state.tier_takes[take] += 1
        if expansions is not None and all(e is None for e in expansions):
            expansions = None
        efs = fetch_features(mfgs, edge_feats if self.model.dim_edge
                             else None)
        mem_input = self._mem_input(state, mfgs[0][0], node_feats) \
            if self.model.use_memory else None
        return mfgs, efs, mem_input, eids, valid, expansions

    @torch.no_grad()
    def _node_inputs(self, mfgs, mem_input, node_feats, train: bool):
        """The innermost MFGs' node features, in the dtype the model asks
        for; None where the memory dedup's updater gathers them itself
        (``train.py:886-894``)."""
        if isinstance(mem_input, memory_lib.DedupMemoryInput):
            return None
        return fetch_node_features(mfgs, node_feats,
                                   self.model.node_feat_dtype(train))

    def _root_rows(self, last: dict, valid: torch.Tensor) -> dict:
        """The updater's dst rows of the batch roots, the first ``(2 +
        r)·B``.  With memory over one layer they are all of them; over
        more, the innermost MFG's dst rows are the next layer's instances,
        whose first rows are the roots.  JAX hands all of them to
        ``update_mem_mail``, which then fails on their shapes
        (``memory.py:766-776``); the port writes back the roots, the rows
        a one-layer model writes back (ROADMAP.md §3)."""
        n = (2 + self.neg_ratio) * valid.shape[0]
        return {k: v[:n] for k, v in last.items()}

    @torch.no_grad()
    def _write_back(self, state: TrainState, last, edge_feats, eids,
                    valid) -> None:
        if last is None:                   # a model without memory
            return
        with profiling.span("memory.write_back"):
            last = self._root_rows(last, valid)
            if self.dp is not None:
                last, eids, valid = self.dp.gather_write_back(last, eids,
                                                              valid)
            # target-edge features for the mails
            tef = _gather_rows(edge_feats, eids, valid)
            memory_lib.update_mem_mail(
                state.memory, last["last_updated_nid"],
                last["last_updated_memory"], last["last_updated_ts"],
                edge_feats=tef, valid=valid, neg_sample_ratio=self.neg_ratio)

    @profiling.traced("trainer.train_step", step=True)
    def train_step(self, state: TrainState, dg: DeviceGraph,
                   edge_feats: Optional[torch.Tensor], batch: Batch, *,
                   node_feats: Optional[torch.Tensor] = None):
        """One train step (``train.py:1371-1378``) over the edge-feature
        table and the node-feature table (None: without): forward with
        dropout, loss, backward, an Adam step, then (with memory) the
        write-back of memory computed with the pre-step parameters.
        Updates the model's parameters, ``state`` and the optimizer in
        place and remakes the model's compute-dtype weight copies.

        The first call calibrates the knobs left to it (the JAX
        ``train_step``; ``eval_step`` never calibrates).

        Returns ``(state, loss, pos_logits [B], neg_logits [r·B])``,
        detached."""
        self._maybe_auto_calibrate(dg, batch.target_nodes, batch.ts)
        return self._train(state, dg, edge_feats, self.batch_arrays(batch),
                           node_feats)

    def train_step_arrays(self, state: TrainState, dg: DeviceGraph,
                          edge_feats: Optional[torch.Tensor],
                          target_nodes: torch.Tensor, ts: torch.Tensor,
                          eids: torch.Tensor, valid: torch.Tensor, *,
                          train: bool = True,
                          node_feats: Optional[torch.Tensor] = None):
        """:meth:`train_step` (or with ``train=False`` :meth:`eval_step`)
        on a batch already on the device (``train.py:1341-1348``):
        ``target_nodes`` and ``ts`` [(2+r)·B], ``eids`` and the bool
        ``valid`` [B]; no host conversion of the batch.  A train step
        calibrates first where :meth:`train_step` would (one copy of the
        roots and timestamps to the host, once)."""
        arrays = (target_nodes, ts, eids, valid)
        if not train:
            return self.eval_step(state, dg, edge_feats, arrays,
                                  node_feats=node_feats)
        with profiling.span("trainer.train_step", step=True):
            if not self._calibrated:
                profiling.count("host_sync.calibrate", 2)
                self._maybe_auto_calibrate(dg, target_nodes.cpu().numpy(),
                                           ts.cpu().numpy())
            return self._train(state, dg, edge_feats, arrays, node_feats)

    def train_steps_scan(self, state: TrainState, dg: DeviceGraph,
                         edge_feats: Optional[torch.Tensor],
                         target_nodes: torch.Tensor, ts: torch.Tensor,
                         eids: torch.Tensor, valid: torch.Tensor, *,
                         node_feats: Optional[torch.Tensor] = None):
        """K train steps in one call over batches staged on the device
        with a leading step axis (``train.py:1350-1369``):
        ``target_nodes`` and ``ts`` [K, (2+r)·B], ``eids`` and ``valid``
        [K, B].  PyTorch runs eagerly, so this is a loop of
        :meth:`train_step_arrays` steps with no per-step host conversion,
        calibrating on the first step's batch as JAX's ``lax.scan`` does;
        each step equals :meth:`train_step` on the same batch, bit for
        bit.  Returns ``(state, losses [K])``."""
        if not self._calibrated:
            profiling.count("host_sync.calibrate", 2)
            self._maybe_auto_calibrate(dg, target_nodes[0].cpu().numpy(),
                                       ts[0].cpu().numpy())
        losses = []
        for k in range(target_nodes.shape[0]):
            with profiling.span("trainer.train_step", step=True):
                state, loss, _, _ = self._train(
                    state, dg, edge_feats,
                    (target_nodes[k], ts[k], eids[k], valid[k]), node_feats)
            losses.append(loss)
        return state, torch.stack(losses)

    def _train(self, state: TrainState, dg: DeviceGraph, edge_feats,
               arrays, node_feats):
        """One train step on ``(target_nodes, ts, eids, valid)`` of the
        global batch on the device."""
        part, num_valid = arrays, None
        if self.dp is not None:
            part, num_valid = self.dp.local_arrays(arrays), arrays[3].sum()
        mfgs, efs, mem_input, eids, valid, expansions = self._inputs(
            state, dg, edge_feats, part, train=True, node_feats=node_feats)
        nfs = self._node_inputs(mfgs, mem_input, node_feats, True)
        pos, neg, last = self._forward(mfgs, efs, mem_input, train=True,
                                       generator=state.dropout_gen,
                                       expansions=expansions, node_feats=nfs)
        loss = link_pred_loss(pos, neg, valid, self.neg_ratio, num_valid)
        self._backward(state, loss)
        if self.dp is not None:
            loss, take = self.dp.reduce_step(self.model.parameters(), loss,
                                             state.last_take)
            if take is not None:
                state.tier_takes[take] += 1
        self._optimizer_step(state)
        self._write_back(state, last, edge_feats, eids, valid)
        state.step += 1
        return (state, loss.detach()) + self._logits(pos, neg)

    @profiling.traced("model.forward")
    def _forward(self, *args, **kw):
        """The model's forward pass over a step's inputs."""
        return self.model(*args, **kw)

    def _backward(self, state: TrainState, loss: torch.Tensor) -> None:
        with profiling.span("trainer.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with profiling.span("trainer.backward"):
            loss.backward()

    @profiling.traced("trainer.optimizer")
    def _optimizer_step(self, state: TrainState) -> None:
        """The optimizer's step, then the model's compute-dtype weight
        copies remade."""
        state.optimizer.step()
        self.model.cast_weights()

    def _logits(self, pos: torch.Tensor, neg: torch.Tensor):
        """``(pos [B], neg [r·B])`` of the whole batch, detached: gathered
        over the ranks of a data-parallel step, each of the ``r`` negative
        blocks in the single-device order."""
        pos, neg = pos[:, 0].detach(), neg[:, 0].detach()
        if self.dp is not None:
            pos, neg = self.dp.gather(pos), self.dp.gather(neg)
            neg = neg.reshape(self.dp.world_size, self.neg_ratio, -1) \
                .transpose(0, 1).reshape(-1)
        return pos, neg

    def train_step_prefetched(self, state: TrainState, mfgs, nfs, efs, tef,
                              batch: Batch, train: bool = True):
        """One step over MFGs sampled outside the trainer (a
        :class:`~gnnflow_tpu_torch.temporal_sampler.TemporalSampler`) and
        the features a :class:`~gnnflow_tpu_torch.cache.Cache` fetched for
        them (``train.py:1267-1339``): ``nfs[s]`` the innermost MFGs'
        [B·(1+F), dim_node] node features (None, or a list of None,
        without), ``efs[l][s]`` each MFG's [B, F, dim_edge] edge features,
        ``tef`` the batch's [B, dim_edge] target-edge features, which the
        mails carry.  MFGs sampled on the CPU (a store placed on the host)
        move to the trainer's device first (``:1331-1336``).

        The memory dedup runs where its factor is set, for models with
        memory and without node features (``:1273-1274``; one host sync);
        no layer dedup, snapshot dedup or block compaction runs, and this
        step never calibrates.  Node features reach the model in the dtype
        :meth:`train_step` gathers them in.  ``train=True`` takes an Adam
        step and remakes the model's compute-dtype weight copies, as
        :meth:`train_step`; ``train=False`` is the cache path's eval step
        (``scripts/offline_edge_prediction.py:231-236``).  Both write
        memory back (models with memory).

        Returns ``(state, loss, pos_logits [B], neg_logits [B])``,
        detached."""
        with profiling.span("trainer.train_step" if train
                            else "trainer.eval_step", step=True):
            return self._prefetched(state, mfgs, nfs, efs, tef, batch, train)

    def _prefetched(self, state, mfgs, nfs, efs, tef, batch, train):
        """:meth:`train_step_prefetched` inside its step's span."""
        mfgs = [[_mfg_to(m, self.device) for m in layer] for layer in mfgs]
        valid = torch.zeros(batch.batch_size, dtype=torch.bool)
        valid[: batch.num_valid] = True
        profiling.count("host_sync.batch_upload")
        valid = valid.to(self.device)
        state.dedup_n_uniq = None
        with torch.no_grad():
            mem_input = self._mem_input(
                state, mfgs[0][0], None,
                dedup=getattr(self.model, "dim_node", 0) == 0) \
                if self.model.use_memory else None
            node_in = None
            if nfs is not None and not isinstance(
                    mem_input, memory_lib.DedupMemoryInput):
                dtype = self.model.node_feat_dtype(train)
                node_in = [None if nf is None else nf.to(dtype)
                           for nf in nfs]
        with torch.set_grad_enabled(train):
            pos, neg, last = self._forward(mfgs, efs, mem_input, train=train,
                                           generator=state.dropout_gen,
                                           node_feats=node_in)
            loss = link_pred_loss(pos, neg, valid, self.neg_ratio)
        if train:
            self._backward(state, loss)
            self._optimizer_step(state)
            state.step += 1
        if last is not None:
            with profiling.span("memory.write_back"), torch.no_grad():
                last = self._root_rows(last, valid)
                memory_lib.update_mem_mail(
                    state.memory, last["last_updated_nid"],
                    last["last_updated_memory"], last["last_updated_ts"],
                    edge_feats=tef, valid=valid,
                    neg_sample_ratio=self.neg_ratio)
        return state, loss.detach(), pos[:, 0].detach(), neg[:, 0].detach()

    @profiling.traced("trainer.eval_step", step=True)
    @torch.no_grad()
    def eval_step(self, state: TrainState, dg: DeviceGraph,
                  edge_feats: Optional[torch.Tensor], batch, *,
                  node_feats: Optional[torch.Tensor] = None):
        """One eval step, on the layer dedup where it is set, as the JAX
        ``_step`` (``train.py:1227-1233``); updates ``state.memory`` in
        place.  ``batch`` is a :class:`Batch` or ``(target_nodes, ts,
        eids, valid)`` on the device.

        Returns ``(state, loss, pos_logits [B], neg_logits [r·B])``."""
        arrays = self.batch_arrays(batch) if isinstance(batch, Batch) \
            else batch
        part, num_valid = arrays, None
        if self.dp is not None:
            part, num_valid = self.dp.local_arrays(arrays), arrays[3].sum()
        mfgs, efs, mem_input, eids, valid, expansions = self._inputs(
            state, dg, edge_feats, part, node_feats=node_feats)
        nfs = self._node_inputs(mfgs, mem_input, node_feats, False)
        pos, neg, last = self._forward(mfgs, efs, mem_input,
                                       expansions=expansions, node_feats=nfs)
        loss = link_pred_loss(pos, neg, valid, self.neg_ratio, num_valid)
        if self.dp is not None:
            loss = self.dp.reduce_loss(loss)
        self._write_back(state, last, edge_feats, eids, valid)
        return (state, loss) + self._logits(pos, neg)

    @torch.no_grad()
    def embed_step(self, state: TrainState, dg: DeviceGraph,
                   edge_feats: Optional[torch.Tensor], batch: Batch, *,
                   node_feats: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """The batch roots' embeddings (``train.py:1380-1409``): the padded
        path's sample (static models at ``3.4e38``), the feature gathers,
        the memory pull (TGN, APAN), then the model at ``train=False,
        return_embed=True``.  No fast path runs, whatever is set, and
        ``state`` is left as it was: memory is not written back and the
        sampling generator does not advance.

        Returns the [(2+r)·B, dim_embed] embeddings."""
        dev = self.device
        profiling.count("host_sync.batch_upload", 2)
        roots = torch.from_numpy(batch.target_nodes).to(dev)
        ts = torch.from_numpy(batch.ts).to(dev)
        if self.is_static:
            ts = torch.full_like(ts, STATIC_SAMPLE_TS)
        gen = torch.Generator(device=dev)
        gen.set_state(state.sample_gen.get_state())
        mfgs = self._sample(gen, dg, roots, ts)
        efs = fetch_features(mfgs, edge_feats if self.model.dim_edge
                             else None)
        mem_input = self._mem_input(state, mfgs[0][0], node_feats,
                                    dedup=False) \
            if self.model.use_memory else None
        nfs = self._node_inputs(mfgs, mem_input, node_feats, False)
        embed, _ = self._forward(mfgs, efs, mem_input, node_feats=nfs,
                                 return_embed=True)
        return embed

    @profiling.traced("trainer.calibrate")
    def calibrate(self, dg: DeviceGraph, batches, *, max_batches: int = 3,
                  occ_batches=()) -> dict:
        """Pick the knobs left on ``"auto"`` from the measured stream
        (``train.py:451-698``).

        Samples, padded and uncompacted, up to ``max_batches`` of
        ``batches`` (batch objects or ``(roots, ts)`` pairs) and every
        ``(roots, ts)`` pair of ``occ_batches``; uniform draws come from a
        generator seeded with 0 for each probe, as the JAX package's one
        probe key.  With windowed snapshots, the worst occupancy of deeper
        layers' neighbour slots sets ``compact_factor``
        (:func:`compact_factor_for`).  With memory, the worst unique
        fraction ``u`` of the memory instances sets ``dedup_factor``
        (:func:`dedup_factor_for`).  Where the layer dedup applies, each
        probe gives the unique fraction at the first layer boundary and the
        worst at deeper ones (each the largest over the snapshots), and
        :func:`tier_ladder` sets ``layer_dedup`` and ``layer_dedup_deep``.
        Returns ``{"occupancy", "uniq_frac", "boundary_uniq_frac",
        "compact_factor", "dedup_factor", "layer_dedup",
        "layer_dedup_deep"}``, also kept as ``self.calibration``."""
        self._calibrated = True
        windowed = self._windowed()
        occ, uniq_frac, boundary_frac = [], [], []
        probes = [b if isinstance(b, tuple) else (b.target_nodes, b.ts)
                  for b in itertools.islice(batches, max_batches)]
        for i, (roots, ts) in enumerate(probes + list(occ_batches)):
            o, u, b = self._probe(dg, roots, ts)
            # occupancy counts on the stream-shifted probes only when
            # windowed (``:571-572``); it is read only then anyway
            if i < len(probes) or windowed:
                occ += o
            if u is not None:
                uniq_frac.append(u)
            if b is not None:
                boundary_frac.append(b)
        stats = {"occupancy": max(occ) if occ else None,
                 "uniq_frac": max(uniq_frac) if uniq_frac else None,
                 "boundary_uniq_frac": max(m for _, m in boundary_frac)
                 if boundary_frac else None}
        if occ and windowed and self._auto["compact"]:
            self.compact_factor = compact_factor_for(stats["occupancy"])
        if uniq_frac and self._auto["dedup"]:
            self.dedup_factor = dedup_factor_for(stats["uniq_frac"],
                                                 self.model.memory_updater)
        if boundary_frac and self._auto["layer_dedup"]:
            self.layer_dedup, self.layer_dedup_deep = tier_ladder(
                boundary_frac, len(self.fanouts),
                self.compact_factor if self.num_snapshots > 1 else None)
        stats.update(compact_factor=self.compact_factor,
                     dedup_factor=self.dedup_factor,
                     layer_dedup=self.layer_dedup,
                     layer_dedup_deep=self.layer_dedup_deep)
        self.calibration = stats
        return stats

    @torch.no_grad()
    def _probe(self, dg: DeviceGraph, roots, ts):
        """One calibration probe, sampled padded and uncompacted
        (``train.py:496-538``): the occupancy of each deeper layer's
        neighbour slots in each snapshot; the unique fraction of the
        innermost MFG's memory instances (None without memory); where the
        layer dedup applies, the pair (unique fraction at the first
        boundary, worst at deeper boundaries; 0.0 without any), each the
        largest over the snapshots, else None.  The probe samples where
        the store's view lies (the CPU for a store placed on the host)."""
        dev = dg.device
        gen = torch.Generator(device=dev).manual_seed(0)
        ts = np.asarray(ts, np.float32)
        if self.is_static:               # every probe, shifted or not
            ts = np.full_like(ts, STATIC_SAMPLE_TS)
        profiling.count("host_sync.calibrate", 2)
        mfgs = self._sample(
            gen, dg, torch.from_numpy(np.asarray(roots, np.int64)).to(dev),
            torch.from_numpy(ts).to(dev), compact=False)
        profiling.count("host_sync.calibrate",
                        sum(len(layer) for layer in mfgs[1:]))
        occ = [m.nbr_mask.float().mean().item()
               for layer in mfgs[1:] for m in layer]
        u = _uniq_pairs_frac(mfgs[0][:1]) if self.model.use_memory \
            else None
        b = None
        if self._layer_dedup_ok():
            # mfgs[1:] run from the layer after the innermost out; the
            # outermost's instances are the first boundary's roots
            us = [_uniq_pairs_frac(layer) for layer in mfgs[1:]]
            b = (us[-1], max(us[:-1]) if len(us) > 1 else 0.0)
        return occ, u, b

    def _maybe_auto_calibrate(self, dg: DeviceGraph, roots, ts) -> None:
        """First-batch calibration (``train.py:719-750``): the batch, and
        the same roots with the batch's timestamps shifted to a third, two
        thirds and the end of the stream, since uniqueness grows as the
        histories do."""
        if self._calibrated:
            return
        ts_arr = np.asarray(ts, np.float32)
        profiling.count("host_sync.calibrate")
        t_hi = dg.max_ts()
        t_b = float(ts_arr.max())
        probes = [(roots, ts_arr + np.float32(q * t_hi - t_b))
                  for q in (0.33, 0.67, 1.0)]
        stats = self.calibrate(dg, [(roots, ts)], max_batches=1,
                               occ_batches=probes)
        logging.getLogger(__name__).info("auto-calibration: %s", stats)

    def tier_take_stats(self, state: TrainState) -> Optional[dict]:
        """The layer dedup's take histogram over train steps
        (``train.py:752-765``): ``{"counts", "total", "tiers",
        "fallback_rate"}``; None for models it does not apply to."""
        if state.tier_takes is None:
            return None
        counts = list(state.tier_takes)
        total = sum(counts)
        tiers = self._dedup_tiers()
        fb = sum(counts[min(len(tiers), 3):]) if tiers else 0
        return {"counts": counts, "total": total, "tiers": tiers,
                "fallback_rate": (fb / total) if total else 0.0}

    def maybe_recalibrate(self, state: TrainState, dg: DeviceGraph, roots,
                          ts, *, threshold: float = 0.3,
                          min_steps: int = 20) -> TrainState:
        """When more than ``threshold`` of at least ``min_steps`` train
        steps since the last (re)calibration fell back to the padded
        path, calibrate again around ``(roots, ts)`` and zero the take
        histogram (``train.py:767-785``); call once per epoch.  Returns
        ``state``."""
        stats = self.tier_take_stats(state)
        if not stats or stats["total"] < min_steps \
                or not self._dedup_tiers() \
                or stats["fallback_rate"] <= threshold:
            return state
        self._calibrated = False
        self._maybe_auto_calibrate(dg, np.asarray(roots, np.int32),
                                   np.asarray(ts, np.float32))
        state.tier_takes = [0] * 4
        return state
