"""The train and eval steps of TGN and TGAT streaming link prediction.

Counterpart of ``gnnflow_tpu/train.py``: ``link_pred_loss``
(``:49-65``), ``_gather_rows`` and ``fetch_features`` (``:92-137``), and a
``Trainer`` with ``init_state``, ``train_step`` and ``eval_step``
(``:1200-1265, 1371-1378, 1411-1417``).  A step samples the batch roots'
neighbours over every layer (most recent or uniform), gathers edge
features, pulls memory rows (TGN), runs the model (GRU memory update,
temporal attention layers, edge predictor) and computes the loss; a train
step then back-propagates and takes an Adam step; with memory, both write
memory and mails back, computed with the parameters from before the step.
PyTorch runs eagerly, so there is no ``jit``.

Two exact dedups are ported, each a Python branch on a unique count where
the JAX package has ``lax.cond``, so one host sync per decision:

- the (nid, ts) memory dedup (``dedup_factor``, ``:861-904``) for models
  with memory, calibrated on the first train step (``:451-623,
  719-750``);
- the layer dedup (``layer_dedup``, ``_layer_dedup_outputs``,
  ``:992-1091``) for models of two or more layers without memory (TGAT):
  a deeper layer samples only the unique (nid, ts) roots of its parent
  layer and its output expands back at the boundary.  A ladder of tiers
  takes the tightest cap that fits at the first boundary; deeper
  boundaries take one cap; an overflow runs the remaining layers padded.
  ``calibrate`` picks the ladder (``:514-538, 624-698``), and
  ``tier_take_stats`` and ``maybe_recalibrate`` follow the takes
  (``:752-785``).

The block compaction of windowed snapshots (``compact_factor``,
``model_compact``) comes with the DySAT slice; the GRU-table path is an
opt-in variant not ported yet (ROADMAP.md).
"""
from __future__ import annotations

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
from gnnflow_tpu_torch.ops.dedup import dedup_instances
from gnnflow_tpu_torch.ops.sampling import sample_hops, sample_layer

# the sampling generator's seed is this plus init_state's seed, so its
# draws are not the dropout generator's
SAMPLE_SEED_OFFSET = 2 ** 32


@dataclass
class TrainState:
    """Node memory (None without memory), the optimizer over the model's
    parameters, the dropout and the sampling generators (on the trainer's
    device), the count of train steps, and what the last step's dedups
    saw: the memory dedup's unique (nid, ts) count (None when the step ran
    without it); the layer dedup's unique count at each boundary it
    examined and the number of boundaries that took a tier (each one
    expansion, whose backward is one K4 launch).  ``tier_takes`` is the
    layer dedup's take histogram over train steps (models it applies to;
    else None): index = tier caps the first boundary's unique count
    exceeded, 3 and up clamped to 3 (``train.py:40-46``)."""
    memory: Optional[memory_lib.MemoryState]
    optimizer: torch.optim.Optimizer
    dropout_gen: torch.Generator
    sample_gen: torch.Generator
    step: int = 0
    dedup_n_uniq: Optional[int] = None
    tier_takes: Optional[List[int]] = None
    layer_dedup_n_uniq: Optional[List[int]] = None
    layer_dedup_compact: int = 0


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor):
    """Elementwise torch BCEWithLogitsLoss, written as the JAX package's."""
    return logits.clamp_min(0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))


def link_pred_loss(pos: torch.Tensor, neg: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Masked ``mean(BCE(pos, 1)) + mean(BCE(neg, 0))`` over valid rows."""
    w = valid.float()[:, None]
    denom = w.sum().clamp_min(1.0)
    return (bce_with_logits(pos, torch.ones_like(pos)) * w).sum() / denom \
        + (bce_with_logits(neg, torch.zeros_like(neg)) * w).sum() / denom


def _gather_rows(table: Optional[torch.Tensor], ids: torch.Tensor,
                 valid: torch.Tensor) -> Optional[torch.Tensor]:
    """Row gather with padded-id masking (invalid rows are zero)."""
    if table is None:
        return None
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1)
    rows = table[flat].reshape(ids.shape + (table.shape[1],))
    return torch.where(valid[..., None], rows, 0.0)


def fetch_features(mfgs: List[List[MFG]],
                   edge_feats: Optional[torch.Tensor]):
    """Per-layer, per-snapshot [B, F, dim_edge] edge features."""
    return [[_gather_rows(edge_feats, m.nbr_eids, m.nbr_mask)
             for m in layer] for layer in mfgs]


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


def tier_ladder(boundary_frac, num_layers: int):
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
    float; none is None (off)."""
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
    return ladder, deep


def _uniq_pairs_frac(m: MFG) -> float:
    """Unique valid (nid, ts bits) pairs of an MFG's instances over all
    its instances."""
    nid = m.all_nodes().cpu().numpy()
    mts = m.all_ts().cpu().numpy().view(np.int32)
    valid = m.all_mask().cpu().numpy()
    pairs = np.stack([nid[valid], mts[valid]], 1)
    return np.unique(pairs, axis=0).shape[0] / max(nid.size, 1)


class Trainer:
    """Runs train and eval steps of a :class:`DGNN` over a
    :class:`DeviceGraph`.  The optimizer is Adam at ``lr`` with optax's
    defaults (``train.py:262``).

    ``fanouts`` has one entry per model layer, outermost first;
    ``sample_strategy`` is ``"recent"`` or ``"uniform"`` (draws from the
    state's sampling generator).

    ``dedup_factor`` sizes the compact table of the memory dedup as a
    fraction of the instances (``None``: off; models with memory only).
    ``layer_dedup`` is the layer dedup's factor or ascending ladder of
    factors (``None``: off; models of two or more layers without memory).
    ``"auto"`` leaves a knob off until :meth:`calibrate` measures the
    stream, which the first :meth:`train_step` does; an explicit value,
    ``None`` included, is a decision calibration keeps
    (``train.py:168-218, 271-286``)."""

    def __init__(self, model: DGNN, *, fanouts, sample_strategy="recent",
                 lr: float = 1e-4, dedup_factor="auto", layer_dedup="auto",
                 device="cuda"):
        self.fanouts = tuple(int(f) for f in fanouts)
        if len(self.fanouts) != model.num_layers:
            raise ValueError(f"{len(self.fanouts)} fanouts for a model of "
                             f"{model.num_layers} layers")
        if sample_strategy not in ("recent", "uniform"):
            raise ValueError(f"sample_strategy must be 'recent' or "
                             f"'uniform', got {sample_strategy!r}")
        self.strategy = sample_strategy
        self.model = model
        self.lr = lr
        self.device = resolve_device(device)
        self._auto = {"dedup": dedup_factor == "auto",
                      "layer_dedup": layer_dedup == "auto"}
        self.dedup_factor = None if self._auto["dedup"] else dedup_factor
        self.layer_dedup = None if self._auto["layer_dedup"] \
            else layer_dedup
        # deeper boundaries' own cap factor; None: the ladder's largest
        self.layer_dedup_deep = None
        if self.layer_dedup is not None and not self._layer_dedup_ok():
            raise ValueError("layer_dedup requires a DGNN of two or more "
                             "layers without memory (TGAT)")
        self._calibrated = not (
            (model.use_memory and self._auto["dedup"])
            or (self._layer_dedup_ok() and self._auto["layer_dedup"]))
        self.calibration: Optional[dict] = None

    def _layer_dedup_ok(self) -> bool:
        """Does the layer dedup apply (``train.py:291-310``): two or more
        layers and no memory."""
        return len(self.fanouts) >= 2 and not self.model.use_memory

    def init_state(self, num_nodes: int, seed: int = 0) -> TrainState:
        """Zero memory for ``num_nodes`` nodes (models with memory), a
        fresh Adam state, a dropout generator seeded with ``seed`` and a
        sampling generator seeded with ``SAMPLE_SEED_OFFSET + seed``, on
        the trainer's device."""
        memory = None
        if self.model.use_memory:
            memory = memory_lib.init_memory(
                num_nodes, self.model.dim_memory, self.model.dim_edge,
                self.device)
        return TrainState(
            memory=memory,
            optimizer=torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                       betas=(0.9, 0.999), eps=1e-8),
            dropout_gen=torch.Generator(device=self.device).manual_seed(seed),
            sample_gen=torch.Generator(device=self.device).manual_seed(
                SAMPLE_SEED_OFFSET + seed),
            tier_takes=[0] * 4 if self._layer_dedup_ok() else None)

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
        """Uniform sampling's draws [B, F] in [0, 1), float32."""
        return torch.rand(shape, generator=gen, device=self.device)

    def _sample_layer(self, gen, dg, roots, ts, layer: int) -> MFG:
        fanout = self.fanouts[layer]
        u = self._uniform(gen, (roots.shape[0], fanout)) \
            if self.strategy == "uniform" else None
        return sample_layer(dg, roots, ts, fanout=fanout,
                            strategy=self.strategy, u=u)

    def _sample(self, gen, dg, roots, ts) -> List[List[MFG]]:
        """Padded MFGs of every layer, innermost first."""
        return sample_hops(dg, roots, ts, fanouts=self.fanouts,
                           strategy=self.strategy,
                           draw=lambda _, shape: self._uniform(gen, shape))

    def _layer_dedup_mfgs(self, state: TrainState, dg, roots, ts):
        """The layer dedup's MFGs (``train.py:992-1091``): from the outer
        layer in, each boundary dedups the parent layer's (nid, ts)
        instances at its largest cap (one host sync for the unique
        count), and the next layer samples the unique pairs at the
        tightest cap that holds them (unused rows invalid); at an overflow
        the remaining layers sample padded.  The first boundary takes the
        tier ladder, deeper ones ``layer_dedup_deep`` or the ladder's top.

        Returns ``(mfgs, expansions, take)``: MFGs and ``("rows", inv,
        sidx, rank_sorted)`` specs, innermost first (the spec of layer
        ``l`` expands its output to layer ``l + 1``'s instances), and the
        first boundary's histogram index."""
        factors = self._dedup_tiers()
        gen = state.sample_gen
        mlist = [self._sample_layer(gen, dg, roots, ts, 0)]
        exps = [None]
        take, n_uniqs = 3, []
        L = len(self.fanouts)
        layer = 1
        while layer < L:
            prev = mlist[-1]
            caps = tier_caps(factors if layer == 1 else
                             [self.layer_dedup_deep or factors[-1]],
                             prev.num_all)
            uniq_nid, uniq_ts, inv, n_uniq, sidx, rank_sorted = \
                dedup_instances(prev.all_nodes(), prev.all_ts(),
                                prev.all_mask(), caps[-1])
            n = int(n_uniq)                 # the boundary's host sync
            n_uniqs.append(n)
            if layer == 1:
                take = min(sum(n > c for c in caps), 3)
            cap = next((c for c in caps if n <= c), None)
            if cap is None:
                break
            nid_c = torch.where(
                torch.arange(cap, device=uniq_nid.device) < n,
                uniq_nid[:cap], INVALID_NID)
            mlist.append(self._sample_layer(gen, dg, nid_c, uniq_ts[:cap],
                                            layer))
            exps.append(("rows", inv, sidx, rank_sorted))
            layer += 1
        state.layer_dedup_n_uniq = n_uniqs
        state.layer_dedup_compact = len(mlist) - 1
        for li in range(layer, L):          # padded after an overflow
            prev = mlist[-1]
            mlist.append(self._sample_layer(gen, dg, prev.all_nodes(),
                                            prev.all_ts(), li))
            exps.append(None)
        return ([[m] for m in reversed(mlist)], list(reversed(exps)),
                take)

    def _mem_input(self, state: TrainState, mfg: MFG):
        """The memory updater's input (``train.py:834-904``): the dedup's
        compact input when the factor is set and the batch's unique pairs
        fit its cap, else the per-instance pull, in bf16 under bf16
        compute when the node table is small next to the instance count
        (``:851-858``; timestamps stay f32).  Records the unique count in
        ``state.dedup_n_uniq``."""
        memory = state.memory
        state.dedup_n_uniq = None
        if self.dedup_factor:
            cap = self._dedup_cap(mfg.num_all)
            uniq_nid, uniq_ts, inv, n_uniq, sidx, rank_sorted = \
                dedup_instances(mfg.all_nodes(), mfg.all_ts(),
                                mfg.all_mask(), cap)
            state.dedup_n_uniq = int(n_uniq)      # the step's host sync
            if state.dedup_n_uniq <= cap:
                return memory_lib.DedupMemoryInput(
                    state=memory, uniq_nids=uniq_nid, uniq_ts=uniq_ts,
                    inv=inv, sidx=sidx, rank_sorted=rank_sorted)
        if self.model.compute_dtype == "bfloat16" \
                and 3 * memory.num_nodes <= mfg.num_all:
            return memory_lib.prepare_input(memory, mfg, torch.bfloat16)
        return memory_lib.prepare_input(memory, mfg)

    @torch.no_grad()
    def _inputs(self, state: TrainState, dg: DeviceGraph,
                edge_feats: Optional[torch.Tensor], batch: Batch,
                train: bool = False):
        """Sample, gather edge features and pull memory rows for a batch:
        ``(mfgs, efs, mem_input, eids, valid, expansions)``; ``mem_input``
        is None without memory, ``expansions`` None off the layer dedup.
        A train batch on the layer dedup counts its take in
        ``state.tier_takes``."""
        dev = self.device
        target_nodes = torch.from_numpy(batch.target_nodes).to(dev)
        ts = torch.from_numpy(batch.ts).to(dev)
        eids = torch.from_numpy(batch.eids).to(dev)
        valid = torch.zeros(batch.batch_size, dtype=torch.bool)
        valid[: batch.num_valid] = True
        valid = valid.to(dev)
        expansions = None
        state.layer_dedup_n_uniq, state.layer_dedup_compact = None, 0
        if self.layer_dedup is not None:
            mfgs, expansions, take = self._layer_dedup_mfgs(
                state, dg, target_nodes, ts)
            if train:
                state.tier_takes[take] += 1
        else:
            mfgs = self._sample(state.sample_gen, dg, target_nodes, ts)
        efs = fetch_features(mfgs, edge_feats)
        mem_input = self._mem_input(state, mfgs[0][0]) \
            if self.model.use_memory else None
        return mfgs, efs, mem_input, eids, valid, expansions

    @torch.no_grad()
    def _write_back(self, state: TrainState, last, edge_feats, eids,
                    valid) -> None:
        if last is None:                   # a model without memory
            return
        # target-edge features for the mails
        tef = _gather_rows(edge_feats, eids, valid)
        memory_lib.update_mem_mail(
            state.memory, last["last_updated_nid"],
            last["last_updated_memory"], last["last_updated_ts"],
            edge_feats=tef, valid=valid)

    def train_step(self, state: TrainState, dg: DeviceGraph,
                   edge_feats: Optional[torch.Tensor], batch: Batch):
        """One train step (``train.py:1371-1378``): forward with dropout,
        loss, backward, an Adam step, then (with memory) the write-back of
        memory computed with the pre-step parameters.  Updates the model's
        parameters, ``state`` and the optimizer in place and remakes the
        model's compute-dtype weight copies.

        The first call calibrates the knobs left to it (the JAX
        ``train_step``; ``eval_step`` never calibrates).

        Returns ``(state, loss, pos_logits [B], neg_logits [B])``,
        detached."""
        self._maybe_auto_calibrate(dg, batch.target_nodes, batch.ts)
        mfgs, efs, mem_input, eids, valid, expansions = self._inputs(
            state, dg, edge_feats, batch, train=True)
        pos, neg, last = self.model(mfgs, efs, mem_input, train=True,
                                    generator=state.dropout_gen,
                                    expansions=expansions)
        loss = link_pred_loss(pos, neg, valid)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        self.model.cast_weights()
        self._write_back(state, last, edge_feats, eids, valid)
        state.step += 1
        return state, loss.detach(), pos[:, 0].detach(), neg[:, 0].detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, dg: DeviceGraph,
                  edge_feats: Optional[torch.Tensor], batch: Batch):
        """One eval step, on the layer dedup where it is set, as the JAX
        ``_step`` (``train.py:1227-1233``); updates ``state.memory`` in
        place.

        Returns ``(state, loss, pos_logits [B], neg_logits [B])``."""
        mfgs, efs, mem_input, eids, valid, expansions = self._inputs(
            state, dg, edge_feats, batch)
        pos, neg, last = self.model(mfgs, efs, mem_input,
                                    expansions=expansions)
        loss = link_pred_loss(pos, neg, valid)
        self._write_back(state, last, edge_feats, eids, valid)
        return state, loss, pos[:, 0], neg[:, 0]

    def calibrate(self, dg: DeviceGraph, batches, *, max_batches: int = 3,
                  occ_batches=()) -> dict:
        """Pick the dedup knobs left on ``"auto"`` from measured (nid, ts)
        uniqueness (``train.py:451-698``).

        Samples, padded, up to ``max_batches`` of ``batches`` (batch
        objects or ``(roots, ts)`` pairs) and every ``(roots, ts)`` pair
        of ``occ_batches``; uniform draws come from a generator seeded
        with 0 for each probe, as the JAX package's one probe key.  With
        memory, the worst unique fraction ``u`` of the memory instances
        sets ``dedup_factor`` to ``round(min(0.35, 2.5u + 0.02), 2)`` when
        ``u <= 0.08`` and None (off) above.  Where the layer dedup
        applies, each probe gives the unique fraction at the first layer
        boundary and the worst at deeper ones, and :func:`tier_ladder`
        sets ``layer_dedup`` and ``layer_dedup_deep``.  Returns
        ``{"uniq_frac", "boundary_uniq_frac", "dedup_factor",
        "layer_dedup", "layer_dedup_deep"}``, also kept as
        ``self.calibration``."""
        self._calibrated = True
        uniq_frac, boundary_frac = [], []
        probes = [b if isinstance(b, tuple) else (b.target_nodes, b.ts)
                  for b in itertools.islice(batches, max_batches)]
        for roots, ts in probes + list(occ_batches):
            u, b = self._probe(dg, roots, ts)
            if u is not None:
                uniq_frac.append(u)
            if b is not None:
                boundary_frac.append(b)
        stats = {"uniq_frac": max(uniq_frac) if uniq_frac else None,
                 "boundary_uniq_frac": max(m for _, m in boundary_frac)
                 if boundary_frac else None}
        if uniq_frac and self._auto["dedup"]:
            # the GRU dedup saves only the GRU gates and the pull; its
            # sort machinery pays only at extreme duplication
            u = stats["uniq_frac"]
            self.dedup_factor = round(min(0.35, 2.5 * u + 0.02), 2) \
                if u <= 0.08 else None
        if boundary_frac and self._auto["layer_dedup"]:
            self.layer_dedup, self.layer_dedup_deep = tier_ladder(
                boundary_frac, len(self.fanouts))
        stats.update(dedup_factor=self.dedup_factor,
                     layer_dedup=self.layer_dedup,
                     layer_dedup_deep=self.layer_dedup_deep)
        self.calibration = stats
        return stats

    @torch.no_grad()
    def _probe(self, dg: DeviceGraph, roots, ts):
        """One calibration probe, sampled padded: the unique fraction of
        the innermost MFG's memory instances (None without memory) and,
        where the layer dedup applies, the pair (unique fraction at the
        first boundary, worst at deeper boundaries; 0.0 without any),
        else None (``train.py:496-538``)."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(0)
        mfgs = self._sample(
            gen, dg, torch.from_numpy(np.asarray(roots, np.int64)).to(dev),
            torch.from_numpy(np.asarray(ts, np.float32)).to(dev))
        u = _uniq_pairs_frac(mfgs[0][0]) if self.model.use_memory else None
        b = None
        if self._layer_dedup_ok():
            # mfgs[1:] run from the layer after the innermost out; the
            # outermost's instances are the first boundary's roots
            us = [_uniq_pairs_frac(layer[0]) for layer in mfgs[1:]]
            b = (us[-1], max(us[:-1]) if len(us) > 1 else 0.0)
        return u, b

    def _maybe_auto_calibrate(self, dg: DeviceGraph, roots, ts) -> None:
        """First-batch calibration (``train.py:719-750``): the batch, and
        the same roots with the batch's timestamps shifted to a third, two
        thirds and the end of the stream, since uniqueness grows as the
        histories do."""
        if self._calibrated:
            return
        ts_arr = np.asarray(ts, np.float32)
        t_hi = float(dg.e_ts.max())
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
