"""The user-facing temporal sampler.

Counterpart of ``gnnflow_tpu/temporal_sampler.py:21-128``:
``TemporalSampler(graph, fanouts, sample_strategy, num_snapshots,
snapshot_time_window, prop_time, seed, is_static, compact_factor)``;
``sample(vertices, ts)`` returns layer-major lists of per-snapshot MFGs,
``mfgs[0]`` the innermost layer, and ``sample_layer`` one (layer,
snapshot).  The work is :func:`~gnnflow_tpu_torch.ops.sampling.sample_hops`
and :func:`~gnnflow_tpu_torch.ops.sampling.sample_layer`; this wrapper
picks the store's view, the static timestamp and the uniform draws.

The feature-cache path is its caller: the trainer's own steps sample
inside the step.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from gnnflow_tpu_torch.common import MFG, STATIC_TS, resolve_device
from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
from gnnflow_tpu_torch.ops.sampling import sample_hops
from gnnflow_tpu_torch.ops.sampling import sample_layer as _sample_layer


class TemporalSampler:
    """Samples k-hop multi-snapshot temporal neighbourhoods of ``graph``.

    Sampling runs on ``device`` (``cuda`` by default; raises without a
    card), except on a store placed on the host, which is sampled on the
    CPU whatever ``device`` says (``_target_device``,
    ``dynamic_graph.py:498-504``).  Uniform draws come from the sampler's
    own ``torch.Generator``, seeded with ``seed``.  ``is_static`` samples
    every root at ``STATIC_TS``.  ``compact_factor="auto"`` is 0.25 for
    windowed multi-snapshot configs and None otherwise
    (``temporal_sampler.py:44-50``); it changes how deeper layers are
    sampled, not the MFGs.  ``neg_sample_ratio``, which the DGNN
    family's trainer kwargs carry, is accepted and ignored, as JAX's
    sampler takes it with its ``**kwargs``: the roots carry the
    negatives."""

    def __init__(self, graph: DynamicGraph, fanouts: List[int],
                 sample_strategy: str = "recent", num_snapshots: int = 1,
                 snapshot_time_window: float = 0.0, prop_time: bool = False,
                 seed: int = 1234, is_static: bool = False,
                 compact_factor="auto", device="cuda",
                 neg_sample_ratio: int = 1):
        del neg_sample_ratio        # a trainer kwarg; sampling ignores it
        sample_strategy = sample_strategy.lower()
        if sample_strategy not in ("recent", "uniform"):
            raise ValueError("strategy must be 'recent' or 'uniform'")
        if num_snapshots > 1 and abs(snapshot_time_window) < 1e-6:
            raise ValueError(
                "snapshot_time_window must be positive when num_snapshots>1")
        self._graph = graph
        self._fanouts = tuple(int(f) for f in fanouts)
        self._strategy = sample_strategy
        self._num_snapshots = int(num_snapshots)
        self._window = float(snapshot_time_window)
        self._prop_time = bool(prop_time)
        self._is_static = bool(is_static)
        if compact_factor == "auto":
            compact_factor = (0.25 if num_snapshots > 1
                              and snapshot_time_window > 0 else None)
        self._compact_factor = compact_factor
        self.device = resolve_device(device)
        self.sample_device = torch.device("cpu") \
            if graph.placement == "host" else self.device
        self._gen = torch.Generator(device=self.sample_device) \
            .manual_seed(seed)

    @property
    def num_layers(self) -> int:
        return len(self._fanouts)

    @property
    def num_snapshots(self) -> int:
        return self._num_snapshots

    @property
    def fanouts(self):
        return self._fanouts

    def _draw(self, layer: int, shape) -> torch.Tensor:
        """Uniform draws in [0, 1) for ``layer``, from the generator."""
        return torch.rand(shape, generator=self._gen,
                          device=self.sample_device)

    def _roots(self, target_vertices, timestamps):
        dev = self.sample_device
        roots = torch.from_numpy(
            np.asarray(target_vertices, dtype=np.int64)).to(dev)
        ts = (np.full(np.shape(target_vertices), STATIC_TS, np.float32)
              if self._is_static else
              np.asarray(timestamps, dtype=np.float32))
        return roots, torch.from_numpy(ts).to(dev)

    def _kw(self) -> dict:
        return dict(strategy=self._strategy,
                    num_snapshots=self._num_snapshots, window=self._window,
                    prop_time=self._prop_time)

    def sample(self, target_vertices: np.ndarray,
               timestamps: np.ndarray) -> List[List[MFG]]:
        """Sample k-hop neighbours; ``mfgs[0]`` is the innermost layer."""
        roots, ts = self._roots(target_vertices, timestamps)
        g = self._graph.device_graph(self.sample_device)
        return sample_hops(g, roots, ts, fanouts=self._fanouts,
                           compact_factor=self._compact_factor,
                           draw=self._draw, **self._kw())

    def sample_layer(self, target_vertices: np.ndarray,
                     timestamps: np.ndarray, layer: int,
                     snapshot: int) -> MFG:
        """Sample a single (layer, snapshot) (``temporal_sampler.py:
        110-128``)."""
        roots, ts = self._roots(target_vertices, timestamps)
        g = self._graph.device_graph(self.sample_device)
        fanout = self._fanouts[layer]
        u = self._draw(layer, (roots.shape[0], fanout)) \
            if self._strategy == "uniform" else None
        return _sample_layer(g, roots, ts, fanout=fanout,
                             snapshot_idx=snapshot, u=u, **self._kw())
