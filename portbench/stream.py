"""The benchmark's traffic generator: a JODIE-like temporal interaction
stream made from the seed, its edge features made on the device, and the
negative destinations of each batch.

The edge stream is a frozen copy of ``make_synthetic_dataset`` in
``gnnflow_tpu_torch/data.py`` as of commit e51abea (sources revisit a few
preferred destinations of a skewed popularity; exponential gaps between
timestamps), kept here so that no change of the program changes the
traffic.  One part is new: the edge features are drawn on the device
(``dst_emb[dst] + 0.1 * noise``, the same law as the original draws on the
host).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def seeds(seed: int, n: int):
    """``n`` independent 32-bit seeds derived from any whole ``seed``."""
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(n)]


@dataclass
class Edges:
    """A chronological edge list (NumPy)."""

    src: np.ndarray    # int64
    dst: np.ndarray    # int64
    time: np.ndarray   # float32
    eid: np.ndarray    # int64

    def __len__(self) -> int:
        return len(self.src)

    def __getitem__(self, sl) -> "Edges":
        return Edges(self.src[sl], self.dst[sl], self.time[sl], self.eid[sl])

    def concat(self, other: "Edges") -> "Edges":
        return Edges(*(np.concatenate([a, b]) for a, b in
                       zip(self.astuple(), other.astuple())))

    def astuple(self):
        return self.src, self.dst, self.time, self.eid


def make_edges(seed: int, num_src: int, num_dst: int, num_edges: int,
               time_scale: float, recurrence: float = 0.8) -> Edges:
    """``num_edges`` interactions from sources ``[0, num_src)`` to
    destinations ``[num_src, num_src + num_dst)``."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, num_src, size=num_edges).astype(np.int64)
    num_pref = 4
    popularity = 1.0 / (np.arange(num_dst) + 1.0)
    popularity /= popularity.sum()
    pref = rng.choice(num_dst, size=(num_src, num_pref), p=popularity)
    revisit = rng.rand(num_edges) < recurrence
    pref_pick = pref[src, rng.randint(0, num_pref, size=num_edges)]
    rand_pick = rng.choice(num_dst, size=num_edges, p=popularity)
    dst = np.where(revisit, pref_pick, rand_pick).astype(np.int64) + num_src
    time = np.cumsum(rng.exponential(time_scale, size=num_edges)) \
        .astype(np.float32)
    return Edges(src, dst, time, np.arange(num_edges, dtype=np.int64))


def edge_features(seed: int, dst: np.ndarray, num_src: int, num_dst: int,
                  dim: int, device) -> torch.Tensor:
    """[E, dim] float32 features on ``device``: the destination's
    embedding plus 0.1 of Gaussian noise, drawn by a generator there in
    two calls."""
    gen = torch.Generator(device=device).manual_seed(seed)
    emb = torch.randn(num_dst, dim, generator=gen, device=device)
    di = torch.as_tensor(dst - num_src, device=device)
    out = torch.randn(len(dst), dim, generator=gen, device=device)
    out.mul_(0.1).add_(emb[di])
    return out


class Negatives:
    """Uniform negative destinations among those seen so far, as the
    GNNFlow scripts' ``DstRandEdgeSampler`` draws them."""

    def __init__(self, dst: np.ndarray, seed: int):
        self.dst_list = np.unique(dst)
        self.rng = np.random.RandomState(seed)
        self.log = None          # a list records each draw when set

    def sample(self, size: int) -> np.ndarray:
        out = self.dst_list[self.rng.randint(0, len(self.dst_list), size)]
        if self.log is not None:
            self.log.append(out)
        return out

    def add_dst_list(self, dst: np.ndarray) -> None:
        self.dst_list = np.unique(np.concatenate([self.dst_list, dst]))
