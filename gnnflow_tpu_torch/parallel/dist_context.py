"""Process groups for multi-GPU training: one process per device.

Counterpart of ``gnnflow_tpu/parallel/mesh.py`` and
``gnnflow_tpu/parallel/dist_context.py``.  The JAX package runs one SPMD
program over a device mesh; PyTorch runs one process per device, joined by
a ``torch.distributed`` process group: NCCL between cards, gloo between
CPU processes.  Nothing falls back: a ``cuda`` run without a card, or with
fewer cards than ranks on a host, raises.

- :func:`initialize` joins a group (or returns the running one, as JAX's
  ``initialize()`` without arguments does, ``dist_context.py:35-52``);
  it reads a ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``) where one is set.
- :func:`owned_partitions` is the contiguous range of partitions a rank
  owns (``:75-84``): with ``P`` partitions over ``W`` ranks, ``P / W``
  each, so one rank may own them all.
- :func:`assert_uniform` checks that a host value agrees on every rank
  (``:97-109``), :func:`dispatch_full_dataset_multiprocess` ingests only
  the owned partitions (``:111-151``).
- :func:`spawn` starts ``world_size`` ranks with ``torch.multiprocessing``
  and runs a function in each, inside its group.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


@dataclass
class DistContext:
    """A rank's place in its group: ``rank`` of ``world_size``, its
    device, and the group (None: the default group)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


def group_device(group=None) -> torch.device:
    """The device a group's collectives take tensors on: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def group_size(group=None) -> int:
    """The group's world size; 1 where no group runs (every collective
    of this package is then the identity)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _running_context() -> DistContext:
    return DistContext(dist.get_rank(), dist.get_world_size(),
                       group_device())


def initialize(rank: Optional[int] = None,
               world_size: Optional[int] = None, device="cuda",
               init_method: Optional[str] = None) -> DistContext:
    """Join the process group: NCCL on ``cuda`` (after
    ``torch.cuda.set_device(local_rank)``), gloo on ``cpu``.  Where a
    group is already initialized, returns its context and joins nothing.
    Unset arguments come from ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
    (``torchrun``), else rank 0 of 1; ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``)."""
    if dist.is_initialized():
        return _running_context()
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    world_size = (_env_int("WORLD_SIZE", 1) if world_size is None
                  else int(world_size))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available; pass device='cpu' for gloo")
        local_rank = _env_int("LOCAL_RANK", rank)
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} needs card {local_rank}, but this host has "
                f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return DistContext(rank, world_size, dev)


def shutdown() -> None:
    """Leave the process group, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()


def owned_partitions(num_partitions: int, rank: int = 0,
                     world_size: int = 1) -> range:
    """The partitions rank ``rank`` owns: ``P / W`` contiguous ids."""
    if num_partitions % world_size:
        raise ValueError(f"{num_partitions} partitions do not divide over "
                         f"{world_size} ranks")
    per = num_partitions // world_size
    return range(rank * per, (rank + 1) * per)


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` concatenated along dim 0, in rank
    order (one ``all_gather_into_tensor``).  bf16, f16 and bool travel as
    same-width integers, which every backend carries."""
    if not dist.is_initialized():
        return t
    world = dist.get_world_size(group)
    wire = _wire(t)
    out = wire.new_empty((world * wire.shape[0],) + tuple(wire.shape[1:]))
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single",
                     dist.all_gather_into_tensor)
    gather(out, wire, group=group)
    return _unwire(out, t.dtype)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a dtype every backend carries: bf16 and f16 as int16,
    bool as uint8."""
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t


def _unwire(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return out.bool()
    return out.view(dtype) if out.dtype != dtype else out


class Route:
    """Where ``n`` rows go: ``dest[i]`` is row i's rank, ``world_size``
    for a row that goes nowhere.  One exchange of the counts builds it
    (every rank calls it, also with no rows); :meth:`send` moves rows to
    their ranks in rank order, stable inside each, and :meth:`back`
    returns rows of the received order to where they came from, filling
    rows that went nowhere with ``fill``."""

    def __init__(self, dest: torch.Tensor, group=None):
        world = group_size(group)
        self.group, self.n = group, dest.shape[0]
        self.order = torch.argsort(dest, stable=True)
        counts = torch.bincount(dest, minlength=world + 1)[:world]
        recv = counts
        if dist.is_initialized():
            recv = torch.empty_like(counts)
            dist.all_to_all_single(recv, counts, group=group)
        self.send_counts = counts.tolist()
        self.recv_counts = recv.tolist()
        self.sent = self.order[:sum(self.send_counts)]

    def _a2a(self, rows: torch.Tensor, out_counts, in_counts):
        if not dist.is_initialized():
            return rows
        wire = _wire(rows)
        out = wire.new_empty((sum(out_counts),) + tuple(wire.shape[1:]))
        dist.all_to_all_single(out, wire, out_counts, in_counts,
                               group=self.group)
        return _unwire(out, rows.dtype)

    def send(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows ``[n, ...]`` of this rank to their ranks: the received
        ``[m, ...]``, in source-rank order."""
        return self._a2a(rows[self.sent], self.recv_counts,
                         self.send_counts)

    def back(self, rows: torch.Tensor, fill=0) -> torch.Tensor:
        """Received-order rows ``[m, ...]`` back to their senders: ``[n,
        ...]`` in this rank's original order."""
        got = self._a2a(rows, self.send_counts, self.recv_counts)
        out = got.new_full((self.n,) + tuple(got.shape[1:]), fill)
        out[self.sent] = got
        return out


def assert_uniform(value, name: str = "value", group=None) -> None:
    """Raise unless the int64 host value ``value`` is the same on every
    rank of the group (an all-gather of it)."""
    if group_size(group) == 1:
        return
    t = torch.as_tensor(np.asarray(value, np.int64).reshape(-1),
                        device=group_device(group))
    got = all_gather_cat(t[None], group)
    if not bool((got == got[0]).all()):
        raise AssertionError(
            f"{name} differs across ranks: the partitioner stream must be "
            f"deterministic and identical on every rank")


def dispatch_full_dataset_multiprocess(full_data, ext_roll, partitioner,
                                       pgraph, node_feats=None,
                                       edge_feats=None,
                                       ingestion_batch_size: int = 100_000,
                                       undirected: bool = False,
                                       device="cpu"):
    """Every rank streams the same edges through its own deterministic
    partitioner and ingests only the partitions it owns (``pgraph`` of
    this rank); the table digest is checked across ranks.  Returns
    ``(train split, ShardedFeatureStore)`` as
    :func:`~gnnflow_tpu_torch.parallel.dispatcher.dispatch_full_dataset`."""
    from gnnflow_tpu_torch.parallel.dispatcher import dispatch_full_dataset
    train, store = dispatch_full_dataset(
        full_data, ext_roll, partitioner, pgraph, node_feats=node_feats,
        edge_feats=edge_feats, ingestion_batch_size=ingestion_batch_size,
        undirected=undirected, device=device)
    pt = partitioner.get_partition_table()
    assert_uniform([len(pt), int(pt.astype(np.int64).sum()),
                    int((pt >= 0).sum())], "partition table digest",
                   pgraph.group)
    return train, store


def _rank_main(rank, fn, world_size, device, init_method, args):
    torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    ctx = initialize(rank, world_size, device, init_method)
    try:
        fn(ctx, *args)
    finally:
        shutdown()


def spawn(fn, world_size: int, device="cuda", *args,
          init_method: Optional[str] = None, join: bool = True):
    """Run ``fn(ctx, *args)`` in ``world_size`` new processes, rank r on
    card r (``cuda``) or over gloo (``cpu``), each inside the group and
    out of it again when ``fn`` returns; raises if any rank fails.
    ``fn`` must be importable by name.  The rendezvous defaults to a file
    under ``build/`` of the repository, removed afterwards.  With
    ``join=False`` (and an ``init_method``) returns at once the
    ``ProcessContext``, whose ``join()`` the caller loops on."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks on cuda need {world_size} "
                           f"cards; this host has "
                           f"{torch.cuda.device_count()}")
    if not join and init_method is None:
        raise ValueError("spawn(join=False) needs an init_method")
    path = None
    if init_method is None:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        path = os.path.join(ROOT, "build",
                            f"rendezvous_{os.getpid()}_{time.time_ns()}")
        init_method = "file://" + path
    try:
        return torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, str(dev), init_method, args),
            nprocs=world_size, join=join, start_method="spawn")
    finally:
        if path is not None and os.path.exists(path):
            os.remove(path)
