"""Node memory and mailbox, the GRU (TGN) and transformer (APAN) memory
updaters and the write-back.

Counterpart of ``gnnflow_tpu/models/memory.py``: ``MemoryState`` with one
mail slot or ``S`` of them (APAN's circular mailbox), in f32 or bf16
storage, and ``init_memory`` (``:50-208``), reset, resize, backup and
restore (``:207-283``), ``DedupMemoryInput`` and ``RawMemoryInput``
(``:286-311``), ``prepare_input_at`` and ``prepare_input`` with the
meaning of ``prepare_input_bf16`` (``:314-433``), ``GRUMemoryUpdater`` on
the per-instance and the dedup path (``:436-590``),
``TransformerMemoryUpdater`` (``:593-753``), each with node features
added to its output (``node_feat_proj``), and ``update_mem_mail`` with
the circular slot write (``:756-875``).

Unlike the JAX package, which builds a new state array every step, the
port updates the memory tensors **in place** (:func:`update_mem_mail`,
:func:`reset_memory`).  The JAX package's row tables, their 128-lane
pads, its split per-slot mail table and its bf16 pair packing into int32
lanes are TPU layout: here the four logical tensors and the slot cursor
are plain row-major tensors, ``mem`` and ``mail`` in bf16 under
``storage="bfloat16"`` (rounded to nearest even, the bits of JAX's
``_pack_bf16``), timestamps f32 and the cursor int64.

A state can be sharded over the ranks of a process group
(:func:`~gnnflow_tpu_torch.parallel.kvstore.shard_memory_state`,
``parallel/kvstore.py:107-120``): rank r then holds rows ``[r·R, (r+1)·R)``
with ``R = ceil(N / W)``, zero-padded, and ``shard`` says where.  A pull
(:func:`prepare_input_at`) is one routed exchange (a collective: every
rank makes it, with any number of ids); the write-back applies only the
rows a rank owns, from the global batch every rank holds, so it needs no
exchange.

Kept reference quirk: mailbox timestamps are ``last_updated_ts[:2B]`` in
block order (src block, then dst block) while mails and their node ids are
interleaved ``[s0, d0, s1, d1, ...]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from gnnflow_tpu_torch.common import MFG
from gnnflow_tpu_torch.models.modules import (FusedGRUCell, Linear,
                                              MultiLinear, TimeEncode,
                                              gru_gates)
from gnnflow_tpu_torch.ops.apan_kv import (apan_table_pull,
                                           apan_table_pull_sharded)
from gnnflow_tpu_torch.ops.gru_gather import gru_node_gather
from gnnflow_tpu_torch.ops.segment import unique_keep_last_mask
from gnnflow_tpu_torch.ops.segment_sum import expand_compact

# the state's tensors, in the order a routed pull packs their rows
TENSORS = ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts",
           "mailbox_ptr")
STORAGES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class MemoryShard:
    """Where a sharded state's rows lie: rank ``rank`` of ``world_size``
    in ``group`` holds the global rows ``[lo, lo + rows_per_rank)`` of
    ``num_nodes``."""

    group: Any
    rank: int
    world_size: int
    rows_per_rank: int
    num_nodes: int

    @property
    def lo(self) -> int:
        return self.rank * self.rows_per_rank


@dataclass
class MemoryState:
    """Per-node memory state: the reference's four tensors, with one mail
    slot or ``S > 1`` (APAN's circular mailbox), and the per-node write
    cursor of the slots (``memory.py:58-66``; int64, always 0 with one
    slot).  ``node_memory`` and ``mailbox`` are f32 or bf16 (the
    storage), the timestamps f32.  With ``shard`` set the tensors hold
    this rank's block of rows only."""

    node_memory: torch.Tensor     # [N, dim_memory]
    node_memory_ts: torch.Tensor  # [N]
    mailbox: torch.Tensor         # [N, dim_raw] or [N, S, dim_raw]
    mailbox_ts: torch.Tensor      # [N] or [N, S]
    mailbox_ptr: torch.Tensor     # [N] int64: the slot written next, mod S
    shard: Optional[MemoryShard] = None

    @property
    def num_nodes(self) -> int:
        """The nodes of the whole state, over every rank."""
        return self.shard.num_nodes if self.shard is not None \
            else self.node_memory.shape[0]

    @property
    def dim_memory(self) -> int:
        return self.node_memory.shape[1]

    @property
    def dim_raw(self) -> int:
        """2 * dim_memory + dim_edge."""
        return self.mailbox.shape[-1]

    @property
    def mailbox_slots(self) -> int:
        return 1 if self.mailbox.dim() == 2 else self.mailbox.shape[1]

    @property
    def storage(self) -> str:
        return "bfloat16" if self.node_memory.dtype == torch.bfloat16 \
            else "float32"

    @property
    def nbytes(self) -> int:
        """Bytes of this rank's tensors."""
        return sum(getattr(self, n).nbytes for n in TENSORS)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in TENSORS}


def init_memory(num_nodes: int, dim_memory: int, dim_edge: int,
                device, mailbox_slots: int = 1,
                storage: str = "float32") -> MemoryState:
    """Zero memory for ``num_nodes`` nodes; ``storage="bfloat16"`` keeps
    ``mem`` and ``mail`` in bf16 and needs even ``dim_memory`` and
    ``dim_raw`` (``memory.py:176-185``)."""
    if storage not in STORAGES:
        raise ValueError(f"unknown memory storage {storage!r}")
    dim_raw = 2 * dim_memory + dim_edge
    if storage == "bfloat16" and (dim_memory % 2 or dim_raw % 2):
        raise ValueError(
            "bfloat16 memory storage needs even dim_memory/dim_raw")
    z = dict(dtype=torch.float32, device=device)
    v = dict(dtype=STORAGES[storage], device=device)
    slots = (mailbox_slots,) if mailbox_slots > 1 else ()
    return MemoryState(torch.zeros(num_nodes, dim_memory, **v),
                       torch.zeros(num_nodes, **z),
                       torch.zeros(num_nodes, *slots, dim_raw, **v),
                       torch.zeros(num_nodes, *slots, **z),
                       torch.zeros(num_nodes, dtype=torch.long,
                                   device=device))


def reset_memory(state: MemoryState) -> MemoryState:
    """Zero every tensor of ``state`` (a rank's block where sharded), in
    place (``memory.py:207-208``)."""
    for t in state.tensors().values():
        t.zero_()
    return state


def _grow(t: torch.Tensor, rows: int) -> torch.Tensor:
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[: t.shape[0]] = t
    return out


def resize_memory(state: MemoryState, num_nodes: int) -> MemoryState:
    """A state of ``num_nodes`` rows: ``state`` itself where it has as
    many, else new tensors holding its rows and zero rows after them,
    every mail slot and the cursor included (``memory.py:211-221``).  A
    sharded state is gathered, grown and sharded again over its group (a
    collective)."""
    if num_nodes <= state.num_nodes:
        return state
    if state.shard is not None:
        from gnnflow_tpu_torch.parallel.kvstore import (shard_memory_state,
                                                        unshard_memory)
        return shard_memory_state(
            resize_memory(unshard_memory(state), num_nodes),
            state.shard.group)
    return MemoryState(**{n: _grow(t, num_nodes)
                          for n, t in state.tensors().items()})


def backup_memory(state: MemoryState) -> Dict[str, torch.Tensor]:
    """Host-side snapshot: a CPU copy of each tensor, in its storage
    dtype (``memory.py:224-233``); of a rank's block where sharded."""
    return {n: t.detach().cpu().clone() for n, t in state.tensors().items()}


def restore_memory(backup: Dict[str, torch.Tensor], device,
                   shard: Optional[MemoryShard] = None) -> MemoryState:
    """A :class:`MemoryState` on ``device`` from :func:`backup_memory`'s
    snapshot (``memory.py:236-283``), in the snapshot's storage (bf16 where
    its ``node_memory`` is); a snapshot without ``mailbox_ptr`` restores
    the cursor as 0, as there.  ``shard`` restores a rank's block of a
    sharded state (the ``shard`` of the state it was taken from)."""
    n = backup["node_memory"].shape[0]
    ptr = backup.get("mailbox_ptr", torch.zeros(n))
    vdt = backup["node_memory"].dtype
    vdt = vdt if vdt == torch.bfloat16 else torch.float32
    return MemoryState(
        node_memory=backup["node_memory"].to(device, vdt),
        node_memory_ts=backup["node_memory_ts"].to(device, torch.float32),
        mailbox=backup["mailbox"].to(device, vdt),
        mailbox_ts=backup["mailbox_ts"].to(device, torch.float32),
        mailbox_ptr=ptr.to(device, torch.long), shard=shard)


@dataclass
class DedupMemoryInput:
    """Compact memory-updater input from the train step's exact (nid, ts)
    instance dedup (:func:`~gnnflow_tpu_torch.ops.dedup.dedup_instances`):
    the raw state (the updater pulls the compact rows itself), the unique
    pairs, the maps that expand compact rows back to instances and the
    node-feature table, from which the updater gathers the unique pairs'
    rows (``memory.py:545-577``; None without node features)."""

    state: MemoryState
    uniq_nids: torch.Tensor      # [cap] winner node ids
    uniq_ts: torch.Tensor        # [cap] f32 winner timestamps
    inv: torch.Tensor            # [L] instance -> compact slot
    sidx: torch.Tensor           # [L] sorted position -> instance
    rank_sorted: torch.Tensor    # [L] int32 non-decreasing slots
    node_feats: Optional[torch.Tensor] = None   # [N, dim_node] table
    # the transformer updater pulls the pairs through its K/V table, as
    # JAX's always does (memory.py:609-619); over sharded memory the
    # trainer sets its apan_table here, so that ranks on either branch
    # make the same exchanges
    table: bool = True


@dataclass
class RawMemoryInput:
    """The raw state as the updater's input (``memory.py:306-311``): the
    updaters' table paths pull their rows themselves (the transformer's
    :func:`~gnnflow_tpu_torch.ops.apan_kv.apan_table_pull`, the GRU's
    :func:`~gnnflow_tpu_torch.ops.gru_gather.gru_node_gather`)."""

    state: MemoryState


def _pull_rows(state: MemoryState, nids: torch.Tensor,
               vdt: torch.dtype) -> Dict[str, torch.Tensor]:
    """The rows of ``nids`` (in ``[0, num_nodes)``) of every tensor the
    pull needs (the cursor with S slots only), ``mem`` and ``mail`` in
    ``vdt``.  A sharded state routes the ids to their owners and their
    rows back packed as bytes, ``[mem | mem_ts | mail | mail_ts (| ptr)]``:
    one :class:`~gnnflow_tpu_torch.parallel.dist_context.Route` and one
    ``back``, whatever the fields."""
    names = TENSORS if state.mailbox_slots > 1 else TENSORS[:-1]

    def rows(idx, dt):
        out = {n: getattr(state, n)[idx] for n in names}
        for n in ("node_memory", "mailbox"):
            out[n] = out[n].to(dt)
        return out

    if state.shard is None:
        if vdt.itemsize < state.node_memory.dtype.itemsize:
            # cast the tables once, then gather: half the gathered bytes
            out = {n: getattr(state, n) for n in names}
            out["node_memory"] = out["node_memory"].to(vdt)
            out["mailbox"] = out["mailbox"].to(vdt)
            return {n: t[nids] for n, t in out.items()}
        return rows(nids, vdt)
    from gnnflow_tpu_torch.parallel.dist_context import Route
    sh = state.shard
    route = Route(torch.div(nids, sh.rows_per_rank, rounding_mode="floor"),
                  sh.group)
    wire = min(vdt, state.node_memory.dtype, key=lambda d: d.itemsize)
    local = rows(route.send(nids) - sh.lo, wire)
    m = nids.shape[0]
    shapes = {n: (m,) + tuple(t.shape[1:]) for n, t in local.items()}
    dtypes = {n: t.dtype for n, t in local.items()}
    packed = torch.cat([t.reshape(t.shape[0], -1).view(torch.uint8)
                        for t in local.values()], 1)
    got = route.back(packed)
    out, off = {}, 0
    for n in local:
        w = math.prod(shapes[n][1:]) * dtypes[n].itemsize
        out[n] = got[:, off: off + w].contiguous().view(dtypes[n]) \
            .reshape(shapes[n])
        off += w
    for n in ("node_memory", "mailbox"):
        out[n] = out[n].to(vdt)
    return out


def prepare_input_at(state: MemoryState, nids: torch.Tensor,
                     dtype: torch.dtype = torch.float32
                     ) -> Dict[str, torch.Tensor]:
    """Pull memory rows for ``nids`` (ids clip into the table): ``mem``,
    ``mem_ts``, ``mail`` ([L, dim_raw], or [L, S, dim_raw] with S slots),
    ``mail_ts`` ([L] or [L, S]) and, with S slots, the cursor
    ``mail_ptr`` [L].  ``mem`` and ``mail`` come in ``dtype``; timestamps
    stay f32.

    ``dtype=torch.bfloat16`` over f32 storage is what ``prepare_input_bf16``
    means: memory and mail values round to bf16 (the node tables are cast
    once, then gathered, halving the gathered bytes).  The TPU's lane
    packing of that pull has no GPU counterpart.  Over bf16 storage the
    rows are the stored bf16 values, widened exactly for f32.  A sharded
    state's pull is a collective (:func:`_pull_rows`) and moves the
    narrower of the storage and ``dtype``."""
    nids = nids.clamp(0, state.num_nodes - 1)
    r = _pull_rows(state, nids, dtype)
    out = {"mem": r["node_memory"], "mem_ts": r["node_memory_ts"],
           "mail": r["mailbox"], "mail_ts": r["mailbox_ts"]}
    if state.mailbox_slots > 1:
        out["mail_ptr"] = r["mailbox_ptr"]
    return out


def prepare_input(state: MemoryState, mfg: MFG,
                  dtype: torch.dtype = torch.float32
                  ) -> Dict[str, torch.Tensor]:
    """Pull memory rows for the MFG's nodes (padded ids clip to 0);
    ``memory.py:377-383``."""
    return prepare_input_at(state, mfg.all_nodes(), dtype)


def table_ok(state: MemoryState) -> bool:
    """Can the transformer updater pull from the tables
    (:func:`~gnnflow_tpu_torch.ops.apan_kv.apan_table_pull`, or over a
    sharded state :func:`~gnnflow_tpu_torch.ops.apan_kv.
    apan_table_pull_sharded`)?  Not over bf16 storage, as in JAX
    (``train.py:232-241, 842``): that takes pulled rows."""
    return state.storage == "float32"


def pull_dtype(state: MemoryState,
               compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype of a compact (dedup) pull: f32, even under bf16 compute
    (``memory.py:516``), but the stored bf16 over bf16 storage under bf16
    compute (a packed state's rows are bf16 there)."""
    return torch.bfloat16 if state.storage == "bfloat16" \
        and compute_dtype == torch.bfloat16 else torch.float32


def table_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``ids`` of a feature table: a tensor (ids clip into it) or
    a sharded table with ``pull`` (a collective)."""
    if hasattr(table, "pull"):
        return table.pull(ids)
    return table[ids.clamp(0, table.shape[0] - 1)]


def _node_feat_proj(dim_node: int, dim_memory: int,
                    gen: torch.Generator) -> Optional[Linear]:
    """``node_feat_proj``, the f32 projection of node features to the
    memory's width (``memory.py:488-500``); None without node features or
    where the widths agree, which adds the features themselves."""
    return Linear(dim_node, dim_memory, gen) \
        if 0 < dim_node != dim_memory else None


def _with_node_feats(updater: nn.Module, mfg: MFG, mem_input,
                     updated: torch.Tensor,
                     node_feats: Optional[torch.Tensor]):
    """The updater's output ``h`` with node features added and the dst
    rows' updated memory for write-back: ``(h, dst_updated)``.

    On the dedup (``memory.py:545-577, 722-743``) the features of the
    unique pairs are gathered from the table (pulled from a sharded one)
    and added before the expansion, whose backward is K4; else
    ``node_feats`` are the instances' rows.  Without node features ``h``
    is ``updated``."""
    def add(nf):
        proj = updater.node_feat_proj
        return updated + (nf if proj is None else proj(nf))

    b = mfg.num_dst
    if not isinstance(mem_input, DedupMemoryInput):
        with_nf = updater.dim_node > 0 and node_feats is not None
        return add(node_feats) if with_nf else updated, updated[:b]
    di = mem_input
    if updater.dim_node == 0 or di.node_feats is None:
        h = expand_compact(updated, di.inv, di.sidx, di.rank_sorted)
        return h, h[:b]
    nf = table_rows(di.node_feats, di.uniq_nids)
    h = expand_compact(add(nf), di.inv, di.sidx, di.rank_sorted)
    return h, updated[di.inv[:b]]


class GRUMemoryUpdater(nn.Module):
    """GRU memory updater (``memory.py:436-590``, ``impl="pallas"``):
    ``dts = ts - mem_ts`` and ``h = GRU(mem, [mail | TimeEncode(dts)])`` in
    the fused kernel, over every MFG instance, or, given a
    :class:`DedupMemoryInput`, over the compact rows, expanded back to the
    instances by :func:`~gnnflow_tpu_torch.ops.segment_sum.expand_compact`.
    With S mail slots the GRU reads the latest mail, slot ``(ptr - 1) mod
    S`` (``memory.py:520-526``).  Without time encoding (``dim_time`` 0)
    the cell has no time part and runs its plain form, as JAX's
    (``:540-542``; the fused kernel needs a time part).  Given a
    :class:`RawMemoryInput` (the trainer's ``gru_table``) it projects the
    gates once per node and gathers them (:meth:`_table`,
    ``memory.py:453-486``), with no kernel.  With node features
    (``dim_node > 0``) the output adds them, through ``node_feat_proj``
    where their width is not the memory's; the write-back takes the
    memory without them.

    Returns ``(h, last_updated)``; ``last_updated`` holds the node ids,
    updated memory and timestamps of the dst rows for write-back, detached
    from autograd (``memory.py:583-589``)."""

    def __init__(self, dim_node: int, dim_edge: int, dim_time: int,
                 dim_memory: int, gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim_node = dim_node
        self.dim_raw = 2 * dim_memory + dim_edge
        self.cell = FusedGRUCell(self.dim_raw + dim_time, dim_memory, gen,
                                 compute_dtype)
        if dim_time > 0:
            self.time_enc = TimeEncode(dim_time)
        self.node_feat_proj = _node_feat_proj(dim_node, dim_memory, gen)

    def _table(self, mfg: MFG, state: MemoryState) -> torch.Tensor:
        """The GRU over the instances through the per-node gate table
        (``memory.py:453-486``): the same math as the cell, the mail and
        memory products hoisted to node space
        (:func:`~gnnflow_tpu_torch.ops.gru_gather.gru_node_gather`), the
        time part and the biases added per instance in the compute dtype.
        Returns the updated memory [L, f], f32."""
        cell, dr = self.cell, self.dim_raw
        cd = cell.compute_dtype or torch.float32
        ki, kh = cell.ih.kernel, cell.hh.kernel
        gi, gh, mem_i, mem_ts_i = gru_node_gather(
            state.node_memory, state.mailbox, state.node_memory_ts,
            ki[:dr], kh, mfg.all_nodes().clamp(0, state.num_nodes - 1),
            cell.compute_dtype)
        if hasattr(self, "time_enc"):
            tf = self.time_enc(mfg.all_ts() - mem_ts_i)
            gi = gi + tf.to(cd) @ ki[dr:].to(cd)
        gi = gi + cell.ih.bias.to(cd)
        gh = gh + cell.hh.bias.to(cd)
        return gru_gates(gi, gh, mem_i, kh.shape[0]).float()

    def forward(self, mfg: MFG,
                mem_input: Union[Dict[str, torch.Tensor], DedupMemoryInput,
                                 RawMemoryInput],
                node_feats: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        all_ts = mfg.all_ts()
        if isinstance(mem_input, RawMemoryInput):
            if mem_input.state.mailbox_slots != 1:
                raise ValueError("RawMemoryInput requires a single-slot "
                                 "mailbox")
            updated = self._table(mfg, mem_input.state)
        elif isinstance(mem_input, DedupMemoryInput):
            # the compact pull is f32 even under bf16 compute
            # (memory.py:516), bf16 over bf16 storage there; the GRU runs
            # over all cap rows, unused slots (nid 0, ts 0) included, as
            # there
            di = mem_input
            pulled = prepare_input_at(
                di.state, di.uniq_nids,
                pull_dtype(di.state, self.cell.compute_dtype))
            updated = self.cell(pulled["mem"], _latest_mail(pulled),
                                di.uniq_ts - pulled["mem_ts"],
                                getattr(self, "time_enc", None))
        else:
            updated = self.cell(mem_input["mem"], _latest_mail(mem_input),
                                all_ts - mem_input["mem_ts"],
                                getattr(self, "time_enc", None))
        h, dst_updated = _with_node_feats(self, mfg, mem_input, updated,
                                          node_feats)
        last_updated = {
            "last_updated_nid": mfg.root_nids,
            "last_updated_memory": dst_updated.detach(),
            "last_updated_ts": all_ts[:mfg.num_dst],
        }
        return h, last_updated


def _latest_mail(pulled: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The pulled mail, or with S slots the latest one, slot ``(ptr - 1)
    mod S``."""
    mail = pulled["mail"]
    if mail.dim() == 2:
        return mail
    slot = (pulled["mail_ptr"] - 1) % mail.shape[1]
    return mail[torch.arange(mail.shape[0], device=mail.device), slot]


class TransformerMemoryUpdater(nn.Module):
    """APAN's memory updater (``memory.py:593-753``): each instance's memory
    queries its node's S mail slots in one attention step,
    ``LayerNorm(mem + Σ_S softmax_S(q·k / sqrt(dh)) v)`` per head, with
    ``q = w_q(mem)`` and ``[k | v] = w_kv([mail | TimeEncode(ts -
    mail_ts)])``, or ``w_kv([mail])`` without time encoding
    (``memory.py:655-672``).

    Three inputs: :class:`RawMemoryInput` (the table path, the trainer's
    default) projects the mail part of K/V once per (node, slot) and
    gathers it (:func:`~gnnflow_tpu_torch.ops.apan_kv.apan_table_pull`),
    then adds the time part and the bias in the compute dtype; a dict of
    pulled rows (:func:`prepare_input_at`) projects per instance as a sum
    of per-part products; a :class:`DedupMemoryInput` runs the table path
    over the unique (nid, ts) pairs, or over a bf16-stored state
    (:func:`table_ok`), or a sharded one without the table
    (``DedupMemoryInput.table``), pulls their rows and projects them, and
    expands the result back to the instances with
    :func:`~gnnflow_tpu_torch.ops.segment_sum.expand_compact` (whose
    backward is K4).  Scores are summed over each head in f32 and
    the softmax over S is f32; LayerNorm (eps 1e-5) adds the memory as it
    was pulled, in the compute dtype on the table path.

    Reference behaviours kept: a slot never written (``mail_ts`` 0) is
    not masked out of the softmax, and the updater applies no dropout,
    even in training: the JAX ``DGNN`` calls it without ``train``
    (``dgnn.py:158-159``), so its ``nn.Dropout`` never fires.

    Node features are added to the output as :class:`GRUMemoryUpdater`
    adds them (``memory.py:716-752``).

    Returns ``(h, last_updated)`` as :class:`GRUMemoryUpdater` does."""

    def __init__(self, dim_node: int, dim_edge: int, dim_time: int,
                 dim_memory: int, att_head: int, gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim_memory % att_head:
            raise ValueError("dim_memory must be a multiple of att_head")
        self.dim_node = dim_node
        self.dim_raw = 2 * dim_memory + dim_edge
        self.dim_memory, self.att_head = dim_memory, att_head
        self.compute_dtype = compute_dtype
        self.w_kv = MultiLinear(self.dim_raw + dim_time, 2 * dim_memory, gen,
                                compute_dtype)
        self.w_q = MultiLinear(dim_memory, dim_memory, gen, compute_dtype)
        if dim_time > 0:
            self.time_enc = TimeEncode(dim_time)
        self.layer_norm = nn.LayerNorm(dim_memory, eps=1e-5)
        self.node_feat_proj = _node_feat_proj(dim_node, dim_memory, gen)

    def _table_kv(self, state: MemoryState, nids: torch.Tensor,
                  ts: torch.Tensor):
        """``(mem, kv)`` of the table path for ``nids`` at ``ts``
        (``memory.py:615-661``)."""
        cd = self.compute_dtype or torch.float32
        mails, mail_ts = state.mailbox, state.mailbox_ts
        if state.mailbox_slots == 1:
            mails, mail_ts = mails[:, None], mail_ts[:, None]
        dr, kernel = self.dim_raw, self.w_kv.kernel
        nids = nids.clamp(0, state.num_nodes - 1)
        if state.shard is None:
            mem, kv, mail_ts = apan_table_pull(
                state.node_memory, mails, mail_ts, kernel[:dr], nids,
                self.compute_dtype)
        else:
            mem, kv, mail_ts = apan_table_pull_sharded(
                state.node_memory, mails, mail_ts, kernel[:dr], nids,
                state.shard, self.compute_dtype)
        if hasattr(self, "time_enc"):
            tf = self.time_enc(ts[:, None] - mail_ts)       # [n, S, dt]
            kv = kv + tf.to(cd) @ kernel[dr:].to(cd)
        return mem, kv + self.w_kv.bias.to(cd)

    def _rows_kv(self, pulled: Dict[str, torch.Tensor], ts: torch.Tensor):
        """``(mem, kv)`` from pulled rows at ``ts``: K/V projected per row
        as a sum of per-part products."""
        mem, mail, mail_ts = pulled["mem"], pulled["mail"], \
            pulled["mail_ts"]
        if mail.dim() == 2:                                  # one slot
            mail, mail_ts = mail[:, None], mail_ts[:, None]
        if not hasattr(self, "time_enc"):
            return mem, self.w_kv([mail])
        tf = self.time_enc(ts[:, None] - mail_ts)
        return mem, self.w_kv([mail,
                               tf.to(self.compute_dtype or torch.float32)])

    def attend(self, mem: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """The attention step over the slots (``memory.py:684-708``):
        ``mem`` [n, dm] and ``kv`` [n, S, 2·dm] in the compute dtype;
        returns the updated memory [n, dm], f32."""
        n, S = kv.shape[:2]
        D, H = self.dim_memory, self.att_head
        dh = D // H
        q = self.w_q([mem])
        qk = q[:, None, :] * kv[..., :D]                     # [n, S, D]
        att = qk.float().reshape(n, S, H, dh).sum(-1) / math.sqrt(dh)
        att = torch.softmax(att, dim=1)                      # over the slots
        v = kv[..., D:].reshape(n, S, H, dh)
        upd = (v * att.to(v.dtype)[..., None]).sum(1).reshape(n, D)
        return self.layer_norm(mem.float() + upd.float())

    def forward(self, mfg: MFG,
                mem_input: Union[Dict[str, torch.Tensor], RawMemoryInput,
                                 DedupMemoryInput],
                node_feats: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        all_ts = mfg.all_ts()
        if isinstance(mem_input, DedupMemoryInput):
            di = mem_input
            if di.table and table_ok(di.state):
                mem, kv = self._table_kv(di.state, di.uniq_nids, di.uniq_ts)
            else:
                mem, kv = self._rows_kv(prepare_input_at(
                    di.state, di.uniq_nids,
                    pull_dtype(di.state, self.compute_dtype)), di.uniq_ts)
        elif isinstance(mem_input, RawMemoryInput):
            mem, kv = self._table_kv(mem_input.state, mfg.all_nodes(),
                                     all_ts)
        else:
            mem, kv = self._rows_kv(mem_input, all_ts)
        h, dst_updated = _with_node_feats(self, mfg, mem_input,
                                          self.attend(mem, kv), node_feats)
        last_updated = {
            "last_updated_nid": mfg.root_nids,
            "last_updated_memory": dst_updated.detach(),
            "last_updated_ts": all_ts[:mfg.num_dst],
        }
        return h, last_updated


def update_mem_mail(state: MemoryState,
                    last_updated_nid: torch.Tensor,
                    last_updated_memory: torch.Tensor,
                    last_updated_ts: torch.Tensor,
                    edge_feats: Optional[torch.Tensor],
                    valid: torch.Tensor,
                    neg_sample_ratio: int = 1) -> MemoryState:
    """Write mails and memories of the batch's src/dst nodes back into
    ``state``, **in place**; the last occurrence of a node wins.

    ``last_updated_*`` cover the ``[src | dst | neg]`` roots ((2+r)·B
    rows with ``neg_sample_ratio`` r, split in 2 + r blocks,
    ``memory.py:766-768``); ``valid`` [B] masks padded batch rows.  Mail
    winners are taken over the interleaved ids, memory winners over the
    block-ordered ids
    (``memory.py:801-830``); both cover one node set.  With S slots a
    node's mail goes to slot ``ptr mod S``, ``ptr`` read before the write,
    and its memory winner writes ``ptr + 1``, taking ``ptr`` from the
    node's interleaved row (``:834-875``): the cursor advances once per
    node per step.  Only winner rows are scattered, so the result is
    deterministic.  Values round to the storage dtype (bf16: to nearest
    even).  A sharded state takes the global batch, the same on every
    rank, and writes only the winners it owns: the winners, the slots and
    the cursor are those of the whole batch, with no exchange."""
    b = last_updated_nid.shape[0] // (2 + neg_sample_ratio)
    src, dst = last_updated_nid[:b], last_updated_nid[b:2 * b]
    mem_src = last_updated_memory[:b]
    mem_dst = last_updated_memory[b:2 * b]
    if edge_feats is None:
        edge_feats = mem_src.new_zeros((b, state.dim_raw - 2 * state.dim_memory))

    src_mail = torch.cat([mem_src, mem_dst, edge_feats], dim=1)
    dst_mail = torch.cat([mem_dst, mem_src, edge_feats], dim=1)
    mail = torch.stack([src_mail, dst_mail], dim=1).reshape(2 * b, -1)
    nid_inter = torch.stack([src, dst], dim=1).reshape(-1)
    mail_ts = last_updated_ts[:2 * b]          # block order (quirk)

    valid_inter = valid.repeat_interleave(2) & (nid_inter >= 0)
    nid_block = last_updated_nid[:2 * b]
    valid_block = torch.cat([valid, valid]) & (nid_block >= 0)

    rows = unique_keep_last_mask(nid_inter, valid_inter).nonzero().squeeze(1)
    mrows = unique_keep_last_mask(nid_block, valid_block).nonzero().squeeze(1)
    lo, n = 0, state.node_memory.shape[0]
    if state.shard is not None:
        lo = state.shard.lo
        rows = rows[(nid_inter[rows] >= lo) & (nid_inter[rows] < lo + n)]
        mrows = mrows[(nid_block[mrows] >= lo) & (nid_block[mrows] < lo + n)]
    nodes, mnodes = nid_inter[rows] - lo, nid_block[mrows] - lo
    vdt = state.node_memory.dtype
    S = state.mailbox_slots
    if S == 1:
        state.mailbox[nodes] = mail[rows].to(vdt)
        state.mailbox_ts[nodes] = mail_ts[rows]
    else:
        ptr = state.mailbox_ptr[(nid_inter - lo).clamp(0, n - 1)]
        slot = ptr[rows] % S
        state.mailbox[nodes, slot] = mail[rows].to(vdt)
        state.mailbox_ts[nodes, slot] = mail_ts[rows]
        # block row i is interleaved row 2 (i mod b) + i div b
        state.mailbox_ptr[mnodes] = ptr[2 * (mrows % b) + mrows // b] + 1
    state.node_memory[mnodes] = last_updated_memory[mrows].to(vdt)
    state.node_memory_ts[mnodes] = last_updated_ts[mrows]
    return state
