"""TGN node memory and mailbox, the GRU memory updater and write-back.

Counterpart of ``gnnflow_tpu/models/memory.py`` for one mail slot and f32
storage: ``MemoryState`` and ``init_memory`` (``:50-208``),
``prepare_input`` and the meaning of ``prepare_input_bf16``
(``:377-433``), ``GRUMemoryUpdater`` on the per-instance path
(``:436-590``) and ``update_mem_mail`` (``:756-833``).

Unlike the JAX package, which builds a new state array every step, the
port updates the memory tensors **in place** (:func:`update_mem_mail`).

Kept reference quirk: mailbox timestamps are ``last_updated_ts[:2B]`` in
block order (src block, then dst block) while mails and their node ids are
interleaved ``[s0, d0, s1, d1, ...]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gnnflow_tpu_torch.common import MFG
from gnnflow_tpu_torch.models.modules import FusedGRUCell, TimeEncode
from gnnflow_tpu_torch.ops.segment import unique_keep_last_mask


@dataclass
class MemoryState:
    """Per-node memory state: the reference's four tensors, f32."""

    node_memory: torch.Tensor     # [N, dim_memory]
    node_memory_ts: torch.Tensor  # [N]
    mailbox: torch.Tensor         # [N, dim_raw], dim_raw = 2*dm + dim_edge
    mailbox_ts: torch.Tensor      # [N]

    @property
    def num_nodes(self) -> int:
        return self.node_memory.shape[0]

    @property
    def dim_memory(self) -> int:
        return self.node_memory.shape[1]

    @property
    def dim_raw(self) -> int:
        return self.mailbox.shape[1]


def init_memory(num_nodes: int, dim_memory: int, dim_edge: int,
                device) -> MemoryState:
    dim_raw = 2 * dim_memory + dim_edge
    z = dict(dtype=torch.float32, device=device)
    return MemoryState(torch.zeros(num_nodes, dim_memory, **z),
                       torch.zeros(num_nodes, **z),
                       torch.zeros(num_nodes, dim_raw, **z),
                       torch.zeros(num_nodes, **z))


def prepare_input(state: MemoryState, mfg: MFG,
                  dtype: torch.dtype = torch.float32
                  ) -> Dict[str, torch.Tensor]:
    """Pull memory rows for the MFG's nodes (padded ids clip to 0).

    ``dtype=torch.bfloat16`` is what ``prepare_input_bf16`` means: memory
    and mail values round to bf16 (the node tables are cast once, then
    gathered, halving the gathered bytes) while timestamps stay f32.  The
    TPU's lane packing of that pull has no GPU counterpart."""
    nids = mfg.all_nodes().clamp(0, state.num_nodes - 1)
    mem, mail = state.node_memory, state.mailbox
    if dtype != torch.float32:
        mem, mail = mem.to(dtype), mail.to(dtype)
    return {"mem": mem[nids], "mem_ts": state.node_memory_ts[nids],
            "mail": mail[nids]}


class GRUMemoryUpdater(nn.Module):
    """GRU memory updater over every MFG instance (``memory.py:436-590``,
    per-instance path, ``impl="pallas"``): ``dts = ts - mem_ts`` and
    ``h = GRU(mem, [mail | TimeEncode(dts)])`` in the fused kernel.

    Returns ``(h, last_updated)``; ``last_updated`` holds the node ids,
    updated memory and timestamps of the dst rows for write-back, detached
    from autograd (``memory.py:583-589``)."""

    def __init__(self, dim_edge: int, dim_time: int, dim_memory: int,
                 gen: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim_time <= 0:
            raise NotImplementedError(
                "a memory updater without time encoding is not on the TGN "
                "path (ROADMAP.md, modules to port, item 14)")
        self.cell = FusedGRUCell(2 * dim_memory + dim_edge + dim_time,
                                 dim_memory, gen, compute_dtype)
        self.time_enc = TimeEncode(dim_time)

    def forward(self, mfg: MFG, mem_input: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        all_ts = mfg.all_ts()
        dts = all_ts - mem_input["mem_ts"]
        updated = self.cell(mem_input["mem"], mem_input["mail"], dts,
                            self.time_enc)
        b = mfg.num_dst
        last_updated = {
            "last_updated_nid": mfg.root_nids,
            "last_updated_memory": updated[:b].detach(),
            "last_updated_ts": all_ts[:b],
        }
        return updated, last_updated


def update_mem_mail(state: MemoryState,
                    last_updated_nid: torch.Tensor,
                    last_updated_memory: torch.Tensor,
                    last_updated_ts: torch.Tensor,
                    edge_feats: Optional[torch.Tensor],
                    valid: torch.Tensor) -> MemoryState:
    """Write mails and memories of the batch's src/dst nodes back into
    ``state``, **in place**; the last occurrence of a node wins.

    ``last_updated_*`` cover the ``[src | dst | neg]`` roots (3B rows);
    ``valid`` [B] masks padded batch rows.  Mail winners are taken over the
    interleaved ids, memory winners over the block-ordered ids, and a
    node's written memory row is its memory winner's (``memory.py:801-830``).
    Only winner rows are scattered, so the result is deterministic."""
    b = last_updated_nid.shape[0] // 3
    dev = last_updated_nid.device
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

    win_mail = unique_keep_last_mask(nid_inter, valid_inter)
    win_mem = unique_keep_last_mask(nid_block, valid_block)
    # node -> row of its memory winner (both masks cover one node set)
    memwin = torch.zeros(state.num_nodes, dtype=torch.long, device=dev)
    memwin[nid_block[win_mem]] = torch.arange(
        2 * b, device=dev)[win_mem]
    rows = win_mail.nonzero().squeeze(1)
    nodes = nid_inter[rows]
    midx = memwin[nodes]
    state.node_memory[nodes] = last_updated_memory[midx].float()
    state.node_memory_ts[nodes] = last_updated_ts[midx]
    state.mailbox[nodes] = mail[rows].float()
    state.mailbox_ts[nodes] = mail_ts[rows]
    return state
