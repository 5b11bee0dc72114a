"""Core constants, the padded message-flow graph (MFG) and device checks.

Counterpart of ``gnnflow_tpu/common.py``: the MFG is a dataclass of torch
tensors with fixed ``[num_dst, fanout]`` neighbour slots plus a validity
mask.  Node and edge ids are int64 (PyTorch's index type).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Invalid-neighbour sentinel (``gnnflow_tpu/common.py:28``).
INVALID_NID = -1

# Timestamp used for static (non-temporal) sampling: float32 max.
STATIC_TS = float(np.finfo(np.float32).max)


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point; raises when CUDA is asked for
    and this process has none (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclass
class MFG:
    """A padded message flow graph for one (layer, snapshot).

    ``num_dst`` roots come first; each has ``fanout`` neighbour slots.
    Invalid slots hold ``INVALID_NID`` / zeros and ``nbr_mask`` False.
    """

    root_nids: torch.Tensor   # [B] int64
    root_ts: torch.Tensor     # [B] float32
    nbr_nids: torch.Tensor    # [B, F] int64 (INVALID_NID when invalid)
    nbr_ts: torch.Tensor      # [B, F] float32
    nbr_dts: torch.Tensor     # [B, F] float32 (root_ts - edge_ts)
    nbr_eids: torch.Tensor    # [B, F] int64
    nbr_mask: torch.Tensor    # [B, F] bool

    @property
    def num_dst(self) -> int:
        return self.root_nids.shape[0]

    @property
    def fanout(self) -> int:
        return self.nbr_nids.shape[1]

    @property
    def num_all(self) -> int:
        return self.num_dst * (1 + self.fanout)

    def all_nodes(self) -> torch.Tensor:
        """[B*(1+F)] node ids: dst nodes first, then padded neighbours."""
        return torch.cat([self.root_nids, self.nbr_nids.reshape(-1)])

    def all_ts(self) -> torch.Tensor:
        """[B*(1+F)] timestamps aligned with :meth:`all_nodes`."""
        return torch.cat([self.root_ts, self.nbr_ts.reshape(-1)])

    def all_mask(self) -> torch.Tensor:
        """[B*(1+F)] validity: dst rows always valid, neighbours masked."""
        return torch.cat([
            torch.ones(self.num_dst, dtype=torch.bool,
                       device=self.nbr_mask.device),
            self.nbr_mask.reshape(-1)])
