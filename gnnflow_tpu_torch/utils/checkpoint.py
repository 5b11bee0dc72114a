"""Checkpoints: model parameters and a TGN memory snapshot.

Counterpart of ``gnnflow_tpu/utils/checkpoint.py`` (the reference's
``torch.save({'model': state_dict, 'memory': memory.backup()})`` on best
validation AP), with ``torch.save`` of the model's state dict, a
:func:`~gnnflow_tpu_torch.models.memory.backup_memory` snapshot and extra
values.  Loading reads tensors and plain containers only
(``weights_only``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    memory_backup: Optional[Dict] = None,
                    extra: Optional[Dict] = None) -> None:
    """Write ``{"params", "memory", "extra"}`` to ``path`` atomically;
    tensors are stored on the CPU."""
    payload = {"params": {k: v.detach().cpu() for k, v in state_dict.items()},
               "memory": memory_backup or {},
               "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)
