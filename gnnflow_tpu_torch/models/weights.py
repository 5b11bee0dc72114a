"""Carry a Flax parameter tree of ``gnnflow_tpu``'s DGNN into the port.

The Flax tree (nested dicts of arrays, kernels ``[in, out]``) maps onto the
port's parameter names one for one after renaming the auto-named Flax
submodules; kernels keep their ``[in, out]`` layout, so nothing is
transposed.  The TGN tree:

- ``updater/FusedGRUCell_0/{ih,hh}/{kernel,bias}``, ``updater/TimeEncode_0/{w,b}``
- ``l0h0/{w_q,w_kv,w_out}/{kernel,bias}``, ``l0h0/TimeEncode_0/{w,b}``,
  ``l0h0/LayerNorm_0/{scale,bias}``
- ``edge_predictor/{src_fc,dst_fc,out_fc}/{kernel,bias}``
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gnnflow_tpu_torch.models.dgnn import DGNN

_RENAME = {"FusedGRUCell_0": "cell", "TimeEncode_0": "time_enc",
           "LayerNorm_0": "layer_norm"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_name(path: tuple) -> str:
    parts = [_RENAME.get(p, p) for p in path]
    if parts[0] == "l0h0":
        parts[0] = "layers.l0h0"
    if len(parts) >= 2 and parts[-2] == "layer_norm" and parts[-1] == "scale":
        parts[-1] = "weight"
    return ".".join(parts)


@torch.no_grad()
def load_flax_params(model: DGNN, tree: Mapping) -> None:
    """Copy a Flax DGNN parameter tree (nested dicts of numpy arrays) into
    ``model`` (a :class:`~gnnflow_tpu_torch.models.dgnn.DGNN`) in place and
    remake its compute-dtype weight copies.  Raises on a missing or extra
    name or a shape mismatch."""
    params = dict(model.named_parameters())
    flat = {_port_name(p): a for p, a in _flatten(tree).items()}
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    for name, arr in flat.items():
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(np.asarray(arr, dtype=np.float32)))
    model.cast_weights()
