"""Carry a Flax parameter tree of ``gnnflow_tpu``'s DGNN, SAGE or GAT into
the port, and the port's parameters back out as such a tree.

The Flax tree (nested dicts of arrays, kernels ``[in, out]``) maps onto the
port's parameter names one for one after renaming the auto-named Flax
submodules; kernels keep their ``[in, out]`` layout, so nothing is
transposed.  The tree:

- ``updater/FusedGRUCell_0/{ih,hh}/{kernel,bias}``,
  ``updater/TimeEncode_0/{w,b}`` (TGN's GRU updater), or
  ``updater/{w_kv,w_q}/{kernel,bias}``, ``updater/TimeEncode_0/{w,b}``,
  ``updater/LayerNorm_0/{scale,bias}`` (APAN's transformer updater); with
  node features of another width than the memory's, also
  ``updater/node_feat_proj/{kernel,bias}``; a model without memory has no
  ``updater``
- per attention layer ``l{l}h{h}`` (TGN ``l0h0``; TGAT ``l0h0``, ``l1h0``;
  DySAT ``l{0,1}h{0,1,2}``): ``{w_q,w_kv,w_out}/{kernel,bias}``,
  ``TimeEncode_0/{w,b}``, ``LayerNorm_0/{scale,bias}``; a layer without
  time encoding has no ``TimeEncode_0``, and one with neither time
  encoding nor node input (DySAT's ``l0h*``) no ``w_q`` either
- ``combiner/{ih,hh}/{kernel,bias}`` (more than one snapshot)
- ``edge_predictor/{src_fc,dst_fc,out_fc}/{kernel,bias}``
- SAGE: per layer ``l{l}h0``, ``fc_self/{kernel,bias}`` and
  ``fc_neigh/kernel`` (``mean``, ``pool``, which adds
  ``fc_pool/{kernel,bias}``) or ``fc_neigh/{kernel,bias}`` (``gcn``);
  GAT: per layer ``l{l}h0``, ``fc/kernel`` [in, H·D] and ``attn_l``,
  ``attn_r`` [H, D]; both ``predictor/{fc0,fc1,fc2}/{kernel,bias}``
- the node-classification ``MLP``: ``{fc1,fc2}/{kernel,bias}``

The port names a layer ``layers.l{l}h{h}``.  The factorized attention
reads the same ``w_kv`` as the materialised one.  A tree of the old layout,
with split ``w_k`` and ``w_v`` where ``w_kv`` now stands, loads with the
pair fused column-wise, ``[K_k | K_v]``, as the JAX package's
``migrate_params`` does on load (``utils/checkpoint.py:34-56``).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_RENAME = {"FusedGRUCell_0": "cell", "TimeEncode_0": "time_enc",
           "LayerNorm_0": "layer_norm"}
_FLAX_NAME = {v: k for k, v in _RENAME.items()}
_LAYER = re.compile(r"l\d+h\d+")


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
    if _LAYER.fullmatch(parts[0]):
        parts[0] = "layers." + parts[0]
    if len(parts) >= 2 and parts[-2] == "layer_norm" and parts[-1] == "scale":
        parts[-1] = "weight"
    return ".".join(parts)


def _flax_path(name: str) -> tuple:
    """Inverse of :func:`_port_name`."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = parts[1:]
    if len(parts) >= 2 and parts[-2] == "layer_norm" and parts[-1] == "weight":
        parts[-1] = "scale"
    return tuple(_FLAX_NAME.get(p, p) for p in parts)


def _fuse_split_kv(tree: Mapping) -> dict:
    """``tree`` with every split ``w_k``/``w_v`` pair (and no ``w_kv``
    beside it) fused into ``w_kv``: kernels and biases concatenated along
    their last axis, K first; other trees pass through."""
    out = {k: _fuse_split_kv(v) if isinstance(v, Mapping) else v
           for k, v in tree.items()}
    if "w_k" in out and "w_v" in out and "w_kv" not in out:
        wk, wv = out.pop("w_k"), out.pop("w_v")
        out["w_kv"] = {n: np.concatenate([np.asarray(wk[n]),
                                          np.asarray(wv[n])], axis=-1)
                       for n in ("kernel", "bias")}
    return out


@torch.no_grad()
def load_flax_params(model: nn.Module, tree: Mapping) -> None:
    """Copy a Flax parameter tree (nested dicts of numpy arrays) into
    ``model`` (a :class:`~gnnflow_tpu_torch.models.dgnn.DGNN`,
    :class:`~gnnflow_tpu_torch.models.static.SAGE` or ``GAT``) in place
    and remake its compute-dtype weight copies.  An old split ``w_k``/
    ``w_v`` pair loads fused (:func:`_fuse_split_kv`).  Raises on a missing
    or extra name or a shape mismatch."""
    params = dict(model.named_parameters())
    flat = {_port_name(p): a
            for p, a in _flatten(_fuse_split_kv(tree)).items()}
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
    if hasattr(model, "cast_weights"):
        model.cast_weights()


def flax_param_tree(model: nn.Module) -> Dict[str, dict]:
    """The model's parameters as a Flax parameter tree (nested dicts of f32
    numpy arrays, Flax names): the inverse of :func:`load_flax_params`."""
    tree: Dict[str, dict] = {}
    for name, p in model.named_parameters():
        path = _flax_path(name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().cpu().numpy().copy()
    return tree
