"""Initial weights made by the benchmark from the seed, on the device, for
both the program and the reference.

One ``torch.rand`` call on a generator on the device draws every random
leaf at once; each leaf then takes its slice.  The laws are the program's
documented ones (``gnnflow_tpu_torch/models/modules.py``): a kernel
``[in, out]`` and its bias uniform in ``±1/sqrt(in)``, a time encoding's
frequencies ``1/10^linspace(0, 9, d)`` and phases 0, a LayerNorm's scale 1
and shift 0.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    if name.endswith(".kernel"):
        return shapes[name][0]
    sibling = name[: -len(".bias")] + ".kernel"
    return shapes[sibling][0]


def make(shapes: Dict[str, Tuple[int, ...]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """Float32 leaves of ``shapes`` (name -> shape), by the names' laws."""
    rand = [k for k in shapes if k.endswith((".kernel", ".bias"))
            and not k.endswith("layer_norm.bias")]
    total = sum(math.prod(shapes[k]) for k in rand)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for k in rand:
        n = math.prod(shapes[k])
        bound = 1.0 / math.sqrt(_fan_in(k, shapes))
        out[k] = (flat[off: off + n] * bound).reshape(shapes[k])
        off += n
    for k, shape in shapes.items():
        if k in out:
            continue
        if k.endswith("time_enc.w"):
            out[k] = 1.0 / 10 ** torch.linspace(0, 9, shape[0],
                                                 device=device)
        elif k.endswith(("time_enc.b", "layer_norm.bias")):
            out[k] = torch.zeros(shape, device=device)
        elif k.endswith("layer_norm.weight"):
            out[k] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"no initial law for the leaf {k!r}")
    return out
