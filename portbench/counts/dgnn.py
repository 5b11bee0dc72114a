"""The work that a DGNN step's inputs need (TGN, TGAT): operations for the
whole step and the least time of the GRU kernels (K1, K2) and of the
attention kernel (K3), counted from the batch's roots with the
benchmark's own sampler on its own store.

Only valid roots and valid neighbour slots count, and the memory updater
counts each distinct ``(node, time)`` row once: padding and repeated rows
earn no credit.  Uniform picks are the benchmark's own draws, so the
counted neighbourhoods follow the same law as the program's.  Operations
are multiply-adds times two; the backward pass counts the weights'
gradients and the inputs' gradients where an input needs one.  K1's and
K2's bytes and operations are chip_smoke.py's formulas (commit e51abea):
each input read once, each output written once.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import least_s
from portbench.reference.dgnn import _ts_bits

F32 = 4


def _linear(n, k, m, train: bool, kdx: int) -> float:
    """``[n, k] @ [k, m]``; training adds the weights' gradient and the
    gradient of the ``kdx`` input columns that need one."""
    fwd = 2.0 * n * k * m
    return fwd + (fwd + 2.0 * n * kdx * m if train else 0.0)


def _attention(R, S, dn, de, dt, D, train: bool, h_grad: bool) -> float:
    """A temporal attention layer over ``R`` roots and ``S`` valid
    slots: Q, K/V, scores, weighted sum, output projection.  The time
    encodings' inputs need gradients (their parameters train); the
    node inputs where ``h_grad``; the edge features never."""
    hn = dn if h_grad else 0
    f = _linear(R, dn + dt, D, train, hn + dt)
    f += _linear(S, dn + de + dt, 2 * D, train, hn + dt)
    f += 4.0 * S * D * (3 if train else 1)
    f += _linear(R, D + dn, D, train, D + hn)
    return f


def _gru(M, dr, dt, f, train: bool):
    """K1 (and K2) on ``M`` rows: ``(operations, least seconds)``."""
    w = ((dr + dt) * 3 * f + f * 3 * f + 6 * f + 2 * dt) * F32
    rows = M * (f + dr + 1 + f) * F32
    k1 = 2.0 * M * ((dr + dt) * 3 * f + f * 3 * f)
    t = least_s(rows + w, k1, "float32")
    if not train:
        return k1, t
    k2 = 2.0 * M * (2 * (dr + dt + f) * 3 * f + 3 * f * dt)
    return k1 + k2, t + least_s(rows + 2 * w, k2, "float32")


def work(cfg, store, batches, train: bool, device, seed: int = 0) -> dict:
    """Summed over ``batches`` (each ``(roots, ts, num_valid)``, NumPy):
    ``flops``, ``gru_least_s`` and ``attn_least_s`` (K3's least time,
    where the step runs K3: eval, or training without attention
    dropout)."""
    de = cfg["stream"]["dim_edge"]
    D, dt = cfg["dim_embed"], cfg["dim_time"]
    mem = bool(cfg.get("use_memory"))
    dm = cfg.get("dim_memory", 0)
    L = cfg["num_layers"]
    fan = cfg["fanouts"]
    k3 = not train or cfg["att_dropout"] == 0
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"flops": 0.0, "gru_least_s": 0.0, "attn_least_s": 0.0}
    for roots_np, ts_np, k in batches:
        b = len(roots_np) // 3
        sel = [slice(i * b, i * b + k) for i in range(3)]
        roots = torch.as_tensor(np.concatenate([roots_np[s] for s in sel]),
                                device=device)
        ts = torch.as_tensor(np.concatenate([ts_np[s] for s in sel]),
                             device=device)
        levels = []
        r, t = roots, ts
        for i in range(L):
            F = fan[L - 1 - i]
            u = torch.rand((len(r), F), generator=gen, device=device) \
                if cfg["sample_strategy"] == "uniform" else None
            nbr = store.sample(r, t, F, u)
            levels.append((len(r), int(nbr["mask"].sum())))
            inst = torch.cat([r, nbr["nid"][nbr["mask"]]])
            its = torch.cat([t, nbr["ts"][nbr["mask"]]])
            key = torch.unique(inst * 2 ** 32 + _ts_bits(its))
            r = torch.div(key, 2 ** 32, rounding_mode="floor")
            t = (key - r * 2 ** 32).to(torch.int32).view(torch.float32)
        if mem:
            # the innermost layer's instances: roots and valid slots
            M = len(r)
            fl, tl = _gru(M, 2 * dm + de, dt, dm, train)
            out["flops"] += fl
            out["gru_least_s"] += tl
        for li in range(L):            # innermost first
            R, S = levels[L - 1 - li]
            dn = (dm if mem else 0) if li == 0 else D
            h_grad = train and (mem or li > 0)
            out["flops"] += _attention(R, S, dn, de, dt, D, train, h_grad)
            if k3:
                nbytes = (2 * R * D + 2 * S * D) * F32 + R * fan[0]
                out["attn_least_s"] += least_s(nbytes, 4.0 * S * D,
                                               "float32")
        out["flops"] += _linear(k, D, D, train, D) \
            + _linear(2 * k, D, D, train, D) + _linear(2 * k, D, 1, train, D)
    out["peak_flops"] = cfg["peak_flops"]
    return out
