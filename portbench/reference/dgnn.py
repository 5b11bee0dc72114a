"""Plain PyTorch reference of TGN and TGAT link prediction: the store, the
temporal sampler, the GRU memory updater, the temporal attention layers,
the edge predictor, the loss, Adam and the memory write-back, in float32
with TF32 off and no kernels, batching tricks or caches.

It follows GNNFlow's published model (``gnnflow/models``, TGN and TGAT as
TGL defines them) as the port's configuration registry states it, and
imports nothing of the program.  Where the program's own conventions fix
a result, the reference keeps them and says so:

- the store holds each edge once, from its source (a directed data
  config), each node's edges in time order, ties in arrival order; a
  root at time ``t`` sees the edges strictly before ``t``;
- recent sampling takes the ``F`` newest; uniform sampling takes, for
  draw ``u``, the candidate ``min(int(u * n), n - 1)`` back from the
  newest of ``n`` (with replacement), every slot valid when ``n > 0``;
- randomness (uniform draws, dropout masks) replays ``torch.rand`` on
  generators seeded as the benchmark seeds the program's, in the order
  and the shapes a step draws them (:class:`Draws`); a dropout keeps a
  value where its draw is below ``1 - p`` and scales it by ``1/(1-p)``;
- attention scores are ``LeakyReLU_0.2(q . k)`` per head with no scale,
  a row with no valid slot gives 0;
- the write-back stores, for each node, the memory of its last row among
  the batch's sources then destinations, and the mail
  ``[mem_self | mem_other | edge feature]`` of its last row among the
  interleaved ``[s0, d0, s1, d1, ...]``; memory timestamps are the roots'
  (the mail timestamps are not read by the GRU and are not kept).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as nnf

INVALID = -1


def no_tf32() -> None:
    """Full float32 products: TF32 would be a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Draws:
    """``torch.rand`` on a generator seeded with ``seed`` on ``device``;
    ``shapes``, where given, is the list of shapes the program drew, which
    each draw checks against."""

    def __init__(self, seed: int, device, shapes: Optional[List] = None):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = device
        self.shapes = None if shapes is None else list(shapes)
        self.n = 0

    def peek(self) -> Optional[tuple]:
        if self.shapes is None or self.n >= len(self.shapes):
            return None
        return tuple(self.shapes[self.n])

    def rand(self, shape) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        want = self.peek()
        if self.shapes is not None and want != shape:
            raise ValueError(f"draw {self.n}: the program drew {want}, "
                             f"the reference needs {shape}")
        self.n += 1
        return torch.rand(shape, generator=self.gen, device=self.device)


def _ts_bits(ts: torch.Tensor) -> torch.Tensor:
    """Non-negative float32 times as int64 keys in their order."""
    return ts.float().contiguous().view(torch.int32).long()


class Store:
    """Every node's edges ``(dst, ts, eid)`` in time order, ties in
    arrival order, built from edges given in arrival order."""

    def __init__(self, src, dst, ts, eid, device):
        src = torch.as_tensor(src, device=device).long()
        key = src * 2 ** 32 + _ts_bits(torch.as_tensor(ts, device=device))
        self.key, order = torch.sort(key, stable=True)
        self.src = src[order]
        self.dst = torch.as_tensor(dst, device=device).long()[order]
        self.ts = torch.as_tensor(ts, device=device).float()[order]
        self.eid = torch.as_tensor(eid, device=device).long()[order]

    def window(self, roots: torch.Tensor, ts: torch.Tensor):
        """``(start, end)``: the slots of each root's edges before ``ts``."""
        r = roots.clamp_min(0).long()
        start = torch.searchsorted(self.key, r * 2 ** 32)
        end = torch.searchsorted(self.key, r * 2 ** 32 + _ts_bits(ts))
        end = torch.where(roots >= 0, end, start)
        return start, end

    def sample(self, roots: torch.Tensor, ts: torch.Tensor, fanout: int,
               u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The ``[B, F]`` neighbours of ``roots`` at ``ts``: the newest
        ``F`` (``u`` None) or uniform picks for the draws ``u`` [B, F]."""
        start, end = self.window(roots, ts)
        nc = (end - start)[:, None]
        if u is None:
            back = torch.arange(fanout, device=roots.device)[None]
            mask = back < nc
        else:
            back = torch.minimum((u * nc.float()).long(),
                                 (nc - 1).clamp_min(0))
            mask = (nc > 0).expand_as(back)
        idx = (end[:, None] - 1 - back).clamp(0, max(len(self.key) - 1, 0))
        ets = torch.where(mask, self.ts[idx], 0.0)
        return {"nid": torch.where(mask, self.dst[idx], INVALID),
                "ts": ets, "dts": torch.where(mask, ts[:, None] - ets, 0.0),
                "eid": torch.where(mask, self.eid[idx], 0), "mask": mask}


def time_encode(dt: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    return torch.cos(dt[..., None] * w + b)


def dropout(x: torch.Tensor, p: float, draws: Optional[Draws]):
    if draws is None or p == 0.0:
        return x
    keep = draws.rand(x.shape) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def gru_memory(P: dict, mem, mail, dts):
    """The GRU cell over ``[mail | TE(dts)]`` and the memory ``mem``;
    gate columns ``[r | z | n]``."""
    f = mem.shape[1]
    x = torch.cat([mail, time_encode(dts, P["updater.time_enc.w"],
                                     P["updater.time_enc.b"])], 1)
    gi = x @ P["updater.cell.ih.kernel"] + P["updater.cell.ih.bias"]
    gh = mem @ P["updater.cell.hh.kernel"] + P["updater.cell.hh.bias"]
    r = torch.sigmoid(gi[:, :f] + gh[:, :f])
    z = torch.sigmoid(gi[:, f:2 * f] + gh[:, f:2 * f])
    n = torch.tanh(gi[:, 2 * f:] + r * gh[:, 2 * f:])
    return (1.0 - z) * n + z * mem


def attention_layer(P: dict, name: str, h_dst, h_src, nbr, ef, heads: int,
                    drop: Optional[Draws], p_drop: float, p_att: float):
    """One temporal attention layer over ``B`` roots with ``F`` slots:
    ``h_dst`` [B, dn], ``h_src`` [B, F, dn] (``dn`` may be 0), edge
    features ``ef`` [B, F, de]."""
    g = lambda k: P[f"layers.{name}.{k}"]
    B, F = nbr["mask"].shape
    tw, tb = g("time_enc.w"), g("time_enc.b")
    ztf = time_encode(torch.zeros(B, device=ef.device), tw, tb)
    q = torch.cat([h_dst, ztf], 1) @ g("w_q.kernel") + g("w_q.bias")
    kv = torch.cat([h_src, ef, time_encode(nbr["dts"], tw, tb)], 2) \
        @ g("w_kv.kernel") + g("w_kv.bias")
    D = q.shape[1]
    k, v = kv[..., :D], kv[..., D:]
    s = (q[:, None, :] * k).reshape(B, F, heads, D // heads).sum(-1)
    s = nnf.leaky_relu(s, 0.2)
    mask = nbr["mask"][..., None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(1, keepdim=True)) * mask
    att = e / e.sum(1, keepdim=True).clamp_min(1e-10)
    att = dropout(att, p_att, drop)
    agg = (v * att.repeat_interleave(D // heads, dim=-1)).sum(1)
    rst = torch.cat([agg, h_dst], 1) @ g("w_out.kernel") + g("w_out.bias")
    rst = dropout(rst, p_drop, drop)
    return nnf.layer_norm(torch.relu(rst), (D,), g("layer_norm.weight"),
                          g("layer_norm.bias"), eps=1e-5)


def edge_logits(P: dict, h: torch.Tensor):
    b = h.shape[0] // 3
    lin = lambda x, n: x @ P[f"edge_predictor.{n}.kernel"] \
        + P[f"edge_predictor.{n}.bias"]
    s = lin(h[:b], "src_fc")
    pos = lin(torch.relu(s + lin(h[b:2 * b], "dst_fc")), "out_fc")
    neg = lin(torch.relu(s + lin(h[2 * b:], "dst_fc")), "out_fc")
    return pos[:, 0], neg[:, 0]


def bce_loss(pos, neg, valid):
    """Mean BCE of the positives against 1 plus that of the negatives
    against 0, over the valid edges."""
    w = valid.float()
    n = w.sum().clamp_min(1.0)
    return (nnf.softplus(-pos) * w).sum() / n \
        + (nnf.softplus(neg) * w).sum() / n


def _gather(table, ids, mask):
    rows = table[ids.clamp_min(0).reshape(-1)].reshape(ids.shape + (-1,))
    return torch.where(mask[..., None], rows, 0.0)


def _inner_rows(nid, ts, valid, rows: int):
    """The deeper layer's roots: one per instance when ``rows`` is the
    instance count, else the unique valid ``(nid, ts)`` pairs in
    ascending order, padded to ``rows``; and each instance's row."""
    L = nid.shape[0]
    if rows == L:
        return (torch.where(valid, nid, INVALID), torch.where(valid, ts, 0.0),
                torch.arange(L, device=nid.device))
    key = torch.where(valid, nid * 2 ** 32 + _ts_bits(ts), 2 ** 62)
    uk, inv = torch.unique(key, return_inverse=True)
    n = int((uk < 2 ** 62).sum())
    if n > rows:
        raise ValueError(f"{n} unique pairs do not fit {rows} rows")
    r = torch.full((rows,), INVALID, dtype=torch.long, device=nid.device)
    t = torch.zeros(rows, device=nid.device)
    r[:n] = torch.div(uk[:n], 2 ** 32, rounding_mode="floor")
    t[:n] = (uk[:n] - r[:n] * 2 ** 32).to(torch.int32).view(torch.float32)
    return r, t, inv.clamp(max=rows - 1)


class Model:
    """A registry configuration's model over plain tensors ``P`` named as
    the program's parameters."""

    def __init__(self, cfg: dict):
        self.layers = int(cfg["num_layers"])
        self.fanouts = [int(f) for f in cfg["fanouts"]]
        self.heads = int(cfg["att_head"])
        self.uniform = cfg["sample_strategy"] == "uniform"
        self.memory = bool(cfg.get("use_memory", False))
        self.p_drop = float(cfg["dropout"])
        self.p_att = float(cfg["att_dropout"])
        if self.memory and self.layers != 1:
            raise ValueError("the reference keeps memory over one layer, "
                             "as the registry's TGN has it")

    def forward(self, P, store: Store, ef_table, mem: Optional[dict],
                roots, ts, train: bool, drop: Optional[Draws],
                smp: Optional[Draws]):
        """Logits ``(pos [B], neg [B])`` of a batch of roots ``[src | dst
        | neg]`` at ``ts``, and the roots' updated memory (None without
        memory).  ``smp`` gives uniform draws, ``drop`` dropout masks."""
        levels = []          # outermost first: (roots, ts, nbr, row map)
        r, t, rowmap = roots, ts, None
        for i in range(self.layers):
            F = self.fanouts[self.layers - 1 - i]
            if i > 0:
                prev_r, prev_t, prev = levels[-1][:3]
                inst = torch.cat([prev_r, prev["nid"].reshape(-1)])
                inst_t = torch.cat([prev_t, prev["ts"].reshape(-1)])
                # a batch root is an instance even where it pads the
                # batch (id -1, time 0), as the program counts them
                ok = torch.cat([torch.ones_like(prev_r, dtype=torch.bool),
                                prev["mask"].reshape(-1)])
                rows = smp.peek()[1] if smp is not None and smp.peek() \
                    else inst.shape[0]
                r, t, rowmap = _inner_rows(inst, inst_t, ok, rows)
            u = smp.rand((1, r.shape[0], F))[0] \
                if self.uniform and smp is not None else None
            if self.uniform and u is None:
                raise ValueError("uniform sampling needs draws")
            levels.append((r, t, store.sample(r, t, F, u), rowmap))
        last = None
        h = None             # the previous (deeper) layer's output
        for li in range(self.layers):
            r, t, nbr, _ = levels[self.layers - 1 - li]
            B, F = nbr["mask"].shape
            if self.memory:
                inst = torch.cat([r, nbr["nid"].reshape(-1)])
                ok = torch.cat([r >= 0, nbr["mask"].reshape(-1)])
                its = torch.cat([t, nbr["ts"].reshape(-1)])
                i0 = inst.clamp_min(0)
                upd = gru_memory(P, mem["mem"][i0], mem["mail"][i0],
                                 its - mem["mem_ts"][i0])
                upd = torch.where(ok[:, None], upd, 0.0)
                last = upd[:B].detach()
                h_all = upd
            elif h is not None:
                rowmap = levels[self.layers - li][3]
                h_all = h[rowmap]
            else:
                h_all = torch.zeros(B * (1 + F), 0, device=roots.device)
            ef = _gather(ef_table, nbr["eid"], nbr["mask"])
            h = attention_layer(P, f"l{li}h0", h_all[:B],
                                h_all[B:].reshape(B, F, -1), nbr, ef,
                                self.heads, drop if train else None,
                                self.p_drop, self.p_att)
        pos, neg = edge_logits(P, h)
        return pos, neg, last


def write_back(mem: dict, roots, ts, last, valid, eids, ef_table) -> None:
    """The write-back of a batch's roots' updated memory ``last`` [3B, f]
    into ``mem`` (in place), as the module docstring states."""
    b = valid.shape[0]
    src, dst = roots[:b], roots[b:2 * b]
    tef = torch.where(valid[:, None], ef_table[eids], 0.0)
    ms, md = last[:b], last[b:2 * b]
    mail = torch.stack([torch.cat([ms, md, tef], 1),
                        torch.cat([md, ms, tef], 1)], 1).reshape(2 * b, -1)
    nid_i = torch.stack([src, dst], 1).reshape(-1)
    ok_i = valid.repeat_interleave(2) & (nid_i >= 0)
    nid_b = roots[:2 * b]
    ok_b = torch.cat([valid, valid]) & (nid_b >= 0)

    def last_rows(nid, ok):
        idx = torch.arange(nid.shape[0], device=nid.device)
        win = torch.full((mem["mem"].shape[0],), -1, dtype=torch.long,
                         device=nid.device)
        win.scatter_reduce_(0, nid[ok], idx[ok], "amax")
        nodes = torch.nonzero(win >= 0)[:, 0]
        return nodes, win[nodes]

    nodes, rows = last_rows(nid_i, ok_i)
    mem["mail"][nodes] = mail[rows]
    nodes, rows = last_rows(nid_b, ok_b)
    mem["mem"][nodes] = last[rows]
    mem["mem_ts"][nodes] = ts[rows]


class Adam:
    """Adam (Kingma and Ba) with bias correction, eps outside the root."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, P: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g)) * self.b1 \
                + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(g)) * self.b2 \
                + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            with torch.no_grad():
                P[k] -= (self.lr / c1) * m / (v.sqrt() / math.sqrt(c2)
                                              + self.eps)


def new_memory(num_nodes: int, dim_memory: int, dim_mail: int, device):
    z = dict(device=device, dtype=torch.float32)
    return {"mem": torch.zeros(num_nodes, dim_memory, **z),
            "mem_ts": torch.zeros(num_nodes, **z),
            "mail": torch.zeros(num_nodes, dim_mail, **z)}


def batch_roots(src, dst, neg, ts, batch_size: int, device):
    """A batch as the program's steps take it: roots ``[src | dst | neg]``
    and their times, padded to ``batch_size`` edges (id -1, time 0), and
    the valid mask."""
    k = len(src)
    pad = batch_size - k
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    fill = lambda a, v, dt: torch.cat([as_t(a, dt), torch.full(
        (pad,), v, dtype=dt, device=device)])
    roots = torch.cat([fill(src, -1, torch.long), fill(dst, -1, torch.long),
                       fill(neg, -1, torch.long)])
    t1 = fill(ts, 0.0, torch.float32)
    valid = torch.arange(batch_size, device=device) < k
    return roots, torch.cat([t1, t1, t1]), valid


def train_step(model: Model, P: dict, opt: Adam, store, ef_table, mem,
               batch, drop: Optional[Draws], smp: Optional[Draws],
               eids) -> tuple:
    """One reference train step on ``batch = (roots, ts, valid)``: the
    loss before the update and every leaf's gradient; updates ``P``,
    ``opt`` and ``mem`` in place."""
    roots, ts, valid = batch
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    pos, neg, last = model.forward(leaves, store, ef_table, mem, roots, ts,
                                   True, drop, smp)
    loss = bce_loss(pos, neg, valid)
    names = [k for k in leaves]
    grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                allow_unused=True)
    grads = {k: torch.zeros_like(P[k]) if g is None else g
             for k, g in zip(names, grads)}
    opt.step(P, grads)
    if mem is not None:
        with torch.no_grad():
            write_back(mem, roots, ts, last, valid, eids, ef_table)
    return float(loss.detach()), grads


@torch.no_grad()
def eval_step(model: Model, P: dict, store, ef_table, mem, batch, eids):
    """One reference eval step: ``(pos, neg)`` logits of the valid
    edges; writes memory back."""
    roots, ts, valid = batch
    pos, neg, last = model.forward(P, store, ef_table, mem, roots, ts,
                                   False, None, None)
    if mem is not None:
        write_back(mem, roots, ts, last, valid, eids, ef_table)
    k = int(valid.sum())
    return pos[:k], neg[:k]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Sequence[str]) -> float:
    """The worst leaf's ``|prog - ref|`` over the larger of its reference
    value and the median leaf's."""
    vals = sorted(ref[k] for k in leaves)
    med = vals[len(vals) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    leaves: Sequence[str]) -> float:
    """The median over ``leaves`` of ``|prog - ref|`` over ``ref``."""
    gaps = sorted(abs(prog[k] - ref[k]) / max(ref[k], 1e-30)
                  for k in leaves)
    return gaps[len(gaps) // 2]
