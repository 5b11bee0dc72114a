"""Prequential online serving, as the port's online script serves its
phase 2: each chunk of the stream is scored batch by batch with
``eval_step`` on the store of the past only, then ingested
(``add_edges``, the device view's refresh); every ``retrain_interval``
chunks the edges older than the chunk's last time less ``time_window``
are evicted and the model retrains for ``epochs`` epochs on the chunk and
a ``replay_ratio`` sample of the edges still in the store, in time order.
The loop is closed: a chunk starts when the last is done.

A session is one run of the script's phase 2: ``chunks`` chunks after a
store of the stream's first part, one data set's worth.  The window
serves sessions back to back, each from a fresh store and the set-up's
weights, so every session does the same work.  Starting one (the store's
build, the weights and memory reset) is the script's set-up, which a
serving user pays once: the window pauses for it.  The store does not
reclaim the pool slots that eviction frees, and a session's pool grows
by about 15,000 slots a chunk, as a run of the script's does; one
endless stream would pass ``maximum_pool_size`` after about 520 chunks
and fail.

Set-up serves the first chunks up to a retraining, which warms up every
shape and calibrates the trainer, then starts the program anew.

The reference serves the window's first session itself, from the
benchmark's weights, zero memory and a fresh Adam, up to the first
retraining's first step: it scores each chunk, writes its memory back,
and takes that step on the same edges and negatives, replaying the
program's dropout draws.  It checks chunk 0's scores, and the step's
loss and change from the memory that ten chunks wrote back.  Past that
step two float32 runs part ways (a rounding in a time encoding's
frequency, against times near 10^6, moves its cosine), so for the
checked chunks after it the reference scores from the program's weights
and memory at the chunk's start, copied while the window is paused.  On
every checked chunk the store the program sampled is held to the edges
it was given and kept.
"""
from __future__ import annotations

import gc
import itertools
import statistics
import time
from contextlib import ExitStack

import numpy as np
import torch

from portbench import program as prog
from portbench import stream, weights
from portbench.harness import Window, p95
from portbench.reference import dgnn as ref


class Stream:
    """The stream's first part, then one session's chunks."""

    def __init__(self, first, cont):
        self.first, self.cont = first, cont

    def take(self, lo: int, hi: int):
        """Edges ``[lo, hi)``."""
        n0 = len(self.first)
        if hi <= n0:
            return self.first[lo:hi]
        if lo >= n0:
            return self.cont[lo - n0: hi - n0]
        return self.first[lo:].concat(self.cont[: hi - n0])

    def pick(self, idx: np.ndarray):
        """The edges at the sorted indices ``idx``."""
        n0 = len(self.first)
        cut = int(np.searchsorted(idx, n0))
        return self.first[idx[:cut]].concat(self.cont[idx[cut:] - n0])

    def first_at(self, t: float) -> int:
        """The first index whose time is at least ``t``."""
        n0 = len(self.first)
        if t <= self.first.time[-1]:
            return int(np.searchsorted(self.first.time, t, "left"))
        return n0 + int(np.searchsorted(self.cont.time, t, "left"))


def run(ctx):
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    st = cfg["stream"]
    s = stream.seeds(ctx.seed, 8)
    C, n0 = tr["chunk"], st["num_edges"]
    full = stream.make_edges(s[0], st["num_src"], st["num_dst"],
                             n0 + tr["chunks"] * C, st["time_scale"])
    ef = stream.edge_features(s[1], full.dst, st["num_src"], st["num_dst"],
                              st["dim_edge"], dev)
    vs = Stream(full[:n0], full[n0:])
    window_t = float(full.time[n0 - 1] - full.time[0])
    num_nodes = st["num_src"] + st["num_dst"]
    ctx.mark("inputs")
    w0 = weights.make(prog.param_shapes(cfg, st["dim_edge"]), s[2], dev)
    bs = min(cfg["batch_size"], max(256, C))
    from gnnflow_tpu_torch.data import get_batches

    def serve(p, neg, rng, k, kept, win, rec=None, trained=None):
        """Chunk ``k``: score, ingest and, on the interval, evict and
        retrain; returns the new first kept index, the chunk's times and
        the negatives its scoring drew.  ``rec`` records what the
        reference needs: the kept edges and the negatives, on the
        checked chunks the view and the scores, and of the first
        retraining its edges, negatives, first loss and weights after
        its first step."""
        e = vs.take(n0 + k * C, n0 + (k + 1) * C)
        neg.log = []
        t0 = time.perf_counter()
        dg = p.view(dev)
        with win.span("score"):
            scores = []
            for batch in get_batches(e, bs, neg):
                _, _, pos, negs = p.trainer.eval_step(p.state, dg, ef, batch)
                n = batch.num_valid
                scores.append((pos[:n].cpu().numpy(),
                               negs[:n].cpu().numpy()))
        drawn, neg.log = neg.log, None
        t1 = time.perf_counter()
        with win.span("ingest"):
            p.dgraph.add_edges(e.src, e.dst, e.time, e.eid,
                               add_reverse=cfg["data"]["undirected"])
            neg.add_dst_list(e.dst)
            p.view(dev)
            win.sync()
        t2 = time.perf_counter()
        if rec is not None:
            rec["chunks"][k] = {"kept": kept, "negs": drawn}
            if k in rec["checked"]:
                rec["chunks"][k].update(view=dg, scores=scores)
        times = {"chunk": t2 - t0, "score": t1 - t0, "ingest": t2 - t1}
        if (k + 1) % tr["retrain_interval"]:
            return kept, times, drawn
        end = n0 + (k + 1) * C
        with win.span("evict"):
            thr = float(e.time[-1]) - window_t
            p.dgraph.offload_old_blocks(thr)
            dg = p.view(dev)
            kept = vs.first_at(thr)
        with win.span("retrain"):
            n_replay = int(C * tr["replay_ratio"])
            pool = end - C - kept
            idx = np.sort(rng.choice(pool, size=min(n_replay, pool),
                                     replace=False)) + kept
            data = vs.pick(idx).concat(e)
            data = data[np.argsort(data.time, kind="stable")]
            first = rec is not None and "after" not in rec
            neg.log = [] if first else None
            for _ in range(tr["epochs"]):
                for batch in get_batches(data, bs, neg):
                    _, loss, _, _ = p.trainer.train_step(p.state, dg, ef,
                                                         batch)
                    if trained is not None:
                        trained.append((batch.target_nodes, batch.ts,
                                        batch.num_valid, kept, end))
                    if first and "after" not in rec:
                        with win.paused():
                            rec.update(loss=loss, after=p.params())
            if first:
                rec["retrain"] = {"kept": kept, "end": end, "data": data,
                                  "negs": neg.log}
            neg.log = None
        return kept, times, drawn

    # set-up: serve the first chunks up to a retraining, which warms up
    # every shape and calibrates the trainer, then start the program anew
    p = prog.build(cfg, vs.first, num_nodes, st["dim_edge"], w0, s[3:5],
                   dev, ctx.compute_dtype, ctx.mark)
    ctx.mark("program")
    warm, kept = Window(False, dev), 0
    neg = stream.Negatives(vs.first.dst, s[5])
    rng = np.random.default_rng(s[6])
    for k in range(tr["retrain_interval"]):
        kept, _, _ = serve(p, neg, rng, k, kept, warm)
    ctx.mark("warm-up")
    p.restart(cfg, vs.first, w0, s[3:5], dev)
    gc.collect()
    neg = stream.Negatives(vs.first.dst, s[5])
    rng = np.random.default_rng(s[6])
    extra = int(np.random.RandomState(s[7]).randint(*tr["check_drawn"]))
    checked = set(tr["check_chunks"] + [extra])
    rec = {"checked": checked, "chunks": {}, "draws": {}, "state": {},
           "followed": {c for c in checked
                                    if c >= tr["retrain_interval"]}}
    last = max(checked)
    ctx.setup_done()

    win = Window(ctx.trace, dev)
    kept, k, spans = 0, 0, {"chunk": [], "score": [], "ingest": []}
    chunks, trained = [], []
    recording = ExitStack()
    recording.enter_context(prog.recorded_draws(p.state, rec["draws"]))
    win.start()
    while True:
        j = k % tr["chunks"]
        if k and not j:                 # the next session
            with win.paused():
                p.restart(cfg, vs.first, w0, s[3:5], dev)
                neg.dst_list = np.unique(vs.first.dst)
                kept = 0
        before = kept
        if k in rec["followed"]:
            with win.paused():
                rec["state"][k] = (p.params(), p.memory())
        kept, times, drawn = serve(p, neg, rng, j, kept, win,
                                   rec if k <= last else None,
                                   trained if ctx.trace else None)
        if k == tr["retrain_interval"] - 1:
            recording.close()
        for name in spans:
            spans[name].append(times[name] * 1e3)
        if ctx.trace:
            chunks.append((j, before, drawn))
        k += 1
        # the window closes on time, but never before the checked chunks
        if win.elapsed() >= ctx.window_seconds and k > last:
            break
    seconds = win.stop()
    recording.close()
    trace = win.trace() if ctx.trace else None
    ctx.read_memory_peak()
    rec["loss"] = float(rec["loss"])
    del p
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()
    lat = spans["chunk"]
    print(f"sessions started in the window: {(k - 1) // tr['chunks']}; "
          f"paused for them and the reference's copies: {win.paused_s!r} s",
          flush=True)
    print(f"chunks {len(lat)}: chunk ms median {statistics.median(lat)!r}"
          f" p95 {p95(lat)!r}; each: {[round(x, 2) for x in lat]}",
          flush=True)
    if trace is not None:
        trace.steps = k
        trace.span_ms = spans
        trace.work = count(ctx, cfg, vs, n0, C, chunks, trained, bs, dev)
    checks = compare(ctx, cfg, tr, vs, ef, w0, rec, n0, C, bs, num_nodes, s)
    return dict(metrics={"serve_edges_per_s": k * C / seconds,
                         "serve_chunk_ms_p95": p95(lat)},
                trace=trace, checks=checks, attempted=k, failed=0)


def _batches(e, bs, negs, dev):
    """The reference's batches of ``e``, each with the negatives the
    program drew for it, next from the iterator ``negs``."""
    for lo in range(0, len(e), bs):
        b = e[lo: lo + bs]
        eids = torch.as_tensor(np.concatenate(
            [b.eid, np.zeros(bs - len(b), np.int64)]), device=dev)
        yield ref.batch_roots(b.src, b.dst, next(negs), b.time, bs,
                              dev), eids


def _store(vs, lo, hi, dev):
    return ref.Store(*vs.take(lo, hi).astuple(), dev)


def count(ctx, cfg, vs, n0, C, chunks, trained, bs, dev) -> dict:
    """The work of the traced window: each chunk's scoring and each
    retraining step, on the store each ran against."""
    work = {}

    def add(w):
        for key, v in w.items():
            work[key] = v if key == "peak_flops" else work.get(key, 0) + v

    for roots, ts, n, kept, end in trained:
        add(ctx.counts.work(cfg, _store(vs, kept, end, dev),
                            [(roots, ts, n)], True, dev))
    for k, kept, negs in chunks:
        e = vs.take(n0 + k * C, n0 + (k + 1) * C)
        store = _store(vs, kept, n0 + k * C, dev)
        batches = []
        for i, lo in enumerate(range(0, len(e), bs)):
            b = e[lo: lo + bs]
            pad = lambda a: np.concatenate([a, np.full(bs - len(b), -1,
                                                       a.dtype)])
            batches.append((np.concatenate([pad(b.src), pad(b.dst),
                                            pad(negs[i])]),
                            np.tile(pad(b.time), 3), len(b)))
        add(ctx.counts.work(cfg, store, batches, False, dev, seed=k))
    return work


def compare(ctx, cfg, tr, vs, ef, w0, rec, n0, C, bs, num_nodes, s) -> dict:
    """The reference serves the first session from its own state up to
    the first retraining's first step, then scores the later checked
    chunks from the program's state; each is held to the program's
    outputs."""
    dev = ctx.device
    ref.no_tf32()
    model = ref.Model(cfg)
    P = {k: v.clone() for k, v in w0.items()}
    mem = ref.new_memory(num_nodes, cfg["dim_memory"],
                         2 * cfg["dim_memory"] + ef.shape[1], dev)
    out, gaps, mismatch = {}, {}, 0
    k1 = tr["retrain_interval"] - 1
    for k in range(k1 + 1):
        gaps[k] = _chunk(model, P, mem, vs, ef, rec["chunks"][k], n0, C, k,
                         bs, dev)
    rt = rec["retrain"]
    store = _store(vs, rt["kept"], rt["end"], dev)
    (batch, eids), = itertools.islice(_batches(rt["data"], bs,
                                               iter(rt["negs"]), dev), 1)
    drop = ref.Draws(s[3], dev, rec["draws"].get("dropout", []))
    loss, grads = ref.train_step(model, P, ref.Adam(cfg["lr"]), store, ef,
                                 mem, batch, drop, None, eids)
    out.update(_first_step(rec, w0, P, loss, grads))
    for k in sorted(rec["followed"]):
        params, memory = rec["state"][k]
        gaps[k] = _chunk(model, params, memory, vs, ef, rec["chunks"][k], n0,
                         C, k, bs, dev)
    for k in rec["checked"]:
        store = _store(vs, rec["chunks"][k]["kept"], n0 + k * C, dev)
        got = prog.view_edges(rec["chunks"][k]["view"])
        want = (store.src, store.dst, store.ts, store.eid)
        mismatch += sum(int((a != b).sum()) if a.shape == b.shape
                        else max(len(a), len(b)) for a, b in zip(got, want))
    out["score_gap"] = max(gaps[k] for k in rec["checked"] if k <= k1)
    out["score_gap.later"] = max(gaps[k] for k in rec["followed"])
    out["store_mismatch"] = float(mismatch)
    return out


def _chunk(model, P, mem, vs, ef, ch, n0, C, k, bs, dev) -> float:
    """The reference scores chunk ``k`` on the store of its kept edges
    and writes ``mem`` back; the largest gap of the program's scores,
    where they were kept, over the reference's RMS score (else 0)."""
    lo = n0 + k * C
    store = _store(vs, ch["kept"], lo, dev)
    scores = iter(ch.get("scores", []))
    gap = 0.0
    for batch, eids in _batches(vs.take(lo, lo + C), bs, iter(ch["negs"]),
                                dev):
        pos, neg = ref.eval_step(model, P, store, ef, mem, batch, eids)
        if "scores" not in ch:
            continue
        want = torch.cat([pos, neg])
        have = torch.as_tensor(np.concatenate(next(scores)), device=dev)
        rms = float(want.double().pow(2).mean().sqrt())
        gap = max(gap, float((have - want).abs().max()) / max(rms, 1e-6))
    return gap


def _first_step(rec, w0, P, loss, grads) -> dict:
    """The first retraining step: its loss, and each leaf's change from
    the benchmark's weights, program against reference."""
    norm = lambda d: {kk: float(v.double().norm()) for kk, v in d.items()}
    g = norm(grads)
    med = sorted(g.values())[len(g) // 2]
    moved = [kk for kk in g if g[kk] >= 1e-3 * med]
    got = norm({kk: rec["after"][kk] - w0[kk] for kk in P})
    want = norm({kk: P[kk] - w0[kk] for kk in P})
    return {"retrain_loss_gap": abs(rec["loss"] - loss) / abs(loss),
            "retrain_change_gap": ref.leaf_gap(got, want, moved),
            "retrain_change_gap.median": ref.median_leaf_gap(got, want,
                                                             moved)}
