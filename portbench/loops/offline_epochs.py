"""Offline training over epochs of a stream's training split, as the
port's offline script trains: chronological batches with a random epoch
start, one negative destination per edge, memory reset at the start of
every epoch after the first, no validation inside the window.

Set-up builds the store over the whole stream, the model with the
benchmark's weights and the trainer, then runs the first ``check_steps``
train steps, which also warm up every shape and build every kernel.  The
window trains on from there.  After the window the reference follows the
check steps from the same inputs and the numbers are compared.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import program as prog
from portbench import stream, weights
from portbench.harness import Window
from portbench.reference import dgnn as ref


def _norms(d):
    return {k: float(v.double().norm()) for k, v in d.items()}


def run(ctx):
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    st = cfg["stream"]
    s = stream.seeds(ctx.seed, 7)
    edges = stream.make_edges(s[0], st["num_src"], st["num_dst"],
                              st["num_edges"], st["time_scale"])
    ef = stream.edge_features(s[1], edges.dst, st["num_src"], st["num_dst"],
                              st["dim_edge"], dev)
    train = edges[: int(len(edges) * st["train_frac"])]
    num_nodes = st["num_src"] + st["num_dst"]
    ctx.mark("inputs")
    w0 = weights.make(prog.param_shapes(cfg, st["dim_edge"]), s[2], dev)
    p = prog.build(cfg, edges, num_nodes, st["dim_edge"], w0, s[3:5], dev,
                   ctx.compute_dtype, ctx.mark)
    dg = p.view(dev)
    ctx.mark("program")
    bs = cfg["batch_size"]
    neg = stream.Negatives(train.dst, s[5])
    epoch_rng = np.random.RandomState(s[6])
    from gnnflow_tpu_torch.data import get_batches

    def epoch():
        start = epoch_rng.randint(0, tr["epoch_starts"]) \
            * (bs // tr["epoch_starts"])
        return start, get_batches(train[start:], bs, neg)

    # the check steps: the first steps of the first epoch
    start0, batches = epoch()
    neg.log, draws, losses = [], {}, []
    with prog.recorded_draws(p.state, draws):
        for i in range(tr["check_steps"]):
            batch = next(batches)
            _, loss, _, _ = p.trainer.train_step(p.state, dg, ef, batch)
            losses.append(float(loss))
            if i == 0:
                g_prog = _norms(p.first_grads())
                print("calibration:", p.trainer.calibration, flush=True)
    checked = {"losses": losses, "grads": g_prog, "negs": neg.log,
               "draws": draws,
               "change": _norms({k: v - w0[k]
                                 for k, v in p.params().items()})}
    neg.log = None
    ctx.setup_done()

    win = Window(ctx.trace, dev)
    steps, edges_done, recorded, per_second = 0, 0, [], []
    win.start()
    limit = ctx.window_seconds
    while True:
        with win.span("next_batch"):
            batch = next(batches, None)
        if batch is None:
            with win.span("epoch_start"):
                p.reset_memory()
                _, batches = epoch()
            continue
        with win.span("train_step"):
            p.trainer.train_step(p.state, dg, ef, batch)
        steps += 1
        edges_done += batch.num_valid
        per_second.append(time.perf_counter() - win.t0)
        if ctx.trace:
            recorded.append((batch.target_nodes, batch.ts, batch.num_valid))
        if time.perf_counter() - win.t0 >= limit:
            break
    seconds = win.stop()
    print("steps in each second of the window:",
          np.bincount(np.asarray(per_second, int)).tolist(), flush=True)
    trace = win.trace() if ctx.trace else None
    ctx.read_memory_peak()
    del p, dg, batches
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()

    store = ref.Store(*edges.astuple(), dev)
    if trace is not None:
        trace.steps = steps
        trace.work = ctx.counts.work(cfg, store, recorded, True, dev)
    checks = compare(ctx, cfg, tr, store, ef, train, start0, bs, w0, s,
                     checked, num_nodes)
    return dict(metrics={"train_edges_per_s": edges_done / seconds},
                trace=trace, checks=checks, attempted=steps, failed=0)


def compare(ctx, cfg, tr, store, ef, train, start0, bs, w0, s, checked,
            num_nodes):
    """The reference's check steps against the program's: each step's
    loss, the first step's gradients and the parameters' change after the
    last, by leaf."""
    dev = ctx.device
    ref.no_tf32()
    model = ref.Model(cfg)
    P = {k: v.clone() for k, v in w0.items()}
    opt = ref.Adam(cfg["lr"])
    mem = ref.new_memory(num_nodes, cfg["dim_memory"],
                         2 * cfg["dim_memory"] + ef.shape[1], dev) \
        if cfg.get("use_memory") else None
    drop = ref.Draws(s[3], dev, checked["draws"].get("dropout", []))
    smp = ref.Draws(s[4], dev, checked["draws"].get("sample", []))
    losses = []
    for i in range(tr["check_steps"]):
        e = train[start0 + i * bs: start0 + (i + 1) * bs]
        batch = ref.batch_roots(e.src, e.dst, checked["negs"][i], e.time,
                                bs, dev)
        eids = torch.as_tensor(
            np.concatenate([e.eid, np.zeros(bs - len(e), np.int64)]),
            device=dev)
        loss, grads = ref.train_step(model, P, opt, store, ef, mem, batch,
                                     drop, smp, eids)
        losses.append(loss)
        if i == 0:
            g_ref = _norms(grads)
    change_ref = _norms({k: P[k] - w0[k] for k in P})
    med = sorted(g_ref.values())[len(g_ref) // 2]
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    gaps = [abs(a - b) / abs(b) for a, b in zip(checked["losses"], losses)]
    return {
        "loss_gap": max(gaps),
        "loss_gap.first": gaps[0],
        "grad_gap": ref.leaf_gap(checked["grads"], g_ref, list(g_ref)),
        "grad_gap.median": ref.median_leaf_gap(checked["grads"], g_ref,
                                               moved),
        "change_gap": ref.leaf_gap(checked["change"], change_ref, moved),
        "change_gap.median": ref.median_leaf_gap(checked["change"],
                                                 change_ref, moved),
    }
