#!/usr/bin/env python3
"""Smoke run of gnnflow_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. device: CUDA must be present; prints ``nvidia-smi``'s name and power
   limit of the card.
2. build: compiles every CUDA kernel of the package from ``csrc/`` with
   ``nvcc`` (one process per source, in parallel) into ``build/``.
3. kernels: each kernel against its plain PyTorch version at the shapes
   the TGN main path gives it, in f32 and bf16, with the tolerance stated;
   times the kernel, the plain version and, where one exists, a single
   PyTorch library call computing the same function.
4. slice: TGN streaming link-prediction inference (eval steps of batch
   4000) on a REDDIT-shaped synthetic stream at full width (memory, time
   and embedding dims 100, 2 heads, 172-dim edge features, fanout 10, bf16
   compute, seeded random weights); every kernel's launch count must equal
   the number of batches run.
5. slice vs itself: the same batches of a small stream on the CPU (plain
   versions) and on the card (kernels), same weights, logits and memory
   table compared in f32 and bf16.

Then one JSON line with every kernel's numbers and, last, the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 on CUDA cores


def _log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 = full f32
    torch.backends.cudnn.allow_tf32 = False
    return {"name": torch.cuda.get_device_name(0), "smi": smi}


def phase_build():
    from gnnflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
            for n, log in logs.items()}
    _log("build", seconds=round(time.perf_counter() - t0, 3),
         kernels=_build.sources(), ptxas=regs)


def _bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def phase_kernels(torch):
    """Kernel vs plain version at main-path shapes; returns JSON rows."""
    from gnnflow_tpu_torch.ops.attention_fused import (
        neighborhood_attention, neighborhood_attention_ref)
    from gnnflow_tpu_torch.ops.gru_fused import (gru_memory_fused,
                                                 gru_memory_fused_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # ---- K1: N = 12,000 roots x (1 + 10) = 132,000 memory rows ---------
    n, f, dr, dt = 132_000, 100, 372, 100
    w = dict(device=dev, generator=gen)
    ki = torch.randn(dr + dt, 3 * f, **w) * 0.05
    kh = torch.randn(f, 3 * f, **w) * 0.05
    bi, bh = torch.randn(3 * f, **w) * 0.05, torch.randn(3 * f, **w) * 0.05
    tw = (1.0 / 10 ** torch.linspace(0, 9, dt, device=dev)).float()
    tb = torch.randn(dt, **w) * 0.1
    # dts as the stream gives them: mostly small, rows never updated reach
    # ~2.7e6 on the REDDIT-shaped stream
    dts = torch.rand(n, **w) * 1e3
    dts[::7] = torch.rand(dts[::7].shape, **w) * 2.7e6
    mem32 = torch.randn(n, f, **w) * 0.5
    mail32 = torch.randn(n, dr, **w) * 0.5
    # f32: sum order only (tolerance as tests/test_gru_pallas.py);
    # bf16: a cos result one ulp apart can round tf to a neighbouring bf16
    # value (2^-8 relative), moving h by ~1e-4
    cases = {"float32": (mem32, mail32, None, 5e-5),
             "bfloat16": (mem32.bfloat16(), mail32.bfloat16(), "bfloat16",
                          2e-3)}
    k1 = {}
    for name, (mem, mail, cd, tol) in cases.items():
        cdt = torch.bfloat16 if cd else torch.float32
        # the kernels take the weights in the compute dtype, as the model
        # keeps them
        args = (mem, mail, dts, ki.to(cdt), bi, kh.to(cdt), bh, tw, tb, cd)
        got = gru_memory_fused(*args)
        torch.cuda.synchronize()
        want = gru_memory_fused_ref(*args)
        err = (got - want).abs().max().item()
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"K1 {name}: max_abs_err {err} > {tol}")
        ms = cuda_ms(torch, lambda: gru_memory_fused(*args))
        plain_ms = cuda_ms(torch, lambda: gru_memory_fused_ref(*args))
        # library yardstick: torch.gru_cell on the pre-concatenated input
        # (excludes the time encoding, which it cannot fuse)
        x = torch.cat([mail.to(cdt), torch.cos(dts[:, None] * tw + tb)
                       .to(cdt)], 1)
        hx, wi, wh = mem.to(cdt), ki.t().contiguous().to(cdt), \
            kh.t().contiguous().to(cdt)
        bic, bhc = bi.to(cdt), bh.to(cdt)
        library_ms = cuda_ms(
            torch, lambda: torch.gru_cell(x, hx, wi, wh, bic, bhc))
        nbytes = _nbytes(mem, mail, dts, got) + _nbytes(
            ki.to(cdt), kh.to(cdt), bi, bh, tw, tb)
        flops = 2.0 * n * ((dr + dt) * 3 * f + f * 3 * f)
        bound, by = _bound(nbytes, flops, name)
        k1[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound, bound_by=by)
        _log("kernels", kernel="gru_memory_fused", dtype=name,
             shape=[n, f, dr, dt], **k1[name])
    rows.append(dict(
        name="gru_memory_fused", route="cuda",
        source="gnnflow_tpu_torch/csrc/gru_fused.cu",
        replaces="gnnflow_tpu/ops/gru_pallas.py:192",
        shapes={"mem": [n, f], "mail": [n, dr], "dts": [n],
                "ki": [dr + dt, 3 * f], "kh": [f, 3 * f]},
        dtype="bfloat16", **{k: v for k, v in k1["bfloat16"].items()
                            if k != "tol"},
        library_note="torch.gru_cell on the pre-concatenated "
                     "[mail | cos(dts*tw+tb)] input; excludes the time "
                     "encoding",
        float32=k1["float32"]))

    # ---- K3: B = 12,000 roots, F = 10, H = 2, dh = 50 ------------------
    B, F, H, dh = 12_000, 10, 2, 50
    D = H * dh
    mask = torch.rand(B, F, **w) > 0.3
    mask[::97] = False                      # some rows fully masked
    k3 = {}
    # f32: sum order; bf16: the output rounds f32 sums taken in another
    # order, so it may sit one bf16 ulp (<= 2^-7 relative) from the plain
    for name, cdt, rtol, atol in (("float32", torch.float32, 1e-5, 1e-5),
                                  ("bfloat16", torch.bfloat16, 2 ** -6,
                                   1e-5)):
        q = torch.randn(B, H, dh, **w).to(cdt)
        kv = torch.randn(B, F, 2 * D, **w).to(cdt)   # fused K/V projection
        k = kv[..., :D].reshape(B, F, H, dh)
        v = kv[..., D:].reshape(B, F, H, dh)
        got = neighborhood_attention(q, k, v, mask)
        torch.cuda.synchronize()
        want = neighborhood_attention_ref(q, k, v, mask).float()
        diff = (got.float() - want).abs()
        err = diff.max().item()
        if not bool((diff <= atol + rtol * want.abs()).all()) \
                or got[::97].abs().max().item() != 0.0:
            raise AssertionError(f"K3 {name}: max_abs_err {err} beyond "
                                 f"rtol {rtol} atol {atol}, or a fully "
                                 "masked row is not 0")
        tol = {"rtol": rtol, "atol": atol}
        ms = cuda_ms(torch, lambda: neighborhood_attention(q, k, v, mask))
        plain_ms = cuda_ms(
            torch, lambda: neighborhood_attention_ref(q, k, v, mask))
        # data-dependent work: only valid slots' k and v rows are needed
        n_valid = int(mask.sum().item())
        nbytes = _nbytes(q, mask, got) + 2 * n_valid * D * q.element_size()
        flops = 4.0 * n_valid * D
        bound, by = _bound(nbytes, flops, name)
        k3[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                        library_ms=None, bound_ms=bound, bound_by=by)
        _log("kernels", kernel="neighborhood_attention", dtype=name,
             shape=[B, F, H, dh], valid_slots=n_valid, **k3[name])
    rows.append(dict(
        name="neighborhood_attention", route="cuda",
        source="gnnflow_tpu_torch/csrc/attention_fused.cu",
        replaces="gnnflow_tpu/ops/attention_pallas.py:114",
        shapes={"q": [B, H, dh], "k": [B, F, H, dh], "v": [B, F, H, dh],
                "mask": [B, F]},
        dtype="bfloat16", **{kk: vv for kk, vv in k3["bfloat16"].items()
                            if kk != "tol"},
        library_note="none: scaled_dot_product_attention has no LeakyReLU "
                     "score and not these masking semantics",
        float32=k3["float32"]))
    return rows


TGN = dict(dim_node=0, dim_time=100, dim_embed=100, num_layers=1,
           num_snapshots=1, att_head=2, dropout=0.2, att_dropout=0.2,
           use_memory=True, dim_memory=100)


def _graph(full):
    from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
    g = DynamicGraph(initial_pool_size=1 << 20, maximum_pool_size=1 << 23,
                     minimum_block_size=62)
    step = 100_000                  # ingestion batches, as bench.py
    for lo in range(0, len(full), step):
        sl = slice(lo, min(lo + step, len(full)))
        g.add_edges(full.src[sl], full.dst[sl], full.time[sl], full.eid[sl],
                    add_reverse=True)
    return g


def phase_slice(torch, kernels):
    import numpy as np
    from gnnflow_tpu_torch.data import (DstRandEdgeSampler, get_batches,
                                        make_synthetic_dataset)
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    from gnnflow_tpu_torch.utils import (average_precision_score,
                                         roc_auc_score)
    t0 = time.perf_counter()
    # REDDIT-shaped stream of bench.py:221-227
    _, _, _, full, _, ef_np = make_synthetic_dataset(
        num_src=10_000, num_dst=984, num_edges=672_447, dim_node=128,
        dim_edge=172, seed=42, time_scale=4.0)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = _graph(full)
    t_ingest = time.perf_counter() - t0
    dg = g.device_graph("cuda")
    ef = torch.from_numpy(ef_np).cuda()
    model = DGNN(dim_edge=172, compute_dtype="bfloat16", seed=0,
                 device="cuda", **TGN)
    trainer = Trainer(model, fanouts=[10], device="cuda")
    state = trainer.init_state(g.max_vertex_id() + 1)
    B, warm, runs = 4000, 3, 30
    batches = []
    for b in get_batches(full, B, DstRandEdgeSampler(full.dst, seed=1)):
        batches.append(b)
        if len(batches) == warm + runs:
            break
    for b in batches[:warm]:
        trainer.eval_step(state, dg, ef, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    pos_all, neg_all, losses = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    for b in batches[warm:]:
        _, loss, pos, neg = trainer.eval_step(state, dg, ef, b)
        pos_all.append(pos[:b.num_valid])
        neg_all.append(neg[:b.num_valid])
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t_host
    launches = {name: fn.launches for name, fn in kernels.items()}
    ms = start.elapsed_time(end) / runs
    pos = torch.cat(pos_all).float().cpu().numpy()
    neg = torch.cat(neg_all).float().cpu().numpy()
    losses = torch.stack(losses).cpu()
    mem = state.memory
    finite = bool(torch.isfinite(losses).all()
                  and torch.isfinite(mem.node_memory).all()
                  and torch.isfinite(mem.mailbox).all())
    y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    s = np.concatenate([pos, neg])
    if not finite or len(pos) != runs * B:
        raise AssertionError("slice produced non-finite values or wrong "
                             "shapes")
    for name, n in launches.items():
        if n != runs:
            raise AssertionError(f"{name} launched {n} times in {runs} "
                                 "eval batches")
    prof = _profile(torch, lambda b: trainer.eval_step(state, dg, ef, b),
                    batches[warm:warm + 5])
    result = dict(batches=runs, batch_size=B, ms_per_batch=ms,
                  host_ms_per_batch=host_s * 1e3 / runs,
                  edges_per_s=runs * B / (ms / 1e3 * runs),
                  ap=average_precision_score(y, s),
                  auc=roc_auc_score(y, s),
                  mean_loss=float(losses.mean()),
                  max_memory_allocated_mib=torch.cuda.max_memory_allocated()
                  / 2 ** 20,
                  launches=launches, data_s=t_data, ingest_s=t_ingest,
                  graph_edges=g.num_edges(), nodes=g.max_vertex_id() + 1,
                  search_iters=dg.search_iters, profile=prof)
    _log("slice", **result)
    return result


def _profile(torch, step, batches, top: int = 10):
    """Device busy time per batch and the kernels that take it, from
    ``torch.profiler`` over ``batches`` (one stream, so kernel times add
    up), with the host ops that launch the most device time and those that
    take the most host time.  The profiler slows the host, so the busy
    share is a lower bound of the unprofiled one and host times are
    inflated."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(batches)
    avgs = prof.key_averages()
    kern = [(e.key, e.self_device_time_total / 1e3 / n, e.count)
            for e in avgs
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        return "not measured: the profiler recorded no device time"
    busy = sum(t for _, t, _ in kern)
    kern.sort(key=lambda r: -r[1])
    ops = [(e.key, e.self_device_time_total / 1e3 / n,
            e.self_cpu_time_total / 1e3 / n, e.count // n)
           for e in avgs if e.device_type == DeviceType.CPU]
    by_dev = sorted(ops, key=lambda r: -r[1])[:top]
    by_host = sorted(ops, key=lambda r: -r[2])[:top]
    return dict(wall_ms_per_batch=wall * 1e3 / n,
                device_busy_ms_per_batch=busy,
                busy_share=busy / (wall * 1e3 / n),
                kernels_per_batch=sum(c for _, _, c in kern) / n,
                top=[[k[:60], t, c // n] for k, t, c in kern[:top]],
                ops_by_device_ms=[[k, d, c] for k, d, _, c in by_dev],
                ops_by_host_ms=[[k, h, c] for k, _, h, c in by_host])


def phase_self_check(torch):
    """CPU (plain versions) vs card (kernels) on the same batches."""
    from gnnflow_tpu_torch.data import (DstRandEdgeSampler, get_batches,
                                        make_synthetic_dataset)
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    _, _, _, full, _, ef_np = make_synthetic_dataset(
        num_src=400, num_dst=80, num_edges=6000, dim_edge=172, seed=7,
        time_scale=4.0)
    g = _graph(full)
    # f32: TF32 is off, so only sum order differs; bf16: a matmul output
    # one bf16 ulp apart (CPU vs cuBLAS accumulation) feeds the next
    # layers and the next batch's memory
    tols = {"float32": 1e-4, "bfloat16": 2e-2}
    out = {}
    for cd, tol in tols.items():
        res = {}
        for device in ("cpu", "cuda"):
            model = DGNN(dim_edge=172, compute_dtype=cd, seed=1,
                         device=device, **TGN)
            tr = Trainer(model, fanouts=[10], device=device)
            st = tr.init_state(g.max_vertex_id() + 1)
            dg = g.device_graph(device)
            ef = torch.from_numpy(ef_np).to(device)
            logits, mems = [], []
            neg = DstRandEdgeSampler(full.dst, seed=3)
            for i, b in enumerate(get_batches(full, 500, neg)):
                if i == 4:
                    break
                _, _, p, n = tr.eval_step(st, dg, ef, b)
                logits.append(torch.cat([p, n]).float().cpu())
                mems.append(torch.cat([st.memory.node_memory,
                                       st.memory.mailbox], 1).cpu())
            res[device] = (logits, mems, st.memory.node_memory_ts.cpu())
        err_l = max((a - b).abs().max().item()
                    for a, b in zip(res["cpu"][0], res["cuda"][0]))
        err_m = max((a - b).abs().max().item()
                    for a, b in zip(res["cpu"][1], res["cuda"][1]))
        ts_equal = bool(torch.equal(res["cpu"][2], res["cuda"][2]))
        out[cd] = dict(logits_max_abs_err=err_l, memory_max_abs_err=err_m,
                       memory_ts_equal=ts_equal, tol=tol)
        if not (err_l <= tol and err_m <= tol and ts_equal):
            raise AssertionError(f"CPU vs card ({cd}): {out[cd]}")
    _log("self_check", batches=4, batch_size=500, **out)


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import gnnflow_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = phase_device(torch)
    from gnnflow_tpu_torch.ops.attention_fused import neighborhood_attention
    from gnnflow_tpu_torch.ops.gru_fused import gru_memory_fused
    phase_build()
    rows = phase_kernels(torch)
    kernels = {"gru_memory_fused": gru_memory_fused,
               "neighborhood_attention": neighborhood_attention}
    sl = phase_slice(torch, kernels)
    for row in rows:
        row["launches"] = sl["launches"][row["name"]]
        row["launches_per_batch"] = row["launches"] / sl["batches"]
    phase_self_check(torch)
    print(json.dumps({"kernels": rows, "card": dev["smi"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
