#!/usr/bin/env python3
"""Smoke run of gnnflow_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. device: CUDA must be present; prints ``nvidia-smi``'s name and power
   limit of the card.
2. build: compiles every CUDA kernel of the package from ``csrc/`` with
   ``nvcc`` (one process per source, in parallel) into ``build/``; prints
   each kernel's registers and spills, and the count of tensor-core
   instructions in the SASS of each GRU kernel (``cuobjdump``), which
   must not be 0 for the bf16 forward, row-tile and product kernels.
3. kernels: each kernel against its plain PyTorch version at the shapes
   the TGN main paths give it, in f32 and bf16, with the tolerance stated;
   times the kernel, the plain version and, where one exists, a single
   PyTorch library call computing the same function (for K1 and K2 also
   at the dedup cap).  The GRU backward (K2) and the sorted segment sum
   (K4, segment ids from a real dedup of a stream batch) must also give
   identical bits in two launches.
4. slice: TGN streaming link-prediction inference (eval steps of batch
   4000) on a REDDIT-shaped synthetic stream at full width (memory, time
   and embedding dims 100, 2 heads, 172-dim edge features, fanout 10, bf16
   compute, seeded random weights); K1 and K3 launch once per batch.
5. train: TGN training (train steps of batch 4000, dropout 0.2, attention
   dropout 0.2, Adam at lr 1e-4) on the stream's train split at the same
   width, with the default trainer, which calibrates the memory dedup on
   its first step; K1 and K2 launch once per step and K3 never (training
   with attention dropout routes around it).  Then a few steps at
   attention dropout 0, where K3 and its backward run once per step.
6. dedup: the same training with the exact (nid, ts) memory dedup at
   factor 0.35 (benchmarks/benchmark_dedup_step.py:68-75): K4 launches
   once per step whose unique pairs fit the cap, K1 and K2 once per step;
   then steps at factor 0.001, which fall back to the per-instance path
   (K4 never), and dedup eval batches (K1 once per batch, K4 never).
7. entry: two epochs of the port's offline training script
   (``gnnflow_tpu_torch.scripts.offline_edge_prediction``) on its
   synthetic stream, with validation and test AP.
8. slice vs itself: the same batches of a small stream on the CPU (plain
   versions) and on the card (kernels), same weights: eval logits and
   memory, then train steps at dropout 0 (losses, gradients, parameters
   and memory after each step), in f32 and bf16.  In bf16 the card takes
   the CPU's state before each step, so every step is held from one
   state; a free-running card run and a CPU run started from the card's
   first step are reported beside it.  In f32 the dedup's train steps run
   on both sides too, and the card's dedup run is held against its
   per-instance run.

Then one JSON line with every kernel's numbers and, last, the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
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


COLD_BYTES = 100e6   # data touched between two launches on one input set


def cuda_ms_cold(torch, fns, iters: int = 24) -> float:
    """Mean device time of one call with the 50 MB L2 cold: ``fns`` are
    calls on independent input sets, together over ``COLD_BYTES``, called
    in turn back to back, so that a set's data has left L2 by its next
    call; CUDA events over ``iters`` calls after one round of warm-up."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fns, iters: int = 24) -> float:
    """Mean device time of one call: the summed device time of every
    kernel the calls launch (``torch.profiler``), over ``iters`` calls
    rotating over ``fns`` after one round of warm-up; the median of three
    profiling sessions, since a session has now and then come back empty
    or short of records.  Where the host takes longer to prepare a call
    than the device to run it, CUDA events around back-to-back calls time
    the host; this does not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    totals = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        totals.append(sum(e.self_device_time_total
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA))
    total = statistics.median(totals)
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total / 1e3 / iters


TIMING_NOTE = ("ms, plain_ms and library_ms: device time from the profiler "
               "with the L2 cold (input sets rotated over 100 MB); ms_warm: "
               "the same on one set; ms_events: CUDA events around the cold "
               "calls, which include the host's time to prepare each call")


def _sets_for(nbytes: float) -> int:
    """Input sets to rotate so that the data between two calls on one set
    exceeds ``COLD_BYTES``."""
    return 1 + max(1, -(-int(COLD_BYTES) // int(nbytes)))


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


# the GRU kernels whose bf16 products must run on tensor cores, by a part
# of their mangled names: K1's forward, K2's row-tile pass and products
TENSOR_CORE_KERNELS = ("2tc10fwd_kernel", "2tc15bwd_rows_kernel",
                       "2tc14product_kernel")


def _tensor_core_counts(lib_path: str):
    """Count of tensor-core instructions (HMMA, HGMMA) in the SASS of each
    function of a built library, from ``cuobjdump --dump-sass``."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", lib_path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in ln or "HGMMA" in ln):
            counts[fn] += 1
    return counts


def phase_build():
    from gnnflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
            for n, log in logs.items()}
    hmma = _tensor_core_counts(_build.lib_path("gru_fused"))
    missing = [k for k in TENSOR_CORE_KERNELS
               if not any(k in fn and c > 0 for fn, c in hmma.items())]
    _log("build", seconds=round(seconds, 3), kernels=_build.sources(),
         ptxas=regs, gru_fused_tensor_core_instructions=hmma)
    if missing:
        raise AssertionError(f"no tensor-core instructions in {missing}")


def _bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def phase_kernels(torch, stream):
    """Kernel vs plain version at main-path shapes; returns JSON rows."""
    from gnnflow_tpu_torch.ops.gru_fused import (
        gru_memory_fused, gru_memory_fused_bwd, gru_memory_fused_bwd_ref,
        gru_memory_fused_ref)
    from gnnflow_tpu_torch.ops.sampling import sample_hops
    from gnnflow_tpu_torch.train import dedup_cap
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
        library_ms = _gru_library_ms(torch, mem, mail, dts, ki, kh, bi, bh,
                                     tw, tb, cdt)
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

    # ---- K2: the backward of K1 at the same shapes, dh [N, F] f32 --------
    dh = torch.randn(n, f, **w)
    # per gradient, max abs error over max abs value.  f32: sum order over
    # 132,000 rows; bf16: both round da and tf to bf16, but a value that the
    # recompute's sum order moves across a rounding boundary rounds to the
    # neighbouring bf16 value (2^-8 relative) inside sums over all rows
    k2_tol = {"float32": 1e-4, "bfloat16": 1e-3}
    names = ("dki", "dbi", "dkh", "dbh", "dtw", "dtb")
    k2 = {}
    for name, (mem, mail, cd, _) in cases.items():
        cdt = torch.bfloat16 if cd else torch.float32
        args = (mem, mail, dts, ki.to(cdt), bi, kh.to(cdt), bh, tw, tb, dh,
                cd)
        got = gru_memory_fused_bwd(*args)
        again = gru_memory_fused_bwd(*args)
        torch.cuda.synchronize()
        want = gru_memory_fused_bwd_ref(*args)
        rel = {nm: _rel(g, w_) for nm, g, w_ in zip(names, got, want)}
        err = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
        identical = all(torch.equal(g, a) for g, a in zip(got, again))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if not (max(rel.values()) <= k2_tol[name] and identical and finite):
            raise AssertionError(f"K2 {name}: relative errors {rel} (tol "
                                 f"{k2_tol[name]}), bit-identical reruns "
                                 f"{identical}, finite {finite}")
        ms = cuda_ms(torch, lambda: gru_memory_fused_bwd(*args))
        plain_ms = cuda_ms(torch, lambda: gru_memory_fused_bwd_ref(*args))
        library_ms = _gru_library_ms(torch, mem, mail, dts, ki, kh, bi, bh,
                                     tw, tb, cdt, dh)
        nbytes = _nbytes(mem, mail, dts, dh, *got) + _nbytes(
            ki.to(cdt), kh.to(cdt), bi, bh, tw, tb)
        k_in = dr + dt
        flops = 2.0 * n * ((k_in + f) * 3 * f        # recompute the gates
                           + (k_in + f) * 3 * f      # dKi and dKh
                           + 3 * f * dt)             # dtf
        bound, by = _bound(nbytes, flops, name)
        # device time of each of K2's launches
        prof = _profile(torch, lambda _: gru_memory_fused_bwd(*args),
                        range(5), top=6)
        k2[name] = dict(max_abs_err=err, rel_err=rel, tol=k2_tol[name],
                        bit_identical_reruns=identical, ms=ms,
                        plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound, bound_by=by,
                        passes_ms=prof if isinstance(prof, str)
                        else prof["top"])
        _log("kernels", kernel="gru_memory_fused_bwd", dtype=name,
             shape=[n, f, dr, dt], **k2[name])
    rows.append(dict(
        name="gru_memory_fused_bwd", route="cuda",
        source="gnnflow_tpu_torch/csrc/gru_fused.cu",
        replaces="gnnflow_tpu/ops/gru_pallas.py:210",
        shapes={"mem": [n, f], "mail": [n, dr], "dts": [n], "dh": [n, f],
                "ki": [dr + dt, 3 * f], "kh": [f, 3 * f]},
        dtype="bfloat16", **{k: v for k, v in k2["bfloat16"].items()
                            if k != "tol"},
        library_note="autograd backward of torch.gru_cell on the "
                     "pre-concatenated [mail | cos(dts*tw+tb)] input with "
                     "respect to its weights and biases; excludes the time "
                     "encoding",
        float32=k2["float32"]))

    # ---- K1 and K2 on the dedup path: N = cap (factor 0.35), f32 memory
    # and mails (the compact pull is f32) under bf16 compute, held to the
    # bf16 tolerances above -----------------------------------------------
    cap = dedup_cap(0.35, n)
    args = (mem32[:cap], mail32[:cap], dts[:cap], ki.bfloat16(), bi,
            kh.bfloat16(), bh, tw, tb)
    at_cap = {}
    for row, fn, ref, extra, flops in (
            (rows[0], gru_memory_fused, gru_memory_fused_ref, (),
             2.0 * cap * ((dr + dt) * 3 * f + f * 3 * f)),
            (rows[1], gru_memory_fused_bwd, gru_memory_fused_bwd_ref,
             (dh[:cap],),
             2.0 * cap * (2 * (dr + dt + f) * 3 * f + 3 * f * dt))):
        a = args + extra + ("bfloat16",)
        bwd = fn is gru_memory_fused_bwd
        outs, again = fn(*a), fn(*a)
        torch.cuda.synchronize()
        want = ref(*a)
        if bwd:
            rel = {nm: _rel(g, w_) for nm, g, w_ in zip(names, outs, want)}
            err = max((g - w_).abs().max().item()
                      for g, w_ in zip(outs, want))
            identical = all(torch.equal(g, a_) for g, a_ in zip(outs, again))
            finite = all(bool(torch.isfinite(g).all()) for g in outs)
            tol = k2_tol["bfloat16"]
            ok = max(rel.values()) <= tol and identical and finite
            checks = dict(rel_err=rel, bit_identical_reruns=identical)
        else:
            err = (outs - want).abs().max().item()
            tol = k1["bfloat16"]["tol"]
            ok = err <= tol and bool(torch.isfinite(outs).all())
            checks = {}
        if not ok:
            raise AssertionError(f"{row['name']} at the dedup cap: max abs "
                                 f"error {err}, {checks} (tol {tol})")
        nbytes = _nbytes(*args, *extra, *(outs if bwd else (outs,)))
        bound, by = _bound(nbytes, flops, "bfloat16")
        row["dedup_cap"] = dict(
            n=cap, operands="f32 memory and mails, bf16 compute",
            max_abs_err=err, **checks, tol=tol,
            ms=cuda_ms(torch, lambda: fn(*a)),
            plain_ms=cuda_ms(torch, lambda: ref(*a)),
            library_ms=_gru_library_ms(torch, *args[:3], ki, kh, bi, bh, tw,
                                       tb, torch.bfloat16, *extra),
            bound_ms=bound, bound_by=by)
        at_cap[row["name"]] = row["dedup_cap"]
        del outs, again, want
    _log("kernels", kernel="gru at the dedup cap", **at_cap)

    # ---- K3: B = 12,000 roots, F = 10, H = 2, dh = 50 ------------------
    B, F, H, dh = 12_000, 10, 2, 50
    mask = torch.rand(B, F, **w) > 0.3
    mask[::97] = False                      # some rows fully masked
    k3 = {}
    # f32: sum order; bf16: the output rounds f32 sums taken in another
    # order, so it may sit one bf16 ulp (<= 2^-7 relative) from the plain
    for name, cdt, rtol, atol in (("float32", torch.float32, 1e-5, 1e-5),
                                  ("bfloat16", torch.bfloat16, 2 ** -6,
                                   1e-5)):
        k3[name] = _kernel_k3(torch, w, mask, cdt, rtol, atol)
        _log("kernels", kernel="neighborhood_attention", dtype=name,
             shape=[B, F, H, dh], **k3[name])
    # the mask of a real sampled eval batch (mid-way through phase 4's
    # timed batches) on the same widths, bf16
    full = stream["full"]
    b = _take(full, 4000, full.dst, 19)[-1]
    real_mask = sample_hops(
        stream["dg"], torch.from_numpy(b.target_nodes).cuda(),
        torch.from_numpy(b.ts).cuda(), fanout=F)[0][0].nbr_mask.contiguous()
    real = _kernel_k3(torch, w, real_mask, torch.bfloat16, 2 ** -6, 1e-5)
    real["batch"] = 18
    _log("kernels", kernel="neighborhood_attention", dtype="bfloat16",
         mask="eval batch 18", shape=list(real_mask.shape) + [H, dh], **real)
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
        timing_note=TIMING_NOTE,
        float32=k3["float32"], real_eval_mask=real))
    rows.append(_kernel_k4(torch, stream, w))
    return rows


def _kernel_k3(torch, w, mask, cdt, rtol, atol):
    """K3 against its plain version on ``mask`` [B, 10] with q [B, 2, 50]
    and k, v column slices of one fused kv [B, 10, 200] in ``cdt`` (as
    the layer has them), fully masked rows exactly 0 and two launches
    bit-identical; times with the L2 cold and warm."""
    from gnnflow_tpu_torch.ops import attention_fused
    from gnnflow_tpu_torch.ops.attention_fused import (
        neighborhood_attention, neighborhood_attention_ref)
    (B, F), H, dh = mask.shape, 2, 50
    D = H * dh

    def operands():
        q = torch.randn(B, H, dh, **w).to(cdt)
        kv = torch.randn(B, F, 2 * D, **w).to(cdt)   # fused K/V projection
        return (q, kv[..., :D].reshape(B, F, H, dh),
                kv[..., D:].reshape(B, F, H, dh), mask)

    args = operands()
    got = neighborhood_attention(*args)
    again = neighborhood_attention(*args)
    torch.cuda.synchronize()
    want = neighborhood_attention_ref(*args).float()
    diff = (got.float() - want).abs()
    err = diff.max().item()
    empty = ~mask.any(1)
    identical = bool(torch.equal(got, again))
    if not bool((diff <= atol + rtol * want.abs()).all()) \
            or got[empty].any() or not identical:
        raise AssertionError(f"K3 {cdt}: max_abs_err {err} beyond rtol "
                             f"{rtol} atol {atol}, a fully masked row is "
                             f"not 0, or reruns differ ({identical})")
    # data-dependent work: only valid slots' k and v rows are needed
    n_valid = int(mask.sum().item())
    es = got.element_size()
    nbytes = _nbytes(args[0], mask, got) + 2 * n_valid * D * es
    bound, by = _bound(nbytes, 4.0 * n_valid * D, str(cdt)[6:])
    sets = [args] + [operands() for _ in range(_sets_for(nbytes) - 1)]
    kernel = [lambda a=a: neighborhood_attention(*a) for a in sets]
    plain = [lambda a=a: neighborhood_attention_ref(*a) for a in sets]
    return dict(
        max_abs_err=err, tol={"rtol": rtol, "atol": atol},
        bit_identical_reruns=identical,
        ms=device_ms(torch, kernel), ms_warm=device_ms(torch, kernel[:1]),
        ms_events=cuda_ms_cold(torch, kernel),
        plain_ms=device_ms(torch, plain), library_ms=None, bound_ms=bound, bound_by=by,
        valid_fraction=n_valid / (B * F), input_sets=len(sets),
        # path and grid (the kernels of a parent tree timed in turn may
        # predate the plan)
        plan=(attention_fused.plan(*args[:3], got)
              if hasattr(attention_fused, "plan") else None))


def _gru_library_ms(torch, mem, mail, dts, ki, kh, bi, bh, tw, tb, cdt,
                    dh=None):
    """The library yardstick of K1 (``dh`` None) or K2: ``torch.gru_cell``
    in ``cdt`` on the pre-concatenated ``[mail | cos(dts*tw+tb)]`` input,
    or the autograd backward of that call with respect to its weights and
    biases.  Both exclude the time encoding, which they cannot fuse."""
    x = torch.cat([mail.to(cdt), torch.cos(dts[:, None] * tw + tb).to(cdt)],
                  1)
    hx = mem.to(cdt)
    ws = [ki.t().contiguous().to(cdt), kh.t().contiguous().to(cdt),
          bi.to(cdt), bh.to(cdt)]
    if dh is None:
        return cuda_ms(torch, lambda: torch.gru_cell(x, hx, *ws))
    ws = [w_.requires_grad_() for w_ in ws]
    out = torch.gru_cell(x, hx, *ws)
    dhc = dh.to(out.dtype)
    return cuda_ms(torch, lambda: torch.autograd.grad(out, ws, dhc,
                                                      retain_graph=True))


def _kernel_k4(torch, stream, w):
    """K4 at the dedup path's shapes: segment ids from a real dedup of the
    first train batch (12,000 roots x 11 = 132,000 instances), cap of
    factor 0.35, D = 100 (the memory width; no lane pad on the card)."""
    from gnnflow_tpu_torch.ops.dedup import dedup_instances
    from gnnflow_tpu_torch.ops.sampling import sample_hops
    from gnnflow_tpu_torch.ops.segment_sum import (sorted_segment_sum,
                                                   sorted_segment_sum_ref)
    from gnnflow_tpu_torch.train import dedup_cap
    train = stream["train"]
    b = _take(train, 4000, train.dst, 1)[0]
    m = sample_hops(stream["dg"], torch.from_numpy(b.target_nodes).cuda(),
                    torch.from_numpy(b.ts).cuda(), fanout=10)[0][0]
    L, D = m.num_all, 100
    cap = dedup_cap(0.35, L)
    _, _, _, n_uniq, _, seg = dedup_instances(m.all_nodes(), m.all_ts(),
                                              m.all_mask(), cap)
    n_uniq = int(n_uniq)
    dhs = torch.randn(L, D, **w)
    got = sorted_segment_sum(dhs, seg, cap)
    again = sorted_segment_sum(dhs, seg, cap)
    torch.cuda.synchronize()
    # the plain version in f64: its atomics' order no longer shows, so the
    # error is the kernel's own f32 rounding
    want = sorted_segment_sum_ref(dhs.double(), seg, cap)
    diff = (got.double() - want).abs()
    rel, err = _rel(got.double(), want), diff.max().item()
    # each value's error over the sum of its terms' magnitudes, the scale
    # of f32 summation error in any order: holds short segments as
    # tightly as the 90,528-row one
    abs_sum = sorted_segment_sum_ref(dhs.abs().double(), seg, cap)
    rel_terms = (diff / abs_sum.clamp_min(1e-300)).max().item()
    identical = bool(torch.equal(got, again))
    tol = 1e-5
    if not (rel <= tol and rel_terms <= tol and identical
            and bool(torch.isfinite(got).all())
            and n_uniq <= cap and not got[n_uniq:].any()):
        raise AssertionError(f"K4: relative error {rel}, error over the "
                             f"terms' magnitudes {rel_terms} (tol {tol}), "
                             f"bit-identical reruns {identical}, n_uniq "
                             f"{n_uniq} of cap {cap}")
    del want, diff, abs_sum
    lengths = torch.bincount(seg.long(), minlength=cap)
    nbytes = _nbytes(dhs, seg, got)
    bound, by = _bound(nbytes, float(L * D), "float32")
    # cold L2: dhs sets rotated over 100 MB (seg, 0.5 MB, is shared)
    sets = [dhs] + [torch.randn(L, D, **w)
                    for _ in range(_sets_for(nbytes) - 1)]
    kernel = [lambda x=x: sorted_segment_sum(x, seg, cap) for x in sets]
    plain = [lambda x=x: sorted_segment_sum_ref(x, seg, cap) for x in sets]
    library = [lambda x=x: torch.segment_reduce(
        x, "sum", lengths=lengths, axis=0, unsafe=True) for x in sets]
    times = dict(ms=device_ms(torch, kernel),
                 ms_warm=device_ms(torch, kernel[:1]),
                 ms_events=cuda_ms_cold(torch, kernel),
                 plain_ms=device_ms(torch, plain),
                 library_ms=device_ms(torch, library))
    # device time of each of K4's launches (warm)
    prof = _profile(torch, lambda _: sorted_segment_sum(dhs, seg, cap),
                    range(5), top=3)
    k4 = dict(max_abs_err=err, rel_err=rel, rel_err_over_terms=rel_terms,
              tol=tol,
              bit_identical_reruns=identical, **times,
              bound_ms=bound, bound_by=by, input_sets=len(sets),
              n_uniq=n_uniq, longest_segment=int(lengths.max().item()),
              passes_ms=prof if isinstance(prof, str) else prof["top"])
    _log("kernels", kernel="sorted_segment_sum", dtype="float32",
         shape=[L, D, cap], **k4)
    return dict(
        name="sorted_segment_sum", route="cuda",
        source="gnnflow_tpu_torch/csrc/segment_sum.cu",
        replaces="gnnflow_tpu/ops/segment_pallas.py:165",
        shapes={"dhs": [L, D], "seg": [L], "cap": cap}, dtype="float32",
        **{k: v for k, v in k4.items() if k != "tol"},
        library_note="torch.segment_reduce(sum) with the segment lengths",
        timing_note=TIMING_NOTE)


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


def reddit_stream(torch):
    """The REDDIT-shaped stream of bench.py:221-227, its graph (built from
    every edge, as bench.py does) and edge features on the card."""
    from gnnflow_tpu_torch.data import make_synthetic_dataset
    t0 = time.perf_counter()
    train, _, _, full, _, ef_np = make_synthetic_dataset(
        num_src=10_000, num_dst=984, num_edges=672_447, dim_node=128,
        dim_edge=172, seed=42, time_scale=4.0)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = _graph(full)
    t_ingest = time.perf_counter() - t0
    return dict(train=train, full=full, g=g, dg=g.device_graph("cuda"),
                ef=torch.from_numpy(ef_np).cuda(), data_s=t_data,
                ingest_s=t_ingest)


def _take(edges, batch_size, neg_dst, count):
    from gnnflow_tpu_torch.data import DstRandEdgeSampler, get_batches
    batches = []
    for b in get_batches(edges, batch_size,
                         DstRandEdgeSampler(neg_dst, seed=1)):
        batches.append(b)
        if len(batches) == count:
            break
    return batches


def _reset(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def _check_launches(launches, expected, what) -> None:
    for name, n in launches.items():
        if n != expected[name]:
            raise AssertionError(f"{name} launched {n} times in {what}, "
                                 f"expected {expected[name]}")


def phase_slice(torch, kernels, stream):
    import numpy as np
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    from gnnflow_tpu_torch.utils import (average_precision_score,
                                         roc_auc_score)
    g, dg, ef = stream["g"], stream["dg"], stream["ef"]
    model = DGNN(dim_edge=172, compute_dtype="bfloat16", seed=0,
                 device="cuda", **TGN)
    trainer = Trainer(model, fanouts=[10], device="cuda")
    state = trainer.init_state(g.max_vertex_id() + 1)
    B, warm, runs = 4000, 3, 30
    full = stream["full"]
    batches = _take(full, B, full.dst, warm + runs)
    for b in batches[:warm]:
        trainer.eval_step(state, dg, ef, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
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
    _check_launches(launches, {"gru_memory_fused": runs,
                               "gru_memory_fused_bwd": 0,
                               "neighborhood_attention": runs,
                               "sorted_segment_sum": 0},
                    f"{runs} eval batches")
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
                  launches=launches, data_s=stream["data_s"],
                  ingest_s=stream["ingest_s"],
                  graph_edges=g.num_edges(), nodes=g.max_vertex_id() + 1,
                  search_iters=dg.search_iters, profile=prof)
    _log("slice", **result)
    return result


def _all_finite(torch, state, model) -> bool:
    mem = state.memory
    return bool(torch.isfinite(mem.node_memory).all()
                and torch.isfinite(mem.mailbox).all()
                and all(torch.isfinite(p).all() for p in model.parameters()))


def _fast_steps(trainer, state, num_all) -> int:
    """1 when the step just taken ran the dedup's fast path, else 0."""
    n = state.dedup_n_uniq
    return int(n is not None and n <= trainer._dedup_cap(num_all))


def phase_train(torch, kernels, stream):
    """Train steps of batch 4000 at the full config of bench.py:262-267 on
    the stream's train split, with the default trainer (it calibrates the
    memory dedup on its first step); then steps at attention dropout 0."""
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.ops.attention_fused import \
        neighborhood_attention_autograd as attention_autograd
    from gnnflow_tpu_torch.train import Trainer
    g, dg, ef, train = stream["g"], stream["dg"], stream["ef"], \
        stream["train"]
    B, warm, runs, extra = 4000, 3, 30, 5
    batches = _take(train, B, train.dst, warm + runs + 5 + extra)
    model = DGNN(dim_edge=172, compute_dtype="bfloat16", seed=0,
                 device="cuda", **TGN)
    trainer = Trainer(model, fanouts=[10], lr=1e-4, device="cuda")
    state = trainer.init_state(g.max_vertex_id() + 1, seed=0)
    for b in batches[:warm]:
        trainer.train_step(state, dg, ef, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    losses = []
    fast = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    for b in batches[warm:warm + runs]:
        _, loss, _, _ = trainer.train_step(state, dg, ef, b)
        losses.append(loss)
        fast += _fast_steps(trainer, state, 3 * B * 11)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t_host
    launches = {name: fn.launches for name, fn in kernels.items()}
    ms = start.elapsed_time(end) / runs
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = torch.stack(losses).cpu()
    if not (bool(torch.isfinite(losses).all())
            and _all_finite(torch, state, model)):
        raise AssertionError("training produced a non-finite loss, "
                             "parameter or memory value")
    _check_launches(launches, {"gru_memory_fused": runs,
                               "gru_memory_fused_bwd": runs,
                               "neighborhood_attention": 0,
                               "sorted_segment_sum": fast},
                    f"{runs} train steps at att_dropout=0.2")
    prof = _profile(torch, lambda b: trainer.train_step(state, dg, ef, b),
                    batches[warm + runs:warm + runs + 5])

    # attention dropout 0: the layer takes K3, and its backward runs
    model0 = DGNN(dim_edge=172, compute_dtype="bfloat16", seed=0,
                  device="cuda", **{**TGN, "att_dropout": 0.0})
    trainer0 = Trainer(model0, fanouts=[10], lr=1e-4, dedup_factor=None,
                       device="cuda")
    state0 = trainer0.init_state(g.max_vertex_id() + 1, seed=0)
    _reset(kernels)
    bwd0 = attention_autograd.backward_calls
    losses0 = [trainer0.train_step(state0, dg, ef, b)[1]
               for b in batches[-extra:]]
    torch.cuda.synchronize()
    launches0 = {name: fn.launches for name, fn in kernels.items()}
    att_bwd = attention_autograd.backward_calls - bwd0
    losses0 = torch.stack(losses0).cpu()
    if not (bool(torch.isfinite(losses0).all())
            and _all_finite(torch, state0, model0)):
        raise AssertionError("training at att_dropout=0 produced a "
                             "non-finite value")
    _check_launches(launches0, {"gru_memory_fused": extra,
                                "gru_memory_fused_bwd": extra,
                                "neighborhood_attention": extra,
                                "sorted_segment_sum": 0},
                    f"{extra} train steps at att_dropout=0")
    if att_bwd != extra:
        raise AssertionError(f"K3's backward ran {att_bwd} times in "
                             f"{extra} train steps at att_dropout=0")
    result = dict(steps=runs, batch_size=B, ms_per_step=ms,
                  host_ms_per_step=host_s * 1e3 / runs,
                  edges_per_s=B / (ms / 1e3),
                  loss_first5=float(losses[:5].mean()),
                  loss_last5=float(losses[-5:].mean()),
                  calibration=trainer.calibration, dedup_fast_steps=fast,
                  max_memory_allocated_mib=peak_mib, launches=launches,
                  att_dropout0=dict(steps=extra, launches=launches0,
                                    attention_backward_calls=att_bwd,
                                    losses=losses0.tolist()),
                  profile=prof)
    _log("train", **result)
    return result


def _mean_or_none(xs):
    return statistics.mean(xs) if xs else None


def phase_dedup(torch, kernels, stream):
    """Train steps with the memory dedup at factor 0.35 (the config of
    benchmarks/benchmark_dedup_step.py:68-75, which is phase 5's), on the
    batches phase 5 times; steps at factor 0.001 (every step falls back);
    dedup eval batches."""
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    g, dg, ef, train, full = stream["g"], stream["dg"], stream["ef"], \
        stream["train"], stream["full"]
    B, warm, runs, fb_steps, ev_runs = 4000, 3, 30, 5, 10
    num_all = 3 * B * 11
    batches = _take(train, B, train.dst, warm + runs)

    def trainer_for(factor):
        model = DGNN(dim_edge=172, compute_dtype="bfloat16", seed=0,
                     device="cuda", **TGN)
        tr = Trainer(model, fanouts=[10], lr=1e-4, dedup_factor=factor,
                     device="cuda")
        return model, tr, tr.init_state(g.max_vertex_id() + 1, seed=0)

    model, trainer, state = trainer_for(0.35)
    cap = trainer._dedup_cap(num_all)
    for b in batches[:warm]:
        trainer.train_step(state, dg, ef, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    losses, n_uniq = [], []
    # an event between steps, read after the loop: each step's share
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    t_host = time.perf_counter()
    events[0].record()
    for i, b in enumerate(batches[warm:warm + runs]):
        _, loss, _, _ = trainer.train_step(state, dg, ef, b)
        losses.append(loss)
        n_uniq.append(state.dedup_n_uniq)
        events[i + 1].record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t_host
    launches = {name: fn.launches for name, fn in kernels.items()}
    ms = events[0].elapsed_time(events[-1]) / runs
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = torch.stack(losses).cpu()
    fast = sum(n <= cap for n in n_uniq)
    if not (bool(torch.isfinite(losses).all())
            and _all_finite(torch, state, model)):
        raise AssertionError("dedup training produced a non-finite value")
    if fast < 1:
        raise AssertionError(f"no dedup step fit the cap {cap}: {n_uniq}")
    _check_launches(launches, {"gru_memory_fused": runs,
                               "gru_memory_fused_bwd": runs,
                               "neighborhood_attention": 0,
                               "sorted_segment_sum": fast},
                    f"{runs} dedup train steps ({fast} fast)")
    # the profile takes early batches again: their unique pairs fit the cap
    prof = _profile(torch, lambda b: trainer.train_step(state, dg, ef, b),
                    batches[warm:warm + 5])

    # factor 0.001: a cap of 256 rows, every step falls back
    model_fb, trainer_fb, state_fb = trainer_for(0.001)
    cap_fb = trainer_fb._dedup_cap(num_all)
    _reset(kernels)
    fb_uniq = []
    for b in batches[:fb_steps]:
        trainer_fb.train_step(state_fb, dg, ef, b)
        fb_uniq.append(state_fb.dedup_n_uniq)
    torch.cuda.synchronize()
    launches_fb = {name: fn.launches for name, fn in kernels.items()}
    if not (all(n > cap_fb for n in fb_uniq)
            and _all_finite(torch, state_fb, model_fb)):
        raise AssertionError(f"fallback steps: unique counts {fb_uniq} "
                             f"against cap {cap_fb}, or non-finite values")
    _check_launches(launches_fb, {"gru_memory_fused": fb_steps,
                                  "gru_memory_fused_bwd": fb_steps,
                                  "neighborhood_attention": 0,
                                  "sorted_segment_sum": 0},
                    f"{fb_steps} train steps at factor 0.001")

    # eval with the dedup: forward only, so K4 never runs
    model_ev, trainer_ev, state_ev = trainer_for(0.35)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ev_batches = _take(full, B, full.dst, ev_runs + warm)
    for b in ev_batches[:warm]:
        trainer_ev.eval_step(state_ev, dg, ef, b)
    torch.cuda.synchronize()
    _reset(kernels)
    ev_uniq, ev_losses = [], []
    start.record()
    for b in ev_batches[warm:]:
        ev_losses.append(trainer_ev.eval_step(state_ev, dg, ef, b)[1])
        ev_uniq.append(state_ev.dedup_n_uniq)
    end.record()
    torch.cuda.synchronize()
    ev_ms = start.elapsed_time(end) / ev_runs
    launches_ev = {name: fn.launches for name, fn in kernels.items()}
    if not (bool(torch.isfinite(torch.stack(ev_losses)).all())
            and all(n <= cap for n in ev_uniq)):
        raise AssertionError(f"dedup eval: non-finite loss or unique "
                             f"counts {ev_uniq} above cap {cap}")
    _check_launches(launches_ev, {"gru_memory_fused": ev_runs,
                                  "gru_memory_fused_bwd": 0,
                                  "neighborhood_attention": ev_runs,
                                  "sorted_segment_sum": 0},
                    f"{ev_runs} dedup eval batches")
    result = dict(
        factor=0.35, cap=cap, steps=runs, batch_size=B, ms_per_step=ms,
        host_ms_per_step=host_s * 1e3 / runs, edges_per_s=B / (ms / 1e3),
        fast_steps=fast, fallback_steps=runs - fast,
        fast_ms_per_step=_mean_or_none(
            [t for t, n in zip(step_ms, n_uniq) if n <= cap]),
        fallback_ms_per_step=_mean_or_none(
            [t for t, n in zip(step_ms, n_uniq) if n > cap]),
        n_uniq_min=min(n_uniq), n_uniq_median=statistics.median(n_uniq),
        n_uniq_max=max(n_uniq), loss_first5=float(losses[:5].mean()),
        loss_last5=float(losses[-5:].mean()),
        max_memory_allocated_mib=peak_mib, launches=launches, profile=prof,
        fallback=dict(factor=0.001, cap=cap_fb, steps=fb_steps,
                      n_uniq=fb_uniq, launches=launches_fb),
        eval=dict(batches=ev_runs, ms_per_batch=ev_ms, n_uniq_min=min(ev_uniq),
                  n_uniq_max=max(ev_uniq), launches=launches_ev))
    _log("dedup", **result)
    return result


def phase_entry(torch, kernels):
    """Two epochs of the port's offline training script on its synthetic
    stream (100,000 edges, batch 4000, TGN in f32), on the card."""
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
    _reset(kernels)
    t0 = time.perf_counter()
    out = entry.main(["--model", "TGN", "--data", "SYNTHETIC", "--epoch",
                      "2"], checkpoint_path=os.path.join(
                          _build.BUILD_DIR, "TGN_torch.ckpt"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    aps = out["val_ap"] + [out["test_ap"]]
    if len(out["val_ap"]) != 2 or not all(0.0 < a <= 1.0 for a in aps):
        raise AssertionError(f"entry: {out}")
    if launches["gru_memory_fused"] == 0 \
            or launches["gru_memory_fused_bwd"] == 0:
        raise AssertionError(f"entry ran without the GRU kernels: "
                             f"{launches}")
    result = dict(seconds=seconds, launches=launches, **out)
    _log("entry", **result)
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


def _rel(a, b) -> float:
    """max |a - b| over max |b| (0 when both are 0)."""
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    return err / scale if scale > 0 else err


def _copy_train_state(src, dst) -> None:
    """Copy run ``src``'s parameters, Adam moments and memory into run
    ``dst`` (across devices) and remake ``dst``'s weight copies."""
    for p_s, p_d in zip(src["model"].parameters(), dst["model"].parameters()):
        p_d.detach().copy_(p_s.detach())
        for k, v in src["st"].optimizer.state[p_s].items():
            dst["st"].optimizer.state[p_d][k].copy_(v)
    for f in ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts"):
        getattr(dst["st"].memory, f).copy_(getattr(src["st"].memory, f))
    dst["model"].cast_weights()


def _trace_errs(a, b, pnames):
    """Per step of two train traces: loss (abs), the worst parameter's
    gradient error (max abs error over max abs value) and that parameter,
    parameters (abs) and memory (abs)."""
    errs = {k: [] for k in ("loss", "grad", "param", "memory")}
    worst = []
    for x, y in zip(a, b):
        errs["loss"].append((x["loss"] - y["loss"]).abs().item())
        rel = {nm: _rel(gy, gx) for nm, gx, gy in
               zip(pnames, x["grad"], y["grad"])}
        worst.append(max(rel, key=rel.get))
        errs["grad"].append(rel[worst[-1]])
        errs["param"].append(max((px - py).abs().max().item()
                                 for px, py in zip(x["param"], y["param"])))
        errs["memory"].append((x["memory"] - y["memory"]).abs().max().item())
    return errs, worst


def phase_self_check(torch, card: str = "cuda"):
    """CPU (plain versions) vs card (kernels) on the same batches: eval
    steps, then train steps at dropout 0 from the same weights; in f32
    also train steps with the memory dedup on both sides, and the card's
    dedup run against its per-instance run."""
    from gnnflow_tpu_torch.data import (DstRandEdgeSampler, get_batches,
                                        make_synthetic_dataset)
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.ops.segment_sum import sorted_segment_sum
    from gnnflow_tpu_torch.train import Trainer
    _, _, _, full, _, ef_np = make_synthetic_dataset(
        num_src=400, num_dst=80, num_edges=6000, dim_edge=172, seed=7,
        time_scale=4.0)
    g = _graph(full)
    num_nodes = g.max_vertex_id() + 1
    graphs = {d: g.device_graph(d) for d in ("cpu", card)}
    efs = {d: torch.from_numpy(ef_np).to(d) for d in ("cpu", card)}
    # eval: f32: TF32 is off, so only sum order differs; bf16: a matmul
    # output one bf16 ulp apart (CPU vs cuBLAS accumulation) feeds the
    # next layers and the next batch's memory
    tols = {"float32": 1e-4, "bfloat16": 2e-2}
    # train, per step: loss (abs), gradients (max abs error over max abs
    # value, per parameter), parameters (abs) and memory (abs).  f32 runs
    # free for all steps: sum order only, and Adam moves parameters alike
    # when gradients agree to ~1e-6 relative.  bf16: a gradient within bf16
    # noise of zero can take an Adam step of +lr on one side and -lr on the
    # other, and free runs then take later gradients at different points.
    # So before each bf16 step the card takes the CPU's parameters, Adam
    # moments and memory, and every step is held from one state: the eval
    # reasons for loss, gradients and memory; parameters part by at most
    # ~2 lr in one step
    lr, steps = 1e-4, 4
    train_tols = {"float32": dict(loss=1e-4, grad=1e-4, param=1e-5,
                                  memory=1e-4),
                  "bfloat16": dict(loss=2e-2, grad=2e-2, param=3e-4,
                                   memory=2e-2)}
    cfg = {**TGN, "dropout": 0.0, "att_dropout": 0.0}
    out, failed = {}, []
    for cd, tol in tols.items():
        ev = {}
        for device in ("cpu", card):
            model = DGNN(dim_edge=172, compute_dtype=cd, seed=1,
                         device=device, **TGN)
            tr = Trainer(model, fanouts=[10], device=device)
            st = tr.init_state(num_nodes)
            logits, mems = [], []
            neg = DstRandEdgeSampler(full.dst, seed=3)
            for i, b in enumerate(get_batches(full, 500, neg)):
                if i == 4:
                    break
                _, _, p, n = tr.eval_step(st, graphs[device], efs[device], b)
                logits.append(torch.cat([p, n]).float().cpu())
                mems.append(torch.cat([st.memory.node_memory,
                                       st.memory.mailbox], 1).cpu())
            ev[device] = (logits, mems, st.memory.node_memory_ts.cpu())
        (cl, cm, cts), (gl, gm, gts) = ev["cpu"], ev[card]
        err_l = max((a - b).abs().max().item() for a, b in zip(cl, gl))
        err_m = max((a - b).abs().max().item() for a, b in zip(cm, gm))
        ts_equal = bool(torch.equal(cts, gts))
        ev = dict(logits_max_abs_err=err_l, memory_max_abs_err=err_m,
                  memory_ts_equal=ts_equal, tol=tol)
        if not (err_l <= tol and err_m <= tol and ts_equal):
            failed.append(f"eval {cd}")

        # runs in lockstep.  bf16 adds two reported runs: "card_free" runs
        # free beside the held card run, and "cpu_nudged" runs on the CPU
        # from card_free's state after the first step, so it parts from
        # "cpu" through the first step's parameter difference alone.  f32
        # adds the dedup on both sides, at factor 1.0 (cap = every
        # instance), so every step takes its fast path
        bf16 = cd == "bfloat16"
        names = ["cpu", "card"] + (["card_free", "cpu_nudged"] if bf16
                                   else ["cpu_dedup", "card_dedup"])
        runs = {}
        for nm in names:
            device = "cpu" if nm.startswith("cpu") else card
            model = DGNN(dim_edge=172, compute_dtype=cd, seed=1,
                         device=device, **cfg)
            tr = Trainer(model, fanouts=[10], lr=lr, device=device,
                         dedup_factor=1.0 if nm.endswith("dedup") else None)
            runs[nm] = dict(model=model, tr=tr, st=tr.init_state(num_nodes),
                            device=device, trace=[], fast=0)
        neg = DstRandEdgeSampler(full.dst, seed=4)
        k4_before = sorted_segment_sum.launches
        for i, b in enumerate(get_batches(full, 500, neg)):
            if i == steps:
                break
            for r in runs.values():
                model, st = r["model"], r["st"]
                _, loss, _, _ = r["tr"].train_step(
                    st, graphs[r["device"]], efs[r["device"]], b)
                r["fast"] += _fast_steps(r["tr"], st, 1500 * 11)
                r["trace"].append(dict(
                    loss=loss.float().cpu(),
                    grad=[q.grad.float().cpu() for q in model.parameters()],
                    param=[q.detach().cpu().clone()
                           for q in model.parameters()],
                    memory=torch.cat([st.memory.node_memory,
                                      st.memory.mailbox], 1).cpu()))
            if bf16:
                _copy_train_state(runs["cpu"], runs["card"])
                if i == 0:
                    _copy_train_state(runs["card_free"], runs["cpu_nudged"])
        pnames = [nm for nm, _ in runs["cpu"]["model"].named_parameters()]
        tt = train_tols[cd]
        errs, worst = _trace_errs(runs["cpu"]["trace"], runs["card"]["trace"],
                                  pnames)
        train_ts_equal = bool(torch.equal(
            runs["cpu"]["st"].memory.node_memory_ts,
            runs["card"]["st"].memory.node_memory_ts.cpu()))
        finite = all(bool(torch.isfinite(x).all())
                     for s_ in runs["card"]["trace"]
                     for x in s_["grad"] + s_["param"] + [s_["memory"]])
        tr_out = dict(steps=steps, state_synced_before_each_step=bf16,
                      per_step_max_err=errs, worst_grad_parameter=worst,
                      tol=tt, memory_ts_equal=train_ts_equal, finite=finite)
        if bf16:
            # the first step's parameter elements more than lr apart
            # between cpu and card_free, and their largest gradient
            # relative to the largest of their parameter
            c0, f0 = runs["cpu"]["trace"][0], runs["card_free"]["trace"][0]
            apart, apart_grad = 0, 0.0
            for gr, x, y in zip(c0["grad"], c0["param"], f0["param"]):
                m = (x - y).abs() > lr
                apart += int(m.sum())
                if m.any():
                    apart_grad = max(apart_grad, (gr[m].abs().max()
                                                  / gr.abs().max()).item())
            free, free_worst = _trace_errs(runs["cpu"]["trace"],
                                           runs["card_free"]["trace"], pnames)
            nudged, nudged_worst = _trace_errs(
                runs["cpu"]["trace"], runs["cpu_nudged"]["trace"], pnames)
            tr_out["reported"] = dict(
                first_step_elements_apart_by_more_than_lr=apart,
                parameter_elements=sum(p.numel() for p in c0["param"]),
                their_max_relative_grad=apart_grad,
                free_card_vs_cpu=dict(per_step_max_err=free,
                                      worst_grad_parameter=free_worst),
                nudged_cpu_vs_cpu=dict(per_step_max_err=nudged,
                                       worst_grad_parameter=nudged_worst))
        if not (all(max(errs[k]) <= tt[k] for k in tt) and train_ts_equal
                and finite):
            failed.append(f"train {cd}")
        if not bf16:
            # the dedup: CPU vs card, and the card's dedup run against its
            # per-instance run (only the sum order over fewer GRU rows and
            # of the expansion's transpose differ)
            k4 = sorted_segment_sum.launches - k4_before
            vs_cpu, vs_cpu_worst = _trace_errs(runs["cpu_dedup"]["trace"],
                                               runs["card_dedup"]["trace"],
                                               pnames)
            vs_plain, vs_plain_worst = _trace_errs(
                runs["card"]["trace"], runs["card_dedup"]["trace"], pnames)
            dedup_ts_equal = bool(torch.equal(
                runs["cpu_dedup"]["st"].memory.node_memory_ts,
                runs["card_dedup"]["st"].memory.node_memory_ts.cpu()))
            tr_out["dedup"] = dict(
                factor=1.0, fast_steps={nm: runs[nm]["fast"] for nm in
                                        ("cpu_dedup", "card_dedup")},
                k4_launches=k4, memory_ts_equal=dedup_ts_equal,
                cpu_vs_card=dict(per_step_max_err=vs_cpu,
                                 worst_grad_parameter=vs_cpu_worst),
                dedup_vs_per_instance_on_card=dict(
                    per_step_max_err=vs_plain,
                    worst_grad_parameter=vs_plain_worst))
            if not (all(max(e[k]) <= tt[k] for e in (vs_cpu, vs_plain)
                        for k in tt)
                    and dedup_ts_equal and k4 == steps
                    and runs["cpu_dedup"]["fast"] == steps
                    and runs["card_dedup"]["fast"] == steps):
                failed.append(f"train dedup {cd}")
        out[cd] = dict(eval=ev, train=tr_out)
    _log("self_check", eval_batches=4, batch_size=500, **out)
    if failed:
        raise AssertionError(f"CPU vs card: {failed} beyond tolerance")


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import gnnflow_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = phase_device(torch)
    from gnnflow_tpu_torch.ops.attention_fused import neighborhood_attention
    from gnnflow_tpu_torch.ops.gru_fused import (gru_memory_fused,
                                                 gru_memory_fused_bwd)
    from gnnflow_tpu_torch.ops.segment_sum import sorted_segment_sum
    phase_build()
    stream = reddit_stream(torch)
    rows = phase_kernels(torch, stream)
    kernels = {"gru_memory_fused": gru_memory_fused,
               "gru_memory_fused_bwd": gru_memory_fused_bwd,
               "neighborhood_attention": neighborhood_attention,
               "sorted_segment_sum": sorted_segment_sum}
    sl = phase_slice(torch, kernels, stream)
    tr = phase_train(torch, kernels, stream)
    dd = phase_dedup(torch, kernels, stream)
    en = phase_entry(torch, kernels)
    # launches on each main path, counted from 0 just before it: eval
    # batches, train steps at att_dropout 0.2 and at 0, dedup train steps,
    # fallback steps and eval batches, the entry script's two epochs
    paths = {"eval": sl["launches"], "train": tr["launches"],
             "train_att_dropout0": tr["att_dropout0"]["launches"],
             "dedup_train": dd["launches"],
             "dedup_fallback": dd["fallback"]["launches"],
             "dedup_eval": dd["eval"]["launches"], "entry": en["launches"]}
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    phase_self_check(torch)
    print(json.dumps({"kernels": rows, "card": dev["smi"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
