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
   must not be 0 for the bf16 forward, row-tile and product kernels; and
   the store's ingestion helper, ``csrc/ingest.cc``, with the host
   compiler.
2b. ingest: the store's host helper (``csrc/ingest.cc``, built in
   phase 2) against its plain NumPy versions on the
   REDDIT-shaped stream of phase 4, bit for bit (``phase_ingest``'s
   docstring), with host ms of each beside its plain version and the
   store build's seconds both ways.
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
8. slice vs itself (run after phase 18, while phase 19's harness runs
   beside it: it times nothing): the same batches of a small stream on
   the CPU (plain versions) and on the card (kernels), same weights: eval
   logits and memory, then train steps at dropout 0 (losses, gradients,
   parameters and memory after each step), in f32 and bf16.  In bf16
   the card takes the CPU's state before each step, so every step is
   held from one state; a free-running card run and a CPU run started
   from the card's first step are reported beside it.  In f32 the
   dedup's train steps run on both sides too, and the card's dedup run is
   held against its per-instance run.  TGAT in f32 as well (the widths
   of phase 9, dropout 0, the same uniform draws on both sides): eval
   logits, then train steps on a two-tier layer-dedup ladder; and DySAT
   the same way (the widths of phase 10), train steps on a two-tier
   snapshot-dedup ladder; and the serving path of phase 13 in f32 (an
   ``embed_step`` and a prequential sequence).
9. tgat: TGAT as ``bench.py:127-160`` runs it (REDDIT defaults through
   ``build_model``: 2 layers, fanouts [10, 10], uniform sampling, no
   memory, dropout and attention dropout 0.1, bf16 compute, 172-dim edge
   features, batch 4000) on the same stream: 10 eval batches (K3 twice a
   batch: 12,000 and 132,000 destinations), 20 train steps with the
   default trainer (the first calibrates the layer-dedup ladder; K3
   never, K4 once a step that takes a tier), 5 steps at attention dropout
   0 and factor 0.5 (K3 and its backward twice a step), 5 at factor 0.01
   (all fall back, K4 never); ms/step with CUDA events and host ms, peak
   memory, profiles, and the plain attention's share of a train step's
   device time; then K3 at the inner layer's 132,000 rows and K4 at the
   layer boundary against their plain versions, with the tolerances of
   phase 3.
10. dysat: DySAT as ``bench.py:127-160`` runs it (REDDIT defaults through
   ``build_model``: 2 layers, fanouts [10, 10], uniform sampling, 3
   snapshots of window 10000 with prop_time, no time encoding, no memory,
   dropout and attention dropout 0.1, bf16 compute, 172-dim edge
   features, batch 4000) on the same stream: 10 eval batches on the
   padded path (K3 six times a batch), 20 train steps with the default
   trainer (the first calibrates the block compaction and the
   snapshot-dedup ladder; K3 never, K4 three times a step on the snapshot
   dedup), 5 steps at attention dropout 0 on the snapshot dedup at factor
   0.5 (K3 and its backward six times a step), 5 on the block compaction
   alone at factor 0.9 (K4 never), 5 at factor 0.01 (all fall back, K4
   never), one epoch of the entry script; then K3 at the inner layer's
   padded, block-compact and deduplicated shapes and K4 at the snapshot
   boundary against their plain versions.
11. apan: APAN as ``bench.py:127-160`` runs it (REDDIT defaults through
   ``build_model``: 1 layer, fanout 10, recent sampling, memory, time and
   embedding dims 100, 2 heads, the transformer memory updater over a
   10-slot circular mailbox, dropout and attention dropout 0.1, bf16
   compute, 172-dim edge features, batch 4000) on the same stream: 10
   eval batches on the pre-projected K/V table pull (K3 once a batch), 20
   train steps with the default trainer (the first calibrates the memory
   dedup by the transformer's rule; K3 never, K4 once a step on the
   dedup), 5 steps at attention dropout 0 on the dedup at factor 0.6 (K3
   and its backward once a step, K4 once a step that fits), 5 at factor
   0.01 (all fall back, K4 never), one f32 train step of the per-instance
   pull against the table pull from one state, one epoch of the entry
   script; the device time of the table pull's forward and its kernel
   gradient and of the updater's attention; then K3 at the embedding
   layer's eval shape and K4 at the memory dedup's boundary against their
   plain versions.  Phase 8's CPU-card check holds APAN in f32 too.
12. static: GraphSAGE and GAT as ``bench.py:127-160`` run them (REDDIT
   defaults through ``build_model``: GraphSAGE 2 layers, fanouts [15, 10],
   the mean aggregator; GAT 2 layers, fanouts [10, 10], heads (2, 1),
   dropout and attention dropout 0.1; both uniform sampling at the static
   timestamp 3.4e38, embedding width 100, bf16 compute, the stream's
   128-dim node features, batch 4000) on the same stream, each: 10 eval
   batches (padded; no kernel), 20 train steps with the default trainer
   (the first calibrates the layer-dedup ladder; K4 once a step that takes
   a tier), 5 steps on the layer dedup at the set factor 0.95 (K4 once a
   step that fits), 5 at factor 0.01 (all fall back, K4 never), one epoch
   of the entry script; then K4 at the layer boundary (GraphSAGE: 192,000
   rows of width 100; GAT: 132,000 of width 200) against its plain
   version.  Phase 8's CPU-card check holds both in f32 too: eval, and 4
   train steps on a two-tier layer-dedup ladder.
13. online: the port's online script
   (``gnnflow_tpu_torch.scripts.online_edge_prediction``) serving TGN at
   the REDDIT defaults in bf16 on the same stream without node features,
   written to ``build/`` by ``write_synthetic_dataset``: phase 1 on 30%
   of it (one epoch), then 50 chunks, each scored prequentially (K1, K3),
   ingested, and every 10th followed by the eviction of the edges older
   than a quarter of the stream's time span and replay retraining (K1,
   K2); the device view must be uploaded once per change of the store.
   Logs eval ms per batch, ingest, eviction and retrain ms per step per
   chunk; a second call resumes from the phase-1 checkpoint. Phase 8's
   CPU-card check holds an f32 ``embed_step`` and a prequential eval →
   ingest → evict sequence from one state per chunk.
14. inference: the port's inference script on that dataset: TGN from the
   online phase-1 checkpoint with its embeddings dumped (K1 and K3 in the
   eval and ``embed_step`` batches; the npz's keys, shapes and node ids
   are checked), then DySAT from random init at batch 4000 over the
   windows 0 and 5000 (K3).
15. cache: TGN through the feature cache (``phase_cache``'s docstring).
16. parallel: multi-GPU training at world size 1 on NCCL (a process
   group over a ``file://`` rendezvous under ``build/``): 20 TGN train
   steps (bf16, REDDIT defaults, batch 4000) and 10 eval batches through
   ``shard_trainer`` beside the plain trainer's, and 3 f32 steps at
   dropout 0 held to the plain ``Trainer`` within 1e-5 (losses,
   parameters, memory); the stream dispatched into 4 hash partitions,
   all owned by rank 0, whose routed and replicated MFGs (2 layers,
   recent and uniform) equal the single store's bit for bit on 3
   batches, with routed layer sampling timed at 12,000 and 132,000 roots
   and the routed load's CV; the same TGN paths and f32 check through
   ``PartitionedTrainer`` (routed); TGAT eval and 5 train steps at
   attention dropout 0 on the layer dedup at 0.5 through routed sampling
   (K3, K4); TGN through ``PartitionedTrainer`` on memory sharded by
   ``shard_memory_state`` beside replicated memory (20 train steps, 10
   eval batches), and 3 f32 steps of each equal exactly, per instance and
   on the memory dedup at 0.35 over the 128-dim node table in a
   ``ShardedTable`` (K4); the LRU cache at 0.3 over a ``ShardedTable``
   master of the 462.6 MB edge table against the host-master cache (the
   same features and hit ratios over 5 batches; 20 cached train steps of
   each); one epoch of the partitioned script at ``--num-devices 1
   --num-partitions 4`` and a ``--max-steps``-cut one of the multiprocess
   script with ``--cache``, each joining the group.  Lines ``[parallel]``
   with ``path`` dp, store, partitioned, memory, cache, tgat and script:
   ms per step and per eval batch (CUDA events, median) beside the plain
   trainer's, host ms, the f32 errors, the store's dispatch seconds and
   partition sizes, the layer sampling ms, the load CV, the scripts'
   APs.  K1, K2, K3 and K4 must each launch on these paths.
17. storage: TGN with bf16 memory storage beside f32 storage
   (``phase_storage``'s docstring): ms/step, the memory's bytes, peak
   memory, and 3 f32-compute steps within ``STORAGE_TOL``.
18. variants: the opt-in variants at TGN's REDDIT defaults
   (``phase_variants``'s docstring): three negatives per edge, memory
   over two layers, the GRU gate table, remat, the factorized attention,
   the scanned steps and ``--use-scan``, the updaters without time
   encoding, a REPLACE store; and K1, K3 and K4 at their new shapes.
19. parity: the port's parity harness, ``parity_run --smoke
   --smoke-models TGN`` with its two host cells, started as a subprocess
   before phase 8 (each cell a subprocess of the training script on the
   card), then without data: the verdicts and each cell's AP.

Then one JSON line with every kernel's numbers and, last, the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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


# timings that the profiler could not take: one entry for each call of
# ``device_ms`` that met an empty profiling session, printed at the end
PROFILER_EMPTY = []


def device_ms(torch, fns, iters: int = 24, sessions: int = 3,
              tries: int = 8) -> float:
    """Mean device time of one call: the summed device time of every
    kernel the calls launch (``torch.profiler``), over ``iters`` calls
    rotating over ``fns`` after one round of warm-up; the median of
    ``sessions`` profiling sessions that recorded device time, out of at
    most ``tries``, since a session now and then comes back empty or short
    of records.  Where the host takes longer to prepare a call than the
    device to run it, CUDA events around back-to-back calls time the host;
    this does not.  If no session records device time, the time is taken
    with CUDA events instead (``cuda_ms_cold``), and ``PROFILER_EMPTY``
    says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    totals, empty = [], 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            totals.append(total)
        else:
            empty += 1
        if len(totals) == sessions:
            break
    if empty:
        PROFILER_EMPTY.append(dict(
            empty_sessions=empty, recorded_sessions=len(totals),
            timed_by="profiler" if totals else "cuda events"))
        _log("timing", **PROFILER_EMPTY[-1])
    if not totals:
        return cuda_ms_cold(torch, fns, iters)
    return statistics.median(totals) / 1e3 / iters


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
    t0 = time.perf_counter()
    host = _build.build_host("ingest")   # the store's host helper, g++
    host_s = time.perf_counter() - t0
    hmma = _tensor_core_counts(_build.lib_path("gru_fused"))
    missing = [k for k in TENSOR_CORE_KERNELS
               if not any(k in fn and c > 0 for fn, c in hmma.items())]
    _log("build", seconds=round(seconds, 3), kernels=_build.sources(),
         host_helper=os.path.relpath(host, _build.BUILD_DIR),
         host_helper_s=round(host_s, 3),
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
        torch.from_numpy(b.ts).cuda(),
        fanouts=[F])[0][0].nbr_mask.contiguous()
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
    """K4 at the memory dedup's shapes: segment ids from a real dedup of
    the first train batch (12,000 roots x 11 = 132,000 instances), cap of
    factor 0.35, D = 100 (the memory width; no lane pad on the card)."""
    from gnnflow_tpu_torch.ops.dedup import dedup_instances
    from gnnflow_tpu_torch.ops.sampling import sample_hops
    from gnnflow_tpu_torch.train import dedup_cap
    train = stream["train"]
    b = _take(train, 4000, train.dst, 1)[0]
    m = sample_hops(stream["dg"], torch.from_numpy(b.target_nodes).cuda(),
                    torch.from_numpy(b.ts).cuda(), fanouts=[10])[0][0]
    cap = dedup_cap(0.35, m.num_all)
    _, _, _, n_uniq, _, seg = dedup_instances(m.all_nodes(), m.all_ts(),
                                              m.all_mask(), cap)
    k4 = _k4_check(torch, w, seg, cap, int(n_uniq), 100)
    _log("kernels", kernel="sorted_segment_sum", dtype="float32",
         shape=[m.num_all, 100, cap], **k4)
    return dict(
        name="sorted_segment_sum", route="cuda",
        source="gnnflow_tpu_torch/csrc/segment_sum.cu",
        replaces="gnnflow_tpu/ops/segment_pallas.py:165",
        shapes={"dhs": [m.num_all, 100], "seg": [m.num_all], "cap": cap},
        dtype="float32", **{k: v for k, v in k4.items() if k != "tol"},
        library_note="torch.segment_reduce(sum) with the segment lengths",
        timing_note=TIMING_NOTE)


def _k4_check(torch, w, seg, cap, n_uniq, D):
    """K4 on ``seg`` [L] (ranks of a real dedup, ``n_uniq`` of them below
    ``cap``) and random rows [L, D]: held to the plain version in f64,
    two launches bit-identical, ranks past ``n_uniq`` zero; times with the
    L2 cold and warm, the plain version and ``torch.segment_reduce``."""
    from gnnflow_tpu_torch.ops.segment_sum import (sorted_segment_sum,
                                                   sorted_segment_sum_ref)
    L = seg.shape[0]
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
    # tightly as long ones
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
    # cold L2: dhs sets rotated over 100 MB (seg is shared)
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
    return dict(max_abs_err=err, rel_err=rel, rel_err_over_terms=rel_terms,
                tol=tol, bit_identical_reruns=identical, **times,
                bound_ms=bound, bound_by=by, input_sets=len(sets),
                n_uniq=n_uniq, longest_segment=int(lengths.max().item()),
                passes_ms=prof if isinstance(prof, str) else prof["top"])


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
    every edge, as bench.py does), and its edge features and the 128-dim
    node features of the static models (bench.py:224-227) on the card."""
    from gnnflow_tpu_torch.data import make_synthetic_dataset
    t0 = time.perf_counter()
    train, _, _, full, nf_np, ef_np = make_synthetic_dataset(
        num_src=10_000, num_dst=984, num_edges=672_447, dim_node=128,
        dim_edge=172, seed=42, time_scale=4.0)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = _graph(full)
    t_ingest = time.perf_counter() - t0
    return dict(train=train, full=full, g=g, dg=g.device_graph("cuda"),
                ef=torch.from_numpy(ef_np).cuda(),
                nf=torch.from_numpy(nf_np).cuda(), data_s=t_data,
                ingest_s=t_ingest)


INGEST_REPEATS = 5      # timed calls of each full-stream sort and cut
INGEST_CUTS = (0.1, 0.3, 0.5, 0.7, 0.9)   # eviction cuts, as time fractions
INGEST_REGIONS = 500    # out-of-order regions re-sorted


@contextlib.contextmanager
def _plain_ingest():
    """Within the block, the store runs the plain NumPy versions of the
    ingestion helper (``np.lexsort`` and the two NumPy searches)."""
    from gnnflow_tpu_torch.ops import ingest
    names = ("group_sort_edges", "ranged_lower_bound", "resort_range")
    saved = {n: getattr(ingest, n) for n in names}
    for n in names:
        setattr(ingest, n, getattr(ingest, n + "_ref"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ingest, n, fn)


def _host_ms(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return (time.perf_counter() - t0) * 1e3, out


def _store_bits(g):
    """The store's arrays as bytes, the pool up to its used slots."""
    used = g._pool_used
    return dict(row_off=g._row_off.tobytes(), row_len=g._row_len.tobytes(),
                row_cap=g._row_cap.tobytes(), dst=g._dst[:used].tobytes(),
                ts=g._ts[:used].tobytes(), eid=g._eid[:used].tobytes(),
                eid_seen=g._eid_seen.tobytes(),
                counts=(used, g._num_offloaded, g._max_degree,
                        g._num_unique_eids, g._max_vertex_id))


def _online_store(full, plain):
    """The online phase's store changes (``phase_online``: REDDIT's data
    config, phase 1 on 30% of the stream, 50 chunks, the eviction of a
    quarter of the time span after every 10th), through the helper or,
    with ``plain``, its plain versions: the store and each chunk's
    ingest ms and each eviction's ms (host, no device view)."""
    from gnnflow_tpu_torch.config import get_default_config
    from gnnflow_tpu_torch.dynamic_graph import build_dynamic_graph
    n = len(full)
    p1_end = int(0.3 * n)
    chunk = (n - p1_end) // ONLINE_STEPS
    window = float(full.time[-1] - full.time[0]) / 4
    cfg = get_default_config("TGN", "reddit")[1]
    ingest_ms, evict_ms, evicted = [], [], []
    with _plain_ingest() if plain else contextlib.nullcontext():
        g = build_dynamic_graph(**cfg)
        g.add_edges(full.src[:p1_end], full.dst[:p1_end],
                    full.time[:p1_end], full.eid[:p1_end],
                    add_reverse=cfg["undirected"])
        for step in range(ONLINE_STEPS):
            c = full[p1_end + step * chunk: p1_end + (step + 1) * chunk]
            ms, _ = _host_ms(g.add_edges, c.src, c.dst, c.time, c.eid,
                             cfg["undirected"])
            ingest_ms.append(ms)
            if (step + 1) % RETRAIN_EVERY == 0:
                ms, k = _host_ms(g.offload_old_blocks,
                                 float(c.time[-1]) - window)
                evict_ms.append(ms)
                evicted.append(k)
    return g, dict(ingest_ms=ingest_ms, evict_ms=evict_ms, evicted=evicted,
                   chunk_edges=chunk, undirected=cfg["undirected"])


def phase_ingest(torch, stream):
    """The store's ingestion helper (``ops/ingest.py`` over
    ``csrc/ingest.cc``) against its plain NumPy versions on the
    REDDIT-shaped stream, bit for bit: the grouping sort of all its
    directed edges and of 50 serving chunks (each edge also reversed, as
    ``_graph`` ingests), the per-range lower bound over the full store's
    active ranges at 5 cut times, the re-sort of shuffled regions of its
    pool, the whole store built both ways, and the store after the online
    phase's 50 chunks and evictions built both ways.  Host ms, medians."""
    import numpy as np
    from gnnflow_tpu_torch.ops import ingest
    med = statistics.median
    full, g = stream["full"], stream["g"]
    bad = []

    def sort_pair(src, ts):
        a_ms, a = _host_ms(ingest.group_sort_edges, src, ts)
        b_ms, b = _host_ms(ingest.group_sort_edges_ref, src, ts)
        if not np.array_equal(a, b):
            bad.append(f"group sort of {len(src)} edges")
        return a_ms, b_ms

    src = np.concatenate([full.src, full.dst]).astype(np.int64)
    ts = np.concatenate([full.time, full.time]).astype(np.float32)
    whole = [sort_pair(src, ts) for _ in range(INGEST_REPEATS)]
    n = len(full)
    p1_end = int(0.3 * n)
    size = (n - p1_end) // ONLINE_STEPS
    chunks = []
    for step in range(ONLINE_STEPS):
        c = full[p1_end + step * size: p1_end + (step + 1) * size]
        chunks.append(sort_pair(
            np.concatenate([c.src, c.dst]).astype(np.int64),
            np.concatenate([c.time, c.time]).astype(np.float32)))

    active = np.flatnonzero(g._row_len > 0)
    offs, lens = g._row_off[active], g._row_len[active]
    t_lo, t_hi = float(full.time[0]), float(full.time[-1])
    bounds = []
    for frac in INGEST_CUTS:
        cut = np.float32(t_lo + frac * (t_hi - t_lo))
        a = [_host_ms(ingest.ranged_lower_bound, g._ts, offs, lens, cut)
             for _ in range(INGEST_REPEATS)]
        b = [_host_ms(ingest.ranged_lower_bound_ref, g._ts, offs, lens, cut)
             for _ in range(INGEST_REPEATS)]
        if not all(np.array_equal(x[1], b[0][1]) for x in a + b):
            bad.append(f"lower bound at {frac}")
        bounds.append((med(x[0] for x in a), med(x[0] for x in b)))

    rng = np.random.RandomState(0)
    pick = rng.choice(active[g._row_len[active] > 1], INGEST_REGIONS,
                      replace=False)
    pools = [[g._ts.copy(), g._dst.copy(), g._eid.copy()] for _ in range(2)]
    for v in pick:
        o, k = int(g._row_off[v]), int(g._row_len[v])
        perm = o + rng.permutation(k)
        for pool in pools:
            for arr in pool:
                arr[o:o + k] = arr[perm]
    resort = []
    for v in pick:
        o, k = int(g._row_off[v]), int(g._row_len[v])
        a_ms, _ = _host_ms(ingest.resort_range, *pools[0], o, k)
        b_ms, _ = _host_ms(ingest.resort_range_ref, *pools[1], o, k)
        resort.append((a_ms, b_ms, k))
    if not all(x.tobytes() == y.tobytes() for x, y in zip(*pools)):
        bad.append("range re-sort")
    if pools[0][0].tobytes() != g._ts.tobytes():
        bad.append("re-sorted times differ from the store's")

    builds = {"helper": [], "plain": []}
    stores = {}
    for kind in ("plain", "helper", "helper", "plain"):
        t0 = time.perf_counter()
        if kind == "plain":
            with _plain_ingest():
                built = _graph(full)
        else:
            built = _graph(full)
        builds[kind].append(time.perf_counter() - t0)
        stores[kind] = _store_bits(built)
    if stores["helper"] != stores["plain"] \
            or stores["helper"] != _store_bits(g):
        bad.append("the whole stream's store")

    online, on_times = {}, {}
    for kind in ("helper", "plain"):
        built, on_times[kind] = _online_store(full, kind == "plain")
        online[kind] = _store_bits(built)
    if online["helper"] != online["plain"]:
        bad.append("the online phase's store")
    if on_times["helper"]["evicted"] != on_times["plain"]["evicted"] \
            or not all(on_times["helper"]["evicted"]):
        bad.append(f"evicted {on_times['helper']['evicted']} against "
                   f"{on_times['plain']['evicted']}")
    if bad:
        raise AssertionError(f"[ingest] helper against plain: {bad}")

    h, p = on_times["helper"], on_times["plain"]
    res = dict(
        equal=True, directed_edges=len(src),
        sort_ms=med(x[0] for x in whole), sort_plain_ms=med(
            x[1] for x in whole),
        chunk_directed_edges=2 * size,
        chunk_sort_ms=med(x[0] for x in chunks),
        chunk_sort_plain_ms=med(x[1] for x in chunks),
        active_ranges=len(active), cuts=list(INGEST_CUTS),
        lower_bound_ms=[x[0] for x in bounds],
        lower_bound_plain_ms=[x[1] for x in bounds],
        resort_regions=len(pick),
        resort_region_edges_median=med(x[2] for x in resort),
        resort_ms=med(x[0] for x in resort),
        resort_plain_ms=med(x[1] for x in resort),
        store_build_s=builds["helper"], store_build_plain_s=builds["plain"],
        stream_build_s=stream["ingest_s"],
        online_chunk_edges=h["chunk_edges"],
        online_undirected=h["undirected"],
        online_ingest_ms=med(h["ingest_ms"]),
        online_ingest_plain_ms=med(p["ingest_ms"]),
        online_evict_ms=h["evict_ms"], online_evict_plain_ms=p["evict_ms"],
        online_evicted=h["evicted"])
    _log("ingest", **res)
    return res


def _take(edges, batch_size, neg_dst, count, ratio=1):
    from gnnflow_tpu_torch.data import DstRandEdgeSampler, get_batches
    batches = []
    for b in get_batches(edges, batch_size,
                         DstRandEdgeSampler(neg_dst, seed=1),
                         neg_sample_ratio=ratio):
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


PROBE_BATCH = 80        # of the 169 batches of 4000 in the stream


def _tgat(att_dropout=None, layer_dedup="auto", device="cuda", cls=None):
    """TGAT as bench.py:127-160 builds it: the REDDIT defaults of the
    config registry (2 layers, fanouts [10, 10], uniform sampling,
    dropout and attention dropout 0.1, 2 heads, time and embedding dims
    100, no memory) in bf16 compute over f32 parameters, no node input,
    172-dim edge features, seeded random weights, through ``build_model``
    and the trainer arguments it returns."""
    from gnnflow_tpu_torch.config import get_default_config
    from gnnflow_tpu_torch.models.factory import build_model
    from gnnflow_tpu_torch.train import Trainer
    mc, _ = get_default_config("TGAT", "REDDIT")
    mc["compute_dtype"] = "bfloat16"
    if att_dropout is not None:
        mc["att_dropout"] = att_dropout
    model, kw = build_model("TGAT", mc, 0, 172, seed=0, device=device)
    return model, (cls or Trainer)(model, lr=1e-4, layer_dedup=layer_dedup,
                                   device=device, **kw)


def _timed_steps(torch, step, batches):
    """Run ``step`` over ``batches`` with a CUDA event between steps and
    the host clock beside it: ``(outputs, device ms, host ms)`` per
    step."""
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(batches) + 1)]
    host, outs = [], []
    events[0].record()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        outs.append(step(b))
        events[i + 1].record()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return outs, [a.elapsed_time(b) for a, b in zip(events, events[1:])], \
        host


def _plain_attention_spy(model):
    """Record the inputs of each layer's last plain-attention call (the
    route of training at attention dropout > 0); returns the record and
    a function that removes the spies."""
    rec = {}
    for name, layer in model.layers.items():
        def spy(q, kv, mask, gen, name=name, orig=layer._attention_plain):
            rec[name] = (q.detach(), kv.detach(), mask)
            return orig(q, kv, mask, gen)
        layer._attention_plain = spy

    def remove():
        for layer in model.layers.values():
            del layer._attention_plain
    return rec, remove


def phase_tgat(torch, kernels, stream):
    """TGAT (``_tgat``) on the REDDIT-shaped stream at batch 4000: eval
    batches (K3 twice a batch), train steps with the default trainer (the
    first calibrates the layer-dedup ladder; K3 never runs at attention
    dropout 0.1, K4 once a step whose first-boundary unique count fits a
    tier), train steps at attention dropout 0 and factor 0.5 (K3 and its
    backward twice a step), steps at factor 0.01 (every step falls back,
    K4 never); then K3 at the inner layer's 132,000 rows and K4 at the
    layer boundary against their plain versions, and the plain
    attention's share of a train step's device time.  Returns the launch
    counts of each path and the kernels' rows."""
    import numpy as np
    from gnnflow_tpu_torch.ops.attention_fused import \
        neighborhood_attention_autograd as attention_autograd
    from gnnflow_tpu_torch.ops.dedup import dedup_instances
    from gnnflow_tpu_torch.train import tier_caps
    from gnnflow_tpu_torch.utils import (average_precision_score,
                                         roc_auc_score)
    g, dg, ef, train, full = stream["g"], stream["dg"], stream["ef"], \
        stream["train"], stream["full"]
    num_nodes = g.max_vertex_id() + 1
    B, warm, ev_runs, steps, extra = 4000, 3, 10, 20, 5
    launches = {}

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    # ---- eval: the default trainer before any train step runs padded --
    model, trainer = _tgat()
    state = trainer.init_state(num_nodes, seed=0)
    ev_batches = _take(full, B, full.dst, warm + ev_runs)
    for b in ev_batches[:warm]:
        trainer.eval_step(state, dg, ef, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    outs, dev_ms, host_ms = _timed_steps(
        torch, lambda b: trainer.eval_step(state, dg, ef, b)[1:],
        ev_batches[warm:])
    launches["tgat_eval"] = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    pos = torch.cat([o[1][:b.num_valid] for o, b in
                     zip(outs, ev_batches[warm:])]).float().cpu().numpy()
    neg = torch.cat([o[2][:b.num_valid] for o, b in
                     zip(outs, ev_batches[warm:])]).float().cpu().numpy()
    losses = torch.stack([o[0] for o in outs]).cpu()
    if not (bool(torch.isfinite(losses).all()) and np.isfinite(pos).all()
            and np.isfinite(neg).all() and len(pos) == ev_runs * B):
        raise AssertionError("TGAT eval: non-finite values or wrong shapes")
    _check_launches(launches["tgat_eval"],
                    {"gru_memory_fused": 0, "gru_memory_fused_bwd": 0,
                     "neighborhood_attention": 2 * ev_runs,
                     "sorted_segment_sum": 0},
                    f"{ev_runs} TGAT eval batches")
    y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    sc = np.concatenate([pos, neg])
    ev = dict(batches=ev_runs, batch_size=B,
              ms_per_batch=statistics.mean(dev_ms),
              host_ms_per_batch=statistics.mean(host_ms),
              edges_per_s=B / (statistics.mean(dev_ms) / 1e3),
              ap=average_precision_score(y, sc), auc=roc_auc_score(y, sc),
              mean_loss=float(losses.mean()),
              max_memory_allocated_mib=peak,
              launches=launches["tgat_eval"],
              profile=_profile(torch,
                               lambda b: trainer.eval_step(state, dg, ef, b),
                               ev_batches[warm:warm + 3]))
    _log("tgat", path="eval", **ev)
    del model, trainer, state, outs

    # ---- train, default trainer: the first step calibrates ------------
    tb = _take(train, B, train.dst, steps + 3)
    model, trainer = _tgat()
    state = trainer.init_state(num_nodes, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)

    def stepper(trainer, state):
        """A train step that returns its loss and what its layer dedup
        did: boundaries that took a tier, unique counts."""
        def step(b):
            loss = trainer.train_step(state, dg, ef, b)[1]
            return loss, state.layer_dedup_compact, state.layer_dedup_n_uniq
        return step

    outs, dev_ms, host_ms = _timed_steps(torch, stepper(trainer, state),
                                         tb[:steps])
    launches["tgat_train"] = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = torch.stack([o[0] for o in outs]).cpu()
    compact = [o[1] for o in outs]
    takes = trainer.tier_take_stats(state)
    if not (bool(torch.isfinite(losses).all())
            and all(bool(torch.isfinite(p).all())
                    for p in model.parameters())):
        raise AssertionError("TGAT training produced a non-finite value")
    # the calibration may leave the dedup off; then no step takes a tier
    if takes is None or takes["total"] != (steps if trainer.layer_dedup
                                           is not None else 0):
        raise AssertionError(f"TGAT tier takes {takes} over {steps} steps")
    _check_launches(launches["tgat_train"],
                    {"gru_memory_fused": 0, "gru_memory_fused_bwd": 0,
                     "neighborhood_attention": 0,
                     "sorted_segment_sum": sum(compact)},
                    f"{steps} TGAT train steps at att_dropout=0.1")
    # the profile's steps also record the plain attention's inputs
    rec, remove = _plain_attention_spy(model)
    prof = _profile(torch, lambda b: trainer.train_step(state, dg, ef, b),
                    tb[steps:steps + 3])
    remove()
    attention = _plain_attention_ms(torch, model, rec)
    busy = prof["device_busy_ms_per_batch"] if isinstance(prof, dict) \
        else None
    fast = [t for t, c in zip(dev_ms, compact) if c]
    slow = [t for t, c in zip(dev_ms, compact) if not c]
    tr = dict(steps=steps, batch_size=B, calibration=trainer.calibration,
              first_step_ms=dev_ms[0], first_step_host_ms=host_ms[0],
              ms_per_step=statistics.mean(dev_ms[warm:]),
              host_ms_per_step=statistics.mean(host_ms[warm:]),
              edges_per_s=B / (statistics.mean(dev_ms[warm:]) / 1e3),
              tier_ms_per_step=_mean_or_none(fast),
              fallback_ms_per_step=_mean_or_none(slow),
              tier_takes=takes, compact_steps=sum(compact),
              first_boundary_n_uniq=[o[2][0] if o[2] else None
                                     for o in outs],
              first_boundary_instances=3 * B * 11,
              loss_first5=float(losses[:5].mean()),
              loss_last5=float(losses[-5:].mean()),
              max_memory_allocated_mib=peak,
              launches=launches["tgat_train"], profile=prof,
              plain_attention=dict(
                  **attention, device_ms_per_step=busy,
                  share_of_step_device_time=(attention["ms"] / busy
                                             if busy else None)))
    # the first-boundary unique fraction of each of the calibration's four
    # probes (the first batch, and its timestamps shifted to a third, two
    # thirds and the end of the stream), from which it took its ladder
    t_hi, t_b = float(dg.e_ts.max()), float(tb[0].ts.max())
    shifts = [np.float32(0.0)] + [np.float32(q * t_hi - t_b)
                                  for q in (0.33, 0.67, 1.0)]
    tr["calibration_probe_first_boundary_uniq_fracs"] = [
        trainer._probe(dg, tb[0].target_nodes, tb[0].ts + d)[2][0]
        for d in shifts]
    _log("tgat", path="train", **tr)
    # K3's shapes: a padded sample of a batch in the middle of the
    # stream, where histories are long (early batches leave most inner
    # rows without a neighbour)
    mid = _take(full, B, full.dst, PROBE_BATCH)[-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    inner = trainer._sample(gen, dg, torch.from_numpy(mid.target_nodes)
                            .cuda(), torch.from_numpy(mid.ts).cuda())[0][0]
    # K4's: the boundary of the last step of the factor-0.5 path below
    outer = trainer._sample(gen, dg, torch.from_numpy(tb[extra - 1]
                                                      .target_nodes).cuda(),
                            torch.from_numpy(tb[extra - 1].ts).cuda())[1][0]
    del model, trainer, state, outs, rec

    # ---- attention dropout 0, factor 0.5: K3 and its backward run -----
    model, trainer = _tgat(att_dropout=0.0, layer_dedup=0.5)
    state = trainer.init_state(num_nodes, seed=0)
    _reset(kernels)
    bwd0 = attention_autograd.backward_calls
    outs, dev_ms, host_ms = _timed_steps(torch, stepper(trainer, state),
                                         tb[:extra])
    launches["tgat_train_att_dropout0"] = counts()
    att_bwd = attention_autograd.backward_calls - bwd0
    compact = [o[1] for o in outs]
    losses = torch.stack([o[0] for o in outs]).cpu()
    if not bool(torch.isfinite(losses).all()) or sum(compact) < 1:
        raise AssertionError(f"TGAT at att_dropout=0: losses {losses}, "
                             f"steps on the dedup {compact}")
    _check_launches(launches["tgat_train_att_dropout0"],
                    {"gru_memory_fused": 0, "gru_memory_fused_bwd": 0,
                     "neighborhood_attention": 2 * extra,
                     "sorted_segment_sum": sum(compact)},
                    f"{extra} TGAT train steps at att_dropout=0")
    if att_bwd != 2 * extra:
        raise AssertionError(f"K3's backward ran {att_bwd} times in "
                             f"{extra} TGAT steps at att_dropout=0")
    ld = dict(factor=0.5, steps=extra, compact_steps=sum(compact),
              first_boundary_n_uniq=[o[2][0] for o in outs],
              ms_per_step=statistics.mean(dev_ms),
              host_ms_per_step=statistics.mean(host_ms),
              attention_backward_calls=att_bwd, losses=losses.tolist(),
              launches=launches["tgat_train_att_dropout0"])
    _log("tgat", path="layer_dedup_att_dropout0", **ld)
    del model, trainer, state, outs

    # ---- factor 0.01: every step falls back to the padded path --------
    model, trainer = _tgat(layer_dedup=0.01)
    state = trainer.init_state(num_nodes, seed=0)
    _reset(kernels)
    outs, dev_ms, host_ms = _timed_steps(torch, stepper(trainer, state),
                                         tb[:extra])
    launches["tgat_fallback"] = counts()
    compact = [o[1] for o in outs]
    takes = trainer.tier_take_stats(state)
    if any(compact) or takes["fallback_rate"] != 1.0:
        raise AssertionError(f"TGAT at factor 0.01: steps on the dedup "
                             f"{compact}, takes {takes}")
    _check_launches(launches["tgat_fallback"],
                    {"gru_memory_fused": 0, "gru_memory_fused_bwd": 0,
                     "neighborhood_attention": 0, "sorted_segment_sum": 0},
                    f"{extra} TGAT train steps at factor 0.01")
    fb = dict(factor=0.01, steps=extra, tier_takes=takes,
              ms_per_step=statistics.mean(dev_ms),
              host_ms_per_step=statistics.mean(host_ms),
              launches=launches["tgat_fallback"])
    _log("tgat", path="fallback", **fb)
    del model, trainer, state, outs

    # ---- K3 at the inner layer, K4 at the boundary --------------------
    w = dict(device=torch.device("cuda"),
             generator=torch.Generator(device="cuda").manual_seed(1))
    mask = inner.nbr_mask.contiguous()
    k3 = {}
    for name, cdt, rtol, atol in (("bfloat16", torch.bfloat16, 2 ** -6,
                                   1e-5),
                                  ("float32", torch.float32, 1e-5, 1e-5)):
        k3[name] = _kernel_k3(torch, w, mask, cdt, rtol, atol)
        _log("kernels", kernel="neighborhood_attention", dtype=name,
             at="TGAT l0h0", shape=list(mask.shape) + [2, 50], **k3[name])
    (cap,) = tier_caps([0.5], outer.num_all)
    _, _, _, n_uniq, _, seg = dedup_instances(
        outer.all_nodes(), outer.all_ts(), outer.all_mask(), cap)
    k4 = _k4_check(torch, w, seg, cap, int(n_uniq), 100)
    _log("kernels", kernel="sorted_segment_sum", dtype="float32",
         at="TGAT layer boundary", shape=[outer.num_all, 100, cap], **k4)
    rows = {"neighborhood_attention": dict(
                shape=list(mask.shape) + [2, 50], layer="l0h0",
                batch=PROBE_BATCH,
                **{k: v for k, v in k3["bfloat16"].items() if k != "tol"},
                float32=k3["float32"]),
            "sorted_segment_sum": dict(
                shape=[outer.num_all, 100], cap=cap, factor=0.5,
                train_batch=extra,
                **{k: v for k, v in k4.items() if k != "tol"})}
    return dict(launches=launches, rows=rows, eval=ev, train=tr,
                layer_dedup=ld, fallback=fb)


def _dysat(att_dropout=None, device="cuda", **knobs):
    """DySAT as bench.py:127-160 builds it: the REDDIT defaults of the
    config registry (2 layers, fanouts [10, 10], uniform sampling, 3
    snapshots of window 10000 with prop_time, no time encoding, dropout
    and attention dropout 0.1, 2 heads, embedding dim 100, no memory) in
    bf16 compute over f32 parameters, no node input, 172-dim edge
    features, seeded random weights, through ``build_model`` and the
    trainer arguments it returns; ``knobs`` set the trainer's fast
    paths."""
    from gnnflow_tpu_torch.config import get_default_config
    from gnnflow_tpu_torch.models.factory import build_model
    from gnnflow_tpu_torch.train import Trainer
    mc, _ = get_default_config("DySAT", "REDDIT")
    mc["compute_dtype"] = "bfloat16"
    if att_dropout is not None:
        mc["att_dropout"] = att_dropout
    model, kw = build_model("DySAT", mc, 0, 172, seed=0, device=device)
    return model, Trainer(model, lr=1e-4, device=device, **kw, **knobs)


def phase_dysat(torch, kernels, stream):
    """DySAT (``_dysat``) on the REDDIT-shaped stream at batch 4000: eval
    batches on the padded path (K3 six times a batch); train steps with
    the default trainer (the first calibrates the block compaction and
    the snapshot-dedup ladder; K3 never runs at attention dropout 0.1, K4
    three times a step on the snapshot dedup, once per snapshot); steps at
    attention dropout 0 on the snapshot dedup at factor 0.5 (K3 and its
    backward six times a step); steps on the block compaction alone at a
    fixed factor (K4 never); steps at factor 0.01, which fall back (K4
    never); one epoch of the entry script; then K3 at the inner layer's
    padded, block-compact and deduplicated shapes and K4 at the snapshot
    boundary against their plain versions.  Returns the launch counts of
    each path and the kernels' rows."""
    import numpy as np
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.ops.attention_fused import \
        neighborhood_attention_autograd as attention_autograd
    from gnnflow_tpu_torch.ops.dedup import dedup_instances
    from gnnflow_tpu_torch.ops.sampling import (sample_deeper_compact,
                                                sample_layer)
    from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
    from gnnflow_tpu_torch.train import tier_caps
    from gnnflow_tpu_torch.utils import (average_precision_score,
                                         roc_auc_score)
    g, dg, ef, train, full = stream["g"], stream["dg"], stream["ef"], \
        stream["train"], stream["full"]
    num_nodes = g.max_vertex_id() + 1
    B, S, warm, ev_runs, steps, extra = 4000, 3, 3, 10, 20, 5
    padded = dict(compact_factor=None, model_compact=False, layer_dedup=None)
    launches = {}

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    def expect(k3=0, k4=0):
        return {"gru_memory_fused": 0, "gru_memory_fused_bwd": 0,
                "neighborhood_attention": k3, "sorted_segment_sum": k4}

    # ---- eval, padded ---------------------------------------------------
    model, trainer = _dysat(**padded)
    state = trainer.init_state(num_nodes, seed=0)
    ev_batches = _take(full, B, full.dst, warm + ev_runs)
    for b in ev_batches[:warm]:
        trainer.eval_step(state, dg, ef, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    outs, dev_ms, host_ms = _timed_steps(
        torch, lambda b: trainer.eval_step(state, dg, ef, b)[1:],
        ev_batches[warm:])
    launches["dysat_eval"] = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    pos = torch.cat([o[1][:b.num_valid] for o, b in
                     zip(outs, ev_batches[warm:])]).float().cpu().numpy()
    neg = torch.cat([o[2][:b.num_valid] for o, b in
                     zip(outs, ev_batches[warm:])]).float().cpu().numpy()
    losses = torch.stack([o[0] for o in outs]).cpu()
    if not (bool(torch.isfinite(losses).all()) and np.isfinite(pos).all()
            and np.isfinite(neg).all() and len(pos) == ev_runs * B):
        raise AssertionError("DySAT eval: non-finite values or wrong shapes")
    _check_launches(launches["dysat_eval"], expect(k3=2 * S * ev_runs),
                    f"{ev_runs} DySAT eval batches")
    y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    sc = np.concatenate([pos, neg])
    ev = dict(batches=ev_runs, batch_size=B,
              ms_per_batch=statistics.mean(dev_ms),
              host_ms_per_batch=statistics.mean(host_ms),
              edges_per_s=B / (statistics.mean(dev_ms) / 1e3),
              ap=average_precision_score(y, sc), auc=roc_auc_score(y, sc),
              mean_loss=float(losses.mean()),
              max_memory_allocated_mib=peak,
              launches=launches["dysat_eval"],
              profile=_profile(torch,
                               lambda b: trainer.eval_step(state, dg, ef, b),
                               ev_batches[warm:warm + 3]))
    _log("dysat", path="eval", **ev)
    del model, trainer, state, outs

    def stepper(trainer, state):
        """A train step that returns its loss and what its fast paths
        did: boundaries on the snapshot dedup, its unique counts, and
        boundaries on the block compaction."""
        def step(b):
            loss = trainer.train_step(state, dg, ef, b)[1]
            return (loss, state.layer_dedup_compact,
                    state.layer_dedup_n_uniq, state.block_compact)
        return step

    def run_path(name, trainer, state, batches, k3_per_step, k4_per_dedup):
        """Time ``batches`` train steps and check their launches: K3 and
        its backward ``k3_per_step`` times a step, K4 ``k4_per_dedup``
        times a boundary on the snapshot dedup.  Only the default
        trainer calibrates (on its first step)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        bwd0 = attention_autograd.backward_calls
        outs, dev_ms, host_ms = _timed_steps(torch, stepper(trainer, state),
                                             batches)
        launches[name] = counts()
        losses = torch.stack([o[0] for o in outs]).cpu()
        dedup = [o[1] for o in outs]
        blocks = [o[3] for o in outs]
        if not (bool(torch.isfinite(losses).all())
                and all(bool(torch.isfinite(p).all())
                        for p in trainer.model.parameters())):
            raise AssertionError(f"DySAT {name}: a non-finite value")
        _check_launches(launches[name],
                        expect(k3=k3_per_step * len(batches),
                               k4=k4_per_dedup * sum(dedup)),
                        f"{len(batches)} DySAT train steps ({name})")
        att_bwd = attention_autograd.backward_calls - bwd0
        if (trainer.calibration is not None) != (name == "dysat_train"):
            raise AssertionError(f"DySAT {name}: calibration "
                                 f"{trainer.calibration}")
        if att_bwd != k3_per_step * len(batches):
            raise AssertionError(f"K3's backward ran {att_bwd} times in "
                                 f"{len(batches)} DySAT steps ({name})")
        return outs, dev_ms, host_ms, dict(
            steps=len(batches), dedup_steps=sum(1 for d in dedup if d),
            block_compact_steps=sum(1 for c in blocks if c),
            first_boundary_n_uniq_max=[o[2][0] if o[2] else None
                                       for o in outs],
            ms_per_step=statistics.mean(dev_ms),
            host_ms_per_step=statistics.mean(host_ms),
            attention_backward_calls=att_bwd, losses=losses.tolist(),
            max_memory_allocated_mib=torch.cuda.max_memory_allocated()
            / 2 ** 20, launches=launches[name])

    # ---- train, default trainer: the first step calibrates ------------
    tb = _take(train, B, train.dst, steps + 3)
    model, trainer = _dysat()
    state = trainer.init_state(num_nodes, seed=0)
    outs, dev_ms, host_ms, tr = run_path("dysat_train", trainer, state,
                                         tb[:steps], 0, S)
    takes = trainer.tier_take_stats(state)
    if takes["total"] != (steps if trainer.layer_dedup is not None else 0):
        raise AssertionError(f"DySAT tier takes {takes} over {steps} steps")
    prof = _profile(torch, lambda b: trainer.train_step(state, dg, ef, b),
                    tb[steps:steps + 3])
    tr.update(calibration=trainer.calibration, tier_takes=takes,
              first_step_ms=dev_ms[0], first_step_host_ms=host_ms[0],
              ms_per_step=statistics.mean(dev_ms[warm:]),
              host_ms_per_step=statistics.mean(host_ms[warm:]),
              edges_per_s=B / (statistics.mean(dev_ms[warm:]) / 1e3),
              dedup_ms_per_step=_mean_or_none(
                  [t for t, o in zip(dev_ms[1:], outs[1:]) if o[1]]),
              padded_or_blocks_ms_per_step=_mean_or_none(
                  [t for t, o in zip(dev_ms[1:], outs[1:]) if not o[1]]),
              first_boundary_instances=3 * B * 11,
              loss_first5=float(np.mean(tr["losses"][:5])),
              loss_last5=float(np.mean(tr["losses"][-5:])), profile=prof)
    del tr["losses"]
    _log("dysat", path="train", **tr)
    cal_compact = trainer.compact_factor
    del model, trainer, state, outs

    # ---- attention dropout 0 on the snapshot dedup at factor 0.5 ------
    # (every knob set, so that the first step does not calibrate)
    model, trainer = _dysat(att_dropout=0.0, layer_dedup=0.5,
                            compact_factor=None)
    state = trainer.init_state(num_nodes, seed=0)
    *_, d0 = run_path("dysat_dedup_att_dropout0", trainer, state, tb[:extra],
                      2 * S, S)
    d0.update(factor=0.5)
    if d0["dedup_steps"] < 1:
        raise AssertionError(f"DySAT at factor 0.5: no step on the "
                             f"snapshot dedup {d0}")
    _log("dysat", path="snapshot_dedup_att_dropout0", **d0)
    del model, trainer, state

    # ---- the block compaction alone, at a fixed factor ------------------
    # (its packed blocks must hold every snapshot's valid ones: most of
    # the most recent snapshot's blocks are valid)
    cf = 0.9
    model, trainer = _dysat(compact_factor=cf, layer_dedup=None)
    state = trainer.init_state(num_nodes, seed=0)
    *_, bc = run_path("dysat_block_compaction", trainer, state, tb[:extra],
                      0, S)
    bc.update(factor=cf)
    if bc["block_compact_steps"] < 1:
        raise AssertionError(f"DySAT at compact factor {cf}: no step on "
                             f"the block compaction {bc}")
    _log("dysat", path="block_compaction", **bc)
    del model, trainer, state

    # ---- factor 0.01: the snapshot dedup falls back -------------------
    model, trainer = _dysat(layer_dedup=0.01, compact_factor=None)
    state = trainer.init_state(num_nodes, seed=0)
    *_, fb = run_path("dysat_fallback", trainer, state, tb[:extra], 0, S)
    fb.update(factor=0.01, tier_takes=trainer.tier_take_stats(state))
    if fb["dedup_steps"] or fb["tier_takes"]["fallback_rate"] != 1.0:
        raise AssertionError(f"DySAT at factor 0.01: {fb}")
    _log("dysat", path="fallback", **fb)
    del model, trainer, state

    # ---- the entry script, one epoch ----------------------------------
    _reset(kernels)
    t0 = time.perf_counter()
    out = entry.main(["--model", "DySAT", "--data", "SYNTHETIC", "--epoch",
                      "1", "--synthetic-edges", "30000"],
                     checkpoint_path=os.path.join(_build.BUILD_DIR,
                                                  "DySAT_torch.ckpt"))
    torch.cuda.synchronize()
    launches["dysat_entry"] = counts()
    aps = out["val_ap"] + [out["test_ap"]]
    if not all(0.0 < a <= 1.0 for a in aps) \
            or launches["dysat_entry"]["neighborhood_attention"] == 0:
        raise AssertionError(f"DySAT entry: {out}, {launches['dysat_entry']}")
    en = dict(seconds=time.perf_counter() - t0,
              launches=launches["dysat_entry"], **out)
    _log("dysat", path="entry", **en)

    # ---- K3 at l0h*'s shapes, K4 at the snapshot boundary -------------
    # a batch in the middle of the stream, sampled padded
    model, trainer = _dysat(**padded)
    mid = _take(full, B, full.dst, PROBE_BATCH)[-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    roots = torch.from_numpy(mid.target_nodes).cuda()
    ts = torch.from_numpy(mid.ts).cuda()
    mfgs = trainer._sample(gen, dg, roots, ts, compact=False)
    outer, inner = mfgs[1], mfgs[0]
    kw = dict(fanout=10, strategy="uniform", num_snapshots=S,
              window=trainer.window, prop_time=True)
    # the block compaction's packed roots at the tightest cap that fits
    blocks = [int(m.nbr_mask.any(1).sum()) for m in outer]
    cap_b = max(blocks)
    inner_b, _ = sample_deeper_compact(
        dg, outer, cap_b, u=torch.rand(S, 3 * B + cap_b * 10, 10,
                                       generator=gen, device="cuda"), **kw)
    # the snapshot dedup of the most recent snapshot, at the tightest
    # 256-row cap that holds its unique pairs
    o = outer[S - 1]
    _, _, _, n_all, _, _ = dedup_instances(o.all_nodes(), o.all_ts(),
                                           o.all_mask(), o.num_all)
    (cap_d,) = tier_caps([int(n_all) / o.num_all], o.num_all)
    uniq_nid, uniq_ts, _, n_uniq, _, seg = dedup_instances(
        o.all_nodes(), o.all_ts(), o.all_mask(), cap_d)
    slot = torch.arange(cap_d, device="cuda")
    inner_d = sample_layer(
        dg, torch.where(slot < n_uniq, uniq_nid, -1), uniq_ts,
        snapshot_idx=S - 1, u=torch.rand(cap_d, 10, generator=gen,
                                         device="cuda"), **kw)
    del model, trainer
    w = dict(device=torch.device("cuda"),
             generator=torch.Generator(device="cuda").manual_seed(1))
    k3 = {}
    shapes = {"padded": inner[S - 1].nbr_mask,
              "block_compact": inner_b[S - 1].nbr_mask,
              "snapshot_dedup": inner_d.nbr_mask}
    for at, mask in shapes.items():
        dts = (("bfloat16", torch.bfloat16, 2 ** -6, 1e-5),) + (
            (("float32", torch.float32, 1e-5, 1e-5),) if at == "padded"
            else ())
        for name, cdt, rtol, atol in dts:
            k3[(at, name)] = _kernel_k3(torch, w, mask.contiguous(), cdt,
                                        rtol, atol)
            _log("kernels", kernel="neighborhood_attention", dtype=name,
                 at=f"DySAT l0h{S - 1} {at}", shape=list(mask.shape)
                 + [2, 50], **k3[(at, name)])
    k4 = _k4_check(torch, w, seg, cap_d, int(n_uniq), 100)
    _log("kernels", kernel="sorted_segment_sum", dtype="float32",
         at="DySAT snapshot boundary", shape=[o.num_all, 100, cap_d], **k4)
    rows = {"neighborhood_attention": dict(
                layer=f"l0h{S - 1}", batch=PROBE_BATCH,
                valid_fraction_by_snapshot=[
                    float(m.nbr_mask.float().mean()) for m in inner],
                valid_blocks_by_snapshot=blocks, block_cap=cap_b,
                **{at: dict(shape=list(shapes[at].shape) + [2, 50],
                            **{k: v for k, v in k3[(at, "bfloat16")].items()
                               if k != "tol"})
                   for at in shapes},
                float32_padded=k3[("padded", "float32")]),
            "sorted_segment_sum": dict(
                shape=[o.num_all, 100], cap=cap_d, snapshot=S - 1,
                batch=PROBE_BATCH,
                **{k: v for k, v in k4.items() if k != "tol"})}
    return dict(launches=launches, rows=rows, eval=ev, train=tr,
                compact_factor=cal_compact, dedup_att_dropout0=d0,
                block_compaction=bc, fallback=fb, entry=en)


def _apan(att_dropout=None, compute_dtype="bfloat16", device="cuda",
          **knobs):
    """APAN as bench.py:127-160 builds it: the REDDIT defaults of the
    config registry (1 layer, fanout 10, recent sampling, memory, time and
    embedding dims 100, 2 heads, the transformer memory updater over 10
    mail slots, dropout and attention dropout 0.1) in bf16 compute over f32
    parameters, no node input, 172-dim edge features, seeded random
    weights, through ``build_model`` and the trainer arguments it returns;
    ``knobs`` set the trainer's fast paths."""
    from gnnflow_tpu_torch.config import get_default_config
    from gnnflow_tpu_torch.models.factory import build_model
    from gnnflow_tpu_torch.train import Trainer
    mc, _ = get_default_config("APAN", "REDDIT")
    mc["compute_dtype"] = compute_dtype
    if att_dropout is not None:
        mc["att_dropout"] = att_dropout
    model, kw = build_model("APAN", mc, 0, 172, seed=0, device=device)
    return model, Trainer(model, lr=1e-4, device=device, **kw, **knobs)


def phase_apan(torch, kernels, stream):
    """APAN (``_apan``) on the REDDIT-shaped stream at batch 4000: eval
    batches on the table pull (K3 once a batch); train steps with the
    default trainer (the first calibrates the memory dedup; K3 never runs
    at attention dropout 0.1, K4 once a step on the dedup); steps at
    attention dropout 0 on the dedup at factor 0.6 (K3 and its backward
    once a step); steps at factor 0.01, which fall back (K4 never); one f32
    train step of the per-instance pull against the table pull from one
    state; one epoch of the entry script; the profiler's device time of
    the table pull, its kernel gradient and the updater's attention; then
    K3 at the embedding layer's eval shape and K4 at the memory dedup's
    boundary against their plain versions.  Returns the launch counts of
    each path and the kernels' rows."""
    import numpy as np
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.ops.apan_kv import apan_table_pull
    from gnnflow_tpu_torch.ops.attention_fused import \
        neighborhood_attention_autograd as attention_autograd
    from gnnflow_tpu_torch.ops.dedup import dedup_instances
    from gnnflow_tpu_torch.ops.sampling import sample_hops
    from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
    from gnnflow_tpu_torch.train import dedup_cap
    from gnnflow_tpu_torch.utils import (average_precision_score,
                                         roc_auc_score)
    g, dg, ef, train, full = stream["g"], stream["dg"], stream["ef"], \
        stream["train"], stream["full"]
    num_nodes = g.max_vertex_id() + 1
    B, warm, ev_runs, steps, extra = 4000, 3, 10, 20, 5
    num_all = 3 * B * 11
    launches = {}

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    def expect(k3=0, k4=0):
        return {"gru_memory_fused": 0, "gru_memory_fused_bwd": 0,
                "neighborhood_attention": k3, "sorted_segment_sum": k4}

    def finite(trainer, state):
        mem = state.memory
        return all(bool(torch.isfinite(t).all()) for t in (
            mem.node_memory, mem.mailbox, *trainer.model.parameters()))

    # ---- eval: the default trainer before any train step (table pull) --
    model, trainer = _apan()
    state = trainer.init_state(num_nodes, seed=0)
    ev_batches = _take(full, B, full.dst, warm + ev_runs)
    for b in ev_batches[:warm]:
        trainer.eval_step(state, dg, ef, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    outs, dev_ms, host_ms = _timed_steps(
        torch, lambda b: trainer.eval_step(state, dg, ef, b)[1:],
        ev_batches[warm:])
    launches["apan_eval"] = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    pos = torch.cat([o[1][:b.num_valid] for o, b in
                     zip(outs, ev_batches[warm:])]).float().cpu().numpy()
    neg = torch.cat([o[2][:b.num_valid] for o, b in
                     zip(outs, ev_batches[warm:])]).float().cpu().numpy()
    losses = torch.stack([o[0] for o in outs]).cpu()
    if not (bool(torch.isfinite(losses).all()) and np.isfinite(pos).all()
            and np.isfinite(neg).all() and len(pos) == ev_runs * B
            and finite(trainer, state)):
        raise AssertionError("APAN eval: non-finite values or wrong shapes")
    _check_launches(launches["apan_eval"], expect(k3=ev_runs),
                    f"{ev_runs} APAN eval batches")
    y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    sc = np.concatenate([pos, neg])
    ptr = state.memory.mailbox_ptr
    ev = dict(batches=ev_runs, batch_size=B,
              ms_per_batch=statistics.mean(dev_ms),
              host_ms_per_batch=statistics.mean(host_ms),
              edges_per_s=B / (statistics.mean(dev_ms) / 1e3),
              ap=average_precision_score(y, sc), auc=roc_auc_score(y, sc),
              mean_loss=float(losses.mean()),
              max_memory_allocated_mib=peak,
              mailbox_ptr_max=int(ptr.max()),
              nodes_with_full_mailbox=int((ptr >= 10).sum()),
              launches=launches["apan_eval"],
              profile=_profile(torch,
                               lambda b: trainer.eval_step(state, dg, ef, b),
                               ev_batches[warm:warm + 3]))
    _log("apan", path="eval", **ev)
    # the memory after eval feeds the device timings below
    ev_model, ev_memory = model, state.memory
    del trainer, state, outs

    def run_path(name, trainer, state, batches, k3_per_step):
        """Time ``batches`` train steps and check their launches: K3 and
        its backward ``k3_per_step`` times a step, K4 once a step on the
        dedup.  Only the default trainer calibrates (on its first
        step)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        bwd0 = attention_autograd.backward_calls

        def step(b):
            loss = trainer.train_step(state, dg, ef, b)[1]
            return loss, state.dedup_n_uniq
        outs, dev_ms, host_ms = _timed_steps(torch, step, batches)
        launches[name] = counts()
        att_bwd = attention_autograd.backward_calls - bwd0
        losses = torch.stack([o[0] for o in outs]).cpu()
        factor = trainer.dedup_factor
        cap = dedup_cap(factor, num_all) if factor else None
        n_uniq = [o[1] for o in outs]
        fast = [n is not None and n <= cap for n in n_uniq]
        if not (bool(torch.isfinite(losses).all())
                and finite(trainer, state)):
            raise AssertionError(f"APAN {name}: a non-finite value")
        _check_launches(launches[name],
                        expect(k3=k3_per_step * len(batches), k4=sum(fast)),
                        f"{len(batches)} APAN train steps ({name})")
        if att_bwd != k3_per_step * len(batches):
            raise AssertionError(f"K3's backward ran {att_bwd} times in "
                                 f"{len(batches)} APAN steps ({name})")
        if (trainer.calibration is not None) != (name == "apan_train"):
            raise AssertionError(f"APAN {name}: calibration "
                                 f"{trainer.calibration}")
        # the default trainer's first steps (calibration, warm-up) out
        skip = warm if name == "apan_train" else 0
        return dev_ms, host_ms, dict(
            steps=len(batches), dedup_factor=factor, cap=cap,
            fast_steps=sum(fast), fallback_steps=len(batches) - sum(fast),
            n_uniq=n_uniq, ms_per_step=statistics.mean(dev_ms[skip:]),
            host_ms_per_step=statistics.mean(host_ms[skip:]),
            fast_ms_per_step=_mean_or_none(
                [t for t, f in zip(dev_ms[skip:], fast[skip:]) if f]),
            fallback_ms_per_step=_mean_or_none(
                [t for t, f in zip(dev_ms[skip:], fast[skip:]) if not f]),
            attention_backward_calls=att_bwd, losses=losses.tolist(),
            max_memory_allocated_mib=torch.cuda.max_memory_allocated()
            / 2 ** 20, launches=launches[name])

    # ---- train, default trainer: the first step calibrates ------------
    tb = _take(train, B, train.dst, steps + 3)
    model, trainer = _apan()
    state = trainer.init_state(num_nodes, seed=0)
    dev_ms, host_ms, tr = run_path("apan_train", trainer, state, tb[:steps],
                                   0)
    cal = trainer.calibration
    prof = _profile(torch, lambda b: trainer.train_step(state, dg, ef, b),
                    tb[steps:steps + 3])
    # the unique fraction of each of the calibration's four probes (the
    # first batch, and its timestamps shifted to a third, two thirds and
    # the end of the stream), the worst of which sets the factor
    t_hi, t_b = float(dg.e_ts.max()), float(tb[0].ts.max())
    shifts = [np.float32(0.0)] + [np.float32(q * t_hi - t_b)
                                  for q in (0.33, 0.67, 1.0)]
    tr.update(
        calibration=cal, calibrated_uniq_frac=cal["uniq_frac"],
        calibration_probe_uniq_fracs=[
            trainer._probe(dg, tb[0].target_nodes, tb[0].ts + d)[1]
            for d in shifts],
        dedup_left_off=(None if trainer.dedup_factor else
                        f"the worst probe's unique fraction "
                        f"{cal['uniq_frac']} is above the transformer's "
                        f"0.5 gate"),
        first_step_ms=dev_ms[0], first_step_host_ms=host_ms[0],
        edges_per_s=B / (statistics.mean(dev_ms[warm:]) / 1e3),
        loss_first5=float(np.mean(tr["losses"][:5])),
        loss_last5=float(np.mean(tr["losses"][-5:])), profile=prof)
    del tr["losses"]
    _log("apan", path="train", **tr)
    busy = prof["device_busy_ms_per_batch"] if isinstance(prof, dict) \
        else None
    cal_factor = trainer.dedup_factor
    del model, trainer, state

    # ---- attention dropout 0 on the dedup at factor 0.6 ---------------
    model, trainer = _apan(att_dropout=0.0, dedup_factor=0.6)
    state = trainer.init_state(num_nodes, seed=0)
    *_, d0 = run_path("apan_dedup_att_dropout0", trainer, state, tb[:extra],
                      1)
    if d0["fast_steps"] < 1:
        raise AssertionError(f"APAN at factor 0.6: no step on the dedup "
                             f"{d0}")
    _log("apan", path="dedup_att_dropout0", **d0)
    del model, trainer, state

    # ---- factor 0.01: every step falls back ----------------------------
    model, trainer = _apan(dedup_factor=0.01)
    state = trainer.init_state(num_nodes, seed=0)
    *_, fb = run_path("apan_fallback", trainer, state, tb[:extra], 0)
    if fb["fast_steps"]:
        raise AssertionError(f"APAN at factor 0.01: {fb}")
    _log("apan", path="fallback", **fb)
    del model, trainer, state

    # ---- the per-instance pull against the table pull, f32 -----------
    # one train step of each from one state (parameters, Adam moments,
    # memory with every slot and cursor, the dropout generator's state)
    runs = {}
    for nm, table in (("table", True), ("per_instance", False)):
        m, t = _apan(compute_dtype=None, dedup_factor=None, apan_table=table)
        runs[nm] = dict(model=m, tr=t, st=t.init_state(num_nodes, seed=0))
    for b in tb[:3]:
        runs["table"]["tr"].train_step(runs["table"]["st"], dg, ef, b)
    runs["per_instance"]["tr"].train_step(runs["per_instance"]["st"], dg, ef,
                                          tb[0])
    _copy_train_state(runs["table"], runs["per_instance"])
    runs["per_instance"]["st"].dropout_gen.set_state(
        runs["table"]["st"].dropout_gen.get_state())
    for r in runs.values():
        _, loss, _, _ = r["tr"].train_step(r["st"], dg, ef, tb[3])
        r["trace"] = [dict(
            loss=loss.cpu(),
            grad=[q.grad.cpu() for q in r["model"].parameters()],
            param=[q.detach().cpu().clone()
                   for q in r["model"].parameters()],
            memory=torch.cat([r["st"].memory.node_memory,
                              r["st"].memory.mailbox.flatten(1)], 1).cpu())]
    pnames = [nm for nm, _ in runs["table"]["model"].named_parameters()]
    errs, worst = _trace_errs(runs["table"]["trace"],
                              runs["per_instance"]["trace"], pnames)
    tt = dict(loss=1e-4, grad=1e-4, param=1e-5, memory=1e-4)
    same_ts = all(bool(torch.equal(getattr(runs["table"]["st"].memory, f),
                                   getattr(runs["per_instance"]["st"].memory,
                                           f)))
                  for f in ("node_memory_ts", "mailbox_ts", "mailbox_ptr"))
    tvp = dict(dtype="float32", step=4,
               apan_table={nm: r["tr"].apan_table for nm, r in runs.items()},
               per_step_max_err=errs,
               worst_grad_parameter=worst, tol=tt,
               timestamps_and_cursors_equal=same_ts)
    _log("apan", path="table_vs_per_instance", **tvp)
    if not (all(max(errs[k]) <= tt[k] for k in tt) and same_ts):
        raise AssertionError(f"APAN table vs per-instance pull: {tvp}")
    del runs

    # ---- the entry script, one epoch -----------------------------------
    _reset(kernels)
    t0 = time.perf_counter()
    out = entry.main(["--model", "APAN", "--data", "SYNTHETIC", "--epoch",
                      "1"], checkpoint_path=os.path.join(
                          _build.BUILD_DIR, "APAN_torch.ckpt"))
    torch.cuda.synchronize()
    launches["apan_entry"] = counts()
    aps = out["val_ap"] + [out["test_ap"]]
    if not all(0.0 < a <= 1.0 for a in aps) \
            or launches["apan_entry"]["neighborhood_attention"] == 0:
        raise AssertionError(f"APAN entry: {out}, {launches['apan_entry']}")
    en = dict(seconds=time.perf_counter() - t0,
              launches=launches["apan_entry"], **out)
    _log("apan", path="entry", **en)

    # ---- the table pull, its kernel gradient and the attention --------
    # on the memory the eval batches left and a mid-stream batch's
    # instances: all 132,000 (eval, the per-step path without the dedup)
    # and the dedup's unique pairs at the calibrated factor (or 0.6)
    mid = _take(full, B, full.dst, PROBE_BATCH)[-1]
    m = sample_hops(dg, torch.from_numpy(mid.target_nodes).cuda(),
                    torch.from_numpy(mid.ts).cuda(), fanouts=[10])[0][0]
    L = m.num_all
    fac = cal_factor or 0.6
    cap = dedup_cap(fac, L)
    uniq_nid, uniq_ts, _, n_uniq, _, seg = dedup_instances(
        m.all_nodes(), m.all_ts(), m.all_mask(), cap)
    if int(n_uniq) > cap:                  # the tightest cap that holds it
        cap = dedup_cap(int(n_uniq) / L, L)
        uniq_nid, uniq_ts, _, n_uniq, _, seg = dedup_instances(
            m.all_nodes(), m.all_ts(), m.all_mask(), cap)
    upd = ev_model.updater
    mem = ev_memory
    dr = upd.dim_raw
    kern = upd.w_kv.kernel.detach()[:dr].clone().requires_grad_()
    parts = {}
    for at, nids in (("instances", m.all_nodes()), ("dedup", uniq_nid)):
        nids = nids.clamp(0, mem.num_nodes - 1)
        pull = (mem.node_memory, mem.mailbox, mem.mailbox_ts)
        fwd = device_ms(torch, [lambda: apan_table_pull(
            *pull, kern.detach(), nids, torch.bfloat16)], iters=6)
        mem_i, kv_i, _ = apan_table_pull(*pull, kern, nids, torch.bfloat16)
        d_kv = torch.randn_like(kv_i)
        dw = device_ms(torch, [lambda: torch.autograd.grad(
            kv_i, kern, d_kv, retain_graph=True)], iters=6)
        kv_r = kv_i.detach().requires_grad_()
        d_out = torch.randn(mem_i.shape, device="cuda")
        att_fwd = device_ms(torch, [lambda: upd.attend(mem_i.detach(),
                                                       kv_r)], iters=6)

        def att_both():
            torch.autograd.backward(upd.attend(mem_i.detach(), kv_r), d_out)
        att = device_ms(torch, [att_both], iters=6)
        parts[at] = dict(rows=int(nids.shape[0]), table_pull_fwd_ms=fwd,
                         table_pull_dw_ms=dw, attention_fwd_ms=att_fwd,
                         attention_fwd_bwd_ms=att)
        del mem_i, kv_i, d_kv, kv_r
    parts.update(
        note="profiler device time; bf16 compute, S 10, dim_raw 372, "
             "K/V width 200; table pull over 10,984 nodes x 10 slots",
        default_train_device_busy_ms_per_step=busy, dedup_factor=fac)
    _log("apan", path="updater_parts", **parts)
    del ev_model, ev_memory, upd, kern

    # ---- K3 at l0h0's eval shape, K4 at the memory dedup's boundary --
    w = dict(device=torch.device("cuda"),
             generator=torch.Generator(device="cuda").manual_seed(1))
    mask = m.nbr_mask.contiguous()
    k3 = _kernel_k3(torch, w, mask, torch.bfloat16, 2 ** -6, 1e-5)
    _log("kernels", kernel="neighborhood_attention", dtype="bfloat16",
         at="APAN l0h0 eval", shape=list(mask.shape) + [2, 50], **k3)
    k4 = _k4_check(torch, w, seg, cap, int(n_uniq), 100)
    _log("kernels", kernel="sorted_segment_sum", dtype="float32",
         at="APAN memory dedup", shape=[L, 100, cap], **k4)
    rows = {"neighborhood_attention": dict(
                shape=list(mask.shape) + [2, 50], layer="l0h0",
                batch=PROBE_BATCH,
                **{k: v for k, v in k3.items() if k != "tol"}),
            "sorted_segment_sum": dict(
                shape=[L, 100], cap=cap, factor=fac, batch=PROBE_BATCH,
                **{k: v for k, v in k4.items() if k != "tol"})}
    return dict(launches=launches, rows=rows, eval=ev, train=tr,
                dedup_att_dropout0=d0, fallback=fb,
                table_vs_per_instance=tvp, entry=en, updater_parts=parts)


STATIC_FACTOR = 0.95    # the layer dedup's set factor in phase_static


def _static(name, layer_dedup="auto", device="cuda", **overrides):
    """GraphSAGE or GAT as bench.py:127-160 builds them: the REDDIT
    defaults of the config registry (GraphSAGE: 2 layers, fanouts [15, 10],
    the mean aggregator; GAT: 2 layers, fanouts [10, 10], heads (2, 1),
    dropout and attention dropout 0.1; both uniform sampling at the static
    timestamp, embedding width 100) in bf16 compute over f32 parameters,
    the stream's 128-dim node features, seeded random weights, through
    ``build_model`` and the trainer arguments it returns."""
    from gnnflow_tpu_torch.config import get_default_config
    from gnnflow_tpu_torch.models.factory import build_model
    from gnnflow_tpu_torch.train import Trainer
    mc, _ = get_default_config(name, "REDDIT")
    mc.update({"compute_dtype": "bfloat16", **overrides})
    model, kw = build_model(name, mc, 128, 172, seed=0, device=device)
    return model, Trainer(model, lr=1e-4, layer_dedup=layer_dedup,
                          device=device, **kw)


def phase_static(torch, kernels, stream):
    """GraphSAGE and GAT (``_static``) on the REDDIT-shaped stream at
    batch 4000, each: eval batches on the padded path (no kernel), train
    steps with the default trainer (the first calibrates the layer-dedup
    ladder; K4 once a step that takes a tier), steps on the layer dedup at
    the set factor ``STATIC_FACTOR`` (K4 once a step that fits), steps at
    factor 0.01 (every step falls back, K4 never) and one epoch of the
    entry script; then K4 at each model's layer boundary (GraphSAGE L
    192,000, D 100; GAT L 132,000, D 200, the two heads' flat output)
    against its plain version.  Returns the launch counts of each path
    and K4's rows."""
    import numpy as np
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.ops.dedup import dedup_instances
    from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
    from gnnflow_tpu_torch.train import STATIC_SAMPLE_TS, tier_caps
    from gnnflow_tpu_torch.utils import (average_precision_score,
                                         roc_auc_score)
    g, dg, ef, nf, train, full = stream["g"], stream["dg"], stream["ef"], \
        stream["nf"], stream["train"], stream["full"]
    num_nodes = g.max_vertex_id() + 1
    B, warm, ev_runs, steps, extra = 4000, 3, 10, 20, 5
    launches, out, k4_rows = {}, {}, {}

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    def expect(k4):
        return {"gru_memory_fused": 0, "gru_memory_fused_bwd": 0,
                "neighborhood_attention": 0, "sorted_segment_sum": k4}

    def stepper(trainer, state):
        def step(b):
            loss = trainer.train_step(state, dg, ef, b, node_feats=nf)[1]
            return loss, state.layer_dedup_compact, state.layer_dedup_n_uniq
        return step

    def finite(model, losses):
        return bool(torch.isfinite(losses).all()) and all(
            bool(torch.isfinite(p).all()) for p in model.parameters())

    ev_batches = _take(full, B, full.dst, warm + ev_runs)
    tb = _take(train, B, train.dst, steps + 3)
    for name in ("GRAPHSAGE", "GAT"):
        key = name.lower()
        res = {}
        # ---- eval: the default trainer before any train step, padded --
        model, trainer = _static(name)
        state = trainer.init_state(num_nodes, seed=0)
        for b in ev_batches[:warm]:
            trainer.eval_step(state, dg, ef, b, node_feats=nf)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        outs, dev_ms, host_ms = _timed_steps(
            torch, lambda b: trainer.eval_step(state, dg, ef, b,
                                               node_feats=nf)[1:],
            ev_batches[warm:])
        launches[f"{key}_eval"] = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        pos = torch.cat([o[1][:b.num_valid] for o, b in
                         zip(outs, ev_batches[warm:])]).float().cpu().numpy()
        neg = torch.cat([o[2][:b.num_valid] for o, b in
                         zip(outs, ev_batches[warm:])]).float().cpu().numpy()
        losses = torch.stack([o[0] for o in outs]).cpu()
        if not (bool(torch.isfinite(losses).all()) and np.isfinite(pos).all()
                and np.isfinite(neg).all() and len(pos) == ev_runs * B):
            raise AssertionError(f"{name} eval: non-finite values or wrong "
                                 f"shapes")
        _check_launches(launches[f"{key}_eval"], expect(0),
                        f"{ev_runs} {name} eval batches")
        y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        sc = np.concatenate([pos, neg])
        res["eval"] = dict(
            batches=ev_runs, batch_size=B,
            ms_per_batch=statistics.mean(dev_ms),
            host_ms_per_batch=statistics.mean(host_ms),
            edges_per_s=B / (statistics.mean(dev_ms) / 1e3),
            ap=average_precision_score(y, sc), auc=roc_auc_score(y, sc),
            mean_loss=float(losses.mean()), max_memory_allocated_mib=peak,
            launches=launches[f"{key}_eval"],
            profile=_profile(torch, lambda b: trainer.eval_step(
                state, dg, ef, b, node_feats=nf), ev_batches[warm:warm + 3]))
        _log("static", model=name, path="eval", **res["eval"])
        del model, trainer, state, outs

        # ---- train, default trainer: the first step calibrates --------
        model, trainer = _static(name)
        state = trainer.init_state(num_nodes, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        outs, dev_ms, host_ms = _timed_steps(torch, stepper(trainer, state),
                                             tb[:steps])
        launches[f"{key}_train"] = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = torch.stack([o[0] for o in outs]).cpu()
        compact = [o[1] for o in outs]
        takes = trainer.tier_take_stats(state)
        if not finite(model, losses):
            raise AssertionError(f"{name} training produced a non-finite "
                                 f"value")
        if takes["total"] != (steps if trainer.layer_dedup is not None
                              else 0):
            raise AssertionError(f"{name} tier takes {takes} over {steps} "
                                 f"steps")
        _check_launches(launches[f"{key}_train"], expect(sum(compact)),
                        f"{steps} {name} train steps")
        # the first-boundary unique fraction of each of the calibration's
        # four probes (static: all four are the first batch at 3.4e38)
        t_hi, t_b = float(dg.e_ts.max()), float(tb[0].ts.max())
        shifts = [np.float32(0.0)] + [np.float32(q * t_hi - t_b)
                                      for q in (0.33, 0.67, 1.0)]
        probe_fracs = [trainer._probe(dg, tb[0].target_nodes,
                                      tb[0].ts + d)[2][0] for d in shifts]
        prof = _profile(torch, lambda b: trainer.train_step(
            state, dg, ef, b, node_feats=nf), tb[steps:steps + 3])
        fast = [t for t, c in zip(dev_ms, compact) if c]
        slow = [t for t, c in zip(dev_ms, compact) if not c]
        res["train"] = dict(
            steps=steps, batch_size=B, calibration=trainer.calibration,
            calibration_probe_first_boundary_uniq_fracs=probe_fracs,
            ladder=trainer.layer_dedup, first_step_ms=dev_ms[0],
            first_step_host_ms=host_ms[0],
            ms_per_step=statistics.mean(dev_ms[warm:]),
            host_ms_per_step=statistics.mean(host_ms[warm:]),
            edges_per_s=B / (statistics.mean(dev_ms[warm:]) / 1e3),
            tier_ms_per_step=_mean_or_none(fast),
            fallback_ms_per_step=_mean_or_none(slow),
            tier_takes=takes, compact_steps=sum(compact),
            first_boundary_n_uniq=[o[2][0] if o[2] else None for o in outs],
            loss_first5=float(losses[:5].mean()),
            loss_last5=float(losses[-5:].mean()),
            max_memory_allocated_mib=peak,
            launches=launches[f"{key}_train"], profile=prof)
        _log("static", model=name, path="train", **res["train"])
        # K4's boundary: the outer layer of the last batch of the
        # set-factor path below, sampled at the static timestamp
        gen = torch.Generator(device="cuda").manual_seed(0)
        b = tb[extra - 1]
        outer = trainer._sample(gen, dg, torch.from_numpy(b.target_nodes)
                                .cuda(), torch.full((len(b.ts),),
                                                    STATIC_SAMPLE_TS,
                                                    device="cuda"))[1][0]
        del model, trainer, state, outs

        # ---- the layer dedup at the set factor: K4 once a fast step ---
        model, trainer = _static(name, layer_dedup=STATIC_FACTOR)
        state = trainer.init_state(num_nodes, seed=0)
        _reset(kernels)
        outs, dev_ms, host_ms = _timed_steps(torch, stepper(trainer, state),
                                             tb[:extra])
        launches[f"{key}_layer_dedup"] = counts()
        compact = [o[1] for o in outs]
        losses = torch.stack([o[0] for o in outs]).cpu()
        if not finite(model, losses) or sum(compact) < 1:
            raise AssertionError(f"{name} at factor {STATIC_FACTOR}: losses "
                                 f"{losses}, steps on the dedup {compact}")
        _check_launches(launches[f"{key}_layer_dedup"], expect(sum(compact)),
                        f"{extra} {name} train steps at factor "
                        f"{STATIC_FACTOR}")
        res["layer_dedup"] = dict(
            factor=STATIC_FACTOR, steps=extra, compact_steps=sum(compact),
            first_boundary_n_uniq=[o[2][0] for o in outs],
            first_boundary_instances=outer.num_all,
            ms_per_step=statistics.mean(dev_ms),
            host_ms_per_step=statistics.mean(host_ms),
            losses=losses.tolist(), launches=launches[f"{key}_layer_dedup"])
        _log("static", model=name, path="layer_dedup", **res["layer_dedup"])
        del model, trainer, state, outs

        # ---- factor 0.01: every step falls back to the padded path ----
        model, trainer = _static(name, layer_dedup=0.01)
        state = trainer.init_state(num_nodes, seed=0)
        _reset(kernels)
        outs, dev_ms, host_ms = _timed_steps(torch, stepper(trainer, state),
                                             tb[:extra])
        launches[f"{key}_fallback"] = counts()
        compact = [o[1] for o in outs]
        takes = trainer.tier_take_stats(state)
        if any(compact) or takes["fallback_rate"] != 1.0:
            raise AssertionError(f"{name} at factor 0.01: steps on the dedup "
                                 f"{compact}, takes {takes}")
        _check_launches(launches[f"{key}_fallback"], expect(0),
                        f"{extra} {name} train steps at factor 0.01")
        res["fallback"] = dict(factor=0.01, steps=extra, tier_takes=takes,
                               ms_per_step=statistics.mean(dev_ms),
                               host_ms_per_step=statistics.mean(host_ms),
                               launches=launches[f"{key}_fallback"])
        _log("static", model=name, path="fallback", **res["fallback"])
        del model, trainer, state, outs

        # ---- the entry script, one epoch ------------------------------
        _reset(kernels)
        t0 = time.perf_counter()
        en = entry.main(["--model", name, "--data", "SYNTHETIC", "--epoch",
                         "1"], checkpoint_path=os.path.join(
                             _build.BUILD_DIR, f"{name}_torch.ckpt"))
        torch.cuda.synchronize()
        launches[f"{key}_entry"] = counts()
        aps = en["val_ap"] + [en["test_ap"]]
        if not all(0.0 < a <= 1.0 for a in aps):
            raise AssertionError(f"{name} entry: {en}")
        res["entry"] = dict(seconds=time.perf_counter() - t0,
                            launches=launches[f"{key}_entry"], **en)
        _log("static", model=name, path="entry", **res["entry"])

        # ---- K4 at the layer boundary ---------------------------------
        D = 100 * (2 if name == "GAT" else 1)
        (cap,) = tier_caps([STATIC_FACTOR], outer.num_all)
        _, _, _, n_uniq, _, seg = dedup_instances(
            outer.all_nodes(), outer.all_ts(), outer.all_mask(), cap)
        w = dict(device=torch.device("cuda"),
                 generator=torch.Generator(device="cuda").manual_seed(1))
        k4 = _k4_check(torch, w, seg, cap, int(n_uniq), D)
        _log("kernels", kernel="sorted_segment_sum", dtype="float32",
             at=f"{name} layer boundary", shape=[outer.num_all, D, cap], **k4)
        k4_rows[key] = dict(shape=[outer.num_all, D], cap=cap,
                            factor=STATIC_FACTOR, train_batch=extra,
                            **{k: v for k, v in k4.items() if k != "tol"})
        out[key] = res
    return dict(launches=launches, rows={"sorted_segment_sum": k4_rows},
                **out)


ONLINE_STEPS, RETRAIN_EVERY = 50, 10


def _launches_by_method(kernels, cls, names):
    """Wrap ``cls``'s methods ``names`` so that each call adds the kernel
    launches made inside it to that method's counts (from 0); returns the
    counts and a function that puts the methods back."""
    counts = {n: {k: 0 for k in kernels} for n in names}
    orig = {n: getattr(cls, n) for n in names}

    def wrap(name):
        fn = orig[name]

        def run(*args, **kwargs):
            before = {k: f.launches for k, f in kernels.items()}
            try:
                return fn(*args, **kwargs)
            finally:
                for k, f in kernels.items():
                    counts[name][k] += f.launches - before[k]
        return run

    for n in names:
        setattr(cls, n, wrap(n))
    return counts, lambda: [setattr(cls, n, f) for n, f in orig.items()]


def _online_dataset():
    """The REDDIT-shaped stream of bench.py:221-227 without node features
    (as bench.py:262-267 runs TGN), written by ``write_synthetic_dataset``
    under ``build/``: ``(data_dir, edges)``."""
    from gnnflow_tpu_torch.data import load_dataset, write_synthetic_dataset
    from gnnflow_tpu_torch.ops import _build
    data_dir = os.path.join(_build.BUILD_DIR, "online_data")
    write_synthetic_dataset(os.path.join(data_dir, "REDDIT"),
                            num_src=10_000, num_dst=984, num_edges=672_447,
                            dim_edge=172, seed=42, time_scale=4.0)
    return data_dir, load_dataset("REDDIT", data_dir)


def phase_online(torch, kernels):
    """TGN served online through the port's online script at the REDDIT
    defaults (batch 4000, memory, time and embedding dims 100, 2 heads,
    fanout 10 recent, 172-dim edge features, bf16 compute): phase 1 on 30%
    of the stream, then 50 chunks scored prequentially, each ingested,
    and every 10th followed by the sliding window's eviction (a quarter
    of the stream's time span) and replay retraining. Then a second call
    that resumes from the phase-1 checkpoint."""
    import numpy as np
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.scripts import online_edge_prediction as online
    from gnnflow_tpu_torch.train import Trainer
    t0 = time.perf_counter()
    data_dir, (_, _, test, full) = _online_dataset()
    write_s = time.perf_counter() - t0
    window = float(full.time[-1] - full.time[0]) / 4
    ckpt = os.path.join(_build.BUILD_DIR, "TGN_torch_online_phase1.ckpt")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    base = ["--model", "TGN", "--data", "REDDIT", "--data-dir", data_dir,
            "--epoch", "1", "--phase2-steps", str(ONLINE_STEPS),
            "--compute-dtype", "bfloat16"]
    argv = base + ["--retrain-interval", str(RETRAIN_EVERY),
                   "--time-window", repr(window)]
    _reset(kernels)
    counts, restore = _launches_by_method(kernels, Trainer,
                                          ["eval_step", "train_step"])
    try:
        t0 = time.perf_counter()
        out = online.main(argv, checkpoint_path=ckpt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        restore()
    launches = {"online_eval": counts["eval_step"],
                "online_retrain": counts["train_step"]}
    scores = out["aps"] + out["aucs"]
    chunk = (len(full) - int(0.3 * len(full))) // ONLINE_STEPS
    n_eval = -(-chunk // min(4000, max(256, chunk)))
    bad = []
    if len(out["aps"]) != ONLINE_STEPS or not all(
            np.isfinite(x) and 0.0 < x <= 1.0 for x in scores):
        bad.append(f"APs/AUCs {scores}")
    if not out["evicted"] or out["evicted"][0] <= 0:
        bad.append(f"evicted {out['evicted']}")
    if out["uploads"] != out["store_changes"] + 1:
        bad.append(f"{out['uploads']} device views for "
                   f"{out['store_changes']} store changes")
    ev, tr = launches["online_eval"], launches["online_retrain"]
    if not (ev["gru_memory_fused"] and ev["neighborhood_attention"]
            and tr["gru_memory_fused"] and tr["gru_memory_fused_bwd"]):
        bad.append(f"launches {launches}")
    if bad:
        raise AssertionError(f"online: {bad}")

    mean = statistics.mean
    res = dict(seconds=seconds, dataset_write_s=write_s, window=window,
               phase1_s=out["phase1_s"], chunks=len(out["aps"]),
               eval_batches_per_chunk=n_eval,
               eval_ms_per_batch=mean(out["eval_ms"]),
               ingest_ms=mean(out["ingest_ms"]),
               refresh_ms=mean(out["refresh_ms"]),
               evict_ms=out["evict_ms"], evicted=out["evicted"],
               retrain_ms_per_step=out["retrain_ms"],
               mean_ap=mean(out["aps"]), mean_auc=mean(out["aucs"]),
               uploads=out["uploads"], store_changes=out["store_changes"],
               launches=launches,
               per_chunk=dict(eval_ms_per_batch=out["eval_ms"],
                              ingest_ms=out["ingest_ms"], ap=out["aps"],
                              auc=out["aucs"]))
    _log("online", **res)

    # the second call resumes from the checkpoint: no phase 1
    t0 = time.perf_counter()
    again = online.main(base + ["--retrain-interval", "0"],
                        checkpoint_path=ckpt)
    torch.cuda.synchronize()
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
    same = all(torch.equal(again["params"][k].cpu(), v)
               for k, v in saved.items())
    if not (again["resumed"] and again["phase1_s"] == 0 and same):
        raise AssertionError(f"online resume: resumed {again['resumed']}, "
                             f"parameters equal {same}")
    res["resume"] = dict(seconds=time.perf_counter() - t0,
                         resumed=again["resumed"],
                         params_equal_checkpoint=same,
                         mean_ap=mean(again["aps"]),
                         eval_ms_per_batch=mean(again["eval_ms"]))
    _log("online", path="resume", **res["resume"])
    return dict(res, data_dir=data_dir, ckpt=ckpt, test=test)


def phase_inference(torch, kernels, on):
    """The port's inference script on the online phase's dataset: TGN
    from the phase-1 checkpoint with its embeddings dumped; then DySAT
    (REDDIT defaults, bf16, batch 4000) from random init over the windows
    0 (the config's 10000) and 5000."""
    import numpy as np
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.scripts import inference
    from gnnflow_tpu_torch.train import Trainer
    npz = os.path.join(_build.BUILD_DIR, "TGN_online_embeddings.npz")
    absent = os.path.join(_build.BUILD_DIR, "DySAT_absent.ckpt")
    for p in (npz, absent):
        if os.path.exists(p):
            os.remove(p)
    common = ["--data", "REDDIT", "--data-dir", on["data_dir"],
              "--compute-dtype", "bfloat16"]
    runs = {"inference": ["--model", "TGN", "--checkpoint", on["ckpt"],
                          "--dump-embeddings", npz, *common],
            "inference_dysat": ["--model", "DySAT", "--batch-size", "4000",
                                "--time-windows", "0", "5000",
                                "--checkpoint", absent, *common]}
    launches, res = {}, {}
    for path, argv in runs.items():
        _reset(kernels)
        counts, restore = _launches_by_method(kernels, Trainer,
                                              ["eval_step", "embed_step"])
        try:
            t0 = time.perf_counter()
            out = inference.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            restore()
        launches[path] = {k: counts["eval_step"][k] + counts["embed_step"][k]
                          for k in kernels}
        res[path] = dict(seconds=seconds, launches=launches[path],
                         by_step=counts, **out)
        _log("inference", path=path, **res[path])

    test, bad = on["test"], []
    tgn, dys = res["inference"], res["inference_dysat"]
    with np.load(npz) as d:
        keys = sorted(d.files)
        emb, nids = d["embeddings_w0"], d["nids_w0"]
        want = np.concatenate([np.concatenate([test.src[lo: lo + 4000],
                                               test.dst[lo: lo + 4000]])
                               for lo in range(0, len(test), 4000)])
        labels_ok = d["labels_w0"].shape == d["scores_w0"].shape \
            == (2 * len(test),)
    if keys != ["embeddings_w0", "labels_w0", "nids_w0", "scores_w0"] \
            or emb.shape != (2 * len(test), 100) \
            or not np.isfinite(emb).all() or not emb.std() > 0 \
            or not np.array_equal(nids, want) or not labels_ok:
        bad.append(f"npz keys {keys}, embeddings {emb.shape}")
    if not tgn["loaded"] or dys["loaded"] or dys["windows"] != [0.0, 5000.0]:
        bad.append("checkpoints")
    for r in (tgn, dys):
        if not all(np.isfinite(x) and 0.0 < x <= 1.0
                   for x in r["ap"] + r["auc"]):
            bad.append(f"AP/AUC {r['ap']} {r['auc']}")
    t_l, d_l = launches["inference"], launches["inference_dysat"]
    if not (t_l["gru_memory_fused"] and t_l["neighborhood_attention"]
            and tgn["by_step"]["embed_step"]["neighborhood_attention"]
            and d_l["neighborhood_attention"] and not d_l["gru_memory_fused"]):
        bad.append(f"launches {launches}")
    if bad:
        raise AssertionError(f"inference: {bad}")
    _log("inference", embeddings=list(emb.shape),
         embeddings_std=float(emb.std()), test_edges=len(test))
    return dict(launches=launches, **res)


CACHE_RATIO = 0.3       # edge-cache ratio of the cache phase
CACHE_BATCH = 4000      # its batch size (the REDDIT default)
CACHE_STEP_TOL = 1e-6   # prefetched vs resident, pipelined vs serial
CACHE_POLICIES = ("LRUCache", "LFUCache", "FIFOCache", "GNNLabStaticCache")


def _cache_store(full, data_cfg, placement):
    from gnnflow_tpu_torch.dynamic_graph import build_dynamic_graph
    g = build_dynamic_graph(**{**data_cfg, "mem_resource_type": placement})
    for lo in range(0, len(full), 100_000):
        sl = slice(lo, lo + 100_000)
        g.add_edges(full.src[sl], full.dst[sl], full.time[sl], full.eid[sl],
                    add_reverse=data_cfg["undirected"])
    return g


def _cache_fetch_check(torch, name, tdt, sampler, g, ef_np, ef, train,
                       batches, num_nodes):
    """Check 1 for one policy and transfer dtype: every fetch against the
    direct gather from the master table on the card (f32: the same bits;
    bf16: each row the f32 row or its bf16 rounding, the seeded rows
    being f32) and against the same cache on the CPU, fed the same MFGs
    (the same bits, and the same hit ratio after every batch)."""
    from gnnflow_tpu_torch.cache import CACHES
    caches = [CACHES[name](CACHE_RATIO, 0, num_nodes, g.num_edges(), None,
                           ef_np, transfer_dtype=tdt, device=d)
              for d in ("cuda", "cpu")]
    for c in caches:
        if name == "GNNLabStaticCache":
            c.init_cache(sampler=sampler, train_data=train,
                         pre_sampling_rounds=2, batch_size=CACHE_BATCH)
        else:
            c.init_cache()
    card, host = caches
    bad, ratios = [], []
    for i, b in enumerate(batches):
        mfgs = sampler.sample(b.target_nodes, b.ts)
        _, efs = card.fetch_feature(mfgs, b.eids)
        _, hefs = host.fetch_feature(mfgs, b.eids)
        m = mfgs[0][0]
        want = torch.where(m.nbr_mask[..., None], ef[m.nbr_eids], 0.0)
        want_t = ef[torch.from_numpy(b.eids).cuda()]
        for got, w in ((efs[0][0], want),
                       (card.target_edge_features, want_t)):
            same = torch.equal(got, w) if tdt == "float32" else bool(
                ((got == w) | (got == w.bfloat16().float())).all())
            if not same:
                bad.append(f"{name} {tdt} batch {i}: fetch != gather")
        for got, h in ((efs[0][0], hefs[0][0]),
                       (card.target_edge_features,
                        host.target_edge_features)):
            if not torch.equal(got.cpu(), h):
                bad.append(f"{name} {tdt} batch {i}: card != CPU")
        ratios.append(card.cache_edge_ratio)
        if card.cache_edge_ratio != host.cache_edge_ratio:
            bad.append(f"{name} {tdt} batch {i}: hit ratio "
                       f"{card.cache_edge_ratio} != {host.cache_edge_ratio}")
    return bad, dict(hit_ratio=ratios[-1], hit_ratio_first=ratios[0],
                     capacity=card.edge_cache.capacity,
                     mem_mb=card.get_mem_size() / 1e6)


def _cached_steps(torch, trainer, state, sampler, cache, batches, train=True,
                  pipeline=False):
    """Prefetched steps over ``batches`` (serial: sample, fetch, step;
    or through the FeaturePipeline): ``(losses, ms per step by CUDA
    events, host ms per step)``."""
    from gnnflow_tpu_torch.pipeline import FeaturePipeline
    losses = []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    if pipeline:
        for b, mfgs, nfs, efs, tef in FeaturePipeline(
                sampler, cache).run(iter(batches)):
            losses.append(trainer.train_step_prefetched(
                state, mfgs, nfs, efs, tef, b, train=train)[1])
    else:
        for b in batches:
            mfgs = sampler.sample(b.target_nodes, b.ts)
            nfs, efs = cache.fetch_feature(mfgs, b.eids)
            losses.append(trainer.train_step_prefetched(
                state, mfgs, nfs, efs, cache.target_edge_features, b,
                train=train)[1])
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    return torch.stack(losses).float().cpu(), \
        start.elapsed_time(end) / len(batches), host_ms


def _tgn_cached(torch, num_nodes, compute_dtype, dedup=None, **over):
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    model = DGNN(dim_edge=172, compute_dtype=compute_dtype, seed=0,
                 device="cuda", **{**TGN, **over})
    trainer = Trainer(model, fanouts=[10], lr=1e-4, dedup_factor=dedup,
                      device="cuda")
    return model, trainer, trainer.init_state(num_nodes, seed=0)


def phase_cache(torch, kernels, on):
    """TGN through the feature cache at the REDDIT defaults (batch 4000,
    fanout 10 recent, memory, time and embedding dims 100, 2 heads) on the
    online phase's REDDIT-shaped stream read back from disk (the REDDIT
    data config: directed), the 172-dim edge table on the host, edge-cache
    ratio 0.3.  Checks: (1) the four policies' fetches, f32 and bf16
    transfer, over 20 batches, against the direct gather and the same
    cache on the CPU; (2) 5 f32 prefetched train steps at dropout 0
    against ``train_step`` on the resident table from one state; (3) 20
    bf16 train steps pipelined against serial; (4) 5 cached train steps
    on the memory dedup at 0.35 on a store placed on the host (sampled on
    the CPU) against the card's store; (5) the kernels' launches on each
    path; (6) one epoch of the script with ``--cache LRUCache
    --edge-cache-ratio 0.3 --features-on-host``, serial and pipelined.
    Timings (CUDA events, bf16, batch 4000): cached train steps serial and
    pipelined, cached eval, the resident train step of the same store, and
    per batch the sampling, the copy of the ids to the host, the host time
    of ``fetch_feature``, the misses and their copy to the card alone."""
    import numpy as np
    from gnnflow_tpu_torch.cache import LRUCache
    from gnnflow_tpu_torch.cache.cache import mfgs_to_host
    from gnnflow_tpu_torch.config import get_default_config
    from gnnflow_tpu_torch.data import load_dataset, load_feat
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
    from gnnflow_tpu_torch.temporal_sampler import TemporalSampler
    from gnnflow_tpu_torch.train import Trainer
    t0 = time.perf_counter()
    train, _, _, full = load_dataset("REDDIT", on["data_dir"])
    _, ef_np = load_feat("REDDIT", on["data_dir"])
    _, data_cfg = get_default_config("tgn", "reddit")
    g = _cache_store(full, data_cfg, "hbm")
    num_nodes = g.max_vertex_id() + 1
    dg = g.device_graph("cuda")
    ef = torch.from_numpy(ef_np).cuda()
    sampler = TemporalSampler(g, [10])
    n_fetch, n_steps, n_eval, n_host = 20, 20, 10, 5
    # from the middle of the train split: the first-k seeding holds every
    # edge the first batches reach, so they would never miss
    batches = _take(train[len(train) // 2:], CACHE_BATCH, train.dst,
                    3 + n_steps + n_eval)
    setup_s = time.perf_counter() - t0
    bad, res = [], dict(setup_s=setup_s, edges=len(full),
                        nodes=num_nodes, ratio=CACHE_RATIO,
                        table_mb=ef_np.nbytes / 1e6)

    # (1) fetches
    t0 = time.perf_counter()
    res["fetch"] = {}
    for name in CACHE_POLICIES:
        for tdt in ("float32", "bfloat16"):
            b1, r = _cache_fetch_check(torch, name, tdt, sampler, g, ef_np,
                                       ef, train, batches[:n_fetch],
                                       num_nodes)
            bad += b1
            res["fetch"][f"{name}/{tdt}"] = r
    res["fetch_s"] = time.perf_counter() - t0
    _log("cache", check="fetch", ok=not bad, **res)

    # per batch: sampling, the id copy, fetch_feature, misses, H2D alone
    cache = LRUCache(CACHE_RATIO, 0, num_nodes, g.num_edges(), None, ef_np)
    cache.init_cache()
    parts = {k: [] for k in ("sample_ms", "d2h_ids_ms", "fetch_host_ms",
                             "unique_ids", "miss_rows")}
    for b in batches[:n_fetch]:
        kind = cache.edge_cache
        total, hits = kind.total, kind.hits
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mfgs = sampler.sample(b.target_nodes, b.ts)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mfgs_to_host(mfgs)
        t3 = time.perf_counter()
        cache.fetch_feature(mfgs, b.eids)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in (("sample_ms", t2 - t1), ("d2h_ids_ms", t3 - t2),
                     ("fetch_host_ms", t4 - t3)):
            parts[k].append(v * 1e3)
        parts["unique_ids"].append(kind.total - total)
        parts["miss_rows"].append((kind.total - total) - (kind.hits - hits))
    per = {k: statistics.mean(v[3:]) for k, v in parts.items()}
    per["miss_mb_f32"] = per["miss_rows"] * 172 * 4 / 1e6
    staged = torch.empty(int(per["miss_rows"]) * 172, pin_memory=True)
    per["h2d_ms"] = cuda_ms(torch, lambda: staged.to(
        "cuda", non_blocking=True))
    per["h2d_gb_s"] = staged.nbytes / (per["h2d_ms"] / 1e3) / 1e9
    res["per_batch"] = per
    res["hit_ratio_lru_20"] = cache.cache_edge_ratio

    # (2) the prefetched step against the resident step, f32, dropout 0
    f32 = dict(dropout=0.0, att_dropout=0.0)
    runs = [_tgn_cached(torch, num_nodes, None, **f32) for _ in range(2)]
    cache = LRUCache(CACHE_RATIO, 0, num_nodes, g.num_edges(), None, ef_np)
    cache.init_cache()
    worst = dict(loss=0.0, logits=0.0)
    for b in batches[3:3 + n_host]:
        _, l_r, p_r, n_r = runs[0][1].train_step(runs[0][2], dg, ef, b)
        mfgs = sampler.sample(b.target_nodes, b.ts)
        _, efs = cache.fetch_feature(mfgs, b.eids)
        _, l_c, p_c, n_c = runs[1][1].train_step_prefetched(
            runs[1][2], mfgs, None, efs, cache.target_edge_features, b)
        worst["loss"] = max(worst["loss"], _rel(l_c, l_r))
        worst["logits"] = max(worst["logits"], _rel(torch.cat([p_c, n_c]),
                                                    torch.cat([p_r, n_r])))
    worst["params"] = max(_rel(a.detach(), w.detach()) for a, w in zip(
        runs[1][0].parameters(), runs[0][0].parameters()))
    worst["memory"] = _rel(runs[1][2].memory.node_memory,
                           runs[0][2].memory.node_memory)
    res["step_vs_resident"] = dict(steps=n_host, tol=CACHE_STEP_TOL,
                                   **worst)
    if max(worst.values()) > CACHE_STEP_TOL:
        bad.append(f"prefetched vs resident: {worst}")
    del runs

    # (3), (5) bf16 at the defaults: serial, pipelined, eval, resident
    timing = {}
    losses, hits = {}, {}
    for mode in ("serial", "pipeline"):
        model, trainer, state = _tgn_cached(torch, num_nodes, "bfloat16")
        cache = LRUCache(CACHE_RATIO, 0, num_nodes, g.num_edges(), None,
                         ef_np)
        cache.init_cache()
        _cached_steps(torch, trainer, state, sampler, cache, batches[:3],
                      pipeline=mode == "pipeline")            # warm-up
        cache.reset()
        _reset(kernels)
        losses[mode], ms, host_ms = _cached_steps(
            torch, trainer, state, sampler, cache,
            batches[3:3 + n_steps], pipeline=mode == "pipeline")
        hits[mode] = cache.cache_edge_ratio
        timing[f"train_{mode}_ms_per_step"] = ms
        timing[f"train_{mode}_host_ms_per_step"] = host_ms
        res.setdefault("launches", {})[f"cache_{mode}" if mode ==
                                       "pipeline" else "cache_train"] = {
            k: f.launches for k, f in kernels.items()}
        if not (bool(torch.isfinite(losses[mode]).all())
                and _all_finite(torch, state, model)):
            bad.append(f"cached {mode} training: non-finite")
        if mode == "pipeline":
            # the worker waits for the interpreter lock up to the switch
            # interval (5 ms) each time the stepping thread holds it; the
            # same steps again at 0.1 ms show what that wait costs
            interval = sys.getswitchinterval()
            sys.setswitchinterval(1e-4)
            try:
                _, ms, host_ms = _cached_steps(
                    torch, trainer, state, sampler, cache,
                    batches[3:3 + n_steps], pipeline=True)
            finally:
                sys.setswitchinterval(interval)
            timing["train_pipeline_switch_0.1ms_ms_per_step"] = ms
            _reset(kernels)
            _, ms, host_ms = _cached_steps(
                torch, trainer, state, sampler, cache,
                batches[3 + n_steps:], train=False)
            timing["eval_ms_per_batch"] = ms
            timing["eval_host_ms_per_batch"] = host_ms
            res["launches"]["cache_eval"] = {k: f.launches
                                             for k, f in kernels.items()}
    err = _rel(losses["pipeline"], losses["serial"])
    res["pipeline_vs_serial"] = dict(steps=n_steps, loss_rel=err,
                                     hit_serial=hits["serial"],
                                     hit_pipeline=hits["pipeline"])
    if hits["serial"] != hits["pipeline"] or err > CACHE_STEP_TOL:
        bad.append(f"pipeline vs serial: {res['pipeline_vs_serial']}")
    model, _, state = _tgn_cached(torch, num_nodes, "bfloat16")
    trainer = Trainer(model, fanouts=[10], lr=1e-4, dedup_factor=None,
                      device="cuda")
    for b in batches[:3]:
        trainer.train_step(state, dg, ef, b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    for b in batches[3:3 + n_steps]:
        trainer.train_step(state, dg, ef, b)
    end.record()
    torch.cuda.synchronize()
    timing["resident_train_ms_per_step"] = start.elapsed_time(end) / n_steps
    timing["resident_train_host_ms_per_step"] = \
        (time.perf_counter() - t1) * 1e3 / n_steps
    res["timing"] = timing

    # (4) a store placed on the host, sampled on the CPU, memory dedup
    hg = _cache_store(full, data_cfg, "host")
    host_losses = []
    for store in (g, hg):
        model, trainer, state = _tgn_cached(torch, num_nodes, None, 0.35,
                                            **f32)
        s = TemporalSampler(store, [10])
        cache = LRUCache(CACHE_RATIO, 0, num_nodes, store.num_edges(), None,
                         ef_np)
        cache.init_cache()
        _reset(kernels)
        fast = 0
        ls = []
        for b in batches[3:3 + n_host]:
            mfgs = s.sample(b.target_nodes, b.ts)
            if store is hg and mfgs[0][0].nbr_eids.device.type != "cpu":
                bad.append("the host store was not sampled on the CPU")
            nfs, efs = cache.fetch_feature(mfgs, b.eids)
            ls.append(trainer.train_step_prefetched(
                state, mfgs, nfs, efs, cache.target_edge_features, b)[1])
            fast += _fast_steps(trainer, state, CACHE_BATCH * 3 * 11)
        host_losses.append(torch.stack(ls).cpu())
        if store is hg:
            res["launches"]["cache_host_store"] = {
                k: f.launches for k, f in kernels.items()}
            res["host_store"] = dict(steps=n_host, dedup_fast_steps=fast,
                                     sample_device=str(s.sample_device))
    res["host_store"]["loss_rel"] = _rel(host_losses[1], host_losses[0])
    if res["host_store"]["loss_rel"] > CACHE_STEP_TOL:
        bad.append(f"host store vs card store: {res['host_store']}")

    # (6) the script, serial and pipelined
    res["entry"] = {}
    en_launches = {k: 0 for k in kernels}
    for mode, extra in (("serial", []), ("pipeline", ["--pipeline"])):
        _reset(kernels)
        t1 = time.perf_counter()
        out = entry.main(["--model", "TGN", "--data", "REDDIT",
                          "--data-dir", on["data_dir"], "--epoch", "1",
                          "--cache", "LRUCache", "--edge-cache-ratio",
                          str(CACHE_RATIO), "--features-on-host"] + extra,
                         checkpoint_path=os.path.join(
                             _build.BUILD_DIR, "TGN_torch_cache.ckpt"))
        torch.cuda.synchronize()
        for k, f in kernels.items():
            en_launches[k] += f.launches
        scores = out["val_ap"] + out["val_auc"] + [out["test_ap"],
                                                   out["test_auc"]]
        if not (all(np.isfinite(x) and 0.0 < x <= 1.0 for x in scores)
                and 0.0 < out["cache_edge_hit"][0] <= 1.0
                and out["phases"] and out["phases"][0].get("train")):
            bad.append(f"entry {mode}: {out}")
        res["entry"][mode] = dict(seconds=time.perf_counter() - t1, **out)
    res["launches"]["cache_entry"] = en_launches

    L = res["launches"]
    # training at attention dropout 0.2 routes around K3; the host-store
    # steps run at 0, so K3 and its backward run there
    want = {"cache_train": (n_steps, n_steps, 0, 0),
            "cache_pipeline": (n_steps, n_steps, 0, 0),
            "cache_eval": (n_eval, 0, n_eval, 0),
            "cache_host_store": (n_host, n_host, n_host,
                                 res["host_store"]["dedup_fast_steps"])}
    for path, counts in want.items():
        got = tuple(L[path][k] for k in (
            "gru_memory_fused", "gru_memory_fused_bwd",
            "neighborhood_attention", "sorted_segment_sum"))
        if got != counts:
            bad.append(f"{path}: launches {got}, expected {counts}")
    if not (res["host_store"]["dedup_fast_steps"]
            and all(L["cache_entry"][k] for k in (
                "gru_memory_fused", "gru_memory_fused_bwd",
                "neighborhood_attention"))):
        bad.append(f"launches {L}")
    _log("cache", **{k: v for k, v in res.items() if k != "fetch"})
    if bad:
        raise AssertionError(f"cache: {bad}")
    return res


def _self_check_online(torch, card, full, efs, num_nodes, failed):
    """TGN in f32, CPU (plain versions) against card (kernels), from one
    state: one ``embed_step`` after an eval batch (the card takes the
    CPU's memory first), which must leave memory as it was; then a
    prequential sequence on stores of the stream's first 3000 edges: per
    chunk of 500 the card takes the CPU's memory, both score the chunk,
    ingest it and evict the edges older than 4000 before its end. Logits,
    embeddings and memory to the f32 eval tolerance; equal evictions and
    device views; one view upload per chunk scored after a change."""
    from gnnflow_tpu_torch.data import DstRandEdgeSampler, get_batches
    from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
    from gnnflow_tpu_torch.models import memory as memory_lib
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    tol, head, size, chunks = 1e-4, 3000, 500, 3
    cfg = {**TGN, "dropout": 0.0, "att_dropout": 0.0}
    devs = {"cpu": "cpu", "card": card}
    sides = {}
    for r, d in devs.items():
        g = DynamicGraph(initial_pool_size=1 << 16, minimum_block_size=62)
        g.add_edges(full.src[:head], full.dst[:head], full.time[:head],
                    full.eid[:head], add_reverse=True)
        tr = Trainer(DGNN(dim_edge=172, seed=1, device=d, **cfg),
                     fanouts=[10], device=d)
        sides[r] = dict(g=g, tr=tr, st=tr.init_state(num_nodes), d=d)

    def sync():
        cpu, dev = sides["cpu"]["st"].memory, sides["card"]["st"].memory
        for k, v in memory_lib.backup_memory(cpu).items():
            getattr(dev, k).copy_(v)

    def mem_err():
        a, b = (torch.cat([s["st"].memory.node_memory,
                           s["st"].memory.mailbox], 1).cpu()
                for s in sides.values())
        return (a - b).abs().max().item()

    b0, b1 = list(get_batches(full[head - 1000: head], size,
                              DstRandEdgeSampler(full.dst, seed=5)))
    embeds, unchanged = {}, True
    for s in sides.values():
        s["tr"].eval_step(s["st"], s["g"].device_graph(s["d"]), efs[s["d"]],
                          b0)
    sync()
    for r, s in sides.items():
        before = memory_lib.backup_memory(s["st"].memory)
        embeds[r] = s["tr"].embed_step(s["st"], s["g"].device_graph(s["d"]),
                                       efs[s["d"]], b1).cpu()
        after = memory_lib.backup_memory(s["st"].memory)
        unchanged &= all(torch.equal(before[k], after[k]) for k in before)
    out = dict(embed_max_abs_err=(embeds["cpu"] - embeds["card"]).abs()
               .max().item(), embed_shape=list(embeds["card"].shape),
               memory_unchanged=unchanged, tol=tol, chunks=[])
    negs = {r: DstRandEdgeSampler(full.dst[:head], seed=6) for r in sides}
    ok = unchanged and out["embed_max_abs_err"] <= tol
    for c in range(chunks):
        chunk = full[head + size * c: head + size * (c + 1)]
        sync()
        logits, evicted = {}, {}
        for r, s in sides.items():
            scores = []
            for b in get_batches(chunk, size, negs[r]):
                _, _, p, n = s["tr"].eval_step(
                    s["st"], s["g"].device_graph(s["d"]), efs[s["d"]], b)
                scores.append(torch.cat([p, n]).cpu())
            logits[r] = torch.cat(scores)
        err_m = mem_err()
        for r, s in sides.items():
            s["g"].add_edges(chunk.src, chunk.dst, chunk.time, chunk.eid,
                             add_reverse=True)
            negs[r].add_dst_list(chunk.dst)
            evicted[r] = s["g"].offload_old_blocks(
                float(chunk.time[-1]) - 4000.0)
        views = [s["g"].device_graph(s["d"]) for s in sides.values()]
        same_view = all(torch.equal(getattr(views[0], f),
                                    getattr(views[1], f).cpu())
                        for f in ("row_off", "row_len", "e_dst", "e_ts",
                                  "e_eid"))
        err_l = (logits["cpu"] - logits["card"]).abs().max().item()
        out["chunks"].append(dict(logits_max_abs_err=err_l,
                                  memory_max_abs_err=err_m,
                                  evicted=evicted["card"],
                                  views_equal=same_view))
        ok &= (err_l <= tol and err_m <= tol and same_view
               and evicted["cpu"] == evicted["card"] > 0)
    out["uploads"] = {r: s["g"].uploads for r, s in sides.items()}
    ok &= all(n == 1 + chunks for n in out["uploads"].values())
    if not ok:
        failed.append("online float32")
    return out


def _plain_attention_ms(torch, model, rec):
    """Device time of the plain attention with its dropout, forward and
    backward, on the inputs each layer last gave it (``rec``), replayed
    as the train step runs it; the layers' shapes beside it."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    calls = []
    for name, (q, kv, mask) in sorted(rec.items()):
        layer = model.layers[name]
        dout = torch.randn(q.shape, device=q.device, dtype=torch.float32) \
            .to(kv.dtype)

        def call(layer=layer, q=q, kv=kv, mask=mask, dout=dout):
            q_, kv_ = q.detach().requires_grad_(), \
                kv.detach().requires_grad_()
            out = layer._attention_plain(q_, kv_, mask, gen)
            out.backward(dout)
        calls.append(call)

    def both():
        for c in calls:
            c()
    return dict(ms=device_ms(torch, [both], iters=6),
                shapes={name: {"q": list(q.shape), "kv": list(kv.shape)}
                        for name, (q, kv, _) in rec.items()},
                note="forward and backward of both layers' plain "
                     "attention, replayed on a step's inputs; profiler "
                     "device time")


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
    """Copy run ``src``'s parameters, Adam moments and memory (if any)
    into run ``dst`` (across devices) and remake ``dst``'s weight
    copies."""
    for p_s, p_d in zip(src["model"].parameters(), dst["model"].parameters()):
        p_d.detach().copy_(p_s.detach())
        for k, v in src["st"].optimizer.state[p_s].items():
            dst["st"].optimizer.state[p_d][k].copy_(v)
    if src["st"].memory is not None:
        for f in ("node_memory", "node_memory_ts", "mailbox", "mailbox_ts",
                  "mailbox_ptr"):
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
    out["tgat_float32"] = _self_check_tgat(torch, card, full, graphs, efs,
                                           num_nodes, failed)
    out["dysat_float32"] = _self_check_dysat(torch, card, full, graphs, efs,
                                             num_nodes, failed)
    out["apan_float32"] = _self_check_apan(torch, card, full, graphs, efs,
                                           num_nodes, failed)
    out["static_float32"] = _self_check_static(torch, card, full, graphs,
                                               num_nodes, failed)
    out["online_float32"] = _self_check_online(torch, card, full, efs,
                                               num_nodes, failed)
    _log("self_check", eval_batches=4, batch_size=500, **out)
    if failed:
        raise AssertionError(f"CPU vs card: {failed} beyond tolerance")


def _cpu_draws(torch, trainer, seed: int) -> None:
    """Make ``trainer`` take its uniform draws from a CPU generator seeded
    with ``seed`` (moved to its device), so a CPU and a card run sample
    alike."""
    gen = torch.Generator().manual_seed(seed)
    trainer._uniform = lambda _gen, shape: torch.rand(
        shape, generator=gen).to(trainer.device)


def _self_check_tgat(torch, card, full, graphs, efs, num_nodes, failed):
    """TGAT in f32 (widths of ``_tgat``, dropout 0), CPU (plain versions)
    against card (kernels), on the same uniform draws: eval logits over 4
    padded batches, then 4 train steps on a two-tier layer-dedup ladder
    (loss, gradients, parameters after each step), with the same tiers
    taken on both sides and K4 launched once per step on the card's
    dedup."""
    from gnnflow_tpu_torch.data import DstRandEdgeSampler, get_batches
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.ops.segment_sum import sorted_segment_sum
    from gnnflow_tpu_torch.train import Trainer
    cfg = dict(dim_node=0, dim_edge=172, dim_time=100, dim_embed=100,
               num_layers=2, num_snapshots=1, att_head=2, dropout=0.0,
               att_dropout=0.0, use_memory=False)
    tol = 1e-4
    tt = dict(loss=1e-4, grad=1e-4, param=1e-5)

    def run(device, layer_dedup):
        model = DGNN(**cfg, seed=1, device=device)
        tr = Trainer(model, fanouts=[10, 10], sample_strategy="uniform",
                     lr=1e-4, layer_dedup=layer_dedup, device=device)
        _cpu_draws(torch, tr, 5)
        return dict(model=model, tr=tr, st=tr.init_state(num_nodes),
                    device=device, trace=[], compact=[])

    ev = {}
    for device in ("cpu", card):
        r = run(device, None)
        logits = []
        neg = DstRandEdgeSampler(full.dst, seed=3)
        for i, b in enumerate(get_batches(full, 500, neg)):
            if i == 4:
                break
            _, _, p, n = r["tr"].eval_step(r["st"], graphs[device],
                                           efs[device], b)
            logits.append(torch.cat([p, n]).float().cpu())
        ev[device] = logits
    err_l = max((a - b).abs().max().item()
                for a, b in zip(ev["cpu"], ev[card]))
    if not err_l <= tol:
        failed.append("tgat eval float32")

    runs = {nm: run(nm if nm == "cpu" else card, (0.3, 0.6))
            for nm in ("cpu", "card")}
    neg = DstRandEdgeSampler(full.dst, seed=4)
    k4_before = sorted_segment_sum.launches
    steps = 4
    for i, b in enumerate(get_batches(full, 500, neg)):
        if i == steps:
            break
        for r in runs.values():
            _, loss, _, _ = r["tr"].train_step(
                r["st"], graphs[r["device"]], efs[r["device"]], b)
            r["compact"].append(r["st"].layer_dedup_compact)
            r["trace"].append(dict(
                loss=loss.float().cpu(),
                grad=[q.grad.float().cpu() for q in r["model"].parameters()],
                param=[q.detach().cpu().clone()
                       for q in r["model"].parameters()],
                memory=torch.zeros(1)))
    k4 = sorted_segment_sum.launches - k4_before
    pnames = [nm for nm, _ in runs["cpu"]["model"].named_parameters()]
    errs, worst = _trace_errs(runs["cpu"]["trace"], runs["card"]["trace"],
                              pnames)
    finite = all(bool(torch.isfinite(x).all())
                 for s_ in runs["card"]["trace"]
                 for x in s_["grad"] + s_["param"])
    compact = runs["card"]["compact"]
    ok = (all(max(errs[k]) <= tt[k] for k in tt) and finite
          and compact == runs["cpu"]["compact"] and sum(compact) >= 1
          and k4 == (sum(compact) if card != "cpu" else 0))
    if not ok:
        failed.append("tgat train layer dedup float32")
    return dict(eval=dict(batches=4, logits_max_abs_err=err_l, tol=tol),
                train=dict(steps=steps, ladder=[0.3, 0.6],
                           per_step_max_err={k: errs[k] for k in tt},
                           worst_grad_parameter=worst, tol=tt,
                           compact_steps=compact,
                           cpu_compact_steps=runs["cpu"]["compact"],
                           tier_takes=runs["card"]["st"].tier_takes,
                           k4_launches=k4, finite=finite))


def _self_check_dysat(torch, card, full, graphs, efs, num_nodes, failed):
    """DySAT in f32 (widths of ``_dysat``, dropout 0, 3 snapshots of
    window 2000 on this 24,000-long stream), CPU (plain versions) against
    card (kernels), on the same uniform draws: eval logits over 4 padded
    batches, then 4 train steps on the snapshot dedup's two-tier ladder
    (loss, gradients, parameters after each step), with the same tiers
    taken on both sides and K4 launched once per snapshot of each step on
    the card's dedup.

    Before each train step the card takes the CPU's parameters and Adam
    moments, so every step is held from one state; a free card run is
    reported beside the held one.  Gradients are held to 1e-2 of each
    parameter's largest gradient element, not 1e-4 as TGAT's: on this
    stream's early, sparsely filled snapshot windows a few rows carry an
    inner layer's gradient, and a ReLU input within ~1e-7 of zero takes
    the other side under any f32 reordering, which moves one row's share
    of a weight gradient.  The CPU shows it alone: a CPU run from the
    CPU's state with every parameter scaled by ``1 + 1e-7·N(0, 1)`` is
    reported beside.  Losses (1e-4) and parameters after each step (1e-5,
    a tenth of an Adam step) keep TGAT's tolerances."""
    from gnnflow_tpu_torch.data import DstRandEdgeSampler, get_batches
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.ops.segment_sum import sorted_segment_sum
    from gnnflow_tpu_torch.train import Trainer
    cfg = dict(dim_node=0, dim_edge=172, dim_time=0, dim_embed=100,
               num_layers=2, num_snapshots=3, att_head=2, dropout=0.0,
               att_dropout=0.0, use_memory=False)
    tol = 1e-4
    tt = dict(loss=1e-4, grad=1e-2, param=1e-5)
    ladder = (0.3, 0.6)

    def run(device, layer_dedup):
        model = DGNN(**cfg, seed=1, device=device)
        tr = Trainer(model, fanouts=[10, 10], sample_strategy="uniform",
                     num_snapshots=3, snapshot_time_window=2000.0,
                     prop_time=True, lr=1e-4, compact_factor=None,
                     model_compact=False, layer_dedup=layer_dedup,
                     device=device)
        _cpu_draws(torch, tr, 5)
        return dict(model=model, tr=tr, st=tr.init_state(num_nodes),
                    device=device, trace=[], compact=[])

    ev = {}
    for device in ("cpu", card):
        r = run(device, None)
        logits = []
        neg = DstRandEdgeSampler(full.dst, seed=3)
        for i, b in enumerate(get_batches(full, 500, neg)):
            if i == 4:
                break
            _, _, p, n = r["tr"].eval_step(r["st"], graphs[device],
                                           efs[device], b)
            logits.append(torch.cat([p, n]).float().cpu())
        ev[device] = logits
    err_l = max((a - b).abs().max().item()
                for a, b in zip(ev["cpu"], ev[card]))
    if not err_l <= tol:
        failed.append("dysat eval float32")

    names = ("cpu", "cpu_perturbed", "card", "card_free")
    runs = {nm: run("cpu" if nm.startswith("cpu") else card, ladder)
            for nm in names}
    neg = DstRandEdgeSampler(full.dst, seed=4)
    noise = torch.Generator().manual_seed(6)
    k4_before = sorted_segment_sum.launches
    steps = 4
    for i, b in enumerate(get_batches(full, 500, neg)):
        if i == steps:
            break
        _copy_train_state(runs["cpu"], runs["card"])
        _copy_train_state(runs["cpu"], runs["cpu_perturbed"])
        with torch.no_grad():
            for q in runs["cpu_perturbed"]["model"].parameters():
                q.mul_(1 + 1e-7 * torch.randn(q.shape, generator=noise))
        runs["cpu_perturbed"]["model"].cast_weights()
        for nm in names:
            r = runs[nm]
            _, loss, _, _ = r["tr"].train_step(
                r["st"], graphs[r["device"]], efs[r["device"]], b)
            r["compact"].append(r["st"].layer_dedup_compact)
            r["trace"].append(dict(
                loss=loss.float().cpu(),
                grad=[q.grad.float().cpu() for q in r["model"].parameters()],
                param=[q.detach().cpu().clone()
                       for q in r["model"].parameters()],
                memory=torch.zeros(1)))
    k4 = sorted_segment_sum.launches - k4_before
    pnames = [nm for nm, _ in runs["cpu"]["model"].named_parameters()]
    errs, worst = _trace_errs(runs["cpu"]["trace"], runs["card"]["trace"],
                              pnames)
    free, free_worst = _trace_errs(runs["cpu"]["trace"],
                                   runs["card_free"]["trace"], pnames)
    pert, pert_worst = _trace_errs(runs["cpu"]["trace"],
                                   runs["cpu_perturbed"]["trace"], pnames)
    finite = all(bool(torch.isfinite(x).all())
                 for s_ in runs["card"]["trace"]
                 for x in s_["grad"] + s_["param"])
    compact = runs["card"]["compact"]
    # K4: once per snapshot of each step on the dedup, in both card runs
    ok = (all(max(errs[k]) <= tt[k] for k in tt) and finite
          and compact == runs["cpu"]["compact"] and sum(compact) >= 1
          and k4 == (3 * (sum(compact) + sum(runs["card_free"]["compact"]))
                     if card != "cpu" else 0))
    if not ok:
        failed.append("dysat train snapshot dedup float32")
    return dict(eval=dict(batches=4, logits_max_abs_err=err_l, tol=tol),
                train=dict(steps=steps, ladder=list(ladder),
                           per_step_max_err={k: errs[k] for k in tt},
                           worst_grad_parameter=worst, tol=tt,
                           compact_steps=compact,
                           cpu_compact_steps=runs["cpu"]["compact"],
                           first_boundary_n_uniq_max=runs["card"]["st"]
                           .layer_dedup_n_uniq,
                           tier_takes=runs["card"]["st"].tier_takes,
                           k4_launches=k4, finite=finite,
                           state_synced_before_each_step=True,
                           reported_free_card_vs_cpu=dict(
                               per_step_max_err={k: free[k] for k in tt},
                               worst_grad_parameter=free_worst),
                           reported_cpu_perturbed_1e_7_vs_cpu=dict(
                               per_step_max_err={k: pert[k] for k in tt},
                               worst_grad_parameter=pert_worst)))


def _self_check_apan(torch, card, full, graphs, efs, num_nodes, failed):
    """APAN in f32 (widths of ``_apan``, dropout 0), CPU (plain versions)
    against card (kernels): eval logits and memory over 4 batches, then 4
    train steps on the table pull and 4 on the memory dedup at factor 1.0
    (every step fits), each held from one state: before each step the
    card takes the CPU's parameters, Adam moments and memory, every mail
    slot and cursor included.  Losses, parameters and memory after each
    step within the TGN f32 check's tolerances; timestamps and cursors
    equal; K4 once a step on the card's dedup.

    The train runs start from the memory that two eval batches leave.
    From an empty memory every slot of an instance holds the same mail, so
    its softmax over the slots is uniform whatever the query, and ``w_q``'s
    gradient is zero but for rounding, in which the two sides share no
    digit.  ``edge_predictor.out_fc.bias``'s gradient is the sum of the
    rows' ``(sigmoid(pos) - 1) / n`` and ``sigmoid(neg) / n``, small next
    to the sum of their magnitudes, which is reported beside as its
    cancellation."""
    from gnnflow_tpu_torch.data import DstRandEdgeSampler, get_batches
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.ops.segment_sum import sorted_segment_sum
    from gnnflow_tpu_torch.train import Trainer
    cfg = dict(dim_node=0, dim_edge=172, dim_time=100, dim_embed=100,
               num_layers=1, num_snapshots=1, att_head=2, dropout=0.0,
               att_dropout=0.0, use_memory=True, dim_memory=100,
               memory_updater="transformer", mailbox_slots=10)
    tol = 1e-4
    tt = dict(loss=1e-4, grad=1e-4, param=1e-5, memory=1e-4)
    exact = ("node_memory_ts", "mailbox_ts", "mailbox_ptr")

    def run(device, dedup_factor):
        model = DGNN(**cfg, seed=1, device=device)
        tr = Trainer(model, fanouts=[10], lr=1e-4, dedup_factor=dedup_factor,
                     device=device)
        return dict(model=model, tr=tr, st=tr.init_state(num_nodes),
                    device=device, trace=[], fast=0)

    def memory(st):
        return torch.cat([st.memory.node_memory,
                          st.memory.mailbox.flatten(1)], 1).cpu()

    ev = {}
    for device in ("cpu", card):
        r = run(device, None)
        logits, mems = [], []
        neg = DstRandEdgeSampler(full.dst, seed=3)
        for i, b in enumerate(get_batches(full, 500, neg)):
            if i == 4:
                break
            _, _, p, n = r["tr"].eval_step(r["st"], graphs[device],
                                           efs[device], b)
            logits.append(torch.cat([p, n]).float().cpu())
            mems.append(memory(r["st"]))
        ev[device] = (logits, mems, [getattr(r["st"].memory, f).cpu()
                                     for f in exact])
    (cl, cm, cx), (gl, gm, gx) = ev["cpu"], ev[card]
    err_l = max((a - b).abs().max().item() for a, b in zip(cl, gl))
    err_m = max((a - b).abs().max().item() for a, b in zip(cm, gm))
    ev_exact = all(bool(torch.equal(a, b)) for a, b in zip(cx, gx))
    if not (err_l <= tol and err_m <= tol and ev_exact):
        failed.append("apan eval float32")

    names = ("cpu", "card", "cpu_dedup", "card_dedup")
    runs = {nm: run("cpu" if nm.startswith("cpu") else card,
                    1.0 if "dedup" in nm else None) for nm in names}
    held = {"card": "cpu", "card_dedup": "cpu_dedup"}
    neg = DstRandEdgeSampler(full.dst, seed=4)
    batches = get_batches(full, 500, neg)
    for b in [next(batches) for _ in range(2)]:
        for nm in ("cpu", "cpu_dedup"):
            r = runs[nm]
            r["tr"].eval_step(r["st"], graphs["cpu"], efs["cpu"], b)
    k4_before = sorted_segment_sum.launches
    steps, same = 4, []
    for i, b in enumerate(batches):
        if i == steps:
            break
        for dst, src in held.items():
            if i:
                _copy_train_state(runs[src], runs[dst])
            else:            # no Adam state yet: the memory alone
                for f in ("node_memory", "node_memory_ts", "mailbox",
                          "mailbox_ts", "mailbox_ptr"):
                    getattr(runs[dst]["st"].memory, f).copy_(
                        getattr(runs[src]["st"].memory, f))
        for nm in names:
            r = runs[nm]
            _, loss, pos, neg = r["tr"].train_step(
                r["st"], graphs[r["device"]], efs[r["device"]], b)
            # |terms| of out_fc.bias's gradient over the gradient
            terms = ((1 - torch.sigmoid(pos)).sum()
                     + torch.sigmoid(neg).sum()) / pos.shape[0]
            r.setdefault("cancellation", []).append(
                (terms / r["model"].edge_predictor.out_fc.bias.grad.abs()
                 .sum()).item())
            r["fast"] += _fast_steps(r["tr"], r["st"], 1500 * 11)
            r["trace"].append(dict(
                loss=loss.float().cpu(),
                grad=[q.grad.float().cpu() for q in r["model"].parameters()],
                param=[q.detach().cpu().clone()
                       for q in r["model"].parameters()],
                memory=memory(r["st"])))
        same.append(all(bool(torch.equal(
            getattr(runs[a]["st"].memory, f).cpu(),
            getattr(runs[c]["st"].memory, f).cpu()))
            for a, c in (("cpu", "card"), ("cpu_dedup", "card_dedup"))
            for f in exact))
    k4 = sorted_segment_sum.launches - k4_before
    pnames = [nm for nm, _ in runs["cpu"]["model"].named_parameters()]
    out = {}
    for c, a in held.items():
        errs, worst = _trace_errs(runs[a]["trace"], runs[c]["trace"], pnames)
        bias = pnames.index("edge_predictor.out_fc.bias")
        out[c] = dict(per_step_max_err=errs, worst_grad_parameter=worst,
                      fast_steps=runs[c]["fast"],
                      out_fc_bias_grad_rel_err=[
                          _rel(y["grad"][bias], x["grad"][bias])
                          for x, y in zip(runs[a]["trace"],
                                          runs[c]["trace"])],
                      out_fc_bias_grad_cancellation=runs[a]["cancellation"])
        if not all(max(errs[k]) <= tt[k] for k in tt):
            failed.append(f"apan train float32 ({c})")
    fin = all(bool(torch.isfinite(x).all())
              for nm in ("card", "card_dedup") for s_ in runs[nm]["trace"]
              for x in s_["grad"] + s_["param"] + [s_["memory"]])
    ptr_max = int(runs["card"]["st"].memory.mailbox_ptr.max())
    if not (all(same) and fin and runs["cpu_dedup"]["fast"] == steps
            and runs["card_dedup"]["fast"] == steps
            and k4 == (steps if card != "cpu" else 0)):
        failed.append("apan train float32 (timestamps, cursors, dedup)")
    return dict(eval=dict(batches=4, logits_max_abs_err=err_l,
                          memory_max_abs_err=err_m,
                          timestamps_and_cursors_equal=ev_exact, tol=tol),
                train=dict(steps=steps, state_synced_before_each_step=True,
                           after_eval_batches=2, dedup_factor=1.0, tol=tt,
                           **out,
                           timestamps_and_cursors_equal=same,
                           mailbox_ptr_max=ptr_max, k4_launches=k4,
                           finite=fin))


def _self_check_static(torch, card, full, graphs, num_nodes, failed):
    """GraphSAGE and GAT in f32 (the widths of ``_static``, dropout 0),
    CPU (plain versions) against card (kernels), on the same uniform draws
    and 128-dim node features drawn from a seed: eval logits over 4 padded
    batches, then 4 train steps on a two-tier layer-dedup ladder (loss,
    gradients, parameters after each step), with the same tiers taken on
    both sides and K4 launched once per step on the card's dedup; TGAT's
    tolerances."""
    import numpy as np
    from gnnflow_tpu_torch.data import DstRandEdgeSampler, get_batches
    from gnnflow_tpu_torch.ops.segment_sum import sorted_segment_sum
    nf_np = np.random.RandomState(8).randn(num_nodes, 128).astype(np.float32)
    nfs = {d: torch.from_numpy(nf_np).to(d) for d in ("cpu", card)}
    tol, ladder = 1e-4, (0.4, 0.6)
    tt = dict(loss=1e-4, grad=1e-4, param=1e-5)
    out = {}
    for name in ("GRAPHSAGE", "GAT"):
        def run(device, layer_dedup):
            model, tr = _static(name, layer_dedup=layer_dedup, device=device,
                                compute_dtype=None, dropout=0.0,
                                att_dropout=0.0)
            _cpu_draws(torch, tr, 5)
            return dict(model=model, tr=tr, st=tr.init_state(num_nodes),
                        device=device, trace=[], compact=[])

        ev = {}
        for device in ("cpu", card):
            r = run(device, None)
            logits = []
            neg = DstRandEdgeSampler(full.dst, seed=3)
            for i, b in enumerate(get_batches(full, 500, neg)):
                if i == 4:
                    break
                _, _, p, n = r["tr"].eval_step(r["st"], graphs[device], None,
                                               b, node_feats=nfs[device])
                logits.append(torch.cat([p, n]).float().cpu())
            ev[device] = logits
        err_l = max((a - b).abs().max().item()
                    for a, b in zip(ev["cpu"], ev[card]))
        if not err_l <= tol:
            failed.append(f"{name} eval float32")

        runs = {nm: run(nm if nm == "cpu" else card, ladder)
                for nm in ("cpu", "card")}
        neg = DstRandEdgeSampler(full.dst, seed=4)
        k4_before = sorted_segment_sum.launches
        steps = 4
        for i, b in enumerate(get_batches(full, 500, neg)):
            if i == steps:
                break
            for r in runs.values():
                _, loss, _, _ = r["tr"].train_step(
                    r["st"], graphs[r["device"]], None, b,
                    node_feats=nfs[r["device"]])
                r["compact"].append(r["st"].layer_dedup_compact)
                r["trace"].append(dict(
                    loss=loss.float().cpu(),
                    grad=[q.grad.float().cpu()
                          for q in r["model"].parameters()],
                    param=[q.detach().cpu().clone()
                           for q in r["model"].parameters()],
                    memory=torch.zeros(1)))
        k4 = sorted_segment_sum.launches - k4_before
        pnames = [nm for nm, _ in runs["cpu"]["model"].named_parameters()]
        errs, worst = _trace_errs(runs["cpu"]["trace"],
                                  runs["card"]["trace"], pnames)
        finite = all(bool(torch.isfinite(x).all())
                     for s_ in runs["card"]["trace"]
                     for x in s_["grad"] + s_["param"])
        compact = runs["card"]["compact"]
        if not (all(max(errs[k]) <= tt[k] for k in tt) and finite
                and compact == runs["cpu"]["compact"] and sum(compact) >= 1
                and k4 == (sum(compact) if card != "cpu" else 0)):
            failed.append(f"{name} train layer dedup float32")
        out[name.lower()] = dict(
            eval=dict(batches=4, logits_max_abs_err=err_l, tol=tol),
            train=dict(steps=steps, ladder=list(ladder),
                       per_step_max_err={k: errs[k] for k in tt},
                       worst_grad_parameter=worst, tol=tt,
                       compact_steps=compact,
                       cpu_compact_steps=runs["cpu"]["compact"],
                       first_boundary_n_uniq=runs["card"]["st"]
                       .layer_dedup_n_uniq,
                       tier_takes=runs["card"]["st"].tier_takes,
                       k4_launches=k4, finite=finite))
    return out



PARALLEL_PARTITIONS = 4   # hash partitions of the [parallel] phase
PARALLEL_TOL = 1e-5       # f32 DP / partitioned steps against the plain ones


def _f32_held(torch, make, dg_, table, stream, batches):
    """3 f32 TGN train steps at dropout 0 of ``make(model)`` over ``dg_``
    and ``table`` against the plain ``Trainer`` over the stream's store,
    from one set of weights: the largest loss (relative), parameter and
    memory (absolute) differences, after each step; raises above
    ``PARALLEL_TOL``."""
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    cfg = dict(TGN, dropout=0.0, att_dropout=0.0)
    num_nodes = stream["g"].max_vertex_id() + 1
    sides = []
    for build in (lambda m: Trainer(m, fanouts=[10], lr=1e-4,
                                    dedup_factor=None, device="cuda"),
                  make):
        model = DGNN(dim_edge=172, seed=0, device="cuda", **cfg)
        trainer = build(model)
        sides.append((model, trainer, trainer.init_state(num_nodes, 0)))
    (pm, pt, ps), (m, t, st) = sides
    errs = {"loss": [], "params": [], "memory": []}
    for b in batches:
        want = float(pt.train_step(ps, stream["dg"], stream["ef"], b)[1])
        got = float(t.train_step(st, dg_, table, b)[1])
        errs["loss"].append(abs(got - want) / max(abs(want), 1e-12))
        errs["params"].append(max(float((a - c).abs().max()) for a, c in
                                  zip(m.parameters(), pm.parameters())))
        errs["memory"].append(max(
            float((getattr(st.memory, k) - getattr(ps.memory, k))
                  .abs().max()) for k in ("node_memory", "mailbox",
                                           "node_memory_ts", "mailbox_ts")))
    worst = max(max(v) for v in errs.values())
    if not worst <= PARALLEL_TOL:
        raise AssertionError(f"f32 steps off the plain Trainer: {errs}")
    return errs


def phase_parallel(torch, kernels, stream):
    """Multi-GPU training at world size 1 on NCCL (one card): a process
    group over a ``file://`` rendezvous under ``build/``, then

    - DP: 20 TGN train steps (bf16, REDDIT defaults, batch 4000) and 10
      eval batches through ``shard_trainer`` (K1 and K2 once a step, K3
      once an eval batch), timed beside the plain trainer's steps on the
      same batches; 3 f32 steps at dropout 0 held against the plain
      ``Trainer`` (losses, parameters, memory);
    - partitioned: ``dispatch_full_dataset`` splits the stream into 4 hash
      partitions, all owned by rank 0; routed and replicated MFGs (2
      layers of fanout 10, recent, and uniform on the same draws) equal
      the single store's ``sample_hops`` bit for bit on 3 batches; routed
      layer sampling timed at 12,000 and 132,000 roots beside the single
      store and the replicated path, and the routed load's CV over the
      train batches; TGN train and eval through
      ``PartitionedTrainer(routed)`` as above, with its own 3 f32 steps
      against the plain ``Trainer``; TGAT (``_tgat``) eval and 5 train
      steps at attention dropout 0 on the layer dedup at factor 0.5
      through routed sampling (K3 twice a batch or step, K4 once a step
      that takes the tier);
    - script: one epoch of ``offline_edge_prediction_partitioned`` at
      ``--num-devices 1 --num-partitions 4``, which joins the group.

    The group is destroyed at the end.  Returns the launches of each
    path."""
    import numpy as np
    import torch.distributed as dist
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.ops.sampling import sample_hops, sample_layer
    from gnnflow_tpu_torch.parallel import (
        PartitionedDynamicGraph, PartitionedTrainer, dispatch_full_dataset,
        get_partitioner, initialize, routed_load_stats,
        sample_hops_partitioned, sample_hops_routed, sample_layer_replicated,
        sample_layer_routed, shard_trainer, shutdown)
    from gnnflow_tpu_torch.scripts import \
        offline_edge_prediction_partitioned as part_script
    from gnnflow_tpu_torch.train import Trainer
    from gnnflow_tpu_torch.utils import average_precision_score
    g, dg, ef, train, full = stream["g"], stream["dg"], stream["ef"], \
        stream["train"], stream["full"]
    num_nodes = g.max_vertex_id() + 1
    B, warm, steps, ev_runs, extra = 4000, 3, 20, 10, 5
    tb = _take(train, B, train.dst, warm + steps)
    eb = _take(full[len(train):], B, full.dst, ev_runs)
    launches, result = {}, {}

    def tgn_trainer(cls, **kw):
        model = DGNN(dim_edge=172, compute_dtype="bfloat16", seed=0,
                     device="cuda", **TGN)
        trainer = cls(model, fanouts=[10], lr=1e-4, device="cuda", **kw)
        return trainer, trainer.init_state(num_nodes, seed=0)

    def tgn_paths(name, trainer, state, dg_, table, plain, pstate):
        """Warm-up, timed train steps and eval batches of ``trainer``
        beside ``plain``'s on the same batches; launch checks."""
        for b in tb[:warm]:
            trainer.train_step(state, dg_, table, b)
            plain.train_step(pstate, dg, ef, b)
        torch.cuda.synchronize()
        _reset(kernels)
        outs, ms, host = _timed_steps(
            torch, lambda b: trainer.train_step(state, dg_, table, b)[1],
            tb[warm:])
        launches[f"parallel_{name}_train"] = _launch_counts(kernels)
        _check_launches(launches[f"parallel_{name}_train"],
                        _expect(k1=steps, k2=steps), f"{steps} {name} steps")
        _, plain_ms, plain_host = _timed_steps(
            torch, lambda b: plain.train_step(pstate, dg, ef, b)[1],
            tb[warm:])
        _reset(kernels)
        evs, ev_ms, ev_host = _timed_steps(
            torch, lambda b: trainer.eval_step(state, dg_, table, b), eb)
        launches[f"parallel_{name}_eval"] = _launch_counts(kernels)
        _check_launches(launches[f"parallel_{name}_eval"],
                        _expect(k1=ev_runs, k3=ev_runs),
                        f"{ev_runs} {name} eval batches")
        _, plain_ev_ms, _ = _timed_steps(
            torch, lambda b: plain.eval_step(pstate, dg, ef, b), eb)
        losses = torch.stack(outs).float().cpu()
        pos = torch.cat([o[2][:b.num_valid] for o, b in zip(evs, eb)])
        neg = torch.cat([o[3][:b.num_valid] for o, b in zip(evs, eb)])
        if not (bool(torch.isfinite(losses).all())
                and _all_finite(torch, state, trainer.model)
                and pos.shape[0] == ev_runs * B):
            raise AssertionError(f"{name}: non-finite values or wrong "
                                 f"shapes")
        y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        sc = torch.cat([pos, neg]).float().cpu().numpy()
        return dict(steps=steps, ms_per_step=statistics.median(ms),
                    host_ms_per_step=statistics.median(host),
                    plain_ms_per_step=statistics.median(plain_ms),
                    plain_host_ms_per_step=statistics.median(plain_host),
                    eval_ms_per_batch=statistics.median(ev_ms),
                    eval_host_ms_per_batch=statistics.median(ev_host),
                    plain_eval_ms_per_batch=statistics.median(plain_ev_ms),
                    mean_loss=float(losses.mean()),
                    eval_ap=average_precision_score(y, sc))

    rdv = os.path.join(_build.BUILD_DIR, f"rendezvous_{os.getpid()}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    if os.path.exists(rdv):
        os.remove(rdv)
    ctx = initialize(0, 1, "cuda", "file://" + rdv)
    try:
        if dist.get_backend() != "nccl" or ctx.world_size != 1:
            raise AssertionError(f"group {dist.get_backend()} of "
                                 f"{ctx.world_size}")
        # ---- DP -------------------------------------------------------
        plain, pstate = tgn_trainer(Trainer, dedup_factor=None)
        dp, dstate = tgn_trainer(Trainer, dedup_factor=None)
        shard_trainer(dp)
        result["dp"] = tgn_paths("dp", dp, dstate, dg, ef, plain, pstate)
        result["dp"]["f32_vs_plain"] = _f32_held(
            torch, lambda m: shard_trainer(Trainer(
                m, fanouts=[10], lr=1e-4, dedup_factor=None,
                device="cuda")), dg, ef, stream, tb[warm:warm + 3])
        _log("parallel", path="dp", **result["dp"])
        del dp, dstate

        # ---- the partitioned store ------------------------------------
        t0 = time.perf_counter()
        pg = PartitionedDynamicGraph(
            PARALLEL_PARTITIONS, initial_pool_size=1 << 20,
            maximum_pool_size=1 << 23, minimum_block_size=62)
        _, store = dispatch_full_dataset(
            full, None, get_partitioner("hash", PARALLEL_PARTITIONS), pg,
            edge_feats=ef.cpu().numpy(), ingestion_batch_size=100_000,
            undirected=True, device="cuda")
        pdg = pg.device_graph("cuda")
        torch.cuda.synchronize()
        dispatch_s = time.perf_counter() - t0
        mfg_checks = 0
        fields = ("root_nids", "root_ts", "nbr_nids", "nbr_ts", "nbr_dts",
                  "nbr_eids", "nbr_mask")
        for b in tb[:3]:
            roots = torch.from_numpy(b.target_nodes).cuda()
            ts = torch.from_numpy(b.ts).cuda()
            for strategy in ("recent", "uniform"):
                def draws():
                    gen = torch.Generator(device="cuda").manual_seed(5)
                    return lambda _, shape: torch.rand(
                        shape, generator=gen, device="cuda")
                kw = dict(fanouts=[10, 10], strategy=strategy)
                want = sample_hops(dg, roots, ts, draw=draws(), **kw)
                for fn in (sample_hops_routed, sample_hops_partitioned):
                    got = fn(pdg, roots, ts, draw=draws(), **kw)
                    for lg, lw in zip(got, want):
                        for mg, mw in zip(lg, lw):
                            for f in fields:
                                if not torch.equal(getattr(mg, f),
                                                   getattr(mw, f)):
                                    raise AssertionError(
                                        f"{fn.__name__} {strategy}: {f} "
                                        f"differs from the single store")
                    mfg_checks += 1
        mid = sample_hops(dg, roots, ts, fanouts=[10, 10])
        layer_ms = {}
        for n, (r, t) in {"roots_12000": (roots, ts),
                          "roots_132000": (mid[0][0].root_nids,
                                           mid[0][0].root_ts)}.items():
            layer_ms[n] = dict(
                routed=cuda_ms(torch, lambda: sample_layer_routed(
                    pdg, r, t, fanout=10), iters=10, warmup=2),
                replicated=cuda_ms(torch, lambda: sample_layer_replicated(
                    pdg, r, t, fanout=10), iters=10, warmup=2),
                single_store=cuda_ms(torch, lambda: sample_layer(
                    dg, r, t, fanout=10), iters=10, warmup=2))
        cvs = [routed_load_stats(pg.partition_table, b.target_nodes,
                                 PARALLEL_PARTITIONS)["cv"] for b in tb]
        result["store"] = dict(
            partitions=PARALLEL_PARTITIONS, dispatch_s=dispatch_s,
            partition_edges=[pg.locals[p].num_edges() for p in pg.owned],
            mfg_checks_bit_equal=mfg_checks, sample_layer_ms=layer_ms,
            load_cv_mean=float(np.mean(cvs)), load_cv_max=float(max(cvs)),
            edge_table_bytes=store.memory_usage()["edge"])
        _log("parallel", path="store", **result["store"])

        # ---- TGN through PartitionedTrainer(routed) -------------------
        part, ptstate = tgn_trainer(PartitionedTrainer)
        result["partitioned"] = tgn_paths("partitioned", part, ptstate, pdg,
                                          store.edge_table, plain, pstate)
        result["partitioned"]["f32_vs_plain"] = _f32_held(
            torch, lambda m: PartitionedTrainer(
                m, fanouts=[10], lr=1e-4, device="cuda"), pdg,
            store.edge_table, stream, tb[warm:warm + 3])
        _log("parallel", path="partitioned", **result["partitioned"])
        del part, ptstate, plain, pstate

        # ---- memory sharded over the group, and the cache over sharded
        # masters --------------------------------------------------------
        result["memory"] = _sharded_memory(torch, kernels, stream, pdg,
                                           store, tb, eb, launches)
        _log("parallel", path="memory", **result["memory"])
        result["cache"] = _sharded_cache(torch, kernels, stream, launches)
        _log("parallel", path="cache", **result["cache"])

        # ---- TGAT on the layer dedup through routed sampling ----------
        model, tgat = _tgat(att_dropout=0.0, layer_dedup=0.5,
                            cls=PartitionedTrainer)
        tstate = tgat.init_state(num_nodes, seed=0)
        _reset(kernels)
        _, tev_ms, _ = _timed_steps(
            torch, lambda b: tgat.eval_step(tstate, pdg, store.edge_table,
                                            b), eb)
        launches["parallel_tgat_eval"] = _launch_counts(kernels)
        _check_launches(launches["parallel_tgat_eval"],
                        _expect(k3=2 * ev_runs),
                        f"{ev_runs} TGAT eval batches, partitioned")
        _reset(kernels)

        def tgat_step(b):
            loss = tgat.train_step(tstate, pdg, store.edge_table, b)[1]
            return loss, tstate.layer_dedup_compact

        touts, tms, thost = _timed_steps(torch, tgat_step, tb[:extra])
        launches["parallel_tgat_train"] = _launch_counts(kernels)
        compact = [o[1] for o in touts]
        _check_launches(launches["parallel_tgat_train"],
                        _expect(k3=2 * extra, k4=sum(compact)),
                        f"{extra} TGAT train steps, partitioned")
        tl = torch.stack([o[0] for o in touts]).float().cpu()
        if not bool(torch.isfinite(tl).all()) or sum(compact) < 1:
            raise AssertionError(f"partitioned TGAT: losses {tl}, steps on "
                                 f"the dedup {compact}")
        result["tgat"] = dict(eval_ms_per_batch=statistics.median(tev_ms),
                              train_steps=extra, compact_steps=sum(compact),
                              ms_per_step=statistics.median(tms),
                              host_ms_per_step=statistics.median(thost),
                              tier_takes=tgat.tier_take_stats(tstate))
        _log("parallel", path="tgat", **result["tgat"])
        del model, tgat, tstate, store, pg, pdg

        # ---- the partitioned script, joining the group ----------------
        _reset(kernels)
        t0 = time.perf_counter()
        sout = part_script.main(["--model", "TGN", "--epoch", "1",
                                 "--num-devices", "1", "--num-partitions",
                                 str(PARALLEL_PARTITIONS)])
        torch.cuda.synchronize()
        launches["parallel_script"] = _launch_counts(kernels)
        sl = launches["parallel_script"]
        if not (sout["val_ap"] and 0.0 < sout["val_ap"][0] <= 1.0
                and sl["gru_memory_fused"] and sl["gru_memory_fused_bwd"]
                and sl["neighborhood_attention"]):
            raise AssertionError(f"partitioned script: {sout}, {sl}")
        result["script"] = dict(seconds=time.perf_counter() - t0,
                                launches=sl, **sout)
        _log("parallel", path="script", **result["script"])
    finally:
        shutdown()
        if os.path.exists(rdv):
            os.remove(rdv)
    every = {k: sum(c[k] for c in launches.values())
             for k in kernels}
    if not all(every.values()):
        raise AssertionError(f"a kernel never launched on the parallel "
                             f"paths: {every}")
    return dict(launches=launches, **result)


def _launch_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _expect(k1=0, k2=0, k3=0, k4=0):
    return {"gru_memory_fused": k1, "gru_memory_fused_bwd": k2,
            "neighborhood_attention": k3, "sorted_segment_sum": k4}


def _sharded_memory(torch, kernels, stream, pdg, store, tb, eb, launches):
    """``[parallel] memory`` (phase 16): TGN at the REDDIT defaults (bf16,
    batch 4000, fanout 10, memory 100) through ``PartitionedTrainer`` on
    memory passed through ``shard_memory_state`` (one block at world size
    1: every pull is a routed exchange over NCCL), beside the same trainer
    on replicated memory: train steps and eval batches, ms and host ms.
    Then 3 f32 steps at dropout 0 of each from one set of weights, equal
    exactly (loss after each step; parameters and memory), per instance
    and on the memory dedup at 0.35 over the stream's 128-dim node table
    sharded in a ``ShardedTable`` (K4 once a step that fits)."""
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.parallel import (PartitionedTrainer, ShardedTable,
                                            shard_memory_state,
                                            unshard_memory)
    num_nodes = stream["g"].max_vertex_id() + 1
    warm = 3
    steps, ev_runs = len(tb) - warm, len(eb)
    table = store.edge_table

    def make(sharded, cfg, compute_dtype, dedup=None):
        model = DGNN(dim_edge=172, compute_dtype=compute_dtype, seed=0,
                     device="cuda", **cfg)
        trainer = PartitionedTrainer(model, fanouts=[10], lr=1e-4,
                                     dedup_factor=dedup, device="cuda")
        state = trainer.init_state(num_nodes, seed=0)
        if sharded:
            state.memory = shard_memory_state(state.memory, trainer.dp.group)
        return model, trainer, state

    out = {}
    for name, sharded in (("replicated", False), ("sharded", True)):
        model, trainer, state = make(sharded, TGN, "bfloat16")
        for b in tb[:warm]:
            trainer.train_step(state, pdg, table, b)
        torch.cuda.synchronize()
        _reset(kernels)
        outs, ms, host = _timed_steps(
            torch, lambda b: trainer.train_step(state, pdg, table, b)[1],
            tb[warm:])
        tl = _launch_counts(kernels)
        _reset(kernels)
        evs, ev_ms, ev_host = _timed_steps(
            torch, lambda b: trainer.eval_step(state, pdg, table, b)[1], eb)
        el = _launch_counts(kernels)
        _check_launches(tl, _expect(k1=steps, k2=steps),
                        f"{steps} {name}-memory train steps")
        _check_launches(el, _expect(k1=ev_runs, k3=ev_runs),
                        f"{ev_runs} {name}-memory eval batches")
        launches[f"parallel_memory_{name}_train"] = tl
        launches[f"parallel_memory_{name}_eval"] = el
        losses = torch.stack(outs + evs).float().cpu()
        if not (bool(torch.isfinite(losses).all())
                and _all_finite(torch, state, model)):
            raise AssertionError(f"{name} memory: non-finite values")
        out[name] = dict(ms_per_step=statistics.median(ms),
                         host_ms_per_step=statistics.median(host),
                         eval_ms_per_batch=statistics.median(ev_ms),
                         eval_host_ms_per_batch=statistics.median(ev_host),
                         mean_loss=float(losses[:steps].mean()),
                         memory_bytes=state.memory.nbytes,
                         local_rows=state.memory.node_memory.shape[0])
        del model, trainer, state

    nt = ShardedTable(stream["nf"].cpu().numpy(), device="cuda")
    f32 = dict(TGN, dropout=0.0, att_dropout=0.0)
    for name, cfg, dedup, nfeat in (
            ("f32_exact", f32, None, None),
            ("f32_exact_dedup", dict(f32, dim_node=128), 0.35, nt)):
        (rm, rt, rs), (sm, st, ss) = (make(s, cfg, None, dedup)
                                      for s in (False, True))
        same, fast, counted = [], 0, {k: 0 for k in kernels}
        for b in tb[warm:warm + 3]:
            want = rt.train_step(rs, pdg, table, b, node_feats=nfeat)[1]
            _reset(kernels)
            got = st.train_step(ss, pdg, table, b, node_feats=nfeat)[1]
            for k, v in _launch_counts(kernels).items():
                counted[k] += v
            fast += _fast_steps(st, ss, 4000 * 3 * 11) if dedup else 0
            same.append(bool(torch.equal(got, want)))
        full = unshard_memory(ss.memory)
        params = all(torch.equal(a, w) for a, w in zip(sm.parameters(),
                                                       rm.parameters()))
        memory = all(torch.equal(getattr(full, k), getattr(rs.memory, k))
                     for k in ("node_memory", "node_memory_ts", "mailbox",
                               "mailbox_ts"))
        res = dict(steps=3, losses_equal=same, params_equal=params,
                   memory_equal=memory, fast_steps=fast, launches=counted)
        out[name] = res
        launches[f"parallel_memory_{name}"] = counted
        if not (all(same) and params and memory):
            raise AssertionError(f"sharded memory {name}: {res}")
        if dedup and not (fast and counted["sorted_segment_sum"] == fast):
            raise AssertionError(f"sharded memory {name}: K4 launched "
                                 f"{counted['sorted_segment_sum']} times "
                                 f"in {fast} steps on the dedup")
        del rm, rt, rs, sm, st, ss, full
    return out


def _sharded_cache(torch, kernels, stream, launches):
    """``[parallel] cache`` (phase 16): LRU at 0.3 over a ``ShardedTable``
    master holding the REDDIT-shaped stream's 172-dim edge table (one
    block on the card at world size 1; misses are routed pulls) against
    the host-master cache: features, target-edge features and hit ratios
    equal bit for bit over 5 batches from the middle of the train split;
    then 20 bf16 TGN train steps through each cache, timed; then one
    ``--max-steps``-cut epoch of the multiprocess script with ``--cache``,
    joining the group."""
    from gnnflow_tpu_torch.cache import LRUCache
    from gnnflow_tpu_torch.parallel import ShardedTable
    from gnnflow_tpu_torch.scripts import \
        offline_edge_prediction_multiprocess as mp_script
    from gnnflow_tpu_torch.temporal_sampler import TemporalSampler
    g, train, full = stream["g"], stream["train"], stream["full"]
    num_nodes = g.max_vertex_id() + 1
    ef_np = stream["ef"].cpu().numpy()
    t0 = time.perf_counter()
    master = ShardedTable(ef_np, device="cuda")
    torch.cuda.synchronize()
    res = dict(table_mb=ef_np.nbytes / 1e6,
               master_upload_s=time.perf_counter() - t0, ratio=CACHE_RATIO)
    sampler = TemporalSampler(g, [10])
    warm, steps, checked = 3, 20, 5
    batches = _take(train[len(train) // 2:], CACHE_BATCH, train.dst,
                    warm + steps)

    def cache_over(table):
        c = LRUCache(CACHE_RATIO, 0, num_nodes, len(full), None, table)
        c.init_cache()
        return c

    dist, host = cache_over(master), cache_over(ef_np)
    bad = []
    for i, b in enumerate(batches[:checked]):
        mfgs = sampler.sample(b.target_nodes, b.ts)
        _, defs = dist.fetch_feature(mfgs, b.eids)
        _, hefs = host.fetch_feature(mfgs, b.eids)
        if not (torch.equal(defs[0][0], hefs[0][0])
                and torch.equal(dist.target_edge_features,
                                host.target_edge_features)
                and dist.cache_edge_ratio == host.cache_edge_ratio):
            bad.append(i)
    res.update(batches_equal=checked - len(bad),
               hit_ratio=dist.cache_edge_ratio,
               hit_ratio_host=host.cache_edge_ratio)
    if bad:
        raise AssertionError(f"sharded-master cache differs from the host "
                             f"one on batches {bad}")
    del dist, host
    for name, table in (("host_master", ef_np), ("sharded_master", master)):
        model, trainer, state = _tgn_cached(torch, num_nodes, "bfloat16")
        cache = cache_over(table)
        _cached_steps(torch, trainer, state, sampler, cache,
                      batches[:warm])
        cache.reset()
        _reset(kernels)
        losses, ms, host_ms = _cached_steps(torch, trainer, state, sampler,
                                            cache, batches[warm:])
        launches[f"parallel_cache_{name}"] = _launch_counts(kernels)
        _check_launches(launches[f"parallel_cache_{name}"],
                        _expect(k1=steps, k2=steps),
                        f"{steps} cached train steps, {name}")
        if not (bool(torch.isfinite(losses).all())
                and _all_finite(torch, state, model)):
            raise AssertionError(f"cached steps over the {name}: "
                                 f"non-finite values")
        res[name] = dict(train_ms_per_step=ms, train_host_ms_per_step=host_ms,
                         hit_ratio=cache.cache_edge_ratio,
                         mean_loss=float(losses.mean()))
        del model, trainer, state, cache
    del master
    _reset(kernels)
    t0 = time.perf_counter()
    out = mp_script.main(["--model", "TGN", "--epoch", "1", "--coordinator",
                          "unused:0", "--num-processes", "1",
                          "--process-id", "0", "--cache", "LRUCache",
                          "--edge-cache-ratio", str(CACHE_RATIO),
                          "--max-steps", "5"])
    torch.cuda.synchronize()
    sl = _launch_counts(kernels)
    launches["parallel_cache_script"] = sl
    if not (out["val_ap"] and 0.0 < out["val_ap"][0] <= 1.0
            and 0.0 < out["cache_edge_hit"][0] <= 1.0
            and sl["gru_memory_fused"] and sl["gru_memory_fused_bwd"]
            and sl["neighborhood_attention"]):
        raise AssertionError(f"multiprocess script with --cache: {out}, "
                             f"{sl}")
    res["script"] = dict(seconds=time.perf_counter() - t0, launches=sl,
                         **out)
    return res


# bf16 storage against f32 storage, f32 compute, free-running from one set
# of weights: a stored value rounds by at most 2^-8 of max(|x|, 1), and the
# GRU amplifies what its inputs differ by from one step to the next, by an
# order of magnitude at the third step at these widths, as JAX's bf16
# storage parts from its f32 storage (tests/test_torch_distmem.py holds the
# port's bf16 storage to JAX's): 1/8 holds three steps; the loss to 1e-3
STORAGE_TOL = dict(loss_rel=1e-3, memory_rel=2 ** -3)


def phase_storage(torch, kernels, stream):
    """Phase 17: TGN with ``memory_storage="bfloat16"`` beside f32
    storage at the REDDIT defaults (bf16 compute, batch 4000, fanout 10,
    memory 100, the memory dedup off): 20 train steps each (K1 and K2 once
    a step), ms/step by CUDA events and host ms, the memory state's bytes
    and the steps' peak memory; then 3 f32-compute steps at dropout 0 of
    each storage from one set of weights: the bf16-stored run's loss and
    memory and mails (each difference over max(|x|, 1)) apart from the
    f32-stored run's by bf16 rounding only, within ``STORAGE_TOL``."""
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    g, dg, ef, train = stream["g"], stream["dg"], stream["ef"], \
        stream["train"]
    num_nodes = g.max_vertex_id() + 1
    warm, steps = 3, 20
    tb = _take(train, 4000, train.dst, warm + steps)

    def make(storage, **over):
        cfg = {**TGN, **over}
        model = DGNN(dim_edge=172, seed=0, device="cuda", **cfg)
        trainer = Trainer(model, fanouts=[10], lr=1e-4, dedup_factor=None,
                          memory_storage=storage, device="cuda")
        return model, trainer, trainer.init_state(num_nodes, seed=0)

    res, launches = {}, {}
    for storage in ("float32", "bfloat16"):
        model, trainer, state = make(storage, compute_dtype="bfloat16")
        for b in tb[:warm]:
            trainer.train_step(state, dg, ef, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset(kernels)
        outs, ms, host = _timed_steps(
            torch, lambda b: trainer.train_step(state, dg, ef, b)[1],
            tb[warm:])
        launches[f"storage_{storage}_train"] = _launch_counts(kernels)
        _check_launches(launches[f"storage_{storage}_train"],
                        _expect(k1=steps, k2=steps),
                        f"{steps} train steps, {storage} storage")
        losses = torch.stack(outs).float().cpu()
        if not (bool(torch.isfinite(losses).all())
                and all(bool(torch.isfinite(t.float()).all())
                        for t in state.memory.tensors().values())):
            raise AssertionError(f"{storage} storage: non-finite values")
        mem = state.memory
        res[storage] = dict(
            ms_per_step=statistics.median(ms),
            host_ms_per_step=statistics.median(host),
            memory_state_bytes=mem.nbytes,
            memory_mail_bytes=mem.node_memory.nbytes + mem.mailbox.nbytes,
            peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
            peak_over_start_mib=(torch.cuda.max_memory_allocated() - base)
            / 2 ** 20, mean_loss=float(losses.mean()))
        del model, trainer, state, mem
    f32 = dict(dropout=0.0, att_dropout=0.0)
    sides = {s: make(s, **f32) for s in ("float32", "bfloat16")}
    errs = dict(loss_rel=[], memory_rel=[])
    for b in tb[warm:warm + 3]:
        loss = {s: t.train_step(st, dg, ef, b)[1]
                for s, (_, t, st) in sides.items()}
        errs["loss_rel"].append(_rel(loss["bfloat16"], loss["float32"]))
        a, w = sides["bfloat16"][2].memory, sides["float32"][2].memory
        errs["memory_rel"].append(max(
            float(((getattr(a, k).float() - getattr(w, k)).abs()
                   / getattr(w, k).abs().clamp_min(1.0)).max())
            for k in ("node_memory", "mailbox")))
    res["f32_compute"] = dict(steps=3, tol=STORAGE_TOL, **errs)
    ratio = res["bfloat16"]["memory_mail_bytes"] \
        / res["float32"]["memory_mail_bytes"]
    res["memory_mail_bytes_ratio"] = ratio
    _log("train", path="storage", **res)
    if ratio != 0.5 or any(max(errs[k]) > STORAGE_TOL[k] for k in errs):
        raise AssertionError(f"bf16 storage: {res}")
    return dict(launches=launches, **res)


def start_parity():
    """Start phase 19's smoke run of the port's parity harness
    (``gnnflow_tpu_torch.scripts.parity_run --smoke --smoke-models TGN``)
    as a subprocess, which runs each cell as a subprocess of the training
    script on the card; the phases that time nothing run beside it.
    Returns what :func:`phase_parity` waits for."""
    from gnnflow_tpu_torch.ops import _build
    path = os.path.join(_build.BUILD_DIR, "parity_smoke_torch.json")
    log = open(os.path.join(_build.BUILD_DIR, "parity_smoke_torch.log"), "w")
    if os.path.exists(path):
        os.remove(path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gnnflow_tpu_torch.scripts.parity_run",
         "--smoke", "--smoke-models", "TGN", "--json-out", path,
         "--timeout", "300"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log, stderr=subprocess.STDOUT)
    return dict(proc=proc, path=path, log=log, t0=time.perf_counter())


def stop_parity(run) -> None:
    """Stop the harness where it still runs (after a failure)."""
    if run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()
    run["log"].close()


def phase_parity(run):
    """Phase 18: the port's parity harness in its smoke mode on the card
    at the default smoke size (3 epochs of a 20,000-edge synthetic stream)
    for TGN and the two host cells (the GDELT analogue with 182-dim edge
    features and the MAG analogue with bf16 memory storage, both with the
    feature tables on the host behind an LRU cache), started by
    :func:`start_parity`: its exit code, verdict and each cell's AP.
    Then the harness without data: every cell skipped, the verdict
    NO-DATA."""
    import contextlib
    import io
    import json
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.scripts import parity_run
    rc = run["proc"].wait(timeout=900)
    run["log"].close()
    seconds = time.perf_counter() - run["t0"]
    if not os.path.exists(run["path"]):
        with open(run["log"].name) as f:
            raise AssertionError(f"parity harness exited {rc}: "
                                 f"{f.read()[-3000:]}")
    with open(run["path"]) as f:
        report = json.load(f)
    res = dict(seconds=seconds, rc=rc,
               verdict=report["summary"]["verdict"],
               cells={c["dataset"]: dict(status=c["status"],
                                         test_ap=c.get("test_ap"),
                                         test_auc=c.get("test_auc"),
                                         elapsed_s=c.get("elapsed_s"))
                      for c in report["cells"]})
    empty = os.path.join(_build.BUILD_DIR, "parity_no_data")
    os.makedirs(empty, exist_ok=True)
    nd = os.path.join(_build.BUILD_DIR, "parity_no_data_torch.json")
    with contextlib.redirect_stdout(io.StringIO()):   # its per-cell lines
        res["no_data_rc"] = parity_run.main(["--data-dir", empty,
                                             "--json-out", nd])
    with open(nd) as f:
        res["no_data_verdict"] = json.load(f)["summary"]["verdict"]
    _log("parity", **res)
    if not (rc == 0 and res["verdict"] == "PASS"
            and len(res["cells"]) == 3 and res["no_data_rc"] == 0
            and res["no_data_verdict"] == "NO-DATA"):
        raise AssertionError(f"parity: {res}, "
                             f"{[c.get('tail') for c in report['cells']]}")
    return res


VARIANT_RATIO = 3      # negatives per edge on the [variants] ratio path
# f32 agreement of the variants with the default path from one state:
# the GRU table against K1 per instance and the factorized attention
# against K3 reorder f32 sums (losses relative, parameters and memory
# absolute, logits absolute); remat and the scanned steps run the same
# kernels on the same inputs, so they are held bit for bit
VARIANT_TOL = dict(loss_rel=1e-5, param=1e-5, memory=1e-4, logits=1e-4)


def _tgn_variant(compute_dtype="bfloat16", fanouts=(10,), ratio=1,
                 dedup=None, trainer_kw=None, **over):
    """TGN at the REDDIT defaults (``TGN``, bench.py:262-267) with ``over``
    changed (``num_layers`` from ``fanouts``), ``ratio`` negatives per
    edge, seeded weights, and its trainer (memory dedup ``dedup``)."""
    from gnnflow_tpu_torch.models.dgnn import DGNN
    from gnnflow_tpu_torch.train import Trainer
    model = DGNN(dim_edge=172, compute_dtype=compute_dtype, seed=0,
                 device="cuda", neg_sample_ratio=ratio,
                 **{**TGN, "num_layers": len(fanouts), **over})
    return model, Trainer(model, fanouts=list(fanouts), lr=1e-4,
                          device="cuda", neg_sample_ratio=ratio,
                          dedup_factor=dedup, **(trainer_kw or {}))


def _variant_path(torch, kernels, name, step, batches, expected):
    """``step`` over ``batches`` with the launch counts from 0 and the
    peak memory from the start; ``expected(outs)`` gives the launches
    each kernel must have made.  Returns the outputs and the path's
    numbers (medians of CUDA events between steps and of the host
    clock)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    outs, dev_ms, host_ms = _timed_steps(torch, step, batches)
    launches = {n: fn.launches for n, fn in kernels.items()}
    losses = torch.stack([o[0] for o in outs]).float()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"[variants] {name}: a non-finite loss")
    _check_launches(launches, expected(outs), f"[variants] {name}")
    return outs, dict(steps=len(batches), ms=statistics.median(dev_ms),
                      host_ms=statistics.median(host_ms),
                      max_memory_allocated_mib=
                      torch.cuda.max_memory_allocated() / 2 ** 20,
                      mean_loss=float(losses.mean()), launches=launches)


def _k(k1=0, k2=0, k3=0, k4=0):
    return lambda _outs: _expect(k1, k2, k3, k4)


def _k1_at(torch, w, n):
    """K1 against its plain version at ``n`` rows of the main path's
    widths (bf16 memory and mails as the bf16 pull gives them, dts up to
    2.7e6), with K1's tolerance of phase 3; times the kernel, the plain
    version and ``torch.gru_cell``."""
    from gnnflow_tpu_torch.ops.gru_fused import (gru_memory_fused,
                                                 gru_memory_fused_ref)
    f, dr, dt = 100, 372, 100
    ki = torch.randn(dr + dt, 3 * f, **w) * 0.05
    kh = torch.randn(f, 3 * f, **w) * 0.05
    bi, bh = torch.randn(3 * f, **w) * 0.05, torch.randn(3 * f, **w) * 0.05
    tw = (1.0 / 10 ** torch.linspace(0, 9, dt, device="cuda")).float()
    tb = torch.randn(dt, **w) * 0.1
    dts = torch.rand(n, **w) * 1e3
    dts[::7] = torch.rand(dts[::7].shape, **w) * 2.7e6
    mem = (torch.randn(n, f, **w) * 0.5).bfloat16()
    mail = (torch.randn(n, dr, **w) * 0.5).bfloat16()
    args = (mem, mail, dts, ki.bfloat16(), bi, kh.bfloat16(), bh, tw, tb,
            "bfloat16")
    got = gru_memory_fused(*args)
    torch.cuda.synchronize()
    err = (got - gru_memory_fused_ref(*args)).abs().max().item()
    tol = 2e-3
    if not err <= tol or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K1 at {n} rows: max_abs_err {err} > {tol}")
    nbytes = _nbytes(mem, mail, dts, got) + _nbytes(*args[3:9])
    bound, by = _bound(nbytes, 2.0 * n * ((dr + dt) * 3 * f + f * 3 * f),
                       "bfloat16")
    ms = cuda_ms(torch, lambda: gru_memory_fused(*args), iters=10)
    out = dict(n=n, max_abs_err=err, tol=tol, ms=ms,
               plain_ms=cuda_ms(torch, lambda: gru_memory_fused_ref(*args),
                                iters=5),
               library_ms=_gru_library_ms(torch, mem, mail, dts, ki, kh, bi,
                                          bh, tw, tb, torch.bfloat16),
               bound_ms=bound, bound_by=by, share=bound / ms)
    del got
    return out


def phase_variants(torch, kernels, stream):
    """The opt-in variants at the REDDIT defaults of TGN (bf16, batch
    4000), each path with its launch check: TGN at three negatives per
    edge (20,000 roots, 220,000 memory rows: eval, train at the default
    dropouts with the default trainer, at attention dropout 0, on the
    memory dedup at 0.35); TGN with memory over two layers (fanouts [10,
    10]: 1,452,000 innermost rows pulled from memory; eval, train, peak
    memory); the GRU gate table against the per-instance step; remat
    against the plain step (two layers, attention dropout 0); the
    factorized attention's eval against K3's; ``train_steps_scan`` against
    the per-step loop, and one epoch of the script with ``--use-scan``;
    one train step of each memory updater without time encoding; a
    REPLACE store's ingestion beside INSERT's.  The f32 checks run each
    variant and its default path from one state (``VARIANT_TOL``).  Then
    K1 at 220,000 and 1,452,000 rows, K3 at the ratio path's 20,000 and
    the inner layer's 132,000 rows and K4 at the ratio path's dedup (each
    on a sample of stream batch ``PROBE_BATCH``) against their plain
    versions."""
    import numpy as np
    from gnnflow_tpu_torch.dynamic_graph import DynamicGraph
    from gnnflow_tpu_torch.ops import _build
    from gnnflow_tpu_torch.ops.attention_fused import \
        neighborhood_attention_autograd as attention_autograd
    from gnnflow_tpu_torch.ops.dedup import dedup_instances
    from gnnflow_tpu_torch.ops.sampling import sample_hops
    from gnnflow_tpu_torch.scripts import offline_edge_prediction as entry
    from gnnflow_tpu_torch.train import dedup_cap
    g, dg, ef, train, full = stream["g"], stream["dg"], stream["ef"], \
        stream["train"], stream["full"]
    num_nodes = g.max_vertex_id() + 1
    B, r, warm, runs, extra = 4000, VARIANT_RATIO, 2, 10, 5
    w = dict(device=torch.device("cuda"),
             generator=torch.Generator(device="cuda").manual_seed(3))
    out, launches, rows = {}, {}, {}

    def trained(trainer, state):
        return lambda b: trainer.train_step(state, dg, ef, b)[1:]

    def evaluated(trainer, state):
        return lambda b: trainer.eval_step(state, dg, ef, b)[1:]

    def fast(trainer, state, num_all):
        """A train step that also says whether it took the dedup."""
        def step(b):
            res = trainer.train_step(state, dg, ef, b)[1:]
            return res + (_fast_steps(trainer, state, num_all),)
        return step

    # ---- TGN at three negatives per edge -----------------------------
    num_all = (2 + r) * B * 11
    tb = _take(train, B, train.dst, warm + runs + extra, ratio=r)
    eb = _take(full, B, full.dst, warm + runs, ratio=r)
    model, trainer = _tgn_variant(ratio=r)
    state = trainer.init_state(num_nodes, seed=0)
    for b in eb[:warm]:
        trainer.eval_step(state, dg, ef, b)
    outs, ev = _variant_path(torch, kernels, "ratio eval",
                             evaluated(trainer, state), eb[warm:],
                             _k(k1=runs, k3=runs))
    if not all(o[2].shape == (r * B,) for o in outs):
        raise AssertionError("[variants] ratio eval: negative logits are "
                             "not [r·B]")
    model, trainer = _tgn_variant(ratio=r, dedup="auto")
    state = trainer.init_state(num_nodes, seed=0)
    for b in tb[:warm]:
        trainer.train_step(state, dg, ef, b)
    _, tr = _variant_path(torch, kernels, "ratio train",
                          fast(trainer, state, num_all),
                          tb[warm:warm + runs],
                          lambda o: _expect(runs, runs, 0,
                                            sum(x[-1] for x in o)))
    tr["calibration"] = trainer.calibration
    model, trainer = _tgn_variant(ratio=r, att_dropout=0.0)
    state = trainer.init_state(num_nodes, seed=0)
    bwd0 = attention_autograd.backward_calls
    _, tr0 = _variant_path(torch, kernels, "ratio train att_dropout 0",
                           trained(trainer, state), tb[-extra:],
                           _k(extra, extra, extra))
    if attention_autograd.backward_calls - bwd0 != extra:
        raise AssertionError("[variants] ratio: K3's backward did not run "
                             "once a step at attention dropout 0")
    model, trainer = _tgn_variant(ratio=r, dedup=0.35)
    state = trainer.init_state(num_nodes, seed=0)
    _, dd = _variant_path(torch, kernels, "ratio dedup",
                          fast(trainer, state, num_all), tb[:runs],
                          lambda o: _expect(runs, runs, 0,
                                            sum(x[-1] for x in o)))
    if dd["launches"]["sorted_segment_sum"] < 1:
        raise AssertionError("[variants] ratio dedup: no step fit the cap")
    launches.update(variants_ratio_eval=ev["launches"],
                    variants_ratio_train=tr["launches"],
                    variants_ratio_att_dropout0=tr0["launches"],
                    variants_ratio_dedup=dd["launches"])
    out["ratio"] = dict(ratio=r, roots=(2 + r) * B, memory_rows=num_all,
                        eval=ev, train=tr, train_att_dropout0=tr0, dedup=dd)
    _log("variants", path="ratio", **out["ratio"])
    # K3's mask and K4's segments from a mid-stream batch (the first
    # batches' histories are short)
    probe = _take(full, B, full.dst, PROBE_BATCH, ratio=r)[-1]
    m = sample_hops(dg, torch.from_numpy(probe.target_nodes).cuda(),
                    torch.from_numpy(probe.ts).cuda(), fanouts=[10])[0][0]
    rows["neighborhood_attention"] = {"ratio_B20000": _kernel_k3(
        torch, w, m.nbr_mask.contiguous(), torch.bfloat16, 2 ** -6, 1e-5)}
    cap = dedup_cap(0.35, m.num_all)
    *_, n_uniq, _, seg = dedup_instances(m.all_nodes(), m.all_ts(),
                                         m.all_mask(), cap)
    rows["sorted_segment_sum"] = {"ratio_dedup": dict(
        L=m.num_all, cap=cap, **_k4_check(torch, w, seg, cap, int(n_uniq),
                                          100))}
    rows["gru_memory_fused"] = {"ratio_N220000": _k1_at(torch, w, num_all)}
    del model, trainer, state, outs, m, seg

    # ---- memory over two layers --------------------------------------
    num_all2 = 3 * B * 11 * 11
    gb = _take(train, B, train.dst, warm + runs)
    model, trainer = _tgn_variant(fanouts=(10, 10))
    state = trainer.init_state(num_nodes, seed=0)
    eb2 = _take(full, B, full.dst, warm + 5)
    for b in eb2[:warm]:
        trainer.eval_step(state, dg, ef, b)
    _, ev2 = _variant_path(torch, kernels, "two-layer eval",
                           evaluated(trainer, state), eb2[warm:],
                           _k(k1=5, k3=10))
    model, trainer = _tgn_variant(fanouts=(10, 10), dedup="auto")
    state = trainer.init_state(num_nodes, seed=0)
    for b in gb[:warm]:
        trainer.train_step(state, dg, ef, b)
    _, tr2 = _variant_path(torch, kernels, "two-layer train",
                           fast(trainer, state, num_all2),
                           gb[warm:warm + 5],
                           lambda o: _expect(5, 5, 0,
                                             sum(x[-1] for x in o)))
    tr2["calibration"] = trainer.calibration
    launches.update(variants_two_layer_eval=ev2["launches"],
                    variants_two_layer_train=tr2["launches"])
    out["two_layer"] = dict(memory_rows=num_all2, eval=ev2, train=tr2)
    _log("variants", path="two_layer", **out["two_layer"])
    probe = _take(full, B, full.dst, PROBE_BATCH)[-1]
    inner = sample_hops(dg, torch.from_numpy(probe.target_nodes).cuda(),
                        torch.from_numpy(probe.ts).cuda(),
                        fanouts=[10, 10])[0][0]
    rows["neighborhood_attention"]["two_layer_B132000"] = _kernel_k3(
        torch, w, inner.nbr_mask.contiguous(), torch.bfloat16, 2 ** -6,
        1e-5)
    del model, trainer, state, inner
    rows["gru_memory_fused"]["two_layer_N1452000"] = _k1_at(torch, w,
                                                            num_all2)

    # ---- the GRU gate table against the per-instance step ------------
    paths = {}
    for name, kw, k in (("per_instance", {}, _k(runs, runs)),
                        ("gru_table", {"gru_table": True}, _k())):
        model, trainer = _tgn_variant(trainer_kw=kw)
        state = trainer.init_state(num_nodes, seed=0)
        for b in gb[:warm]:
            trainer.train_step(state, dg, ef, b)
        _, paths[name] = _variant_path(torch, kernels, f"gru {name}",
                                       trained(trainer, state), gb[warm:],
                                       k)
    launches["variants_gru_table"] = paths["gru_table"]["launches"]
    paths["f32"] = _f32_pair(torch, num_nodes, dg, ef, gb[:3],
                             dict(trainer_kw={"gru_table": True}), {})
    out["gru_table"] = paths
    _log("variants", path="gru_table", **paths)

    # ---- remat against the plain step: two layers, K3 in training ----
    rb = gb[:warm + 5]
    paths = {}
    for name, remat, k3 in (("plain", False, 10), ("remat", True, 20)):
        model, trainer = _tgn_variant(fanouts=(10, 10), att_dropout=0.0,
                                      remat_attention=remat)
        state = trainer.init_state(num_nodes, seed=0)
        for b in rb[:warm]:
            trainer.train_step(state, dg, ef, b)
        _, paths[name] = _variant_path(torch, kernels, f"remat {name}",
                                       trained(trainer, state), rb[warm:],
                                       _k(5, 5, k3))
        del model, trainer, state
    launches["variants_remat"] = paths["remat"]["launches"]
    paths["f32"] = _f32_pair(torch, num_nodes, dg, ef, rb[:3],
                             dict(fanouts=(10, 10), dropout=0.2,
                                  att_dropout=0.2, remat_attention=True),
                             dict(fanouts=(10, 10), dropout=0.2,
                                  att_dropout=0.2), exact=True)
    out["remat"] = paths
    _log("variants", path="remat", **paths)

    # ---- factorized attention against K3: eval -----------------------
    paths = {}
    for name, impl, k3 in (("k3", "xla", runs),
                           ("factorized", "xla_factorized", 0)):
        model, trainer = _tgn_variant(attention_impl=impl)
        state = trainer.init_state(num_nodes, seed=0)
        eb1 = _take(full, B, full.dst, warm + runs)
        for b in eb1[:warm]:
            trainer.eval_step(state, dg, ef, b)
        _, paths[name] = _variant_path(torch, kernels, f"attention {name}",
                                       evaluated(trainer, state), eb1[warm:],
                                       _k(k1=runs, k3=k3))
    launches["variants_factorized_eval"] = paths["factorized"]["launches"]
    paths["f32"] = _f32_pair(torch, num_nodes, dg, ef, eb1[:3],
                             dict(attention_impl="xla_factorized"), {},
                             train=False)
    out["factorized"] = paths
    _log("variants", path="factorized", **paths)

    # ---- the scanned steps: bit-equal to the loop; the script --------
    sb = gb[:5]
    model, trainer = _tgn_variant()
    state = trainer.init_state(num_nodes, seed=0)
    loop = torch.stack([trainer.train_step(state, dg, ef, b)[1]
                        for b in sb])
    model, trainer = _tgn_variant()
    state = trainer.init_state(num_nodes, seed=0)
    arrays = [torch.stack(t) for t in
              zip(*map(trainer.batch_arrays, sb))]
    torch.cuda.synchronize()
    _reset(kernels)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, scan = trainer.train_steps_scan(state, dg, ef, *arrays)
    end.record()
    torch.cuda.synchronize()
    scan_launches = {n: fn.launches for n, fn in kernels.items()}
    _check_launches(scan_launches, _expect(5, 5), "[variants] scan")
    if not torch.equal(loop, scan):
        raise AssertionError(f"[variants] scan: losses {scan.tolist()} "
                             f"differ from the loop's {loop.tolist()}")
    _reset(kernels)
    t0 = time.perf_counter()
    res = entry.main(["--model", "TGN", "--data", "SYNTHETIC", "--epoch",
                      "1", "--use-scan"], checkpoint_path=os.path.join(
                          _build.BUILD_DIR, "TGN_scan_torch.ckpt"))
    torch.cuda.synchronize()
    script = dict(seconds=time.perf_counter() - t0,
                  launches={n: fn.launches for n, fn in kernels.items()},
                  val_ap=res["val_ap"], test_ap=res["test_ap"])
    if not (0.0 < res["test_ap"] <= 1.0
            and script["launches"]["gru_memory_fused_bwd"] > 0):
        raise AssertionError(f"[variants] --use-scan: {script}")
    launches.update(variants_scan=scan_launches,
                    variants_scan_script=script["launches"])
    out["scan"] = dict(steps=5, ms_per_step=start.elapsed_time(end) / 5,
                       losses_bit_equal=True, launches=scan_launches,
                       script=script)
    _log("variants", path="scan", **out["scan"])

    # ---- memory updaters without time encoding: one train step each --
    paths = {}
    for name, over in (("gru", {}), ("transformer", dict(
            memory_updater="transformer", mailbox_slots=10))):
        model, trainer = _tgn_variant(dim_time=0, **over)
        state = trainer.init_state(num_nodes, seed=0)
        _, paths[name] = _variant_path(torch, kernels, f"no time {name}",
                                       trained(trainer, state), gb[:1],
                                       _k())
        if not _all_finite(torch, state, model):
            raise AssertionError(f"[variants] {name} without time "
                                 "encoding: a non-finite value")
    launches["variants_no_time"] = {
        n: sum(p["launches"][n] for p in paths.values()) for n in kernels}
    out["no_time_encoding"] = paths
    _log("variants", path="no_time_encoding", **paths)

    # ---- a REPLACE store beside INSERT: ingestion ---------------------
    stores = {}
    for policy in ("insert", "replace"):
        t0 = time.perf_counter()
        s = DynamicGraph(initial_pool_size=1 << 20,
                         maximum_pool_size=1 << 24, minimum_block_size=62,
                         insertion_policy=policy)
        for lo in range(0, len(full), 100_000):
            sl = slice(lo, lo + 100_000)
            s.add_edges(full.src[sl], full.dst[sl], full.time[sl],
                        full.eid[sl], add_reverse=True)
        stores[policy] = (s, (time.perf_counter() - t0) * 1e3)
    ins, rep = stores["insert"][0], stores["replace"][0]
    b = eb[-1]
    roots = torch.from_numpy(b.target_nodes).cuda()
    ts = torch.from_numpy(b.ts).cuda()
    a_, b_ = (sample_hops(s.device_graph("cuda"), roots, ts,
                          fanouts=[10])[0][0] for s in (ins, rep))
    same = all(torch.equal(getattr(a_, f), getattr(b_, f)) for f in (
        "nbr_nids", "nbr_ts", "nbr_eids", "nbr_mask"))
    if not (same and np.array_equal(ins._row_len, rep._row_len)):
        raise AssertionError("[variants] the REPLACE store samples other "
                             "neighbours than INSERT")
    out["replace_store"] = dict(
        edges=2 * len(full), insert_ingest_ms=stores["insert"][1],
        replace_ingest_ms=stores["replace"][1],
        insert_pool_used=ins._pool_used, replace_pool_used=rep._pool_used,
        samples_equal=same)
    _log("variants", path="replace_store", **out["replace_store"])
    del stores, ins, rep
    for name, sub in rows.items():
        _log("variants", kernel=name, **sub)
    return dict(launches=launches, rows=rows, **out)


def _f32_pair(torch, num_nodes, dg, ef, batches, over_a, over_b,
              exact=False, train=True):
    """Variant ``over_a`` against ``over_b`` in f32 at dropout 0 (unless
    set), from the same seeded weights and state: 3 train steps (losses,
    parameters, memory after each) or eval batches (logits), held to
    ``VARIANT_TOL``, or bit for bit with ``exact``.  Returns the largest
    errors."""
    runs = []
    for over in (over_a, over_b):
        o = {"dropout": 0.0, "att_dropout": 0.0, **over}
        model, trainer = _tgn_variant(compute_dtype=None, **o)
        state = trainer.init_state(num_nodes, seed=0)
        trace = []
        for b in batches:
            if train:
                _, loss, pos, neg = trainer.train_step(state, dg, ef, b)
            else:
                _, loss, pos, neg = trainer.eval_step(state, dg, ef, b)
            trace.append(dict(
                loss=loss.double(), logits=torch.cat([pos, neg]).double(),
                params=[p.detach().clone() for p in model.parameters()],
                memory=torch.cat([state.memory.node_memory,
                                  state.memory.mailbox], 1).clone()))
        runs.append(trace)
    errs = dict(loss_rel=0.0, param=0.0, memory=0.0, logits=0.0)
    for x, y in zip(*runs):
        errs["loss_rel"] = max(errs["loss_rel"], _rel(x["loss"], y["loss"]))
        errs["logits"] = max(errs["logits"], (x["logits"] - y["logits"])
                             .abs().max().item())
        errs["param"] = max([errs["param"]] + [
            (p - q).abs().max().item() for p, q in zip(x["params"],
                                                        y["params"])])
        errs["memory"] = max(errs["memory"], (x["memory"] - y["memory"])
                             .abs().max().item())
    held = {k: v for k, v in errs.items()
            if k in (("loss_rel", "param", "memory") if train
                     else ("logits", "memory"))}
    bad = {k: v for k, v in held.items()
           if (v != 0.0 if exact else v > VARIANT_TOL[k])}
    if bad:
        raise AssertionError(f"[variants] f32 {over_a} against {over_b}: "
                             f"{bad} beyond {'0' if exact else VARIANT_TOL}")
    return dict(steps=len(batches), exact=exact, **held)


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
    phase_ingest(torch, stream)
    rows = phase_kernels(torch, stream)
    kernels = {"gru_memory_fused": gru_memory_fused,
               "gru_memory_fused_bwd": gru_memory_fused_bwd,
               "neighborhood_attention": neighborhood_attention,
               "sorted_segment_sum": sorted_segment_sum}
    sl = phase_slice(torch, kernels, stream)
    tr = phase_train(torch, kernels, stream)
    dd = phase_dedup(torch, kernels, stream)
    en = phase_entry(torch, kernels)
    tg = phase_tgat(torch, kernels, stream)
    dy = phase_dysat(torch, kernels, stream)
    ap = phase_apan(torch, kernels, stream)
    st = phase_static(torch, kernels, stream)
    on = phase_online(torch, kernels)
    inf = phase_inference(torch, kernels, on)
    ca = phase_cache(torch, kernels, on)
    pa = phase_parallel(torch, kernels, stream)
    so = phase_storage(torch, kernels, stream)
    va = phase_variants(torch, kernels, stream)
    # the CPU-card checks time nothing, so the parity harness runs beside
    parity = start_parity()
    try:
        phase_self_check(torch)
        phase_parity(parity)
    finally:
        stop_parity(parity)
    # launches on each main path, counted from 0 just before it: TGN eval
    # batches, train steps at att_dropout 0.2 and at 0, dedup train steps,
    # fallback steps and eval batches, the entry script's two epochs; TGAT
    # eval batches, default train steps, steps at att_dropout 0 and factor
    # 0.5, steps at factor 0.01; DySAT eval batches, default train steps,
    # steps at att_dropout 0 on the snapshot dedup, on the block
    # compaction, at factor 0.01, the entry script's epoch; APAN eval
    # batches, default train steps, steps at att_dropout 0 on the memory
    # dedup, at factor 0.01, the entry script's epoch; GraphSAGE's and
    # GAT's eval batches, default train steps, steps on the layer dedup at
    # STATIC_FACTOR, at factor 0.01, the entry script's epoch; the online
    # script's eval steps and train steps (phase 1 and retraining); the
    # inference script's eval and embed steps, TGN and DySAT; the cache
    # phase's serial and pipelined train steps, eval batches, steps on the
    # host-placed store, and the script's two epochs; the parallel phase's
    # DP and partitioned TGN train steps and eval batches, partitioned
    # TGAT eval batches and train steps, TGN on replicated and sharded
    # memory (train, eval) and the sharded side's f32 steps per instance
    # and on the dedup, the cached steps over a host and a sharded master,
    # the partitioned script's epoch and the multiprocess script's cut
    # epoch with the cache; the storage phase's train steps in f32 and
    # bf16 storage; the variants phase's paths (its docstring)
    paths = {"eval": sl["launches"], "train": tr["launches"],
             "train_att_dropout0": tr["att_dropout0"]["launches"],
             "dedup_train": dd["launches"],
             "dedup_fallback": dd["fallback"]["launches"],
             "dedup_eval": dd["eval"]["launches"], "entry": en["launches"],
             **tg["launches"], **dy["launches"], **ap["launches"],
             **st["launches"], **on["launches"], **inf["launches"],
             **ca["launches"], **pa["launches"], **so["launches"],
             **va["launches"]}
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] in tg["rows"]:
            row["tgat"] = tg["rows"][row["name"]]
        if row["name"] in dy["rows"]:
            row["dysat"] = dy["rows"][row["name"]]
        if row["name"] in ap["rows"]:
            row["apan"] = ap["rows"][row["name"]]
        if row["name"] in st["rows"]:
            row["static"] = st["rows"][row["name"]]
        if row["name"] in va["rows"]:
            row["variants"] = va["rows"][row["name"]]
    print(json.dumps({"kernels": rows, "card": dev["smi"],
                      "profiler_empty": PROFILER_EMPTY}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
