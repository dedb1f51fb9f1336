#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_syncbn_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, in order; takes no options

Phases, in order; any failure exits non-zero (nothing is caught, nothing
falls back to the CPU):

1. card      — name, compute capability (must be 9.0) and the
               ``nvidia-smi --query-gpu=name,power.limit`` line;
2. settings  — TF32 and cuDNN switches, set and printed;
3. build     — nvcc builds every CUDA library of the port from
               ``tpu_syncbn_torch/ops/csrc`` (the two BN forward kernels and
               the three flash-attention kernels; one nvcc per source, all
               at once), with seconds, registers and spills; ``cuobjdump``
               counts each library's HGMMA and UTMALDG instructions, and
               every attention library must hold both;
4. kernels   — each of the four BN kernels (CUDA ``bn_stats`` and
               ``bn_normalize``, Triton ``bn_backward_reduce`` and
               ``bn_backward_elemt``) against its plain
               PyTorch version at every distinct BN shape of the ResNet-50
               path and at one ragged M, in float32
               (against a float64 plain computation) and bfloat16 (in the
               working dtype), with max error against the stated tolerance;
               then kernel, plain and ATen-yardstick times per training
               step over every BN shape of the path, beside the bound
               (``bn_normalize`` as the path runs it, the PyTorch fold
               included, and its kernel alone beside it);
5. slice     — full-width bf16 ResNet-50, converted to SyncBN, trained by
               ``DataParallel`` with SGD(0.1, momentum 0.9) at batch 64,
               224x224, fed by SyntheticImageDataset -> DistributedSampler
               -> DataLoader -> device_prefetch; every BN kernel must launch
               53 x steps times; step times and img/s; a profiler window;
               an in-place A/B of kernels against plain versions on the
               same weights and batch (loss and running stats; every
               kernel call of that step against its plain version on the
               same tensors; the gradients shown beside a bf16-vs-f32
               reference); one eval step;
6. groups    — the cross-replica path with the kernels: four processes
               share the card over a gloo group (gloo copies CUDA tensors
               through the host; NCCL needs a card a rank), each joined by
               ``runtime.initialize("cuda")``, kernel mode "on". One
               SyncBatchNorm at C = 256, 12544 rows a rank, for the whole
               world, ``group_size=2`` and the partition ((0, 3), (1, 2)), in
               float32 and bfloat16: y, dx, dγ, dβ and running statistics
               against one BatchNorm of the rank's group in float64; two
               planted faults (the partition built as contiguous pairs; local
               moments after the all-reduce) must fail that check; one f32
               ResNet-50 step at world 4 against world 1 on the same weights
               and global batch 64; three bf16 steps with ``group_size=2``
               after each of which every rank's parameters and buffers equal
               rank 0's bit for bit, every BN kernel launching 53 x 3 times
               on every rank; the
               compressed collectives on CUDA tensors (``compressed_pmean``
               bf16 and int8, ``ef_compressed_pmean``,
               ``compressed_reduce_scatter``, ``shuffle_sharded_psum``)
               against float64 reductions within their analytic bounds,
               two SyncBN steps with ``stats_compress="bf16"`` and the
               int8 statistics' backward raising;
7. imagenet  — the real-image data path: the native library must load; a
               seeded JPEG tree of ImageNet's image sizes (4 classes x 160
               train, x 16 val); the train pipeline's img/s with 8 thread
               and 8 process workers and with os.cpu_count() of the faster
               kind, the process path's receive time a batch, and
               ``staged_iter`` over the native ring (batches equal, the
               consumer's time a batch); then the ported ImageNet example
               (``imagenet_resnet50.main``, bf16 ResNet-50 at batch 64 and
               224x224, kernel mode "on"): every BN kernel must launch 53 x
               the train steps (the eval counted apart), the loss be
               finite, the done line carry a val top-1, and the first 3
               staged batches read back from the card equal their host
               arrays; its median step and data wait beside the synthetic
               slice's step; a 2-step profiler window (device busy, the
               host-to-device copies on a stream of their own, and their
               overlap with the compute stream's kernels); then, side by
               side, the example under ``python -m tpu_syncbn_torch.launch``
               with process workers on the tree's first 16 train and 4 val
               images a class, to its done line, and phase 6's launcher
               checks: ``train.py`` (ResNet-50) at ``--nproc-per-node 1`` to
               its done line, and one process more than the card count
               refused;
8. trainer   — the rest of ``DataParallel`` on the slice's model and batch
               (bf16 ResNet-50 SyncBN, 64 at 224x224, the example's
               optimizer with its schedule in the trainer), every BN launch
               of the checked steps held against its plain version:
               ``accum_steps=2`` (53 x 2 launches of each kernel a step,
               num_batches_tracked +2 a step, finite loss; step time
               against accum 1); ``remat`` against the plain step from the
               same weights (loss, running stats and update within 2^-8,
               num_batches_tracked +1, forward kernels 2 x 53 and backward
               53; peak memory and step time both ways); the guard
               (``skip_step`` with a NaN image: parameters, momentum and BN
               buffers bit for bit unchanged, nonfinite 1, the schedule not
               advanced; ``halve_lr`` gives lr_scale 0.5; its cost a step);
               checkpoints (payload MB, synchronous save, async snapshot
               and load seconds) and the ported example run 2 epochs with
               ``--ckpt-dir --async-ckpt --accum-steps 2 --divergence-guard
               skip_step``, then ``--resume --epochs 3`` (starts at epoch
               2, the state after load bitwise equal to the saved one; a
               truncated newest checkpoint falls back to the older one);
9. gan       — the GAN capability config (DCGAN, then SNGAN, at full
               width: latent 128, G width 256, D width 64, 32x32, f32,
               global batch 64) through ``gan_train.main`` in process on
               synthetic data for 20 iterations each: every BN kernel
               launches 14 x iterations (forward pair) and 10 x iterations
               (backward pair), the 16 samples' eval forward counted apart
               (``bn_normalize`` once a generator BN layer, nothing else); num_batches_tracked +2 (G) and +3 (D) an
               iteration; the 16 samples finite in [-1, 1]; the iteration
               time (CUDA events, median of 10) and a 2-iteration profiler
               window; one iteration from the same state on the same
               batch with the kernels and with their plain versions
               (d_loss, g_loss, every running statistic and SNConv u within
               the slice's A/B tolerances; every kernel call against its
               plain version on its own tensors);
10. retinanet — RetinaNet-R50-FPN at 512x512, 80 classes, per-GPU batch 2,
               f32, Adam(1e-3) under ``DataParallel`` on synthetic
               detection data (32 boxes at most) for 10 steps: each BN
               kernel launches 53 x steps; a finite loss; step time (CUDA
               events), peak memory and a profiler window; the A/B step
               as above; decode + ``batched_nms`` + ``evaluate_detections``
               over 8 images give an mAP in [0, 1];
11. bench     — ``python -m tpu_syncbn_torch.bench --scan 8 --serve`` in a
               subprocess: exit 0, every key of its JSON line, 0 < mfu <= 1,
               the ``recovery`` block (a truncated newest checkpoint resumes
               the older step, the async write certifies), the ``scan``
               block at K = 8 and the ``collectives`` block (wire bytes and
               ratios on 1 MiB), the ``monitor``, ``numerics``,
               ``incident``, ``memory`` and ``compile`` blocks, the
               ``serve`` block with JAX's keys (its closed- and open-loop
               levels printed, ``p99_bounded`` and
               ``degradation_graceful`` among them; its ``publish``
               section with JAX's keys, the swap ``swapped`` and the
               rollback bit for bit); the line printed;
12. scan      — K steps as one CUDA graph (``train_steps_batches``,
               ``GANTrainer.train_steps``) for the ResNet-50 slice (the
               example's SGD and a cosine schedule), DCGAN and RetinaNet:
               4 captured steps against the same body run eagerly from the
               same state (cuDNN deterministic; losses and buffers within
               the A/B limits, update and optimizer state within 2^-8,
               counts exact, bitwise equality printed), one captured step
               against one ``train_step``, the BN launches the graph
               recorded (layers x K, none through the wrappers at a
               replay), the lr table across two chunks, and after
               ``load_state_dict`` of another state a rebuilt graph equal
               to the eager body (the stale-address check); then eager and
               captured step times (host clock and CUDA events) at K = 4
               and 8, capture seconds and graph pool bytes against the
               eager steady peak. (The gloo refusal runs in phase 6's
               children: ``train_steps_batches`` on CUDA tensors under
               their gloo group raises.)
12b. compress — the int8 wire (ROADMAP A.9): its three CUDA kernels
               (``quant_minmax``, ``quant_encode``, ``quant_decode``)
               bit-identical to their plain versions at ResNet-50's
               payload and a ragged one, qmax 127/63/31/1, with and
               without a residual and a constant chunk; their device
               times beside bound and plain; the ResNet-50 slice at
               ``compress="int8"`` with error feedback (one launch of each
               a step, finite losses, wire ratio 3.879, one step's
               reduction bitwise against the plain versions on the same
               gradients, parameters within one rounding, every residual
               within the bound derived from the encode's f32 arithmetic
               (written out beside the gate), a captured K = 4 chunk
               bitwise against its
               body) and its step time against ``"none"`` in turns, eager
               and captured; one DCGAN iteration at ``compress="bf16"``;
12c. autopilot — the closed loop (ROADMAP A.14a) on the int8 ResNet-50
               step (monitors on, cuDNN deterministic): ``ResilientLoop(
               scan_steps=4, autopilot=...)`` fed by ``chunked_batches``,
               the controller on ``numerics_rules() + mem_rules()`` over
               the ladder, K in (4, 8) and a byte budget from the int8
               K = 4 graph's pool, on an injected clock of 30 s a chunk.
               A clip fault on every 256-element chunk (gain 1000x the
               largest real gradient, ``clip_fraction`` >= 0.9) until the
               first actuation, then a real ``mem.headroom_frac`` sample,
               then a planted ``mem_pressure`` burn. Gates: int8 -> bf16
               within 2 chunks on ``numerics_clip``, one valid bundle an
               actuation; the rung cycle back to int8 with no capture and
               its first chunk bitwise its eager body, no storm; K 4 -> 8
               -> 4 with the watchdog's deadline at K x the step's and no
               capture on the way back; the evicted K = 8 graph's pool
               returned to the card; 53 launches of each BN kernel a step
               and one of each int8 kernel on the int8 rung only, every
               eager call held against its plain version; the live gauges
               on ``/statusz``; captures, step ms a rung and seconds;
13. resilience — ``ResilientLoop(scan_steps=4, async_checkpoint=True)`` on
               the ResNet slice: a NaN step under ``restore_last_good``
               restores the last checkpoint and continues; SIGTERM before
               the second chunk of a child process (``chip_smoke.py
               --resilience-child DIR``): exit 0, ``preempted``, the
               boundary checkpoint, and the resume here continues from it;
13b. obs      — the observability slice (ROADMAP A.11a) on the ResNet-50
               slice: ``monitors=True`` against ``False`` in turns, eager
               and captured K = 4 (the monitors' cost a step, host clock and
               CUDA events); the monitor key set (``bn_layers`` = 53), every
               monitor a CUDA tensor, ``grad_norm`` within 1e-3 of a float64
               host recompute from the step's own gradients; a captured
               K = 4 chunk with monitors bitwise against its body (losses,
               state and every monitor); ``clip_fraction`` and
               ``overflow_headroom`` in range on an int8 step;
               ``NumericsPublisher.publish`` over 8 steps of two captured
               chunks with no ``torch.cuda.synchronize`` call, returning
               while the chunk's work is still pending, and ``flush()``
               publishing all 8; ``tests/test_torch_gpu.py``'s two tests
               of a publisher's and a recorder's first calls behind queued
               work, each alone in a fresh process (gated); a
               registry JSONL export and a Chrome trace
               of 8 ``ResilientLoop`` steps (every BN kernel 53 x 8 times)
               that validate and hold the ``step`` and ``data_wait`` spans
               and the ``train.step`` gauge; the monitor functions' own host
               time a step, and the eager step with monitors toggled every
               step on one trainer;
13c. incident — the flight recorder, memory watermarks, compile events and
               the profiler capture (ROADMAP A.11b) on the same slice: a
               NaN step under ``ResilientLoop(scan_steps=4)`` with the
               recorder and the sampler installed gives exactly one valid
               ``divergence_restore`` bundle whose step ring holds finite
               loss and monitors before the fault; the sampler's thread at
               1 ms beside a K = 4 graph capture (the capture replays
               bitwise its body; a sample's gauges equal
               ``memory_allocated`` / ``max_memory_allocated``); a manual
               dump from the loop's fetch while a captured chunk still
               runs (no ``torch.cuda.synchronize``; each ring value
               ``"pending"`` or its own step's); a contract at half the
               steady peak fires one ``mem_pressure`` bundle; one program
               key rebuilt 3 times gives one ``recompile_storm`` bundle and
               distinct keys none; a 1 s ``profiling.capture`` on the main
               thread while a worker replays captured chunks holds the BN
               kernels' names under the size cap, and the worker's own
               capture meanwhile raises ``ProfilerBusy``; then
               ``record_step``'s cost a step, one sample's cost, the dump's
               seconds and bytes;
13d. monitor  — the monitoring server, the SLO tracker and ``/profilez``
               (ROADMAP A.11c) on the guarded trainer of 13c (its K = 4
               program warm): ``ResilientLoop(scan_steps=4)`` with
               ``TPU_SYNCBN_METRICS_PORT=0`` starts the server itself;
               20 or more ``/metrics`` scrapes at ~10 Hz while captured
               chunks run, each 200 in valid Prometheus text, with no
               synchronize from any thread but the main one; ``/healthz``
               and ``/readyz`` 200 before a planted divergence and after
               it, the loop's readiness check recording not-ready during
               the restore; a chunk scraped bitwise the same chunk with no
               server; eager loop steps (every BN kernel 53 x steps) under
               a tracker whose planted ``step.time_s p99 < 0.001`` fires
               (one valid ``slo_alert`` bundle naming it in
               ``state.alerts``, ``/statusz`` listing the alert and the
               last incident) while ``step.time_s p99 < 60`` does not;
               ``POST /incidentz`` a valid bundle; ``POST /profilez``
               answered 200 with device events by the loop's main thread
               within its bound, and 503 within its bound with no loop;
               the captured step without the server and scraped, in turns;
13e. serve    — the serving path (ROADMAP A.12a): bf16 ResNet-50 at full
               width (``channels_last``), its SyncBN trainer taken 3 steps,
               ``InferenceEngine.from_trainer(dp, buckets=(8, 32, 128))``
               on 224² f32 requests, cuDNN deterministic: each bucket's
               capture launches ``bn_normalize`` 53 times (and its eager
               warm-up 53), no other BN kernel; request sizes 1, 5, 8, 20,
               32, 100, 128 and 200 (chunked) each bitwise the engine
               copy's eager forward at the padded size (their own rows);
               3 programs after ``warm()`` and the traffic; the bucket-128
               graph profiled against one captured under kernel mode "off"
               (53 ``bn_normalize`` against none, 3 x 53 kernels fewer),
               their logits within the slice's 1e-2 and their replays
               timed in turns; replay, ``predict``, eager (kernels and
               plain) ms and img/s per bucket, capture seconds and pool
               bytes, the bucket-128 copies; eval ``bn_normalize`` at the
               53 bucket-128 shapes against the plain chain and ATen's
               ``F.batch_norm(training=False)`` beside the bound;
               ``swap_params`` with a request in flight (old rows; then
               the new weights' eager forward; no new capture),
               ``rollback`` bitwise, a skewed tree refused; a
               ``DynamicBatcher`` at ``max_batch`` 32 under 64 closed-loop
               clients (fill >= 0.9); ``faults.crash_engine_at_batch`` on
               the engine: the circuit opens, ``/readyz`` answers 503
               (``TPU_SYNCBN_METRICS_PORT=0``), the half-open probe
               recovers, one valid ``circuit_open`` bundle; the trainer's
               module stays in training mode;
13f. publish  — weight publication (ROADMAP A.12b) on 13e's engine and
               trainer, cuDNN deterministic, after one untimed swap and
               rollback (a kernel's first launch waits for queued work):
               ``publish_version`` of the trainer's weights, one training
               step, ``SwapController.swap_from_trainer`` (no new capture,
               the serve cache's misses unchanged; the bucket-128 replay
               profiled: 53 ``bn_normalize``; no wrapper launch on the
               replay path; the rows bitwise the engine copy's eager
               forward at the padded size and within 1e-2 of it under
               kernel mode "off"; the engine's weights the trainer's bit
               for bit), ``swap_from_publication`` back to the published
               weights (rows bitwise the pre-step rows), a truncated
               publication rejected (rows unchanged bit for bit, one
               ``serve.swap_rejected_total``, a ``weight_swap`` serve-ring
               record), a canary crash on the new version rolled back, a
               manual rollback bitwise, a memwatch contract aborting a swap
               (its serve-ring record ``aborted``/``mem_pressure`` and one
               ``mem_pressure`` bundle carrying the swap's detail, apart
               from the sampler's own); ``weight_swap`` bundles one a swap,
               rollback and rejection; swap, commit, publish, load and
               rollback seconds, the payload's bytes, the double buffer;
14. attn-parity — each attention kernel (forward, dK/dV, dQ) against its
                 plain version, causal and not, float32 (against float64)
                 and bfloat16, at the LM slice's shape and four others,
                 and causal bf16 at the LM shape on views into one fused
                 QKV tensor;
15. attn-time  — device time of each attention kernel at the LM shape
                 beside its bound, its plain version and, as a yardstick the
                 port never calls, ``scaled_dot_product_attention``; the
                 kernels' times at every parity shape, and at a fixed 1024
                 blocks over four lengths (a fixed cost per block, fitted);
                 the float32 kernels' times;
16. lm         — the causal transformer LM at full width (d_model 512, 8
                 heads of 64, d_ff 2048, vocab 50257, 8 layers, L 8192,
                 batch 2, bf16), trained by ``longcontext_train.train_step``
                 with Adam and ``attn_impl="flash_pallas_bwd"``: every
                 attention kernel must launch 8 x steps times; step times,
                 tokens/s, a profiler window;
17. lm-a/b     — one step from the same weights and batch with the kernels
                 and with their plain versions (loss; every kernel call of
                 the kernel step against its plain version on the same
                 tensors; the gradients shown), and one step of
                 ``attn_impl="flash"`` (kernel forward, scan backward);
18. seq        — sequence parallelism across ranks (ROADMAP A.13a): four
                 processes on the card over one gloo group (as phase 6),
                 kernel mode "on". Which gloo collectives take bf16 CUDA
                 tensors. ``sharded_self_attention`` at the LM slice's
                 attention, (2, 8192, 8, 64) bf16, 2048 tokens a rank: ring,
                 zigzag ring and dense Ulysses (causal), Ulysses with the
                 flash kernels under the scan backward (causal) and the
                 kernel backward (causal and full); each output and dq, dk,
                 dv, all-gathered, against the exact attention (float64)
                 within a per-element limit (derived beside
                 SEQ_HOP_ROUNDINGS) and against the world-1
                 ``flash_attention`` run with the same backward; every
                 kernel call at the per-rank shape (2, 8192, 2, 64) against
                 its plain version under kernel mode "off", the calls and
                 launches of each case (1 ``flash_fwd``, with the kernel
                 backward 1 ``flash_bwd_dkdv`` and 1 ``flash_bwd_dq``, of
                 the case's variant), no plain version run otherwise. Then
                 the LM at world 4 in three arms — ring and dense Ulysses at
                 depth 2, Ulysses on the flash kernels at depth 8 — 3 Adam
                 steps each against the world-1 LM (same seed, depth and
                 global batch): losses and step 1's gradient within 5x the
                 world-1 step's own rounding floor (derived beside
                 SEQ_FLOOR_FACTOR), launches a rank, step ms and peak
                 memory of each process; the phase's seconds.

Before the last two lines come ``{"groups": {...}}`` (phase 6's worst
ratios) and ``{"paths": {...}}`` (phases 9-13f's and 18's launches, times,
the bench line, the eager and captured steps, the compress, resilience,
obs, incident, monitor, serve, publish and seq summaries); the
second-to-last line is ``{"kernels": [...]}`` (the BN, attention and
int8-wire kernels; ``bn_normalize``'s row carries the serving path's
launches and times under ``serve`` and the replay after a swap under
``publish``; each attention row a rank's launches in phase 18's flash LM
arm and its calls by variant in the attention cases under ``seq``); the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
nvcc (phase 3) and Triton (at first launch) build every kernel from this
checkout's sources into ``tpu_syncbn_torch/_build/`` (git-ignored).
Without a card the script exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# float32 outside the tensor cores (the BN kernels compute in f32 whatever
# the storage dtype).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the Pallas kernel each BN kernel replaces (the dx pass replaces the
# XLA-fused elementwise tail of the custom VJP), and its route and source
# (the forward pair in CUDA C++, the backward pair in Triton)
REPLACES = {
    "bn_stats": "tpu_syncbn/ops/pallas_bn.py:99",
    "bn_normalize": "tpu_syncbn/ops/pallas_bn.py:157",
    "bn_backward_reduce": "tpu_syncbn/ops/pallas_bn.py:206",
    "bn_backward_elemt": "tpu_syncbn/ops/pallas_bn.py:344",
}
BN_SOURCE = {
    "bn_stats": ("cuda", "tpu_syncbn_torch/ops/csrc/bn_stats.cu"),
    "bn_normalize": ("cuda", "tpu_syncbn_torch/ops/csrc/bn_normalize.cu"),
    "bn_backward_reduce": ("triton", "tpu_syncbn_torch/ops/triton_bn.py"),
    "bn_backward_elemt": ("triton", "tpu_syncbn_torch/ops/triton_bn.py"),
}
# the BN kernels as the profiler names them: the CUDA ones by namespace, the
# Triton ones by function; the forward's old Triton kernels must not appear
BN_CUDA_NAMESPACES = ("bn_stats_k::", "bn_normalize_k::")
BN_TRITON_NAMES = ("bwd_reduce_partial", "sum_partials", "backward_elemt")
OLD_TRITON_NAMES = ("stats_partial", "normalize")
# floating-point operations per element (x̂ = 2, one FMA = 2)
FLOPS_PER_ELEM = {"bn_stats": 3, "bn_normalize": 2,
                  "bn_backward_reduce": 5, "bn_backward_elemt": 7}
# per call: ((M, C) operands read, (M, C) operands written, f32 (C,)
# vectors read + written) — each input read once, each output written once
MOVES = {"bn_stats": (1, 0, 2), "bn_normalize": (1, 1, 4),
         "bn_backward_reduce": (2, 0, 4), "bn_backward_elemt": (2, 1, 5)}


def bound_ms(k: str, m: int, c: int, itemsize: int) -> tuple[float, float]:
    """(bytes time, operations time) in ms: the least time an H100 needs
    for one call, by memory rate and by f32 rate."""
    reads, writes, vecs = MOVES[k]
    nbytes = (reads + writes) * m * c * itemsize + vecs * c * 4
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            FLOPS_PER_ELEM[k] * m * c / F32_FLOPS_PER_S * 1e3)

BN_LAYERS = 53  # BatchNorm layers in ResNet-50
# the slice: per-GPU batch 64 at 224x224, as the JAX package's headline
# bench (bench.py:273-320); >= 5 timed steps after the first (build) step
BATCH, IMAGE_SIZE, STEPS = 64, 224, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


# -- phase 1: card ---------------------------------------------------------


def phase_card(torch):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {name} capability {cap[0]}.{cap[1]} "
        f"count {torch.cuda.device_count()}")
    log(smi)
    if cap != (9, 0):
        fail(f"needs a Hopper card (capability 9.0), got {cap}")
    return name, smi


# -- phases 3-4: build, kernels -------------------------------------------


def _event_ms(torch, fn, iters: int, reps: int = 1) -> float:
    """Host-inclusive time per call: the median over ``reps`` windows of
    ``iters`` calls back to back between two CUDA events, after one
    warm-up call. Where a kernel is shorter than its launch, this measures
    the launch, not the kernel."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def device_intervals(prof):
    """``(name, start_us, end_us)`` of every device activity (kernels,
    copies, fills) a ``torch.profiler`` window recorded."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _device_ms(torch, fn, iters: int, reps: int = 5) -> float:
    """Device time per call, without the host's launch cost: ``iters``
    calls captured in one CUDA graph, the graph replayed between two CUDA
    events; the median over ``reps`` replays. Inputs that fit the 50 MB L2
    stay there between calls, as an activation just written by the layer
    before would be."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):  # warm-up (and first build) off the graph
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del g
    return statistics.median(times)


def _inputs(torch, m, c, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(m, c, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
    dy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
    w = torch.rand(c, generator=g, device="cuda") + 0.5
    b = torch.randn(c, generator=g, device="cuda")
    return x, dy, w, b


def _cases(torch, T, bn_ops, x, dy, w, b, eps=1e-5):
    """For each kernel: (wrapper call, plain call) on the same inputs."""
    s, sq, count = T.bn_stats(x)
    mean, var = s / count, (sq / count - (s / count) ** 2).clamp_min(0)
    invstd = torch.rsqrt(var + eps)
    scale, shift = bn_ops.fold_scale_shift(mean, var, w, b, eps)
    sdy, sdyx = T.bn_backward_reduce(dy, x, mean, invstd)
    return {
        "bn_stats": (lambda: T.bn_stats(x)[:2],
                     lambda xx: T.stats_plain(xx)),
        "bn_normalize": (lambda: T.bn_normalize(x, mean, var, w, b, eps),
                         lambda xx: T.normalize_plain(xx, scale, shift)),
        "bn_backward_reduce": (
            lambda: T.bn_backward_reduce(dy, x, mean, invstd),
            lambda xx: T.backward_reduce_plain(dy.to(xx.dtype), xx, mean, invstd)),
        "bn_backward_elemt": (
            lambda: T.bn_backward_elemt(dy, x, mean, invstd, w, sdy, sdyx, count),
            lambda xx: T.backward_elemt_plain(dy.to(xx.dtype), xx, mean, invstd,
                                              w, sdy, sdyx, count)),
    }, (mean, invstd, count, scale, shift)


def _err(torch, got, ref, elementwise: bool, scaled_floor: bool = False):
    """(max abs error, max relative error). Elementwise outputs: relative
    to each element's |reference| + 1e-3 — or, with ``scaled_floor``, + 1e-3
    of the output's largest |reference|, for activations and gradients of
    any scale. Per-channel sums: relative to the largest |sum| of that
    output (a sum near zero by cancellation carries the rounding of its
    large terms, not of its own size)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    abs_e, rel_e = 0.0, 0.0
    for g_, r_ in zip(got, ref):
        g_, r_ = g_.double(), r_.double()
        # equal values (infinities included) and NaN on both sides agree
        # (a step with a NaN input: the two must put NaN in the same
        # places); a non-finite value on one side only is an infinite error
        same = (g_ == r_) | (g_.isnan() & r_.isnan())
        d = torch.where(same, 0.0, (g_ - r_).abs()).nan_to_num(nan=math.inf)
        ra = r_.abs().nan_to_num(nan=0.0, posinf=0.0)
        abs_e = max(abs_e, float(d.max()))
        if elementwise:
            floor = 1e-3 * float(ra.max()) + 1e-30 if scaled_floor else 1e-3
            rel_e = max(rel_e, float((d / (ra + floor)).max()))
        else:
            rel_e = max(rel_e, float(d.max() / (ra.max() + 1e-30)))
    return abs_e, rel_e


ELEMENTWISE = {"bn_normalize", "bn_backward_elemt"}

# Tolerances on the relative errors of _err:
#  * float32 kernel vs float64 plain: f32 rounding of sums over up to 8e5
#    rows accumulated blockwise, and of a few f32 operations per element —
#    well inside 1e-4;
#  * bfloat16 outputs (normalize, dx) vs the plain version in the working
#    dtype: both compute in f32 then round to bf16, so they may differ by
#    one bf16 unit in the last place (at most 2^-7 relative);
#  * bfloat16 inputs to the reductions: both accumulate the same bf16
#    values in f32, in different orders — 1e-4.
TOL = {("float32", k): 1e-4 for k in MOVES}
TOL.update({("bfloat16", "bn_stats"): 1e-4,
            ("bfloat16", "bn_backward_reduce"): 1e-4,
            ("bfloat16", "bn_normalize"): 2 ** -7 + 1e-4,
            ("bfloat16", "bn_backward_elemt"): 2 ** -7 + 1e-4})

# an M that is a multiple of no row block, beside the path's own shapes
RAGGED_SHAPE = (100003, 96)


def phase_kernel_parity(torch, T, bn_ops, shapes):
    """Each kernel against its plain version at every distinct BN shape of
    the path and at one ragged shape, in float32 and bfloat16; returns the
    worst abs errors and the cases that disagree (every case runs)."""
    worst = {k: 0.0 for k in MOVES}
    failures = []
    for (m, c) in sorted(set(shapes)) + [RAGGED_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, dy, w, b = _inputs(torch, m, c, dtype, seed=m + c)
            cases, (_, _, count, _, _) = _cases(torch, T, bn_ops, x, dy, w, b)
            if float(count) != m:
                failures.append(f"bn_stats count {float(count)} != M={m}")
            for k, (kern, plain) in cases.items():
                got = kern()
                ref = plain(x.double() if dtype == torch.float32 else x)
                torch.cuda.synchronize()
                abs_e, rel_e = _err(torch, got, ref, k in ELEMENTWISE)
                tol = TOL[(dname, k)]
                ok = rel_e <= tol
                log(f"[parity] {k:19s} M={m:<7d} C={c:<5d} {dname:8s} "
                    f"max_abs_err={abs_e:.3e} max_rel_err={rel_e:.3e} "
                    f"tol={tol:.1e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{k} disagrees with its plain version "
                                    f"at M={m} C={c} {dname}")
                worst[k] = max(worst[k], abs_e)
            del x, dy
    return worst, failures


# the dispatch function of ops/triton_bn.py each kernel runs through, and
# its plain version (same arguments)
DISPATCH = {"bn_stats": ("_stats_2d", "stats_plain"),
            "bn_normalize": ("_normalize_2d", "normalize_plain"),
            "bn_backward_reduce": ("_backward_reduce_2d", "backward_reduce_plain"),
            "bn_backward_elemt": ("_backward_elemt_2d", "backward_elemt_plain")}


def _note_capture(torch, seen, k) -> bool:
    """Inside a CUDA graph capture a kernel call is recorded, not run: count
    it in ``seen[kernel + " captured"]`` and say so (a replay is held
    against the body run eagerly instead)."""
    if not torch.cuda.is_current_stream_capturing():
        return False
    calls = seen.get(k + " captured", (0, 0.0, 0.0))[0]
    seen[k + " captured"] = (calls + 1, 0.0, 0.0)
    return True


@contextlib.contextmanager
def checking_every_call(torch, T, seen):
    """Inside the block, every call that ``FusedBatchNorm`` makes to a
    kernel is followed by the kernel's plain version on the same arguments,
    and ``seen[kernel] = (calls, worst error / tolerance, worst abs
    error)`` is kept: the kernels held against their plain versions on a
    real step's own activations and gradients, layer by layer. A call
    inside a graph capture is only counted (``_note_capture``)."""
    saved = {disp: getattr(T, disp) for disp, _ in DISPATCH.values()}
    for k, (disp, plain) in DISPATCH.items():
        def run(*args, _k=k, _kern=saved[disp], _plain=getattr(T, plain)):
            got = _kern(*args)
            if _note_capture(torch, seen, _k):
                return got
            # stats also hands back its count, which the plain sums lack
            cmp = got[:2] if _k == "bn_stats" else got
            abs_e, rel_e = _err(torch, cmp, _plain(*args), _k in ELEMENTWISE,
                                scaled_floor=True)
            tol = TOL[(str(args[0].dtype).split(".")[-1], _k)]
            calls, ratio, worst_abs = seen.get(_k, (0, 0.0, 0.0))
            seen[_k] = (calls + 1, max(ratio, rel_e / tol), max(worst_abs, abs_e))
            return got
        setattr(T, disp, run)
    try:
        yield
    finally:
        for disp, fn in saved.items():
            setattr(T, disp, fn)


def bn_shapes(torch, model, batch, side):
    """(M, C) of every BN layer of one forward, in order."""
    from tpu_syncbn_torch.nn import BatchNorm

    shapes = []
    was_training = model.training
    model.eval()  # same shapes, and the running stats stay untouched
    hooks = [mod.register_forward_pre_hook(
        lambda mod, args: shapes.append(
            (args[0].numel() // args[0].shape[mod.channel_axis],
             args[0].shape[mod.channel_axis])))
        for mod in model.modules() if isinstance(mod, BatchNorm)]
    with torch.no_grad():
        model(torch.zeros(batch, side, side, 3, device="cuda"))
    for h in hooks:
        h.remove()
    model.train(was_training)
    return shapes


def phase_kernel_times(torch, T, bn_ops, shapes, card):
    """Per training step: kernel, plain and ATen-yardstick time of each
    kernel summed over the path's BN shapes (bf16, the path's dtype), and
    the bound for the same work."""
    counts: dict = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "host_ms": 0.0} for k in MOVES}
    for (m, c), n in sorted(counts.items()):
        x, dy, w, b = _inputs(torch, m, c, torch.bfloat16, seed=7)
        cases, (mean, invstd, count, scale, shift) = _cases(torch, T, bn_ops, x,
                                                             dy, w, b)
        # bn_normalize is timed as the path runs it: the wrapper, which
        # folds (mean, var, γ, β) into (scale, shift) with six small PyTorch
        # ops before the kernel, the same function ATen's batch_norm_elemt
        # computes; the kernel alone, on the folded (scale, shift), beside it
        alone = lambda: T._normalize_2d(x, scale, shift)  # noqa: E731
        icount = torch.tensor([m], dtype=torch.int32, device="cuda")
        sdy, sdyx = T.bn_backward_reduce(dy, x, mean, invstd)
        sdyx_over_invstd = sdyx / invstd  # ATen takes Σdy·(x − mean)
        aten = {
            "bn_stats": lambda: torch.batch_norm_stats(x, 1e-5),
            "bn_normalize": lambda: torch.batch_norm_elemt(
                x, w, b, mean, invstd, 1e-5),
            "bn_backward_reduce": lambda: torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, w, True, True, True),
            "bn_backward_elemt": lambda: torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, w, sdy, sdyx_over_invstd, icount),
        }
        iters = 20
        for k, (kern, plain) in cases.items():
            t_k = _device_ms(torch, kern, iters)
            t_p = _device_ms(torch, lambda: plain(x), iters)
            t_l = _device_ms(torch, aten[k], iters)
            t_host = _event_ms(torch, kern, iters)
            bytes_ms, ops_ms = bound_ms(k, m, c, x.element_size())
            extra = ""
            if k == "bn_normalize":
                t_a = _device_ms(torch, alone, iters)
                t_ah = _event_ms(torch, alone, iters)
                tot[k]["alone_ms"] = tot[k].get("alone_ms", 0.0) + n * t_a
                tot[k]["alone_host_ms"] = tot[k].get("alone_host_ms", 0.0) + n * t_ah
                extra = (f"; kernel alone (scale, shift folded) device "
                         f"{t_a:.4f}ms, with its launch {t_ah:.4f}ms")
            log(f"[time] {k:19s} M={m:<7d} C={c:<5d} x{n:<2d} bf16 device: "
                f"kernel={t_k:.4f}ms plain={t_p:.4f}ms aten={t_l:.4f}ms "
                f"bound={max(bytes_ms, ops_ms):.4f}ms "
                f"({100 * max(bytes_ms, ops_ms) / t_k:.0f}% of bound); "
                f"kernel with its launch {t_host:.4f}ms{extra} [{card}]")
            agg = tot[k]
            agg["ms"] += n * t_k
            agg["plain_ms"] += n * t_p
            agg["library_ms"] += n * t_l
            agg["host_ms"] += n * t_host
            agg["bytes_ms"] += n * bytes_ms
            agg["ops_ms"] += n * ops_ms
        del x, dy
    for k, agg in tot.items():
        agg["bound_by"] = "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else "operations"
        agg["bound_ms"] = max(agg["bytes_ms"], agg["ops_ms"])
        log(f"[time] {k:19s} per step (53 layers, bf16) device: "
            f"kernel={agg['ms']:.3f}ms plain={agg['plain_ms']:.3f}ms "
            f"aten={agg['library_ms']:.3f}ms bound={agg['bound_ms']:.3f}ms "
            f"({agg['bound_by']}); kernel with its launches "
            f"{agg['host_ms']:.3f}ms [{card}]")
    agg = tot["bn_normalize"]
    log(f"[time] bn_normalize kernel alone per step (scale, shift folded) "
        f"device: {agg['alone_ms']:.3f}ms; with its launches "
        f"{agg['alone_host_ms']:.3f}ms [{card}]")
    return tot


def merged(intervals):
    """The union of ``(start, end)`` intervals as disjoint sorted ones:
    overlapping device work counts once."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def profile_window(torch, run, tag: str, what: str, is_ours, card: str,
                   window: str = "2 steps"):
    """Run ``run()`` (two training steps, or what ``window`` says) under
    ``torch.profiler`` and print the device's busy and idle share of the
    wall time, the share of busy time spent in the kernels
    ``is_ours(name)`` selects, and the top 15 device activities."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    acts = device_intervals(prof)
    by_name: dict = {}
    for name_, start, end in acts:
        tot_, cnt_ = by_name.get(name_, (0.0, 0))
        by_name[name_] = (tot_ + (end - start) / 1e3, cnt_ + 1)
    rows = sorted(((ms, cnt, key) for key, (ms, cnt) in by_name.items()),
                  reverse=True)
    busy = sum(e - s_ for s_, e in merged([(a[1], a[2]) for a in acts])) / 1e3
    ours_ms = sum(r[0] for r in rows if is_ours(r[2]))
    wall_ms = window * 1e3
    if busy > 0:
        log(f"[{tag}] {window}: wall {wall_ms:.1f}ms, device busy {busy:.1f}ms "
            f"({100 * busy / wall_ms:.1f}%, idle {100 * (1 - busy / wall_ms):.1f}%), "
            f"{what} {ours_ms:.2f}ms ({100 * ours_ms / busy:.1f}% of busy), "
            f"{len(acts)} device activities [{card}]")
    else:  # a limit of the profiler's tracing, not a fault of the port
        log(f"[{tag}] {window}: wall {wall_ms:.1f}ms; the profiler recorded "
            "no device activity, so the busy share is not measured")
    for ms, cnt, key in rows[:15]:
        log(f"[{tag}] {ms:9.3f}ms x{cnt:<5d} {key[:100]}")
    for ms, cnt, key in rows[15:]:  # the rest of the selected kernels
        if is_ours(key):
            log(f"[{tag}] {ms:9.3f}ms x{cnt:<5d} {key[:100]} (below the top 15)")
    return set(by_name)


# -- phase 5: the slice -----------------------------------------------------


def _loss_fn(model, batch):
    import torch.nn.functional as F

    x, y = batch
    logits = model(x).float()  # cross-entropy in f32
    return F.cross_entropy(logits, y.long())


def _bn_buffers(torch, model):
    from tpu_syncbn_torch.nn import BatchNorm

    return [(name, mod.running_mean.clone(), mod.running_var.clone())
            for name, mod in model.named_modules() if isinstance(mod, BatchNorm)]


def phase_slice(torch, card):
    from tpu_syncbn_torch import data, models, nn, parallel
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T

    dev = torch.device("cuda", 0)
    bs, side, steps = BATCH, IMAGE_SIZE, STEPS
    model = nn.convert_sync_batchnorm(
        models.resnet50(num_classes=1000, dtype=torch.bfloat16, device=dev))
    n_bn = sum(isinstance(mm, nn.BatchNorm) for mm in model.modules())
    if n_bn != BN_LAYERS:
        fail(f"expected {BN_LAYERS} BN layers, found {n_bn}")
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    dp = parallel.DataParallel(model, opt, _loss_fn, device=dev)

    n_batches = steps + 3  # steps, profiler window (2), A/B + eval (1)
    ds = data.SyntheticImageDataset(length=bs * n_batches,
                                    shape=(side, side, 3), num_classes=1000)
    sampler = data.DistributedSampler(len(ds), num_replicas=1, rank=0,
                                      shuffle=True, seed=0)
    loader = data.DataLoader(ds, batch_size=bs, sampler=sampler,
                             num_workers=8, drop_last=True)
    batches = data.device_prefetch(iter(loader), size=2, device=dev)

    # the main path: every launch count starts at 0 here
    T.reset_launch_counts()
    times, losses = [], []
    for i in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dp.train_step(batch)
        loss = float(out.loss)  # waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"[slice] step {i + 1} loss {loss:.4f} "
            f"time {times[-1] * 1e3:.1f}ms [{card}]")
    launches = T.launch_counts()
    relayouts = T.DY_RELAYOUTS[0]
    log(f"[slice] kernels {json.dumps(launches)} dy_relayouts {relayouts}")
    for k, n in launches.items():
        if n != BN_LAYERS * steps:
            fail(f"{k} launched {n} times in {steps} steps, expected "
                 f"{BN_LAYERS * steps}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss in {losses}")
    steady = times[1:]  # the first step may build Triton kernels
    med = statistics.median(steady)
    log(f"[slice] first step {times[0] * 1e3:.1f}ms; "
        f"steady median {med * 1e3:.2f}ms over {len(steady)} steps = "
        f"{bs / med:.1f} img/s, batch {bs} at {side}x{side} bf16 [{card}]")

    # profiler window: where the device time goes in a steady step
    prof_batches = [next(batches), next(batches)]
    names = profile_window(
        torch, lambda: [dp.train_step(b_) for b_ in prof_batches], "profile",
        "BN kernels", lambda name: name in BN_TRITON_NAMES
        or any(ns in name for ns in BN_CUDA_NAMESPACES), card)
    stale = sorted(set(OLD_TRITON_NAMES) & names)
    if stale:
        fail(f"the profile window shows the old Triton forward kernels {stale}")

    # in-place A/B: one step from the same state on the same batch, with
    # the kernels ("auto") and with their plain versions ("off"); in the
    # kernel step every kernel call is also held against its plain version
    # on the same arguments
    ab_batch = next(batches)
    failures = []
    state = {k: v.clone() for k, v in model.state_dict().items()}
    opt_state = copy.deepcopy(opt.state_dict())
    result, seen = {}, {}
    for mode in ("auto", "off"):
        model.load_state_dict(state)
        opt.load_state_dict(copy.deepcopy(opt_state))
        check = checking_every_call(torch, T, seen) if mode == "auto" \
            else contextlib.nullcontext()
        with bn_ops.kernel_mode(mode), check:
            loss = float(dp.train_step(ab_batch).loss)
        result[mode] = (loss, _bn_buffers(torch, model), {
            n: p.grad.detach().float().clone() for n, p in model.named_parameters()})
    (l_k, buf_k, g_k), (l_p, buf_p, g_p) = result["auto"], result["off"]
    # bf16 activations: the kernel and the plain version round a few
    # elements differently (one bf16 ulp, 2^-7), and 50 layers carry that
    # forward — 1% on the loss, 2% of each layer's scale on its stats
    loss_err = abs(l_k - l_p) / max(abs(l_p), 1e-6)
    stat_err = 0.0
    for (name, rm_k, rv_k), (_, rm_p, rv_p) in zip(buf_k, buf_p):
        for a, b_ in ((rm_k, rm_p), (rv_k, rv_p)):
            e = float((a - b_).abs().max()) / (float(b_.abs().max()) + 1e-6)
            stat_err = max(stat_err, e)
    log(f"[a/b] loss kernels {l_k:.6f} plain {l_p:.6f} rel_err {loss_err:.2e} "
        f"(tol 1e-2); running stats of {len(buf_k)} layers max rel_err "
        f"{stat_err:.2e} (tol 2e-2)")
    # every layer's forward and backward kernels on the step's own tensors,
    # with the parity phase's bf16 tolerances
    for k in MOVES:
        calls, ratio, worst_abs = seen.get(k, (0, 0.0, 0.0))
        log(f"[a/b] {k:19s} at each of {calls} calls of the kernel step vs "
            f"its plain version on the same tensors: worst "
            f"{ratio:.2f} of tol, max_abs_err {worst_abs:.3e}")
        if calls != BN_LAYERS or ratio > 1.0:
            failures.append(f"{k} disagrees with its plain version inside "
                            f"the step ({calls} calls, worst {ratio:.2f} of tol)")

    # Whole-model gradients: shown, not gated. Rounding alone moves the
    # gradient of the early layers by about its whole norm (compare the
    # plain path in bf16 with the plain path in f32 below), so the gradient
    # of a 53-BN network cannot tell a wrong kernel from a rounding; the
    # per-call check above does, layer by layer.
    ref = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.float32, device=dev))
    ref.load_state_dict(state)
    with bn_ops.kernel_mode("off"):
        _loss_fn(ref, ab_batch).backward()
    g_f = {n: p.grad.detach() for n, p in ref.named_parameters()}
    bn_kind = {f"{name}.{leaf}": f"bn_{leaf}"
               for name, mod in model.named_modules()
               if isinstance(mod, nn.BatchNorm) for leaf in ("weight", "bias")}

    def by_kind(got, want):
        diff2, ref2 = {}, {}
        for n in want:
            kind = bn_kind.get(n, "conv_fc")
            diff2[kind] = diff2.get(kind, 0.0) + float((got[n] - want[n]).norm()) ** 2
            ref2[kind] = ref2.get(kind, 0.0) + float(want[n].norm()) ** 2
        return ", ".join(f"{kind} {math.sqrt(diff2[kind] / ref2[kind]):.2e}"
                         for kind in sorted(diff2))

    log(f"[a/b] gradients of {len(g_p)} parameters, norm rel_err by kind: "
        f"kernels vs plain (bf16): {by_kind(g_k, g_p)}; plain bf16 vs plain "
        f"f32: {by_kind(g_p, g_f)}; fc.weight alone: kernels vs plain "
        f"{float((g_k['fc.weight'] - g_p['fc.weight']).norm() / g_p['fc.weight'].norm()):.2e}, "
        f"bf16 vs f32 "
        f"{float((g_p['fc.weight'] - g_f['fc.weight']).norm() / g_f['fc.weight'].norm()):.2e}")
    del ref, g_f
    if loss_err > 1e-2 or stat_err > 2e-2:
        failures.append("kernels and plain versions disagree on the full model")

    ev_out = dp.eval_step(ab_batch)
    ev_loss = float(ev_out.loss)
    with torch.no_grad():
        logits = model(ab_batch[0])
    log(f"[eval] loss {ev_loss:.4f} logits {tuple(logits.shape)} "
        f"{logits.dtype}")
    if not math.isfinite(ev_loss) or tuple(logits.shape) != (bs, 1000) \
            or not bool(torch.isfinite(logits).all()):
        fail("eval step produced non-finite or misshapen output")
    for _ in batches:  # drain the loader so its threads finish
        pass
    return launches, failures, med


# -- phase 6: groups — the cross-replica path at world 4 on one card --------

# Four processes share the one card through a gloo group (gloo all-reduces
# and broadcasts CUDA tensors by copying them through the host; NCCL needs a
# card a rank). This checks the SyncBN and DataParallel collectives with the
# hand-written kernels; it measures no configuration a user would run.
GROUP_WORLD = 4
GROUP_SPECS = {"world": None, "g2": 2, "partition": ((0, 3), (1, 2))}
# one SyncBN layer at a ResNet-50 shape: 4 x 56 x 56 = 12544 rows a rank,
# C = 256, channels_last
GROUP_LAYER = (4, 256, 56, 56)
GROUP_BATCH, GROUP_STEPS = 16, 3  # per rank (global 64), bit-identity steps
GROUP_JOIN_S = 600
# World 4 against world 1, f32 with TF32 off, one SGD step of ResNet-50 at
# global batch 64. The two differ only in the order of f32 sums (BN moments
# over 4 partials; convolution gradients summed per 16-image shard, then
# across ranks). The loss is well conditioned: limit 1e-4 (f32 rounds at
# 6e-8). The update is not: at initialization the backward through 53 BN
# layers amplifies rounding, so reordering the images of the same world-1
# step moves the whole update (|Δp(perm) − Δp| / |Δp| over all
# parameters, L2) by percents (2.4e-2 on an H100, this phase's floor). So
# the update's limit is measured in the same run: the world-1 step
# repeated on the batch with its four shards in reverse order gives the
# rounding floor, and world 4 must agree with world 1 within 5x that
# floor. A missing 1/world (an update 4x too large: error 3), a wrong
# group or an unsynced layer moves the update by O(1).
TRAINER_LOSS_TOL, TRAINER_FLOOR_FACTOR = 1e-4, 5.0


def _layer_errs(torch, got, ref, terms=None):
    """Relative errors of the layer invariant, by output kind: elementwise
    against ``terms`` (|ref| + 1e-3 when None), per-channel sums against
    the largest |sum| (as ``_err``). y's terms are |x̂γ| + |β| + 1e-3: in
    float32 the kernel's per-channel scale and shift are rounded to f32
    (6e-8 of each), so at an element where x̂γ and β cancel, y's error is
    that rounding of its terms, not of y."""
    d = (got.detach().double() - ref).abs()
    if terms is None:
        return float(d.max() / (ref.abs().max() + 1e-30))
    return float((d / terms).max())


def _group_layer_case(torch, rank, spec, dtype, seed):
    """One SyncBatchNorm at ``GROUP_LAYER`` on every rank, forward and
    backward, against one BatchNorm of this rank's group's shards
    concatenated, in float64; returns ``{output: error / tolerance}``."""
    from tpu_syncbn_torch import nn
    from tpu_syncbn_torch.parallel import collectives

    n, c, h, w = GROUP_LAYER
    cl = torch.channels_last
    g = torch.Generator(device="cuda").manual_seed(seed)
    # every rank draws every rank's shard, so it can build its group's batch
    xs = [(torch.randn(n, c, h, w, generator=g, device="cuda") * 1.5 + 0.3)
          .to(dtype).contiguous(memory_format=cl) for _ in range(GROUP_WORLD)]
    dys = [torch.randn(n, c, h, w, generator=g, device="cuda").to(dtype)
           .contiguous(memory_format=cl) for _ in range(GROUP_WORLD)]
    gamma = torch.rand(c, generator=g, device="cuda") + 0.5
    beta = torch.randn(c, generator=g, device="cuda")
    bn = nn.SyncBatchNorm(c, channel_axis=1, group_size=spec, device="cuda")
    with torch.no_grad():
        bn.weight.copy_(gamma)
        bn.bias.copy_(beta)
    x = xs[rank].detach().requires_grad_()
    y = bn(x)
    y.backward(dys[rank])
    world = torch.distributed.group.WORLD
    dgamma = collectives.psum_in_groups(bn.weight.grad, world, spec)
    dbeta = collectives.psum_in_groups(bn.bias.grad, world, spec)

    members = next(grp for grp in collectives.partition(spec, GROUP_WORLD)
                   if rank in grp) if spec is not None else range(GROUP_WORLD)
    rows = lambda t: t.permute(0, 2, 3, 1).reshape(-1, c).double()  # noqa: E731
    xg = torch.cat([rows(xs[r]) for r in members])
    dyg = torch.cat([rows(dys[r]) for r in members])
    cnt = xg.shape[0]
    mean, var = xg.mean(0), xg.var(0, unbiased=False)
    invstd = torch.rsqrt(var + bn.eps)
    xhat = (xg - mean) * invstd
    gd, bd = gamma.double(), beta.double()
    y_ref = xhat * gd + bd
    sum_dy, sum_dy_xhat = dyg.sum(0), (dyg * xhat).sum(0)
    dx_ref = (dyg - sum_dy / cnt - xhat * sum_dy_xhat / cnt) * invstd * gd
    mine = slice(list(members).index(rank) * n * h * w,
                 (list(members).index(rank) + 1) * n * h * w)
    dname = str(dtype).split(".")[-1]
    tol = lambda k: TOL[(dname, k)]  # noqa: E731
    return {
        "y": _layer_errs(torch, rows(y), y_ref[mine],
                         (xhat[mine] * gd).abs() + bd.abs() + 1e-3)
        / tol("bn_normalize"),
        "dx": _layer_errs(torch, rows(x.grad), dx_ref[mine],
                          dx_ref[mine].abs() + 1e-3) / tol("bn_backward_elemt"),
        "dgamma": _layer_errs(torch, dgamma, sum_dy_xhat) / tol("bn_backward_reduce"),
        "dbeta": _layer_errs(torch, dbeta, sum_dy) / tol("bn_backward_reduce"),
        "running_mean": _layer_errs(torch, bn.running_mean, 0.1 * mean)
        / tol("bn_stats"),
        "running_var": _layer_errs(torch, bn.running_var,
                                   0.9 + 0.1 * var * cnt / (cnt - 1)) / tol("bn_stats"),
    }


def _group_faults(torch, rank):
    """Two planted faults, each applied on every rank (so every rank still
    issues the same collectives on the same groups) through a patch of this
    process's modules; returns each one's worst error / tolerance, which
    must exceed 1."""
    from tpu_syncbn_torch.ops import triton_bn as T
    from tpu_syncbn_torch.parallel import collectives

    out = {}
    # (a) the partition's groups are built as the contiguous pairs
    real_build = collectives._build_groups

    def contiguous(groups, parent):
        return real_build(((0, 1), (2, 3)) if groups == ((0, 3), (1, 2))
                          else groups, parent)

    collectives.clear_group_cache()
    collectives._build_groups = contiguous
    try:
        out["partition_built_contiguous"] = max(_group_layer_case(
            torch, rank, GROUP_SPECS["partition"], torch.float32, 11).values())
    finally:
        collectives._build_groups = real_build
        collectives.clear_group_cache()
    # (b) the moments are all-reduced, then each rank normalizes with its own
    real_reduce = T.reduce_moments

    def local_moments(s, sq, count, group, **kw):
        real_reduce(s, sq, count, group, **kw)
        mean, var = T.moments_from_stats(s, sq, count)
        return mean, var, count

    T.reduce_moments = local_moments
    try:
        out["local_moments"] = max(_group_layer_case(
            torch, rank, None, torch.float32, 12).values())
    finally:
        T.reduce_moments = real_reduce
    return out


def _group_trainer_check(torch, rank, ref):
    """One DataParallel step of f32 ResNet-50 at world 4 (16 images a
    rank) from the world-1 step's weights and batch; returns (loss rel
    err, whole-update rel err, fc.weight's update rel err)."""
    from tpu_syncbn_torch import models, nn, parallel

    model = nn.convert_sync_batchnorm(models.resnet50(num_classes=1000,
                                                      device="cuda"))
    model.load_state_dict(ref["state"])
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    dp = parallel.DataParallel(model, opt, _loss_fn, device="cuda")
    sl = slice(rank * GROUP_BATCH, (rank + 1) * GROUP_BATCH)
    loss = float(dp.train_step((ref["x"][sl].cuda(), ref["y"][sl].cuda())).loss)
    after = {k: p.detach().cpu() for k, p in model.named_parameters()}
    params = {k: ref["state"][k] for k in after}
    fc = "fc.weight"
    return (abs(loss - ref["loss"]) / abs(ref["loss"]),
            _update_rel_err(params, after, ref["after"]),
            _update_rel_err({fc: params[fc]}, {fc: after[fc]}, {fc: ref["after"][fc]}))


def _group_replicas(torch, rank):
    """GROUP_STEPS DataParallel steps of bf16 ResNet-50 with group-scoped
    SyncBN (group_size=2), a different batch a rank: after every step each
    rank's parameters, and its buffers after the trainer's broadcast, equal
    rank 0's bit for bit. Returns (identical per step, launches, step
    times in ms)."""
    from tpu_syncbn_torch import models, nn, parallel
    from tpu_syncbn_torch.ops import triton_bn as T

    tdist = torch.distributed
    model = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.bfloat16, device="cuda"), group_size=2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    dp = parallel.DataParallel(model, opt, _loss_fn, device="cuda")
    if not dp._per_step_broadcast:
        raise RuntimeError("a group-scoped SyncBN model must keep the "
                           "per-step buffer broadcast")
    g = torch.Generator(device="cuda").manual_seed(100 + rank)
    batches = [(torch.randn(GROUP_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3, generator=g,
                            device="cuda"),
                torch.randint(0, 1000, (GROUP_BATCH,), generator=g, device="cuda"))
               for _ in range(GROUP_STEPS)]
    same, times = [], []
    T.reset_launch_counts()  # the main path of this phase
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp.train_step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ok = True
        for ts in ([p.detach() for p in model.parameters()],
                   [b_ for b_ in model.buffers() if b_ is not None]):
            flat = torch.cat([t.reshape(-1).double() for t in ts])
            ref = flat.clone()
            tdist.broadcast(ref, src=0)
            ok = ok and torch.equal(flat, ref)
        same.append(ok)
    launches = T.launch_counts()
    # K steps as one CUDA graph cannot hold gloo's host-side collectives:
    # train_steps_batches on CUDA tensors under this gloo group must raise
    try:
        dp.train_steps_batches(tuple(t[None] for t in batches[0]))
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    return same, launches, times, refusal


GROUP_COMPRESS_N = 100_000  # elements a rank (a multiple of 4 for the scatter)
F32_U, BF16_U = 2.0 ** -24, 2.0 ** -8  # unit roundoffs


def _world_grid(torch, xs, chunk: int = 256):
    """Per element of the fused payloads ``xs`` (one a rank): its chunk's
    shared scale and zero point at world ``len(xs)``, in f64."""
    w, n = len(xs), xs[0].numel()
    pad = (-n) % chunk
    blocks = torch.nn.functional.pad(torch.stack(xs).double(), (0, pad)).view(w, -1, chunk)
    gmin, gmax = blocks.amin(dim=(0, 2)), blocks.amax(dim=(0, 2))
    scale = (gmax - gmin) / 2 / (127 // w)
    return (scale.repeat_interleave(chunk)[:n], ((gmax + gmin) / 2).repeat_interleave(chunk)[:n])


def _group_compress(torch, rank):
    """The compressed collectives on CUDA tensors at world 4 over gloo
    (the int8 kernels on the card), each against a float64 reduction of
    the four ranks' inputs, as error / analytic bound (<= 1 passes): int8
    codes are within scale/2 of their values, bf16 rounds each addend and
    partial sum once; two SyncBN steps with bf16 statistics (the running
    mean against the f64 global mean, bf16-rounded sums allowed); the int8
    statistics' backward must raise."""
    from tpu_syncbn_torch import nn
    from tpu_syncbn_torch.parallel import collectives as C

    world, w = torch.distributed.group.WORLD, GROUP_WORLD
    g = torch.Generator(device="cuda").manual_seed(40)
    xs = [torch.randn(GROUP_COMPRESS_N, device="cuda", generator=g) for _ in range(w)]
    es = [torch.randn(GROUP_COMPRESS_N, device="cuda", generator=g) * 1e-2 for _ in range(w)]
    x, e = xs[rank], es[rank]
    exact = torch.stack([t.double() for t in xs]).sum(0)
    absum = torch.stack([t.double().abs() for t in xs]).sum(0)
    out = {}

    def ratio(got, ref, bound):
        return float(((got.double() - ref).abs() / bound).max())

    scale, zp = _world_grid(torch, xs)
    slack = 4 * F32_U * (absum + 127 * w * scale + w * zp.abs())
    out["pmean int8"] = ratio(C.compressed_pmean(x, world, mode="int8"), exact / w,
                              scale / 2 + slack / w)
    # each addend rounds once and each of the w - 1 partial sums once
    out["pmean bf16"] = ratio(C.compressed_pmean(x, world, mode="bf16"), exact / w,
                              (w + 1) * BF16_U * absum / w + 1e-30)
    ps = [a + b for a, b in zip(xs, es)]
    p_exact = torch.stack([t.double() for t in ps]).sum(0)
    p_scale, p_zp = _world_grid(torch, ps)
    p_slack = 4 * F32_U * (p_exact.abs() + 127 * w * p_scale + w * p_zp.abs())
    mean, res = C.ef_compressed_pmean(x, e, world, mode="int8")
    out["ef_pmean int8"] = ratio(mean, p_exact / w, p_scale / 2 + p_slack / w)
    out["ef residual"] = float((res.double().abs() / (p_scale / 2 + p_slack)).max())
    # the scatter: one chunk a shard
    shard_n = GROUP_COMPRESS_N // w
    s_scale = torch.stack([t.double().view(w, -1) for t in xs])  # (rank, shard, elem)
    half = (s_scale.amax(dim=(0, 2)) - s_scale.amin(dim=(0, 2))) / 2 / (127 // w)
    mine = slice(rank * shard_n, (rank + 1) * shard_n)
    shard, _ = C.compressed_reduce_scatter(x, world, mode="int8")
    out["reduce_scatter int8"] = ratio(shard, exact[mine],
                                       w * half[rank] / 2 + slack[mine] + 1e-30)
    stages = len(C._prime_factors(w))
    for mode in ("none", "bf16", "int8"):
        got = C.shuffle_sharded_psum(x, world, mode=mode)
        bound = {"none": 4 * w * F32_U * absum + 1e-30,
                 "bf16": (1 + stages) * 2 * BF16_U * absum + 1e-30,
                 "int8": w * scale / 2 + slack}[mode]
        out[f"shuffle {mode}"] = ratio(got, exact, bound)

    # SyncBN with bf16 statistics, two steps on one batch a rank
    n_, c, h, w_ = GROUP_LAYER
    xb = [(torch.randn(n_, c, h, w_, generator=g, device="cuda") * 1.5 + 0.3)
          .contiguous(memory_format=torch.channels_last) for _ in range(w)]
    bn = nn.SyncBatchNorm(c, channel_axis=1, stats_compress="bf16", device="cuda")
    for _ in range(2):
        xx = xb[rank].detach().requires_grad_()
        y = bn(xx)
        y.backward(torch.ones_like(y))
    rows = torch.cat([t.permute(0, 2, 3, 1).reshape(-1, c).double() for t in xb])
    local = [t.permute(0, 2, 3, 1).reshape(-1, c).double().sum(0).abs() for t in xb]
    tol_mean = (w + 1) * BF16_U * torch.stack(local).sum(0) / rows.shape[0]
    want = 0.19 * rows.mean(0)  # two momentum-0.1 updates from 0
    out["syncbn bf16 running_mean"] = ratio(bn.running_mean, want, 0.19 * tol_mean + 1e-30)
    out["syncbn bf16 finite"] = 0.0 if bool(torch.isfinite(y).all()
                                           and torch.isfinite(xx.grad).all()) else 2.0
    bn8 = nn.SyncBatchNorm(c, channel_axis=1, stats_compress="int8", device="cuda")
    try:
        bn8(xb[rank].detach().requires_grad_()).sum().backward()
        out["int8 stats backward raises"] = 2.0
    except NotImplementedError as err:
        out["int8 stats backward raises"] = 0.0 if "no gradient" in str(err) else 2.0
    return out


GROUP_ZERO_BATCH = 8  # images a rank in the ZeRO part (global 32)
GAN_TOL = dict(rtol=2e-4, atol=1e-5)  # the GAN tests' parameter tolerance


def _close_ratio(a: dict, b: dict, atol: float = 1e-5, rtol: float = 1e-7) -> float:
    """Worst |a - b| / (atol + rtol |b|) over every tensor: <= 1 is the JAX
    tests' ``trees_close`` (``assert_allclose`` at atol 1e-5, its default
    rtol 1e-7)."""
    return max(float(((a[k].double() - b[k].double()).abs()
                      / (atol + rtol * b[k].double().abs())).max()) for k in b)


def _scatter_bound_ratio(torch, p, shard, group) -> float:
    """One int8 reduce-scatter (one chunk a shard) against the float64 sum
    of the group's inputs ``p`` on this rank's shard, as error / analytic
    bound (<= 1 passes): each rank's code is within scale/2 of its value,
    plus 4 f32 roundings of the terms (``_group_compress``'s bound)."""
    from tpu_syncbn_torch.parallel import collectives as C

    w, me = C.world_size(group), C._rank(group)
    rows = C.all_gather(p, group).double()  # (rank, n)
    n = rows.shape[1] // w
    mine = slice(me * n, (me + 1) * n)
    blocks = rows.view(w, w, n)  # (rank, shard, element)
    half = (blocks.amax(dim=(0, 2)) - blocks.amin(dim=(0, 2))) / 2 / (127 // w)
    zp = (blocks.amax(dim=(0, 2)) + blocks.amin(dim=(0, 2))) / 2
    exact = rows.sum(0)[mine]
    absum = rows.abs().sum(0)[mine]
    slack = 4 * F32_U * (absum + 127 * w * half[me] + w * zp[me].abs())
    return float(((shard.double() - exact).abs() / (w * half[me] / 2 + slack + 1e-30)).max())


def _group_zero(torch, rank):
    """The sharded weight update at world 4 (ROADMAP A.10), f32 ResNet-50
    with TF32 off and cuDNN deterministic at GROUP_ZERO_BATCH images a
    rank: SpecLayout.zero() and SpecLayout.fsdp(data=2, fsdp=2) against
    plain DataParallel for ZERO_STEPS SGD-momentum steps on the same
    shards (every loss's relative error; parameters and running
    statistics after each step, as ``trees_close`` ratios); Adam's
    state numel against padded / shard_world; build_redistribute against
    unshard_params; int8 under fsdp (finite losses; the reduce-scatter
    within its analytic bound); a DCGAN GANTrainer under a composed
    replicated layout against group= training (Adam's eps 1e-3, as the
    GAN tests: eps 1e-8 turns a gradient that cancels to ~0 into ±lr)."""
    from tpu_syncbn_torch import models, nn, parallel
    from tpu_syncbn_torch.parallel import collectives as C
    from tpu_syncbn_torch.parallel.layout import SpecLayout
    from tpu_syncbn_torch.parallel.redistribute import build_redistribute
    from tpu_syncbn_torch.parallel.zero import unshard_params

    B = GROUP_ZERO_BATCH
    g = torch.Generator(device="cuda").manual_seed(200)
    glob = [(torch.randn(GROUP_WORLD * B, IMAGE_SIZE, IMAGE_SIZE, 3, generator=g, device="cuda"),
             torch.randint(0, 1000, (GROUP_WORLD * B,), generator=g, device="cuda"))
            for _ in range(ZERO_STEPS)]
    mine = [(x[rank * B:(rank + 1) * B], y[rank * B:(rank + 1) * B]) for x, y in glob]

    def build(opt="sgdm", **kw):
        model = nn.convert_sync_batchnorm(models.resnet50(
            num_classes=1000, device="cuda", generator=torch.Generator().manual_seed(0)))
        o = (torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9) if opt == "sgdm"
             else torch.optim.Adam(model.parameters(), lr=1e-3))
        return model, parallel.DataParallel(model, o, _loss_fn, device="cuda", **kw)

    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out, runs = {}, {}
    for tag, kw in (("dp", {}), ("zero", {"layout": SpecLayout.zero()}),
                    ("fsdp", {"layout": SpecLayout.fsdp(data=2, fsdp=2)})):
        model, dp = build(**kw)
        losses, params, bufs = [], [], []
        for b in mine:
            losses.append(float(dp.train_step(b).loss))
            params.append({n: p.detach().clone() for n, p in model.named_parameters()})
            bufs.append({n: t.detach().clone() for n, t in model.named_buffers()
                         if t.is_floating_point()})
        runs[tag] = (losses, params, bufs)
        if tag == "fsdp":
            full = unshard_params(dp._flat, dp._shards, dp._shard_group)
            red = build_redistribute(dp._flat, dp.layout)(dp._shards)
            out["redistribute_bitwise"] = all(torch.equal(red[n].cpu(), full[n]) for n in full)
        del dp, model
        torch.cuda.empty_cache()
    l0, p0, b0 = runs.pop("dp")
    for tag, (losses, params, bufs) in runs.items():
        out[tag] = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, l0)),
                    "param_ratio": [_close_ratio(p, q) for p, q in zip(params, p0)],
                    "buffer_ratio": [_close_ratio(b, c) for b, c in zip(bufs, b0)]}
    runs.clear()
    for tag, kw in (("zero", {"layout": SpecLayout.zero()}),
                    ("fsdp", {"layout": SpecLayout.fsdp(data=2, fsdp=2)})):
        model, dp = build("adam", **kw)
        dp.train_step(mine[0])
        st = dp.optimizer.state[dp._shards["float32"]]
        out[tag]["adam_numel"] = [st["exp_avg"].numel(), st["exp_avg_sq"].numel(),
                                  dp._flat.padded["float32"] // dp._shard_world]
        del dp, model
        torch.cuda.empty_cache()
    # int8 under fsdp: the trainer's compressed reduce-scatters, spied
    model, dp = build("adam", layout=SpecLayout.fsdp(data=2, fsdp=2), compress="int8")
    real, ratios = C.compressed_reduce_scatter, []

    def spy(x, group, **kw):
        shard, res = real(x, group, **kw)
        ratios.append(_scatter_bound_ratio(torch, x, shard, group))
        return shard, res

    C.compressed_reduce_scatter = spy
    try:
        losses = [float(dp.train_step(b).loss) for b in mine]
    finally:
        C.compressed_reduce_scatter = real
    out["int8"] = {"losses": losses, "finite": all(math.isfinite(v) for v in losses),
                   "bound_ratio": max(ratios), "calls": len(ratios)}
    del dp, model
    torch.cuda.empty_cache()
    # GANTrainer under a composed replicated layout against group=
    gan = {}
    for tag, kw in (("layout", {"layout": SpecLayout({"data": 2, "fsdp": 2},
                                                     param_shard_axis=None)}),
                    ("group", {"group": torch.distributed.group.WORLD})):
        G = nn.convert_sync_batchnorm(models.DCGANGenerator(
            latent_dim=128, device="cuda", generator=torch.Generator().manual_seed(0)))
        D = nn.convert_sync_batchnorm(models.DCGANDiscriminator(
            device="cuda", generator=torch.Generator().manual_seed(1)))
        tr = parallel.GANTrainer(
            G, D, torch.optim.Adam(G.parameters(), lr=2e-4, betas=(0.5, 0.999), eps=1e-3),
            torch.optim.Adam(D.parameters(), lr=2e-4, betas=(0.5, 0.999), eps=1e-3),
            device="cuda", **kw)
        gg = torch.Generator(device="cuda").manual_seed(13 + rank)
        n = GAN_BATCH // GROUP_WORLD
        o = tr.train_step(torch.rand(n, 32, 32, 3, device="cuda", generator=gg) * 2 - 1,
                          torch.randn(n, 128, device="cuda", generator=gg),
                          torch.randn(n, 128, device="cuda", generator=gg))
        gan[tag] = ([float(o.d_loss), float(o.g_loss)],
                    {f"{k}.{n_}": v.detach().clone() for k, m in (("g", G), ("d", D))
                     for n_, v in list(m.named_parameters()) + list(m.named_buffers())
                     if v.is_floating_point()})
    (ll, sl), (lg, sg) = gan["layout"], gan["group"]
    out["gan"] = {"finite": all(math.isfinite(v) for v in ll),
                  "loss_rel": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(ll, lg)),
                  "state_ratio": max(float(((sl[k].double() - v.double()).abs()
                                            / (GAN_TOL["atol"] + GAN_TOL["rtol"]
                                               * v.double().abs())).max())
                                     for k, v in sg.items())}
    torch.backends.cudnn.deterministic = determ
    return out


def _groups_child(rank, d, ref_path):
    """One of the GROUP_WORLD processes: cuda:0, a gloo group through a
    file:// rendezvous, then ``runtime.initialize("cuda")``, which keeps
    it. Writes its results to ``d/rank<r>.json``; any failure raises, and
    the process exits non-zero."""
    sys.path.insert(0, HERE)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(GROUP_WORLD),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(GROUP_WORLD))
    import torch
    import torch.distributed as tdist

    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                             world_size=GROUP_WORLD, rank=rank)
    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.ops import batch_norm as bn_ops

    dev = runtime.initialize("cuda")
    if dev != torch.device("cuda", 0) or runtime.process_count() != GROUP_WORLD:
        raise RuntimeError(f"initialize gave {dev}, world {runtime.process_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bn_ops.set_kernel_mode("on")  # a CPU tensor or a missed launch raises
    out = {"layer": {}}
    for name, spec in GROUP_SPECS.items():
        for dtype in (torch.float32, torch.bfloat16):
            out["layer"][f"{name} {str(dtype).split('.')[-1]}"] = \
                _group_layer_case(torch, rank, spec, dtype, 1)
    out["faults"] = _group_faults(torch, rank)
    deadline = time.monotonic() + GROUP_JOIN_S  # the parent writes it meanwhile
    while not os.path.exists(ref_path):
        if time.monotonic() > deadline:
            raise RuntimeError(f"no world-1 reference at {ref_path}")
        time.sleep(0.2)
    ref = torch.load(ref_path, map_location="cpu")
    out["trainer"] = _group_trainer_check(torch, rank, ref)
    del ref
    t0 = time.perf_counter()
    out["zero"] = _group_zero(torch, rank)
    out["zero"]["seconds"] = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = True
    out["replicas"] = _group_replicas(torch, rank)
    out["compress"] = _group_compress(torch, rank)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown()


def _groups_zero_summary(res, summary, card) -> list:
    """The ZeRO part of the children's results: gates and lines."""
    failures = []
    z = [r_["zero"] for r_ in res]
    summary["zero"] = {}
    for tag, shard_world in (("zero", GROUP_WORLD), ("fsdp", 2)):
        loss = max(r_[tag]["loss_rel"] for r_ in z)
        params = [max(r_[tag]["param_ratio"][i] for r_ in z) for i in range(ZERO_STEPS)]
        bufs = [max(r_[tag]["buffer_ratio"][i] for r_ in z) for i in range(ZERO_STEPS)]
        numel_ok = all(r_[tag]["adam_numel"][0] == r_[tag]["adam_numel"][1]
                       == r_[tag]["adam_numel"][2] for r_ in z)
        # zero reduces in the plain trainer's order (one all-reduce of the
        # same flat buffer over the world), so its whole trajectory is
        # held; fsdp sums the two axes in turn, so its first gradients
        # differ by f32 roundings, which the second step amplifies as the
        # trainer check's floor says (ResNet-50 at initialization): its
        # state is held after the first step, shown after the last
        n_gated = ZERO_STEPS if tag == "zero" else 1
        ok = (loss <= 1e-5 and max(params[:n_gated] + bufs[:n_gated]) <= 1.0
              and numel_ok)
        summary["zero"][tag] = {"loss_rel": loss, "param_ratio": params, "buffer_ratio": bufs,
                                "adam_numel": z[0][tag]["adam_numel"]}
        log(f"[groups] {tag} (shard world {shard_world}) vs plain DataParallel, f32 "
            f"ResNet-50 at {GROUP_ZERO_BATCH} a rank, {ZERO_STEPS} SGD-momentum steps on "
            f"the same shards: loss rel err {loss:.2e} (tol 1e-5); after each step "
            f"parameters {[round(v, 3) for v in params]} and running statistics "
            f"{[round(v, 3) for v in bufs]} of trees_close (atol 1e-5; "
            + ("every step gated" if tag == "zero" else "the first step gated, the "
               "second shown") + f"); Adam state a rank {z[0][tag]['adam_numel'][0]} = "
            f"padded / shard world {z[0][tag]['adam_numel'][2]} on every rank: "
            f"{numel_ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[groups] {tag} disagrees with plain DataParallel")
    red = all(r_["redistribute_bitwise"] for r_ in z)
    i8 = [r_["int8"] for r_ in z]
    bound = max(r_["bound_ratio"] for r_ in i8)
    finite = all(r_["finite"] for r_ in i8)
    gan_ok = all(r_["gan"]["finite"] for r_ in z)
    gan_loss = max(r_["gan"]["loss_rel"] for r_ in z)
    gan_state = max(r_["gan"]["state_ratio"] for r_ in z)
    summary["zero"].update(redistribute_bitwise=red, int8_bound_ratio=bound,
                           int8_losses=i8[0]["losses"], gan_loss_rel=gan_loss,
                           gan_state_ratio=gan_state,
                           seconds=max(r_["seconds"] for r_ in z))
    log(f"[groups] build_redistribute's tree bitwise equal to unshard_params on every "
        f"rank: {red} {'ok' if red else 'FAIL'}")
    log(f"[groups] int8 under fsdp(data=2, fsdp=2), Adam: losses {i8[0]['losses']} finite "
        f"on every rank: {finite}; each compressed reduce-scatter ({i8[0]['calls']} a rank) "
        f"within {bound:.3f} of its analytic bound of a float64 reduction "
        f"{'ok' if finite and bound <= 1.0 else 'FAIL'}")
    log(f"[groups] DCGAN GANTrainer(layout=SpecLayout(data=2, fsdp=2, replicated)) vs "
        f"group= world 4, one iteration: finite {gan_ok}, losses rel err {gan_loss:.2e} "
        f"(tol 1e-5), state worst {gan_state:.3f} of rtol 2e-4 / atol 1e-5 "
        f"{'ok' if gan_ok and gan_loss <= 1e-5 and gan_state <= 1 else 'FAIL'}")
    log(f"[groups] the ZeRO part took {summary['zero']['seconds']:.1f}s a rank [{card}]")
    if not red:
        failures.append("[groups] build_redistribute differs from unshard_params")
    if not finite or bound > 1.0:
        failures.append(f"[groups] int8 under fsdp: finite {finite}, bound ratio {bound:.3f}")
    if not gan_ok or gan_loss > 1e-5 or gan_state > 1.0:
        failures.append("[groups] the GAN under a composed layout disagrees with group=")
    return failures


def _update_rel_err(before, after, want_after) -> float:
    """|Δ − Δ_want| / |Δ_want| over every parameter at once (L2), in f64."""
    diff2 = want2 = 0.0
    for name, b in before.items():
        want = want_after[name].double() - b.double()
        diff2 += float((after[name].double() - b.double() - want).norm()) ** 2
        want2 += float(want.norm()) ** 2
    return math.sqrt(diff2 / want2)


def _world1_step(torch, model, state, x, y):
    """One f32 DataParallel step (TF32 off) of ``model`` from ``state`` on
    the whole batch, at world 1; returns (loss, updated parameters)."""
    from tpu_syncbn_torch import parallel

    model.load_state_dict(state)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    dp = parallel.DataParallel(model, opt, _loss_fn, device="cuda")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        loss = float(dp.train_step((x.cuda(), y.cuda())).loss)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return loss, {k: p.detach().cpu().clone() for k, p in model.named_parameters()}


def _world1_reference(torch, path):
    """The world-1 side of the trainer check, outside any process group:
    weights, batch, loss and updated parameters of one f32 ResNet-50 step
    saved for the children; and the rounding floor, the same step with the
    batch's four shards in reverse order. Returns (loss, floor)."""
    from tpu_syncbn_torch import models, nn

    model = nn.convert_sync_batchnorm(models.resnet50(num_classes=1000,
                                                      device="cuda"))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(5)
    n = GROUP_WORLD * GROUP_BATCH
    x = torch.randn(n, IMAGE_SIZE, IMAGE_SIZE, 3, generator=g)
    y = torch.randint(0, 1000, (n,), generator=g)
    loss, after = _world1_step(torch, model, state, x, y)
    rev = torch.cat([torch.arange(r * GROUP_BATCH, (r + 1) * GROUP_BATCH)
                     for r in reversed(range(GROUP_WORLD))])
    _, after_rev = _world1_step(torch, model, state, x[rev], y[rev])
    del model
    torch.cuda.empty_cache()
    params = {k: state[k] for k in after}
    floor = _update_rel_err(params, after_rev, after)
    # the children wait for the file: it appears whole
    torch.save({"state": state, "x": x, "y": y, "loss": loss, "after": after}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return loss, floor


def _launcher_commands(n: int) -> dict:
    """``python -m tpu_syncbn_torch.launch`` with ``train.py`` (ResNet-50):
    at --nproc-per-node 1, and at one process more than the ``n`` cards."""
    base = [sys.executable, "-m", "tpu_syncbn_torch.launch"]
    train = [os.path.join("tpu_syncbn_torch", "train.py"), "--", "--arch",
             "resnet50", "--epochs", "1", "--dataset-size", "128",
             "--batch-size", "64"]
    return {"train": base + ["--nproc-per-node", "1"] + train,
            "refusal": base + ["--nproc-per-node", str(n + 1)] + train}


def _launcher_gates(res: dict, n: int) -> list:
    """``_launcher_commands``' runs: train.py must reach its ``done:`` line;
    the request for ``n + 1`` processes must exit non-zero, naming the
    card count."""
    failures = []
    r = res["train"]
    done = [ln for ln in r.stdout.splitlines() if ln.startswith("done:")]
    log(f"[groups] launcher --nproc-per-node 1 train.py --arch resnet50: exit "
        f"{r.returncode}; {done[-1] if done else 'no done: line'}")
    if r.returncode != 0 or not done:
        failures.append("[groups] the launcher did not run train.py at --nproc-per-node 1: "
                        + (r.stdout + r.stderr)[-2000:])
    r = res["refusal"]
    msg = (r.stdout + r.stderr).strip().splitlines()
    log(f"[groups] launcher --nproc-per-node {n + 1} on {n} card(s): exit "
        f"{r.returncode}: {msg[-1] if msg else ''}")
    if r.returncode == 0 or f"this node has {n}" not in r.stdout + r.stderr:
        failures.append(f"[groups] the launcher did not refuse --nproc-per-node {n + 1}")
    return failures


def _side_by_side(cmds: dict, timeout: float = 300) -> dict:
    """Every command at once, from the checkout with it on ``PYTHONPATH``,
    each to its end or ``timeout``: ``{name: CompletedProcess}``. The
    launcher runs are start-up bound (imports, the card, cuDNN's plans,
    spawned workers), so together they take about the longest one."""
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = {name: subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}
    out = {}
    for name, p in procs.items():
        try:
            o, e = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            o, e = p.communicate()
        out[name] = subprocess.CompletedProcess(p.args, p.returncode, o, e)
    return out


def phase_groups(torch, card):
    """The cross-replica path with the kernels: four processes on the one
    card over gloo (see GROUP_WORLD). Returns the summary and failures."""
    import multiprocessing
    import tempfile

    failures = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_groups_") as d:
        ref_path = os.path.join(d, "world1.pt")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_groups_child, args=(r, d, ref_path))
                 for r in range(GROUP_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        # the reference is read only at the children's trainer check: it is
        # computed while they start and run their layer cases
        t1 = time.perf_counter()
        try:
            ref_loss, floor = _world1_reference(torch, ref_path)
        except BaseException:
            for p in procs:
                p.kill()
            raise
        log(f"[groups] world-1 reference steps in {time.perf_counter() - t1:.1f}s, beside "
            "the four processes' start")
        deadline = time.monotonic() + GROUP_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        if alive:
            fail(f"[groups] {len(alive)} of {GROUP_WORLD} processes still "
                 f"running after {GROUP_JOIN_S}s; killed")
        codes = [p.exitcode for p in procs]
        if codes != [0] * GROUP_WORLD:
            fail(f"[groups] process exit codes {codes}")
        res = []
        for r in range(GROUP_WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                res.append(json.load(f))
    secs = time.perf_counter() - t0
    summary = {"world": GROUP_WORLD, "layer": {}, "faults": {}}
    for case in res[0]["layer"]:
        per = {k: max(r_["layer"][case][k] for r_ in res) for k in res[0]["layer"][case]}
        worst = max(per.values())
        summary["layer"][case] = worst
        log(f"[groups] layer C=256 x 12544 rows a rank, {case}: worst {worst:.3f} "
            "of tol over 4 ranks (" + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
            + f") {'ok' if worst <= 1.0 else 'FAIL'}")
        if worst > 1.0:
            failures.append(f"[groups] layer invariant {case}: {worst:.3f} of tol")
    for fault in res[0]["faults"]:
        worst = min(r_["faults"][fault] for r_ in res)
        summary["faults"][fault] = worst
        log(f"[groups] planted fault {fault}: fails its check at "
            f"{worst:.2f}x tol (least over 4 ranks) "
            f"{'ok' if worst > 1.0 else 'FAIL: the check did not see it'}")
        if worst <= 1.0:
            failures.append(f"[groups] planted fault {fault} passed the check")
    loss_err = max(r_["trainer"][0] for r_ in res)
    upd_err = max(r_["trainer"][1] for r_ in res)
    fc_err = max(r_["trainer"][2] for r_ in res)
    upd_tol = TRAINER_FLOOR_FACTOR * floor
    summary["trainer"] = {"loss_rel_err": loss_err, "update_rel_err": upd_err,
                          "update_floor": floor}
    ok = loss_err <= TRAINER_LOSS_TOL and upd_err <= upd_tol
    log(f"[groups] trainer: world 4 (16 a rank) vs world 1 (64), f32 ResNet-50, "
        f"TF32 off, loss {ref_loss:.6f}: loss rel err {loss_err:.2e} (tol "
        f"{TRAINER_LOSS_TOL:.0e}); whole update rel err {upd_err:.3e} against "
        f"the world-1 step's own rounding floor {floor:.3e} (shards reversed; "
        f"tol {TRAINER_FLOOR_FACTOR:g}x floor = {upd_tol:.3e}); worst "
        f"{max(loss_err / TRAINER_LOSS_TOL, upd_err / upd_tol):.3f} of tol "
        f"{'ok' if ok else 'FAIL'}; fc.weight's update alone {fc_err:.2e}")
    if not ok:
        failures.append("[groups] world 4 disagrees with world 1")
    same = all(all(r_["replicas"][0]) for r_ in res)
    want = BN_LAYERS * GROUP_STEPS
    counts = [r_["replicas"][1] for r_ in res]
    summary["replicas_bit_identical"] = same
    summary["launches_per_rank"] = counts
    log(f"[groups] replicas: bf16 ResNet-50, group_size=2, {GROUP_STEPS} steps: "
        f"parameters and buffers equal rank 0's bit for bit after every step "
        f"on every rank: {same}; BN kernel launches per rank {counts} "
        f"(expected {want} each)")
    if not same:
        failures.append("[groups] replicas differ from rank 0")
    if any(n_ != want for c_ in counts for n_ in c_.values()):
        failures.append(f"[groups] a BN kernel did not launch {want} times on every rank")
    refusals = [r_["replicas"][3] for r_ in res]
    refused = all(m is not None and "gloo" in m for m in refusals)
    summary["gloo_scan_refused"] = refused
    log(f"[groups] train_steps_batches on CUDA tensors under the gloo group raises "
        f"on every rank: {refused} ({refusals[0]!r})")
    if not refused:
        failures.append(f"[groups] train_steps_batches under gloo did not raise: {refusals}")
    summary["compress"] = {}
    for check in res[0]["compress"]:
        worst = max(r_["compress"][check] for r_ in res)
        summary["compress"][check] = worst
        log(f"[groups] compressed {check}: worst {worst:.3f} of its bound over 4 ranks "
            f"{'ok' if worst <= 1.0 else 'FAIL'}")
        if worst > 1.0:
            failures.append(f"[groups] compressed {check}: {worst:.3f} of its bound")
    for r, r_ in enumerate(res):
        log(f"[groups] rank {r} step times " + ", ".join(
            f"{t:.1f}" for t in r_["replicas"][2]) + " ms: four processes "
            f"time-slicing one card through gloo host copies, not a throughput "
            f"figure [{card}]")
    failures += _groups_zero_summary(res, summary, card)
    log(f"[groups] four processes: {secs:.1f}s from spawn to join (the launcher checks "
        f"run at the end of [imagenet])")
    return summary, failures


# -- phase 7: imagenet — the real-image data path --------------------------

# A JPEG tree of ImageNet's shape (the ILSVRC-2012 train images average
# about 400 x 350 pixels and 110 KB): 4 classes of 160 train images (10
# steps of batch 64) and of 16 val images (one eval batch).
IMAGENET_CLASSES, IMAGENET_TRAIN, IMAGENET_VAL = 4, 160, 16
LOADER_WORKERS = 8  # the JAX example's num_workers
PROFILED_STEP = 4  # the 2-step profiler window starts at this 0-based step
STAGED_CHECKED = 3  # staged batches read back from the card


def _smooth_jpeg(path: str, seed: int) -> int:
    """One image of 375-500 x 300-375 pixels: colour fields at three
    scales, upsampled, plus mild noise, saved at quality 90 (about 100 KB,
    so the decoder does a photo's work, not a noise image's). Returns the
    file's bytes."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    w, h = rs.randint(375, 501), rs.randint(300, 376)
    out = np.zeros((h, w, 3), np.float32)
    for grid, amp in (((6, 8), 1.0), ((24, 32), 1.0), ((150, 190), 2.0)):
        f = Image.fromarray(rs.randint(0, 256, grid + (3,), dtype=np.uint8))
        out += amp * (np.asarray(f.resize((w, h), Image.BILINEAR), np.float32) - 128)
    out = out / 4.0 + 128 + rs.randint(-32, 33, (h, w, 3))
    Image.fromarray(np.clip(out, 0, 255).astype(np.uint8)).save(path, quality=90)
    return os.path.getsize(path)


def write_jpeg_tree(root: str) -> tuple[int, int]:
    """``root/{train,val}/n0000000<c>/*.JPEG``, image k from seed k, written
    by a thread pool (PIL's resize and encode release the interpreter
    lock). Returns (files, bytes)."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = []
    for split, n in (("train", IMAGENET_TRAIN), ("val", IMAGENET_VAL)):
        for c in range(IMAGENET_CLASSES):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            jobs += [os.path.join(d, f"{split}_{i:04d}.JPEG") for i in range(n)]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        sizes = list(pool.map(_smooth_jpeg, jobs, range(len(jobs))))
    return len(sizes), sum(sizes)


def _loader_rate(data, ds, kind: str, workers: int):
    """img/s of ``DataLoader(ds, 64, worker_type=kind)`` (no device) over
    its second epoch, from the epoch's start to its last batch (the first
    epoch warms up; its first batch's wait, a process pool's spawn
    included, is returned apart); for the process kind also the
    consumer's time per batch when the batch is already waiting in a pipe
    (the receive and unpickle of 38.5 MB)."""
    sampler = data.DistributedSampler(len(ds), 1, 0, shuffle=True, seed=0)
    loader = data.DataLoader(ds, BATCH, sampler=sampler, num_workers=workers,
                             drop_last=True, worker_type=kind)
    try:
        t0 = time.perf_counter()
        it = iter(loader)
        next(it)
        first = time.perf_counter() - t0
        for _ in it:
            pass
        sampler.set_epoch(1)
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        rate = BATCH * n / (time.perf_counter() - t0)
        receive = []
        if kind == "process":
            # let the workers fill their pipes, then time the consumer alone
            sampler.set_epoch(2)
            it = iter(loader)
            next(it)
            waiting = min(len(loader) - 1, workers * loader.prefetch_batches)
            deadline = time.monotonic() + 60
            queues = loader._pool["out_queues"]
            while (sum(q.qsize() for q in queues) < waiting
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            for _ in range(waiting):
                t0 = time.perf_counter()
                next(it)
                receive.append(time.perf_counter() - t0)
            it.close()
    finally:
        loader.close()
    return rate, first, receive


def _pipeline_costs(ds, n: int = 64):
    """ms an image of each stage of ``ds``'s pipeline on one thread:
    decode, then each transform in turn, then the collate's share."""
    import numpy as np

    costs = {"decode": 0.0}
    out = []
    for path, _ in ds.samples[:n]:
        t0 = time.perf_counter()
        x = ds.loader(path)
        costs["decode"] += time.perf_counter() - t0
        for tf in ds.transform.transforms:
            t0 = time.perf_counter()
            x = tf(x)
            name = type(tf).__name__
            costs[name] = costs.get(name, 0.0) + time.perf_counter() - t0
        out.append(x)
    t0 = time.perf_counter()
    np.stack(out)
    costs["collate"] = time.perf_counter() - t0
    return {k: 1e3 * v / n for k, v in costs.items()}


def _staged_consumer_ms(data, batches):
    """The consumer thread's time per batch out of ``staged_iter`` when the
    producer has already filled the ring (the copy out of a slot); the
    batches must come out equal."""
    it = data.staged_iter(iter(batches), slots=3, slot_mb=64)
    got = [next(it)]
    time.sleep(1.0)  # the producer fills the other slots
    times = []
    for _ in range(len(batches) - 1):
        t0 = time.perf_counter()
        got.append(next(it))
        times.append(time.perf_counter() - t0)
    it.close()
    import numpy as np

    same = all(a.dtype == b.dtype and np.array_equal(a, b)
               for g, w in zip(got, batches) for a, b in zip(g, w))
    return times, same


class _Tee:
    """stdout that is also kept, to read the example's done line."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def h2d_overlap(prof):
    """(H2D copies, ms of them, their streams, the compute stream, the
    share of copy time during which the compute stream ran a kernel):
    the compute stream is the one with the most kernel time."""
    from torch.autograd import DeviceType

    kernels, copies = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "HtoD" in e.name:
            copies.append((e.device_resource_id, span))
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.setdefault(e.device_resource_id, []).append(span)
    if not kernels or not copies:
        return len(copies), 0.0, set(), None, 0.0
    compute = max(kernels, key=lambda s_: sum(e - b for b, e in kernels[s_]))
    busy = merged(kernels[compute])
    total = sum(e - b for _, (b, e) in copies)
    over = sum(max(0, min(e, be) - max(b, bb))
               for _, (b, e) in copies for bb, be in busy)
    return (len(copies), total / 1e3, {s_ for s_, _ in copies}, compute,
            over / total if total else 0.0)


def _example_in_process(torch, tree):
    """``imagenet_resnet50.main`` under kernel mode "on", with its train
    steps and evals wrapped: BN launches counted apart for the evals, the
    first staged batches kept on the card (and their host arrays), and a
    2-step profiler window. Returns (summary, done line, train launches,
    eval launches, kept batches, host batches, profile, its wall
    seconds)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_syncbn_torch import data, imagenet_resnet50, parallel
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T

    DP = parallel.DataParallel
    orig_train, orig_eval, orig_prefetch = DP.train_step, DP.eval_step, data.device_prefetch
    kept, host, eval_launches = [], [], dict.fromkeys(T.LAUNCHES, 0)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    calls, window = [0], [0.0]

    def train_step(self, batch):
        i = calls[0]
        calls[0] += 1
        if i < STAGED_CHECKED:
            kept.append(batch)  # held: the allocator cannot reuse it
        if i == PROFILED_STEP:
            torch.cuda.synchronize()
            prof.start()
            window[0] = time.perf_counter()
        out = orig_train(self, batch)
        if i == PROFILED_STEP + 1:
            torch.cuda.synchronize()
            window[0] = time.perf_counter() - window[0]
            prof.stop()
        return out

    def eval_step(self, batch):
        before = T.launch_counts()
        out = orig_eval(self, batch)
        for k, n in T.launch_counts().items():
            eval_launches[k] += n - before[k]
        return out

    def device_prefetch(iterator, **kw):
        first = not host and not kept

        def tee(it):
            for b in it:
                if first and len(host) < STAGED_CHECKED:
                    host.append(b)
                yield b

        return orig_prefetch(tee(iterator), **kw)

    tee_out = _Tee(sys.stdout)
    DP.train_step, DP.eval_step, data.device_prefetch = train_step, eval_step, device_prefetch
    try:
        with bn_ops.kernel_mode("on"), contextlib.redirect_stdout(tee_out):
            T.reset_launch_counts()  # the real-data path: counts from 0
            summary = imagenet_resnet50.main([
                "--data-root", tree, "--epochs", "1", "--batch-size", str(BATCH),
                "--image-size", str(IMAGE_SIZE), "--dtype", "bf16",
                "--num-classes", str(IMAGENET_CLASSES), "--eval-every", "1"])
            total = T.launch_counts()
    finally:
        DP.train_step, DP.eval_step, data.device_prefetch = orig_train, orig_eval, orig_prefetch
    done = [ln for ln in "".join(tee_out.lines).splitlines() if ln.startswith("done:")]
    train_launches = {k: total[k] - eval_launches[k] for k in total}
    return summary, done, train_launches, eval_launches, kept, host, prof, window[0]


#: the launcher run's tree, a class: one training batch of 64 and one eval
#: batch over the 4 classes (the loader alone and the in-process example
#: read the whole tree)
LAUNCHER_TRAIN, LAUNCHER_VAL = 16, 4


def launcher_tree(tree: str, root: str) -> int:
    """``root`` as a copy of the first ``LAUNCHER_TRAIN`` / ``LAUNCHER_VAL``
    images of each class of ``tree``. Returns the files."""
    import shutil

    n_files = 0
    for split, n in (("train", LAUNCHER_TRAIN), ("val", LAUNCHER_VAL)):
        for c in sorted(os.listdir(os.path.join(tree, split))):
            os.makedirs(os.path.join(root, split, c))
            for f in sorted(os.listdir(os.path.join(tree, split, c)))[:n]:
                shutil.copyfile(os.path.join(tree, split, c, f), os.path.join(root, split, c, f))
                n_files += 1
    return n_files


def _example_launcher_command(tree: str) -> list:
    """``python -m tpu_syncbn_torch.launch --nproc-per-node 1
    tpu_syncbn_torch/imagenet_resnet50.py`` with process workers."""
    return [sys.executable, "-m", "tpu_syncbn_torch.launch", "--nproc-per-node", "1",
            os.path.join("tpu_syncbn_torch", "imagenet_resnet50.py"), "--",
            "--data-root", tree, "--worker-type", "process", "--epochs", "1",
            "--batch-size", str(BATCH), "--image-size", str(IMAGE_SIZE),
            "--dtype", "bf16", "--eval-every", "1"]


def phase_imagenet(torch, card, slice_med):
    """The real-image path: a JPEG tree, the loader alone, the ported
    ImageNet example in process with the BN kernels, and the example under
    the launcher with process workers. Returns the failures."""
    import tempfile

    import numpy as np

    from tpu_syncbn_torch import data, imagenet_resnet50
    from tpu_syncbn_torch.runtime import native

    t_phase = time.perf_counter()
    failures = []
    if not native.available():
        fail(f"[imagenet] the native library did not build or load: "
             f"{native.load_error()}")
    log(f"[imagenet] native library loaded: "
        f"{os.path.relpath(native.library_path(native.BUILD_DIR), HERE)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_imagenet_") as tree:
        t0 = time.perf_counter()
        n_files, n_bytes = write_jpeg_tree(tree)
        log(f"[imagenet] JPEG tree: {n_files} files ({IMAGENET_CLASSES} classes x "
            f"{IMAGENET_TRAIN} train + {IMAGENET_VAL} val), {n_bytes / 2**20:.1f} MiB, "
            f"mean {n_bytes / n_files / 1024:.1f} KiB a file, written in "
            f"{time.perf_counter() - t0:.1f}s; host CPUs {os.cpu_count()}")

        # the loader alone: the train pipeline at 224², no device
        train_ds, _ = imagenet_resnet50.make_imagefolder_datasets(tree, IMAGE_SIZE)
        costs = _pipeline_costs(train_ds)
        log(f"[imagenet] one thread, ms an image: " + ", ".join(
            f"{k} {v:.3f}" for k, v in costs.items())
            + f"; total {sum(costs.values()):.3f} [{card}]")
        rates = {}
        for kind, workers in (("thread", LOADER_WORKERS), ("process", LOADER_WORKERS)):
            rate, first, receive = _loader_rate(data, train_ds, kind, workers)
            rates[kind] = rate
            extra = ""
            if receive:
                extra = (f"; consumer's receive of a waiting batch "
                         f"({BATCH * IMAGE_SIZE ** 2 * 3 * 4 / 1e6:.1f} MB) median "
                         f"{1e3 * statistics.median(receive):.2f}ms over {len(receive)}")
            log(f"[imagenet] loader {kind} x{workers}: {rate:.1f} img/s over an "
                f"epoch of {IMAGENET_TRAIN * IMAGENET_CLASSES} images (the first "
                f"epoch's first batch after {first:.2f}s){extra} [{card}]")
        best = max(rates, key=rates.get)
        if os.cpu_count() == LOADER_WORKERS:
            log(f"[imagenet] loader {best} x{os.cpu_count()} (os.cpu_count()): "
                f"the {best} run above")
        else:
            rate, first, _ = _loader_rate(data, train_ds, best, os.cpu_count())
            log(f"[imagenet] loader {best} x{os.cpu_count()} (os.cpu_count()): "
                f"{rate:.1f} img/s over an epoch (the first epoch's first batch "
                f"after {first:.2f}s) [{card}]")

        # the staging ring on real batches: a pass, and its consumer cost
        batches = list(data.DataLoader(train_ds, BATCH, num_workers=LOADER_WORKERS,
                                       drop_last=True))[:6]
        times, same = _staged_consumer_ms(data, batches)
        log(f"[imagenet] staged_iter over the native ring: {len(batches)} batches "
            f"equal: {same}; consumer's time a batch median "
            f"{1e3 * statistics.median(times):.2f}ms [{card}]")
        if not same:
            failures.append("[imagenet] staged_iter changed a batch")
        del batches

        # the example in process, with the BN kernels
        t0 = time.perf_counter()
        summary, done, launches, eval_launches, kept, host, prof, window = \
            _example_in_process(torch, tree)
        secs = time.perf_counter() - t0
        steps = summary["steps"]
        log(f"[imagenet] example in process: {steps} steps in {secs:.1f}s; "
            f"{done[-1] if done else 'no done: line'}")
        log(f"[imagenet] BN kernels over the train steps {json.dumps(launches)}; "
            f"in the eval {json.dumps(eval_launches)}")
        if any(n != BN_LAYERS * steps for n in launches.values()) or steps < 1:
            failures.append(f"[imagenet] a BN kernel did not launch {BN_LAYERS} x "
                            f"{steps} times over the train steps: {launches}")
        if not math.isfinite(summary["loss"]):
            failures.append(f"[imagenet] non-finite loss {summary['loss']}")
        if not done or "val top1" not in done[-1] or not math.isfinite(summary["final_top1"]):
            failures.append("[imagenet] no done: line with a val top1")
        exact = len(kept) == len(host) == STAGED_CHECKED and all(
            torch.equal(d_.cpu(), torch.from_numpy(h_))
            for kb, hb in zip(kept, host) for d_, h_ in zip(kb, hb))
        on_card = all(t.is_cuda for kb in kept for t in kb)
        log(f"[imagenet] first {STAGED_CHECKED} staged batches read back from the "
            f"card equal their host arrays: {exact} (on the card: {on_card})")
        if not (exact and on_card):
            failures.append("[imagenet] a staged batch differs from its host arrays")
        del kept, host

        step_s, wait_s = summary["step_s"], summary["data_wait_s"]
        steady = [i for i in range(1, steps)
                  if i not in (PROFILED_STEP, PROFILED_STEP + 1)]
        it_med = statistics.median(step_s[i] for i in steady)
        wait_med = statistics.median(wait_s[i] for i in steady)
        comp_med = statistics.median(step_s[i] - wait_s[i] for i in steady)
        log(f"[imagenet] real-data step (next batch + step) median {1e3 * it_med:.2f}ms "
            f"= {BATCH / it_med:.1f} img/s over {len(steady)} steady steps; data_wait "
            f"median {1e3 * wait_med:.2f}ms; step without the wait {1e3 * comp_med:.2f}ms; "
            f"the synthetic slice's step this run {1e3 * slice_med:.2f}ms = "
            f"{BATCH / slice_med:.1f} img/s [{card}]")
        acts = device_intervals(prof)
        window *= 1e3
        busy = sum(e - s_ for s_, e in merged([(a[1], a[2]) for a in acts])) / 1e3
        n_h2d, h2d_ms, h2d_streams, compute, overlap = h2d_overlap(prof)
        side = bool(h2d_streams) and compute not in h2d_streams
        log(f"[imagenet-profile] 2 steps (steps {PROFILED_STEP + 1}-{PROFILED_STEP + 2}): "
            f"device busy {busy:.1f}ms of {window:.1f}ms "
            f"({100 * busy / window:.1f}%); {n_h2d} H2D copies, {h2d_ms:.2f}ms, on "
            f"stream(s) {sorted(h2d_streams)}, compute on stream {compute}: side "
            f"stream {side}; {100 * overlap:.1f}% of the copy time overlapped "
            f"compute-stream kernels [{card}]")
        if n_h2d and not side:
            failures.append("[imagenet] the H2D copies ran on the compute stream")

        # the example under the launcher, side by side with [groups]' two
        # launcher checks: each only has to reach its end
        small = os.path.join(tree, "launcher")
        n_small = launcher_tree(tree, small)
        n_cards = torch.cuda.device_count()
        t0 = time.perf_counter()
        res = _side_by_side({**_launcher_commands(n_cards),
                             "example": _example_launcher_command(small)})
        secs = time.perf_counter() - t0
        failures += _launcher_gates(res, n_cards)
        r = res["example"]
        done = [ln for ln in r.stdout.splitlines() if ln.startswith("done:")]
        log(f"[imagenet] launcher --nproc-per-node 1 imagenet_resnet50.py "
            f"--worker-type process on {n_small} files of the tree: exit {r.returncode}; "
            f"{done[-1] if done else 'no done: line'}")
        log(f"[imagenet] the three launcher runs side by side took {secs:.1f}s")
        if r.returncode != 0 or not done:
            failures.append("[imagenet] the launcher did not run the example: "
                            + (r.stdout + r.stderr)[-2000:])
    log(f"[imagenet] phase done in {time.perf_counter() - t_phase:.1f}s, "
        f"{len(failures)} failures")
    return failures


# -- phase 8: trainer — accum_steps, remat, the guard, checkpoints ----------

# The rest of the trainer on [slice]'s model and batch (ResNet-50 SyncBN,
# bf16, 64 images at 224x224, world 1) with the example's optimizer (SGD
# Nesterov, weight decay, per-step cosine schedule owned by the trainer);
# the batches are made on the card from a seed. Every BN launch of the
# checked steps is held against its plain version (checking_every_call);
# the timed steps after them run the same path unchecked.
ACCUM, TRAINER_STEPS = 2, 3
# remat recomputes the same forward with the same kernels, so its loss and
# running statistics equal the plain step's up to bf16 rounding (2^-8);
# its update differs from the plain step's only by the backward's own
# run-to-run rounding, so its limit is 5x that floor, measured in the same
# run by repeating the plain step, and at least 2^-8. The recomputation
# runs in autograd's device thread, and PyTorch keeps cuDNN's convolution
# plans per thread (looked up before the benchmark flag is read): where the
# calling thread autotuned a shape and the device thread did not, the two
# passes convolve with other algorithms, and that bf16 rounding, amplified
# through 53 BN layers at initialization, moves the early layers' gradients
# by about their norm (shown below, not gated; PERF.md, Findings). So the
# checked steps run in a fresh thread with the autotuner off: both passes
# then take cuDNN's heuristic plans (no earlier phase recomputes a forward).
# A recomputation that wrote the running stats again, or normalized with
# other statistics, moves them by O(1).
REMAT_TOL, REMAT_FLOOR_FACTOR = 2 ** -8, 5.0


def _nbt(model) -> int:
    """``num_batches_tracked`` of the first BN layer (all move alike)."""
    from tpu_syncbn_torch.nn import BatchNorm

    return next(int(m.num_batches_tracked) for m in model.modules()
                if isinstance(m, BatchNorm))


def _trainer_batch(torch, seed: int, nan_image: int | None = None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(BATCH, IMAGE_SIZE, IMAGE_SIZE, 3, device="cuda", generator=g)
    y = torch.randint(0, 1000, (BATCH,), device="cuda", generator=g)
    if nan_image is not None:
        x[nan_image] = float("nan")
    return x, y


def _resnet_trainer(torch, decay_steps: int = 100, **kw):
    """A ResNet-50 SyncBN trainer from seed-0 weights with the ImageNet
    example's optimizer and its schedule (owned by the trainer)."""
    from tpu_syncbn_torch import imagenet_resnet50, models, nn, parallel

    model = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(0)))
    opt, sched = imagenet_resnet50.make_optimizer(model, 0.1, decay_steps)
    return model, parallel.DataParallel(model, opt, _loss_fn, device="cuda",
                                        lr_scheduler=sched, **kw)


def _timed_step(torch, dp, batch):
    """(ms between CUDA events around one step, peak bytes allocated
    during it above the bytes allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    dp.train_step(batch)
    b.record()
    b.synchronize()
    return a.elapsed_time(b), torch.cuda.max_memory_allocated() - base


def _held(tag: str, seen: dict, launches: dict, failures: list) -> None:
    """Every launch was held against its plain version, within tolerance."""
    worst = {k: round(seen.get(k, (0, 0.0, 0.0))[1], 3) for k in MOVES}
    log(f"[trainer] {tag}: per-call kernel/plain worst ratio to tol {json.dumps(worst)}")
    for k in MOVES:
        calls, ratio, _ = seen.get(k, (0, 0.0, 0.0))
        if calls != launches[k] or ratio > 1.0:
            failures.append(f"[trainer] {tag}: {k} {calls} of {launches[k]} "
                            f"launches checked, worst {ratio:.2f} of tol")


def _trainer_accum(torch, T, batches, card, failures):
    model, dp = _resnet_trainer(torch, accum_steps=ACCUM)
    nbt0, seen = _nbt(model), {}
    T.reset_launch_counts()  # this path: counts from 0
    with checking_every_call(torch, T, seen):
        losses = [float(dp.train_step(b).loss) for b in batches]
    launches = T.launch_counts()
    want, nbt = BN_LAYERS * ACCUM * len(batches), _nbt(model) - nbt0
    log(f"[trainer] accum {ACCUM}: {len(batches)} steps, losses "
        f"{[round(v, 4) for v in losses]}, BN kernels {json.dumps(launches)} "
        f"(want {want} each), num_batches_tracked +{nbt} "
        f"(want {ACCUM * len(batches)})")
    _held(f"accum {ACCUM}", seen, launches, failures)
    if any(n != want for n in launches.values()):
        failures.append(f"[trainer] accum: BN launches {launches}, want {want}")
    if nbt != ACCUM * len(batches):
        failures.append(f"[trainer] accum: num_batches_tracked +{nbt}")
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"[trainer] accum: non-finite loss {losses}")
    times = {1: [], ACCUM: []}
    for acc in (1, ACCUM, ACCUM, 1):  # in turns, on the same trainer
        dp.accum_steps = acc
        times[acc] += [_timed_step(torch, dp, b)[0] for b in batches[:2]]
    log(f"[trainer] accum step time (CUDA events, median of 4 unchecked "
        f"steps): accum_steps=1 {statistics.median(times[1]):.2f} ms, "
        f"accum_steps={ACCUM} {statistics.median(times[ACCUM]):.2f} ms "
        f"{json.dumps({k: [round(t, 2) for t in v] for k, v in times.items()})} [{card}]")


def _rel(torch, a: dict, b: dict) -> float:
    """|a - b| / |b| over every tensor of two name->tensor dicts (L2)."""
    num = sum(float((a[k].double() - b[k].double()).norm()) ** 2 for k in b)
    den = sum(float(b[k].double().norm()) ** 2 for k in b)
    return math.sqrt(num / den)


def _in_fresh_thread(fn):
    """``fn()`` run in a new thread (its own cuDNN plan cache); its result,
    or its exception raised here."""
    import threading

    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised in the caller below
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


def _trainer_remat(torch, T, batch, card, failures):
    model, dp = _resnet_trainer(torch)
    start = dp.state_dict()
    seen, total = {}, dict.fromkeys(T.LAUNCHES, 0)

    def step(remat):
        dp.load_state_dict(start)
        dp.remat = remat
        nbt0 = _nbt(model)
        T.reset_launch_counts()  # this path: counts from 0
        with checking_every_call(torch, T, seen):
            loss = float(dp.train_step(batch).loss)
        launches = T.launch_counts()
        for k, n in launches.items():
            total[k] += n
        after = dp.state_dict()
        delta = {k: after["params"][k] - start["params"][k] for k in start["params"]}
        return loss, after["rest"], delta, launches, _nbt(model) - nbt0

    def checked_steps():
        return (step(False), step(False),  # the plain step again: the floor
                step(True))

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        (l_p, rest_p, d_p, _, _), (_, _, d_p2, _, _), \
            (l_r, rest_r, d_r, launches, nbt) = _in_fresh_thread(checked_steps)
    finally:
        torch.backends.cudnn.benchmark = bench
    # shown, not gated: the same pair in this thread, with the autotuner on
    _, _, d_pb, _, _ = step(False)
    _, _, d_rb, _, _ = step(True)
    loss_err = abs(l_r - l_p) / abs(l_p)
    stat_err = max(float((rest_r[k] - rest_p[k]).abs().max())
                   / (float(rest_p[k].abs().max()) + 1e-6)
                   for k in rest_p if k.endswith(("running_mean", "running_var")))
    floor = _rel(torch, d_p2, d_p)
    upd_err = _rel(torch, d_r, d_p)
    upd_tol = max(REMAT_FLOOR_FACTOR * floor, REMAT_TOL)
    want = {"bn_stats": 2 * BN_LAYERS, "bn_normalize": 2 * BN_LAYERS,
            "bn_backward_reduce": BN_LAYERS, "bn_backward_elemt": BN_LAYERS}
    log(f"[trainer] remat (fresh thread, cudnn.benchmark off): loss {l_r:.6f} vs {l_p:.6f} rel_err {loss_err:.2e} "
        f"(tol {REMAT_TOL:.2e}); running stats max rel_err {stat_err:.2e} (tol "
        f"{REMAT_TOL:.2e}); update rel_err {upd_err:.3e} (floor {floor:.3e}, "
        f"tol {upd_tol:.3e}); num_batches_tracked +{nbt}; BN kernels "
        f"{json.dumps(launches)} (want {json.dumps(want)})")
    log(f"[trainer] remat in the autotuned thread (shown, not gated): update "
        f"rel_err {_rel(torch, d_rb, d_pb):.3e} against the plain step")
    _held("remat (the five steps)", seen, total, failures)
    if launches != want:
        failures.append(f"[trainer] remat: BN launches {launches}, want {want}")
    if nbt != 1:
        failures.append(f"[trainer] remat: num_batches_tracked +{nbt}, want +1")
    if not (loss_err <= REMAT_TOL and stat_err <= REMAT_TOL and upd_err <= upd_tol):
        failures.append("[trainer] remat and the plain step disagree")
    # peak memory and step time both ways, unchecked, in turns
    got = {False: [], True: []}
    for remat in (False, True, True, False):
        dp.load_state_dict(start)
        dp.remat = remat
        got[remat].append(_timed_step(torch, dp, batch))
    for remat in (False, True):
        log(f"[trainer] remat={remat}: step {statistics.median(t for t, _ in got[remat]):.2f} ms "
            f"(CUDA events), peak above the step's start "
            f"{max(m for _, m in got[remat]) / 2**30:.3f} GiB "
            f"{json.dumps([[round(t, 2), m] for t, m in got[remat]])} [{card}]")


def _state_leaves(tree) -> list:
    """``(path, leaf)`` of a trainer state, in a fixed order."""
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    return ckpt._leaves(tree)


def _same_leaf(torch, a, b) -> bool:
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _trainer_guard(torch, T, batches, card, failures):
    """The guard's exact skip; returns the trainer (the checkpoint timings
    use its state: the example's optimizer, schedule and guard)."""
    from tpu_syncbn_torch import parallel

    model, dp = _resnet_trainer(torch, divergence_guard="skip_step")
    poisoned = _trainer_batch(torch, 7, nan_image=0)
    seen = {}
    T.reset_launch_counts()  # this path: counts from 0
    with checking_every_call(torch, T, seen):
        dp.train_step(batches[0])
        before = dp.state_dict()
        out = dp.train_step(poisoned)
        nonfinite = float(out.metrics["nonfinite"])
        after = dp.state_dict()
        halve = parallel.DataParallel(model, dp.optimizer, _loss_fn, device="cuda",
                                      divergence_guard="halve_lr",
                                      lr_scheduler=dp.lr_scheduler)
        halve.train_step(poisoned)
    launches = T.launch_counts()
    bad = [p for (p, a), (_, b) in zip(_state_leaves(before), _state_leaves(after))
           if not _same_leaf(torch, a, b) and not p.startswith("/opt_state/guard")]
    moms = sum("momentum_buffer" in p for p, _ in _state_leaves(before))
    sched_steps = (before["opt_state"]["lr_scheduler"]["last_epoch"],
                   after["opt_state"]["lr_scheduler"]["last_epoch"])
    log(f"[trainer] guard skip_step, NaN in image 0 of step 2: nonfinite "
        f"{nonfinite}, {len(_state_leaves(before))} state leaves ({moms} momentum "
        f"buffers) bitwise unchanged but {bad[:4]}; scheduler step "
        f"{sched_steps[0]} -> {sched_steps[1]}; guard {dp.guard_state}; halve_lr "
        f"guard {halve.guard_state}; BN kernels {json.dumps(launches)}")
    _held("guard", seen, launches, failures)
    if bad or nonfinite != 1.0 or sched_steps[0] != sched_steps[1] or moms != 161:
        failures.append(f"[trainer] guard: the skipped step moved {bad[:4]} "
                        f"(nonfinite {nonfinite}, scheduler {sched_steps})")
    if halve.guard_state["lr_scale"] != 0.5:
        failures.append(f"[trainer] guard: halve_lr gave {halve.guard_state}")
    if any(n != 3 * BN_LAYERS for n in launches.values()):
        failures.append(f"[trainer] guard: BN launches {launches}")
    # the guard's cost a step: finite steps with and without it, in turns,
    # host clock around a step and the read of its loss
    plain = parallel.DataParallel(model, dp.optimizer, _loss_fn, device="cuda",
                                  lr_scheduler=dp.lr_scheduler)
    times = {"off": [], "skip_step": []}
    for name in ("off", "skip_step", "skip_step", "off"):
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float((plain if name == "off" else dp).train_step(b).loss)
            times[name].append((time.perf_counter() - t0) * 1e3)
    log(f"[trainer] guard cost: step (host clock) off "
        f"{statistics.median(times['off']):.2f} ms, skip_step "
        f"{statistics.median(times['skip_step']):.2f} ms "
        f"{json.dumps({k: [round(t, 2) for t in v] for k, v in times.items()})} [{card}]")
    return dp


def _trainer_checkpoint(torch, T, dp, card, failures):
    """Certified saves, verified resume and the async writer: timed on the
    guard's trainer, then the ported example run to 2 epochs with
    checkpoints and resumed to 3."""
    import tempfile

    from tpu_syncbn_torch import imagenet_resnet50, parallel, utils
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = dp.state_dict()
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        utils.save_checkpoint(os.path.join(d, "sync"), 1, tree)
        sync_s = time.perf_counter() - t0
        mb = utils.read_manifest(os.path.join(d, "sync"), 1)["nbytes"] / 2**20
        with utils.AsyncCheckpointer() as ac:
            t0 = time.perf_counter()
            ac.save(os.path.join(d, "async"), 1, tree)
            snap_s = time.perf_counter() - t0
            ac.flush()
            write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, _ = utils.load_checkpoint(os.path.join(d, "sync"), tree)
        dp.load_state_dict(state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = utils.verified_steps(os.path.join(d, "async")) == [1] and \
            _read_bytes(ckpt._path(os.path.join(d, "async"), 1)) == \
            _read_bytes(ckpt._path(os.path.join(d, "sync"), 1))
        log(f"[trainer] checkpoint of the ResNet-50 trainer: payload {mb:.1f} MB "
            f"(MiB); state_dict copy {copy_s:.3f} s; synchronous save {sync_s:.3f} s; "
            f"async snapshot {snap_s:.3f} s (what the loop pays), write done "
            f"{write_s:.3f} s after it; load + load_state_dict {load_s:.3f} s; "
            f"async payload equal to the synchronous one: {same} [{card}]")
        if not same:
            failures.append("[trainer] the async checkpoint differs from the sync one")

        # the ported example: 2 epochs with checkpoints, then resumed to 3
        ex = os.path.join(d, "example")
        saved, loaded, evals = {}, {}, dict.fromkeys(T.LAUNCHES, 0)
        AC, DP = utils.AsyncCheckpointer, parallel.DataParallel
        orig = (AC.save, DP.load_state_dict, DP.eval_step)

        def save(self, directory, step, tree, **kw):
            saved[step] = ckpt.snapshot_to_host(tree)
            return orig[0](self, directory, step, tree, **kw)

        def load_state_dict(self, state):
            orig[1](self, state)
            loaded["state"] = ckpt.snapshot_to_host(self.state_dict())

        def eval_step(self, batch):
            before = T.launch_counts()
            out = orig[2](self, batch)
            for k, n in T.launch_counts().items():
                evals[k] += n - before[k]
            return out

        argv = ["--ckpt-dir", ex, "--async-ckpt", "--accum-steps", str(ACCUM),
                "--divergence-guard", "skip_step", "--dataset-size", str(2 * BATCH),
                "--batch-size", str(BATCH), "--image-size", str(IMAGE_SIZE),
                "--dtype", "bf16"]
        seen = {}
        AC.save, DP.load_state_dict, DP.eval_step = save, load_state_dict, eval_step
        try:
            T.reset_launch_counts()  # this path: counts from 0
            with checking_every_call(torch, T, seen):
                first = imagenet_resnet50.main(["--epochs", "2"] + argv)
                second = imagenet_resnet50.main(["--epochs", "3", "--resume"] + argv)
            launches = T.launch_counts()
        finally:
            AC.save, DP.load_state_dict, DP.eval_step = orig
        steps = len(first["step_s"]) + len(second["step_s"])
        train = {k: launches[k] - evals[k] for k in launches}
        diff = [p for (p, a), (q, b) in zip(_state_leaves(saved.get(2, {})),
                                            _state_leaves(loaded.get("state", {})))
                if p != q or not _same_leaf(torch, a, b)]
        if len(_state_leaves(saved.get(2, {}))) != len(_state_leaves(loaded.get("state", {}))):
            diff.append("the number of leaves")
        n_leaves = len(_state_leaves(saved.get(2, {})))
        newest = ckpt.available_steps(ex)
        with open(ckpt._path(ex, newest[-1]), "r+b") as f:
            f.truncate(os.path.getsize(ckpt._path(ex, newest[-1])) // 2)
        _, fell_back = utils.load_checkpoint(ex, None)
        log(f"[trainer] example --epochs 2 {' '.join(argv[2:])}: {first['steps']} "
            f"steps, loss {first['loss']:.4f}; --resume --epochs 3: start epoch "
            f"{second['start_epoch']}, {second['steps']} steps in all, loss "
            f"{second['loss']:.4f}; checkpoints {newest}; state after load vs "
            f"saved at epoch 2: {n_leaves - len(diff)} of {n_leaves} leaves "
            f"bitwise equal; newest truncated -> load_checkpoint restores step "
            f"{fell_back}; BN kernels over {steps} train steps {json.dumps(train)}, "
            f"in the evals {json.dumps(evals)}")
        _held("example", seen, launches, failures)
        if second["start_epoch"] != 2 or diff or not n_leaves or newest != [1, 2, 3] \
                or fell_back != 2 or not (math.isfinite(first["loss"])
                                          and math.isfinite(second["loss"])):
            failures.append(f"[trainer] checkpoint/resume failed: start "
                            f"{second['start_epoch']}, differing {diff[:4]}, "
                            f"steps {newest}, fallback {fell_back}")
        if any(n != BN_LAYERS * ACCUM * steps for n in train.values()) or steps != 6:
            failures.append(f"[trainer] example: BN launches {train} over {steps} steps")


def phase_trainer(torch, card):
    """accum_steps, remat, the divergence guard and checkpoints on the
    ResNet-50 SyncBN step; returns the failures."""
    t0 = time.perf_counter()
    from tpu_syncbn_torch.ops import triton_bn as T

    failures = []
    batches = [_trainer_batch(torch, 100 + i) for i in range(TRAINER_STEPS)]
    _trainer_accum(torch, T, batches, card, failures)
    torch.cuda.empty_cache()
    _trainer_remat(torch, T, batches[0], card, failures)
    torch.cuda.empty_cache()
    dp = _trainer_guard(torch, T, batches, card, failures)
    _trainer_checkpoint(torch, T, dp, card, failures)
    del dp
    torch.cuda.empty_cache()
    log(f"[trainer] phase done in {time.perf_counter() - t0:.1f}s, "
        f"{len(failures)} failures")
    return failures


# -- phases 9-11: the GAN, RetinaNet and the bench -------------------------

# The paper's two small-batch workloads, in float32 on the BN kernels at
# shapes the ResNet slice never takes, and the port's headline bench.
GAN_ITERS, GAN_BATCH, GAN_TIMED = 20, 64, 10
GAN_FWD, GAN_BWD = 14, 10  # BN kernel launches a DCGAN/SNGAN iteration
RN_SIDE, RN_BATCH, RN_STEPS, RN_BOXES, RN_EVAL = 512, 2, 10, 32, 8
FORWARD = ("bn_stats", "bn_normalize")
AB_LOSS_TOL, AB_STAT_TOL = 1e-2, 2e-2  # the slice's A/B tolerances


def _float_buffers(*models):
    """``(name, clone)`` of every floating-point buffer (BN running
    statistics, SNConv's ``u``) of the models, in order."""
    return [(f"{i}.{n}", b.detach().clone()) for i, m in enumerate(models)
            for n, b in m.named_buffers() if b is not None and b.is_floating_point()]


def _stat_err(a, b) -> float:
    """Worst of |a − b| / max|b| over two lists of ``_float_buffers``."""
    return max(float((x - y).abs().max()) / (float(y.abs().max()) + 1e-6)
               for (_, x), (_, y) in zip(a, b))


def _ab(torch, T, bn_ops, tag, step, restore, buffers, want_calls, failures):
    """One step from the same state on the same inputs with the kernels
    ("auto", every kernel call held against its plain version) and with
    the plain versions ("off"); ``step()`` returns its losses, ``restore()``
    puts the starting state back, ``buffers()`` lists the buffers to hold
    equal. Fails on a loss or a buffer past the slice's A/B tolerances, or
    a call count other than ``want_calls``."""
    result, seen = {}, {}
    for mode in ("auto", "off"):
        restore()
        check = checking_every_call(torch, T, seen) if mode == "auto" \
            else contextlib.nullcontext()
        with bn_ops.kernel_mode(mode), check:
            losses = step()
        result[mode] = (losses, buffers())
    (l_k, b_k), (l_p, b_p) = result["auto"], result["off"]
    loss_err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(l_k, l_p))
    stat_err = _stat_err(b_k, b_p)
    worst = {k: round(seen.get(k, (0, 0.0, 0.0))[1], 3) for k in MOVES}
    log(f"[{tag}] a/b: losses kernels {[round(v, 6) for v in l_k]} plain "
        f"{[round(v, 6) for v in l_p]} rel_err {loss_err:.2e} (tol "
        f"{AB_LOSS_TOL:.0e}); {len(b_k)} buffers max rel_err {stat_err:.2e} "
        f"(tol {AB_STAT_TOL:.0e}); per-call worst ratio to tol {json.dumps(worst)}")
    if loss_err > AB_LOSS_TOL or stat_err > AB_STAT_TOL:
        failures.append(f"[{tag}] kernels and plain versions disagree "
                        f"(loss {loss_err:.2e}, buffers {stat_err:.2e})")
    for k in MOVES:
        calls, ratio, _ = seen.get(k, (0, 0.0, 0.0))
        if calls != want_calls[k] or ratio > 1.0:
            failures.append(f"[{tag}] {k}: {calls} calls checked (want "
                            f"{want_calls[k]}), worst {ratio:.2f} of tol")


def _launch_gate(tag, launches, want, failures):
    log(f"[{tag}] BN kernels {json.dumps(launches)} (want {json.dumps(want)})")
    if launches != want:
        failures.append(f"[{tag}] BN launches {launches}, want {want}")


def _is_bn_kernel(name: str) -> bool:
    return name in BN_TRITON_NAMES or any(ns in name for ns in BN_CUDA_NAMESPACES)


def _gan_arch(torch, T, bn_ops, arch, card, failures):
    """``gan_train.main`` in process at full width (f32, global batch 64,
    synthetic data) for GAN_ITERS iterations, then timed and profiled
    iterations and the one-iteration A/B on the trained trainer."""
    from tpu_syncbn_torch import gan_train, nn

    tag = f"gan/{arch}"
    T.reset_launch_counts()  # this path: counts from 0
    t0 = time.perf_counter()
    out = gan_train.main(["--arch", arch, "--iters", str(GAN_ITERS),
                          "--batch-size", str(GAN_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = T.launch_counts()
    tr, samples = out["trainer"], out["samples"]
    # the run closes with one sampling call, an eval forward of the
    # generator: one bn_normalize a generator BN layer
    g_bn = sum(isinstance(m, nn.BatchNorm) for m in tr.generator.modules())
    want = {k: (GAN_FWD if k in FORWARD else GAN_BWD) * GAN_ITERS for k in MOVES}
    want["bn_normalize"] += g_bn
    _launch_gate(tag, launches, want, failures)
    nbt = {net: sorted({int(m.num_batches_tracked) for m in model.modules()
                        if isinstance(m, nn.BatchNorm)})
           for net, model in (("G", tr.generator), ("D", tr.discriminator))}
    shapes = {net: [m.num_features for m in model.modules() if isinstance(m, nn.BatchNorm)]
              for net, model in (("G", tr.generator), ("D", tr.discriminator))}
    log(f"[{tag}] {out['iters']} iterations in {wall:.1f}s (first builds nothing "
        f"new: the kernels are built); BN layers {json.dumps(shapes)}; "
        f"num_batches_tracked {json.dumps(nbt)} (want G {[2 * GAN_ITERS]}, "
        f"D {[3 * GAN_ITERS]}); samples {tuple(samples.shape)} range "
        f"[{float(samples.min()):.4f}, {float(samples.max()):.4f}]")
    if nbt != {"G": [2 * GAN_ITERS], "D": [3 * GAN_ITERS]}:
        failures.append(f"[{tag}] num_batches_tracked {nbt}")
    if tuple(samples.shape) != (16, 32, 32, 3) or not bool(torch.isfinite(samples).all()) \
            or float(samples.abs().max()) > 1.0:
        failures.append(f"[{tag}] samples not finite in [-1, 1]")

    g = torch.Generator(device="cuda").manual_seed(11)
    real = torch.rand(GAN_BATCH, 32, 32, 3, device="cuda", generator=g) * 2 - 1
    z = torch.randn(2, GAN_BATCH, tr.generator.latent_dim, device="cuda", generator=g)

    def step():
        o = tr.train_step(real, z[0], z[1])
        return [float(o.d_loss), float(o.g_loss)]

    med = _event_ms(torch, lambda: tr.train_step(real, z[0], z[1]), 1, GAN_TIMED)
    log(f"[{tag}] iteration (D + G update) CUDA events median {med:.3f} ms over "
        f"{GAN_TIMED} = {GAN_BATCH / med * 1e3:.1f} img/s, batch {GAN_BATCH} "
        f"f32 [{card}]")
    profile_window(torch, lambda: [tr.train_step(real, z[0], z[1]) for _ in range(2)],
                   f"{tag}-profile", "BN kernels", _is_bn_kernel, card)

    saved = tr.state_dict()
    _ab(torch, T, bn_ops, tag, step, lambda: tr.load_state_dict(saved),
        lambda: _float_buffers(tr.generator, tr.discriminator),
        {k: GAN_FWD if k in FORWARD else GAN_BWD for k in MOVES}, failures)
    return launches, med


def phase_gan(torch, card):
    """DCGAN, then SNGAN (ROADMAP A.6); returns (failures, launches by
    arch, median iteration ms by arch)."""
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T

    t0 = time.perf_counter()
    failures, launches, meds = [], {}, {}
    for arch in ("dcgan", "sngan"):
        launches[arch], meds[arch] = _gan_arch(torch, T, bn_ops, arch, card, failures)
        torch.cuda.empty_cache()
    log(f"[gan] phase done in {time.perf_counter() - t0:.1f}s, "
        f"{len(failures)} failures")
    return failures, launches, meds


def phase_retinanet(torch, card):
    """RetinaNet-R50-FPN (ROADMAP A.7) at 512², 80 classes, per-GPU batch
    2, f32, Adam(1e-3) under DataParallel for RN_STEPS steps on synthetic
    detection data, then the A/B step and an mAP over RN_EVAL images."""
    from tpu_syncbn_torch import data, models, nn, parallel, retinanet_train
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T

    t0 = time.perf_counter()
    failures = []
    dev = torch.device("cuda", 0)
    model = nn.convert_sync_batchnorm(models.retinanet_r50_fpn(
        num_classes=80, image_size=(RN_SIDE, RN_SIDE), device=dev))
    n_bn = sum(isinstance(m, nn.BatchNorm) for m in model.modules())
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    dp = parallel.DataParallel(model, opt, lambda m, b: m.loss(*b), device=dev)
    ds = data.SyntheticDetectionDataset(length=RN_BATCH * (RN_STEPS + 3),
                                        image_size=(RN_SIDE, RN_SIDE),
                                        num_classes=80, max_boxes=RN_BOXES)
    sampler = data.DistributedSampler(len(ds), num_replicas=1, rank=0,
                                      shuffle=True, seed=0)
    loader = data.DataLoader(ds, batch_size=RN_BATCH, sampler=sampler,
                             num_workers=4, drop_last=True)
    batches = data.device_prefetch(iter(loader), size=2, device=dev)

    T.reset_launch_counts()  # this path: counts from 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    times, losses, peaks = [], [], []
    for _ in range(RN_STEPS):
        batch = next(batches)
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = dp.train_step(batch)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        peaks.append(torch.cuda.max_memory_allocated())
        losses.append(float(out.loss))
    launches = T.launch_counts()
    # the first step autotunes cuDNN, whose trial workspaces set its peak
    peak = max(peaks[1:])
    _launch_gate("retinanet", launches, dict.fromkeys(MOVES, BN_LAYERS * RN_STEPS),
                 failures)
    med = statistics.median(times[1:])
    log(f"[retinanet] {n_bn} BN layers; losses {[round(v, 4) for v in losses]}; "
        f"first step {times[0]:.1f} ms (cuDNN autotune), steady median {med:.2f} ms "
        f"over {RN_STEPS - 1} (CUDA events) = {RN_BATCH / med * 1e3:.1f} img/s at "
        f"batch {RN_BATCH}, {RN_SIDE}² f32; peak memory of a steady step "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
        f"start; the first step's {peaks[0] / 2**30:.3f} GiB) [{card}]")
    if n_bn != BN_LAYERS:
        failures.append(f"[retinanet] {n_bn} BN layers, want {BN_LAYERS}")
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"[retinanet] non-finite loss {losses}")

    prof_batches = [next(batches), next(batches)]
    profile_window(torch, lambda: [dp.train_step(b_) for b_ in prof_batches],
                   "retinanet-profile", "BN kernels", _is_bn_kernel, card)
    ab_batch = next(batches)
    for _ in batches:  # drain the loader so its threads finish
        pass
    state = {k: v.clone() for k, v in model.state_dict().items()}
    opt_state = copy.deepcopy(opt.state_dict())

    def restore():
        model.load_state_dict(state)
        opt.load_state_dict(copy.deepcopy(opt_state))

    _ab(torch, T, bn_ops, "retinanet", lambda: [float(dp.train_step(ab_batch).loss)],
        restore, lambda: _float_buffers(model), dict.fromkeys(MOVES, BN_LAYERS), failures)

    t1 = time.perf_counter()
    ap = retinanet_train.evaluate(model, ds, RN_EVAL, 80, 100)
    log(f"[retinanet] eval over {RN_EVAL} images (decode, batched_nms, "
        f"evaluate_detections) in {time.perf_counter() - t1:.1f}s: mAP "
        f"{ap['mAP']:.4f} AP50 {ap['AP50']:.4f} AP75 {ap['AP75']:.4f}")
    if not 0.0 <= ap["mAP"] <= 1.0:
        failures.append(f"[retinanet] mAP {ap['mAP']} outside [0, 1]")
    del dp, model, opt
    torch.cuda.empty_cache()
    log(f"[retinanet] phase done in {time.perf_counter() - t0:.1f}s, "
        f"{len(failures)} failures")
    return failures, launches, med, peak


BENCH_KEYS = ("metric", "value", "unit", "backend", "bn_backend", "chips",
              "per_chip_batch", "image_side", "steps", "compile_warmup_s", "mfu",
              "flops_per_step", "flops_source", "peak_flops", "peak_source",
              "device_kind", "host_load_1m", "collectives", "monitor", "numerics",
              "autopilot", "incident", "memory", "compile", "serve", "telemetry",
              "audit", "layout")
# the audit and layout blocks' keys (bench.py's measure_audit, measure_layout)
BENCH_AUDIT_KEYS = {"files_linted", "lint_violations", "sharding", "audit_s"}
BENCH_AUDIT_SHARDING_KEYS = {"collectives_explained", "implicit_reshards",
                             "replicated_intermediates", "max_replicated_mb",
                             "peak_mb_per_device", "peak_bytes_per_device", "xla_peak_bytes"}
BENCH_LAYOUT_KEYS = {"dp", "dp_fsdp", "dp_fsdp_int8", "fsdp_peak_ratio", "int8_wire_ratio",
                     "layout_s"}
# the serve block's keys (bench.py's measure_serve and its sections)
BENCH_SERVE_KEYS = {"buckets", "max_batch", "max_wait_ms", "warm_compile_s", "levels",
                    "clients", "requests", "rejected", "throughput_rps", "latency_p50_ms",
                    "latency_p99_ms", "fill_ratio", "buckets_compiled", "drained",
                    "open_loop", "publish", "tenancy"}
BENCH_PUBLISH_KEYS = {"swap_s", "commit_s", "swap_outcome", "requests_during_swap",
                      "baseline_p99_ms", "p99_during_swap_ms", "p99_ratio",
                      "double_buffer_peak_bytes", "memwatch_contract_bytes",
                      "double_buffer_bounded", "rollback_s", "rollback_bit_identical"}
BENCH_OPEN_LOOP_KEYS = {"slo_ms", "deadline_ms", "levels", "offered_rps", "goodput_rps",
                        "latency_p99_ms", "deadline_miss_rate", "shed_rate", "shed",
                        "rejected", "p99_bounded", "sheds_rise", "degradation_graceful"}
BENCH_TENANCY_KEYS = {"deadline_ms", "miss_target", "burn_threshold", "tenants",
                      "aggressive_burn", "steady_burn", "isolation_ok", "alert_bundle"}


def phase_bench():
    """``python -m tpu_syncbn_torch.bench --scan 8 --serve`` in a subprocess
    (its kernels are built and cached by now): exit 0, every key of its line,
    0 < mfu <= 1, the ``recovery`` block (a truncated newest checkpoint
    resumes the older step, the async write certifies), the ``scan``
    block at K = 8, the ``monitor`` and ``numerics`` blocks (a port-0
    server's scrape and probes, one SLO evaluation; the publisher's samples
    and one forced ``numerics_drift`` bundle), the ``incident``, ``memory``
    and ``compile`` blocks (a
    forced bundle, the card's reading against the audited peak of the
    benched step, ``contract_source`` ``"sharding_audit"``, with its
    ``mem_pressure`` drill and a capture holding CUDA activity, the first
    step's compile event and no storm), the ``audit`` and ``layout`` blocks
    (``_bench_audit_blocks``), the ``autopilot`` block (JAX's
    validator: off int8 within 2 chunks, the A/B, one bundle an
    actuation; its arms launch the int8 kernels), the ``serve`` block (JAX's
    keys, one program a bucket, its levels printed; its ``publish`` section
    with JAX's keys, the swap ``swapped`` under load and the rollback bit
    for bit) and
    the ``telemetry`` block (the registry's schema, a ``step.time_s``
    sample a timed step). Returns (failures, the line)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "tpu_syncbn_torch.bench", "--scan",
                        str(SCAN_KS[-1]), "--serve"], cwd=HERE,
                       env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
                       text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    log(f"[bench] exit {r.returncode} in {time.perf_counter() - t0:.1f}s")
    if r.returncode != 0 or not lines:
        return [f"[bench] exit {r.returncode}: {r.stderr[-2000:]}"], None
    line = json.loads(lines[-1])
    log(f"[bench] {json.dumps(line)}")
    failures = [f"[bench] key {k} missing" for k in BENCH_KEYS if k not in line]
    mfu = line.get("mfu")
    if not (isinstance(mfu, (int, float)) and 0 < mfu <= 1):
        failures.append(f"[bench] mfu {mfu} not in (0, 1]")
    rec, scan = line.get("recovery") or {}, line.get("scan") or {}
    if rec.get("resumed_step_after_kill") != 1 or not rec.get("async_manifest_verified"):
        failures.append(f"[bench] recovery block {rec}")
    if scan.get("k") != SCAN_KS[-1] or not scan.get("img_per_sec_per_chip"):
        failures.append(f"[bench] scan block {scan}")
    # the pipeline sub-block and 1F1B's bubbles: null at world 1 ([parallel]
    # runs the block at world 4)
    if any(scan.get(k, "missing") is not None
           for k in ("pipeline", "bubble_frac_predicted", "bubble_frac_measured")):
        failures.append(f"[bench] scan block's pipeline keys {scan}")
    # the compressed wire on 1 MiB a GPU (262,144 f32): bytes and ratios
    coll = line.get("collectives") or {}
    modes = coll.get("modes") or {}
    n = 262_144
    want = {"fp32": (4 * n, 1.0), "bf16": (2 * n, 2.0), "int8": (n + 8 * 1024, 3.879),
            "shuffle_sharded": (0, None)}
    got = {m: (v.get("wire_bytes"), v.get("compression_ratio")) for m, v in modes.items()}
    if got != want or not all(isinstance(v.get("ms"), (int, float)) and v["ms"] >= 0
                              for v in modes.values()):
        failures.append(f"[bench] collectives block {coll}")
    # the obs blocks: a forced bundle; the card's reading against the
    # audited peak, the planted mem_pressure drill, a capture with CUDA
    # activity; the first step's compile event and no storm
    # the monitor block: a port-0 server's scrape and probes over the loop's
    # window, one SLO evaluation that does not fire; the numerics block: the
    # loop's publishes and one forced, valid numerics_drift bundle
    mon, num = line.get("monitor") or {}, line.get("numerics") or {}
    if not (mon.get("healthz_ok") and mon.get("readyz_ok") and mon.get("series")
            and mon.get("window_agreement") == 1.0 and mon.get("slo_firing") is False
            and isinstance(mon.get("metrics_fetch_s"), (int, float))):
        failures.append(f"[bench] monitor block {mon}")
    if not (num.get("published") == line.get("steps")
            and (num.get("drift") or {}).get("valid")
            and num.get("rules") == ["numerics_residual", "numerics_skew", "numerics_clip"]
            and isinstance(num.get("record_overhead_frac"), (int, float))):
        failures.append(f"[bench] numerics block {num}")
    # the autopilot block, as JAX's validator holds it: off int8 within one
    # window on numerics_clip, the controlled arm converging while the
    # static int8 arm ends at least 2x worse, one valid bundle an actuation
    ap = line.get("autopilot") or {}
    bundles = ap.get("bundles") or {}
    log(f"[bench] autopilot {json.dumps(ap)}")
    if not (1 <= (ap.get("escalate_within_chunks") or 0) <= 2
            and ap.get("first_signal") == "numerics_clip"
            and (ap.get("modes_visited") or [None])[0] == "int8"
            and ap.get("final_mode") in ("bf16", "none") and ap.get("actuations", 0) >= 1
            and ap.get("autopilot_final_mse", math.inf) < ap.get("initial_mse", -math.inf)
            and ap.get("advantage_ratio", 0) >= 2.0 and bundles.get("valid") is True
            and bundles.get("count") == ap.get("actuations")
            and all(x == "numerics_clip" for x in bundles.get("signals") or [None])):
        failures.append(f"[bench] autopilot block {ap}")
    inc, mem, comp = (line.get(k) or {} for k in ("incident", "memory", "compile"))
    if inc.get("trigger") != "manual" or not inc.get("bundle_bytes") \
            or inc.get("ring_steps") != line.get("steps"):
        failures.append(f"[bench] incident block {inc}")
    if (mem.get("source") != "device" or mem.get("contract_source") != "sharding_audit"
            or mem.get("used_frac") is None or not (mem.get("pressure") or {}).get("valid")
            or (mem.get("profilez") or {}).get("status") != 200
            or not (mem.get("profilez") or {}).get("device_events")):
        failures.append(f"[bench] memory block {mem}")
    if comp.get("storms") != 0 or not comp.get("events_total") \
            or "train" not in (comp.get("families") or {}):
        failures.append(f"[bench] compile block {comp}")
    failures += _bench_audit_blocks(line)
    # the serve block: JAX's keys; the publish section's swap under load and
    # its rollback; printed: the closed-loop levels, the open-loop levels
    # with their flags, the publish section
    srv = line.get("serve") or {}
    ol, ten = srv.get("open_loop") or {}, srv.get("tenancy") or {}
    pub = srv.get("publish") or {}
    if set(srv) != BENCH_SERVE_KEYS or set(ol) != BENCH_OPEN_LOOP_KEYS \
            or set(ten) != BENCH_TENANCY_KEYS or set(pub) != BENCH_PUBLISH_KEYS \
            or pub.get("swap_outcome") != "swapped" \
            or pub.get("rollback_bit_identical") is not True \
            or srv.get("buckets_compiled") != len(srv.get("buckets") or ()):
        failures.append(f"[bench] serve block {srv}")
    log(f"[bench] serve publish {json.dumps(pub)}")
    for lv in srv.get("levels") or []:
        log(f"[bench] serve closed loop {json.dumps(lv)}")
    for lv in ol.get("levels") or []:
        log(f"[bench] serve open loop {json.dumps(lv)}")
    log(f"[bench] serve open loop p99_bounded {ol.get('p99_bounded')}, sheds_rise "
        f"{ol.get('sheds_rise')}, degradation_graceful {ol.get('degradation_graceful')}; "
        f"tenancy isolation_ok {ten.get('isolation_ok')}")
    # the registry's snapshot: schema 1, one step.time_s sample a timed step
    from tpu_syncbn_torch.obs import telemetry

    try:
        tel = telemetry.validate_snapshot(line.get("telemetry"))
        timed = tel["histograms"].get("step.time_s", {}).get("count")
        if timed != line.get("steps"):
            failures.append(f"[bench] telemetry: {timed} step.time_s samples, "
                            f"{line.get('steps')} steps")
    except ValueError as e:
        failures.append(f"[bench] telemetry block: {e}")
    return failures, line


def _jax_layout_ratio() -> float | None:
    """JAX's golden DP×FSDP/DP peak ratio, read from its pinned contract
    files (data: nothing of the JAX package is imported)."""
    peaks = []
    for kind in ("dp_fsdp", "dp"):
        path = os.path.join(HERE, "tests", "contracts", f"layout.{kind}.train_step.json")
        try:
            with open(path) as f:
                peaks.append(json.load(f)["sharding"]["peak_bytes_per_device"])
        except (OSError, KeyError, ValueError):
            return None
    return peaks[0] / peaks[1]


def _bench_audit_blocks(line) -> list:
    """The bench line's ``audit`` and ``layout`` blocks: JAX's keys; the lint
    clean; layer 3 over the benched step with no implicit reshard, its peak
    the memory block's contract and at most the allocator's reading; the
    layout block's three programs at the pinned world and C.7's ratio as
    measured, beside JAX's golden one. Each block's seconds are printed."""
    failures = []
    aud, lay = line.get("audit") or {}, line.get("layout") or {}
    sh = aud.get("sharding") or {}
    mem = line.get("memory") or {}
    if set(aud) != BENCH_AUDIT_KEYS or set(sh) != BENCH_AUDIT_SHARDING_KEYS \
            or aud.get("lint_violations") != 0 or sh.get("implicit_reshards") != 0 \
            or not 0 < (sh.get("peak_bytes_per_device") or 0) <= (sh.get("xla_peak_bytes") or 0) \
            or mem.get("contract_bytes_per_device") != sh.get("peak_bytes_per_device"):
        failures.append(f"[bench] audit block {aud} (memory contract "
                        f"{mem.get('contract_bytes_per_device')})")
    if set(lay) != BENCH_LAYOUT_KEYS or any(
            (lay.get(k) or {}).get("world") != 8 for k in ("dp", "dp_fsdp", "dp_fsdp_int8")):
        failures.append(f"[bench] layout block {lay}")
    jax_ratio = _jax_layout_ratio()
    log(f"[bench] audit: {aud.get('files_linted')} files linted, "
        f"{aud.get('lint_violations')} violations; the benched step's peak "
        f"{(sh.get('peak_bytes_per_device') or 0) / 2**30:.3f} GiB, the allocator's "
        f"{(sh.get('xla_peak_bytes') or 0) / 2**30:.3f} GiB; memory contract_source "
        f"{mem.get('contract_source')}; in {aud.get('audit_s')}s")
    log(f"[bench] layout: fsdp_peak_ratio {lay.get('fsdp_peak_ratio')} (JAX's golden "
        f"{jax_ratio if jax_ratio is None else round(jax_ratio, 4)}; ROADMAP C.7), "
        f"int8_wire_ratio {lay.get('int8_wire_ratio')}, "
        + ", ".join(f"{k} {json.dumps(lay.get(k))}" for k in ("dp", "dp_fsdp", "dp_fsdp_int8"))
        + f"; in {lay.get('layout_s')}s")
    return failures


# -- phases 12-13: scan (K steps captured into one CUDA graph) and resilience

SCAN_KS = (4, 8)
SCAN_TIMED = 4  # timed chunks of each K, after the one that captures it
SCAN_STEPS = 4  # steps of each checked chunk (two chunks: the schedule)
SCAN_UPD_TOL, SCAN_FLOOR_FACTOR = 2 ** -8, 5.0  # the remat check's rule
SCAN_ROUNDING = 2 ** -24  # f32's unit roundoff (parameters and optimizer state)
SCAN_STEP_UNITS = 2.0  # one step against optimizer.step(): PERF.md §2
SCAN_DECAY = 1000  # cosine schedule length: the lr moves at every step


def _split_state(torch, tree) -> dict:
    """A trainer state (``state_dict()``) as ``{"params", "buffers",
    "moments", "counts"}`` of path -> tensor: parameters, floating
    buffers (running statistics, SNConv's u), floating optimizer state
    (momentum, Adam's moments) and the integer-valued leaves
    (``num_batches_tracked``, Adam's step counts), which must match
    exactly."""
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    out = {"params": {}, "buffers": {}, "moments": {}, "counts": {}}
    for path, leaf in ckpt._leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        if "params" in path:
            out["params"][path] = leaf
        elif not leaf.is_floating_point() or path.endswith("/step"):
            out["counts"][path] = leaf
        elif "opt_state" in path:
            out["moments"][path] = leaf
        else:
            out["buffers"][path] = leaf
    return out


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k].double() - a[k].double() for k in a}


def _scan_compare(torch, tag, start, eager, eager2, scan, l_e, l_s, failures,
                  losses_only: bool = False) -> bool:
    """K captured steps against K eager ones from ``start``: losses and
    floating buffers within the A/B limits, counts exact, and the
    parameter update and the optimizer state within the larger of 2^-8
    and 5x the eager run's own floor (``eager2``, the same K steps
    again); with ``losses_only`` the gate holds the losses and the counts
    and shows the rest. Prints whether the two are bitwise equal and
    returns it; with ``failures`` None it only prints."""
    s0, e, e2, c = (_split_state(torch, t) for t in (start, eager, eager2, scan))
    loss_err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(l_s, l_e))
    stat_err = max((float((c["buffers"][k] - e["buffers"][k]).abs().max())
                    / (float(e["buffers"][k].abs().max()) + 1e-6)
                    for k in e["buffers"]), default=0.0)
    upd_want = _delta(s0["params"], e["params"])
    upd_floor = _rel(torch, _delta(s0["params"], e2["params"]), upd_want)
    upd_err = _rel(torch, _delta(s0["params"], c["params"]), upd_want)
    mom_floor = _rel(torch, e2["moments"], e["moments"]) if e["moments"] else 0.0
    mom_err = _rel(torch, c["moments"], e["moments"]) if e["moments"] else 0.0
    upd_tol = max(SCAN_FLOOR_FACTOR * upd_floor, SCAN_UPD_TOL)
    mom_tol = max(SCAN_FLOOR_FACTOR * mom_floor, SCAN_UPD_TOL)
    counts_ok = all(torch.equal(c["counts"][k].cpu(), e["counts"][k].cpu())
                    for k in e["counts"])
    bitwise = counts_ok and list(l_s) == list(l_e) and all(
        torch.equal(c[part][k], e[part][k]) for part in ("params", "buffers", "moments")
        for k in e[part])
    ok = loss_err <= AB_LOSS_TOL and counts_ok and (losses_only or (
        stat_err <= AB_STAT_TOL and upd_err <= upd_tol and mom_err <= mom_tol))
    verdict = ("shown, not gated" if failures is None else
               ("ok" if ok else "FAIL") + ("; losses and counts gated, the rest "
                                           "shown" if losses_only else ""))
    log(f"[{tag}] {len(l_e)} steps: losses {[round(v, 5) for v in l_s]} vs "
        f"{[round(v, 5) for v in l_e]} rel_err {loss_err:.2e} (tol {AB_LOSS_TOL:.0e}); "
        f"buffers max rel_err {stat_err:.2e} (tol {AB_STAT_TOL:.0e}); update rel_err "
        f"{upd_err:.3e} (eager floor {upd_floor:.3e}, tol {upd_tol:.3e}); optimizer "
        f"state rel_err {mom_err:.3e} (floor {mom_floor:.3e}, tol {mom_tol:.3e}); "
        f"{len(e['counts'])} counts exact: {counts_ok}; bitwise equal: {bitwise} "
        f"({verdict})")
    if failures is not None and not ok:
        failures.append(f"[{tag}] captured and eager steps disagree")
    return bitwise


def _rounding_units(a: dict, b: dict) -> float:
    """|a - b| / (2^-24 |b|), L2 over every tensor of ``b``: the distance
    in f32 unit roundoffs of ``b``'s norm."""
    num = sum(float((a[k].double() - b[k].double()).norm()) ** 2 for k in b)
    den = sum(float(b[k].double().norm()) ** 2 for k in b)
    return 0.0 if num == 0 else math.sqrt(num) / (SCAN_ROUNDING * math.sqrt(den))


def _by_net(part: dict, skip=()) -> dict:
    """``{net: {path: tensor}}`` by a state path's first component
    (``params``, ``opt_state``; ``g_params``, ``d_opt_state``, ...),
    leaving out the paths that start with one of ``skip``."""
    out = {}
    for k, v in part.items():
        if not any(k.startswith(p) for p in skip):
            out.setdefault(k.split("/")[1], {})[k] = v
    return out


def _optimizers(tr) -> list:
    return [tr.optimizer] if hasattr(tr, "optimizer") else [o for _, _, o in tr._nets()]


def _make_capturable(torch, tr) -> bool:
    """Put every Adam of ``tr`` in torch's capturable form (step counts
    on the device), the form a chunk runs it in; False if there is
    none."""
    adams = [o for o in _optimizers(tr) if isinstance(o, torch.optim.Adam)]
    for opt in adams:
        for g in opt.param_groups:
            g["capturable"] = True
        for st in opt.state.values():
            if "step" in st:
                st["step"] = st["step"].to("cuda")
    return bool(adams)


def _scan_step_vs_torch(torch, tag, start, eager, scan, l_e, l_s, failures,
                        cancel=(), lr=0.0) -> None:
    """One captured step against one ``train_step`` from ``start``: the
    captured update (SGD's ``_foreach`` update reading the lr tensor;
    Adam's capturable update reading its lr from the device) against
    torch's ``optimizer.step()``. Losses and floating buffers within the
    A/B limits, counts exact, and for each net the parameters and the
    optimizer state within ``SCAN_STEP_UNITS`` f32 unit roundoffs of
    their norm: one ulp an element, two roundings of one value. With
    ``failures`` None it only prints.

    ``cancel`` lists the state paths of the biases a BatchNorm follows:
    their gradient is zero in exact arithmetic and rounding noise as
    computed, and Adam's first step turns noise of either sign into ±lr.
    They are left out of the nets' figures; their sign flips and largest
    move (against ``lr``) are printed."""
    s0, e, c = (_split_state(torch, t) for t in (start, eager, scan))
    loss_err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(l_s, l_e))
    stat_err = max((float((c["buffers"][k] - e["buffers"][k]).abs().max())
                    / (float(e["buffers"][k].abs().max()) + 1e-6)
                    for k in e["buffers"]), default=0.0)
    counts_ok = all(torch.equal(c["counts"][k].cpu(), e["counts"][k].cpu())
                    for k in e["counts"])
    ok = loss_err <= AB_LOSS_TOL and stat_err <= AB_STAT_TOL and counts_ok
    nets = {}
    for part in ("params", "moments"):
        ce, ee = _by_net(c[part], cancel), _by_net(e[part], cancel)
        for net in ee:
            nets[net] = round(_rounding_units(ce[net], ee[net]), 3)
            ok = ok and nets[net] <= SCAN_STEP_UNITS
    upd = _rel(torch, _delta(s0["params"], c["params"]), _delta(s0["params"], e["params"]))
    biases = [k for k in e["params"] if any(k.startswith(p) for p in cancel)]
    flips, worst = 0, 0.0
    for k in biases:
        dc, de = c["params"][k] - s0["params"][k], e["params"][k] - s0["params"][k]
        flips += int(((dc > 0) != (de > 0)).sum())
        worst = max(worst, float(dc.abs().max()), float(de.abs().max()))
    verdict = "shown, not gated" if failures is None else ("ok" if ok else "FAIL")
    log(f"[{tag}] losses {[round(v, 5) for v in l_s]} vs {[round(v, 5) for v in l_e]} "
        f"rel_err {loss_err:.2e} (tol {AB_LOSS_TOL:.0e}); buffers max rel_err "
        f"{stat_err:.2e} (tol {AB_STAT_TOL:.0e}); {len(e['counts'])} counts exact: "
        f"{counts_ok}; parameters and optimizer state by net, in f32 unit roundoffs "
        f"of the norm (tol {SCAN_STEP_UNITS}) {json.dumps(nets)}; the whole update "
        f"rel_err {upd:.3e}"
        + (f"; {len(biases)} BN-fed biases left out: {flips} signs flipped, max "
           f"|dp| {worst:.4e} (lr {lr:.0e})" if biases else "") + f" ({verdict})")
    if failures is not None and not ok:
        failures.append(f"[{tag}] the captured step and optimizer.step() disagree")


def _restore_in_place(torch, tr, sd) -> None:
    """Copy a trainer's ``state_dict()`` back into its live tensors (a
    captured program keeps their addresses, where ``load_state_dict``
    replaces the optimizer's): parameters and buffers, every optimizer
    state tensor (zeroed where ``sd`` has none: torch's fresh state), each
    group's lr, the schedule and the host counters."""
    from tpu_syncbn_torch.parallel.trainer import _load_named_state_

    if hasattr(tr, "model"):
        nets = [(tr.model, tr.optimizer, sd["params"], sd["rest"],
                 sd["opt_state"]["optimizer"])]
    else:
        nets = [(m, o, sd[f"{n}_params"], sd[f"{n}_rest"], sd[f"{n}_opt_state"])
                for n, m, o in tr._nets()]
    with torch.no_grad():
        for model, opt, params, rest, osd in nets:
            _load_named_state_(model, params, rest)
            if getattr(tr, "zero", False):  # the shards, and their state's slices
                osd = copy.deepcopy(osd)
                tr._reshard_from_model(osd)
            for i, st in opt.state_dict()["state"].items():
                for key, v in st.items():
                    if isinstance(v, torch.Tensor):
                        if i in osd["state"]:
                            v.copy_(osd["state"][i][key])
                        else:
                            v.zero_()
            for g, saved in zip(opt.param_groups, osd["param_groups"]):
                g["lr"] = saved["lr"]
        if getattr(tr, "_residual", None) is not None:
            views = tr._residual if tr.zero else tr._residual_views()
            for n, v in views.items():
                v.copy_(sd["opt_state"]["residual"][n])
    if getattr(tr, "lr_scheduler", None) is not None:
        tr.lr_scheduler.load_state_dict(copy.deepcopy(sd["opt_state"]["lr_scheduler"]))
    if "step_count" in sd:
        tr.step_count = sd["step_count"]


def _timed_calls(torch, fn, n: int) -> tuple[list, list, int]:
    """``n`` calls of ``fn``, each between a synchronize and CUDA events:
    (host ms, device ms, peak bytes above the start of a call)."""
    host, dev, peak = [], [], 0
    for _ in range(n):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(b))
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return host, dev, peak


def _flat(losses) -> list:
    """Per-step loss lists (``[loss]``, or ``[d_loss, g_loss]``) as one list."""
    return [v for step in losses for v in step]


def _program(tr, k: int):
    return next(p for key, p in tr.program_caches[0].items() if key[0] == k)


def _scan_path(torch, T, tag, subject, per_step, card, failures) -> dict:
    """One path of ``[scan]``. ``subject`` builds and drives the trainer:
    ``trainer``, ``steps`` (per-step batches on the card), ``stack``,
    ``eager(batch) -> losses`` (``train_step``), ``chunk(stacked) ->
    per-step losses``, ``losses(out)`` of a program's outputs, ``images``
    a step, and ``lr_at(start, i)`` where a schedule runs. ``per_step``:
    BN launches of each kernel a step. The checks:

    * K captured steps against the same K-step body run eagerly on the
      card from the same state (``ScanSteps.loop``), with cuDNN's
      deterministic algorithms so the eager run repeats itself: the graph
      must replay what it recorded (update and optimizer state within
      2^-8, bitwise equality printed);
    * one captured step against one ``train_step`` with each Adam in
      torch's capturable form, as the chunk runs it: the update and the
      optimizer state within one rounding (:func:`_scan_step_vs_torch`);
      shown, against Adam as built (torch's capturable form computes
      its bias corrections in f32);
    * K captured steps against K such ``train_step`` calls: the losses
      within the A/B limit and the counts exact (the rest shown: a
      rounding apart grows step by step; all shown where
      ``gate_k_losses`` is False); for Adam, shown, against the form as
      built, and torch's two forms against each other;
    * the launches the graph recorded, none at a replay; the schedule
      across two chunks. Then, with cuDNN's default algorithms again,
      the eager and captured step times at each K of ``SCAN_KS``."""
    tr, steps, k = subject["trainer"], subject["steps"], SCAN_STEPS
    eager, chunk, stack, losses = (subject[n] for n in ("eager", "chunk", "stack",
                                                        "losses"))
    start = tr.state_dict()
    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    # the train_steps first (a load of ``start`` puts each Adam back in
    # its form as built; a chunk makes it capturable)
    l_e1 = [eager(steps[0])]
    st_e1 = tr.state_dict()
    tr.load_state_dict(start)
    l_e = [eager(b) for b in steps[:k]]
    st_e = tr.state_dict()
    tr.load_state_dict(start)
    adam = _make_capturable(torch, tr)
    l_ec1, st_ec1, l_ec, st_ec = l_e1, st_e1, l_e, st_e
    if adam:
        l_ec1 = [eager(steps[0])]
        st_ec1 = tr.state_dict()
        l_ec = l_ec1 + [eager(b) for b in steps[1:k]]
        st_ec = tr.state_dict()
    form = " (Adam capturable, as the chunk runs it)" if adam else ""

    tr.load_state_dict(start)
    l_c1 = chunk(stack(steps[:1]))
    st_c1 = tr.state_dict()
    _scan_step_vs_torch(torch, f"{tag} K=1 captured vs one train_step{form}", start,
                        st_ec1, st_c1, _flat(l_ec1), _flat(l_c1), failures)
    if adam:
        _scan_step_vs_torch(torch, f"{tag} K=1 captured vs one train_step (Adam as "
                            "built)", start, st_e1, st_c1, _flat(l_e1), _flat(l_c1),
                            None, subject.get("cancel", ()), subject.get("lr", 0.0))

    tr.load_state_dict(start)
    chunk1, chunk2 = stack(steps[:k]), stack(steps[k:2 * k])
    T.reset_launch_counts()  # the captured path: counts from 0
    t0 = time.perf_counter()
    l_c = chunk(chunk1)
    first_s = time.perf_counter() - t0
    built = T.launch_counts()
    st_c = tr.state_dict()
    prog = _program(tr, k)
    from tpu_syncbn_torch.parallel import scan_driver

    captured = {n: built[n] - per_step[n] * scan_driver.WARMUP_STEPS for n in built}
    want = {n: per_step[n] * k for n in per_step}
    looped = []
    for _ in range(2):  # the body eagerly from the same state, twice
        _restore_in_place(torch, tr, start)
        looped.append((losses(prog.loop(chunk1)), tr.state_dict()))
    bitwise = _scan_compare(torch, f"{tag} K={k} captured vs the body run eagerly",
                            start, looped[0][1], looped[1][1], st_c,
                            _flat(looped[0][0]), _flat(l_c), failures)
    _scan_compare(torch, f"{tag} K={k} captured vs {k} train_steps{form}", start, st_ec,
                  st_ec, st_c, _flat(l_ec), _flat(l_c),
                  failures if subject.get("gate_k_losses", True) else None,
                  losses_only=True)
    if adam:
        _scan_compare(torch, f"{tag} K={k} captured vs {k} train_steps (Adam as built)",
                      start, st_e, st_e, st_c, _flat(l_e), _flat(l_c), None)
        _scan_compare(torch, f"{tag} K={k} torch's two forms: {k} train_steps with Adam "
                      "capturable vs as built", start, st_e, st_e, st_ec, _flat(l_e),
                      _flat(l_ec), None)
    _restore_in_place(torch, tr, st_c)
    before = T.launch_counts()
    chunk(chunk2)
    replay_adds = {n: T.launch_counts()[n] - before[n] for n in before}
    log(f"[{tag}] K={k}: the first chunk built (warm-up {scan_driver.WARMUP_STEPS} "
        f"steps + capture) in {first_s:.2f}s (capture {prog.capture_s:.2f}s), graph "
        f"pool {prog.pool_bytes / 2**30:.3f} GiB; BN launches recorded in the graph "
        f"{json.dumps(captured)} (want {json.dumps(want)} a replay); launches through "
        f"the wrappers during a later chunk {json.dumps(replay_adds)} (a replay calls "
        "none)")
    if captured != want or any(replay_adds.values()):
        failures.append(f"[{tag}] captured launches {captured} (want {want}), a "
                        f"replay added {replay_adds}")
    if "lr_at" in subject:
        # the table holds the last fill, chunk 2's: schedule steps k..2k-1
        table = prog.chunk.opt.lrs[:, 0].cpu()
        want_lr = torch.tensor([subject["lr_at"](start, i) for i in range(k, 2 * k)],
                               dtype=torch.float32)
        sched = tr.lr_scheduler.last_epoch - start["opt_state"]["lr_scheduler"]["last_epoch"]
        log(f"[{tag}] schedule across two chunks: chunk 2's lr table "
            f"{table.tolist()} vs the cosine schedule's {want_lr.tolist()}; the "
            f"scheduler advanced {sched} steps (want {2 * k})")
        if not torch.equal(table, want_lr) or sched != 2 * k:
            failures.append(f"[{tag}] the chunk's lr table does not follow the schedule")
    torch.backends.cudnn.deterministic = determ
    e_host, e_dev, e_peak = _timed_calls(torch, lambda: eager(steps[0]), SCAN_TIMED + 1)
    e_host_med, e_dev_med = statistics.median(e_host[1:]), statistics.median(e_dev[1:])
    out = {"eager": {"host_ms": e_host_med, "device_ms": e_dev_med,
                     "img_s": subject["images"] / e_host_med * 1e3,
                     "steady_peak_bytes": e_peak},
           "bitwise_vs_loop": bitwise}
    log(f"[{tag}] eager step: host median {e_host_med:.3f} ms, CUDA events "
        f"{e_dev_med:.3f} ms ({subject['images'] / e_host_med * 1e3:.1f} img/s), "
        f"peak above the step's start {e_peak / 2**30:.3f} GiB [{card}]")
    for kk in SCAN_KS:
        stacked = stack(steps[:kk])
        tr.program_caches[0].clear()
        t0 = time.perf_counter()
        chunk(stacked)
        build_s = time.perf_counter() - t0
        p = _program(tr, kk)
        host, dev, peak = _timed_calls(torch, lambda: chunk(stacked), SCAN_TIMED)
        h, d = statistics.median(host) / kk, statistics.median(dev) / kk
        out[f"k{kk}"] = {"host_ms": h, "device_ms": d, "img_s": subject["images"] / h * 1e3,
                         "capture_s": p.capture_s, "build_s": build_s,
                         "pool_bytes": p.pool_bytes, "call_peak_bytes": peak}
        log(f"[{tag}] captured K={kk}: a step host {h:.3f} ms, CUDA events {d:.3f} ms "
            f"(median of {SCAN_TIMED} chunks / K; {subject['images'] / h * 1e3:.1f} img/s, "
            f"{e_host_med / h:.2f}x eager); capture {p.capture_s:.2f}s (build "
            f"{build_s:.2f}s); graph pool {p.pool_bytes / 2**30:.3f} GiB vs the eager "
            f"steady peak {e_peak / 2**30:.3f} GiB; a call's own peak "
            f"{peak / 2**30:.3f} GiB [{card}]")
    last = stack(steps[:SCAN_KS[-1]])
    profile_window(torch, lambda: [chunk(last) for _ in range(2)], f"{tag}-profile",
                   "BN kernels", _is_bn_kernel, card,
                   window=f"2 chunks of K={SCAN_KS[-1]} ({2 * SCAN_KS[-1]} steps)")
    return out


def _dp_losses(out) -> list:
    return [[v] for v in out["loss"].tolist()]


def _scan_resnet(torch, T, card, failures):
    """ResNet-50 SyncBN bf16 at batch 64, 224², the ImageNet example's SGD
    (Nesterov, weight decay) and its cosine LambdaLR; then the
    stale-address check."""
    from tpu_syncbn_torch import imagenet_resnet50
    from tpu_syncbn_torch.parallel import scan_driver

    model, dp = _resnet_trainer(torch, decay_steps=SCAN_DECAY)
    steps = [_trainer_batch(torch, 300 + i) for i in range(max(2 * SCAN_STEPS, SCAN_KS[-1]))]
    base = dp.optimizer.param_groups[0]["initial_lr"]
    subject = {
        "trainer": dp, "steps": steps, "images": BATCH, "losses": _dp_losses,
        "stack": scan_driver.stack_batches,
        "eager": lambda b: [float(dp.train_step(b).loss)],
        "chunk": lambda s: [[v] for v in dp.train_steps_batches(s).loss.tolist()],
        # bf16 at lr 0.1 from initialization: the eager steps' own fourth
        # loss moves ~2 % between processes (cuDNN's autotuned algorithms),
        # so the K-step losses against train_step are shown; the one-step
        # check holds the update against torch's
        "gate_k_losses": False,
        "lr_at": lambda start, i: base * imagenet_resnet50.cosine_decay(
            start["opt_state"]["lr_scheduler"]["last_epoch"] + i, SCAN_DECAY),
    }
    out = _scan_path(torch, T, "scan/resnet50", subject,
                     dict.fromkeys(MOVES, BN_LAYERS), card, failures)
    # stale addresses: load a different state (it replaces the optimizer's
    # tensors); the next chunk must equal the body run eagerly from it
    other = dp.state_dict()
    for _ in range(2):
        dp.train_step(steps[0])
    held = next(iter(dp.program_caches[0].values()))
    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dp.load_state_dict(other)
    stale, emptied = held.stale(), len(dp.program_caches[0]) == 0
    chunk1 = scan_driver.stack_batches(steps[:SCAN_STEPS])
    l_c = subject["chunk"](chunk1)
    st_c = dp.state_dict()
    prog = _program(dp, SCAN_STEPS)
    looped = []
    for _ in range(2):
        _restore_in_place(torch, dp, other)
        looped.append((_dp_losses(prog.loop(chunk1)), dp.state_dict()))
    log(f"[scan/resnet50] stale addresses: after load_state_dict the program "
        f"held before it reads stale: {stale}; the cache emptied: {emptied}")
    n_fail = len(failures)
    _scan_compare(torch, "scan/resnet50 after load_state_dict, captured vs the body "
                  "run eagerly", other, looped[0][1], looped[1][1], st_c,
                  _flat(looped[0][0]), _flat(l_c), failures)
    torch.backends.cudnn.deterministic = determ
    if not (stale and emptied):
        failures.append("[scan/resnet50] load_state_dict left a stale program cached")
    out["stale_gate"] = stale and emptied and len(failures) == n_fail
    del dp, model
    return out


def _scan_dcgan(torch, T, card, failures):
    """DCGAN at full width (latent 128, G width 256, D width 64), f32,
    batch 64, Adam(2e-4, β₁ 0.5) made capturable: GANTrainer.train_steps."""
    from tpu_syncbn_torch import models, nn, parallel
    from tpu_syncbn_torch.parallel import scan_driver

    def build():
        G = nn.convert_sync_batchnorm(models.DCGANGenerator(
            latent_dim=128, device="cuda", generator=torch.Generator().manual_seed(0)))
        D = nn.convert_sync_batchnorm(models.DCGANDiscriminator(
            device="cuda", generator=torch.Generator().manual_seed(1)))
        return parallel.GANTrainer(
            G, D, torch.optim.Adam(G.parameters(), lr=2e-4, betas=(0.5, 0.999)),
            torch.optim.Adam(D.parameters(), lr=2e-4, betas=(0.5, 0.999)), device="cuda")

    tr = build()
    g = torch.Generator(device="cuda").manual_seed(12)
    steps = [(torch.rand(GAN_BATCH, 32, 32, 3, device="cuda", generator=g) * 2 - 1,
              torch.randn(GAN_BATCH, 128, device="cuda", generator=g),
              torch.randn(GAN_BATCH, 128, device="cuda", generator=g))
             for _ in range(max(2 * SCAN_STEPS, SCAN_KS[-1]))]

    def eager(b):
        o = tr.train_step(*b)
        return [float(o.d_loss), float(o.g_loss)]

    def chunk(s):
        o = tr.train_steps(*s)
        return [list(v) for v in zip(o.d_loss.tolist(), o.g_loss.tolist())]

    # the biases a BatchNorm follows (G: fc, the deconvs; D: conv2, conv3)
    names = {"g": ["fc.bias"] + [f"deconvs.{i}.bias" for i in range(3)],
             "d": ["conv2.bias", "conv3.bias"]}
    cancel = []
    for net, model, _ in tr._nets():
        order = [n for n, _ in model.named_parameters()]
        for n in names[net]:
            cancel += [f"/{net}_params/{n}", f"/{net}_opt_state/state/{order.index(n)}/"]
    subject = {"trainer": tr, "steps": steps, "images": GAN_BATCH, "eager": eager,
               "chunk": chunk, "stack": scan_driver.stack_batches,
               "cancel": cancel, "lr": 2e-4,
               "losses": lambda o: [list(v) for v in zip(o["d_loss"].tolist(),
                                                         o["g_loss"].tolist())]}
    per = {k: GAN_FWD if k in FORWARD else GAN_BWD for k in MOVES}
    out = _scan_path(torch, T, "scan/dcgan", subject, per, card, failures)
    nbt = {net: sorted({int(m.num_batches_tracked) for m in model.modules()
                        if isinstance(m, nn.BatchNorm)})
           for net, model in (("G", tr.generator), ("D", tr.discriminator))}
    log(f"[scan/dcgan] num_batches_tracked after the timed chunks {json.dumps(nbt)} "
        f"(+2 G / +3 D an iteration: {tr.step_count} iterations)")
    if nbt != {"G": [2 * tr.step_count], "D": [3 * tr.step_count]}:
        failures.append(f"[scan/dcgan] num_batches_tracked {nbt}")
    return out


def _scan_retinanet(torch, T, card, failures):
    """RetinaNet-R50-FPN at 512², batch 2, f32, Adam(1e-3) made capturable,
    under DataParallel: its loss (per-image matching, one-hot targets,
    gathers by index) reads no device value on the host, so it captures."""
    from tpu_syncbn_torch import data, models, nn, parallel
    from tpu_syncbn_torch.parallel import scan_driver

    model = nn.convert_sync_batchnorm(models.retinanet_r50_fpn(
        num_classes=80, image_size=(RN_SIDE, RN_SIDE), device="cuda"))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    dp = parallel.DataParallel(model, opt, lambda m, b: m.loss(*b), device="cuda")
    ds = data.SyntheticDetectionDataset(length=RN_BATCH * SCAN_KS[-1],
                                        image_size=(RN_SIDE, RN_SIDE),
                                        num_classes=80, max_boxes=RN_BOXES)
    loader = data.DataLoader(ds, batch_size=RN_BATCH, num_workers=0, drop_last=True)
    steps = [data.loader._map_arrays(lambda a: torch.as_tensor(a).cuda(), b)
             for b in loader]
    subject = {"trainer": dp, "steps": steps, "images": RN_BATCH, "losses": _dp_losses,
               "stack": scan_driver.stack_batches,
               "eager": lambda b: [float(dp.train_step(b).loss)],
               "chunk": lambda s: [[v] for v in dp.train_steps_batches(s).loss.tolist()]}
    out = _scan_path(torch, T, "scan/retinanet", subject,
                     dict.fromkeys(MOVES, BN_LAYERS), card, failures)
    del dp, model, opt
    return out


def phase_scan(torch, card):
    """K steps as one CUDA graph for each path (ROADMAP A.8). Returns
    (failures, numbers by path)."""
    from tpu_syncbn_torch.ops import triton_bn as T

    t0 = time.perf_counter()
    failures, out = [], {}
    for name, fn in (("resnet50", _scan_resnet), ("dcgan", _scan_dcgan),
                     ("retinanet", _scan_retinanet)):
        t1 = time.perf_counter()
        out[name] = fn(torch, T, card, failures)
        torch.cuda.empty_cache()
        log(f"[scan/{name}] done in {time.perf_counter() - t1:.1f}s")
    log(f"[scan] phase done in {time.perf_counter() - t0:.1f}s, {len(failures)} failures")
    return failures, out


# -- phase 12b: compress — the int8 wire of the gradient all-reduce (A.9) ---

QUANT_KERNELS = ("quant_minmax", "quant_encode", "quant_decode")
QUANT_SOURCE = "tpu_syncbn_torch/ops/csrc/quant_int8.cu"
# XLA-fused code in the JAX package, no pallas_call: the per-chunk range,
# the shared-range encode, the error-feedback mean's dequantize
QUANT_REPLACES = {
    "quant_minmax": "tpu_syncbn/parallel/collectives.py:707",
    "quant_encode": "tpu_syncbn/parallel/collectives.py:715",
    "quant_decode": "tpu_syncbn/parallel/collectives.py:898",
}
QUANT_QMAX = (127, 63, 31, 1)  # worlds 1, 2, 4, 127
QUANT_RAGGED = 100_003  # not a multiple of the 256-element chunk
RESNET50_GRADS = 25_557_032  # the slice's trainable parameters
# f32 operations an element (compare and add; sub, div, rint, clip, mul,
# add, sub; mul, add, div), against the 67 TFLOP/s f32 peak
QUANT_OPS = {"quant_minmax": 3, "quant_encode": 9, "quant_decode": 3}
COMPRESS_STEPS, COMPRESS_K, COMPRESS_TIMED = 3, 4, 3


def quant_bytes(k: str, n: int, chunk: int = 256) -> int:
    """Bytes one call must move with error feedback on: each input read
    once, each output written once."""
    nc = -(-n // chunk)
    if k == "quant_minmax":  # g, e -> ranges
        return 8 * n + 8 * nc
    if k == "quant_encode":  # g, e, ranges -> q, scale, zp, e'
        return 8 * n + 8 * nc + nc * chunk + 8 * nc + 4 * n
    return nc * chunk + 8 * nc + 4 * n  # q, scale, zp -> the f32 mean


def quant_bound_ms(k: str, n: int, chunk: int = 256) -> tuple[float, str]:
    by_bytes = quant_bytes(k, n, chunk) / HBM_BYTES_PER_S * 1e3
    by_ops = QUANT_OPS[k] * n / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _quant_inputs(torch, n: int, seed: int):
    """A gradient-like payload and a residual, with one constant chunk
    (elements 256-511: half = 0, so scale = 1)."""
    g_ = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n, device="cuda", generator=g_) * 1e-2
    e = torch.randn(n, device="cuda", generator=g_) * 1e-4
    g[256:512] = 0.5
    e[256:512] = 0.0
    return g, e


def _quant_parity(torch, Q, failures) -> dict:
    """Each kernel against its plain version on the same CUDA tensors: at
    the ResNet-50 payload and a ragged length, qmax 127 / 63 / 31 / 1, with
    and without a residual. Gate: every output bit-identical. Returns the
    largest |kernel - plain| per kernel."""
    worst = dict.fromkeys(QUANT_KERNELS, 0.0)
    n_cases = 0
    for n in (RESNET50_GRADS, QUANT_RAGGED):
        g, e = _quant_inputs(torch, n, seed=n % 1000)
        for qmax in QUANT_QMAX:
            for ee in (e, None):
                ef = ee is not None
                rk, rp = Q.minmax(g, ee, chunk=256), Q.minmax_plain(g, ee, 256)
                qk, sk, zk, resk = Q.encode(g, ee, rk, qmax, chunk=256, want_residual=ef)
                qp, sp, zp, resp = Q.encode_plain(g, ee, rk, qmax, 256, ef)
                world = 127 // qmax  # q summed over this many replicas fits
                dk = Q.decode(qk, sk, zk, world=world, n=n, chunk=256, mean=ef)
                dp = Q.decode_plain(qk, sk, zk, world, n, ef)
                pairs = {"quant_minmax": [(rk, rp)],
                         "quant_encode": [(qk, qp), (sk, sp), (zk, zp)]
                         + ([(resk, resp)] if ef else []),
                         "quant_decode": [(dk, dp)]}
                n_cases += 1
                bad = []
                for k, ps in pairs.items():
                    for a, b in ps:
                        worst[k] = max(worst[k], float((a.double() - b.double()).abs().max()))
                        if not torch.equal(a, b):
                            bad.append(k)
                if float(sk[1]) != 1.0 or bool((qk[256:512] != 0).any()):
                    bad.append("constant chunk")
                if bad:
                    failures.append(f"[compress] parity n={n} qmax={qmax} ef={ef}: "
                                    f"{sorted(set(bad))} differ from the plain versions")
        del g, e
    log(f"[compress] parity: {n_cases} cases (n = {RESNET50_GRADS} and {QUANT_RAGGED}, "
        f"qmax {QUANT_QMAX}, with and without a residual, a constant chunk): "
        f"max |kernel - plain| {json.dumps(worst)} (gate: bit-identical) "
        f"{'ok' if not failures else 'FAIL'}")
    return worst


# the ZeRO reduce-scatter's chunks: one a scatter shard of ResNet-50's
# gradients, at world 1 (the whole payload) and world 4
QUANT_ZERO_CHUNKS = ((RESNET50_GRADS, 1), (RESNET50_GRADS // 4, 4))


def _quant_zero_shapes(torch, Q, card, failures) -> dict:
    """The three kernels at the ZeRO reduce-scatter's chunk sizes (the
    tiled launch shape), with and without a residual: every output
    bit-identical to the plain version, and each kernel's device time
    beside its bound (error feedback on). Returns {"<kernel> chunk=<c>":
    {"ms", "bound_ms", "bound_by"}}."""
    n = RESNET50_GRADS
    g, e = _quant_inputs(torch, n, seed=7)
    out, bad, worst = {}, [], 0.0
    for chunk, world in QUANT_ZERO_CHUNKS:
        qmax = 127 // world
        for ee in (e, None):
            ef = ee is not None
            rk = Q.minmax(g, ee, chunk=chunk)
            qk, sk, zk, resk = Q.encode(g, ee, rk, qmax, chunk=chunk, want_residual=ef)
            want = {"quant_minmax": [Q.minmax_plain(g, ee, chunk)],
                    "quant_encode": [t for t in Q.encode_plain(g, ee, rk, qmax, chunk, ef)
                                     if t is not None],
                    "quant_decode": [Q.decode_plain(qk, sk, zk, world, n, ef)]}
            got = {"quant_minmax": [rk],
                   "quant_encode": [t for t in (qk, sk, zk, resk) if t is not None],
                   "quant_decode": [Q.decode(qk, sk, zk, world=world, n=n, chunk=chunk,
                                             mean=ef)]}
            for k in QUANT_KERNELS:
                for a, b in zip(got[k], want[k]):
                    worst = max(worst, float((a.double() - b.double()).abs().max()))
                    if not torch.equal(a, b):
                        bad.append(f"{k} chunk={chunk} ef={ef}")
        r = Q.minmax(g, e, chunk=chunk)
        q, s_, z, _ = Q.encode(g, e, r, qmax, chunk=chunk)
        e2 = torch.empty_like(e)
        calls = {"quant_minmax": lambda: Q.minmax(g, e, chunk=chunk),
                 "quant_encode": lambda: Q.encode(g, e, r, qmax, chunk=chunk,
                                                  want_residual=True, residual_out=e2),
                 "quant_decode": lambda: Q.decode(q, s_, z, world=world, n=n, chunk=chunk,
                                                  mean=True)}
        plains = {"quant_minmax": lambda: Q.minmax_plain(g, e, chunk),
                  "quant_encode": lambda: Q.encode_plain(g, e, r, qmax, chunk, True),
                  "quant_decode": lambda: Q.decode_plain(q, s_, z, world, n, True)}
        for k, fn in calls.items():
            t, t_p = _device_ms(torch, fn, 20), _device_ms(torch, plains[k], 5)
            bound, by = quant_bound_ms(k, n, chunk)
            out[f"{k} chunk={chunk}"] = {"ms": t, "plain_ms": t_p, "bound_ms": bound,
                                         "bound_by": by}
            log(f"[compress] {k:12s} n={n} chunk={chunk} ({-(-n // chunk)} chunks, the ZeRO "
                f"scatter at world {world}) f32 device: kernel={t:.4f}ms plain={t_p:.4f}ms "
                f"bound={bound:.4f}ms ({by}; {100 * bound / t:.1f}% of bound) [{card}]")
        del r, q, s_, z, e2
    log(f"[compress] parity at the ZeRO chunks (n = {n}, chunk = n and n/4, qmax 127 "
        f"and 31, with and without a residual): max |kernel - plain| {worst:.3e} (gate: "
        f"bit-identical) {'ok' if not bad else 'FAIL'}")
    if bad:
        failures.append(f"[compress] ZeRO chunks differ from the plain versions: {bad}")
    del g, e
    return out


def _quant_times(torch, Q, card) -> dict:
    """Device time of each kernel at the ResNet-50 payload (error feedback
    on, world 1) beside its bound and its plain version's."""
    n = RESNET50_GRADS
    g, e = _quant_inputs(torch, n, seed=5)
    e2 = torch.empty_like(e)
    ranges = Q.minmax(g, e, chunk=256)
    q, s, z, _ = Q.encode(g, e, ranges, 127, chunk=256)
    calls = {
        "quant_minmax": (lambda: Q.minmax(g, e, chunk=256),
                         lambda: Q.minmax_plain(g, e, 256)),
        "quant_encode": (lambda: Q.encode(g, e, ranges, 127, chunk=256, want_residual=True,
                                          residual_out=e2),
                         lambda: Q.encode_plain(g, e, ranges, 127, 256, True)),
        "quant_decode": (lambda: Q.decode(q, s, z, world=1, n=n, chunk=256, mean=True),
                         lambda: Q.decode_plain(q, s, z, 1, n, True)),
    }
    out = {}
    for k, (kern, plain) in calls.items():
        t_k, t_p = _device_ms(torch, kern, 20), _device_ms(torch, plain, 5)
        bound, by = quant_bound_ms(k, n)
        out[k] = dict(ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by=by, library_ms=None)
        log(f"[compress] {k:12s} n={n} f32 device: kernel={t_k:.4f}ms "
            f"plain={t_p:.4f}ms bound={bound:.4f}ms ({by}, "
            f"{quant_bytes(k, n) / 1e6:.1f} MB; {100 * bound / t_k:.1f}% of bound) [{card}]")
    chain_k = sum(v["ms"] for v in out.values())
    chain_p = sum(v["plain_ms"] for v in out.values())
    log(f"[compress] the three a step: kernels {chain_k:.4f}ms, plain chain "
        f"{chain_p:.4f}ms, bound {sum(v['bound_ms'] for v in out.values()):.4f}ms [{card}]")
    del g, e, e2, q
    return out


def _trainers_in_turns(torch, tag, builders: dict, steps, k: int, timed: int,
                       card) -> dict:
    """Two trainers (``builders``: mode -> ``(model, dp)`` factory) side by
    side, timed in turns (a, b, b, a): eager and captured K-step times,
    host clock and CUDA events, the median a step over both turns; each
    one's graph pool, capture seconds and the bytes it holds between
    steps for the weights."""
    from tpu_syncbn_torch.parallel import scan_driver

    stacked = scan_driver.stack_batches(steps[:k])
    runs = {}
    for mode, build in builders.items():
        model, dp = build()
        dp.train_step(steps[0])  # cuDNN's autotuning and the builds
        dp.train_steps_batches(stacked)  # captures
        runs[mode] = (model, dp, {"eager_host": [], "eager_dev": [], "captured_host": [],
                                  "captured_dev": []})
    a, b = list(builders)
    for mode in (a, b, b, a):
        _, dp, t = runs[mode]
        host, dev, _ = _timed_calls(torch, lambda: dp.train_step(steps[0]), timed)
        t["eager_host"] += host
        t["eager_dev"] += dev
        host, dev, _ = _timed_calls(torch, lambda: dp.train_steps_batches(stacked), timed)
        t["captured_host"] += [h / k for h in host]
        t["captured_dev"] += [d / k for d in dev]
    out = {}
    for mode, (model, dp, t) in runs.items():
        prog = _program(dp, k)
        out[mode] = {key + "_ms": statistics.median(v) for key, v in t.items()}
        out[mode].update(pool_bytes=prog.pool_bytes, capture_s=prog.capture_s,
                         held_bytes=_held_bytes(dp))
        o = out[mode]
        log(f"[{tag}] {mode}: eager step host {o['eager_host_ms']:.3f} ms, "
            f"events {o['eager_dev_ms']:.3f} ms; captured K={k} a step host "
            f"{o['captured_host_ms']:.3f} ms, events {o['captured_dev_ms']:.3f} ms "
            f"(medians of 2 turns x {timed}); capture {prog.capture_s:.2f}s, graph pool "
            f"{prog.pool_bytes / 2**30:.3f} GiB; parameters + optimizer state held between "
            f"steps {o['held_bytes'] / 1e6:.1f} MB [{card}]")
    runs.clear()
    for kind in ("eager_dev_ms", "captured_dev_ms"):
        log(f"[{tag}] {b} costs {out[b][kind] - out[a][kind]:+.3f} ms a step over {a} "
            f"({kind.split('_')[0]}, CUDA events: {out[b][kind]:.3f} vs {out[a][kind]:.3f}) "
            f"[{card}]")
    return out


def _held_bytes(dp) -> int:
    """Bytes a rank holds between steps for the weights: the module's
    parameters, the shards under a sharding layout, the optimizer's state
    and the error-feedback residual."""
    ts = list(dp.model.parameters())
    if dp.zero:
        ts += list(dp._shards.values())
    for st in dp.optimizer.state.values():
        ts += [v for v in st.values() if hasattr(v, "numel")]
    ts += dp._residuals()
    return sum(t.numel() * t.element_size() for t in ts)


def _chunk_vs_body(torch, dp, steps, k: int, tag: str, failures) -> bool:
    """A captured ``k``-step chunk of ``dp`` from its current state held
    bitwise against the same body run eagerly from that state (cuDNN
    deterministic), as [scan] does; a failure is appended when not."""
    from tpu_syncbn_torch.parallel import scan_driver

    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    start = dp.state_dict()
    stacked = scan_driver.stack_batches(steps[:k])
    l_c = dp.train_steps_batches(stacked).loss.tolist()
    st_c = dp.state_dict()
    prog = _program(dp, k)
    looped = []
    for _ in range(2):
        _restore_in_place(torch, dp, start)
        looped.append((_dp_losses(prog.loop(stacked)), dp.state_dict()))
    bitwise = _scan_compare(torch, f"{tag} K={k} captured vs the body run eagerly", start,
                            looped[0][1], looped[1][1], st_c, _flat(looped[0][0]), l_c,
                            failures)
    torch.backends.cudnn.deterministic = determ
    if not bitwise:
        failures.append(f"[{tag}] the captured chunk is not bitwise its body")
    return bitwise


def _compress_slice(torch, Q, card, failures) -> tuple[dict, dict]:
    """The slice's main path with ``compress="int8"`` (error feedback on):
    eager steps (one minmax, encode and decode a step; finite losses; the
    wire ratio), one step's reduction against the plain versions on the
    same gradients, the residual's bound, a captured K = 4 chunk against
    its body run eagerly, and the step's cost against ``"none"``."""
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.parallel import collectives as C

    steps = [_trainer_batch(torch, 500 + i) for i in range(COMPRESS_K)]
    model, dp = _resnet_trainer(torch, compress="int8")
    n = sum(p.numel() for p in model.parameters() if p.requires_grad)
    dp.train_step(steps[0])  # cuDNN's autotuning (not counted)
    # the main path: every quant count from 0
    Q.reset_launch_counts()
    C.reset_tallies()
    losses = [float(dp.train_step(b).loss) for b in steps[:COMPRESS_STEPS]]
    launches = Q.launch_counts()
    ratio = C.compression_tallies()["compression_ratio"]
    log(f"[compress] int8 + error feedback, {n} gradients in {-(-n // 256)} chunks: "
        f"{COMPRESS_STEPS} steps, losses {losses}, launches {json.dumps(launches)} "
        f"(want {COMPRESS_STEPS} each), wire ratio {ratio:.4f} (want 3.879)")
    if launches != dict.fromkeys(QUANT_KERNELS, COMPRESS_STEPS):
        failures.append(f"[compress] launches {launches}")
    if n != RESNET50_GRADS or round(ratio, 3) != 3.879:
        failures.append(f"[compress] payload {n}, ratio {ratio}")
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"[compress] non-finite loss {losses}")

    # one step's reduction, kernels against plain versions, same gradients
    rec = {}
    real = dp._reduce_grads_

    def spy(grads):
        rec["grads"] = [g.clone() for g in grads]
        rec["e0"] = dp._residual.clone()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        real(grads)
        b.record()
        rec["host_ms"] = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        rec["device_ms"] = a.elapsed_time(b)
        rec["mean"] = C._fuse_f32(grads)
        rec["e1"] = dp._residual.clone()

    start = dp.state_dict()
    dp._reduce_grads_ = spy
    dp.train_step(steps[COMPRESS_STEPS % len(steps)])
    del dp._reduce_grads_
    after_k = {k: p.detach().clone() for k, p in model.named_parameters()}
    dp.load_state_dict(start)
    trainable = [p for p in model.parameters() if p.requires_grad]
    for p, g in zip(trainable, rec["grads"]):
        p.grad = g.clone()
    grads = [p.grad for p in trainable]
    with bn_ops.kernel_mode("off"):
        dp._reduce_grads_(grads)
    mean_off, e1_off = C._fuse_f32(grads), dp._residual.clone()
    dp._optimizer_step()
    units = max(float(((after_k[k].double() - p.detach().double()).abs()
                       / (p.detach().double().abs() * 2 ** -24 + 1e-30)).max())
                for k, p in model.named_parameters())
    same = torch.equal(rec["mean"], mean_off) and torch.equal(rec["e1"], e1_off)
    log(f"[compress] one step, kernels vs plain versions on the same gradients: "
        f"reduced gradients and residual bit-identical: {same}; parameters "
        f"{units:.2f} f32 roundings apart (gate 1) {'ok' if same and units <= 1 else 'FAIL'}")
    if not (same and units <= 1.0):
        failures.append(f"[compress] the step's reduction differs from the plain versions "
                        f"(bitwise {same}, parameters {units:.2f} roundings)")
    # Every residual element within the bound of the encode's own f32
    # arithmetic (Q.encode_residual_bound). Derivation, u = 2^-24, fl() one
    # round-to-nearest, for one element of payload p = fl(g + e) (the
    # residual is p's error, so p's own rounding does not enter), with the
    # chunk's range gmin <= p <= gmax (exact: min and max do not round):
    #   zp    = fl(fl(gmax + gmin) * 0.5)
    #   half  = fl(fl(gmax - gmin) * 0.5)
    #   scale = fl(half * fl(1 / qmax))    (the product with the f32 reciprocal)
    #   d = fl(p - zp)        |d - (p - zp)| <= u |p - zp|
    #   t = fl(d / scale)     |t - d/scale| <= u |d| / scale   (__fdiv_rn)
    #   q = clamp(rint(t), +-qmax)
    #     unclamped: |q - t| <= 1/2, so
    #       |scale q - (p - zp)| <= scale/2 + u |d| + u |p - zp|
    #                            <= scale/2 + u (2 + u) |p - zp|
    #     clamped (|t| > qmax): q = +-qmax and the exact error is
    #       |p - zp| - qmax scale <= (gmax - gmin)/2 + u |zp| (1 + u) - qmax scale
    #       <= 3u (1 + 4u) qmax scale + u (1 + u) |zp|   (half and scale each
    #       round once or twice below (gmax - gmin)/2), inside the same sum
    #       since scale/2 >= u qmax scale
    #   s = fl(scale q)       |s - scale q| <= u scale |q|
    #   o = fl(s + zp)        |o - (s + zp)| <= u (scale |q| (1 + u) + |zp|)
    #   r = fl(p - o)         |r| <= (1 + u) |p - o|
    # Summed: |r| <= (1 + u) (scale/2 + u (2 + u)(|p - zp| + scale |q|)
    #                         + u |zp|)
    #             <= scale/2 + u (1 + 2u) (scale/2 + 2 |p - zp| + 2 scale |q| + |zp|),
    # plus 2^-149 for a product that underflows (a subnormal sum or
    # difference is exact). The kernel rounds after every operation with the
    # same intrinsics (csrc/quant_int8.cu), so the bound holds for it too;
    # tests/test_torch_compression.py pins it on adversarial chunks and
    # shows it catches an off-by-one code and a scale k ulps off.
    flat = C._fuse_f32(rec["grads"])
    ranges = Q.minmax_plain(flat, rec["e0"], 256)
    q, scale, zp, _ = Q.encode_plain(flat, rec["e0"], ranges, 127, 256, False)
    bound = Q.encode_residual_bound(flat + rec["e0"], scale, zp, q, 256)
    excess = float((rec["e1"].double().abs() - bound).max())
    log(f"[compress] residual: max |e| {float(rec['e1'].abs().max()):.3e}, largest "
        f"|e| - (the encode's derived bound) {excess:.3e} (gate <= 0) "
        f"{'ok' if excess <= 0 else 'FAIL'}")
    if excess > 0:
        failures.append(f"[compress] a residual exceeds the encode's derived bound by "
                        f"{excess:.3e}")
    red = {"host_ms": rec["host_ms"], "device_ms": rec["device_ms"]}
    del rec

    bitwise = _chunk_vs_body(torch, dp, steps, COMPRESS_K, "compress/resnet50 int8", failures)
    del dp, model
    torch.cuda.empty_cache()
    times = _trainers_in_turns(
        torch, "compress", {m: functools.partial(_resnet_trainer, torch, compress=m)
                            for m in ("none", "int8")}, steps, COMPRESS_K, COMPRESS_TIMED, card)
    torch.cuda.empty_cache()
    log(f"[compress] the int8 reduction alone in an eager step: host {red['host_ms']:.3f} "
        f"ms to enqueue, device {red['device_ms']:.3f} ms between CUDA events [{card}]")
    return launches, {"times": times, "bitwise_chunk": bitwise, "ratio": ratio,
                      "reduce": red}


def _compress_gan(torch, failures) -> float:
    """One DCGAN iteration at full width with ``compress="bf16"``."""
    from tpu_syncbn_torch import models, nn, parallel

    G = nn.convert_sync_batchnorm(models.DCGANGenerator(
        latent_dim=128, device="cuda", generator=torch.Generator().manual_seed(0)))
    D = nn.convert_sync_batchnorm(models.DCGANDiscriminator(
        device="cuda", generator=torch.Generator().manual_seed(1)))
    tr = parallel.GANTrainer(
        G, D, torch.optim.Adam(G.parameters(), lr=2e-4, betas=(0.5, 0.999)),
        torch.optim.Adam(D.parameters(), lr=2e-4, betas=(0.5, 0.999)),
        compress="bf16", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    out = tr.train_step(torch.rand(GAN_BATCH, 32, 32, 3, device="cuda", generator=g) * 2 - 1,
                        torch.randn(GAN_BATCH, 128, device="cuda", generator=g),
                        torch.randn(GAN_BATCH, 128, device="cuda", generator=g))
    d_loss, g_loss = float(out.d_loss), float(out.g_loss)
    ok = math.isfinite(d_loss) and math.isfinite(g_loss)
    log(f"[compress] DCGAN compress='bf16': one iteration d_loss {d_loss:.4f} g_loss "
        f"{g_loss:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[compress] the bf16 DCGAN iteration is not finite")
    return d_loss


def phase_compress(torch, card):
    """The compressed gradient wire (ROADMAP A.9): the three int8 kernels
    against their plain versions and their times, the ResNet-50 slice at
    int8 with error feedback, and a bf16 DCGAN iteration. Returns
    (failures, kernel figures, main-path launches, summary)."""
    from tpu_syncbn_torch.ops import quant_int8 as Q

    t0 = time.perf_counter()
    failures = []
    worst = _quant_parity(torch, Q, failures)
    times = _quant_times(torch, Q, card)
    zero_shapes = _quant_zero_shapes(torch, Q, card, failures)
    torch.cuda.empty_cache()
    launches, summary = _compress_slice(torch, Q, card, failures)
    summary["zero_chunks"] = zero_shapes
    _compress_gan(torch, failures)
    torch.cuda.empty_cache()
    for k in QUANT_KERNELS:
        times[k]["max_abs_err"] = worst[k]
    log(f"[compress] phase done in {time.perf_counter() - t0:.1f}s, {len(failures)} failures")
    return failures, times, launches, summary


# -- phase: zero — the sharded weight update (ROADMAP A.10) ----------------

ZERO_STEPS, ZERO_K, ZERO_TIMED = 2, 4, 3


def _zero_trainer(torch, **kw):
    """bf16 ResNet-50 SyncBN from seed-0 weights with Adam(1e-3), at world
    1: replicated (no layout), or under ``kw``'s layout."""
    from tpu_syncbn_torch import models, nn, parallel

    model = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(0)))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    return model, parallel.DataParallel(model, opt, _loss_fn, device="cuda", **kw)


def _adam_moments(dp) -> dict:
    """``{"<param>/<exp_avg|exp_avg_sq>": tensor}`` per parameter, from
    the flat shards under a sharding layout (world 1: a shard is the
    whole padded vector)."""
    out = {}
    if dp.zero:
        for key in ("exp_avg", "exp_avg_sq"):
            views = dp._flat.unflatten({dt: dp.optimizer.state[s][key]
                                        for dt, s in dp._shards.items()})
            out.update({f"{n}/{key}": v for n, v in views.items()})
        return out
    for n, p in dp.model.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"{n}/{key}"] = dp.optimizer.state[p][key]
    return out


def _zero_eager_gate(torch, steps, failures) -> dict:
    """ZERO_STEPS eager steps replicated and under SpecLayout.zero() from the
    same weights and batches (cuDNN deterministic): parameters and Adam's
    moments within one f32 rounding of each tensor's norm (bitwise
    expected, printed). Returns the held bytes of each."""
    from tpu_syncbn_torch.parallel.layout import SpecLayout

    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    for tag, kw in (("replicated", {}), ("zero", {"layout": SpecLayout.zero()})):
        model, dp = _zero_trainer(torch, **kw)
        losses = [float(dp.train_step(b).loss) for b in steps[:ZERO_STEPS]]
        state = {f"{n}": p.detach().clone() for n, p in model.named_parameters()}
        state.update({k: v.clone() for k, v in _adam_moments(dp).items()})
        runs[tag] = (losses, state, _held_bytes(dp))
        del dp, model
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = determ
    (l_r, s_r, b_r), (l_z, s_z, b_z) = runs["replicated"], runs["zero"]
    units = max(float((s_z[k].double() - v.double()).norm())
                / (SCAN_ROUNDING * max(float(v.double().norm()), 1e-30)) for k, v in s_r.items())
    bitwise = l_z == l_r and all(torch.equal(s_z[k], v) for k, v in s_r.items())
    ok = units <= 1.0 and set(s_z) == set(s_r)
    log(f"[zero] {ZERO_STEPS} eager steps, SpecLayout.zero() against zero=False, same "
        f"weights and batches: losses {[round(v, 5) for v in l_z]} vs "
        f"{[round(v, 5) for v in l_r]}; parameters and Adam moments ({len(s_r)} tensors) "
        f"at most {units:.3f} f32 roundings of their norm apart (gate 1); bitwise equal: "
        f"{bitwise} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[zero] the sharded step differs from the replicated one "
                        f"({units:.3f} roundings)")
    return {"replicated": b_r, "zero": b_z, "bitwise": bitwise, "roundings": units}


def _zero_int8(torch, steps, card, failures) -> dict:
    """The int8 wire under SpecLayout.zero() with error feedback: the main
    path's eager steps (each int8 kernel once a step, at one chunk = the
    whole payload, and the BN kernels 53 times a step; finite losses), then
    one step's scattered shard and new residual held bitwise against the
    plain versions on the same gradients and residual."""
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import quant_int8 as Q
    from tpu_syncbn_torch.ops import triton_bn as T
    from tpu_syncbn_torch.parallel.layout import SpecLayout

    model, dp = _zero_trainer(torch, layout=SpecLayout.zero(), compress="int8")
    dp.train_step(steps[0])  # cuDNN's autotuning (not counted)
    Q.reset_launch_counts()
    T.reset_launch_counts()  # the main path of this phase: counts from 0
    losses = [float(dp.train_step(b).loss) for b in steps[:ZERO_STEPS]]
    q_launch, bn_launch = Q.launch_counts(), T.launch_counts()
    ok_launch = (q_launch == dict.fromkeys(QUANT_KERNELS, ZERO_STEPS)
                 and all(v == BN_LAYERS * ZERO_STEPS for v in bn_launch.values()))
    log(f"[zero] int8 + error feedback under SpecLayout.zero(): {ZERO_STEPS} steps, losses "
        f"{losses}, int8 launches {json.dumps(q_launch)}, BN launches "
        f"{json.dumps(bn_launch)} (want {ZERO_STEPS} and {BN_LAYERS * ZERO_STEPS} each) "
        f"{'ok' if ok_launch else 'FAIL'}")
    if not ok_launch or not all(math.isfinite(v) for v in losses):
        failures.append(f"[zero] int8 path: launches {q_launch} {bn_launch}, losses {losses}")
    rec = {}
    real = dp._scatter_grads

    def spy(grads):
        rec["grads"] = [g.clone() for g in grads]
        rec["e0"] = {dt: r.clone() for dt, r in dp._residual.items()}
        out = real(grads)
        rec["shard"] = {dt: v.clone() for dt, v in out.items()}
        rec["e1"] = {dt: r.clone() for dt, r in dp._residual.items()}
        return out

    dp._scatter_grads = spy
    dp.train_step(steps[ZERO_STEPS % len(steps)])
    del dp._scatter_grads
    with torch.no_grad():
        for dt, r in dp._residual.items():
            r.copy_(rec["e0"][dt])
    with bn_ops.kernel_mode("off"):
        plain = dp._scatter_grads([g.clone() for g in rec["grads"]])
    same = all(torch.equal(rec["shard"][dt], plain[dt]) for dt in plain) and all(
        torch.equal(rec["e1"][dt], dp._residual[dt]) for dt in plain)
    n = dp._flat.padded["float32"]
    log(f"[zero] one step's int8 reduce-scatter ({n} gradients, one chunk: the shard), "
        f"kernels vs plain versions on the same gradients and residual: scattered shard "
        f"and new residual bit-identical: {same} {'ok' if same else 'FAIL'}")
    if not same:
        failures.append("[zero] the int8 reduce-scatter differs from its plain version")
    del dp, model, rec
    return {"launches": q_launch, "bn_launches": bn_launch, "bitwise": same,
            "losses": losses}


def phase_zero(torch, card, zero_chunks):
    """ZeRO at world 1 on the card (ROADMAP A.10): bf16 ResNet-50 SyncBN,
    batch 64 at 224², Adam, under SpecLayout.zero() — the flat layout, the
    gather, the scatter, the shard optimizer and its rebinding all run
    (the shard world is 1). Gates: the eager steps against zero=False, a
    captured chunk against its body, the int8 path's launches and its
    reduce-scatter against the plain versions. Prints the step costs, the
    bytes held between steps and the int8 kernels' times at chunk = n
    (measured in [compress]). Returns (failures, summary)."""
    from tpu_syncbn_torch.parallel.layout import SpecLayout

    t0 = time.perf_counter()
    failures = []
    steps = [_trainer_batch(torch, 700 + i) for i in range(ZERO_K)]
    held = _zero_eager_gate(torch, steps, failures)
    torch.cuda.empty_cache()
    model, dp = _zero_trainer(torch, layout=SpecLayout.zero())
    dp.train_step(steps[0])  # Adam's state exists before the capture
    bitwise = _chunk_vs_body(torch, dp, steps, ZERO_K, "zero", failures)
    del dp, model
    torch.cuda.empty_cache()
    int8 = _zero_int8(torch, steps, card, failures)
    for k in QUANT_KERNELS:
        z = zero_chunks[f"{k} chunk={RESNET50_GRADS}"]
        log(f"[zero] {k} at the int8 path's chunk = n = {RESNET50_GRADS}: {z['ms']:.4f} ms, "
            f"bound {z['bound_ms']:.4f} ms ({100 * z['bound_ms'] / z['ms']:.1f}% of bound) "
            f"[{card}]")
    torch.cuda.empty_cache()
    times = _trainers_in_turns(
        torch, "zero", {"replicated": functools.partial(_zero_trainer, torch),
                        "zero": functools.partial(_zero_trainer, torch,
                                                  layout=SpecLayout.zero())},
        steps, ZERO_K, ZERO_TIMED, card)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[zero] phase done in {secs:.1f}s, {len(failures)} failures [{card}]")
    return failures, {"held_bytes": held, "captured_bitwise": bitwise, "int8": int8,
                      "times": times, "seconds": secs}


# -- phase: autopilot — the closed loop on the full-width path (ROADMAP A.14a)

AP_K = (4, 8)  # the controller's K candidates; the loop starts at 4
AP_CLOCK_S = 30.0  # injected seconds a chunk boundary (the bench block's)
AP_WINDOW_S, AP_HEALTHY_S = 60.0, 60.0  # two chunk boundaries each
AP_DEADLINE_S = 30.0  # the loop's per-step watchdog deadline
AP_GAIN_OVER_MAX = 1000.0  # the fault's gradient over the largest real one
AP_STRIDE = 128  # every 128th element of each parameter carries the fault
AP_LR = 1e-10  # the spiked weights move < 1e-3 over the phase (gated)
AP_MIN_CLIP = 0.9  # the fault's clip_fraction, at least
AP_MAX_CHUNKS = 40  # a bound on the loop: the script's sequence takes ~26
AP_STEP_SEEDS = 8  # distinct per-step batches, cycled


def _ap_loss(model, batch):
    """The slice's loss plus the planted clip fault: ``flag`` times the sum
    of every ``AP_STRIDE``-th element of each parameter, so every 256-element
    int8 chunk of the fused gradient holds a +flag element (a chunk inside
    one parameter holds two; one that spans parameters holds the next
    one's first element). With flag 0 the term adds an exact 0."""
    x, y, flag = batch
    spike = sum(p.reshape(-1)[::AP_STRIDE].float().sum()
                for p in model.parameters() if p.requires_grad)
    return _loss_fn(model, (x, y)) + flag * spike


@contextlib.contextmanager
def checking_every_quant_call(torch, Q, seen):
    """``checking_every_call`` for the three int8 kernels: every call the
    wire makes is followed by the plain version on the same inputs (the
    residual the encode may write in place is copied first), and
    ``seen[kernel] = (calls, 0.0 if bit-identical else 2.0, 0.0)`` is
    kept; a call inside a graph capture is only counted."""
    saved = {k: getattr(Q, k) for k in ("minmax", "encode", "decode")}

    def note(k, same):
        calls, worst, _ = seen.get(k, (0, 0.0, 0.0))
        seen[k] = (calls + 1, max(worst, 0.0 if same else 2.0), 0.0)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)

    def minmax(g, e=None, *, chunk):
        got = saved["minmax"](g, e, chunk=chunk)
        if not _note_capture(torch, seen, "quant_minmax"):
            note("quant_minmax", equal((got,), (Q.minmax_plain(g, e, chunk),)))
        return got

    def encode(g, e, ranges, qmax, *, chunk, want_residual=False, residual_out=None):
        e0 = None if e is None or torch.cuda.is_current_stream_capturing() else e.clone()
        got = saved["encode"](g, e, ranges, qmax, chunk=chunk, want_residual=want_residual,
                              residual_out=residual_out)
        if not _note_capture(torch, seen, "quant_encode"):
            note("quant_encode", equal(got, Q.encode_plain(g, e0, ranges, qmax, chunk,
                                                           want_residual)))
        return got

    def decode(sumq, scale, zp, *, world, n, chunk, mean=False):
        got = saved["decode"](sumq, scale, zp, world=world, n=n, chunk=chunk, mean=mean)
        if not _note_capture(torch, seen, "quant_decode"):
            note("quant_decode", equal((got,), (Q.decode_plain(sumq, scale, zp, world, n,
                                                               mean),)))
        return got

    Q.minmax, Q.encode, Q.decode = minmax, encode, decode
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(Q, k, fn)


def _ap_trainer(torch):
    """The slice's trainer at ``compress="int8"`` (error feedback on) with
    monitors, the example's optimizer at ``AP_LR`` and the faulted loss."""
    from tpu_syncbn_torch import imagenet_resnet50, models, nn, parallel

    model = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(0)))
    opt, sched = imagenet_resnet50.make_optimizer(model, AP_LR, 1000)
    return model, parallel.DataParallel(model, opt, _ap_loss, device="cuda",
                                        lr_scheduler=sched, compress="int8", monitors=True)


def phase_autopilot(torch, card):
    """The autopilot (ROADMAP A.14a) turning the knobs of the full-width
    int8 ResNet-50 step, captured K at a time under ``ResilientLoop``,
    through ``chunked_batches``, on an injected clock (30 s a chunk
    boundary), each actuation dumping a bundle into a temporary directory
    (cooldown 0). The script plants a clip fault until the controller
    moves, then a ``mem.headroom_frac`` sample, then a ``mem_pressure``
    burn, and gates: the escalation within 2 chunks (one valid bundle an
    actuation); the int8 program recalled after the rung cycle with no
    capture, its first chunk bitwise its body run eagerly; K 4 -> 8 -> 4
    with the watchdog deadline following and no capture on the way back;
    the evicted graph's pool returned to the card; 53 launches a step of
    each BN kernel and one of each int8 kernel on the int8 rung, none on
    the others, each eager call held against its plain version; the live
    gauges on /statusz. Returns (failures, summary)."""
    import gc
    import tempfile

    from tpu_syncbn_torch.obs import (
        flightrec, memwatch, numerics as obs_numerics, server as obs_server, telemetry,
        timeseries,
    )
    from tpu_syncbn_torch.ops import quant_int8 as Q
    from tpu_syncbn_torch.ops import triton_bn as T
    from tpu_syncbn_torch.parallel import scan_driver
    from tpu_syncbn_torch.runtime import autopilot as ap_mod
    from tpu_syncbn_torch.runtime import resilience

    t_phase = time.perf_counter()
    failures: list = []
    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the recalled chunk against its body
    steps = [_trainer_batch(torch, 900 + i) for i in range(AP_STEP_SEEDS)]
    model, dp = _ap_trainer(torch)
    zero = torch.zeros((), device="cuda")
    dp.train_step((*steps[0], zero))  # cuDNN's plans, the builds
    gmax = max((float(p.grad.abs().max()) for p in model.parameters() if p.grad is not None),
               default=0.0)
    if not gmax > 0:
        fail("[autopilot] the first step left no gradient to size the fault by")
    gain = 2.0 ** math.ceil(math.log2(AP_GAIN_OVER_MAX * gmax))
    log(f"[autopilot] largest real gradient {gmax:.4g}: the fault's gain {gain:g} "
        f"(2^{int(math.log2(gain))}), on every {AP_STRIDE}th element of each parameter")
    spiked0 = {n: p.detach().reshape(-1)[::AP_STRIDE].float().clone()
               for n, p in model.named_parameters()}

    st = {"fault": False, "check": False, "stage": "fault", "measure": False, "c": 0}

    def source():
        i = 0
        while True:
            x, y = steps[i % len(steps)]
            i += 1
            yield x, y, torch.full((), gain if st["fault"] else 0.0, device="cuda")

    per_step: list = []  # (rung, launches of each kernel in one step)
    real_step = dp._chunk_step

    def counted_step(chunk, k, batch):
        before = {**T.launch_counts(), **Q.launch_counts()}
        out = real_step(chunk, k, batch)
        after = {**T.launch_counts(), **Q.launch_counts()}
        per_step.append((dp.compress, {n: after[n] - before[n] for n in after}))
        return out

    dp._chunk_step = counted_step  # every program steps through it

    # the int8 K = 4 program before the loop (its pool sets the byte budget)
    src = source()
    dp.train_steps_batches(scan_driver.stack_batches([next(src) for _ in range(AP_K[0])]))
    int8_cache = dp._train_steps_cache
    k4_pool = _program(dp, AP_K[0]).pool_bytes
    # the first shrink (to 3x) keeps int8's K = 4 and K = 8 graphs, the
    # second (to 1.5x) evicts the least recently used of them (K = 8): a
    # graph's pool is about one step's activations, whatever its K
    bounds = (k4_pool // 2, 6 * k4_pool)
    per_step.clear()

    prev_reg = telemetry.REGISTRY
    telemetry.REGISTRY = scratch = telemetry.Registry()
    telemetry.set_enabled(True)
    d = tempfile.mkdtemp(prefix="chip_smoke_autopilot_")
    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=d, cooldown_s=0.0))
    agg = timeseries.WindowedAggregator(scratch)
    clock = {"t": 0.0}
    agg.tick(now=0.0)

    def now():
        clock["t"] += AP_CLOCK_S
        agg.tick(now=clock["t"])
        return clock["t"]

    pilot = ap_mod.Autopilot(
        dp, aggregator=agg, rules=obs_numerics.numerics_rules() + memwatch.mem_rules(),
        modes=ap_mod.COMPRESS_LADDER, k_candidates=AP_K, cache_bytes_bounds=bounds,
        window_s=AP_WINDOW_S, healthy_for_s=AP_HEALTHY_S, now=now)
    sampler = memwatch.MemorySampler(
        contract_bytes_per_device=torch.cuda.get_device_properties(0).total_memory,
        contract_source="card capacity", pressure_threshold=None)

    # -- the harness around the loop: chunks, decisions, launches, times
    chunks: list = []  # one dict a chunk
    decisions: list = []
    evictions: list = []
    held: dict = {}
    real_tsb = dp.train_steps_batches

    def tsb(stacked):
        k, rung, cache = scan_driver.scan_length(stacked), dp.compress, dp._train_steps_cache
        misses = cache.misses
        info = {"c": st["c"], "rung": rung, "k": k, "fault": st["fault"]}
        if st["check"]:
            st["check"] = False
            start = dp.state_dict()
            out = real_tsb(stacked)
            st_c = dp.state_dict()
            prog = _program(dp, k)
            looped = []
            for _ in range(2):  # the body eagerly from the same state, twice
                _restore_in_place(torch, dp, start)
                looped.append((_dp_losses(prog.loop(stacked)), dp.state_dict()))
            info["bitwise"] = _scan_compare(
                torch, f"autopilot recalled {rung} K={k} chunk vs the body run eagerly",
                start, looped[0][1], looped[1][1], st_c, _flat(looped[0][0]),
                out.loss.tolist(), failures)
            _restore_in_place(torch, dp, st_c)
        else:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = real_tsb(stacked)
            b.record()
            info["events"] = (a, b)
        info["captured"] = cache.misses - misses
        if info["captured"]:
            p = _program(dp, k)
            info.update(capture_s=p.capture_s, pool_bytes=p.pool_bytes)
        if rung == "int8":
            info["clip"] = out.monitors["clip_fraction"]
        chunks.append(info)
        return out

    dp.train_steps_batches = tsb

    def live_pools():
        return {(id(c), key): p.pool_bytes for c in dp.program_caches for key, p in c.items()}

    real_on_chunk = pilot.on_chunk

    def on_chunk(**kw):
        if st["measure"]:
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            reserved, pools = torch.cuda.memory_reserved(), live_pools()
        out = real_on_chunk(**kw)
        for dec in out:
            dec = dict(dec, firing=sorted(r for r, s in pilot.tracker.state().items()
                                         if s["firing"]))
            decisions.append(dec)
            log(f"[autopilot] chunk {dec['chunk']} (t={dec['t_mono']:.0f}s): {dec['knob']} "
                f"{dec['action']} {dec.get('frm')} -> {dec.get('to')} on {dec.get('signal')} "
                f"(rules firing {dec['firing']})")
        if st["measure"] and any(x["action"] == "shrink" for x in out):
            gone = {key: v for key, v in pools.items() if key not in live_pools()}
            gc.collect()
            torch.cuda.empty_cache()
            evictions.append({"chunk": pilot.chunks, "programs": len(gone),
                              "pool_bytes": sum(gone.values()),
                              "released_bytes": reserved - torch.cuda.memory_reserved()})
        return out

    pilot.on_chunk = on_chunk

    def driver():
        """The chunk source: waits for the previous chunk (so its monitors
        are published at the next boundary), then steps the script."""
        inner = ap_mod.chunked_batches(source(), pilot)
        k8_chunks = 0
        for c in range(1, AP_MAX_CHUNKS + 1):
            torch.cuda.synchronize()
            st["c"] = c
            acts = [x for x in decisions if x["action"] not in ("clamp", "suppress")]
            stage = st["stage"]
            if stage == "fault":
                st["fault"] = not acts
                if acts:
                    st["stage"] = "recall"
            if stage == "recall" and dp.compress == "int8":
                st["check"], st["stage"] = True, "headroom"
            elif stage == "headroom":
                sampler.sample()  # a real reading: the K raise's headroom
                st["stage"] = "k8"
            elif stage == "k8":
                k8_chunks += pilot.scan_k == AP_K[1]
                if k8_chunks == 2:  # the captured K = 8 chunk and one replay
                    for _ in range(20):  # mem.used_frac over the 0.9 pressure SLO
                        telemetry.observe("mem.used_frac", 0.95, buckets=(0.5, 0.9, 1.0))
                    st["stage"], st["measure"] = "pressure", True
            elif stage == "pressure" and len(evictions) > 0 and evictions[-1]["programs"]:
                st["stage"] = "done"
            elif stage == "done":
                return
            yield next(inner)
        failures.append(f"[autopilot] the script stopped at stage {st['stage']!r} "
                        f"after {AP_MAX_CHUNKS} chunks")

    deadlines: list = []
    real_watchdog = resilience.Watchdog

    class DeadlineWatchdog(real_watchdog):
        def pat(self):
            deadlines.append(self.deadline_s)
            super().pat()

    int8_misses = int8_cache.misses
    T.reset_launch_counts()
    Q.reset_launch_counts()  # the main path: every count from 0
    t_loop = time.perf_counter()
    resilience.Watchdog = DeadlineWatchdog
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ap_ckpt_") as ck, \
                checking_every_call(torch, T, held), checking_every_quant_call(torch, Q, held):
            loop = resilience.ResilientLoop(dp, ck, ckpt_every=10 ** 9, scan_steps=AP_K[0],
                                            step_deadline_s=AP_DEADLINE_S, autopilot=pilot)
            summary = loop.run(driver())
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t_loop
        launches = {**T.launch_counts(), **Q.launch_counts()}
        report = obs_server.statusz_report(registry=scratch)
        text = obs_server.render_statusz(report)
        snap = scratch.snapshot()
        bundles = _bundles_by_kind(d)
    finally:
        resilience.Watchdog = real_watchdog
        dp.train_steps_batches, pilot.on_chunk = real_tsb, real_on_chunk
        del dp._chunk_step
        flightrec.uninstall()
        rec.close()
        telemetry.REGISTRY = prev_reg
        telemetry.set_enabled(None)
        torch.backends.cudnn.deterministic = determ
    st_final = pilot.state()
    acts = [x for x in decisions if x["action"] not in ("clamp", "suppress")]

    # 1. escalation on the fault, a bundle an actuation
    clip = [float(v) for x in chunks if x["fault"] and "clip" in x for v in x["clip"]]
    first = acts[0] if acts else {}
    log(f"[autopilot] the fault's clip_fraction on its int8 steps: min "
        f"{min(clip, default=float('nan')):.4f} over {len(clip)} steps (gate >= {AP_MIN_CLIP})")
    if not clip or min(clip) < AP_MIN_CLIP:
        failures.append(f"[autopilot] the fault's clip_fraction {clip} < {AP_MIN_CLIP}")
    ok1 = (first.get("action") == "escalate" and (first.get("frm"), first.get("to"))
           == ("int8", "bf16") and first.get("chunk", 99) <= 2
           and "numerics_clip" in first.get("firing", ()))
    ap_bundles = bundles.get("autopilot", [])
    valid = [b for b in ap_bundles if b["trigger"]["detail"].get("signal")
             and b["rings"].get("autopilot")]
    log(f"[autopilot] escalation: {first.get('frm')} -> {first.get('to')} at chunk "
        f"{first.get('chunk')} on {first.get('signal')} (numerics_clip firing: "
        f"{'numerics_clip' in first.get('firing', ())}; gate <= 2 chunks) "
        f"{'ok' if ok1 else 'FAIL'}; {len(acts)} actuations, {len(ap_bundles)} autopilot "
        f"bundles, {len(valid)} naming their signal with the ring; other kinds "
        f"{ {k: len(v) for k, v in bundles.items() if k != 'autopilot'} }")
    if not ok1:
        failures.append(f"[autopilot] no int8 -> bf16 escalation within 2 chunks: {first}")
    if len(ap_bundles) != len(acts) or len(valid) != len(acts):
        failures.append(f"[autopilot] {len(acts)} actuations left {len(ap_bundles)} bundles, "
                        f"{len(valid)} valid")

    # 2. the recalled int8 program: no capture, bitwise its body, no storm
    recalled = [x for x in chunks if "bitwise" in x]
    storms = snap["counters"].get("compile.storms", 0)
    modes = [x["to"] for x in acts if x["knob"] == "compress"]
    int8_new = int8_cache.misses - int8_misses  # its K = 8 graph only
    ok2 = (len(recalled) == 1 and recalled[0]["bitwise"] and not recalled[0]["captured"]
           and recalled[0]["rung"] == "int8" and storms == 0 and int8_new == 1
           and "recompile_storm" not in bundles and modes == ["bf16", "none", "bf16", "int8"])
    log(f"[autopilot] rungs visited int8 -> {' -> '.join(modes)}; the recalled int8 K=4 "
        f"chunk: captures {recalled[0]['captured'] if recalled else None}, bitwise its body "
        f"{recalled[0]['bitwise'] if recalled else None}; the int8 cache's captures in the "
        f"loop {int8_new} (its K=8 graph); compile.storms {storms} {'ok' if ok2 else 'FAIL'}")
    if not ok2:
        failures.append(f"[autopilot] recall: {recalled}, rungs {modes}, storms {storms}")

    # 3. K both ways, the deadline following
    ks = [(x["frm"], x["to"]) for x in acts if x["knob"] == "scan_k"]
    k_chunks = [x["k"] for x in chunks]
    want_dl = [AP_DEADLINE_S * AP_K[0]] + [AP_DEADLINE_S * k for k in k_chunks[1:]]
    back = [x for x in chunks if x["k"] == AP_K[0] and any(
        y["k"] == AP_K[1] for y in chunks[:chunks.index(x)])]
    ok3 = (ks == [(AP_K[0], AP_K[1]), (AP_K[1], AP_K[0])] and deadlines == want_dl
           and back and not any(x["captured"] for x in back)
           and loop.scan_steps == AP_K[0])
    log(f"[autopilot] K moves {ks}; chunk Ks {k_chunks}; watchdog deadlines at the pats "
        f"{deadlines} (want {want_dl}); K={AP_K[0]} chunks after K={AP_K[1]}: "
        f"{len(back)}, captures {sum(x['captured'] for x in back)} "
        f"{'ok' if ok3 else 'FAIL'}")
    if not ok3:
        failures.append(f"[autopilot] K moves {ks}, deadlines {deadlines} vs {want_dl}")

    # 4. the shrink that evicted gave its pools back
    ev = [e for e in evictions if e["programs"]]
    ok4 = bool(ev) and all(e["released_bytes"] >= 0.95 * e["pool_bytes"] for e in ev)
    for e in evictions:
        log(f"[autopilot] shrink at chunk {e['chunk']}: {e['programs']} program(s) "
            f"evicted, pools {e['pool_bytes'] / 2**30:.3f} GiB, memory_reserved fell "
            f"{e['released_bytes'] / 2**30:.3f} GiB after empty_cache (gate >= 95% of the "
            f"pools when one was evicted)")
    if not ok4:
        failures.append(f"[autopilot] evictions {evictions}")

    # 5. launches a step by rung, every eager call held
    bad = [(r, n) for r, n in per_step
           if any(n[k] != BN_LAYERS for k in MOVES)
           or any(n[k] != (1 if r == "int8" else 0) for k in QUANT_KERNELS)]
    by_rung = {}
    for r, _ in per_step:
        by_rung[r] = by_rung.get(r, 0) + 1
    want_launch = {k: BN_LAYERS * len(per_step) for k in MOVES}
    want_launch.update({k: by_rung.get("int8", 0) for k in QUANT_KERNELS})
    worst = {k: round(v[1], 3) for k, v in held.items() if "captured" not in k}
    eager_calls = {k: v[0] for k, v in held.items() if "captured" not in k}
    captured_calls = {k: v[0] for k, v in held.items() if "captured" in k}
    ok5 = (not bad and launches == want_launch
           and all(v <= 1.0 for v in worst.values())
           and sum(eager_calls.values()) + sum(captured_calls.values())
           == sum(want_launch.values()))
    log(f"[autopilot] steps through the kernels by rung {by_rung} (warm-ups, captures, the "
        f"eager bodies; replays launch none): launches {json.dumps(launches)} (want "
        f"{json.dumps(want_launch)}); steps off 53 BN / 1-or-0 int8: {len(bad)}; eager calls "
        f"held {json.dumps(eager_calls)}, worst/tol {json.dumps(worst)} (int8 bitwise: 0); "
        f"recorded in captures {json.dumps(captured_calls)} {'ok' if ok5 else 'FAIL'}")
    if not ok5:
        failures.append(f"[autopilot] launches {launches} vs {want_launch}, {len(bad)} steps "
                        f"off, worst {worst}")

    # 6. the live gauges
    gauges = report["autopilot"]
    want_g = {"autopilot.compress_rung": float(st_final["compress_rung"]),
              "autopilot.scan_k": float(st_final["scan_k"]),
              "autopilot.cache_max_bytes": float(st_final["cache_max_bytes"]),
              "autopilot.actuations": st_final["actuations"],
              "autopilot.clamped": st_final["clamped"]}
    ok6 = (all(gauges.get(k) == v for k, v in want_g.items())
           and st_final["compress"] == "int8" and st_final["scan_k"] == AP_K[0]
           and "autopilot.actuations" in text)
    log(f"[autopilot] /statusz autopilot section {json.dumps(gauges)}; state "
        f"{st_final['compress']} K={st_final['scan_k']} budget "
        f"{st_final['cache_max_bytes']} {'ok' if ok6 else 'FAIL'}")
    if not ok6:
        failures.append(f"[autopilot] gauges {gauges} vs {want_g}")

    moved = max(float((p.detach().reshape(-1)[::AP_STRIDE].float() - spiked0[n]).abs().max())
                for n, p in model.named_parameters())
    log(f"[autopilot] the spiked weights moved at most {moved:.3g} over the phase (gate < 1e-3)")
    if not moved < 1e-3:
        failures.append(f"[autopilot] the spiked weights moved {moved}")

    # captures and step times by rung and K
    captures = [{"rung": x["rung"], "k": x["k"], "capture_s": x["capture_s"],
                 "pool_bytes": x["pool_bytes"]} for x in chunks if x["captured"]]
    for x in captures:
        log(f"[autopilot] capture {x['rung']} K={x['k']}: {x['capture_s']:.2f}s, graph pool "
            f"{x['pool_bytes'] / 2**30:.3f} GiB [{card}]")
    times: dict = {}
    for x in chunks:
        if "events" in x and not x["captured"]:
            times.setdefault(f"{x['rung']} K={x['k']}", []).append(
                x["events"][0].elapsed_time(x["events"][1]) / x["k"])
    step_ms = {key: statistics.median(v) for key, v in times.items()}
    for key, v in step_ms.items():
        log(f"[autopilot] {key}: {v:.3f} ms a step (CUDA events, median of "
            f"{len(times[key])} replayed chunks) [{card}]")
    secs = time.perf_counter() - t_phase
    log(f"[autopilot] {len(chunks)} chunks ({summary['steps']} steps) in {loop_s:.1f}s; "
        f"int8 K=4 pool before the loop {k4_pool / 2**30:.3f} GiB, budget bounds "
        f"{bounds}; phase done in {secs:.1f}s, {len(failures)} failures [{card}]")
    for c in dp.program_caches:
        c.clear()
    del dp, model, pilot, loop
    gc.collect()
    torch.cuda.empty_cache()
    return failures, {
        "chunks": len(chunks), "steps": summary["steps"], "gain": gain,
        "clip_fraction_min": min(clip, default=None),
        "decisions": [{k: x.get(k) for k in ("chunk", "knob", "action", "frm", "to", "signal")}
                      for x in decisions],
        "captures": captures, "step_ms": step_ms, "evictions": evictions,
        "launches": launches, "bitwise_recall": bool(recalled and recalled[0]["bitwise"]),
        "deadlines": sorted(set(deadlines)), "statusz": gauges, "seconds": secs,
    }


RES_CHUNKS, RES_K = 3, 4  # ResilientLoop's chunks of K steps


# -- [audit]: the program contracts of the main path on the card -------------

AUDIT_K = 4  # the stacked chunk held against the one-step body
AUDIT_BUCKET = 128  # the serving bucket recorded
AUDIT_STATE = ("params", "rest", "opt_state")


def _audit_state_counts(torch, dp) -> dict:
    """The leaves each state group must write in place: the module's
    parameters and buffers, the optimizer's state tensors (and the
    error-feedback residual)."""
    opt = sum(1 for st in dp.optimizer.state.values()
              for v in st.values() if isinstance(v, torch.Tensor))
    return {"params": len(list(dp.model.parameters())),
            "rest": sum(1 for b in dp.model.buffers() if b is not None),
            "opt_state": opt + len(dp._residuals())}


def _audit_capture(torch, dp, batch, k: int, record: bool):
    """A ``k``-step program of ``dp`` captured from the trainer's current
    state by the trainer's own ``_build_program``, its learning rates
    filled as ``train_steps`` fills them: ``(program, recorder or None,
    capture seconds)``. With ``record`` the audit's recorder (sync debug
    mode "error" armed, layer 3 on the trainer's mesh and declared specs)
    is entered around the captured applications alone."""
    from tpu_syncbn_torch.audit import contracts
    from tpu_syncbn_torch.parallel.trainer import _schedule_lrs

    box = []
    mesh_axes, layout = dp.audit_mesh()

    def recorder(state, specs):
        box.append(contracts.Recorder(state, sync_debug=True, mesh_axes=mesh_axes,
                                      in_specs=specs, declared=AUDIT_STATE, layout=layout))
        return box[-1]

    t0 = time.perf_counter()
    prog = dp._build_program(k, True, batch, recorder=recorder if record else None)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    prog.chunk.opt.fill(_schedule_lrs(dp.optimizer, dp.lr_scheduler, k))
    return prog, (box[0] if box else None), capture_s


def _audit_wire(torch, T, Q, wire: str, card, failures) -> dict:
    """Gates 1-5 on the bf16 ResNet-50 slice at ``compress=wire``: the
    one-step body and a stacked K-step chunk recorded while they are
    captured, their contracts per step, the state written in place, the
    K = 4 chunk replayed bitwise against the same chunk captured without
    the recorder from the same state, and the launches (the eager warm-up
    applications held against the plain versions)."""
    from tpu_syncbn_torch.audit.contracts import compare_contracts
    from tpu_syncbn_torch.parallel import scan_driver

    tag = f"audit/{wire}"
    _, dp = _resnet_trainer(torch, compress=wire, monitors=True)
    steps = [_trainer_batch(torch, 700 + i) for i in range(AUDIT_K)]
    stacked = scan_driver.stack_batches(steps)
    one = scan_driver.stack_batches(steps[:1])
    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    seen: dict = {}
    T.reset_launch_counts()
    Q.reset_launch_counts()
    with checking_every_call(torch, T, seen), checking_every_quant_call(torch, Q, seen):
        prog1, rec1, cap1_s = _audit_capture(torch, dp, one, 1, True)
    launches1 = {**T.launch_counts(), **Q.launch_counts()}
    body = _audit_code(prog1.step_fn)
    del prog1
    dp._zero_grad()
    start = dp.state_dict()
    prog_r, rec4, cap_rec_s = _audit_capture(torch, dp, stacked, AUDIT_K, True)
    out_r = prog_r(stacked)
    state_r = dp.state_dict()
    del prog_r
    dp._zero_grad()
    torch.cuda.empty_cache()
    _restore_in_place(torch, dp, start)
    prog_p, _, cap_plain_s = _audit_capture(torch, dp, stacked, AUDIT_K, False)
    out_p = prog_p(stacked)
    state_p = dp.state_dict()
    del prog_p
    dp._zero_grad()
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = determ

    name = "resnet50_bf16." + wire
    t0 = time.perf_counter()
    c1 = rec1.contract(name=name, world=dp.world, declared_donated=AUDIT_STATE)
    extract_s = time.perf_counter() - t0
    c4 = rec4.contract(name=name, world=dp.world, declared_donated=AUDIT_STATE,
                       steps=AUDIT_K)
    log(f"[audit] {wire} one-step body, recorded at its capture: {json.dumps(c1.to_json())}")
    log(f"[audit] {wire} K={AUDIT_K} chunk a step: {json.dumps(c4.to_json())}; "
        f"{len(rec4.ops)} dispatched ops, {rec4.flops / AUDIT_K / 1e12:.4f} TFLOP a step")
    # 1. no host read (a sync inside raised under sync debug mode "error")
    if c1.host_callbacks or c4.host_callbacks:
        failures.append(f"[{tag}] host reads in the body: {c1.host_callbacks} "
                        f"{c4.host_callbacks}")
    # 2. every state leaf written in place; the batch not written
    want = _audit_state_counts(torch, dp)
    for what, c in (("K=1", c1), (f"K={AUDIT_K}", c4)):
        if c.donated_aliased != want:
            failures.append(f"[{tag}] {what}: state written in place {c.donated_aliased}, "
                            f"want {want} (module and optimizer leaves)")
    # 3. the K-step chunk's contract a step equals the one-step body's (layer
    # 3's peak holds the chunk's K batches: gate (f))
    k_diffs = compare_contracts(dataclasses.replace(c4, sharding=None),
                                dataclasses.replace(c1, sharding=None))
    if k_diffs:
        failures.append(f"[{tag}] K={AUDIT_K} chunk a step differs from the body: {k_diffs}")
    # 4. the recorder changes nothing: bitwise the chunk captured without it
    same_loss = torch.equal(out_r["loss"], out_p["loss"])
    leaves_r, leaves_p = _state_leaves(state_r), _state_leaves(state_p)
    same_state = len(leaves_r) == len(leaves_p) and all(
        pa == pb and _same_leaf(torch, a, b) for (pa, a), (pb, b) in zip(leaves_r, leaves_p))
    if not (same_loss and same_state):
        failures.append(f"[{tag}] the chunk captured under the recorder is not bitwise "
                        f"the one captured without it (losses {same_loss}, state {same_state})")
    # 5. launches: 53 of each BN kernel a step, 1 (int8) or 0 of each quant
    # kernel; the warm-up applications' launches held against the plain versions
    n_quant = 1 if wire == "int8" else 0
    steps_run = scan_driver.WARMUP_STEPS + 1
    for k in MOVES:
        want_k = BN_LAYERS * steps_run
        if launches1[k] != want_k or seen.get(k + " captured", (0,))[0] != BN_LAYERS:
            failures.append(f"[{tag}] {k}: {launches1[k]} launches (want {want_k}), "
                            f"{seen.get(k + ' captured', (0,))[0]} captured (want {BN_LAYERS})")
    for k in QUANT_KERNELS:
        if launches1[k] != n_quant * steps_run:
            failures.append(f"[{tag}] {k}: {launches1[k]} launches, want "
                            f"{n_quant * steps_run}")
    held = dict.fromkeys(MOVES, BN_LAYERS * scan_driver.WARMUP_STEPS)
    _held(tag, seen, held, failures)
    for k in QUANT_KERNELS:
        calls, worst, _ = seen.get(k, (0, 0.0, 0.0))
        if calls != n_quant * scan_driver.WARMUP_STEPS or worst > 0.0:
            failures.append(f"[{tag}] {k}: {calls} eager calls held, worst {worst}")
    log(f"[audit] {wire}: launches of the one-step program (2 eager warm-ups + its "
        f"capture) {json.dumps(launches1)}; the chunk under the recorder bitwise the "
        f"chunk without it: losses {same_loss}, state {same_state}; capture s K=1 "
        f"{cap1_s:.2f} (recorded), K={AUDIT_K} {cap_rec_s:.2f} recorded / "
        f"{cap_plain_s:.2f} not; contract from the recording {extract_s * 1e3:.1f} ms "
        f"[{card}]")
    from tpu_syncbn_torch.audit.contracts import tensor_leaves

    out_step = sum(t.numel() * t.element_size() for t in tensor_leaves(out_r)) // AUDIT_K
    layer3 = _audit_layer3(torch, dp, wire, c1, c4, one, out_step, steps[0], card, failures)
    return dp, {"contract_step": c1.to_json(), "ops_a_step": len(rec4.ops) // AUDIT_K,
            "layer3": layer3,
            "tflop_a_step": rec4.flops / AUDIT_K / 1e12,
            "capture_s": {"k1_recorded": cap1_s, f"k{AUDIT_K}_recorded": cap_rec_s,
                          f"k{AUDIT_K}_plain": cap_plain_s},
            "extract_ms": extract_s * 1e3, "bitwise": same_loss and same_state,
            "launches": launches1, "body": body}


# gate (e)'s bound: the allocator's reading over the recorded peak
AUDIT_ALLOCATOR_RATIO = 1.25
# dispatched ops whose kernels take cuDNN's and cuBLAS's workspaces
CUBLAS_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "matmul", "_scaled_mm", "linear",
                        "addmv", "mv", "dot"})


class _WorkspaceProbe:
    """A dispatch mode that reads, for every op, the bytes the caching
    allocator handed out inside it beyond what the op left allocated (its
    workspace: cuDNN's for a convolution, cuBLAS's for a matrix product),
    and the allocator's most above the start of the block, op by op. It
    also notes the storages each ``stack`` reads: the last run of stacks
    in a K-step body is ``ScanSteps.loop`` stacking the steps' results, so
    their storages are what each step keeps until the chunk ends
    (:meth:`result_bytes`)."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        probe = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                torch.cuda.reset_peak_memory_stats()
                m0 = torch.cuda.memory_allocated()
                out = func(*args, **(kwargs or {}))
                top = torch.cuda.max_memory_allocated()
                left = torch.cuda.memory_allocated()
                name = func._opname
                probe.ops.append((name, [(t.untyped_storage().data_ptr(),
                                          t.untyped_storage().nbytes())
                                         for t in (args[0] if name == "stack" else ())]))
                fam = ("cudnn" if "conv" in name or "cudnn" in name
                       else "cublas" if name in CUBLAS_OPS else "other")
                ws = top - max(left, m0)
                if ws > probe.most[fam]:
                    probe.most[fam], probe.where[fam] = ws, name
                if top - probe.start > probe.peak:
                    probe.peak, probe.at = top - probe.start, (name, fam, ws)
                return out

        self.mode = Mode()
        self.torch = torch
        self.most = {"cudnn": 0, "cublas": 0, "other": 0}
        self.where = {"cudnn": None, "cublas": None, "other": None}
        self.peak, self.at, self.start = 0, None, 0
        self.ops: list = []

    def result_bytes(self) -> int:
        """Bytes of the distinct storages the last run of ``stack`` ops read."""
        i = max((k for k, (n, _) in enumerate(self.ops) if n == "stack"), default=-1)
        seen = {}
        while i >= 0 and self.ops[i][0] == "stack":
            seen.update(self.ops[i][1])
            i -= 1
        return sum(seen.values())

    def __enter__(self):
        self.start = self.torch.cuda.memory_allocated()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def _audit_layer3(torch, dp, wire, c1, c4, one, out_step, batch, card, failures) -> dict:
    """Gates (d)-(f), layer 3 on the card: (d) no implicit reshard in the
    one-step body nor the K = 4 chunk recorded at their captures; (e) one
    eager application recorded with the allocator's reading: the recorded
    peak at most the allocator's, the allocator's at most
    ``AUDIT_ALLOCATOR_RATIO`` times the recorded, and the workspaces the gap
    is made of (a second eager application under ``_WorkspaceProbe``); (f)
    the K = 4 chunk's peak above the body's by at most its three extra
    steps' inputs and results: the batches of its stacked input and the
    storages of the per-step losses and metrics the chunk keeps until it
    stacks them (read by the probe; ``out_step``, the stacked results' bytes
    a step, is printed beside), nothing that grows with K besides."""
    t0 = time.perf_counter()
    s1, s4 = c1.sharding, c4.sharding
    if s1.implicit_reshards or s4.implicit_reshards:
        failures.append(f"[audit/{wire}] gate (d): implicit reshards {s1.reshard_detail} "
                        f"{s4.reshard_detail}")
    flow = dp.lowered_train_step(batch, sharding=True, memory=True).flow()
    recorded, allocator = flow.peak_bytes_per_device, flow.xla_peak_bytes
    ratio = allocator / max(recorded, 1)
    if not recorded <= allocator <= AUDIT_ALLOCATOR_RATIO * recorded or flow.implicit_reshards:
        failures.append(f"[audit/{wire}] gate (e): recorded peak {recorded} B, the "
                        f"allocator's {allocator} B (ratio {ratio:.4f}, bound "
                        f"{AUDIT_ALLOCATOR_RATIO}); reshards {flow.reshard_detail}")
    probe = _WorkspaceProbe(torch)
    with probe:
        dp.lowered_train_step(batch)
    # (f): what each step keeps until the chunk ends is its batch and the
    # storages of the results the chunk stacks
    kept = probe.result_bytes()
    batch_bytes = sum(t.numel() * t.element_size() for t in one)
    grow = s4.peak_bytes_per_device - s1.peak_bytes_per_device
    if grow > (AUDIT_K - 1) * (batch_bytes + kept):
        failures.append(f"[audit/{wire}] gate (f): the K={AUDIT_K} chunk's peak "
                        f"{s4.peak_bytes_per_device} B is {grow} B above the body's "
                        f"{s1.peak_bytes_per_device} B, more than {AUDIT_K - 1} steps' batch "
                        f"({batch_bytes} B) and results ({kept} B)")
    blas = getattr(torch.backends.cuda, "cublas_workspace_size", None)
    blaslt = getattr(torch.backends.cuda, "cublaslt_workspace_size", None)
    secs = time.perf_counter() - t0
    log(f"[audit] {wire} layer 3: gate (d) implicit reshards K=1 {s1.implicit_reshards}, "
        f"K={AUDIT_K} {s4.implicit_reshards}, eager {flow.implicit_reshards}; replicated "
        f"intermediates {s1.replicated_intermediates} (world 1: the detector is off, "
        f"DESIGN.md §8) {s1.replication_detail}; gate (f) peak K=1 "
        f"{s1.peak_bytes_per_device} B ({s1.peak_bytes_per_device / 2**30:.3f} GiB), "
        f"K={AUDIT_K} {s4.peak_bytes_per_device} B: +{grow} B against {AUDIT_K - 1} x "
        f"({batch_bytes} B of batch + {kept} B of results, their storages; the stacked "
        f"results {out_step} B a step); gate (e) eager recorded "
        f"{recorded} B "
        f"({recorded / 2**30:.3f} GiB), the allocator's {allocator} B, ratio {ratio:.4f} "
        f"(bound {AUDIT_ALLOCATOR_RATIO}), gap {allocator - recorded} B; workspaces an op, "
        f"largest: cuDNN {probe.most['cudnn']} B ({probe.where['cudnn']}), cuBLAS "
        f"{probe.most['cublas']} B ({probe.where['cublas']}), other {probe.most['other']} B "
        f"({probe.where['other']}); at the allocator's peak ({probe.peak} B above the start) "
        f"op {probe.at}; cuBLAS workspace setting "
        f"{blas() if blas else None} B, cuBLASLt {blaslt() if blaslt else None} B; "
        f"in {secs:.1f}s [{card}]")
    return {"k1": s1.to_json(), f"k{AUDIT_K}": s4.to_json(),
            "eager": {"peak_bytes_per_device": recorded, "xla_peak_bytes": allocator,
                      "ratio": ratio, "implicit_reshards": flow.implicit_reshards},
            "workspaces": {"largest": dict(probe.most), "ops": dict(probe.where),
                           "at_peak": probe.at,
                           "probe_peak_bytes": probe.peak,
                           "cublas_setting": blas() if blas else None,
                           "cublaslt_setting": blaslt() if blaslt else None},
            "batch_bytes": batch_bytes, "result_bytes": kept, "out_step_bytes": out_step,
            "seconds": secs}


def _audit_serve(torch, T, dp, card, failures) -> dict:
    """Gate 6: the bucket-128 program (the eval forward each bucket's graph
    captures) recorded on an engine built from ``dp``: no collective,
    nothing of its input or of the weights written, no host read (sync
    debug mode "error"), 53 ``bn_normalize`` launches; a second forward
    holds each against its plain version."""
    from tpu_syncbn_torch import serve
    from tpu_syncbn_torch.audit import contracts
    from tpu_syncbn_torch.mesh_axes import DATA_AXIS
    from tpu_syncbn_torch.parallel.layout import P

    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    engine = serve.InferenceEngine.from_trainer(dp, buckets=(AUDIT_BUCKET,))
    x = torch.randn(AUDIT_BUCKET, IMAGE_SIZE, IMAGE_SIZE, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    params = list(engine.model.parameters())
    rest = [b for b in engine.model.buffers() if b is not None]
    with torch.no_grad():
        engine._forward(x)  # builds cuDNN's plans outside the timed calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._forward(x)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        T.reset_launch_counts()
        rec = contracts.Recorder({"params": params, "rest": rest, "batch": x},
                                 sync_debug=True, mesh_axes={DATA_AXIS: 1},
                                 in_specs={"params": P(), "rest": P(), "batch": P(DATA_AXIS)})
        t0 = time.perf_counter()
        with rec:
            engine._forward(x)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        launches = T.launch_counts()
        seen: dict = {}
        with checking_every_call(torch, T, seen):
            engine._forward(x)
    torch.backends.cudnn.deterministic = determ
    body = _audit_code(engine._forward)
    c = rec.contract(name=f"serve.eval_bucket{AUDIT_BUCKET}", world=1)
    log(f"[audit] serve bucket {AUDIT_BUCKET}: {json.dumps(c.to_json())}; "
        f"launches {json.dumps(launches)}; eager forward {plain_s * 1e3:.1f} ms, recorded "
        f"{rec_s * 1e3:.1f} ms [{card}]")
    if c.collectives or c.donated_aliased or c.host_callbacks:
        failures.append(f"[audit/serve] the bucket program has collectives "
                        f"{c.collectives}, writes {c.donated_aliased}, host reads "
                        f"{c.host_callbacks}")
    if c.sharding.implicit_reshards:  # gate (d)
        failures.append(f"[audit/serve] gate (d): implicit reshards "
                        f"{c.sharding.reshard_detail}")
    log(f"[audit] serve bucket {AUDIT_BUCKET} layer 3: implicit reshards "
        f"{c.sharding.implicit_reshards}, peak {c.sharding.peak_bytes_per_device} B "
        f"({c.sharding.peak_bytes_per_device / 2**30:.3f} GiB) [{card}]")
    want = {k: (BN_LAYERS if k == "bn_normalize" else 0) for k in MOVES}
    if {k: launches[k] for k in MOVES} != want:
        failures.append(f"[audit/serve] launches {launches}, want {want}")
    calls, worst, _ = seen.get("bn_normalize", (0, 0.0, 0.0))
    if calls != BN_LAYERS or worst > 1.0:
        failures.append(f"[audit/serve] bn_normalize: {calls} calls held, worst {worst:.2f} "
                        "of tol")
    del engine
    torch.cuda.empty_cache()
    return {"contract": c.to_json(), "launches": launches, "forward_ms": plain_s * 1e3,
            "recorded_forward_ms": rec_s * 1e3, "held_worst": worst,
            "body": body}


def _audit_fingerprint(failures) -> dict:
    """Gate 7: a bundle written now carries the hash of the port's goldens."""
    import tempfile

    from tpu_syncbn_torch.audit import program_audit
    from tpu_syncbn_torch.obs import flightrec, incident

    with tempfile.TemporaryDirectory(prefix="chip_smoke_audit_") as d:
        rec = flightrec.FlightRecorder(incident_dir=d, cooldown_s=0.0)
        try:
            bundle = incident.load_bundle(rec.trigger("manual", force=True))
        finally:
            rec.close()
    got = bundle["contract"]["fingerprint"]
    want = incident.contract_fingerprint(program_audit.default_golden_dir())
    log(f"[audit] a bundle's contract.fingerprint {got}, the goldens' {want}")
    if got is None or got != want:
        failures.append(f"[audit] bundle fingerprint {got}, want {want}")
    return {"fingerprint": got}


def _audit_code(fn) -> dict:
    """Where the function a program captures is defined: the function
    under any ``functools.partial`` and bound method."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    code = getattr(fn, "__func__", fn).__code__
    return {"name": code.co_name, "file": code.co_filename, "line": code.co_firstlineno}


def _audit_lint(card, failures) -> dict:
    """Gate 8 (a): the source lint over the package that runs here, every
    rule, strict."""
    from tpu_syncbn_torch import audit

    t0 = time.perf_counter()
    result = audit.run_audit(contracts=False, strict=True)
    secs = time.perf_counter() - t0
    for v in result.violations:
        failures.append(f"[audit/lint] {v.format()}")
    log(f"[audit] gate (a) lint: {result.files_linted} files linted, "
        f"{len(result.violations)} violations in {secs:.2f}s [{card}]")
    return {"files_linted": result.files_linted, "violations": len(result.violations),
            "seconds": secs}


def _audit_sync_cases(torch):
    """Gate 8 (b)'s calls: one a host-sync form of ``host_sync_in_step``
    and the near misses the rule leaves clean, on small CUDA tensors made
    before the mode is armed."""
    F = torch.nn.functional
    x = torch.arange(8, device="cuda", dtype=torch.float32)
    y = torch.tensor([0, 3, 1, 2], device="cuda")
    r = torch.tensor([1, 2, 1, 0], device="cuda")
    mask = x > 3
    stream = torch.cuda.Stream()
    event = torch.cuda.Event()
    event.record()
    pinned = torch.ones(4, pin_memory=True)
    torch.cuda.synchronize()
    named = {
        ".item()": lambda: x.sum().item(),
        ".tolist()": lambda: x.tolist(),
        ".cpu()": lambda: x.cpu(),
        ".numpy()": lambda: x.numpy(),
        "torch.cuda.synchronize": lambda: torch.cuda.synchronize(),
        "stream.synchronize()": lambda: stream.synchronize(),
        "event.synchronize()": lambda: event.synchronize(),
        "torch.nonzero": lambda: torch.nonzero(mask),
        ".nonzero()": lambda: mask.nonzero(),
        "torch.unique": lambda: torch.unique(y),
        ".unique()": lambda: y.unique(),
        "torch.masked_select": lambda: torch.masked_select(x, mask),
        ".masked_select()": lambda: x.masked_select(mask),
        "torch.argwhere": lambda: torch.argwhere(mask),
        ".argwhere()": lambda: mask.argwhere(),
        "torch.where(condition)": lambda: torch.where(mask),
        "one_hot without num_classes": lambda: F.one_hot(y),
        "repeat_interleave without output_size": lambda: y.repeat_interleave(r),
    }
    near = {
        "F.one_hot(y, num_classes=8)": lambda: F.one_hot(y, num_classes=8),
        "repeat_interleave(r, output_size=4)": lambda: y.repeat_interleave(r, output_size=4),
        "repeat_interleave(2)": lambda: y.repeat_interleave(2),
        "torch.where(mask, x, 0.0)": lambda: torch.where(mask, x, 0.0),
        "pinned.to('cuda', non_blocking=True)": lambda: pinned.to("cuda", non_blocking=True),
    }
    return named, near


def _audit_sync_vocabulary(torch, card, failures) -> dict:
    """Gate 8 (b): each host-sync form ``host_sync_in_step`` names raises
    under ``torch.cuda.set_sync_debug_mode("error")`` on this card, but
    those ``srclint.NOT_OBSERVABLE`` lists (printed as not observable by
    sync debug mode, counted as no pass; one that raises fails the gate,
    as the list would be wrong); each near miss runs without raising."""
    from tpu_syncbn_torch.audit import srclint

    named, near = _audit_sync_cases(torch)
    if tuple(named) != srclint.HOST_SYNC_FORMS:
        failures.append(f"[audit/sync] the gate's forms {list(named)} are not the rule's "
                        f"{list(srclint.HOST_SYNC_FORMS)}")
    outcome = {}
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for form, call in {**named, **near}.items():
            try:
                call()
                outcome[form] = "ran"
            except RuntimeError as e:
                outcome[form] = ("raised" if "synchroniz" in str(e)
                                 else f"RuntimeError: {str(e)[:80]}")
            except Exception as e:  # noqa: BLE001 — printed, and gated below
                outcome[form] = f"{type(e).__name__}: {str(e)[:80]}"
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    raised, unseen = [], []
    for form in named:
        if form in srclint.NOT_OBSERVABLE:
            unseen.append(form)
            if outcome[form] == "raised":
                failures.append(f"[audit/sync] {form} raised under sync debug mode, but "
                                "srclint.NOT_OBSERVABLE lists it")
        elif outcome[form] == "raised":
            raised.append(form)
        else:
            failures.append(f"[audit/sync] {form} did not raise under sync debug mode "
                            f"'error': {outcome[form]}")
    for form in near:
        if outcome[form] != "ran":
            failures.append(f"[audit/sync] near miss {form} raised: {outcome[form]}")
    log(f"[audit] gate (b) host syncs: {len(raised)} of {len(named)} named forms raised "
        f"under sync debug mode 'error' ({', '.join(raised)}); not observable by sync "
        f"debug mode: {', '.join(f'{f} ({outcome[f]})' for f in unseen)}; "
        f"{sum(outcome[f] == 'ran' for f in near)} of {len(near)} near misses ran "
        f"({', '.join(near)}) [{card}]")
    return {"raised": raised, "not_observable": {f: outcome[f] for f in unseen},
            "near_misses_ran": [f for f in near if outcome[f] == "ran"]}


def _audit_body_coverage(bodies, card, failures) -> dict:
    """Gate 8 (c): every body function ``[audit]`` captured on the card is
    a step body of ``host_sync_in_step``, by file and first line."""
    import ast

    from tpu_syncbn_torch.audit import srclint

    found = {}
    for tag, body in bodies.items():
        with open(body["file"]) as f:
            tree = ast.parse(f.read())
        firsts = {min([d.lineno for d in fn.decorator_list] + [fn.lineno])
                  for fn in srclint.step_body_functions(tree)}
        found[tag] = body["line"] in firsts
        if not found[tag]:
            failures.append(f"[audit/bodies] {tag}: {body['name']} at "
                            f"{body['file']}:{body['line']} is not a step body of the rule")
    log(f"[audit] gate (c) bodies: "
        + ", ".join(f"{tag} {b['name']} {os.path.relpath(b['file'])}:{b['line']} "
                    f"{'covered' if found[tag] else 'MISSED'}" for tag, b in bodies.items())
        + f" [{card}]")
    return found


def phase_audit(torch, card, scan=None, zero=None):
    """The audit's contracts of the main path on the card (ROADMAP A.14b):
    the bf16 ResNet-50 SyncBN body on the wires ``none`` and ``int8``,
    recorded while its CUDA graphs are captured, and the serving bucket's
    forward; seven gates (``_audit_wire``, ``_audit_serve``,
    ``_audit_fingerprint``), and layer 3's three on the same recordings
    (``_audit_layer3``: (d) no implicit reshard, (e) an eager body's
    recorded peak against the caching allocator's reading, (f) the K = 4
    chunk's peak against the body's). Then the source lint's three (gate
    8): the lint clean over the package here, its host-sync vocabulary
    against this card's sync debug mode, and the bodies captured above
    among the rule's step bodies. The body's peak is printed beside
    ``scan``'s graph pools and ``zero``'s held bytes when given. Returns
    (failures, summary)."""
    from tpu_syncbn_torch.ops import quant_int8 as Q
    from tpu_syncbn_torch.ops import triton_bn as T

    t0 = time.perf_counter()
    failures: list = []
    wires = {}
    for wire in ("none", "int8"):
        dp, wires[wire] = _audit_wire(torch, T, Q, wire, card, failures)
        if wire == "none":
            del dp
            torch.cuda.empty_cache()
    serve_out = _audit_serve(torch, T, dp, card, failures)  # the int8 trainer's model
    del dp
    peak = wires["none"]["layer3"]["k1"]["peak_bytes_per_device"]
    res = (scan or {}).get("resnet50") or {}
    held = (zero or {}).get("held_bytes") or {}
    beside = [f"[scan]'s K={k[1:]} graph pool {v['pool_bytes'] / 2**30:.3f} GiB"
              for k, v in res.items() if isinstance(v, dict) and "pool_bytes" in v]
    beside += [f"[zero]'s {k} parameters and optimizer state held {held[k] / 2**30:.3f} GiB"
               for k in ("replicated", "zero") if k in held]
    log(f"[audit] the bf16 ResNet-50 body's recorded peak {peak / 2**30:.3f} GiB; "
        f"{'; '.join(beside) or 'no [scan] or [zero] figures in this run'} [{card}]")
    fp = _audit_fingerprint(failures)
    t_lint = time.perf_counter()
    lint = _audit_lint(card, failures)
    sync = _audit_sync_vocabulary(torch, card, failures)
    bodies = _audit_body_coverage(
        {**{f"trainer/{w}": wires[w]["body"] for w in wires},
         f"serve/bucket{AUDIT_BUCKET}": serve_out["body"]}, card, failures)
    lint_s = time.perf_counter() - t_lint
    secs = time.perf_counter() - t0
    launches = {k: sum(w["launches"][k] for w in wires.values())
                + serve_out["launches"].get(k, 0) for k in (*MOVES, *QUANT_KERNELS)}
    log(f"[audit] phase done in {secs:.1f}s ({lint_s:.2f}s of it gates (a)-(c)), "
        f"{len(failures)} failures [{card}]")
    return failures, {"wires": wires, "serve": serve_out, **fp, "seconds": secs,
                      "launches": launches,
                      "srclint": {**lint, "sync": sync, "bodies": bodies,
                                  "gates_s": lint_s}}


def _resilience_chunks(torch, n_chunks, seed, poison=None):
    from tpu_syncbn_torch.parallel import scan_driver
    from tpu_syncbn_torch.testing import faults

    steps = [_trainer_batch(torch, seed + i) for i in range(n_chunks * RES_K)]
    if poison is not None:
        steps = list(faults.poison_nan(steps, poison))
    return [scan_driver.stack_batches(steps[i:i + RES_K])
            for i in range(0, len(steps), RES_K)]


def _params_sum(torch, model) -> float:
    return float(sum(p.detach().double().sum() for p in model.parameters()))


def _resilience_child(d: str) -> int:
    """``chip_smoke.py --resilience-child DIR``: the full-width ResNet
    slice under ResilientLoop(scan_steps=4, async checkpoints), SIGTERM
    delivered before the second chunk; prints the summary and the sum of
    the parameters as its last line."""
    sys.path.insert(0, HERE)
    import torch

    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.testing import faults

    model, dp = _resnet_trainer(torch)
    chunks = _resilience_chunks(torch, RES_CHUNKS, 500)
    with runtime.ResilientLoop(dp, d, ckpt_every=100, scan_steps=RES_K,
                               async_checkpoint=True) as loop:
        summary = loop.run(faults.signal_at(iter(chunks), at_step=1))
    summary["params_sum"] = _params_sum(torch, model)
    print(json.dumps(summary), flush=True)
    return 0


def phase_resilience(torch, card):
    """ResilientLoop over the full-width ResNet slice with scan_steps=4 and
    async checkpoints: a NaN step restored from the last good checkpoint;
    SIGTERM in a child process checkpointing at the chunk boundary and
    exiting 0, then resumed here. Returns (failures, summary)."""
    import tempfile

    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    failures, out = [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resilience_") as d:
        model, dp = _resnet_trainer(torch, divergence_guard="restore_last_good")
        # step 5 (inside the second chunk) sees NaN images
        chunks = _resilience_chunks(torch, RES_CHUNKS, 400, poison=RES_K + 1)
        t1 = time.perf_counter()
        with runtime.ResilientLoop(dp, os.path.join(d, "nan"), ckpt_every=RES_K,
                                   keep=5, scan_steps=RES_K, async_checkpoint=True) as loop:
            summary = loop.run(iter(chunks))
        kept = ckpt.verified_steps(os.path.join(d, "nan"))
        finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
        ok = (summary["divergence_restores"] == 1 and summary["nonfinite_steps"] == 1
              and summary["steps"] == RES_CHUNKS * RES_K and summary["step"] == 2 * RES_K
              and kept == [RES_K, 2 * RES_K] and finite)
        log(f"[resilience] restore_last_good, {RES_CHUNKS} chunks of {RES_K} with NaN "
            f"images at step {RES_K + 2}: {json.dumps(summary)}; verified checkpoints "
            f"{kept}; parameters finite {finite}; {time.perf_counter() - t1:.1f}s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("[resilience] the NaN chunk was not restored from the last "
                            "good checkpoint")
        out["nan_restore"] = summary
        del dp, model
        torch.cuda.empty_cache()

        pre = os.path.join(d, "preempt")
        t1 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                            "--resilience-child", pre], cwd=HERE,
                           env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
                           text=True, timeout=600)
        child_s = time.perf_counter() - t1
        lines = r.stdout.strip().splitlines()
        child = json.loads(lines[-1]) if r.returncode == 0 and lines else None
        kept = ckpt.verified_steps(pre)
        log(f"[resilience] SIGTERM child: exit {r.returncode} in {child_s:.1f}s, summary "
            f"{json.dumps(child)}; verified checkpoints {kept}")
        if child is None or not child["preempted"] or child["step"] != 2 * RES_K \
                or kept != [2 * RES_K]:
            failures.append(f"[resilience] SIGTERM child: exit {r.returncode} "
                            f"{r.stderr[-2000:]}")
        else:
            model, dp = _resnet_trainer(torch)
            with runtime.ResilientLoop(dp, pre, scan_steps=RES_K) as loop:
                resumed = loop.resume()
                same = _params_sum(torch, model) == child["params_sum"]
                more = loop.run(iter(_resilience_chunks(torch, 1, 600)))
            ok = resumed == 2 * RES_K and same and more["step"] == 3 * RES_K
            log(f"[resilience] resumed at step {resumed} (want {2 * RES_K}), parameters "
                f"equal the child's at its exit: {same}; one more chunk to step "
                f"{more['step']} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("[resilience] the resume did not continue from the "
                                "preemption boundary")
            del dp, model
        out["preempt"] = child
    log(f"[resilience] phase done in {time.perf_counter() - t0:.1f}s, "
        f"{len(failures)} failures [{card}]")
    return failures, out


# -- phases 14-17: the attention kernels and the transformer LM -------------

BF16_FLOPS_PER_S = 989e12  # H100 SXM tensor cores, dense (data sheet)
ATTN_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
# the causal Pallas kernel each CUDA kernel replaces on the LM path (the
# rectangular ones, pallas_attention.py:118, :412, :450, are its
# causal=false instantiation)
ATTN_REPLACES = {"flash_fwd": "tpu_syncbn/ops/pallas_attention.py:161",
                 "flash_bwd_dkdv": "tpu_syncbn/ops/pallas_attention.py:497",
                 "flash_bwd_dq": "tpu_syncbn/ops/pallas_attention.py:533"}
# matrix products per kernel, each 2*D operations per (query, key) pair:
# S and PV; S, dV, dP and dK; S, dP and dQ
ATTN_PRODUCTS = {"flash_fwd": 2, "flash_bwd_dkdv": 4, "flash_bwd_dq": 3}
# per call: (B, L, H, D) operands read, written; (B*H, L) f32 rows moved
ATTN_MOVES = {"flash_fwd": (3, 1, 1), "flash_bwd_dkdv": (4, 2, 2),
              "flash_bwd_dq": (4, 1, 2)}

# the LM slice: the repo's own long attention case (tpu_validation.py:355,
# 363-364: 8 heads x 64, bf16, L 8192); d_ff, vocab and depth follow GPT-2
# (assumed, PERF.md); the example's Adam lr (longcontext_train.py:49)
LM_CFG = dict(vocab=50257, d_model=512, n_heads=8, n_layers=8, d_ff=2048,
              max_len=8192)
LM_BATCH, LM_STEPS, LM_LR = 2, 6, 3e-3
ATTN_SHAPE = (LM_BATCH, LM_CFG["max_len"], LM_CFG["n_heads"],
              LM_CFG["d_model"] // LM_CFG["n_heads"])
ATTN_PARITY_SHAPES = [ATTN_SHAPE, (1, 2048, 8, 64), (1, 1000, 8, 64),
                      (1, 2048, 16, 128), (4, 512, 8, 8)]
# the kernels whose bf16 path is the TMA + wgmma design, and the opcodes
# that show it in their machine code
HOPPER_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
SASS_OPS = ("HGMMA", "UTMALDG")

# |kernel - plain| per element, by output kind:
#  * float32 kernels vs a float64 plain run: the repo's on-card gate
#    (benchmarks/tpu_validation.py:269,294) — outputs 2e-4, gradients
#    5e-4; the logsumexp 2e-4 (float32 in every case);
#  * bfloat16 kernels vs the plain version on the same bf16 inputs: the
#    kernels round P (and dS) to bf16, unit roundoff 2^-8, before the sums
#    that the plain version makes in f32 (o = sum_j P_ij v_j, dv = sum_i
#    P_ij dO_i, dk = sum_i dS_ij q_i, dq = sum_j dS_ij k_j), so an
#    element's error is ~2^-8/sqrt(3) of the root sum of squares of its
#    terms, however far the terms cancel (the dS of a query row sum to 0,
#    and the LM's values, keys and queries share a common part). Limit:
#    2^-5 of that root sum of squares (14 of those standard deviations);
#    plus 2^-6|x| for the final rounding of both sides to bf16, half an
#    ulp each, where at a power of two one side's ulp is twice the
#    other's (3 * 2^-8|x| at most); plus 2^-12 of the tensor's RMS, so a
#    limit is never 0. dS = P (dP - delta) is a difference of two f32 dot
#    products that both sides round apart, by up to D * 2^-24 of
#    |dO_i| |v_j|: its magnitude in the terms is never taken below 2^-11
#    of P |dO_i| |v_j| (2^-5 of that covers both sides' rounding up to
#    D = 128), which matters only where dS is itself rounding noise (the
#    first causal row of dq, where P = 1 and dP = delta). The limit follows
#    each element's own terms, so a fault in the late, small rows of a long
#    causal call fails it.
BF16_TERMS, BF16_RTOL, BF16_FLOOR, DS_F32 = 2 ** -5, 2 ** -6, 2 ** -12, 2 ** -11
F32_TOL = {"out": 2e-4, "grad": 5e-4, "lse": 2e-4}


# -- [obs]: the observability slice ------------------------------------------

OBS_K, OBS_TIMED, OBS_PUBLISHED = 4, 4, 8
#: the keys every monitors=True ResNet-50 step must return
OBS_KEYS = {"grad_norm", "grad_nonfinite", "state_nonfinite", "bn_layers",
            "bn_mean_max_abs", "bn_var_max", "bn_var_min", "bn_mean_skew",
            "bn_var_skew", "bn_skew_layers", "replica_grad_norm",
            "replica_grad_norm_disp"}
OBS_GRAD_NORM_TOL = 1e-3  # relative, against a float64 host recompute


def _obs_step_checks(torch, dp, model, steps, failures) -> dict:
    """One eager step: the key set, every monitor on the card, the layer
    count, and ``grad_norm`` against the step's own gradients in float64."""
    mon = dp.train_step(steps[0]).monitors
    on_card = all(v.is_cuda for v in mon.values())
    missing = sorted(OBS_KEYS - set(mon))
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    want = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    got = float(mon["grad_norm"])
    rel = abs(got - want) / want
    layers = float(mon["bn_layers"])
    ok = on_card and not missing and layers == BN_LAYERS and rel <= OBS_GRAD_NORM_TOL
    log(f"[obs] monitor keys {sorted(mon)}; every one a CUDA tensor: {on_card}; "
        f"missing {missing}; bn_layers {layers:.0f} (want {BN_LAYERS}); grad_norm "
        f"{got:.6f} against {want:.6f} in float64 from the step's {len(grads)} "
        f"gradients, rel {rel:.2e} (tol {OBS_GRAD_NORM_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[obs] monitors: keys missing {missing}, on card {on_card}, "
                        f"bn_layers {layers}, grad_norm rel {rel:.2e}")
    return {"keys": sorted(mon), "grad_norm_rel_err": rel}


def _obs_chunk_vs_body(torch, dp, steps, failures) -> bool:
    """A captured K-step chunk with monitors from the trainer's state,
    against the same body run eagerly from that state (cuDNN
    deterministic): losses, every state tensor and every monitor bitwise."""
    from tpu_syncbn_torch.parallel import scan_driver

    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        start = dp.state_dict()
        stacked = scan_driver.stack_batches(steps[:OBS_K])
        out = dp.train_steps_batches(stacked)
        st_c = _split_state(torch, dp.state_dict())
        _restore_in_place(torch, dp, start)
        looped = _program(dp, OBS_K).loop(stacked)
        st_l = _split_state(torch, dp.state_dict())
    finally:
        torch.backends.cudnn.deterministic = determ
    mon_l = {k[1]: v for k, v in looped.items() if isinstance(k, tuple) and k[0] == "mon"}
    same_mon = set(mon_l) == set(out.monitors) and all(
        torch.equal(out.monitors[k], mon_l[k]) for k in mon_l)
    same_state = all(torch.equal(st_c[part][k], st_l[part][k])
                     for part in st_l for k in st_l[part])
    same_loss = torch.equal(out.loss, looped["loss"])
    ok = same_mon and same_state and same_loss
    shapes = {tuple(v.shape) for v in out.monitors.values()}
    log(f"[obs] captured K={OBS_K} chunk with monitors against its body run eagerly: "
        f"losses bitwise {same_loss}, state bitwise {same_state}, {len(mon_l)} monitors "
        f"(shapes {sorted(shapes)}) bitwise {same_mon} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("[obs] the captured chunk with monitors is not bitwise its body")
    return ok


def _obs_int8(torch, steps, failures) -> dict:
    """One ``compress="int8"`` step: the wire's health monitors in range."""
    _, dp = _resnet_trainer(torch, compress="int8")
    mon = dp.train_step(steps[0]).monitors
    vals = {k: float(mon[k]) for k in ("clip_fraction", "overflow_headroom",
                                       "ef_residual_ratio") if k in mon}
    ok = (len(vals) == 3 and 0.0 <= vals["clip_fraction"] <= 1.0
          and 0.0 <= vals["overflow_headroom"] <= 1.0
          and math.isfinite(vals["ef_residual_ratio"]))
    log(f"[obs] int8 step: {json.dumps(vals)} (clip fraction and headroom in [0, 1]) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[obs] int8 monitors {vals}")
    return vals


def _obs_publisher(torch, dp, steps, failures) -> dict:
    """``NumericsPublisher`` over the 8 steps of two captured chunks, each
    step's monitors published as they come: no ``torch.cuda.synchronize``
    (counted through a wrapper), each chunk's publishes returning while its
    work is still pending, and ``flush()`` publishing the rest."""
    from tpu_syncbn_torch.obs import numerics, telemetry
    from tpu_syncbn_torch.parallel import scan_driver

    stacked = scan_driver.stack_batches(steps[:OBS_K])
    pub = numerics.NumericsPublisher()
    syncs = [0]
    real_sync = torch.cuda.synchronize

    def counting_sync(*a, **kw):
        syncs[0] += 1
        return real_sync(*a, **kw)

    telemetry.REGISTRY.reset()
    telemetry.set_enabled(True)
    pending_at_return, step, publish_ms = [], 0, 0.0
    torch.cuda.synchronize = counting_sync
    try:
        for _ in range(OBS_PUBLISHED // OBS_K):
            out = dp.train_steps_batches(stacked)
            done = torch.cuda.Event()
            done.record()
            t0 = time.perf_counter()
            for i in range(OBS_K):
                step += 1
                pub.publish(step, {k: v[i] for k, v in out.monitors.items()})
            publish_ms = (time.perf_counter() - t0) * 1e3
            pending_at_return.append(not done.query())
    finally:
        torch.cuda.synchronize = real_sync
    before_flush = pub.published
    flushed = pub.flush()
    samples = telemetry.snapshot()["counters"].get("numerics.samples", 0)
    telemetry.set_enabled(None)
    ok = (syncs[0] == 0 and all(pending_at_return) and pub.published == OBS_PUBLISHED
          and samples == OBS_PUBLISHED)
    log(f"[obs] publisher: {OBS_PUBLISHED} steps published from 2 captured chunks, "
        f"torch.cuda.synchronize calls {syncs[0]} (want 0), the chunk's work still "
        f"pending when its publishes returned: {pending_at_return} (the last chunk's "
        f"{OBS_K} publishes {publish_ms:.3f} ms), {before_flush} landed before flush(), "
        f"flush() {flushed}, numerics.samples {samples} (want {OBS_PUBLISHED}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[obs] publisher: {syncs[0]} synchronizes, pending "
                        f"{pending_at_return}, published {pub.published}, samples {samples}")
    return {"synchronizes": syncs[0], "pending_at_return": pending_at_return,
            "published_before_flush": before_flush, "flushed": flushed,
            "publish_ms": publish_ms}


#: card tests run alone, each in a fresh process (its kernels' first
#: launches and its first page-locked allocation the process's own):
#: (name, gated)
OBS_ALONE = (
    "test_first_publish_and_record_behind_queued_work_return_at_once",
    "test_numerics_publisher_waits_on_the_event_not_the_host",
)


def _obs_publisher_alone(failures) -> dict:
    """The publisher's and recorder's card tests alone in fresh processes
    (``-k``), where their page-locked blocks and kernel launches are the
    process's first: the first publish and record behind queued work must
    still return at once (both take their blocks and launch their kernels
    when built, and each test launches its own kernels before its sleep).
    The two processes run side by side (``_side_by_side``: each is start-up
    bound), each test still alone in its own."""
    out = {}
    t0 = time.perf_counter()
    runs = _side_by_side({name: [sys.executable, "-m", "pytest", "tests/test_torch_gpu.py",
                                 "--noconftest", "-m", "gpu", "-q", "-p", "no:cacheprovider",
                                 "-k", name] for name in OBS_ALONE})
    secs = time.perf_counter() - t0
    for name, r in runs.items():
        lines = r.stdout.strip().splitlines()
        tail = lines[-1] if lines else ""
        ok = r.returncode == 0 and tail.startswith("1 passed")
        log(f"[obs] {name} alone in a fresh process (-k): exit {r.returncode}, {tail!r}; "
            f"the two side by side in {secs:.1f}s {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"[obs] {name} alone: {r.stdout[-1500:]} {r.stderr[-500:]}")
        out[name] = {"exit": r.returncode, "summary": tail}
    return out


def _obs_exports(torch, T, dp, steps, failures) -> dict:
    """8 ``ResilientLoop`` steps with telemetry on and a tracer installed
    (every BN kernel counted from 0): the registry's JSONL export and the
    Chrome trace, validated, with the loop's spans and gauge."""
    import shutil
    import tempfile

    from tpu_syncbn_torch.obs import telemetry, tracing
    from tpu_syncbn_torch.runtime.resilience import ResilientLoop

    d = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    telemetry.REGISTRY.reset()
    telemetry.set_enabled(True)
    tracer = tracing.install()
    try:
        T.reset_launch_counts()
        loop = ResilientLoop(dp, os.path.join(d, "ckpt"), ckpt_every=OBS_PUBLISHED)
        summary = loop.run([steps[i % len(steps)] for i in range(OBS_PUBLISHED)])
        torch.cuda.synchronize()
        launches = T.launch_counts()
        jsonl = telemetry.REGISTRY.export_jsonl(os.path.join(d, "telemetry.jsonl"))
        trace = tracer.save(os.path.join(d, "trace.json"))
        merged = telemetry.validate_snapshot(telemetry.merge_exports([jsonl]))
        events = tracing.validate_trace(tracing.load_trace(trace))
        sizes = (os.path.getsize(jsonl), os.path.getsize(trace))
    finally:
        tracing.uninstall()
        telemetry.set_enabled(None)
        shutil.rmtree(d, ignore_errors=True)
    names = {e["name"] for e in events}
    spans = {n: sum(e["name"] == n for e in events) for n in ("step", "data_wait")}
    gauge = merged["gauges"].get("train.step")
    steps_timed = merged["histograms"].get("step.time_s", {}).get("count")
    want = dict.fromkeys(MOVES, BN_LAYERS * OBS_PUBLISHED)
    ok = (summary["steps"] == OBS_PUBLISHED and spans["step"] == OBS_PUBLISHED
          and spans["data_wait"] >= OBS_PUBLISHED and gauge == OBS_PUBLISHED
          and steps_timed == OBS_PUBLISHED and launches == want)
    log(f"[obs] ResilientLoop {summary['steps']} steps: JSONL export {sizes[0]} B "
        f"({len(merged['counters'])} counters, {len(merged['gauges'])} gauges, "
        f"{len(merged['histograms'])} histograms) and Chrome trace {sizes[1]} B "
        f"({len(events)} events) validate; spans {json.dumps(spans)}, checkpoint spans "
        f"{sorted(n for n in names if n.startswith('checkpoint'))}, train.step gauge "
        f"{gauge}, step.time_s samples {steps_timed}, BN launches {json.dumps(launches)} "
        f"(want {BN_LAYERS} x {OBS_PUBLISHED} each) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[obs] exports: spans {spans}, gauge {gauge}, launches {launches}")
    return {"launches": launches, "spans": spans, "events": len(events),
            "counters": len(merged["counters"]), "histograms": len(merged["histograms"])}


def _obs_host_ms(torch, dp, steps, card) -> float:
    """The host time the monitors' own calls take in an eager step: every
    monitor function wrapped with the host clock over 8 steps (a direct
    reading, free of the step-to-step spread of the shared host)."""
    from tpu_syncbn_torch.obs import numerics, stepstats

    spent = [0.0]
    wrapped = [(stepstats, "grad_monitors"), (stepstats, "state_health"),
               (numerics, "grad_norm_scalar"), (numerics, "cross_replica_monitors"),
               (numerics.Collector, "summary")]
    saved = [getattr(m, n) for m, n in wrapped]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return call

    for (m, n), fn in zip(wrapped, saved):
        setattr(m, n, timed(fn))
    try:
        for i in range(8):
            dp.train_step(steps[i % len(steps)])
    finally:
        for (m, n), fn in zip(wrapped, saved):
            setattr(m, n, fn)
    ms = spent[0] * 1e3 / 8
    log(f"[obs] the monitor functions' own host time in an eager step: {ms:.3f} ms "
        f"(host clock around each call, mean of 8 steps) [{card}]")
    return ms


def _obs_paired_eager(torch, dp, steps, card) -> dict:
    """The eager step with monitors on and off on ONE trainer, toggled every
    step (on, off, off, on, ... 16 steps each way): adjacent steps share the
    host's state, so the median difference is far less spread than two
    trainers timed in turns."""
    times = {True: ([], []), False: ([], [])}
    for i, mon in enumerate([True, False, False, True] * 8):
        dp.monitors = mon
        host, dev, _ = _timed_calls(torch, lambda: dp.train_step(steps[i % len(steps)]), 1)
        times[mon][0].extend(host)
        times[mon][1].extend(dev)
    dp.monitors = True
    med = {f"{'on' if mon else 'off'}_{kind}_ms": statistics.median(v)
           for mon, (h, d) in times.items() for kind, v in (("host", h), ("dev", d))}
    log(f"[obs] eager, monitors toggled every step on one trainer (16 steps each way, "
        f"medians): on {med['on_host_ms']:.3f} / {med['on_dev_ms']:.3f} ms, off "
        f"{med['off_host_ms']:.3f} / {med['off_dev_ms']:.3f} ms (host clock / CUDA events): "
        f"{med['on_host_ms'] - med['off_host_ms']:+.3f} / "
        f"{med['on_dev_ms'] - med['off_dev_ms']:+.3f} ms a step [{card}]")
    return med


def phase_obs(torch, card):
    """Phase 13b (module docstring): the monitors' keys and values, the
    captured chunk, the publisher, the exports, the int8 wire's monitors,
    then the monitors' cost in turns."""
    from tpu_syncbn_torch.ops import triton_bn as T

    t_phase = time.perf_counter()
    failures: list = []
    steps = [_trainer_batch(torch, 900 + i) for i in range(OBS_K)]
    model, dp = _resnet_trainer(torch)
    out = {"step": _obs_step_checks(torch, dp, model, steps, failures)}
    out["bitwise_chunk"] = _obs_chunk_vs_body(torch, dp, steps, failures)
    out["publisher"] = _obs_publisher(torch, dp, steps, failures)
    out["publisher_alone"] = _obs_publisher_alone(failures)
    out["exports"] = _obs_exports(torch, T, dp, steps, failures)
    out["host_ms_in_monitors"] = _obs_host_ms(torch, dp, steps, card)
    out["paired_eager"] = _obs_paired_eager(torch, dp, steps, card)
    del dp, model
    torch.cuda.empty_cache()
    out["int8"] = _obs_int8(torch, steps, failures)
    torch.cuda.empty_cache()
    times = _trainers_in_turns(
        torch, "obs", {f"monitors={m}": functools.partial(_resnet_trainer, torch, monitors=m)
                       for m in (False, True)}, steps, OBS_K, OBS_TIMED, card)
    off, on = times["monitors=False"], times["monitors=True"]
    cost = {k: on[k] - off[k] for k in ("eager_host_ms", "eager_dev_ms",
                                         "captured_host_ms", "captured_dev_ms")}
    log(f"[obs] the monitors' cost a step: eager {cost['eager_host_ms']:+.3f} ms host clock, "
        f"{cost['eager_dev_ms']:+.3f} ms CUDA events; captured K={OBS_K} "
        f"{cost['captured_host_ms']:+.3f} ms host clock, {cost['captured_dev_ms']:+.3f} ms "
        f"CUDA events [{card}]")
    out.update(times=times, cost_ms=cost)
    log(f"[obs] phase done in {time.perf_counter() - t_phase:.1f}s, "
        f"{len(failures)} failures")
    return failures, out


# -- [incident]: the flight recorder, memory watermarks, compile events and
# the profiler capture (ROADMAP A.11b) on the ResNet-50 slice ----------------

INC_K = 4  # the captured chunk's steps
INC_STORM_THRESHOLD = 3  # rebuilds of one program key that make a storm
INC_SLEEP_CYCLES = int(6e8)  # ~0.3 s of device sleep (~1.98 GHz) ahead of the chunk a dump races
INC_CAPTURE_S = 1.0  # the profiler capture's duration
INC_CHUNK_PAUSE_S = 0.1  # the capture's worker: the pause after each chunk


def _bundles_by_kind(d: str) -> dict:
    """``{trigger kind: [bundle, ...]}`` of the incident bundles in ``d``,
    each loaded through ``incident.load_bundle`` (schema-validated)."""
    from tpu_syncbn_torch.obs import incident

    out: dict = {}
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        if name.startswith("incident_") and name.endswith(".json"):
            b = incident.load_bundle(os.path.join(d, name))
            out.setdefault(b["trigger"]["kind"], []).append(b)
    return out


def _finite_entry(e: dict) -> bool:
    vals = [e["metrics"].get("loss")] + list(e["monitors"].values())
    return bool(e["monitors"]) and all(
        isinstance(v, float) and math.isfinite(v) for v in vals)


def _incident_nan_restore(torch, d, failures, keep=None) -> dict:
    """Gate 1: a NaN step under ``ResilientLoop(scan_steps=4)`` with the
    recorder and the sampler installed gives exactly one
    ``divergence_restore`` bundle, valid, whose step ring holds finite loss
    and monitors for the steps before the fault. With ``keep`` (a dict) the
    guarded trainer and its warm K = 4 program are handed on to
    ``[monitor]`` instead of dropped."""
    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.obs import flightrec, memwatch

    model, dp = _resnet_trainer(torch, divergence_guard="restore_last_good")
    chunks = _resilience_chunks(torch, RES_CHUNKS, 400, poison=RES_K + 1)
    fault = RES_K + 2  # the poisoned step
    rec = flightrec.install(flightrec.FlightRecorder(
        incident_dir=os.path.join(d, "nan"), cooldown_s=0.0))
    sampler = memwatch.install(memwatch.MemorySampler(interval_s=0.01))
    t0 = time.perf_counter()
    try:
        with runtime.ResilientLoop(dp, os.path.join(d, "ckpt"), ckpt_every=RES_K,
                                   keep=5, scan_steps=INC_K) as loop:
            summary = loop.run(iter(chunks))
    finally:
        memwatch.uninstall()
        sampler.close()
        flightrec.uninstall()
        rec.close()
    kinds = _bundles_by_kind(rec.incident_dir)
    restores = kinds.get("divergence_restore", [])
    before = [e for b in restores for e in b["rings"]["steps"] if e["step"] < fault]
    mem_ring = sum(len(b["rings"]["mem"]) for b in restores)
    ok = (len(restores) == 1 and summary["divergence_restores"] == 1 and before
          and all(_finite_entry(e) for e in before))
    log(f"[incident] NaN at step {fault} under ResilientLoop(scan_steps={INC_K}) with the "
        f"recorder and the sampler ({sampler.samples} samples): bundles by trigger "
        f"{ {k: len(v) for k, v in kinds.items()} } (want one divergence_restore), valid; "
        f"its step ring {[e['step'] for b in restores for e in b['rings']['steps']]}, the "
        f"entries before the fault finite (loss and {len(before[0]['monitors']) if before else 0} "
        f"monitors): {bool(before) and all(_finite_entry(e) for e in before)}; mem ring "
        f"{mem_ring} samples; {time.perf_counter() - t0:.1f}s {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[incident] NaN restore: bundles {list(kinds)}, ring before the "
                        f"fault {before}")
    if keep is not None:
        keep.update(model=model, dp=dp)
    del dp, model
    torch.cuda.empty_cache()
    return {"bundles": {k: len(v) for k, v in kinds.items()}, "ring_before_fault": len(before),
            "mem_ring": mem_ring, "summary": summary}


class _FlaggedGraph:
    """Wraps ``torch.cuda.graph`` so a thread can tell that a capture is
    open (the flag is set from its entry to its exit)."""

    def __init__(self, torch, flag):
        self._graph, self._flag = torch.cuda.graph, flag

    def __call__(self, *a, **kw):
        ctx, flag = self._graph(*a, **kw), self._flag

        class Ctx:
            def __enter__(self):
                flag.set()
                return ctx.__enter__()

            def __exit__(self, *exc):
                try:
                    return ctx.__exit__(*exc)
                finally:
                    flag.clear()

        return Ctx()


def _incident_sampler_beside_capture(torch, dp, steps, failures) -> dict:
    """Gate 3: the memory sampler's thread samples at a short interval
    while ``scan_driver`` captures a K = 4 graph; the capture succeeds and
    replays bitwise its body (cuDNN deterministic, as in ``[scan]``); then
    one sample's gauges equal ``memory_allocated`` / ``max_memory_allocated``."""
    import threading

    from tpu_syncbn_torch.obs import memwatch, telemetry
    from tpu_syncbn_torch.parallel import scan_driver

    capturing, during = threading.Event(), [0]

    def reader():
        if capturing.is_set():
            during[0] += 1
        return memwatch.device_readings()

    sampler = memwatch.MemorySampler(interval_s=0.001, device_reader=reader,
                                     pressure_threshold=None)
    stacked = scan_driver.stack_batches(steps[:INC_K])
    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    real_graph = torch.cuda.graph
    torch.cuda.graph = _FlaggedGraph(torch, capturing)
    try:
        start = dp.state_dict()
        sampler.start()
        out = dp.train_steps_batches(stacked)  # the capture
        sampler.close()
        torch.cuda.graph = real_graph
        st_c = _split_state(torch, dp.state_dict())
        _restore_in_place(torch, dp, start)
        looped = _program(dp, INC_K).loop(stacked)
        st_l = _split_state(torch, dp.state_dict())
    finally:
        torch.cuda.graph = real_graph
        sampler.close()
        torch.backends.cudnn.deterministic = determ
    mon_l = {k[1]: v for k, v in looped.items() if isinstance(k, tuple) and k[0] == "mon"}
    bitwise = (torch.equal(out.loss, looped["loss"])
               and all(torch.equal(st_c[p][k], st_l[p][k]) for p in st_l for k in st_l[p])
               and set(mon_l) == set(out.monitors)
               and all(torch.equal(out.monitors[k], mon_l[k]) for k in mon_l))
    torch.cuda.synchronize()
    telemetry.REGISTRY.reset()
    telemetry.set_enabled(True)
    r = sampler.sample()
    alloc, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    gauges = telemetry.snapshot()["gauges"]
    telemetry.set_enabled(None)
    same = (r["bytes_in_use"] == alloc == gauges["mem.device.bytes_in_use"]
            and r["peak_bytes"] == peak == gauges["mem.device.peak_bytes"])
    ok = during[0] > 0 and bitwise and same
    log(f"[incident] sampler at 1 ms beside the K={INC_K} capture: {sampler.samples} samples, "
        f"{during[0]} of them while the graph was being captured; the capture replays "
        f"bitwise its body (losses, state, {len(mon_l)} monitors): {bitwise}; one sample's "
        f"mem.device.bytes_in_use {r['bytes_in_use']} / peak_bytes {r['peak_bytes']} against "
        f"memory_allocated {alloc} / max_memory_allocated {peak}: {same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[incident] sampler beside the capture: {during[0]} samples during "
                        f"it, bitwise {bitwise}, gauges equal {same}")
    return {"samples": sampler.samples, "during_capture": during[0], "bitwise": bitwise,
            "bytes_in_use": r["bytes_in_use"], "peak_bytes": r["peak_bytes"]}


def _incident_dump_mid_chunk(torch, dp, steps, d, failures) -> dict:
    """Gate 2: a manual trigger fired from the loop's data fetch while the
    captured chunk just dispatched is still running (a device sleep queued
    ahead of it): the dump returns with no ``torch.cuda.synchronize`` call,
    and each of that chunk's ring values reads ``"pending"`` or its own
    step's value, never a later one."""
    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.obs import flightrec, incident, telemetry
    from tpu_syncbn_torch.parallel import scan_driver

    stacked = [scan_driver.stack_batches(steps[:INC_K])] * 3
    rec = flightrec.install(flightrec.FlightRecorder(
        incident_dir=os.path.join(d, "mid"), cooldown_s=0.0))
    telemetry.REGISTRY.reset()
    telemetry.set_enabled(True)
    want, probe = {}, {}
    real_chunk = dp.train_steps_batches
    real_sync = torch.cuda.synchronize
    syncs = [0]

    def counting_sync(*a, **kw):
        syncs[0] += 1
        return real_sync(*a, **kw)

    def chunk(batch):
        out = real_chunk(batch)
        step = dp_step[0] = dp_step[0] + INC_K
        # the chunk-final values, cloned on the stream for the check below
        want[step] = {"loss": out.loss[-1].clone(),
                      **{k: v[-1].clone() for k, v in out.monitors.items()}}
        return out

    dp_step = [0]

    def batches():
        for i, b in enumerate(stacked):
            if i == 1:  # the chunk before this one was dispatched behind the sleep
                done = torch.cuda.Event()
                done.record()
                torch.cuda.synchronize = counting_sync
                try:
                    t0 = time.perf_counter()
                    probe["path"] = flightrec.trigger("manual", {"source": "chip_smoke"},
                                                      force=True)
                    probe["dump_s"] = time.perf_counter() - t0
                finally:
                    torch.cuda.synchronize = real_sync
                probe["running"] = not done.query()
            if i == 0:
                torch.cuda._sleep(INC_SLEEP_CYCLES)
            yield b

    dp.train_steps_batches = chunk
    try:
        with runtime.ResilientLoop(dp, os.path.join(d, "mid_ckpt"), ckpt_every=1000,
                                   scan_steps=INC_K) as loop:
            loop.run(batches())
        torch.cuda.synchronize()
        late = rec.rings_snapshot()["steps"]
    finally:
        del dp.train_steps_batches
        flightrec.uninstall()
        rec.close()
        telemetry.set_enabled(None)
    bundle = incident.load_bundle(probe["path"]) if probe.get("path") else None
    entries = bundle["rings"]["steps"] if bundle else []
    pending = sum(v == flightrec.PENDING for e in entries
                  for v in list(e["metrics"].values()) + list(e["monitors"].values()))

    def own(e):  # every value pending or this step's own
        w = want[e["step"]]
        vals = {"loss": e["metrics"]["loss"], **e["monitors"]}
        return set(vals) == set(w) and all(
            v == flightrec.PENDING or v == float(w[k].double()) for k, v in vals.items())

    landed = all(own(e) and _finite_entry(e) for e in late)
    ok = (bundle is not None and syncs[0] == 0 and probe["running"]
          and all(own(e) for e in entries) and landed and len(late) == len(stacked))
    log(f"[incident] manual dump from the loop's fetch while the K={INC_K} chunk of step "
        f"{INC_K} was still running ({INC_SLEEP_CYCLES:.0e} cycles of device sleep ahead of it; running at "
        f"return: {probe.get('running')}): torch.cuda.synchronize calls {syncs[0]} (want 0), "
        f"dump {probe.get('dump_s', 0) * 1e3:.3f} ms, {os.path.getsize(probe['path']) if bundle else 0} "
        f"B; its ring {[e['step'] for e in entries]} holds {pending} pending values and "
        f"otherwise each step's own: {all(own(e) for e in entries)}; after the run every "
        f"entry landed with its own step's values: {landed} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[incident] dump mid-chunk: {syncs[0]} synchronizes, running "
                        f"{probe.get('running')}, entries {entries}")
    return {"synchronizes": syncs[0], "running_at_return": probe.get("running"),
            "dump_s": probe.get("dump_s"),
            "bundle_bytes": os.path.getsize(probe["path"]) if bundle else None,
            "pending_values": pending, "entries": len(entries)}


def _incident_pressure(torch, dp, steps, d, failures) -> dict:
    """Gate 4: a contract at half the eager step's measured steady peak;
    the sampler's thread, at a short interval over three eager steps, trips
    and fires exactly one ``mem_pressure`` bundle (the recorder's cooldown
    takes the rest), carrying the mem ring."""
    from tpu_syncbn_torch.obs import flightrec, memwatch, telemetry

    dp.train_step(steps[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dp.train_step(steps[1])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    contract = peak // 2
    telemetry.REGISTRY.reset()
    telemetry.set_enabled(True)
    rec = flightrec.FlightRecorder(incident_dir=os.path.join(d, "pressure"))
    sampler = memwatch.MemorySampler(interval_s=0.002, contract_bytes_per_device=contract,
                                     contract_source="half_steady_peak", recorder=rec)
    try:
        sampler.start()
        for i in range(3):
            dp.train_step(steps[i % len(steps)])
        torch.cuda.synchronize()
        sampler.close()
        trips = telemetry.snapshot()["counters"].get("mem.pressure_trips", 0)
    finally:
        sampler.close()
        rec.close()
        telemetry.set_enabled(None)
    kinds = _bundles_by_kind(rec.incident_dir)
    got = kinds.get("mem_pressure", [])
    ring = got[0]["rings"]["mem"] if got else []
    ok = (list(kinds) == ["mem_pressure"] and len(got) == 1 and trips >= 1 and ring
          and ring[-1]["used_frac"] > memwatch.DEFAULT_PRESSURE_THRESHOLD
          and ring[-1]["contract_source"] == "half_steady_peak")
    log(f"[incident] contract {contract} B = half the eager step's steady peak {peak} B: "
        f"{sampler.samples} samples at 2 ms over 3 eager steps, {trips} pressure trips, "
        f"bundles {[(k, len(v)) for k, v in kinds.items()]} (want one mem_pressure), its mem "
        f"ring {len(ring)} samples ending at used_frac "
        f"{ring[-1]['used_frac'] if ring else None} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[incident] mem_pressure: bundles {list(kinds)}, trips {trips}")
    return {"contract_bytes": contract, "steady_peak_bytes": peak, "trips": trips,
            "bundles": len(got), "mem_ring": len(ring), "samples": sampler.samples}


def _incident_storm(torch, d, failures) -> dict:
    """Gate 5: one ``ProgramCache`` key rebuilt ``threshold`` times (two keys
    through one slot; each build captures a small CUDA graph) gives one
    ``recompile_storm`` bundle and ``compile.storms == 1``; as many distinct
    keys give none."""
    from tpu_syncbn_torch.obs import flightrec, profiling, telemetry
    from tpu_syncbn_torch.parallel import scan_driver

    def build():
        x = torch.zeros(1024, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            x.add_(1)
        return g

    telemetry.REGISTRY.reset()
    telemetry.set_enabled(True)
    rec = flightrec.install(flightrec.FlightRecorder(
        incident_dir=os.path.join(d, "storm"), cooldown_s=0.0))
    prev = profiling.set_detector(profiling.RecompileDetector(
        window_s=600.0, threshold=INC_STORM_THRESHOLD))
    try:
        churn = scan_driver.ProgramCache(name="incident", max_entries=1)
        for key in ("a", "b") * (INC_STORM_THRESHOLD - 1) + ("a",):
            scan_driver.cached_program(churn, key, build).replay()
        warm = scan_driver.ProgramCache(name="incident_warm", max_entries=8)
        for key in range(INC_STORM_THRESHOLD + 1):
            scan_driver.cached_program(warm, key, build).replay()
        counters = telemetry.snapshot()["counters"]
    finally:
        profiling.set_detector(prev)
        flightrec.uninstall()
        rec.close()
        telemetry.set_enabled(None)
    kinds = _bundles_by_kind(rec.incident_dir)
    storms = kinds.get("recompile_storm", [])
    ring = storms[0]["rings"]["compile"] if storms else []
    ok = (list(kinds) == ["recompile_storm"] and len(storms) == 1
          and counters.get("compile.storms") == 1
          and storms[0]["trigger"]["detail"]["compiles"] == INC_STORM_THRESHOLD)
    log(f"[incident] one ProgramCache key rebuilt {INC_STORM_THRESHOLD} times (a CUDA graph "
        f"captured a build), then {INC_STORM_THRESHOLD + 1} distinct keys: compile events "
        f"{counters.get('compile.events_total')}, compile.storms "
        f"{counters.get('compile.storms')} (want 1), bundles "
        f"{[(k, len(v)) for k, v in kinds.items()]}, its compile ring {len(ring)} events "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[incident] recompile storm: bundles {list(kinds)}, counters "
                        f"{ {k: v for k, v in counters.items() if k.startswith('compile.')} }")
    return {"events": counters.get("compile.events_total"),
            "storms": counters.get("compile.storms"), "bundles": len(storms)}


def _incident_capture(torch, dp, steps, d, failures) -> dict:
    """Gate 6: ``profiling.capture`` for about a second on this thread (the
    one Kineto registered: its CUDA side starts nowhere else) while a
    worker thread replays captured K = 4 chunks: a Chrome trace under the
    size cap holding the BN kernels' names; the worker's own capture
    meanwhile raises ``ProfilerBusy``. Every wait has a deadline."""
    import threading

    from tpu_syncbn_torch.obs import profiling
    from tpu_syncbn_torch.parallel import scan_driver

    stacked = scan_driver.stack_batches(steps[:INC_K])
    dp.train_steps_batches(stacked)  # cached: a replay
    torch.cuda.synchronize()
    root = os.path.join(d, "capture")
    stop, info = threading.Event(), {"chunks": 0, "busy": None}

    def replay():
        deadline = time.monotonic() + 60
        while not profiling._capture_lock.locked() and not stop.is_set() \
                and time.monotonic() < deadline:
            time.sleep(0.0005)
        try:
            profiling.capture(0.1, log_dir=root)
            info["busy"] = False
        except profiling.ProfilerBusy:
            info["busy"] = True
        except Exception as e:  # reported below
            info["busy"] = f"{type(e).__name__}: {e}"
        while not stop.is_set() and time.monotonic() < deadline:
            dp.train_steps_batches(stacked)
            torch.cuda.synchronize()
            info["chunks"] += 1
            # a pause a chunk: a second of back-to-back chunks is ~100k
            # kernel events, ~95 MB of trace against the 128 MiB cap
            stop.wait(INC_CHUNK_PAUSE_S)

    worker = threading.Thread(target=replay, name="incident-replay")
    worker.start()
    out, error = None, None
    try:
        out = profiling.capture(INC_CAPTURE_S, log_dir=root)
    except Exception as e:  # reported below
        error = f"{type(e).__name__}: {e}"
    finally:
        stop.set()
        worker.join(timeout=120)
    names, kernels, bn_events = set(), 0, 0
    if out is not None:
        with open(os.path.join(out["path"], "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") == "kernel":
                kernels += 1
                if _is_bn_kernel(e.get("name", "")):
                    bn_events += 1
                    names.add(e["name"])
    cap = profiling.DEFAULT_PROFILE_MAX_BYTES
    busy = info["busy"] is True
    ok = (out is not None and busy and bool(names) and out["bytes"] <= cap
          and out["device_events"] > 0 and info["chunks"] > 0 and not worker.is_alive())
    log(f"[incident] profiling.capture({INC_CAPTURE_S}) on the main thread while a worker "
        f"replayed {info['chunks']} captured K={INC_K} chunks: {error or ''}"
        f"{out['bytes'] if out else 0} B (cap {cap}), {out['device_events'] if out else 0} "
        f"device events, {kernels} kernel events, {bn_events} of the BN kernels "
        f"({sorted(names)[:6]}); the worker's capture meanwhile: "
        f"{'ProfilerBusy' if busy else info['busy']} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"[incident] capture: {error}, busy {info['busy']}, BN names "
                        f"{sorted(names)}, chunks {info['chunks']}")
    return {"seconds": out["duration_s"] if out else None, "bytes": out["bytes"] if out else None,
            "kernel_events": kernels, "bn_kernel_events": bn_events, "busy": busy,
            "chunks": info["chunks"]}


def _incident_costs(torch, dp, steps, card) -> dict:
    """``record_step``'s host cost a call on a captured chunk's final slices
    (micro-measured), against the captured step's device time; one
    sample's cost."""
    from tpu_syncbn_torch.obs import flightrec, memwatch
    from tpu_syncbn_torch.parallel import scan_driver

    stacked = scan_driver.stack_batches(steps[:INC_K])
    host, dev, _ = _timed_calls(torch, lambda: dp.train_steps_batches(stacked), 4)
    step_ms = statistics.median(dev) / INC_K
    out = dp.train_steps_batches(stacked)
    metrics = {"loss": out.loss[-1], **{k: v[-1] for k, v in out.metrics.items()}}
    monitors = {k: v[-1] for k, v in out.monitors.items()}
    n = 200
    cost = {}
    # the page-locked rows are taken when a recorder is built: a ring that
    # keeps every record (each row used once), then one of 8 that has
    # wrapped (rows reused)
    for tag, cap in (("fresh", n), ("steady", 8)):
        rec = flightrec.FlightRecorder(incident_dir=os.devnull, step_capacity=cap)
        for i in range(2 * cap if tag == "steady" else 0):
            rec.record_step(i, metrics=metrics, monitors=monitors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            rec.record_step(i, metrics=metrics, monitors=monitors)
        cost[tag] = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        del rec
    record_ms = cost["steady"]
    sampler = memwatch.MemorySampler(pressure_threshold=None)
    t0 = time.perf_counter()
    for _ in range(n):
        sampler.sample()
    sample_ms = (time.perf_counter() - t0) * 1e3 / n
    log(f"[incident] record_step {record_ms * 1e3:.1f} us a call in steady state (ring of 8 "
        f"wrapped; {cost['fresh'] * 1e3:.1f} us into rows never used before; both rings' "
        f"page-locked rows taken when the recorder was built), {len(metrics)} metrics and "
        f"{len(monitors)} monitors, mean of {n}, against "
        f"the captured step's {step_ms:.3f} ms (CUDA events, median of 4 chunks / {INC_K}): "
        f"{record_ms / step_ms:.2e} of a step; one memory sample {sample_ms * 1e3:.1f} us "
        f"[{card}]")
    return {"record_step_ms": record_ms, "record_step_fresh_ms": cost["fresh"],
            "captured_step_ms": step_ms, "record_frac": record_ms / step_ms,
            "sample_ms": sample_ms}


def phase_incident(torch, card, keep=None):
    """Phase 13c (module docstring): the six gates of the flight recorder,
    the memory sampler, compile events and the profiler capture on the
    bf16 ResNet-50 SyncBN slice (batch 64 at 224², world 1), then their
    costs. Returns (failures, summary); with ``keep`` (a dict) the first
    gate's guarded trainer is kept there for ``[monitor]``."""
    import tempfile

    t_phase = time.perf_counter()
    failures: list = []
    out: dict = {}
    gate_s: dict = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out[name] = fn(*a)
        gate_s[name] = round(time.perf_counter() - t0, 2)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_incident_") as d:
        timed("nan_restore", _incident_nan_restore, torch, d, failures, keep)
        steps = [_trainer_batch(torch, 950 + i) for i in range(INC_K)]
        model, dp = _resnet_trainer(torch)
        timed("sampler_capture", _incident_sampler_beside_capture, torch, dp, steps, failures)
        timed("dump_mid_chunk", _incident_dump_mid_chunk, torch, dp, steps, d, failures)
        timed("mem_pressure", _incident_pressure, torch, dp, steps, d, failures)
        timed("recompile_storm", _incident_storm, torch, d, failures)
        timed("capture", _incident_capture, torch, dp, steps, d, failures)
        timed("costs", _incident_costs, torch, dp, steps, card)
        del dp, model
    out["gate_s"] = gate_s
    out["phase_s"] = time.perf_counter() - t_phase
    c, m = out["costs"], out["dump_mid_chunk"]
    log(f"[incident] record_step {c['record_step_ms'] * 1e3:.1f} us a step "
        f"({c['record_frac']:.2e} of the captured step), dump_s {m['dump_s']}, "
        f"bundle_bytes {m['bundle_bytes']}, one sample {c['sample_ms'] * 1e3:.1f} us, capture "
        f"{out['capture']['seconds']} s and {out['capture']['bytes']} B; phase "
        f"{out['phase_s']:.1f}s (budget 60 s; by gate {json.dumps(gate_s)}), "
        f"{len(failures)} failures [{card}]")
    return failures, out


# -- [monitor]: the monitoring server, the SLO tracker and /profilez
# (ROADMAP A.11c) on the ResNet-50 slice under ResilientLoop ---------------

MON_K = 4  # the captured chunk's steps
MON_MIN_SCRAPES = 20  # /metrics scrapes while captured chunks run, at least
MON_SCRAPE_HZ = 10.0  # the scraper's rate
MON_EAGER = 2  # eager ResilientLoop steps (the BN launch count, the SLO leg)
MON_POISON_AT = 4  # the poisoned chunk (after the step-8 checkpoint)
MON_PROFILE_S = 0.5  # POST /profilez?duration_s=
MON_GRACE_S = 2.0  # the hand-off's grace for the request no loop services
MON_TURNS = 4  # rounds of server-off / server-on-and-scraped step timing
MON_HTTP_TIMEOUT_S = 30.0  # every HTTP request's own timeout
MON_PLANTED = "step.time_s p99 < 0.001"  # must fire (eager steps take ~90 ms)
MON_LIVENESS = "step.time_s p99 < 60"  # must not


def _http(url: str, method: str = "GET", timeout: float = MON_HTTP_TIMEOUT_S):
    """(status, body bytes, seconds) of one request, 4xx/5xx included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=b"" if method == "POST" else None,
                                 method=method)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def _prometheus_series(text: str) -> int | None:
    """The number of ``# TYPE`` families of a Prometheus 0.0.4 exposition,
    or None when a line is neither a TYPE line nor ``name[{labels}] value``
    with a number (NaN and ±Inf included)."""
    import re

    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? (\S+)$')
    families = 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in ("counter", "gauge", "histogram"):
                return None
            families += 1
            continue
        m = sample.match(line)
        if not m:
            return None
        try:
            float(m.group(2))
        except ValueError:
            return None
    return families if text.endswith("\n") else None


class _Scraper:
    """A thread that GETs ``/metrics`` of the active env server at
    ``MON_SCRAPE_HZ`` until stopped: (status, seconds, bytes, series) a
    scrape."""

    def __init__(self, port_fn):
        import threading

        self._port_fn, self.scrapes = port_fn, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="monitor-scraper",
                                        daemon=True)

    def _run(self):
        deadline = time.monotonic() + 600
        while not self._stop.is_set() and time.monotonic() < deadline:
            port = self._port_fn()
            if port is not None:
                status, body, s = _http(f"http://127.0.0.1:{port}/metrics")
                text = body.decode(errors="replace")
                self.scrapes.append((status, s, len(body), _prometheus_series(text)))
            self._stop.wait(1.0 / MON_SCRAPE_HZ)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=MON_HTTP_TIMEOUT_S + 5)


def _monitor_chunks(torch):
    """Three clean K = 4 chunks and one whose second step holds a NaN image."""
    from tpu_syncbn_torch.parallel import scan_driver

    clean = [scan_driver.stack_batches([_trainer_batch(torch, 1300 + 4 * c + j)
                                        for j in range(MON_K)]) for c in range(3)]
    poison = scan_driver.stack_batches([_trainer_batch(torch, 1400 + j,
                                                       nan_image=0 if j == 1 else None)
                                        for j in range(MON_K)])
    return clean, poison


def _monitor_captured_leg(torch, dp, clean, poison, d, syncs, failures) -> dict:
    """Gates 1-3: ``ResilientLoop(scan_steps=4)`` starts the env server
    itself; /metrics scraped at ~10 Hz while captured chunks run (each 200 in
    valid exposition; no synchronize from any thread but the main one);
    /healthz and /readyz 200 before the planted divergence and after it; the
    loop's readiness check records not-ready during the restore."""
    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.obs import server as obs_server

    probes, state = {}, {"i": 0}

    def port():
        srv = obs_server.active_server()
        return srv.port if srv is not None else None

    def probe(tag):
        base = f"http://127.0.0.1:{port()}"
        probes[tag] = {r: _http(f"{base}/{r}")[0] for r in ("healthz", "readyz")}

    with runtime.ResilientLoop(dp, os.path.join(d, "ckpt"), ckpt_every=2 * MON_K,
                               scan_steps=MON_K) as loop, _Scraper(port) as scraper:
        def batches():
            for i in range(150):
                state["i"] = i
                if i == 2:
                    probe("before")
                if i == MON_POISON_AT + 3:
                    probe("after")
                if i > MON_POISON_AT + 3 and len(scraper.scrapes) >= MON_MIN_SCRAPES + 4:
                    return
                yield poison if i == MON_POISON_AT else clean[i % len(clean)]

        t0 = time.perf_counter()
        summary = loop.run(batches())
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        scrapes = list(scraper.scrapes)
    during = [r for r in loop.readiness_log if r["recovering"]]
    ok_scrapes = [s for s in scrapes if s[0] == 200 and s[3]]
    secs = [s[1] for s in scrapes] or [float("nan")]
    scrapes = scrapes or [(None, float("nan"), 0, None)]
    gates = {
        "scrapes": len(ok_scrapes) >= MON_MIN_SCRAPES and len(ok_scrapes) == len(scrapes),
        "no_sync": syncs["other"] == 0,
        "probes": probes.get("before") == probes.get("after") == {"healthz": 200,
                                                                  "readyz": 200},
        "restore": summary["divergence_restores"] == 1 and bool(during)
        and not any(r["ok"] for r in during),
    }
    log(f"[monitor] ResilientLoop(scan_steps={MON_K}) with TPU_SYNCBN_METRICS_PORT=0 "
        f"started the server itself (port {port()}); {state['i']} chunks in {loop_s:.2f}s "
        f"while /metrics was scraped at {MON_SCRAPE_HZ:g} Hz: {len(ok_scrapes)}/"
        f"{len(scrapes)} scrapes 200 in valid Prometheus text (want >= {MON_MIN_SCRAPES}), "
        f"median {statistics.median(secs) * 1e3:.2f} ms, max {max(secs) * 1e3:.2f} ms a "
        f"scrape, {scrapes[-1][2]} B and {scrapes[-1][3]} series; synchronizes from the "
        f"server's threads {syncs['other']} (want 0; the loop's own {syncs['main']}); "
        f"/healthz and /readyz before the planted divergence {probes.get('before')}, after "
        f"it {probes.get('after')}; restores {summary['divergence_restores']}, the loop's "
        f"readiness check recorded {len(during)} verdicts while recovering, ok: "
        f"{[r['ok'] for r in during]} {'ok' if all(gates.values()) else 'FAIL'}")
    for k, v in gates.items():
        if not v:
            failures.append(f"[monitor] captured leg: gate {k} failed")
    return {"chunks": state["i"], "loop_s": loop_s, "scrapes": len(scrapes),
            "scrapes_ok": len(ok_scrapes), "scrape_median_s": statistics.median(secs),
            "scrape_max_s": max(secs), "exposition_bytes": scrapes[-1][2],
            "series": scrapes[-1][3], "server_thread_syncs": syncs["other"],
            "probes": probes, "recovering_verdicts": len(during),
            "restores": summary["divergence_restores"]}


def _monitor_bitwise(torch, dp, chunk, failures) -> bool:
    """Gate 4: the same captured chunk from the same state, once with the
    server up and scraped, once with no server: losses, state and monitors
    bitwise equal."""
    from tpu_syncbn_torch.obs import server as obs_server

    start = dp.state_dict()
    runs = []
    for served in (True, False):
        _restore_in_place(torch, dp, start)
        srv = obs_server.MonitoringServer(port=0, host="127.0.0.1") if served else None
        try:
            with contextlib.ExitStack() as stack:
                if srv is not None:
                    stack.enter_context(_Scraper(lambda: srv.port))
                    time.sleep(0.15)  # a scrape or two in flight first
                out = dp.train_steps_batches(chunk)
                torch.cuda.synchronize()
        finally:
            if srv is not None:
                srv.close()
        runs.append((out.loss.clone(), {k: v.clone() for k, v in out.monitors.items()},
                     dp.state_dict()))
    (l1, m1, s1), (l2, m2, s2) = runs
    leaves1, leaves2 = _state_leaves(s1), _state_leaves(s2)
    same = (torch.equal(l1, l2) and set(m1) == set(m2)
            and all(torch.equal(m1[k], m2[k]) for k in m1)
            and [p for p, _ in leaves1] == [p for p, _ in leaves2]
            and all(_same_leaf(torch, a, b) for (_, a), (_, b) in zip(leaves1, leaves2)))
    log(f"[monitor] one captured K={MON_K} chunk from the same state with the server up "
        f"and scraped, and with no server: losses {l1.tolist()}, state and "
        f"{len(m1)} monitors bitwise equal: {same} {'ok' if same else 'FAIL'}")
    if not same:
        failures.append("[monitor] a chunk run while scraped differs from it run without "
                        "the server")
    return same


def _monitor_slo(torch, T, dp, clean, d, rec, failures) -> dict:
    """Gates 5-7: eager ``ResilientLoop`` steps (every BN kernel 53 x steps)
    under an attached tracker with the planted objective, which fires (one
    valid ``slo_alert`` bundle naming the rule in ``state.alerts``;
    ``/statusz`` lists the alert and the last incident) while the
    liveness-grade one does not; ``POST /incidentz`` gives a valid bundle."""
    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.obs import incident, server as obs_server, slo, telemetry

    srv = obs_server.active_server()
    agg = srv.aggregator
    tracker = slo.SLOTracker(agg, [
        slo.AlertRule("planted_p99", MON_PLANTED, windows_s=(120.0,), clear_for=3),
        slo.AlertRule("liveness_p99", MON_LIVENESS, windows_s=(120.0,), clear_for=3),
    ]).attach()
    try:
        agg.tick()
        T.reset_launch_counts()
        steps = [tuple(t[j] for t in clean[0]) for j in range(MON_EAGER)]
        with runtime.ResilientLoop(dp, os.path.join(d, "eager_ckpt"), ckpt_every=1000) as loop:
            loop.run(iter(steps))
        torch.cuda.synchronize()
        launches = T.launch_counts()
        agg.tick()
        before = len(_bundles_by_kind(rec.incident_dir).get("slo_alert", []))
        out = tracker.evaluate()
        fired = telemetry.snapshot()["counters"].get("obs.alert.fired", 0)
        bundles = _bundles_by_kind(rec.incident_dir).get("slo_alert", [])
        alerts = bundles[-1]["state"]["alerts"] if bundles else {}
        base = f"http://127.0.0.1:{srv.port}"
        _, page, _ = _http(base + "/statusz")
        page = page.decode()
        readyz = _http(base + "/readyz")[0]
        status, body, inc_s = _http(base + "/incidentz", method="POST")
        inc_doc = json.loads(body)
        inc_ok = status == 200 and incident.load_bundle(inc_doc["path"])["trigger"][
            "kind"] == "manual"
    finally:
        tracker.detach()
    last = rec.last_incident or {}
    want = dict.fromkeys(MOVES, BN_LAYERS * MON_EAGER)
    gates = {
        "launches": launches == want,
        "fired": out["planted_p99"]["firing"] and fired >= 1,
        "quiet": not out["liveness_p99"]["firing"],
        "bundle": len(bundles) == before + 1 and
        alerts.get("slo", {}).get("planted_p99", {}).get("firing") is True
        and bundles[-1]["trigger"]["detail"]["rule"] == "planted_p99",
        "statusz": "slo/planted_p99" in page and "FIRING" in page
        and bundles[-1]["incident_id"] in page if bundles else False,
        "incidentz": inc_ok,
    }
    log(f"[monitor] {MON_EAGER} eager ResilientLoop steps: BN launches "
        f"{json.dumps(launches)} (want {BN_LAYERS} x {MON_EAGER} each); SLO tracker "
        f"'{MON_PLANTED}' firing {out['planted_p99']['firing']} (burns "
        f"{out['planted_p99']['burns']}), '{MON_LIVENESS}' firing "
        f"{out['liveness_p99']['firing']}; obs.alert.fired {fired}; slo_alert bundles "
        f"{len(bundles) - before} (state.alerts {json.dumps(alerts)}); /statusz lists the "
        f"alert and the last incident: {gates['statusz']}; /readyz while firing {readyz}; "
        f"POST /incidentz {status} in {inc_s * 1e3:.1f} ms, bundle valid {inc_ok} "
        f"(last incident {last.get('trigger')}) {'ok' if all(gates.values()) else 'FAIL'}")
    for k, v in gates.items():
        if not v:
            failures.append(f"[monitor] SLO leg: gate {k} failed")
    return {"launches": launches, "planted_firing": out["planted_p99"]["firing"],
            "liveness_firing": out["liveness_p99"]["firing"], "alert_fired": fired,
            "slo_alert_bundles": len(bundles) - before, "readyz_while_firing": readyz,
            "incidentz_status": status, "incidentz_s": inc_s}


def _monitor_profilez(torch, dp, clean, d, failures) -> dict:
    """Gate 8: ``POST /profilez?duration_s=0.5`` sent while the loop runs
    answers 200 with device events within its bound (the loop on this, the
    main thread, starts and stops the capture at chunk boundaries); the same
    request with no loop to service it answers 503 within its bound."""
    import threading

    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.obs import profiling, server as obs_server

    base = f"http://127.0.0.1:{obs_server.active_server().port}"
    url = f"{base}/profilez?duration_s={MON_PROFILE_S:g}"
    bound = MON_PROFILE_S + profiling.HANDOFF_GRACE_S
    res = {}

    def post():
        res["served"] = _http(url, method="POST", timeout=bound + 10)

    worker = threading.Thread(target=post, name="profilez-client", daemon=True)

    def batches():
        for i in range(400):
            if i == 1:
                worker.start()
            if i > 1 and not worker.is_alive():
                return
            if i > 1:
                time.sleep(0.2)  # a data wait: fewer chunks (and trace events) a second
            yield clean[i % len(clean)]

    with runtime.ResilientLoop(dp, os.path.join(d, "prof_ckpt"), ckpt_every=10 ** 6,
                               scan_steps=MON_K) as loop:
        loop.run(batches())
    worker.join(timeout=bound + 15)
    code, body, served_s = res.get("served", (None, b"{}", None))
    doc = json.loads(body or b"{}")
    grace, profiling.HANDOFF_GRACE_S = profiling.HANDOFF_GRACE_S, MON_GRACE_S
    try:
        code2, body2, idle_s = _http(url, method="POST", timeout=MON_PROFILE_S + MON_GRACE_S
                                     + 10)
    finally:
        profiling.HANDOFF_GRACE_S = grace
    doc2 = json.loads(body2)
    gates = {
        "served": code == 200 and doc.get("device_events", 0) > 0 and served_s < bound,
        "idle": code2 == 503 and "main thread" in doc2.get("error", "")
        and idle_s < MON_PROFILE_S + MON_GRACE_S + 2.0,
    }
    log(f"[monitor] POST /profilez?duration_s={MON_PROFILE_S:g} while the loop ran: {code} in "
        f"{served_s if served_s is None else round(served_s, 3)} s (bound {bound:g} s), "
        f"{doc.get('events')} events, {doc.get('device_events')} on the device, "
        f"{doc.get('bytes')} B; with no loop to take it: {code2} in {idle_s:.3f} s (bound "
        f"{MON_PROFILE_S + MON_GRACE_S:g} s): {doc2.get('error', '')[:90]}... "
        f"{'ok' if all(gates.values()) else 'FAIL'}")
    for k, v in gates.items():
        if not v:
            failures.append(f"[monitor] /profilez {k}: {code}/{code2} {doc} {doc2}")
    return {"served_status": code, "served_s": served_s, "device_events":
            doc.get("device_events"), "trace_bytes": doc.get("bytes"),
            "idle_status": code2, "idle_s": idle_s}


def _monitor_in_turns(torch, dp, chunk, card) -> dict:
    """The captured step with no server against the server up and scraped
    at ~10 Hz, in turns (CUDA events; shown, not gated)."""
    from tpu_syncbn_torch.obs import server as obs_server

    times = {"off": [], "on": []}
    for r in range(MON_TURNS):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            srv = obs_server.MonitoringServer(port=0, host="127.0.0.1") \
                if mode == "on" else None
            try:
                with contextlib.ExitStack() as stack:
                    if srv is not None:
                        stack.enter_context(_Scraper(lambda: srv.port))
                    _, dev, _ = _timed_calls(torch, lambda: dp.train_steps_batches(chunk), 2)
            finally:
                if srv is not None:
                    srv.close()
            times[mode].extend(v / MON_K for v in dev)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[monitor] the captured step (CUDA events, {MON_TURNS} turns x 2 chunks of "
        f"{MON_K}): no server {med['off']:.3f} ms (range {min(times['off']):.3f}-"
        f"{max(times['off']):.3f}), server up and scraped at {MON_SCRAPE_HZ:g} Hz "
        f"{med['on']:.3f} ms (range {min(times['on']):.3f}-{max(times['on']):.3f}): "
        f"{med['on'] - med['off']:+.3f} ms a step [{card}]")
    return {"step_ms_off": med["off"], "step_ms_on": med["on"], "off": times["off"],
            "on": times["on"]}


def phase_monitor(torch, card, keep):
    """Phase 13d (module docstring): the monitoring server, the SLO tracker
    and ``/profilez`` on the guarded ResNet-50 trainer ``[incident]`` built
    (``keep``: its K = 4 program warm). Returns (failures, summary)."""
    import tempfile
    import threading

    from tpu_syncbn_torch.obs import flightrec, server as obs_server, telemetry
    from tpu_syncbn_torch.ops import triton_bn as T

    t_phase = time.perf_counter()
    failures: list = []
    out: dict = {}
    dp = keep["dp"]
    clean, poison = _monitor_chunks(torch)
    env_keys = ("TPU_SYNCBN_METRICS_PORT", "TPU_SYNCBN_PROFILE_DIR")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    determ = torch.backends.cudnn.deterministic
    real_sync = torch.cuda.synchronize
    syncs = {"main": 0, "other": 0}

    def counting_sync(*a, **kw):
        main = threading.current_thread() is threading.main_thread()
        syncs["main" if main else "other"] += 1
        return real_sync(*a, **kw)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_monitor_") as d:
        os.environ["TPU_SYNCBN_METRICS_PORT"] = "0"
        os.environ["TPU_SYNCBN_PROFILE_DIR"] = os.path.join(d, "prof")
        telemetry.REGISTRY.reset()
        telemetry.set_enabled(True)
        rec = flightrec.install(flightrec.FlightRecorder(
            incident_dir=os.path.join(d, "inc"), cooldown_s=0.0))
        # the rebuilt graph after the restore picks deterministic algorithms,
        # so two replays from one state are bitwise (gate 4)
        torch.backends.cudnn.deterministic = True
        torch.cuda.synchronize = counting_sync
        try:
            out["captured"] = _monitor_captured_leg(torch, dp, clean, poison, d, syncs,
                                                    failures)
            out["bitwise_chunk"] = _monitor_bitwise(torch, dp, clean[0], failures)
            out["slo"] = _monitor_slo(torch, T, dp, clean, d, rec, failures)
            out["profilez"] = _monitor_profilez(torch, dp, clean, d, failures)
            out["server_thread_syncs"] = syncs["other"]
            if syncs["other"]:
                failures.append(f"[monitor] {syncs['other']} synchronizes off the main thread")
            torch.cuda.synchronize = real_sync
            # the timed graph is captured as every other phase's is
            # (cuDNN free to pick nondeterministic algorithms)
            torch.backends.cudnn.deterministic = determ
            for cache in dp.program_caches:
                cache.clear()
            dp.train_steps_batches(clean[0])
            out["in_turns"] = _monitor_in_turns(torch, dp, clean[0], card)
        finally:
            torch.cuda.synchronize = real_sync
            torch.backends.cudnn.deterministic = determ
            obs_server.stop_env_server()
            flightrec.uninstall()
            rec.close()
            telemetry.set_enabled(None)
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    keep.clear()
    del dp, clean, poison
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    c, t = out["captured"], out["in_turns"]
    log(f"[monitor] scrape median {c['scrape_median_s'] * 1e3:.2f} ms / max "
        f"{c['scrape_max_s'] * 1e3:.2f} ms for {c['series']} series ({c['exposition_bytes']} B); "
        f"captured step {t['step_ms_off']:.3f} ms without the server, {t['step_ms_on']:.3f} ms "
        f"scraped; phase {out['phase_s']:.1f}s (budget 60 s), {len(failures)} failures [{card}]")
    return failures, out


# -- phase 13e: serve — the serving path (ROADMAP A.12a) ----------------------

SERVE_BUCKETS = (8, 32, 128)  # the JAX engine's default buckets
SERVE_SIZES = (1, 5, 8, 20, 32, 100, 128, 200)  # 200 is chunked through 128
SERVE_TRAIN_STEPS = 3  # the slice's steps before serving: real running stats
SERVE_BATCHER_MAX, SERVE_CLIENTS, SERVE_PER_CLIENT = 32, 64, 8
SERVE_FILL_MIN = 0.9  # the JAX bench's acceptance bound on the fill ratio
# kernels against their plain versions on the whole model, bf16: the
# slice's loss tolerance (PERF.md §2), held on the logits' largest value
SERVE_AB_TOL = 1e-2
SERVE_TIMED = 10
SERVE_SLEEP_CYCLES = int(1e9)  # ~0.5 s of device sleep ahead of the in-flight request
SERVE_PROFILED = 3  # replays in the profiler window; the last one is read
SERVE_WAIT_S = 60


def _serve_eager(torch, engine, x, n: int):
    """The engine copy's eager eval forward on the rows ``x[:n]``, chunked
    and zero-padded to buckets as ``predict`` does; host float32."""
    import numpy as np

    outs = []
    for off in range(0, n, engine.max_bucket):
        take = min(engine.max_bucket, n - off)
        padded = np.zeros((engine.bucket_for(take),) + x.shape[1:], x.dtype)
        padded[:take] = x[off:off + take]
        with torch.no_grad():
            y = engine.model(torch.from_numpy(padded).cuda())
        outs.append(y.float().cpu().numpy()[:take])
    return np.concatenate(outs)


def _stream_ms(torch, stream, fn, iters: int) -> float:
    """Time a call of ``fn`` issued on ``stream``: one warm-up call, then
    ``iters`` calls between two CUDA events recorded on that stream."""
    with torch.cuda.stream(stream):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        e.record()
    e.synchronize()
    return a.elapsed_time(e) / iters


def _serve_build(torch, T, engine, x, failures) -> tuple[dict, int]:
    """Each bucket's program built alone: the ``bn_normalize`` launches of
    its eager warm-up and of its capture (counted while the stream
    captures), no other BN kernel; capture seconds and pool bytes. Returns
    the programs and the captures' ``bn_normalize`` launches summed over
    the buckets."""
    captured = [0]
    total = 0
    orig = T._normalize_kernel

    def counting(x2, scale, shift):
        if torch.cuda.is_current_stream_capturing():
            captured[0] += 1
        return orig(x2, scale, shift)

    progs = {}
    T._normalize_kernel = counting
    try:
        for b in SERVE_BUCKETS:
            T.reset_launch_counts()
            captured[0] = 0
            progs[b] = engine._program(b, x[:1])
            launches = T.launch_counts()
            p = progs[b]
            log(f"[serve] bucket {b}: capture {p.capture_s:.2f}s (eager warm-up "
                f"included), graph pool {p.pool_bytes / 2**20:.1f} MiB; BN launches "
                f"{json.dumps(launches)}, bn_normalize while capturing {captured[0]}")
            if captured[0] != BN_LAYERS or launches != {
                    **dict.fromkeys(T.LAUNCHES, 0), "bn_normalize": 2 * BN_LAYERS}:
                failures.append(f"[serve] bucket {b}: {captured[0]} bn_normalize in "
                                f"the capture, launches {launches}")
            total += captured[0]
    finally:
        T._normalize_kernel = orig
    return progs, total


def _serve_replays(torch, engine, progs, x, card) -> dict:
    """Per bucket: the replay alone by CUDA events on the engine's stream,
    ``predict`` by the host clock (staging, copies, replay, copy-out), the
    eager eval forward with the kernels and with their plain versions;
    the bucket-128 batch's host-to-device and device-to-host copies."""
    from tpu_syncbn_torch.ops import batch_norm as bn_ops

    st = engine._stream
    out = {}
    for b, p in progs.items():
        replay = _stream_ms(torch, st, p.graph.replay, SERVE_TIMED)
        host = []
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            engine.predict(x[:b])
            host.append((time.perf_counter() - t0) * 1e3)
        dev = torch.from_numpy(x[:b]).cuda()
        with torch.no_grad():
            eager = _event_ms(torch, lambda: engine.model(dev), 3, reps=3)
            with bn_ops.kernel_mode("off"):
                eager_off = _event_ms(torch, lambda: engine.model(dev), 3, reps=3)
        out[b] = {"replay_ms": round(replay, 4), "predict_ms": round(statistics.median(host), 4),
                  "eager_ms": round(eager, 4), "eager_plain_ms": round(eager_off, 4),
                  "capture_s": round(p.capture_s, 3), "pool_bytes": p.pool_bytes,
                  "img_per_s_replay": round(b / replay * 1e3, 1),
                  "img_per_s_predict": round(b / statistics.median(host) * 1e3, 1)}
        log(f"[serve] bucket {b}: replay {replay:.3f} ms (CUDA events) = "
            f"{b / replay * 1e3:.1f} img/s; predict {statistics.median(host):.3f} ms "
            f"(host clock, staging and copies included) = "
            f"{out[b]['img_per_s_predict']:.1f} img/s; eager eval {eager:.3f} ms with "
            f"the kernels, {eager_off:.3f} ms plain [{card}]")
        del dev
    p = progs[SERVE_BUCKETS[-1]]
    h2d = _stream_ms(torch, st, lambda: [d.copy_(h, non_blocking=True)
                                         for d, h in zip(p.static_in, p.staging)],
                     SERVE_TIMED)
    d2h = _stream_ms(torch, st, lambda: p.out_host.copy_(p.static_out, non_blocking=True),
                     SERVE_TIMED)
    mb = sum(t.numel() * t.element_size() for t in p.staging) / 1e6
    log(f"[serve] bucket {SERVE_BUCKETS[-1]} copies: host-to-device {h2d:.3f} ms for "
        f"{mb:.1f} MB of f32 ({mb / h2d:.1f} GB/s), device-to-host {d2h:.4f} ms for "
        f"the logits [{card}]")
    out["h2d_ms"], out["d2h_ms"] = round(h2d, 4), round(d2h, 4)
    return out


def _replay_kernels(torch, prog, stream) -> list:
    """The device kernels of one replay of ``prog``'s graph, by name: the
    last of SERVE_PROFILED replays in one profiler window, each after a
    marker, one ``bn_stats`` kernel (which no eval graph holds). A
    window's first activities can go missing in a process that ran other
    profiler windows before, so the earlier replays are not read."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_syncbn_torch.ops import triton_bn as T

    mark = torch.zeros(64, 64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.cuda.stream(stream):
            for _ in range(SERVE_PROFILED):
                T.bn_stats(mark)
                prog.graph.replay()
            T.bn_stats(mark)
        torch.cuda.synchronize()
    names = [n for n, _, _ in sorted(device_intervals(prof), key=lambda e: e[1])
             if "Memcpy" not in n and "Memset" not in n]
    marks = [i for i, n in enumerate(names) if "bn_stats_k::" in n]
    if len(marks) < 2:
        return []
    return names[marks[-2] + 1:marks[-1]]


def _serve_plain_graph(torch, bn_ops, dp, engine, x, card, failures) -> dict:
    """A second engine captured under kernel mode "off" (its BN the plain
    chain): one replay of each bucket-128 graph profiled (53
    ``bn_normalize`` kernels in the kernel graph and none in the plain
    one, which runs three kernels more a layer: the chain's cast,
    multiply, add and cast for the normalize kernel), their outputs held
    within the slice's tolerance, their replays timed in turns."""
    import numpy as np

    from tpu_syncbn_torch import serve

    b = SERVE_BUCKETS[-1]
    with bn_ops.kernel_mode("off"):
        plain = serve.InferenceEngine.from_trainer(dp, buckets=(b,))
        plain.warm(x[:1])
    k_names = _replay_kernels(torch, engine._program(b, x[:1]), engine._stream)
    p_prog = plain._program(b, x[:1])
    p_names = _replay_kernels(torch, p_prog, plain._stream)
    k_norm = sum("bn_normalize_k::" in n for n in k_names)
    p_norm = sum("bn_normalize_k::" in n for n in p_names)
    log(f"[serve] profiled bucket-{b} replay: {len(k_names)} kernels with the "
        f"hand-written normalize ({k_norm} bn_normalize), {len(p_names)} with the "
        f"plain chain ({p_norm} bn_normalize); difference {len(p_names) - len(k_names)} "
        f"(want 3 x {BN_LAYERS})")
    if k_norm != BN_LAYERS or p_norm != 0 or len(p_names) - len(k_names) != 3 * BN_LAYERS:
        failures.append(f"[serve] replay kernels: {k_norm} bn_normalize with the kernels, "
                        f"{p_norm} plain, {len(k_names)} against {len(p_names)}")
    got, want = engine.predict(x[:b]), plain.predict(x[:b])
    rel = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))
    log(f"[serve] bucket-{b} logits, kernels against plain versions: max |diff| / "
        f"max |plain| = {rel:.2e} (tol {SERVE_AB_TOL})")
    if not rel <= SERVE_AB_TOL:
        failures.append(f"[serve] kernels against plain versions: {rel:.2e}")
    times = {"kernel": [], "plain": []}
    for tag in ("plain", "kernel", "kernel", "plain"):
        eng = engine if tag == "kernel" else plain
        times[tag].append(_stream_ms(torch, eng._stream, eng._program(b, x[:1]).graph.replay,
                                     SERVE_TIMED))
    log(f"[serve] bucket-{b} replay in turns (plain, kernel, kernel, plain): "
        f"kernel {times['kernel']} ms, plain chain {times['plain']} ms [{card}]")
    del plain, p_prog
    torch.cuda.empty_cache()
    return {"rel_err": rel, "replay_kernel_ms": times["kernel"],
            "replay_plain_ms": times["plain"], "kernels_a_replay": len(k_names),
            "bn_normalize_a_replay": k_norm,
            "plain_kernels_a_replay": len(p_names)}


def _serve_normalize_times(torch, T, bn_ops, engine, card, failures) -> dict:
    """Eval ``bn_normalize`` at the 53 BN shapes of a bucket-128 forward:
    the wrapper (fold and kernel, as the path runs it) against the plain
    chain (``batch_norm_elemt``) and ATen's ``F.batch_norm(training=False)``
    on the same inputs, device time summed over the layers, beside the
    bound; each call held against the plain chain within one bf16 ulp."""
    import torch.nn.functional as F

    shapes = bn_shapes(torch, engine.model, SERVE_BUCKETS[-1], IMAGE_SIZE)
    counts: dict = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "max_abs_err": 0.0}
    library_ok = True
    for (m, c), n in sorted(counts.items()):
        x, _, w, b = _inputs(torch, m, c, torch.bfloat16, seed=23)
        g = torch.Generator(device="cuda").manual_seed(m + c)
        rm = torch.randn(c, device="cuda", generator=g)
        rv = torch.rand(c, device="cuda", generator=g) + 0.5
        kern = lambda: T.bn_normalize(x, rm, rv, w, b, 1e-5)  # noqa: E731
        plain = lambda: bn_ops.batch_norm_elemt(x, rm, rv, w, b, 1e-5)  # noqa: E731
        got, want = kern(), plain()
        err = (got.float() - want.float()).abs()
        tot["max_abs_err"] = max(tot["max_abs_err"], float(err.max()))
        if not bool((err <= 2 ** -7 * want.float().abs() + 1e-5).all()):
            failures.append(f"[serve] bn_normalize at M={m} C={c} off its plain version "
                            f"by {float(err.max()):.3e}")
        t_k = _device_ms(torch, kern, 20)
        t_p = _device_ms(torch, plain, 20)
        try:
            t_l = _device_ms(torch, lambda: F.batch_norm(x, rm, rv, w, b, False, 0.0, 1e-5), 20)
        except RuntimeError as e:  # no ATen call for this mix of dtypes
            log(f"[serve] F.batch_norm(training=False) at M={m} C={c}: {e}")
            library_ok, t_l = False, 0.0
        bytes_ms, ops_ms = bound_ms("bn_normalize", m, c, 2)
        for k, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                     ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            tot[k] += n * v
        del x
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    if not library_ok:
        tot["library_ms"] = None
    log(f"[serve] eval bn_normalize at bucket {SERVE_BUCKETS[-1]} ({len(shapes)} layers, "
        f"bf16) device a forward: kernel {tot['ms']:.3f} ms (fold included), plain chain "
        f"{tot['plain_ms']:.3f} ms, ATen F.batch_norm(training=False) "
        f"{tot['library_ms'] if tot['library_ms'] is None else round(tot['library_ms'], 3)}"
        f" ms, bound {tot['bound_ms']:.3f} ms ({tot['bound_by']}); max |kernel - plain| "
        f"{tot['max_abs_err']:.3e} [{card}]")
    return tot


def _serve_swap(torch, serve, engine, x, failures) -> dict:
    """``swap_params`` with perturbed weights while a bucket-128 request is
    in flight (queued behind a device sleep on the engine's stream): the
    request returns the old version's rows, the next one the new weights'
    eager forward, no new capture; ``rollback`` returns the old rows bit
    for bit; a skewed tree raises ``VersionSkewError`` and changes
    nothing."""
    import threading

    import numpy as np

    n = SERVE_BUCKETS[-1]
    old = engine.predict(x[:n])
    compiled = engine.stats()["programs_compiled"]
    g = torch.Generator(device="cuda").manual_seed(17)
    new = {k: p + 0.05 * p.abs().mean() * torch.randn(p.shape, device="cuda", generator=g)
           for k, p in engine.param_template().items()}
    result: dict = {}
    with torch.cuda.stream(engine._stream):
        torch.cuda._sleep(SERVE_SLEEP_CYCLES)
    th = threading.Thread(target=lambda: result.setdefault("y", engine.predict(x[:n])))
    th.start()
    deadline = time.monotonic() + SERVE_WAIT_S
    while not engine._run_lock.locked() and time.monotonic() < deadline:
        time.sleep(0.001)
    in_flight = engine._run_lock.locked()
    t0 = time.perf_counter()
    prev = engine.swap_params(new, version=1)
    swap_s = time.perf_counter() - t0
    th.join(SERVE_WAIT_S)
    inflight_old = not th.is_alive() and np.array_equal(result.get("y"), old)
    got_new = engine.predict(x[:n])
    new_ok = np.array_equal(got_new, _serve_eager(torch, engine, x, n)) \
        and not np.array_equal(got_new, old)
    t0 = time.perf_counter()
    back = engine.rollback()
    rollback_s = time.perf_counter() - t0
    rolled = np.array_equal(engine.predict(x[:n]), old)
    bad = dict(new)
    k0 = next(iter(bad))
    bad[k0] = bad[k0].reshape(-1, 1)
    try:
        engine.swap_params(bad, version=2)
        skew = False
    except serve.VersionSkewError:
        skew = engine.version == 0 and np.array_equal(engine.predict(x[:n]), old)
    recompiled = engine.stats()["programs_compiled"] - compiled
    out = {"in_flight": in_flight, "in_flight_old_rows": inflight_old,
           "new_bitwise_eager": new_ok, "rollback_bitwise": rolled, "skew_rejected": skew,
           "new_captures": recompiled, "swap_s": round(swap_s, 4),
           "rollback_s": round(rollback_s, 4), "swapped_from": prev, "rolled_back_to": back,
           "params_nbytes": engine.params_nbytes()}
    log(f"[serve] swap: {json.dumps(out)} (swap_s waits for the in-flight request)")
    if not (in_flight and inflight_old and new_ok and rolled and skew and recompiled == 0
            and prev == 0 and back == 0):
        failures.append(f"[serve] swap/rollback {out}")
    return out


def _serve_batcher(torch, serve, engine, x, card, failures) -> dict:
    """A ``DynamicBatcher`` at ``max_batch`` 32 under 64 closed-loop
    clients (single-image requests): fill ratio, p50 and p99."""
    import threading

    import numpy as np

    bat = serve.DynamicBatcher(engine, max_batch=SERVE_BATCHER_MAX, max_wait_ms=50.0,
                               max_queue=4 * SERVE_BATCHER_MAX, health_name="serve_chip")
    lat: list = []
    lock = threading.Lock()

    def client(cid):
        rng = np.random.RandomState(cid)
        for _ in range(SERVE_PER_CLIENT):
            i = int(rng.randint(0, len(x)))
            t0 = time.perf_counter()
            bat.submit(x[i:i + 1]).result(timeout=SERVE_WAIT_S)
            with lock:
                lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(SERVE_WAIT_S)
    wall = time.perf_counter() - t0
    bat.close(drain=True, timeout=SERVE_WAIT_S)
    fill = bat.fill_ratio
    out = {"requests": len(lat), "fill_ratio": fill, "throughput_rps": round(len(lat) / wall, 1),
           "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3) if lat else None,
           "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3) if lat else None,
           "batches": bat.counters.count("batches")}
    log(f"[serve] batcher max_batch {SERVE_BATCHER_MAX}, {SERVE_CLIENTS} closed-loop "
        f"clients: {json.dumps(out)} (fill >= {SERVE_FILL_MIN}) [{card}]")
    if len(lat) != SERVE_CLIENTS * SERVE_PER_CLIENT or fill is None or fill < SERVE_FILL_MIN:
        failures.append(f"[serve] batcher {out}")
    return out


def _serve_circuit(torch, serve, engine, x, failures) -> dict:
    """``faults.crash_engine_at_batch`` on the real engine behind a batcher
    whose server ``TPU_SYNCBN_METRICS_PORT=0`` started: two failed batches
    open the circuit, ``/readyz`` answers 503 naming it, the half-open
    probe after the backoff answers the engine's own rows and closes it,
    ``/readyz`` answers 200; exactly one valid ``circuit_open`` bundle."""
    import tempfile

    import numpy as np

    from tpu_syncbn_torch.obs import flightrec
    from tpu_syncbn_torch.obs import server as obs_server
    from tpu_syncbn_torch.testing import faults

    d = tempfile.mkdtemp(prefix="serve_incidents_")
    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=d))
    prev_port = os.environ.get("TPU_SYNCBN_METRICS_PORT")
    os.environ["TPU_SYNCBN_METRICS_PORT"] = "0"
    out = {}
    try:
        proxy = faults.crash_engine_at_batch(engine, 0, n_batches=2)
        breaker = serve.CircuitBreaker(failure_threshold=2, backoff_base_s=0.2,
                                       backoff_max_s=1.0, key="chip")
        bat = serve.DynamicBatcher(proxy, max_batch=8, max_wait_ms=1, max_queue=16,
                                   breaker=breaker, health_name="serve_circuit")
        try:
            base = f"http://127.0.0.1:{obs_server.active_server().port}"
            crashed = 0
            for i in range(2):  # one at a time: two batches, two failures
                try:
                    bat.submit(x[i:i + 1]).result(timeout=SERVE_WAIT_S)
                except RuntimeError:
                    crashed += 1
            status, body, _ = _http(base + "/readyz")
            check = json.loads(body)["checks"].get("serve_circuit", {})
            out["open"] = breaker.state == serve.CircuitBreaker.OPEN
            out["readyz_open"] = status
            out["readyz_circuit"] = (check.get("circuit") or {}).get("state")
            deadline = time.monotonic() + SERVE_WAIT_S
            while breaker.state == serve.CircuitBreaker.OPEN and time.monotonic() < deadline:
                time.sleep(0.01)
            probe = bat.submit(x[:1]).result(timeout=SERVE_WAIT_S)
            out["probe_rows"] = bool(np.array_equal(probe, engine.predict(x[:1])))
            out["closed"] = breaker.state == serve.CircuitBreaker.CLOSED
            out["readyz_after"] = _http(base + "/readyz")[0]
            out["crashed"] = crashed
        finally:
            bat.close(timeout=SERVE_WAIT_S)
    finally:
        obs_server.stop_env_server()
        if prev_port is None:
            os.environ.pop("TPU_SYNCBN_METRICS_PORT", None)
        else:
            os.environ["TPU_SYNCBN_METRICS_PORT"] = prev_port
        flightrec.uninstall()
        rec.close()
    bundles = _bundles_by_kind(d)
    out["bundles"] = {k: len(v) for k, v in bundles.items()}
    ring = [e["kind"] for e in bundles.get("circuit_open", [{}])[0].get("rings", {}).get(
        "serve", [])]
    out["ring_circuit_states"] = ring.count("circuit_state")
    log(f"[serve] circuit drill: {json.dumps(out)}")
    if not (out["crashed"] == 2 and out["open"] and out["readyz_open"] == 503
            and out["readyz_circuit"] == "open" and out["probe_rows"] and out["closed"]
            and out["readyz_after"] == 200 and out["bundles"] == {"circuit_open": 1}
            and out["ring_circuit_states"] >= 1):
        failures.append(f"[serve] circuit drill {out}")
    return out


def phase_serve(torch, card, keep: dict):
    """The serving path (ROADMAP A.12a) on full-width bf16 ResNet-50
    (``channels_last``), its SyncBN trainer taken SERVE_TRAIN_STEPS steps
    first: ``InferenceEngine.from_trainer(dp, buckets=(8, 32, 128))`` on
    224² f32 requests, cuDNN deterministic. Leaves the engine, the trainer
    and the requests in ``keep`` for :func:`phase_publish`. Returns
    (failures, summary, the eval normalize's row for the kernel line)."""
    import numpy as np

    from tpu_syncbn_torch import serve
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T

    t0 = time.perf_counter()
    failures: list = []
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model, dp = _resnet_trainer(torch)
        for i in range(SERVE_TRAIN_STEPS):
            dp.train_step(_trainer_batch(torch, 300 + i))
        engine = serve.InferenceEngine.from_trainer(dp, buckets=SERVE_BUCKETS)
        if not model.training or engine.model.training:
            failures.append("[serve] the trainer's module left training mode, or the "
                            "engine's copy is not in eval mode")
        x = np.random.RandomState(5).randn(max(SERVE_SIZES), IMAGE_SIZE, IMAGE_SIZE, 3) \
            .astype(np.float32)
        progs, captured = _serve_build(torch, T, engine, x, failures)
        engine.warm(x[:1])
        # every bucket bitwise its eager forward; every size its own rows
        sizes_ok = {}
        for n in SERVE_SIZES:
            got = engine.predict(x[:n])
            sizes_ok[n] = bool(got.shape == (n, 1000) and np.isfinite(got).all()
                               and np.array_equal(got, _serve_eager(torch, engine, x, n)))
        log(f"[serve] request sizes, replay bitwise the eager forward at the padded "
            f"size (rows their own): {json.dumps(sizes_ok)}")
        if not all(sizes_ok.values()):
            failures.append(f"[serve] sizes {sizes_ok}")
        if engine.stats()["programs_compiled"] != len(SERVE_BUCKETS):
            failures.append(f"[serve] stats after warm() and traffic: {engine.stats()}")
        replays = _serve_replays(torch, engine, progs, x, card)
        ab = _serve_plain_graph(torch, bn_ops, dp, engine, x, card, failures)
        norm = _serve_normalize_times(torch, T, bn_ops, engine, card, failures)
        swap = _serve_swap(torch, serve, engine, x, failures)
        batcher = _serve_batcher(torch, serve, engine, x, card, failures)
        circuit = _serve_circuit(torch, serve, engine, x, failures)
        if engine.stats()["programs_compiled"] != len(SERVE_BUCKETS):
            failures.append(f"[serve] programs rebuilt: {engine.stats()}")
        log(f"[serve] stats {json.dumps(engine.stats())}; trainer still training: "
            f"{model.training}")
        keep.update(engine=engine, dp=dp, x=x)
        del engine, dp, model, progs
    finally:
        torch.backends.cudnn.deterministic = prev_det
    torch.cuda.empty_cache()
    log(f"[serve] phase done in {time.perf_counter() - t0:.1f}s, {len(failures)} failures")
    row = {"launches": captured, "launches_a_replay": ab["bn_normalize_a_replay"],
           "bucket": SERVE_BUCKETS[-1], "ms": norm["ms"], "plain_ms": norm["plain_ms"],
           "library_ms": norm["library_ms"], "bound_ms": norm["bound_ms"],
           "bound_by": norm["bound_by"], "max_abs_err": norm["max_abs_err"]}
    summary = {"replays": replays, "ab": ab, "swap": swap, "batcher": batcher,
               "circuit": circuit, "sizes": sizes_ok}
    return failures, summary, row


# -- phase 13f: publish — weight publication into the serving engine (A.12b) --

PUBLISH_STEP_SEED = 400  # the one training step between two versions


def _publish_same(torch, engine, dp) -> bool:
    """Whether the engine's parameters and buffers equal the trainer's
    module's, bit for bit."""
    params, rest = engine._live()
    theirs = {**dict(dp.model.named_parameters()), **dict(dp.model.named_buffers())}
    return all(torch.equal(t, theirs[n]) for n, t in {**params, **rest}.items())


def _publish_counts(telemetry, before: dict) -> dict:
    """The ``serve.*`` swap counters since ``before``."""
    now = telemetry.snapshot()["counters"]
    return {k: now.get(k, 0) - before.get(k, 0) for k in
            ("serve.swaps_total", "serve.rollbacks_total", "serve.swap_rejected_total")}


def phase_publish(torch, card, keep: dict):
    """Weight publication (ROADMAP A.12b) on ``[serve]``'s engine and
    trainer (``keep``), cuDNN deterministic, telemetry on, a flight recorder
    installed: every source of a new version ends in ``swap_params``' copy
    into the tensors the captured graphs read, so no swap captures again.
    The bucket-128 rows are held against the engine copy's eager forward at
    the padded size (``[serve]``'s reference) and its kernel-mode "off"
    forward. Returns (failures, summary, the replay's row for
    ``bn_normalize``'s kernel entry)."""
    import shutil
    import tempfile

    import numpy as np

    from tpu_syncbn_torch import serve
    from tpu_syncbn_torch.obs import flightrec, memwatch, telemetry
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T
    from tpu_syncbn_torch.serve.publish import serving_state
    from tpu_syncbn_torch.testing import faults
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    failures: list = []
    engine, dp, x = keep.pop("engine"), keep.pop("dp"), keep.pop("x")
    b = SERVE_BUCKETS[-1]
    d = tempfile.mkdtemp(prefix="publish_")
    pub, inc = os.path.join(d, "pub"), os.path.join(d, "inc")
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    telemetry.set_enabled(True)
    rec = flightrec.install(flightrec.FlightRecorder(cooldown_s=0.0, incident_dir=inc))
    ctl = serve.SwapController(engine, health_name="publish_chip")
    out: dict = {}

    def rows():
        return engine.predict(x[:b])

    try:
        stats0 = engine.stats()
        counters0 = telemetry.snapshot()["counters"]
        # a kernel's first launch in a process waits for all queued work
        # (lazy module loading): one untimed swap and rollback first
        ctl.swap_from_trainer(dp, version=1)
        ctl.rollback(reason="warm-up")
        old = rows()
        # the trainer's weights (those the engine serves) published, timed
        t0 = time.perf_counter()
        params, rest = serving_state(dp)
        ckpt.publish_version(pub, 1, {"params": params, "rest": rest},
                             step=SERVE_TRAIN_STEPS)
        out["publish_s"] = round(time.perf_counter() - t0, 4)
        out["publish_bytes"] = ckpt.read_published_manifest(pub, 1)["nbytes"]
        # one training step: the trainer moves past the engine
        dp.train_step(_trainer_batch(torch, PUBLISH_STEP_SEED))
        torch.cuda.synchronize()
        T.reset_launch_counts()
        res = ctl.swap_from_trainer(dp, version=2, canary=x[:1])
        new = rows()
        wrapper = T.launch_counts()
        out["trainer_swap"] = res
        names = _replay_kernels(torch, engine._program(b, x[:1]), engine._stream)
        out["bn_normalize_a_replay"] = sum("bn_normalize_k::" in n for n in names)
        out["kernels_a_replay"] = len(names)
        out["wrapper_launches"] = wrapper
        eager = _serve_eager(torch, engine, x, b)
        with bn_ops.kernel_mode("off"):
            plain = _serve_eager(torch, engine, x, b)
        rel = float(np.abs(new - plain).max() / max(np.abs(plain).max(), 1e-6))
        out["trainer_rows"] = {
            "bitwise_eager": bool(np.array_equal(new, eager)),
            "finite": bool(np.isfinite(new).all()), "changed": not np.array_equal(new, old),
            "plain_rel_err": rel, "weights_the_trainers": _publish_same(torch, engine, dp)}
        out["double_buffer_bytes"] = engine.params_nbytes()
        log(f"[publish] swap_from_trainer: {json.dumps(res)}; bucket-{b} replay "
            f"{len(names)} kernels, {out['bn_normalize_a_replay']} bn_normalize; wrapper "
            f"launches on the replay path {json.dumps(wrapper)}; rows "
            f"{json.dumps(out['trainer_rows'])}; double buffer "
            f"{out['double_buffer_bytes'] / 2**20:.1f} MiB [{card}]")
        if not (res["outcome"] == "swapped" and out["bn_normalize_a_replay"] == BN_LAYERS
                and not any(wrapper.values()) and out["trainer_rows"]["bitwise_eager"]
                and out["trainer_rows"]["finite"] and out["trainer_rows"]["changed"]
                and rel <= SERVE_AB_TOL and out["trainer_rows"]["weights_the_trainers"]):
            failures.append(f"[publish] swap_from_trainer {out}")
        # back to the published (pre-step) weights, from disk
        t0 = time.perf_counter()
        res = ctl.swap_from_publication(pub, canary=x[:1])
        out["publication_s"] = round(time.perf_counter() - t0, 4)
        out["publication_swap"] = res
        got = rows()
        out["publication_rows_old"] = bool(np.array_equal(got, old)
                                           and np.array_equal(got, _serve_eager(torch, engine, x, b)))
        log(f"[publish] swap_from_publication ({out['publish_bytes'] / 1e6:.1f} MB, "
            f"published in {out['publish_s']} s, loaded and swapped in "
            f"{out['publication_s']} s): {json.dumps(res)}; rows bitwise the pre-step "
            f"rows and the eager forward: {out['publication_rows_old']} [{card}]")
        if res["outcome"] != "swapped" or res["version"] != 1 or not out["publication_rows_old"]:
            failures.append(f"[publish] swap_from_publication {res}")
        # a truncated publication: rejected, rows unchanged bit for bit
        ckpt.publish_version(pub, 3, {"params": params, "rest": rest})
        faults.corrupt_publication(pub, "truncate")
        try:
            ctl.swap_from_publication(pub)
            out["truncated"] = "swapped"
        except ckpt.CheckpointCorruptError:
            out["truncated"] = "rejected"
        ring = [e for e in rec.rings_snapshot()["serve"] if e["kind"] == "weight_swap"]
        out["truncated_ring"] = ring[-1].get("outcome"), ring[-1].get("reason")
        out["truncated_rows_unchanged"] = bool(np.array_equal(rows(), old)) \
            and engine.version == 1
        # a canary that crashes on the new version: rolled back
        proxy = faults.crash_engine_on_version(engine, 4)
        with serve.SwapController(proxy, health_name="publish_chip_canary") as c2:
            res = c2.swap(*serving_state(dp), version=4, canary=x[:1])
        out["canary"] = {k: res[k] for k in ("outcome", "version", "failed_version")}
        out["canary_rows_old"] = bool(np.array_equal(rows(), old))
        # a manual rollback after a swap: bit for bit
        ctl.swap_from_trainer(dp, version=5)
        t0 = time.perf_counter()
        res = ctl.rollback(reason="chip drill")
        out["rollback_s"] = round(time.perf_counter() - t0, 6)
        out["rollback"] = {k: res[k] for k in ("outcome", "version", "failed_version")}
        out["rollback_rows_old"] = bool(np.array_equal(rows(), old))
        # a memwatch contract at the bytes now allocated: the double buffer
        # cannot fit, the swap aborts with mem_pressure
        sampler = memwatch.install(memwatch.MemorySampler(
            contract_bytes_per_device=torch.cuda.memory_allocated(), interval_s=3600.0))
        try:
            ctl.swap_from_trainer(dp, version=6)
            out["memwatch"] = "swapped"
        except serve.SwapAbortedError:
            out["memwatch"] = "aborted"
        finally:
            memwatch.uninstall()
            sampler.close()
        out["memwatch_version"] = engine.version
        ring = [e for e in rec.rings_snapshot()["serve"] if e["kind"] == "weight_swap"]
        out["memwatch_ring"] = ring[-1].get("outcome"), ring[-1].get("reason")
        out["readiness"] = ctl.readiness()
        stats1 = engine.stats()
        out["new_captures"] = stats1["programs_compiled"] - stats0["programs_compiled"]
        out["new_misses"] = (stats1["program_cache"]["misses"]
                             - stats0["program_cache"]["misses"])
        out["counters"] = _publish_counts(telemetry, counters0)
    finally:
        ctl.close()
        flightrec.uninstall()
        rec.close()
        telemetry.set_enabled(None)
        torch.backends.cudnn.deterministic = prev_det
    bundles = _bundles_by_kind(inc)
    out["bundles"] = {k: len(v) for k, v in bundles.items()}
    # the preflight's own mem_pressure bundle, told from the sampler's
    # (which also trips at this contract) by the swap's detail
    out["memwatch_bundles"] = sum(
        b["trigger"]["detail"].get("outcome") == "aborted"
        and b["trigger"]["detail"].get("version") == 6
        for b in bundles.get("mem_pressure", []))
    shutil.rmtree(d, ignore_errors=True)
    ts, ps = out["trainer_swap"], out["publication_swap"]
    log(f"[publish] truncated publication {out['truncated']} (ring "
        f"{out['truncated_ring']}, rows unchanged {out['truncated_rows_unchanged']}); "
        f"canary crash {json.dumps(out['canary'])} (rows old {out['canary_rows_old']}); "
        f"manual rollback {json.dumps(out['rollback'])} in {out['rollback_s'] * 1e3:.3f} ms "
        f"(rows bitwise {out['rollback_rows_old']}); memwatch contract: "
        f"{out['memwatch']} (ring {out['memwatch_ring']}, its mem_pressure bundles "
        f"{out['memwatch_bundles']}); new captures {out['new_captures']}, new misses "
        f"{out['new_misses']}; counters {json.dumps(out['counters'])}; bundles "
        f"{json.dumps(out['bundles'])}")
    log(f"[publish] swap_from_trainer swap_s {ts['swap_s'] * 1e3:.3f} ms (commit_s "
        f"{ts['commit_s'] * 1e3:.3f} ms, the canary after it); swap_from_publication "
        f"swap_s {ps['swap_s'] * 1e3:.3f} ms (commit_s {ps['commit_s'] * 1e3:.3f} ms), "
        f"{out['publication_s'] * 1e3:.1f} ms with the load; publish_version "
        f"{out['publish_s'] * 1e3:.1f} ms for {out['publish_bytes']} B; rollback "
        f"{out['rollback_s'] * 1e3:.3f} ms; double buffer {out['double_buffer_bytes']} B "
        f"[{card}]")
    want_counts = {"serve.swaps_total": 4, "serve.rollbacks_total": 3,
                   "serve.swap_rejected_total": 2}
    if not (out["truncated"] == "rejected" and out["truncated_ring"] == ("rejected", "corrupt")
            and out["truncated_rows_unchanged"]
            and out["canary"] == {"outcome": "rolled_back", "version": 1, "failed_version": 4}
            and out["canary_rows_old"]
            and out["rollback"] == {"outcome": "rolled_back", "version": 1, "failed_version": 5}
            and out["rollback_rows_old"] and out["memwatch"] == "aborted"
            and out["memwatch_version"] == 1 and out["readiness"][0]
            and out["new_captures"] == 0 and out["new_misses"] == 0
            and out["counters"] == want_counts
            and out["bundles"].get("weight_swap") == 8
            and out["memwatch_ring"] == ("aborted", "mem_pressure")
            and out["memwatch_bundles"] == 1):
        failures.append(f"[publish] drills {out}")
    del engine, dp, x, proxy
    out["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(f"[publish] phase done in {out['phase_s']}s (budget 30 s), {len(failures)} failures")
    row = {"launches_a_replay": out["bn_normalize_a_replay"], "bucket": b,
           "wrapper_launches": out["wrapper_launches"]["bn_normalize"],
           "new_captures": out["new_captures"]}
    return failures, out, row


def attn_terms(torch, A, kern: str, args, causal: bool, scale: float, lse):
    """The root sum of squares of the terms each element of ``kern``'s
    bf16 outputs sums (o; dk, dv; dq), float32 (B, L, H, D), from the
    plain arithmetic on ``args``; ``lse`` is the forward's logsumexp."""
    q, k, v = args[:3]
    b, l, h, _ = q.shape
    f = torch.float32
    qs, kf, vf = A._bh(q, f) * scale, A._bh(k, f), A._bh(v, f)
    lse = lse.float()
    if kern != "flash_fwd":
        dof, delta = A._bh(args[3], f), args[5].float()
        do_norm, v_norm = dof.norm(dim=-1), vf.norm(dim=-1)
    outs = [torch.zeros_like(qs) for _ in range(2 if kern == "flash_bwd_dkdv" else 1)]
    for r0 in range(0, l, A._PLAIN_ROWS):
        r1 = min(r0 + A._PLAIN_ROWS, l)
        p = torch.exp(qs[:, r0:r1] @ kf.transpose(1, 2) - lse[:, r0:r1, None])
        live = A._live(r0, r1, l, causal, q.device)
        if live is not None:
            p = torch.where(live, p, 0.0)
        if kern == "flash_fwd":
            outs[0][:, r0:r1] = p.square() @ vf.square()
            continue
        ds2 = (p * ((dof[:, r0:r1] @ vf.transpose(1, 2) - delta[:, r0:r1, None]).abs()
                    + DS_F32 * do_norm[:, r0:r1, None] * v_norm[:, None, :])).square()
        if kern == "flash_bwd_dq":
            outs[0][:, r0:r1] = (ds2 @ kf.square()) * scale ** 2
        else:
            outs[0] += ds2.transpose(1, 2) @ qs[:, r0:r1].square()
            outs[1] += p.square().transpose(1, 2) @ dof[:, r0:r1].square()
    return [A._blhd(x.sqrt(), b, h, f) for x in outs]


def attn_check(torch, got, want, kind: str, terms=None):
    """(max abs error, worst error as a share of its limit, median |want|,
    row of the worst element) of a kernel output of ``kind`` (out, grad,
    lse) against the plain version's ``want``; ``terms`` is the output's
    :func:`attn_terms` where it is bf16."""
    want = want.double()
    d = (got.double() - want).abs()
    if kind == "lse" or got.dtype != torch.bfloat16:
        tol = F32_TOL[kind]
    else:
        tol = (BF16_TERMS * terms.double() + BF16_RTOL * want.abs()
               + BF16_FLOOR * float(want.pow(2).mean().sqrt()))
    ratio = d / tol
    i = int(ratio.argmax())
    row = (i // (want.shape[2] * want.shape[3])) % want.shape[1] \
        if want.dim() == 4 else i % want.shape[-1]
    return float(d.max()), float(ratio.max()), float(want.abs().median()), row


def attn_bound_ms(k: str, shape, causal: bool, itemsize: int,
                  flops_per_s: float) -> tuple[float, float]:
    """(bytes time, operations time) in ms: the least time an H100 needs
    for one call at ``shape`` (B, L, H, D); causal work counts only the
    L(L+1)/2 live (query, key) pairs."""
    b, l, h, d = shape
    pairs = b * h * (l * (l + 1) // 2 if causal else l * l)
    reads, writes, rows = ATTN_MOVES[k]
    nbytes = (reads + writes) * b * l * h * d * itemsize + rows * b * h * l * 4
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2 * ATTN_PRODUCTS[k] * pairs * d / flops_per_s * 1e3)


def _attn_inputs(torch, shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def phase_build():
    """nvcc builds every CUDA library of the port before any kernel runs, so
    the build is timed and ptxas's report printed here (a later first
    launch finds the libraries built)."""
    import re

    from tpu_syncbn_torch.ops import _cuda_build

    t0 = time.perf_counter()
    paths = _cuda_build.build()
    secs = time.perf_counter() - t0
    for stem, out in sorted(_cuda_build.LAST_BUILD["ptxas"].items()):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", out)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", out))
        # ptxas notes a wgmma it had to serialize (no room for its registers
        # to stay apart while it runs) as a "Potential Performance Loss"
        serial = len(re.findall(r"wgmma.mma_async instructions are serialized", out))
        log(f"[build] {stem}: {len(regs)} kernels, registers "
            f"{min(regs)}-{max(regs)}, spill stores {spills} bytes, "
            f"{serial} kernels with serialized wgmma")
    log(f"[build] nvcc built {len(_cuda_build.LAST_BUILD['compiled'])} "
        f"of {len(paths)} libraries in {secs:.1f}s (one nvcc per source, in "
        f"parallel) into {os.path.dirname(next(iter(paths.values())))}")
    # the Hopper design is on the path: the machine code of every attention
    # library holds warpgroup products (HGMMA) and TMA loads (UTMALDG); the
    # BN libraries stream with plain 16-byte loads and hold neither
    cuobjdump = os.path.join(os.path.dirname(_cuda_build.nvcc()), "cuobjdump")
    for stem, path in sorted(paths.items()):
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        n = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
        log(f"[build] {stem} SASS: " + ", ".join(f"{op} {c}" for op, c in n.items()))
        if stem in HOPPER_KERNELS and not all(n.values()):
            fail(f"{stem}: no {' or '.join(op for op, c in n.items() if not c)} "
                 "in its machine code: the Hopper design is not on the path")
    return secs


def _fused_qkv_inputs(torch, shape, seed):
    """bf16 q, k, v as (B, L, H, D) views into one fused (B, L, 3*H*D)
    tensor, as the LM's QKV product hands them over (row stride 3*H*D),
    and a contiguous dO."""
    b, l, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, l, 3 * h * d, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (x.view(b, l, h, d) for x in qkv.split(h * d, -1))
    do = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    return q, k, v, do


def phase_attn_parity(torch, A):
    """Each attention kernel against its plain version (float64 for float32
    inputs) on the same inputs — the backward kernels on the forward
    kernel's own lse and delta — causal and not, at every parity shape,
    and once, causal bf16 at the LM shape, on views into a fused QKV
    tensor. Returns the disagreements with the rest; main() fails on them
    after the LM phases, so one run shows every kernel's gate."""
    log(f"[attn-parity] limits: float32 vs float64 |err| <= out "
        f"{F32_TOL['out']:.0e}, grad {F32_TOL['grad']:.0e}, lse {F32_TOL['lse']:.0e}; "
        f"bfloat16 |err| <= {BF16_TERMS:.2e} x root sum of squares of the "
        f"element's terms + {BF16_RTOL:.2e}|x| + {BF16_FLOOR:.2e} x the "
        f"tensor's RMS, lse {F32_TOL['lse']:.0e}")
    worst = {k: 0.0 for k in ATTN_KERNELS}
    failures = []

    def check(shape, causal, dtype, fused):
        dname = str(dtype).split(".")[-1]
        scale = shape[-1] ** -0.5
        if fused:
            q, k, v, do = _fused_qkv_inputs(torch, shape, seed=sum(shape))
        else:
            q, k, v, do = _attn_inputs(torch, shape, dtype, seed=sum(shape) + causal)
        kw = dict(causal=causal, scale=scale)
        o, lse = A.flash_fwd(q, k, v, **kw)
        delta = A.row_delta(do, o)
        dk, dv = A.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        dq = A.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ref = (lambda x: x.double()) if dtype == torch.float32 else (lambda x: x)
        rq, rk, rv, rdo = (ref(x) for x in (q, k, v, do))
        po, plse = A.flash_fwd_plain(rq, rk, rv, **kw)
        args = (rq, rk, rv, rdo, ref(lse), ref(delta))
        pdk, pdv = A.flash_bwd_dkdv_plain(*args, **kw)
        pdq = A.flash_bwd_dq_plain(*args, **kw)
        if dtype == torch.bfloat16:
            t_o, = attn_terms(torch, A, "flash_fwd", (q, k, v), causal, scale, plse)
            t_dk, t_dv = attn_terms(torch, A, "flash_bwd_dkdv", args, causal, scale, lse)
            t_dq, = attn_terms(torch, A, "flash_bwd_dq", args, causal, scale, lse)
        else:
            t_o = t_dk = t_dv = t_dq = None
        checks = {"flash_fwd": [("o", o, po, "out", t_o), ("lse", lse, plse, "lse", None)],
                  "flash_bwd_dkdv": [("dk", dk, pdk, "grad", t_dk),
                                     ("dv", dv, pdv, "grad", t_dv)],
                  "flash_bwd_dq": [("dq", dq, pdq, "grad", t_dq)]}
        what = f"{str(shape):18s} {'causal' if causal else 'full  '} {dname:8s}" \
            + (" fused-qkv" if fused else "")
        for kern, outs in checks.items():
            parts, ratio = [], 0.0
            for name, got, want, kind, terms in outs:
                abs_e, r, med, row = attn_check(torch, got, want, kind, terms)
                parts.append(f"{name} max_abs_err={abs_e:.3e} median|ref|={med:.3e} "
                             f"{r:.2f} of tol (row {row})")
                ratio = max(ratio, r)
                worst[kern] = max(worst[kern], abs_e)
            ok = ratio <= 1.0
            log(f"[attn-parity] {kern:15s} {what} {'; '.join(parts)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{kern} disagrees with its plain version at {what}")

    cases = [(shape, causal, dtype, False) for shape in ATTN_PARITY_SHAPES
             for causal in (True, False) for dtype in (torch.float32, torch.bfloat16)]
    cases.append((ATTN_SHAPE, True, torch.bfloat16, True))
    for case in cases:
        check(*case)
    return worst, len(cases), failures


def phase_attn_time(torch, A, card):
    """Device time of each attention kernel at the LM slice's shape (bf16),
    causal (the path) and not; beside it the bound, the plain version and
    scaled_dot_product_attention (a yardstick only: the port never calls
    it). Then the kernels' times at every parity shape, and the float32
    kernels' times at the LM shape."""
    import torch.nn.functional as F

    shape, scale = ATTN_SHAPE, ATTN_SHAPE[-1] ** -0.5
    out = {}
    for causal in (True, False):
        tag = "causal" if causal else "full"
        q, k, v, do = _attn_inputs(torch, shape, torch.bfloat16, seed=11)
        kw = dict(causal=causal, scale=scale)
        o, lse = A.flash_fwd(q, k, v, **kw)
        delta = A.row_delta(do, o)
        calls = {
            "flash_fwd": (lambda: A.flash_fwd(q, k, v, **kw),
                          lambda: A.flash_fwd_plain(q, k, v, **kw)),
            "flash_bwd_dkdv": (
                lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw),
                lambda: A.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, **kw)),
            "flash_bwd_dq": (
                lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                lambda: A.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)),
        }
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        # at this shape a call lasts milliseconds: its launch is a
        # negligible part of the event time
        sdpa_fwd = _event_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 5, 5)
        # the closest single library call to the backward pair: ATen's
        # flash-attention backward, dQ, dK and dV in one call
        fa = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=scale)
        aten_bwd = _event_ms(
            torch, lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, fa[0], fa[1], fa[2], fa[3], fa[4], fa[5], 0.0,
                causal, fa[6], fa[7], scale=scale), 5, 5)
        for kern, (kfn, pfn) in calls.items():
            t_k = _event_ms(torch, kfn, 5, 5)
            t_p = _event_ms(torch, pfn, 1, 3)
            bytes_ms, ops_ms = attn_bound_ms(kern, shape, causal, 2, BF16_FLOPS_PER_S)
            bound = max(bytes_ms, ops_ms)
            lib = sdpa_fwd if kern == "flash_fwd" else None
            out[(kern, causal)] = dict(ms=t_k, plain_ms=t_p, bound_ms=bound,
                                       bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                       library_ms=lib)
            log(f"[attn-time] {kern:15s} {tag:6s} {shape} bf16 device: "
                f"kernel={t_k:.3f}ms plain={t_p:.3f}ms bound={bound:.3f}ms "
                f"({out[(kern, causal)]['bound_by']}, {100 * bound / t_k:.1f}% "
                f"of bound) "
                + (f"sdpa={lib:.3f}ms " if lib is not None else "")
                + f"[{card}]")
        # forward plus backward as a whole, through the autograd Function
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        qtr, ktr, vtr = (x.detach().requires_grad_() for x in (qt, kt, vt))

        def ours():
            A.flash_attention(qr, kr, vr, causal=causal, backward="pallas").backward(do)

        def sdpa():
            F.scaled_dot_product_attention(qtr, ktr, vtr, is_causal=causal).backward(dot)

        t_fb, t_sfb = _event_ms(torch, ours, 3, 3), _event_ms(torch, sdpa, 3, 3)
        bound_fb = sum(max(attn_bound_ms(kk, shape, causal, 2, BF16_FLOPS_PER_S))
                       for kk in ATTN_KERNELS)
        log(f"[attn-time] forward+backward {tag:6s} {shape} bf16 device: "
            f"kernels={t_fb:.3f}ms bound={bound_fb:.3f}ms sdpa={t_sfb:.3f}ms "
            f"sdpa_fwd={sdpa_fwd:.3f}ms [{card}]")
        pair = out[("flash_bwd_dkdv", causal)]["ms"] + out[("flash_bwd_dq", causal)]["ms"]
        log(f"[attn-time] backward pair {tag:6s} {shape} bf16 device: "
            f"flash_bwd_dkdv+flash_bwd_dq={pair:.3f}ms "
            f"aten_flash_attention_backward={aten_bwd:.3f}ms [{card}]")
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, qr, kr, vr, qtr, ktr, vtr, fa
    # every parity shape, bf16: device time (CUDA graph of 10 calls; at the
    # small shapes a call's host cost exceeds the kernel) against the
    # bound, beside the SDPA forward (yardstick only)
    for shp in ATTN_PARITY_SHAPES:
        q, k, v, do = _attn_inputs(torch, shp, torch.bfloat16, seed=13)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        for causal in (True, False):
            kw = dict(causal=causal, scale=shp[-1] ** -0.5)
            o, lse = A.flash_fwd(q, k, v, **kw)
            delta = A.row_delta(do, o)
            parts = []
            for kern, fn in (
                    ("flash_fwd", lambda: A.flash_fwd(q, k, v, **kw)),
                    ("flash_bwd_dkdv", lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)),
                    ("flash_bwd_dq", lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw))):
                t = _device_ms(torch, fn, 10)
                bound = max(attn_bound_ms(kern, shp, causal, 2, BF16_FLOPS_PER_S))
                parts.append(f"{kern} {t * 1e3:.1f}/{bound * 1e3:.1f}us")
            t_s = _device_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), 10)
            log(f"[attn-shape] {str(shp):18s} {'causal' if causal else 'full  '} "
                f"bf16 device kernel/bound: {', '.join(parts)}; sdpa forward "
                f"{t_s * 1e3:.1f}us [{card}]")
        del q, k, v, do, qt, kt, vt, o, lse, delta
    # a fixed 1024 blocks (128 rows of one head each, one block per SM at a
    # time) with walks of 128 down to 16 tiles: the time's least-squares
    # line in L splits into a cost per key walked and a fixed part, which
    # over ceil(1024 / SMs) waves is each block's fixed cost
    sweep = [(2 * 8192 // l, l, 8, 64) for l in (8192, 4096, 2048, 1024)]
    waves = -(-1024 // torch.cuda.get_device_properties(0).multi_processor_count)
    times = {kern: [] for kern in ATTN_KERNELS}
    for shp in sweep:
        q, k, v, do = _attn_inputs(torch, shp, torch.bfloat16, seed=14)
        kw = dict(causal=False, scale=shp[-1] ** -0.5)
        o, lse = A.flash_fwd(q, k, v, **kw)
        delta = A.row_delta(do, o)
        for kern, fn in (
                ("flash_fwd", lambda: A.flash_fwd(q, k, v, **kw)),
                ("flash_bwd_dkdv", lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)),
                ("flash_bwd_dq", lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw))):
            times[kern].append(_device_ms(torch, fn, 10) * 1e3)
        del q, k, v, do, o, lse, delta
    for kern, ts in times.items():
        slope, fixed = statistics.linear_regression([shp[1] for shp in sweep], ts)
        log(f"[attn-sweep] {kern:15s} full bf16, 1024 blocks, (B, L) = "
            f"{', '.join(f'({s[0]}, {s[1]})' for s in sweep)} x 8 heads x 64: "
            f"{' / '.join(f'{t:.1f}' for t in ts)}us; fit {slope * 1e3:.2f}us per "
            f"1000 keys + {fixed:.1f}us = {fixed / waves:.2f}us per block "
            f"({waves} waves) [{card}]")
    # float32 kernels (full f32 on the CUDA cores; 67 TFLOP/s peak)
    q, k, v, do = _attn_inputs(torch, shape, torch.float32, seed=12)
    o, lse = A.flash_fwd(q, k, v, causal=True, scale=scale)
    delta = A.row_delta(do, o)
    kw = dict(causal=True, scale=scale)
    for kern, fn in (("flash_fwd", lambda: A.flash_fwd(q, k, v, **kw)),
                     ("flash_bwd_dkdv", lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)),
                     ("flash_bwd_dq", lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw))):
        t = _event_ms(torch, fn, 2, 3)
        bound = max(attn_bound_ms(kern, shape, True, 4, F32_FLOPS_PER_S))
        log(f"[attn-time] {kern:15s} causal {shape} float32 device: "
            f"kernel={t:.3f}ms bound={bound:.3f}ms (f32 rate) [{card}]")
    return out


@contextlib.contextmanager
def checking_every_attn_call(torch, A, seen):
    """Inside the block, every attention kernel call is followed by its
    plain version on the same arguments and held to the parity phase's
    limits, which follow each element's own terms: the LM's gradients are
    ~1e-7 (a token-mean loss over 16384 tokens) and fall off along a
    causal sequence. ``seen[kernel] = (calls, worst error / limit, worst
    abs error, median |plain| of a bf16 output, row of the worst
    element)``."""
    saved = {k: getattr(A, k) for k in ATTN_KERNELS}

    def run(*args, _k, _kern, _plain, **kw):
        got = _kern(*args, **kw)
        want = _plain(*args, **kw)
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        lse = want_t[1] if _k == "flash_fwd" else args[4]
        terms = attn_terms(torch, A, _k, args, kw["causal"], kw["scale"], lse)
        calls, r0, a0, m0, row0 = seen.get(_k, (0, 0.0, 0.0, 0.0, -1))
        for i, (g_, w_) in enumerate(zip(got_t, want_t)):
            kind = "lse" if w_.dtype == torch.float32 else "out"
            abs_e, r, med, row = attn_check(torch, g_, w_, kind,
                                            terms[i] if kind == "out" else None)
            a0 = max(a0, abs_e)
            if kind == "out":
                m0 = max(m0, med)
            if r > r0:
                r0, row0 = r, row
        seen[_k] = (calls + 1, r0, a0, m0, row0)
        return got

    for k in ATTN_KERNELS:
        setattr(A, k, functools.partial(run, _k=k, _kern=saved[k],
                                        _plain=getattr(A, f"{k}_plain")))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(A, k, fn)


def phase_lm(torch, A, card):
    """The slice's LM trained by the port's own step function, every
    attention call through the three kernels."""
    from tpu_syncbn_torch import longcontext_train as lct
    from tpu_syncbn_torch import models

    L, n_layers = LM_CFG["max_len"], LM_CFG["n_layers"]
    model = models.init_transformer_lm(0, **LM_CFG, dtype=torch.bfloat16,
                                       device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    opt = torch.optim.Adam(model.parameters(), lr=LM_LR)
    stream = lct.periodic_batches(0, LM_BATCH, L, LM_CFG["vocab"])

    def batch():
        toks = torch.from_numpy(next(stream)).to("cuda")
        return toks[:, :L], toks[:, 1:]

    torch.cuda.reset_peak_memory_stats()
    # the main path: every attention launch count starts at 0 here
    A.reset_launch_counts()
    times, losses = [], []
    for i in range(LM_STEPS):
        inputs, labels = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(lct.train_step(model, opt, inputs, labels,
                                    attn_impl="flash_pallas_bwd"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"[lm] step {i + 1} loss {loss:.4f} time {times[-1] * 1e3:.1f}ms [{card}]")
    launches = A.launch_counts()
    log(f"[lm] kernels {json.dumps(launches)}")
    for k, n in launches.items():
        if n != n_layers * LM_STEPS:
            fail(f"{k} launched {n} times in {LM_STEPS} steps, expected "
                 f"{n_layers * LM_STEPS}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite LM loss in {losses}")
    steady = times[1:]  # the first step warms cuBLAS and the allocator
    med = statistics.median(steady)
    tokens = LM_BATCH * L
    log(f"[lm] {n_params / 1e6:.1f}M parameters, {n_layers} layers, batch "
        f"{LM_BATCH} x L {L} bf16: first step {times[0] * 1e3:.1f}ms, steady "
        f"median {med * 1e3:.2f}ms over {len(steady)} steps "
        f"({min(steady) * 1e3:.1f}-{max(steady) * 1e3:.1f}) = "
        f"{tokens / med:.0f} tokens/s; loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB "
        f"[{card}]")
    prof = [batch(), batch()]
    profile_window(
        torch, lambda: [lct.train_step(model, opt, i_, l_, attn_impl="flash_pallas_bwd")
                        for i_, l_ in prof],
        "lm-profile", "attention kernels", lambda name: "flash" in name, card)
    return model, opt, batch, launches


def phase_lm_ab(torch, A, model, opt, batch, card):
    """One step from the same weights and batch with the kernels ("auto")
    and with their plain versions ("off"), every kernel call of the kernel
    step held against its plain version on that call's tensors; then one
    step of attn_impl="flash" (kernel forward, blockwise-scan backward).
    Returns the per-call disagreements, which main() fails on."""
    from tpu_syncbn_torch import longcontext_train as lct
    from tpu_syncbn_torch.ops import batch_norm as bn_ops

    n_layers = LM_CFG["n_layers"]
    inputs, labels = batch()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    opt_state = copy.deepcopy(opt.state_dict())

    def step(mode, impl, check=None):
        model.load_state_dict(state)
        opt.load_state_dict(copy.deepcopy(opt_state))
        with bn_ops.kernel_mode(mode), (check or contextlib.nullcontext()):
            loss = float(lct.train_step(model, opt, inputs, labels, attn_impl=impl))
        return loss, {n: p.grad.detach().float().clone()
                      for n, p in model.named_parameters()}

    seen: dict = {}
    l_k, g_k = step("auto", "flash_pallas_bwd", checking_every_attn_call(torch, A, seen))
    l_p, g_p = step("off", "flash_pallas_bwd")
    loss_err = abs(l_k - l_p) / max(abs(l_p), 1e-6)
    log(f"[lm-a/b] loss kernels {l_k:.6f} plain {l_p:.6f} rel_err "
        f"{loss_err:.2e} (tol 1e-2: bf16 activations through {n_layers} layers)")
    failures = []
    for k in ATTN_KERNELS:
        calls, r, abs_e, med, row = seen.get(k, (0, 0.0, 0.0, 0.0, -1))
        log(f"[lm-a/b] {k:15s} at each of {calls} calls of the kernel step vs "
            f"its plain version on the same tensors (parity limits): worst "
            f"{r:.2f} of tol at row {row}, max_abs_err {abs_e:.3e}, "
            f"median|ref| {med:.3e} {'ok' if calls == n_layers and r <= 1.0 else 'FAIL'}")
        if calls != n_layers or r > 1.0:
            failures.append(f"{k} disagrees with its plain version inside the "
                            f"LM step ({calls} calls, worst {r:.2f} of tol)")

    def by_group(got, want):
        groups: dict = {}
        for n in want:
            grp = n.split(".")[-1]
            d2, r2 = groups.get(grp, (0.0, 0.0))
            groups[grp] = (d2 + float((got[n] - want[n]).norm()) ** 2,
                           r2 + float(want[n].norm()) ** 2)
        return ", ".join(f"{g} {math.sqrt(d / max(r, 1e-60)):.2e}"
                         for g, (d, r) in sorted(groups.items()))

    # shown, not gated: whole-model gradients move under bf16 rounding alone
    # (PERF.md, Findings); the per-call check above is the gate
    log(f"[lm-a/b] gradients, norm rel_err by parameter, kernels vs plain: "
        f"{by_group(g_k, g_p)}")
    A.reset_launch_counts()
    l_f, g_f = step("auto", "flash")
    counts = A.launch_counts()
    log(f"[lm-a/b] attn_impl='flash' (kernel forward, scan backward): loss "
        f"{l_f:.6f} (kernel backward {l_k:.6f}), launches {json.dumps(counts)}, "
        f"gradients vs kernel backward: {by_group(g_f, g_k)}")
    if counts != {"flash_fwd": n_layers, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}:
        fail(f"attn_impl='flash' launched {counts}")
    if loss_err > 1e-2 or abs(l_f - l_k) > 1e-2 * abs(l_k) or not math.isfinite(l_f):
        fail("the LM step disagrees between kernels and plain versions")
    return failures


# -- [seq]: sequence parallelism across ranks (ROADMAP A.13a) ------------------

# Four processes share the one card over a gloo group, as [groups] does
# (gloo moves CUDA tensors through the host; NCCL needs a card a rank): the
# LM slice's attention at (2, 8192, 8, 64) bf16 sharded 2048 tokens a rank,
# and the LM itself at world 4. Not a throughput figure.
SEQ_WORLD = 4
SEQ_JOIN_S = 600
SEQ_SEED = 31
# sharded_self_attention's cases: every rank holds the global tensors
SEQ_CASES = {
    "ring": dict(impl="ring", causal=True),
    "ring_zigzag": dict(impl="ring_zigzag", causal=True),
    "ulysses": dict(impl="ulysses", causal=True),
    "ulysses+flash": dict(impl="ulysses", causal=True, local_impl="flash"),
    "ulysses+flash+pallas": dict(impl="ulysses", causal=True, local_impl="flash",
                                 local_backward="pallas"),
    "ulysses+flash+pallas full": dict(impl="ulysses", causal=False, local_impl="flash",
                                      local_backward="pallas"),
}
# each case's kernel calls a rank, in order: (kernel, variant)
SEQ_CALLS = {
    "ulysses+flash": [("flash_fwd", "causal")],
    "ulysses+flash+pallas": [("flash_fwd", "causal"), ("flash_bwd_dkdv", "causal"),
                             ("flash_bwd_dq", "causal")],
    "ulysses+flash+pallas full": [("flash_fwd", "full"), ("flash_bwd_dkdv", "full"),
                                  ("flash_bwd_dq", "full")],
}
# the LM at world 4: (depth, the LM's attention arguments). The dense arms'
# block attention keeps ~0.8 GB of f32 scores a block a layer for the
# backward, so they run 2 layers (8 would need ~26 GB a process)
SEQ_LM_ARMS = {
    "ring": (2, dict(attn_impl="ring")),
    "ulysses": (2, dict(attn_impl="ulysses")),
    "ulysses+flash+pallas": (LM_CFG["n_layers"], dict(
        attn_impl="ulysses", local_impl="flash", local_backward="pallas")),
}
SEQ_LM_STEPS = 3
# Attention limits, per element, against the exact attention (float64 plain
# arithmetic on the same bf16 inputs, by 1024-query-row blocks): the
# parity phase's bf16 limit (BF16_TERMS x the root sum of squares of the
# element's terms + BF16_RTOL |x| + BF16_FLOOR x RMS), which bounds a
# kernel's rounding of P and dS and the final bf16 rounding, and covers
# the dense paths (f32 arithmetic, one rounding) with room. The ring and
# the zigzag ring also carry k's and v's cotangents around the ring in
# bf16: at most SEQ_HOP_ROUNDINGS roundings a hop (the casts of up to two
# f32 block gradients, their add, the add of the cotangent coming back
# from the next rank), each within u = 2^-8 of a value no larger than the
# sum of |partial gradients| over 1024-query-row chunks; so dk and dv get
# SEQ_HOP_ROUNDINGS x world x u x that sum on top. The flash backward
# (world 1 and Ulysses alike) computes δ = rowsum(dO ∘ O) from its bf16
# output, off the exact δ by at most Σ_d |dO| x the output's limit; δ
# enters dS = P (dP − δ), so dq and dk get that error carried through P
# and |k| (|q|) on top, in every case. Each case must also be within its
# limit plus the reference's limit of the world-1 run of the same function
# (the port's flash_attention with the same backward).
SEQ_HOP_ROUNDINGS = 4
U_BF16 = 2.0 ** -8
# The LM arms against the world-1 LM (same seed, depth, global batch), bf16:
# they differ by rounding only (the order of f32 sums; four bf16 partial
# gradients, one a rank, summed across ranks in bf16 by gloo; GEMMs of a
# quarter of the rows). The rounding floor is measured in the same run, as
# [groups] does: the world-1 step whose gradient is taken as the same four
# partials — one backward for each rank's chunk of the token losses, each
# rounded to bf16 and accumulated in bf16 (4 roundings and 3 adds, as
# world 4's). The world-4 gradient and later losses must agree within
# SEQ_FLOOR_FACTOR x that floor (the other reorderings of f32 sums stay
# below it); the loss also within the f32 sum of 16384 cross-entropies in
# another order (16384 x 2^-24 of itself). A missing hop, mask or position
# offset moves a loss or a gradient by O(1).
SEQ_FLOOR_FACTOR = 5.0
SEQ_LOSS_SUM = LM_BATCH * LM_CFG["max_len"] * 2.0 ** -24


def _seq_inputs(torch, causal: bool):
    """q, k, v, dO: bf16 (2, 8192, 8, 64) on cuda:0 from a seed, the same in
    every process."""
    return _attn_inputs(torch, ATTN_SHAPE, torch.bfloat16, SEQ_SEED + int(causal))


def _seq_exact_bwd(torch, A, q, k, v, do, o, lse, dlim, causal: bool, scale: float):
    """The exact attention's gradients for dO (float64 plain arithmetic on
    the bf16 inputs, by query-row chunks of L / (2 world)), given the exact
    output and logsumexp; beside them, the sums of |partial dk| and
    |partial dv| over those chunks, and the bounds that an error of
    ``dlim`` (B*H, L) in δ = rowsum(dO ∘ O) puts on dq and dk (δ enters
    dS = P (dP − δ) in every row)."""
    f = torch.float64
    b, l, h, _ = q.shape
    delta = A.row_delta(do.to(f), o)
    _, qs, kf, vf, dof, lsef, deltaf = A._bwd_operands(
        q.to(f), k.to(f), v.to(f), do.to(f), lse, delta, scale)
    dq, edq = torch.empty_like(qs), torch.empty_like(qs)
    dk, dv, adk, adv, edk = (torch.zeros_like(kf) for _ in range(5))
    rows = l // (2 * SEQ_WORLD)
    for r0 in range(0, l, rows):
        r1 = r0 + rows
        p, ds = A._p_ds(qs[:, r0:r1], kf, vf, dof[:, r0:r1], lsef[:, r0:r1],
                        deltaf[:, r0:r1], A._live(r0, r1, l, causal, q.device))
        pv = p.transpose(1, 2) @ dof[:, r0:r1]
        pk = ds.transpose(1, 2) @ qs[:, r0:r1]
        dv += pv
        dk += pk
        adv += pv.abs()
        adk += pk.abs()
        dq[:, r0:r1] = (ds @ kf) * scale
        a = dlim[:, r0:r1, None]
        edq[:, r0:r1] = a * (p @ kf.abs()) * scale
        edk += p.transpose(1, 2) @ (a * qs[:, r0:r1].abs())
        del p, ds, pv, pk
    blhd = lambda x: A._blhd(x, b, h, f)  # noqa: E731
    return ({"dq": blhd(dq), "dk": blhd(dk), "dv": blhd(dv)},
            {"dk": blhd(adk), "dv": blhd(adv)},
            {"dq": blhd(edq), "dk": blhd(edk)}, delta.float())


def _seq_reference(torch, A, causal: bool) -> dict:
    """For one mask: the exact outputs, the per-element limits (module
    constants above), the ring's partial sums, and the world-1 runs of
    flash_attention with each backward, on the inputs of ``_seq_inputs``.
    The flash backward computes δ from its bf16 output, which is within
    the forward's limit of the exact one; that error of δ is in the dq
    and dk limits of every case."""
    f = torch.float64
    q, k, v, do = _seq_inputs(torch, causal)
    scale = q.shape[-1] ** -0.5
    o, lse = A.flash_fwd_plain(q.to(f), k.to(f), v.to(f), causal=causal, scale=scale)
    base = lambda t, x: (BF16_TERMS * t.double() + BF16_RTOL * x.abs()  # noqa: E731
                         + BF16_FLOOR * float(x.pow(2).mean().sqrt()))
    t_out, = attn_terms(torch, A, "flash_fwd", (q, k, v), causal, scale, lse.float())
    limit = {"out": base(t_out, o)}
    b, l, h, _ = q.shape
    dlim = (do.double() * limit["out"]).abs().sum(-1).transpose(1, 2).reshape(b * h, l)
    grads, partials, from_delta, delta = _seq_exact_bwd(
        torch, A, q, k, v, do, o, lse, dlim, causal, scale)
    exact = {"out": o, **grads}
    args = (q, k, v, do, lse.float(), delta)
    terms = {}
    terms["dk"], terms["dv"] = attn_terms(torch, A, "flash_bwd_dkdv", args, causal, scale,
                                          lse.float())
    terms["dq"], = attn_terms(torch, A, "flash_bwd_dq", args, causal, scale, lse.float())
    for p_, t in terms.items():
        limit[p_] = base(t, exact[p_]) + from_delta.get(p_, 0.0)
    del terms, from_delta, dlim
    world1 = {}
    for backward in ("xla", "pallas"):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = A.flash_attention(*leaves, causal=causal, backward=backward)
        out.backward(do)
        world1[backward] = {"out": out.detach(), "dq": leaves[0].grad,
                            "dk": leaves[1].grad, "dv": leaves[2].grad}
    return {"exact": exact, "limit": limit, "partials": partials, "world1": world1}


@contextlib.contextmanager
def _seq_kernel_check(torch, A, bn_ops, seen: dict, calls: list, state: dict):
    """Inside: each attention wrapper launches its kernel (kernel mode "on"),
    then runs again on the same tensors under kernel mode "off" (its plain
    version), and the two are held to the parity limits. ``seen["<kernel>
    <variant>"] = [calls, worst error / limit, worst abs error]``; every
    call appends ``(kernel, variant)`` to ``calls``; a plain version run
    outside that comparison counts in ``state["stray_plain"]``."""
    wrappers = {k: getattr(A, k) for k in ATTN_KERNELS}
    plains = {k: getattr(A, f"{k}_plain") for k in ATTN_KERNELS}

    def run(*args, _k, **kw):
        got = wrappers[_k](*args, **kw)
        state["checking"] = True
        try:
            with bn_ops.kernel_mode("off"):
                want = wrappers[_k](*args, **kw)
        finally:
            state["checking"] = False
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        lse = want_t[1] if _k == "flash_fwd" else args[4]
        terms = attn_terms(torch, A, _k, args, kw["causal"], kw["scale"], lse)
        variant = "causal" if kw["causal"] else "full"
        entry = seen.setdefault(f"{_k}<{variant}>", [0, 0.0, 0.0])
        entry[0] += 1
        for i, (g_, w_) in enumerate(zip(got_t, want_t)):
            kind = "lse" if w_.dtype == torch.float32 else "out"
            abs_e, r, _, _ = attn_check(torch, g_, w_, kind,
                                        terms[i] if kind == "out" else None)
            entry[1], entry[2] = max(entry[1], r), max(entry[2], abs_e)
        calls.append((_k, variant))
        return got

    def plain(*args, _k, **kw):
        if not state["checking"]:
            state["stray_plain"] += 1
        return plains[_k](*args, **kw)

    for k in ATTN_KERNELS:
        setattr(A, k, functools.partial(run, _k=k))
        setattr(A, f"{k}_plain", functools.partial(plain, _k=k))
    try:
        yield
    finally:
        for k in ATTN_KERNELS:
            setattr(A, k, wrappers[k])
            setattr(A, f"{k}_plain", plains[k])


def _seq_gloo_probe(torch, group) -> dict:
    """Which gloo collectives take bf16 CUDA tensors, and whether the values
    come back bit for bit: ``all_to_all_single`` and ``all_reduce``.
    Point-to-point sends are not probed:
    a send refused on one rank would leave its peer's receive waiting; the
    port's ppermute stages CUDA tensors through the host on gloo."""
    import torch.distributed as tdist

    n, me = tdist.get_world_size(group), tdist.get_rank(group)
    out = {}
    # integers below 256: bf16 holds them and their sums over 4 ranks exactly
    x = (torch.arange(4 * n, device="cuda") + 16 * me).to(torch.bfloat16)
    try:
        y = torch.empty_like(x)
        tdist.all_to_all_single(y, x, group=group)
        want = torch.cat([(torch.arange(4 * me, 4 * me + 4, device="cuda") + 16 * r)
                          for r in range(n)]).to(torch.bfloat16)
        out["all_to_all_single cuda bf16"] = "ok, bitwise" if torch.equal(y, want) \
            else "ran, values differ"
    except (RuntimeError, ValueError) as e:
        out["all_to_all_single cuda bf16"] = f"refused: {type(e).__name__}: {e}"[:200]
    try:
        y = x.clone()
        tdist.all_reduce(y, group=group)
        want = sum((torch.arange(4 * n, device="cuda") + 16 * r) for r in range(n))
        out["all_reduce cuda bf16"] = "ok, exact" if torch.equal(y, want.to(torch.bfloat16)) \
            else "ran, values differ"
    except (RuntimeError, ValueError) as e:
        out["all_reduce cuda bf16"] = f"refused: {type(e).__name__}: {e}"[:200]
    return out


def _seq_child(rank, d):
    """One of the SEQ_WORLD processes: cuda:0, a gloo group through a
    file:// rendezvous, ``runtime.initialize("cuda")``, kernel mode "on".
    Rank 0 saves the attention cases' whole outputs and gradients and the
    LM arms' step-1 gradients; every rank writes ``d/rank<r>.json``."""
    sys.path.insert(0, HERE)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SEQ_WORLD),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(SEQ_WORLD))
    import torch
    import torch.distributed as tdist

    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                             world_size=SEQ_WORLD, rank=rank)
    from tpu_syncbn_torch import longcontext_train as lct
    from tpu_syncbn_torch import models, runtime
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import cuda_attention as A
    from tpu_syncbn_torch.parallel import sequence

    if runtime.initialize("cuda") != torch.device("cuda", 0) \
            or runtime.process_count() != SEQ_WORLD:
        raise RuntimeError("runtime.initialize did not keep the gloo group")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bn_ops.set_kernel_mode("on")  # a CPU tensor raises; no wrapper falls back
    group = tdist.group.WORLD
    out = {"probe": _seq_gloo_probe(torch, group), "cases": {}, "lm": {}}
    saved = {}
    seen, calls, state = {}, [], {"checking": False, "stray_plain": 0}
    A.reset_launch_counts()
    with _seq_kernel_check(torch, A, bn_ops, seen, calls, state):
        for name, kw in SEQ_CASES.items():
            q, k, v, do = _seq_inputs(torch, kw["causal"])
            q, k, v = (x.requires_grad_() for x in (q, k, v))
            before, first = A.launch_counts(), len(calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = sequence.sharded_self_attention(group, q, k, v, **kw)
            o.backward(do)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
            out["cases"][name] = {
                "seconds": secs, "calls": calls[first:],
                "launches": {kk: n - before[kk] for kk, n in A.launch_counts().items()},
                "sums": {p: float(x.double().sum()) for p, x in got.items()}}
            if rank == 0:
                saved[name] = {p: x.cpu() for p, x in got.items()}
            del q, k, v, do, o, got
    out["kernel_check"], out["stray_plain"] = seen, state["stray_plain"]
    out["parity_launches"] = A.launch_counts()
    if rank == 0:
        torch.save(saved, os.path.join(d, "cases.pt"))
    del saved
    torch.cuda.empty_cache()

    L, grads = LM_CFG["max_len"], {}
    for arm, (depth, attn) in SEQ_LM_ARMS.items():
        model = models.init_transformer_lm(0, **dict(LM_CFG, n_layers=depth),
                                           dtype=torch.bfloat16, device="cuda")
        opt = torch.optim.Adam(model.parameters(), lr=LM_LR)
        stream = lct.periodic_batches(0, LM_BATCH, L, LM_CFG["vocab"])
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()  # the arm's path: counts from 0
        losses, times = [], []
        for step in range(SEQ_LM_STEPS):
            inputs, labels = (torch.from_numpy(x).to("cuda") for x in
                              lct.local_chunk(next(stream), rank, L // SEQ_WORLD))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(lct.train_step(model, opt, inputs, labels, group=group,
                                               **attn)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if step == 0 and rank == 0:
                grads[arm] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        out["lm"][arm] = {"losses": losses, "ms": times, "launches": A.launch_counts(),
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        del model, opt
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(grads, os.path.join(d, "lm_grads.pt"))
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown()


def _seq_world1_lm(torch, depth: int, attn: dict, split: bool):
    """The world-1 LM (group ALONE: ring and Ulysses are then their dense
    or flash attention over the whole sequence) from the children's seed and
    batches: SEQ_LM_STEPS Adam steps; returns the losses and step 1's
    gradients. ``split``: the gradient accumulated from one backward for
    each rank's chunk of the token losses (the rounding floor)."""
    import torch.nn.functional as F

    from tpu_syncbn_torch import longcontext_train as lct
    from tpu_syncbn_torch import models
    from tpu_syncbn_torch.parallel import collectives

    L = LM_CFG["max_len"]
    model = models.init_transformer_lm(0, **dict(LM_CFG, n_layers=depth),
                                       dtype=torch.bfloat16, device="cuda")
    opt = torch.optim.Adam(model.parameters(), lr=LM_LR)
    stream = lct.periodic_batches(0, LM_BATCH, L, LM_CFG["vocab"])
    losses, grads = [], None
    for step in range(SEQ_LM_STEPS):
        toks = torch.from_numpy(next(stream)).to("cuda")
        inputs, labels = toks[:, :L], toks[:, 1:]
        if not split:
            loss = float(lct.train_step(model, opt, inputs, labels,
                                        group=collectives.ALONE, **attn))
        else:
            opt.zero_grad(set_to_none=True)
            logits = model(inputs, group=collectives.ALONE, **attn)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1).long(), reduction="none")
            ce = ce.view(labels.shape) / labels.numel()
            chunk, loss = L // SEQ_WORLD, 0.0
            for r in range(SEQ_WORLD):
                part = ce[:, r * chunk:(r + 1) * chunk].sum()
                part.backward(retain_graph=r < SEQ_WORLD - 1)
                loss += float(part.detach())
            del logits, ce
            opt.step()
        losses.append(loss)
        if step == 0:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model, opt
    torch.cuda.empty_cache()
    return losses, grads


def _grad_rel_err(torch, got: dict, want: dict) -> float:
    """|got − want| / |want|, L2 over every parameter's gradient, float64."""
    d2 = sum(float((got[n].to(w.device).double() - w.double()).pow(2).sum())
             for n, w in want.items())
    r2 = sum(float(w.double().pow(2).sum()) for w in want.values())
    return math.sqrt(d2 / r2)


def _seq_attention_gates(torch, ref: dict, res: list, d: str, card) -> list:
    """The attention cases against the exact attention and against the
    world-1 run (SEQ_HOP_ROUNDINGS' comment), the kernel checks and the
    launch counts."""
    failures = []
    cases = torch.load(os.path.join(d, "cases.pt"))
    for name, kw in SEQ_CASES.items():
        r = ref[kw["causal"]]
        backward = kw.get("local_backward", "xla")
        w1 = r["world1"][backward]
        got = cases[name]
        parts, worst, worst_w1, same = [], 0.0, 0.0, True
        for p, x in r["exact"].items():
            lim = r["limit"][p]
            if kw["impl"].startswith("ring") and p in r["partials"]:
                lim = lim + SEQ_HOP_ROUNDINGS * SEQ_WORLD * U_BF16 * r["partials"][p]
            g = got[p].to(x.device)
            err = (g.double() - x).abs()
            ratio = float((err / lim).max())
            ratio_w1 = float(((g.double() - w1[p].double()).abs()
                              / (lim + r["limit"][p])).max())
            same = same and torch.equal(g, w1[p])
            worst, worst_w1 = max(worst, ratio), max(worst_w1, ratio_w1)
            parts.append(f"{p} max_abs_err={float(err.max()):.3e} {ratio:.3f}")
        secs = [res_["cases"][name]["seconds"] for res_ in res]
        ranks_agree = all(res_["cases"][name]["sums"] == res[0]["cases"][name]["sums"]
                          for res_ in res)
        ok = worst <= 1.0 and worst_w1 <= 1.0 and ranks_agree
        log(f"[seq] {name:25s} {'causal' if kw['causal'] else 'full'} {ATTN_SHAPE} bf16, "
            f"world 4: vs exact {'; '.join(parts)} of limit; vs world-1 flash_attention "
            f"(backward {backward!r}) {worst_w1:.3f} of both limits, bitwise {same}; ranks "
            f"agree {ranks_agree}; {min(secs):.2f}-{max(secs):.2f}s a rank (fwd+bwd, "
            f"four processes on one card) {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append(f"[seq] {name} disagrees ({worst:.3f} / {worst_w1:.3f} of limit)")
        want_calls = SEQ_CALLS.get(name, [])
        for rk, res_ in enumerate(res):
            c = res_["cases"][name]
            got_calls = [tuple(x) for x in c["calls"]]
            counts = {k: sum(1 for kk, _ in want_calls if kk == k) for k in ATTN_KERNELS}
            if got_calls != want_calls or c["launches"] != counts:
                failures.append(f"[seq] {name} rank {rk}: kernel calls {got_calls}, "
                                f"launches {c['launches']}, expected {want_calls}")
    for key in sorted(res[0]["kernel_check"]):
        per = [res_["kernel_check"][key] for res_ in res]
        n_calls = [p_[0] for p_ in per]
        r_ = max(p_[1] for p_ in per)
        a_ = max(p_[2] for p_ in per)
        b_, l_, h_, d_ = ATTN_SHAPE
        log(f"[seq] kernel {key:22s} at {(b_, l_, h_ // SEQ_WORLD, d_)} (H/{SEQ_WORLD} heads a rank): "
            f"{n_calls} calls a rank, each against its plain version (kernel mode "
            f"'off') on the same tensors: worst {r_:.3f} of the parity limit, "
            f"max_abs_err {a_:.3e} {'ok' if r_ <= 1.0 else 'FAIL'}")
        if r_ > 1.0:
            failures.append(f"[seq] {key} disagrees with its plain version ({r_:.3f})")
    strays = [res_["stray_plain"] for res_ in res]
    if any(strays):
        failures.append(f"[seq] a plain attention version ran outside the check: {strays}")
    log(f"[seq] plain versions run outside the kernel check, per rank: {strays}")
    return failures


def _seq_lm_gates(torch, res: list, d: str, card) -> tuple[list, dict]:
    """The LM arms against the world-1 LM and its rounding floor
    (SEQ_FLOOR_FACTOR's comment)."""
    failures, summary = [], {}
    grads = torch.load(os.path.join(d, "lm_grads.pt"))
    refs: dict = {}
    for arm, (depth, attn) in SEQ_LM_ARMS.items():
        key = (depth, "flash" if "local_impl" in attn else "dense")
        if key not in refs:  # ring and Ulysses are the same dense LM at world 1
            t0 = time.perf_counter()
            refs[key] = (_seq_world1_lm(torch, depth, attn, split=False),
                         _seq_world1_lm(torch, depth, attn, split=True),
                         time.perf_counter() - t0)
        (l1, g1), (ls, gs), ref_s = refs[key]
        l4 = [res_["lm"][arm]["losses"] for res_ in res]
        floor_loss = max(abs(a - b) / abs(b) for a, b in zip(ls, l1))
        loss_tol = SEQ_FLOOR_FACTOR * floor_loss + SEQ_LOSS_SUM
        loss_err = max(abs(a - b) / abs(b) for l_ in l4 for a, b in zip(l_, l1))
        floor_grad = _grad_rel_err(torch, gs, g1)
        grad_err = _grad_rel_err(torch, grads[arm], g1)
        grad_tol = SEQ_FLOOR_FACTOR * floor_grad
        ok = loss_err <= loss_tol and grad_err <= grad_tol
        counts = [res_["lm"][arm]["launches"] for res_ in res]
        want = (depth * SEQ_LM_STEPS if "local_impl" in attn else 0)
        launches_ok = all(c == {k: want if (k == "flash_fwd" or attn.get("local_backward")
                                             == "pallas") else 0 for k in ATTN_KERNELS}
                          for c in counts)
        log(f"[seq] lm {arm:21s} depth {depth}, world 4 vs world 1 (global batch "
            f"{LM_BATCH} x L {LM_CFG['max_len']}, bf16, {SEQ_LM_STEPS} Adam steps): losses "
            f"{[round(x, 6) for x in l4[0]]} vs {[round(x, 6) for x in l1]}, worst rel "
            f"err {loss_err:.3e} (tol {loss_tol:.3e} = {SEQ_FLOOR_FACTOR:g} x floor "
            f"{floor_loss:.3e} + {SEQ_LOSS_SUM:.2e}); step-1 gradient rel L2 "
            f"{grad_err:.3e} (tol {grad_tol:.3e} = {SEQ_FLOOR_FACTOR:g} x floor "
            f"{floor_grad:.3e}, the world-1 step's gradient as four bf16 partials); "
            f"world-1 reference and floor {ref_s:.1f}s {'ok' if ok else 'FAIL'}")
        log(f"[seq] lm {arm:21s} kernel launches a rank over {SEQ_LM_STEPS} steps "
            f"{counts[0]} (every rank the same: {all(c == counts[0] for c in counts)}; "
            f"expected {want} of each kernel the arm runs)")
        for rk, res_ in enumerate(res):
            lm = res_["lm"][arm]
            log(f"[seq] lm {arm:21s} rank {rk}: step ms "
                + ", ".join(f"{t:.1f}" for t in lm["ms"])
                + f"; peak {lm['peak_bytes'] / 2 ** 30:.2f} GiB: four processes "
                f"time-slicing one card through gloo host copies, not a throughput "
                f"figure [{card}]")
        if not ok:
            failures.append(f"[seq] lm {arm} at world 4 disagrees with world 1 "
                            f"(loss {loss_err:.3e} / {loss_tol:.3e}, gradient "
                            f"{grad_err:.3e} / {grad_tol:.3e})")
        if not launches_ok:
            failures.append(f"[seq] lm {arm}: launches {counts}, expected {want}")
        summary[arm] = {"depth": depth, "loss_rel_err": loss_err, "loss_tol": loss_tol,
                        "grad_rel_err": grad_err, "grad_tol": grad_tol,
                        "step_ms": [res_["lm"][arm]["ms"] for res_ in res],
                        "peak_bytes": [res_["lm"][arm]["peak_bytes"] for res_ in res],
                        "launches_per_rank": counts[0]}
    return failures, summary


def phase_seq(torch, A, card):
    """Sequence parallelism across ranks: the attention cases and the LM at
    world 4, four processes on the one card over gloo (SEQ_WORLD). Returns
    the failures and a summary."""
    import multiprocessing
    import tempfile

    t_phase = time.perf_counter()
    failures = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = {causal: _seq_reference(torch, A, causal) for causal in (True, False)}
    log(f"[seq] exact references, limits and world-1 runs in "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as d:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_seq_child, args=(r, d)) for r in range(SEQ_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + SEQ_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        if alive:
            fail(f"[seq] {len(alive)} of {SEQ_WORLD} processes still running after "
                 f"{SEQ_JOIN_S}s; killed")
        codes = [p.exitcode for p in procs]
        if codes != [0] * SEQ_WORLD:
            fail(f"[seq] process exit codes {codes}")
        log(f"[seq] four processes: {time.perf_counter() - t0:.1f}s from spawn to join")
        res = []
        for r in range(SEQ_WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                res.append(json.load(f))
        log(f"[seq] gloo on CUDA tensors: {json.dumps(res[0]['probe'])}")
        failures += _seq_attention_gates(torch, ref, res, d, card)
        del ref
        torch.cuda.empty_cache()
        lm_failures, lm = _seq_lm_gates(torch, res, d, card)
        failures += lm_failures
    secs = time.perf_counter() - t_phase
    log(f"[seq] phase done in {secs:.1f}s, {len(failures)} failures")
    variants = {}
    for key, (n, _, _) in res[0]["kernel_check"].items():
        variants[key] = n
    return failures, {"seconds": secs, "lm": lm, "parity_calls_per_rank": variants,
                      "probe": res[0]["probe"]}


# -- phase 20: tensor, expert and pipeline parallelism at world 4 ---------
# Four processes on the one card over gloo, one spawn (PAR_WORLD), as
# [seq]: Megatron TP and Switch EP at the LM slice's width, then the
# PipelineTrainer with the LM's own blocks as stages on the flash kernels,
# then the bench's pipeline sub-block. Not a throughput figure.
PAR_WORLD = 4
PAR_JOIN_S = 300
PAR_SEED = 41
PAR_TP = (2, 2048, LM_CFG["d_model"])  # TP input (B, L, d_model), f32
PAR_EP = dict(tokens=4096, experts=8, capacity_factor=1.25)  # tokens a rank
PAR_M = 8  # microbatches a step, each one 8192-token sequence of activations
PAR_STEPS = 2
PAR_LR = 1e-2
PAR_BLOCKS = ("ln1_scale", "ln2_scale", "wqkv", "wo", "w1", "w2")
# the pipeline arms: (data, pipe), LM blocks a stage, schedules
PAR_ARMS = {"1x4": ((1, 4), 2, ("1f1b", "gpipe")), "2x2": ((2, 2), 1, ("1f1b",))}
# TP and EP against the dense world-1 run: both are f32 sums of the same
# products in another order (K = 512 partials summed across 4 ranks by gloo
# against one K = 2048 GEMM; the experts' GEMMs batched (2, 2560) against
# (8, 640)), so each tensor's relative L2 error against a float64 run of the
# dense function must stay within PAR_FLOOR_FACTOR x the dense f32 run's own
# (its rounding floor, measured in the same call, at least one f32 rounding).
# A missing all-reduce, a wrong shard or a dropped 1/world moves them by O(1).
PAR_FLOOR_FACTOR = 5.0
U_F32 = 2.0 ** -24
# The (2, 2) arm against its oracle: every stage's inputs and calls are the
# oracle's, but the data-axis mean of the bf16 gradients is gloo's. Its
# rounding floor is one bf16 rounding of the exact mean (relative L2 of the
# f32 mean against its bf16 rounding): the gradients must stay within
# PAR_FLOOR_FACTOR x that, the losses (an f32 mean of two) within
# PAR_FLOOR_FACTOR f32 roundings, and a parameter may differ only where its
# gradient does, by lr x the gradient's difference and a bf16 rounding of
# each side.


def _par_stage(params, x):
    """A pipeline stage of [parallel]: the LM's blocks (each leaf's leading
    axis) on x (1, L, d_model), attention through the three kernels."""
    import types

    from tpu_syncbn_torch.models.transformer import _block

    blk = types.SimpleNamespace(**params)
    for i in range(blk.wqkv.shape[0]):
        x = _block(x, blk, i, n_heads=LM_CFG["n_heads"], attn_impl="flash_pallas_bwd",
                   group=None, local_impl=None, local_backward="xla")
    return x


def _par_loss(y, t):
    """The f32 MSE loss head."""
    return ((y.float() - t.float()) ** 2).mean()


def _par_batch(torch, step: int, replica: int = 0):
    """One step's (x_mb, t_mb), each (PAR_M, 1, L, d_model) bf16 on cuda:0,
    from a seed: the same in every process."""
    g = torch.Generator(device="cuda").manual_seed(PAR_SEED + 100 * step + replica)
    shape = (PAR_M, 1, LM_CFG["max_len"], LM_CFG["d_model"])
    return tuple(torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
                 for _ in range(2))


def _par_stages(torch):
    """The arms' stacked stage parameters from the LM slice's bf16 init: the
    8 blocks as (4, 2, ...) for 1x4, blocks 0 and 1 as (2, 1, ...) for 2x2."""
    from tpu_syncbn_torch import models

    lm = models.init_transformer_lm(0, **LM_CFG, dtype=torch.bfloat16, device="cpu")
    blocks = {n: getattr(lm.blocks, n).detach() for n in PAR_BLOCKS}
    out = {}
    for arm, ((_, pipe), per, _) in PAR_ARMS.items():
        out[arm] = {n: v[:pipe * per].reshape(pipe, per, *v.shape[1:]).clone()
                    for n, v in blocks.items()}
    return out


def _par_inputs(torch):
    """TP's and EP's f32 inputs on cuda:0 from a seed, the same in every
    process: weights scaled by fan_in^-1/2, cotangents standard normal."""
    g = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    d, f = LM_CFG["d_model"], LM_CFG["d_ff"]
    e, t = PAR_EP["experts"], PAR_EP["tokens"]

    def n(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=g) * scale

    return {"x": n(*PAR_TP), "w1": n(d, f, scale=d ** -0.5), "b1": n(f, scale=0.1),
            "w2": n(f, d, scale=f ** -0.5), "b2": n(d, scale=0.1), "dy": n(*PAR_TP),
            "xa": n(*PAR_TP), **{k: n(d, d, scale=d ** -0.5) for k in ("wq", "wk", "wv", "wo")},
            "dya": n(*PAR_TP), "xe": n(PAR_WORLD * t, d), "router": n(d, e, scale=d ** -0.5),
            "w_in": n(e, d, f, scale=d ** -0.5), "w_out": n(e, f, d, scale=f ** -0.5),
            "we": n(PAR_WORLD * t, d)}


#: each TP/EP case's arguments: (input key, layout) — "rep" replicated,
#: "col"/"row" the rank's block of the last/first dim, "tok" its token rows
PAR_CASES = {
    "tp_mlp": (("x", "rep"), ("w1", "col"), ("b1", "col"), ("w2", "row"), ("b2", "rep")),
    "tp_attention": (("xa", "rep"), ("wq", "col"), ("wk", "col"), ("wv", "col"),
                     ("wo", "row")),
    "ep": (("xe", "tok"), ("router", "rep"), ("w_in", "row"), ("w_out", "row")),
}


def _par_block(x, how: str, rank: int, world: int):
    from tpu_syncbn_torch.parallel.tensor import shard_columns, shard_rows

    if how == "col":
        return shard_columns(x, rank, world)
    if how in ("row", "tok"):
        return shard_rows(x, rank, world)
    return x


def _par_args(torch, name: str, inp: dict, rank: int, world: int, dtype) -> list:
    """The case's arguments on this rank (world 1: whole), leaves that
    require grad."""
    return [_par_block(inp[k], how, rank, world).to(dtype).detach().requires_grad_()
            for k, how in PAR_CASES[name]]


def _par_finish(torch, name: str, y, aux, args, inp, rank: int, world: int) -> dict:
    """Backward of ``sum(y * cotangent)`` (+ aux for EP); the output (EP:
    its rows flattened, then aux) and every argument's gradient."""
    w = _par_block(inp["we" if name == "ep" else "dy" if name == "tp_mlp" else "dya"],
                   "tok" if name == "ep" else "rep", rank, world).to(y.dtype)
    loss = (y * w).sum()
    if aux is not None:
        loss = loss + aux
        y = torch.cat([y.reshape(-1), aux.reshape(1).to(y.dtype)])
    loss.backward()
    return {"out": y.detach(), **{f"g{i}": a.grad for i, a in enumerate(args)}}


def _par_case(torch, name: str, inp: dict, group, rank: int, world: int) -> dict:
    """One TP/EP case on this rank's blocks, f32."""
    from tpu_syncbn_torch.parallel import expert, tensor

    args = _par_args(torch, name, inp, rank, world, torch.float32)
    aux = None
    if name == "tp_mlp":
        y = tensor.tp_mlp(*args, group)
    elif name == "tp_attention":
        y = tensor.tp_attention(*args, group, n_local_heads=LM_CFG["n_heads"] // world,
                                causal=True)
    else:
        y, aux = expert.expert_parallel_moe(*args, group,
                                            capacity_factor=PAR_EP["capacity_factor"])
    return _par_finish(torch, name, y, aux, args, inp, rank, world)


def _par_dense(torch, name: str, inp: dict, dtype) -> dict:
    """The dense world-1 function of a case on the whole inputs: the port's
    functions with no group in f32 (EP: dense_moe on every rank's shard, aux
    averaged); in float64 the same formulas evaluated in float64, EP routed
    as its f32 router routes (argmax, queue ranks, drops)."""
    import torch.nn.functional as F

    from tpu_syncbn_torch.parallel import expert, tensor

    args = _par_args(torch, name, inp, 0, 1, dtype)
    aux = None
    if name == "tp_mlp":
        y = tensor.tp_mlp(*args, None)
    elif name == "tp_attention" and dtype == torch.float32:
        y = tensor.tp_attention(*args, None, n_local_heads=LM_CFG["n_heads"], causal=True)
    elif name == "tp_attention":
        x, wq, wk, wv, wo = args
        b, l, dm = x.shape
        h = LM_CFG["n_heads"]
        q, k, v = ((x @ w).view(b, l, h, dm // h) for w in (wq, wk, wv))
        sc = torch.einsum("bqhd,bkhd->bqhk", q * (dm // h) ** -0.5, k)
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        sc = sc.masked_fill(~causal[None, :, None, :], float("-inf"))
        o = torch.einsum("bqhk,bkhd->bqhd", sc.softmax(-1), v)
        y = o.reshape(b, l, dm) @ wo
    else:
        x, router, w_in, w_out = args
        cf, ys, aux = PAR_EP["capacity_factor"], [], 0.0
        for r in range(PAR_WORLD):
            xr = _par_block(x, "tok", r, PAR_WORLD)
            if dtype == torch.float32:
                y_r, a_r = expert.dense_moe(xr, router, w_in, w_out, capacity_factor=cf)
            else:
                e = router.shape[-1]
                c = expert._capacity(xr.shape[0], e, cf)
                dispatch, _, _ = expert.switch_route(xr.detach().float(),
                                                     router.detach().float(), c)
                dispatch = dispatch.to(dtype)
                probs = torch.softmax(xr @ router, dim=-1)
                idx = torch.argmax(torch.softmax(
                    xr.detach().float() @ router.detach().float(), -1), -1)
                onehot = F.one_hot(idx, e).to(dtype)
                out = expert._expert_mlp(torch.einsum("tec,td->ecd", dispatch, xr),
                                         w_in, w_out)
                y_r = torch.einsum("tec,ecd->td", dispatch * probs[:, :, None], out)
                a_r = e * torch.sum(onehot.mean(0) * probs.mean(0))
            ys.append(y_r)
            aux = aux + a_r / PAR_WORLD
        y = torch.cat(ys)
    return _par_finish(torch, name, y, aux, args, inp, 0, 1)


def _digest(torch, t) -> list:
    """(sha256 of the bytes, float64 L2 norm): bit-for-bit comparison across
    processes without moving the tensors."""
    import hashlib

    b = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return [hashlib.sha256(b).hexdigest(), float(t.detach().double().norm())]


def _par_train(torch, A, layout, stacked, sched, save=None):
    """One pipeline arm on this rank: PAR_STEPS SGD steps; each step's loss,
    host ms, launches a step (counts from 0 before each), and digests of the
    stage's gradients and updated parameters."""
    from tpu_syncbn_torch.parallel import pipeline as pp

    tr = pp.PipelineTrainer(_par_stage, _par_loss, stacked,
                            lambda ps: torch.optim.SGD(ps, lr=PAR_LR),
                            num_microbatches=PAR_M, schedule=sched, layout=layout)
    di = layout.ranks.index(int(os.environ["RANK"])) // layout.axis_sizes["pipe"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for k in range(PAR_STEPS):
        batch = _par_batch(torch, k, di)
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(tr.train_step(batch).loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ps = tr._params
        steps.append({"loss": loss, "ms": ms, "launches": A.launch_counts(),
                      "grads": {n: _digest(torch, p.grad) for n, p in ps.items()},
                      "params": {n: _digest(torch, p) for n, p in ps.items()}})
        if save is not None:
            save[k] = {"grads": {n: p.grad.to("cpu", copy=True) for n, p in ps.items()},
                       "params": {n: p.detach().to("cpu", copy=True) for n, p in ps.items()}}
    return {"stage": tr.stage, "replica": di, "ticks": tr.schedule.ticks, "steps": steps,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def _par_child(rank, d):
    """One of the PAR_WORLD processes: cuda:0, a gloo group through a
    file:// rendezvous, kernel mode "on". Writes its TP/EP tensors to
    ``d/case<r>.pt``, the 2x2 arm's stage-0/1 tensors to ``d/arm2x2_<r>.pt``
    (replica 0) and everything else to ``d/rank<r>.json``."""
    sys.path.insert(0, HERE)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(PAR_WORLD),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(PAR_WORLD))
    import torch
    import torch.distributed as tdist

    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                             world_size=PAR_WORLD, rank=rank)
    from tpu_syncbn_torch import bench, runtime
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import cuda_attention as A
    from tpu_syncbn_torch.parallel import collectives
    from tpu_syncbn_torch.parallel import pipeline as pp

    if runtime.initialize("cuda") != torch.device("cuda", 0) \
            or runtime.process_count() != PAR_WORLD:
        raise RuntimeError("runtime.initialize did not keep the gloo group")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bn_ops.set_kernel_mode("on")  # a CPU tensor raises; no wrapper falls back
    plain = _count_plain_attention(A)
    group = tdist.group.WORLD
    out = {"cases": {}, "arms": {}}
    t0 = time.perf_counter()
    inp = _par_inputs(torch)
    saved = {}
    for name in PAR_CASES:
        collectives.reset_tallies()
        res = _par_case(torch, name, inp, group, rank, PAR_WORLD)
        out["cases"][name] = {"tallies": collectives.tallies()}
        saved[name] = {k: v.cpu() for k, v in res.items()}
    torch.save(saved, os.path.join(d, f"case{rank}.pt"))
    del inp, saved
    out["cases_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    stages = torch.load(os.path.join(d, "stages.pt"))
    for arm, ((data, pipe), _, scheds) in PAR_ARMS.items():
        layout = pp.pipeline_mesh(pipe, device="cuda")
        if layout.axis_sizes != {"data": data, "pipe": pipe}:
            raise RuntimeError(f"pipeline_mesh({pipe}) gave {layout.axis_sizes}")
        for sched in scheds:
            save = {} if arm == "2x2" and rank < pipe else None
            out["arms"][f"{arm} {sched}"] = _par_train(
                torch, A, layout, stages[arm], sched, save)
            if save is not None:
                torch.save(save, os.path.join(d, f"arm2x2_{rank}.pt"))
            torch.cuda.empty_cache()
    out["plain_calls"] = dict(plain)
    collectives.reset_tallies()
    t0 = time.perf_counter()
    out["bench"] = bench.measure_pipeline_bubbles(group, torch.device("cuda", 0))
    out["bench_s"] = time.perf_counter() - t0
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown()


def _count_plain_attention(A) -> dict:
    """Wrap the attention kernels' plain versions in this process with
    counters: on CUDA tensors they must never run."""
    calls = {k: 0 for k in ATTN_KERNELS}

    def counted(fn, k):
        def run(*a, **kw):
            calls[k] += 1
            return fn(*a, **kw)
        return run

    for k in ATTN_KERNELS:
        setattr(A, f"{k}_plain", counted(getattr(A, f"{k}_plain"), k))
    return calls


def _par_oracle(torch, stacked: dict, replicas: int):
    """The stages in sequence at world 1, PAR_STEPS SGD steps: for each
    replica and microbatch the trainer's calls in its order — the forward
    without a tape, then per microbatch (ascending, as both schedules run
    them on every stage) the recompute from the saved input and
    ``autograd.grad`` against the stage's parameters and input, the
    gradients accumulated in the parameters' dtype, divided by M, averaged
    over the replicas ((a + b) / 2 in bf16). Returns each step's loss,
    gradients and updated parameters per stage, and with two replicas the
    gradients' exact mean (in f32) beside them."""
    from torch import nn

    n = next(iter(stacked.values())).shape[0]
    params = [{k: nn.Parameter(v[s].to("cuda", copy=True)) for k, v in stacked.items()}
              for s in range(n)]
    opts = [torch.optim.SGD(list(p.values()), lr=PAR_LR) for p in params]
    steps = []
    for k in range(PAR_STEPS):
        losses, grads = [], []
        for r in range(replicas):
            x_mb, t_mb = _par_batch(torch, k, r)
            gacc = [[torch.zeros_like(p) for p in ps.values()] for ps in params]
            saved = [[None] * PAR_M for _ in range(n)]
            loss_acc = torch.zeros((), dtype=torch.float32, device="cuda")
            with torch.no_grad():
                for j in range(PAR_M):
                    x = x_mb[j]
                    for s in range(n):
                        saved[s][j] = x
                        x = _par_stage(params[s], x)
                    loss_acc = loss_acc + _par_loss(x, t_mb[j]).float()
            for j in range(PAR_M):
                gy = None
                for s in reversed(range(n)):
                    plist = list(params[s].values())
                    with torch.enable_grad():
                        xb = saved[s][j].detach().requires_grad_(s > 0)
                        yb = _par_stage(params[s], xb)
                        if s == n - 1:
                            yy = yb.detach().requires_grad_()
                            gy, = torch.autograd.grad(_par_loss(yy, t_mb[j]).float(), yy)
                        g = torch.autograd.grad(yb, plist + [xb] if s > 0 else plist, gy)
                    with torch.no_grad():
                        for a, gi in zip(gacc[s], g):
                            a.add_(gi)
                    gy = g[-1] if s > 0 else None
            losses.append(loss_acc / PAR_M)
            grads.append([[a / PAR_M for a in ga] for ga in gacc])
        loss = losses[0] if replicas == 1 else (losses[0] + losses[1]) / 2
        mean, exact = grads[0], None
        if replicas == 2:
            mean = [[(a + b) / 2 for a, b in zip(ga, gb)] for ga, gb in zip(*grads)]
            exact = [[(a.float() + b.float()) / 2 for a, b in zip(ga, gb)]
                     for ga, gb in zip(*grads)]
        for ps, opt, gs in zip(params, opts, mean):
            for p, g in zip(ps.values(), gs):
                p.grad = g
            opt.step()
        steps.append({"loss": float(loss),
                      "exact": exact and [dict(zip(ps, e)) for ps, e in zip(params, exact)],
                      "grads": [{n_: p.grad.detach().clone() for n_, p in ps.items()}
                                for ps in params],
                      "params": [{n_: p.detach().clone() for n_, p in ps.items()}
                                 for ps in params]})
    return steps


def _rel_l2(torch, a, b) -> float:
    """|a − b| / |b|, L2, float64."""
    b64 = b.double()
    return float((a.to(b.device).double() - b64).norm() / b64.norm().clamp_min(1e-300))


def _par_case_gates(torch, d, card) -> tuple[list, dict]:
    """TP and EP at world 4 against the dense world-1 run (PAR_FLOOR_FACTOR's
    comment) and their all-reduce tallies."""
    failures, summary = [], {}
    loaded = [torch.load(os.path.join(d, f"case{r}.pt")) for r in range(PAR_WORLD)]
    inp = _par_inputs(torch)
    for name, spec in PAR_CASES.items():
        ranks = [l_[name] for l_ in loaded]
        t0 = time.perf_counter()
        f32 = _par_dense(torch, name, inp, torch.float32)
        f64 = _par_dense(torch, name, inp, torch.float64)
        ref_s = time.perf_counter() - t0
        parts, worst = [], 0.0
        for part in ["out"] + [f"g{i}" for i in range(len(spec))]:
            how = "tok" if part == "out" and name == "ep" else \
                ("rep" if part == "out" else spec[int(part[1:])][1])
            if part == "out" and name == "ep":  # the rows, then aux (averaged)
                got = torch.cat([r_["out"][:-1].view(-1, LM_CFG["d_model"]) for r_ in ranks])
                got = torch.cat([got.reshape(-1), ranks[0]["out"][-1:]])
                agree = all(torch.equal(r_["out"][-1:], ranks[0]["out"][-1:]) for r_ in ranks)
            elif how == "rep":  # every rank holds the whole tensor
                got = ranks[0][part]
                agree = all(torch.equal(r_[part], got) for r_ in ranks)
            else:  # each rank its block: reassemble in rank order
                dim = -1 if how == "col" else 0
                got = torch.cat([r_[part] for r_ in ranks], dim=dim)
                agree = True
            err, floor = _rel_l2(torch, got, f64[part]), _rel_l2(torch, f32[part], f64[part])
            limit = PAR_FLOOR_FACTOR * max(floor, U_F32)
            worst = max(worst, err / limit)
            parts.append(f"{part} {err:.2e}/{limit:.2e}{'' if agree else ' RANKS DIFFER'}")
            if err > limit or not agree:
                failures.append(f"[parallel] {name} {part}: rel err {err:.3e} > limit "
                                f"{limit:.3e} (floor {floor:.3e}) or ranks differ")
        log(f"[parallel] {name:12s} world 4 vs dense world 1, f32 (rel L2 vs float64 "
            f"/ {PAR_FLOOR_FACTOR:g} x the dense f32 floor): {'; '.join(parts)}; "
            f"worst {worst:.3f} of limit; references {ref_s:.1f}s "
            f"{'ok' if worst <= 1.0 else 'FAIL'} [{card}]")
        summary[name] = {"worst_of_limit": worst}
        del f32, f64
    del loaded, ranks, inp
    torch.cuda.empty_cache()
    return failures, summary


def _par_tally_gates(res: list) -> list:
    """One all-reduce in a TP block's forward and one in its backward (the
    row half's g, the input's f), one in EP's backward (the router's f)
    with its two all-to-alls each way and aux's pmean, on every rank."""
    failures = []
    want = {"tp_mlp": {"psum": 2}, "tp_attention": {"psum": 2},
            "ep": {"all_to_all": 4, "pmean": 1, "psum": 1}}
    for rk, r_ in enumerate(res):
        for name, w in want.items():
            got = {op: v["calls"] for op, v in r_["cases"][name]["tallies"].items()}
            if got != w:
                failures.append(f"[parallel] {name} rank {rk}: collectives {got}, "
                                f"expected {w}")
    log(f"[parallel] collectives a rank (forward + backward): "
        f"{json.dumps({n: c['tallies'] for n, c in res[0]['cases'].items()})}")
    return failures


def _par_bitwise(torch, res, oracle, arm, sched) -> list:
    """The 1x4 arm on every rank against the oracle's stage: losses and
    each step's gradient and updated parameter digests, bit for bit."""
    bad = []
    for rk, r_ in enumerate(res):
        a = r_["arms"][f"{arm} {sched}"]
        s = a["stage"]
        for k, st in enumerate(a["steps"]):
            want = oracle[k]
            if st["loss"] != want["loss"]:
                bad.append(f"rank {rk} step {k + 1} loss {st['loss']!r} != {want['loss']!r}")
            for part in ("grads", "params"):
                for n, (sha, norm) in st[part].items():
                    w_sha, w_norm = _digest(torch, want[part][s][n])
                    if sha != w_sha:
                        bad.append(f"rank {rk} step {k + 1} {part} {n}: norm {norm!r} vs "
                                   f"{w_norm!r}")
    return bad


def _par_data_axis(torch, d, res, oracle) -> tuple[list, dict]:
    """The 2x2 arm against its oracle (the comment under PAR_FLOOR_FACTOR):
    replica 0's stage tensors; replica 1's digests equal to replica 0's."""
    failures = []
    worst = {"loss_rel_err": 0.0, "grads_of_limit": 0.0, "params_ok": True,
             "bitwise": True}
    for rk, r_ in enumerate(res):
        a = r_["arms"]["2x2 1f1b"]
        for k, st in enumerate(a["steps"]):
            rel = abs(st["loss"] - oracle[k]["loss"]) / abs(oracle[k]["loss"])
            worst["loss_rel_err"] = max(worst["loss_rel_err"], rel)
            if rel > PAR_FLOOR_FACTOR * U_F32:
                failures.append(f"[parallel] 2x2 rank {rk} step {k + 1} loss rel err {rel:.3e}")
            twin = res[rk % 2]["arms"]["2x2 1f1b"]["steps"][k]
            if (st["grads"], st["params"]) != (twin["grads"], twin["params"]):
                failures.append(f"[parallel] 2x2 replicas disagree on stage {a['stage']} "
                                f"at step {k + 1}")
    for s in range(2):
        saved = torch.load(os.path.join(d, f"arm2x2_{s}.pt"))
        for k in range(PAR_STEPS):
            for n in PAR_BLOCKS:
                g, g_o = saved[k]["grads"][n].cuda(), oracle[k]["grads"][s][n]
                exact = oracle[k]["exact"][s][n]
                limit = PAR_FLOOR_FACTOR * max(
                    _rel_l2(torch, exact.to(g_o.dtype), exact), U_F32)
                err = _rel_l2(torch, g, g_o)
                worst["grads_of_limit"] = max(worst["grads_of_limit"], err / limit)
                if err > limit:
                    failures.append(f"[parallel] 2x2 stage {s} step {k + 1} grad {n}: rel "
                                    f"err {err:.3e} > {limit:.3e}")
                p, p_o = saved[k]["params"][n].cuda(), oracle[k]["params"][s][n]
                worst["bitwise"] &= torch.equal(g, g_o) and torch.equal(p, p_o)
                # a parameter may differ only where its gradient does: by lr x
                # the gradient's difference and a bf16 rounding of each side
                room = (2 * U_BF16 * torch.maximum(p.abs(), p_o.abs()).float()
                        + PAR_LR * (g.float() - g_o.float()).abs())
                ok = bool(((p == p_o) | (g != g_o)).all()) \
                    and bool(((p.float() - p_o.float()).abs() <= room).all())
                worst["params_ok"] &= ok
                if not ok:
                    failures.append(f"[parallel] 2x2 stage {s} step {k + 1} parameter {n} "
                                    f"differs beyond its gradient's difference")
    return failures, worst


# launches of each kernel a rank a step in the 1x4 arms: every microbatch
# runs each of the stage's 2 blocks once in the forward slot and once in the
# recompute (flash_fwd), and its backward once (dK/dV, dQ)
PAR_LAUNCHES = {"flash_fwd": 2 * PAR_M * 2, "flash_bwd_dkdv": PAR_M * 2,
                "flash_bwd_dq": PAR_M * 2}


def _par_pipeline_gates(torch, A, d, res, stages, card) -> tuple[list, dict]:
    """The pipeline arms: 1x4 bit for bit against the sequential oracle for
    each schedule, 2x2 against its oracle, the launches a rank a step, no
    plain attention version run, step times and peak memory a process."""
    failures, summary = [], {}
    plain = _count_plain_attention(A)
    t0 = time.perf_counter()
    A.reset_launch_counts()
    oracle = _par_oracle(torch, stages["1x4"], 1)
    oracle_launches = A.launch_counts()
    oracle2 = _par_oracle(torch, stages["2x2"], 2)
    oracle_s = time.perf_counter() - t0
    want_oracle = {k: v * PAR_STEPS * PAR_ARMS["1x4"][0][1] for k, v in PAR_LAUNCHES.items()}
    if oracle_launches != want_oracle:
        failures.append(f"[parallel] oracle launches {oracle_launches}, expected {want_oracle}")
    log(f"[parallel] oracles (stages in sequence at world 1: 1x4 and 2x2, {PAR_STEPS} steps) "
        f"in {oracle_s:.1f}s; 1x4 losses {[s_['loss'] for s_ in oracle]}; launches "
        f"{oracle_launches}")
    for arm, (_, _, scheds) in PAR_ARMS.items():
        for sched in scheds:
            key = f"{arm} {sched}"
            arms = [r_["arms"][key] for r_ in res]
            launches = [[st["launches"] for st in a["steps"]] for a in arms]
            if arm == "1x4":
                bad = _par_bitwise(torch, res, oracle, arm, sched)
                verdict = "bitwise" if not bad else f"{len(bad)} differ: {bad[:4]}"
                if bad:
                    failures.append(f"[parallel] {key} not bitwise its oracle: {bad[:4]}")
                if any(c != PAR_LAUNCHES for per in launches for c in per):
                    failures.append(f"[parallel] {key} launches {launches}, expected "
                                    f"{PAR_LAUNCHES} a rank a step")
            else:
                bad2, worst = _par_data_axis(torch, d, res, oracle2)
                failures += bad2
                verdict = json.dumps(worst)
            ms = [[round(st["ms"], 1) for st in a["steps"]] for a in arms]
            peaks = [round(a["peak_bytes"] / 2 ** 30, 3) for a in arms]
            log(f"[parallel] pipeline {key}: stages {[a['stage'] for a in arms]}, "
                f"{arms[0]['ticks']} ticks, M {PAR_M} x (1, {LM_CFG['max_len']}, "
                f"{LM_CFG['d_model']}) bf16, losses {[st['loss'] for st in arms[0]['steps']]}; "
                f"vs oracle: {verdict}; launches a rank a step {launches[0][0]}; step ms "
                f"a rank {ms}; peak GiB a process {peaks}: four processes time-slicing "
                f"one card through gloo host copies, not a throughput figure [{card}]")
            summary[key] = {"ticks": arms[0]["ticks"], "step_ms": ms, "peak_gib": peaks,
                            "launches_per_rank_step": launches[0][0],
                            "oracle": "bitwise" if verdict == "bitwise" else verdict}
    strays = [r_["plain_calls"] for r_ in res] + [dict(plain)]
    if any(any(c.values()) for c in strays):
        failures.append(f"[parallel] a plain attention version ran: {strays}")
    return failures, summary


PAR_BENCH_KEYS = {"n_stages", "data_world", "microbatches", "dense_step_s",
                  "canonical_gpipe_bubble", "schedules", "fused", "collective_calls"}


def _par_bench_gates(res, card) -> list:
    """The bench's pipeline sub-block at world 4: its keys, the predicted
    bubble 1 − M/T from the tables, 2·T ppermutes a step for each schedule
    timed, and no fused chunk on gloo (the reason is logged)."""
    from tpu_syncbn_torch.parallel import pipeline_schedule as ps

    failures = []
    for rk, r_ in enumerate(res):
        blk = r_["bench"] or {}
        if set(blk) != PAR_BENCH_KEYS or blk.get("fused") is not None:
            failures.append(f"[parallel] bench block rank {rk}: {blk}")
            continue
        n, m = blk["n_stages"], blk["microbatches"]
        for name, sch in blk["schedules"].items():
            t = ps.get_schedule(name, m, n).ticks
            if sch["ticks"] != t or sch["bubble_frac_predicted"] != round(1 - m / t, 4) \
                    or blk["collective_calls"][name].get("ppermute") != 2 * t:
                failures.append(f"[parallel] bench {name} rank {rk}: {sch}, "
                                f"{blk['collective_calls'][name]}")
    log(f"[parallel] bench pipeline block (rank 0, {res[0]['bench_s']:.1f}s; bubbles "
        f"measured with four processes on one card, not four cards): "
        f"{json.dumps(res[0]['bench'])} [{card}]")
    return failures


def phase_parallel(torch, A, card):
    """Tensor, expert and pipeline parallelism at world 4, four processes on
    the one card over gloo (PAR_WORLD), one spawn. Returns the failures and
    a summary."""
    import multiprocessing
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as d:
        stages = _par_stages(torch)
        torch.save(stages, os.path.join(d, "stages.pt"))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_par_child, args=(r, d)) for r in range(PAR_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + PAR_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        if alive:
            fail(f"[parallel] {len(alive)} of {PAR_WORLD} processes still running after "
                 f"{PAR_JOIN_S}s; killed")
        codes = [p.exitcode for p in procs]
        if codes != [0] * PAR_WORLD:
            fail(f"[parallel] process exit codes {codes}")
        res = []
        for r in range(PAR_WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                res.append(json.load(f))
        log(f"[parallel] four processes: {time.perf_counter() - t0:.1f}s from spawn to "
            f"join (TP/EP cases {res[0]['cases_s']:.1f}s a rank)")
        failures = _par_tally_gates(res)
        case_failures, cases = _par_case_gates(torch, d, card)
        failures += case_failures
        pipe_failures, arms = _par_pipeline_gates(torch, A, d, res, stages, card)
        failures += pipe_failures
        failures += _par_bench_gates(res, card)
    secs = time.perf_counter() - t_phase
    log(f"[parallel] phase done in {secs:.1f}s, {len(failures)} failures")
    return failures, {"seconds": secs, "cases": cases, "arms": arms,
                      "bench": res[0]["bench"]}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpu_syncbn_torch")):
        fail("tpu_syncbn_torch/ not found beside chip_smoke.py; run it from "
             "a checkout of the repository")
    # every kernel builds from this checkout's sources into its own
    # git-ignored build directory, whatever cache the environment names
    os.environ["TRITON_CACHE_DIR"] = os.path.join(
        HERE, "tpu_syncbn_torch", "_build", "triton")
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--resilience-child"]:  # phase_resilience's child
        return _resilience_child(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card", 2)

    name, smi = phase_card(torch)
    card = smi
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    log(f"[settings] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    from tpu_syncbn_torch import models, nn
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T

    probe = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.bfloat16, device="cuda"))
    shapes = bn_shapes(torch, probe, BATCH, IMAGE_SIZE)
    del probe
    phase_build()
    t0 = time.perf_counter()
    worst, failures = phase_kernel_parity(torch, T, bn_ops, shapes)
    log(f"[kernels] parity done in {time.perf_counter() - t0:.1f}s "
        f"(includes the Triton builds), {len(failures)} disagree")
    times = phase_kernel_times(torch, T, bn_ops, shapes, card)
    launches, slice_failures, slice_med = phase_slice(torch, card)
    failures += slice_failures
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    groups, group_failures = phase_groups(torch, card)
    failures += group_failures
    log(f"[groups] phase done in {time.perf_counter() - t0:.1f}s, "
        f"{len(group_failures)} failures")
    torch.cuda.empty_cache()
    failures += phase_imagenet(torch, card, slice_med)
    torch.cuda.empty_cache()
    failures += phase_trainer(torch, card)
    torch.cuda.empty_cache()
    gan_failures, gan_launches, gan_meds = phase_gan(torch, card)
    failures += gan_failures
    rn_failures, rn_launches, rn_med, rn_peak = phase_retinanet(torch, card)
    failures += rn_failures
    bench_failures, bench_line = phase_bench()
    failures += bench_failures
    torch.cuda.empty_cache()
    scan_failures, scan = phase_scan(torch, card)
    failures += scan_failures
    torch.cuda.empty_cache()
    comp_failures, quant, quant_launches, compress = phase_compress(torch, card)
    failures += comp_failures
    torch.cuda.empty_cache()
    zero_failures, zero = phase_zero(torch, card, compress["zero_chunks"])
    failures += zero_failures
    torch.cuda.empty_cache()
    ap_failures, autopilot = phase_autopilot(torch, card)
    failures += ap_failures
    torch.cuda.empty_cache()
    audit_failures, audit = phase_audit(torch, card, scan, zero)
    failures += audit_failures
    torch.cuda.empty_cache()
    res_failures, resilience = phase_resilience(torch, card)
    failures += res_failures
    torch.cuda.empty_cache()
    obs_failures, obs = phase_obs(torch, card)
    failures += obs_failures
    torch.cuda.empty_cache()
    shared: dict = {}
    inc_failures, incident_out = phase_incident(torch, card, shared)
    failures += inc_failures
    torch.cuda.empty_cache()
    mon_failures, monitor_out = phase_monitor(torch, card, shared)
    failures += mon_failures
    torch.cuda.empty_cache()
    serving: dict = {}
    serve_failures, serve_out, serve_row = phase_serve(torch, card, serving)
    failures += serve_failures
    pub_failures, publish_out, publish_row = phase_publish(torch, card, serving)
    failures += pub_failures
    torch.cuda.empty_cache()

    from tpu_syncbn_torch.ops import cuda_attention as A

    t0 = time.perf_counter()
    attn_worst, n_cases, attn_failures = phase_attn_parity(torch, A)
    failures += attn_failures
    log(f"[attn-parity] {n_cases} cases x 3 kernels in "
        f"{time.perf_counter() - t0:.1f}s, {len(attn_failures)} disagree")
    torch.cuda.empty_cache()
    attn_times = phase_attn_time(torch, A, card)
    torch.cuda.empty_cache()
    model, opt, batch, attn_launches = phase_lm(torch, A, card)
    failures += phase_lm_ab(torch, A, model, opt, batch, card)
    del model, opt, batch
    torch.cuda.empty_cache()
    seq_failures, seq = phase_seq(torch, A, card)
    failures += seq_failures
    torch.cuda.empty_cache()
    par_failures, par = phase_parallel(torch, A, card)
    failures += par_failures
    if failures:
        fail("; ".join(failures))

    kernels = []
    for k in MOVES:
        t = times[k]
        kernels.append({
            "name": k,
            "route": BN_SOURCE[k][0],
            "source": BN_SOURCE[k][1],
            "replaces": REPLACES[k],
            "launches": launches[k],
            "max_abs_err": worst[k],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        # [audit]: the launches of its recorded programs (each wire's eager
        # warm-ups and capture; the serving forward's normalizes)
        kernels[-1]["audit"] = {"launches": audit["launches"][k]}
        if k == "bn_normalize":  # "ms" is the wrapper, fold included
            kernels[-1]["kernel_alone_ms"] = t["alone_ms"]
            # the serving path: eval BN, 53 launches in each bucket's graph;
            # times a bucket-128 forward
            kernels[-1]["serve"] = serve_row
            # weight publication: the bucket-128 replay after a swap
            kernels[-1]["publish"] = publish_row
    n_layers = LM_CFG["n_layers"]
    for k in ATTN_KERNELS:  # per LM training step: n_layers causal calls
        t = attn_times[(k, True)]
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": f"tpu_syncbn_torch/ops/csrc/{k}.cu",
            "replaces": ATTN_REPLACES[k],
            "launches": attn_launches[k],
            "max_abs_err": attn_worst[k],
            "ms": n_layers * t["ms"],
            "plain_ms": n_layers * t["plain_ms"],
            "bound_ms": n_layers * t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None if t["library_ms"] is None
            else n_layers * t["library_ms"],
            # [seq]: a rank's launches in the world-4 LM arm through the
            # kernels (its 3 steps), and a rank's calls by variant in the
            # attention cases (each held against its plain version)
            "seq": {"lm_launches_per_rank": seq["lm"]["ulysses+flash+pallas"][
                "launches_per_rank"][k],
                    "parity_calls_per_rank": {
                        key.split("<")[1].rstrip(">"): n
                        for key, n in seq["parity_calls_per_rank"].items()
                        if key.startswith(k + "<")}},
            # [parallel]: a rank's launches a step in the world-4 pipeline of
            # the LM's blocks (1x4, 2 blocks a stage, M microbatches)
            "parallel": {sched: par["arms"][f"1x4 {sched}"]["launches_per_rank_step"][k]
                         for sched in PAR_ARMS["1x4"][2]},
        })
    for k in QUANT_KERNELS:  # per ResNet-50 int8 step: one call each
        t = quant[k]
        zc = compress["zero_chunks"][f"{k} chunk={RESNET50_GRADS}"]
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": QUANT_SOURCE,
            "replaces": QUANT_REPLACES[k],
            "launches": quant_launches[k],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            # the ZeRO reduce-scatter's shape ([zero]'s int8 path): one chunk
            # of the whole payload at world 1
            "zero_chunk": {"chunk": RESNET50_GRADS, "launches": zero["int8"]["launches"][k],
                           **zc},
            # [autopilot]: the main path's launches through the wrapper while
            # the controller moved the int8 step between rungs and Ks (one a
            # step on the int8 rung, recorded at captures and the eager body)
            "autopilot": {"launches": autopilot["launches"][k]},
            "audit": {"launches": audit["launches"][k]},
        })
    print(json.dumps({"groups": groups}), flush=True)
    print(json.dumps({"paths": {
        "gan": {arch: {"launches": gan_launches[arch],
                       "iteration_ms": gan_meds[arch]} for arch in gan_launches},
        "retinanet": {"launches": rn_launches, "step_ms": rn_med,
                      "peak_bytes": rn_peak},
        "bench": bench_line, "scan": scan, "compress": compress, "zero": zero,
        "autopilot": autopilot, "audit": audit,
        "resilience": resilience, "obs": obs, "incident": incident_out,
        "monitor": monitor_out, "serve": serve_out, "publish": publish_out,
        "seq": seq, "parallel": par}}),
        flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
