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
6. attn-parity — each attention kernel (forward, dK/dV, dQ) against its
                 plain version, causal and not, float32 (against float64)
                 and bfloat16, at the LM slice's shape and four others,
                 and causal bf16 at the LM shape on views into one fused
                 QKV tensor;
7. attn-time   — device time of each attention kernel at the LM shape
                 beside its bound, its plain version and, as a yardstick the
                 port never calls, ``scaled_dot_product_attention``; the
                 kernels' times at every parity shape, and at a fixed 1024
                 blocks over four lengths (a fixed cost per block, fitted);
                 the float32 kernels' times;
8. lm          — the causal transformer LM at full width (d_model 512, 8
                 heads of 64, d_ff 2048, vocab 50257, 8 layers, L 8192,
                 batch 2, bf16), trained by ``longcontext_train.train_step``
                 with Adam and ``attn_impl="flash_pallas_bwd"``: every
                 attention kernel must launch 8 x steps times; step times,
                 tokens/s, a profiler window;
9. lm-a/b      — one step from the same weights and batch with the kernels
                 and with their plain versions (loss; every kernel call of
                 the kernel step against its plain version on the same
                 tensors; the gradients shown), and one step of
                 ``attn_impl="flash"`` (kernel forward, scan backward).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
nvcc (phase 3) and Triton (at first launch) build every kernel from this
checkout's sources into ``tpu_syncbn_torch/_build/`` (git-ignored).
Without a card the script exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
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
        r_ = r_.double()
        d = (g_.double() - r_).abs()
        abs_e = max(abs_e, float(d.max()))
        if elementwise:
            floor = 1e-3 * float(r_.abs().max()) + 1e-30 if scaled_floor else 1e-3
            rel_e = max(rel_e, float((d / (r_.abs() + floor)).max()))
        else:
            rel_e = max(rel_e, float(d.max() / (r_.abs().max() + 1e-30)))
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


@contextlib.contextmanager
def checking_every_call(torch, T, seen):
    """Inside the block, every call that ``FusedBatchNorm`` makes to a
    kernel is followed by the kernel's plain version on the same arguments,
    and ``seen[kernel] = (calls, worst error / tolerance, worst abs
    error)`` is kept: the kernels held against their plain versions on a
    real step's own activations and gradients, layer by layer."""
    saved = {disp: getattr(T, disp) for disp, _ in DISPATCH.values()}
    for k, (disp, plain) in DISPATCH.items():
        def run(*args, _k=k, _kern=saved[disp], _plain=getattr(T, plain)):
            got = _kern(*args)
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


def profile_window(torch, run, tag: str, what: str, is_ours, card: str):
    """Run ``run()`` (two training steps) under ``torch.profiler`` and print
    the device's busy and idle share of the wall time, the share of busy
    time spent in the kernels ``is_ours(name)`` selects, and the top 15
    device activities."""
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
    busy = 0.0  # union of device intervals: overlapping work counts once
    cur_s = cur_e = None
    for _, start, end in sorted(acts, key=lambda r: r[1]):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += (cur_e - cur_s) / 1e3
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += (cur_e - cur_s) / 1e3
    ours_ms = sum(r[0] for r in rows if is_ours(r[2]))
    wall_ms = window * 1e3
    if busy > 0:
        log(f"[{tag}] 2 steps: wall {wall_ms:.1f}ms, device busy {busy:.1f}ms "
            f"({100 * busy / wall_ms:.1f}%, idle {100 * (1 - busy / wall_ms):.1f}%), "
            f"{what} {ours_ms:.2f}ms ({100 * ours_ms / busy:.1f}% of busy), "
            f"{len(acts)} device activities [{card}]")
    else:  # a limit of the profiler's tracing, not a fault of the port
        log(f"[{tag}] 2 steps: wall {wall_ms:.1f}ms; the profiler recorded "
            "no device activity, so the busy share is not measured")
    for ms, cnt, key in rows[:15]:
        log(f"[{tag}] {ms:9.3f}ms x{cnt:<5d} {key[:100]}")
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
    return launches, failures


# -- phases 6-9: the attention kernels and the transformer LM ---------------

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


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpu_syncbn_torch")):
        fail("tpu_syncbn_torch/ not found beside chip_smoke.py; run it from "
             "a checkout of the repository")
    # every kernel builds from this checkout's sources into its own
    # git-ignored build directory, whatever cache the environment names
    os.environ["TRITON_CACHE_DIR"] = os.path.join(
        HERE, "tpu_syncbn_torch", "_build", "triton")
    sys.path.insert(0, HERE)
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
    launches, slice_failures = phase_slice(torch, card)
    failures += slice_failures
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
        if k == "bn_normalize":  # "ms" is the wrapper, fold included
            kernels[-1]["kernel_alone_ms"] = t["alone_ms"]
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
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
