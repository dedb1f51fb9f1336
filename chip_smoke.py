#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_syncbn_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, in order; takes no options

Phases, in order; any failure exits non-zero (nothing is caught, nothing
falls back to the CPU):

1. card      — name, compute capability (must be 9.0) and the
               ``nvidia-smi --query-gpu=name,power.limit`` line;
2. settings  — TF32 and cuDNN switches, set and printed;
3. kernels   — each of the four Triton BN kernels against its plain
               PyTorch version at every distinct BN shape of the ResNet-50
               path and at one ragged M, in float32
               (against a float64 plain computation) and bfloat16 (in the
               working dtype), with max error against the stated tolerance;
               then kernel, plain and ATen-yardstick times per training
               step over every BN shape of the path, beside the bound;
4. slice     — full-width bf16 ResNet-50, converted to SyncBN, trained by
               ``DataParallel`` with SGD(0.1, momentum 0.9) at batch 64,
               224x224, fed by SyntheticImageDataset -> DistributedSampler
               -> DataLoader -> device_prefetch; every BN kernel must launch
               53 x steps times; step times and img/s; a profiler window;
               an in-place A/B of kernels against plain versions on the
               same weights and batch (loss and running stats; every
               kernel call of that step against its plain version on the
               same tensors; the gradients shown beside a bf16-vs-f32
               reference); one eval step.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Triton builds every kernel from this checkout's sources into
``tpu_syncbn_torch/_build/`` (git-ignored). Without a card the script
exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
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

# the Pallas kernel each Triton kernel replaces (the dx pass replaces the
# XLA-fused elementwise tail of the custom VJP)
REPLACES = {
    "bn_stats": "tpu_syncbn/ops/pallas_bn.py:99",
    "bn_normalize": "tpu_syncbn/ops/pallas_bn.py:157",
    "bn_backward_reduce": "tpu_syncbn/ops/pallas_bn.py:206",
    "bn_backward_elemt": "tpu_syncbn/ops/pallas_bn.py:344",
}
# floating-point operations per element (x̂ = 2, one FMA = 2)
FLOPS_PER_ELEM = {"bn_stats": 3, "bn_normalize": 2,
                  "bn_backward_reduce": 5, "bn_backward_elemt": 7}
# per call: ((M, C) operands read, (M, C) operands written, f32 (C,)
# vectors read + written) — each input read once, each output written once
MOVES = {"bn_stats": (1, 0, 2), "bn_normalize": (1, 1, 2),
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


# -- phase 3: kernels -------------------------------------------------------


def _event_ms(torch, fn, iters: int) -> float:
    """Host-inclusive time per call: ``iters`` calls back to back between
    two CUDA events, after warm-up. Where a kernel is shorter than its
    launch, this measures the launch, not the kernel."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


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
    }, (mean, invstd, count)


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
    the path and at one ragged shape, in float32 and bfloat16."""
    worst = {k: 0.0 for k in MOVES}
    for (m, c) in sorted(set(shapes)) + [RAGGED_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, dy, w, b = _inputs(torch, m, c, dtype, seed=m + c)
            cases, _ = _cases(torch, T, bn_ops, x, dy, w, b)
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
                    fail(f"{k} disagrees with its plain version at "
                         f"M={m} C={c} {dname}")
                worst[k] = max(worst[k], abs_e)
            del x, dy
    return worst


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
            abs_e, rel_e = _err(torch, got, _plain(*args), _k in ELEMENTWISE,
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
        cases, (mean, invstd, count) = _cases(torch, T, bn_ops, x, dy, w, b)
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
            log(f"[time] {k:19s} M={m:<7d} C={c:<5d} x{n:<2d} bf16 device: "
                f"kernel={t_k:.4f}ms plain={t_p:.4f}ms aten={t_l:.4f}ms "
                f"bound={max(bytes_ms, ops_ms):.4f}ms "
                f"({100 * max(bytes_ms, ops_ms) / t_k:.0f}% of bound); "
                f"kernel with its launch {t_host:.4f}ms [{card}]")
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
    return tot


# -- phase 4: the slice -----------------------------------------------------


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
    steady = times[1:]  # the first step builds the Triton kernels
    med = statistics.median(steady)
    log(f"[slice] first step {times[0] * 1e3:.1f}ms (includes Triton builds); "
        f"steady median {med * 1e3:.2f}ms over {len(steady)} steps = "
        f"{bs / med:.1f} img/s, batch {bs} at {side}x{side} bf16 [{card}]")

    # profiler window: where the device time goes in a steady step
    prof_batches = [next(batches), next(batches)]
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b_ in prof_batches:
            dp.train_step(b_)
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
    bn_names = ("stats_partial", "sum_partials", "normalize",
                "bwd_reduce_partial", "backward_elemt")
    bn_ms = sum(r[0] for r in rows if r[2] in bn_names)
    wall_ms = window * 1e3
    if busy > 0:
        log(f"[profile] 2 steps: wall {wall_ms:.1f}ms, device busy {busy:.1f}ms "
            f"({100 * busy / wall_ms:.1f}%, idle {100 * (1 - busy / wall_ms):.1f}%), "
            f"BN kernels {bn_ms:.2f}ms ({100 * bn_ms / busy:.1f}% of busy), "
            f"{len(acts)} device activities [{card}]")
    else:  # a limit of the profiler's tracing, not a fault of the port
        log(f"[profile] 2 steps: wall {wall_ms:.1f}ms; the profiler recorded "
            "no device activity, so the busy share is not measured")
    for ms, cnt, key in rows[:15]:
        log(f"[profile] {ms:9.3f}ms x{cnt:<5d} {key[:100]}")

    # in-place A/B: one step from the same state on the same batch, with
    # the kernels ("auto") and with their plain versions ("off"); in the
    # kernel step every kernel call is also held against its plain version
    # on the same arguments
    ab_batch = next(batches)
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
            fail(f"{k} disagrees with its plain version inside the step "
                 f"({calls} calls, worst {ratio:.2f} of tol)")

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
        fail("kernels and plain versions disagree on the full model")

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
    return launches


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
    t0 = time.perf_counter()
    worst = phase_kernel_parity(torch, T, bn_ops, shapes)
    log(f"[kernels] parity done in {time.perf_counter() - t0:.1f}s "
        "(includes Triton builds)")
    times = phase_kernel_times(torch, T, bn_ops, shapes, card)
    launches = phase_slice(torch, card)

    kernels = []
    for k in MOVES:
        t = times[k]
        kernels.append({
            "name": k,
            "route": "triton",
            "source": "tpu_syncbn_torch/ops/triton_bn.py",
            "replaces": REPLACES[k],
            "launches": launches[k],
            "max_abs_err": worst[k],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
