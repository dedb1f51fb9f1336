#!/usr/bin/env python3
"""Where the on-device monitors' cost goes in an eager step of the bf16
ResNet-50 slice (batch 64 at 224², SyncBN, the ImageNet example's SGD), on
one CUDA card:

    python3 tools/monitor_costs.py

* ``[monitor-launches]`` — kernels launched a step with ``monitors=True``
  and ``False`` (``cudaLaunchKernel`` calls in a 2-step ``torch.profiler``
  window of each trainer), and the host ops whose self CPU time grew most;
* ``[monitor-parts]`` — one trainer, its monitors toggled and each of the
  four monitor functions (``stepstats.grad_monitors``, ``state_health``,
  ``numerics.grad_norm_scalar``, ``cross_replica_monitors``) replaced by a
  stub in turn, one step each in turns (forward then reverse order, 16
  turns, each step between synchronizes): the median step by the host
  clock against monitors off. The spread of the shared host shows as a
  stubbed part timing slower than none.

Every line carries the card's name and power limit. Exits non-zero
without a card.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def launches(torch, cs, steps, card) -> None:
    counts = {}
    for mon in (False, True):
        _, dp = cs._resnet_trainer(torch, monitors=mon)
        for _ in range(3):
            dp.train_step(steps[0])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for b in steps[:2]:
                dp.train_step(b)
            torch.cuda.synchronize()
        counts[mon] = {e.key: (e.count, e.self_cpu_time_total) for e in prof.key_averages()}
        n = counts[mon].get("cudaLaunchKernel", (0, 0))[0]
        print(f"[monitor-launches] monitors={mon}: cudaLaunchKernel {n / 2:.0f} a step [{card}]",
              flush=True)
        del dp
        torch.cuda.empty_cache()
    grown = {k: (c - counts[False].get(k, (0, 0))[0], t - counts[False].get(k, (0, 0))[1])
             for k, (c, t) in counts[True].items()}
    for k, (c, t) in sorted(grown.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[monitor-launches] {k[:56]:56s} {c / 2:+7.1f} calls, {t / 2e3:+7.3f} ms self "
              f"CPU a step [{card}]", flush=True)


def parts(torch, cs, steps, card) -> None:
    from tpu_syncbn_torch.obs import numerics, stepstats

    _, dp = cs._resnet_trainer(torch)
    for _ in range(3):
        dp.train_step(steps[0])
    names = {"grad_monitors": stepstats, "state_health": stepstats,
             "grad_norm_scalar": numerics, "cross_replica_monitors": numerics}
    real = {k: getattr(m, k) for k, m in names.items()}
    zero = torch.zeros((), device="cuda")
    stub = {"grad_monitors": lambda *a, **kw: {"grad_norm": zero, "grad_nonfinite": zero},
            "state_health": lambda *a, **kw: {},
            "grad_norm_scalar": lambda *a, **kw: zero,
            "cross_replica_monitors": lambda *a, **kw: {}}
    variants = ["off", "on", *(f"on without {k}" for k in names), "on without all four"]

    def setup(v):
        dp.monitors = v != "off"
        for k, m in names.items():
            setattr(m, k, stub[k] if v in (f"on without {k}", "on without all four") else real[k])

    times = {v: [] for v in variants}
    try:
        for turn in range(16):
            for v in (variants if turn % 2 == 0 else variants[::-1]):
                setup(v)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dp.train_step(steps[turn % 2])
                torch.cuda.synchronize()
                times[v].append((time.perf_counter() - t0) * 1e3)
    finally:
        setup("on")
    base = statistics.median(times["off"])
    for v in variants:
        med = statistics.median(times[v])
        print(f"[monitor-parts] {v:38s} eager step {med:8.3f} ms (median of {len(times[v])}), "
              f"{med - base:+7.3f} ms against off [{card}]", flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "tpu_syncbn_torch", "_build", "triton")
    import torch

    if not torch.cuda.is_available():
        print("monitor_costs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    _, card = cs.phase_card(torch)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    steps = [cs._trainer_batch(torch, 900 + i) for i in range(2)]
    launches(torch, cs, steps, card)
    parts(torch, cs, steps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
