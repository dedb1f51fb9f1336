#!/usr/bin/env python3
"""Which host call waits for work already queued on the card, in a fresh
process each time: a ~0.5 s ``torch.cuda._sleep`` is queued, then a
``torch.ones`` scalar, a multiply by a Python scalar, a stack of two
scalars, a page-locked allocation, a non-blocking copy into it and a CUDA
event are each timed by the host clock, with whether the sleep had ended
when the call returned:

    python3 tools/first_launch_wait.py

Variants, each in its own process: ``plain``; ``pinned`` (a page-locked
block taken before the sleep); ``warm_fill`` and ``warm_ops`` (the fill, or
fill, multiply and stack kernels launched once before the sleep);
``publisher`` (an ``obs.numerics.NumericsPublisher`` built before the
sleep); and ``plain`` again under ``CUDA_MODULE_LOADING=EAGER``. A call
that returns after the sleep ended waited for it. Prints one JSON line a
variant and the card's name and power limit; exits non-zero without a
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, os, sys, time
import torch
variant = sys.argv[1]
torch.cuda.init()
out = {"variant": variant, "module_loading": os.environ.get("CUDA_MODULE_LOADING")}
if variant == "pinned":
    torch.empty(8, pin_memory=True)
if variant in ("warm_fill", "warm_ops"):
    a = torch.zeros((), device="cuda")
    if variant == "warm_ops":
        torch.stack([a * 2.0, a])
    torch.cuda.synchronize()
if variant == "publisher":
    from tpu_syncbn_torch.obs import numerics
    numerics.NumericsPublisher()
torch.cuda._sleep(int(1e9))
mark = torch.cuda.Event()
mark.record()

def timed(name, fn):
    t0 = time.perf_counter()
    r = fn()
    out[name] = {"ms": round((time.perf_counter() - t0) * 1e3, 3),
                 "sleep_over": mark.query()}
    return r

v = timed("ones", lambda: torch.ones((), device="cuda"))
w = timed("mul_scalar", lambda: v * 2.0)
s = timed("stack2", lambda: torch.stack([w, v]))
h = timed("pinned_alloc", lambda: torch.empty(2, pin_memory=True))
timed("copy_to_pinned", lambda: h.copy_(s, non_blocking=True))
timed("event", lambda: torch.cuda.Event().record())
torch.cuda.synchronize()
print(json.dumps(out))
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(f"[first-launch] {card} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    runs = [(v, None) for v in ("plain", "pinned", "warm_fill", "warm_ops", "publisher")]
    runs.append(("plain", "EAGER"))
    rc = 0
    for variant, loading in runs:
        env = dict(os.environ, PYTHONPATH=HERE)
        if loading:
            env["CUDA_MODULE_LOADING"] = loading
        r = subprocess.run([sys.executable, "-c", CHILD, variant], cwd=HERE, env=env,
                           capture_output=True, text=True, timeout=300)
        if r.returncode:
            rc = 1
            print(f"[first-launch] {variant}: exit {r.returncode} {r.stderr[-800:]}", flush=True)
        else:
            print(f"[first-launch] {r.stdout.strip()} [{card}]", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
