#!/usr/bin/env python3
"""Device and host times of the BatchNorm forward pair (``bn_stats``,
``bn_normalize``) of one tree of the port, on one CUDA card, at the 53 BN
layers of ResNet-50 (bf16, batch 64 at 224²): for comparing two trees in
one run, e.g. a commit and its parent unpacked with ``git archive``:

    python3 tools/bn_forward_times.py --tree PARENT_DIR --label parent
    python3 tools/bn_forward_times.py --tree . --label change

Per shape, one ``[bn-fwd]`` line with the device time a call (20 calls
captured in one CUDA graph, median of 5 replays: ``chip_smoke``'s
``_device_ms``) of

* ``stats``   — ``bn_stats``, as the path calls it;
* ``norm``    — ``bn_normalize`` as the path calls it: the fold of (mean,
                var, γ, β) into (scale, shift), then the kernel;
* ``alone``   — the normalize kernel alone on folded (scale, shift)
                (``triton_bn._normalize_2d``);
* ``fold``    — ``fold_scale_shift`` alone;
* ``aten``    — ATen's ``batch_norm_elemt`` (the same function as ``norm``)
                and ``batch_norm_stats``;

and the host-inclusive time a call of ``bn_stats`` and ``bn_normalize``
(calls back to back between CUDA events). The ``[bn-fwd] per step`` line
sums each over the 53 layers. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# (M, C, layers) of ResNet-50's BatchNorm inputs at batch 64, 224x224
# (chip_smoke.bn_shapes); 53 layers
SHAPES = [(3136, 512, 5), (12544, 256, 11), (3136, 2048, 4), (12544, 512, 1),
          (50176, 128, 7), (12544, 1024, 7), (50176, 256, 1), (200704, 64, 6),
          (50176, 512, 5), (200704, 128, 1), (200704, 256, 4), (802816, 64, 1)]
EPS = 1e-5
ITERS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True,
                    help="root of the tree whose tpu_syncbn_torch is timed")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    sys.path.insert(0, os.path.abspath(args.tree))
    sys.path.insert(1, ROOT)  # chip_smoke's timers, after the tree's package
    import torch

    if not torch.cuda.is_available():
        print("bn_forward_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_syncbn_torch.ops import triton_bn as T
    from tpu_syncbn_torch.ops.batch_norm import fold_scale_shift

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[bn-fwd] {args.label}: {T.__file__} torch {torch.__version__} [{smi}]",
          flush=True)

    keys = ("stats", "norm", "alone", "fold", "aten_norm", "aten_stats",
            "stats_host", "norm_host")
    tot = dict.fromkeys(keys, 0.0)
    for m, c, n in SHAPES:
        x, _, w, b = cs._inputs(torch, m, c, torch.bfloat16, seed=7)
        s, sq, count = T.bn_stats(x)
        mean = s / count
        var = (sq / count - mean * mean).clamp_min(0)
        invstd = torch.rsqrt(var + EPS)
        scale, shift = fold_scale_shift(mean, var, w, b, EPS)
        fns = {
            "stats": lambda: T.bn_stats(x),
            "norm": lambda: T.bn_normalize(x, mean, var, w, b, EPS),
            "alone": lambda: T._normalize_2d(x, scale, shift),
            "fold": lambda: fold_scale_shift(mean, var, w, b, EPS),
            "aten_norm": lambda: torch.batch_norm_elemt(x, w, b, mean, invstd, EPS),
            "aten_stats": lambda: torch.batch_norm_stats(x, EPS),
        }
        t = {k: cs._device_ms(torch, fn, ITERS) for k, fn in fns.items()}
        t["stats_host"] = cs._event_ms(torch, fns["stats"], ITERS, reps=3)
        t["norm_host"] = cs._event_ms(torch, fns["norm"], ITERS, reps=3)
        print(f"[bn-fwd] {args.label} M={m:<7d} C={c:<5d} x{n:<2d} us a call: "
              + " ".join(f"{k}={1e3 * v:.2f}" for k, v in t.items()), flush=True)
        for k, v in t.items():
            tot[k] += n * v
        del x
    print(f"[bn-fwd] {args.label} per step (53 layers) ms: "
          + " ".join(f"{k}={v:.4f}" for k, v in tot.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
