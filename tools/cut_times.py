#!/usr/bin/env python3
"""The two ``chip_smoke.py`` runs shortened to make room for ``[audit]``,
timed on the tree at ``--tree DIR`` (default: this checkout):
``[groups]`` (its world-1 reference computed before the four processes are
spawned, or beside their start) and ``[obs]``'s two card tests alone in
fresh processes (in sequence, or side by side). Every gate of both runs
is checked as the script checks it. To compare a commit with its parent in
one chip call, unpack the parent with ``git archive`` into a git-ignored
directory and run parent, change, change, parent:

    python3 tools/cut_times.py --tree _archive/parent --label parent

Builds the tree's kernels and fills its Triton cache (the kernel parity
phase) before timing. Prints one JSON line (seconds of each run, its
failures) and the card's name and power limit; exits non-zero without a
card or when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(tree, "tpu_syncbn_torch", "_build", "triton")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: these runs need the card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        print(f"chip_smoke imported from {cs.__file__}, not {tree}", file=sys.stderr)
        return 2
    _, card = cs.phase_card(torch)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    from tpu_syncbn_torch import models, nn
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T

    probe = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.bfloat16, device="cuda"))
    shapes = cs.bn_shapes(torch, probe, cs.BATCH, cs.IMAGE_SIZE)
    del probe
    cs.phase_build()
    cs.phase_kernel_parity(torch, T, bn_ops, shapes)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, groups_failures = cs.phase_groups(torch, card)
    groups_s = time.perf_counter() - t0
    obs_failures: list = []
    t0 = time.perf_counter()
    cs._obs_publisher_alone(obs_failures)
    obs_s = time.perf_counter() - t0
    out = {"label": args.label, "groups_s": round(groups_s, 1),
           "obs_alone_s": round(obs_s, 1), "failures": groups_failures + obs_failures}
    print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
