#!/usr/bin/env python3
"""``chip_smoke.py``'s three launcher runs — ``train.py`` (ResNet-50) at
``--nproc-per-node 1``, the request for one process more than the card
count, and ``imagenet_resnet50.py`` with process workers on the copy of the
JPEG tree's first images — timed in sequence and side by side, in turns
(sequence, side by side, side by side, sequence) after one untimed round
that builds every kernel and fills Triton's cache:

    python3 tools/launcher_runs.py

Prints one line a round (each run's exit code and seconds, and the
round's wall time) and the card's name and power limit; exits non-zero
without a card or when a run misses its gate.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "tpu_syncbn_torch", "_build", "triton")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the launcher runs need the card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    _, card = cs.phase_card(torch)
    cs.phase_build()
    n = torch.cuda.device_count()
    failed = False
    with tempfile.TemporaryDirectory(prefix="launcher_runs_") as tree:
        cs.write_jpeg_tree(tree)
        small = os.path.join(tree, "launcher")
        cs.launcher_tree(tree, small)
        cmds = {**cs._launcher_commands(n), "example": cs._example_launcher_command(small)}
        for rnd in ("warm-up", "sequence", "side by side", "side by side", "sequence"):
            t0 = time.perf_counter()
            if rnd == "side by side":
                res = cs._side_by_side(cmds)
                secs = {}
            else:
                res, secs = {}, {}
                for name, cmd in cmds.items():
                    t1 = time.perf_counter()
                    res.update(cs._side_by_side({name: cmd}))
                    secs[name] = round(time.perf_counter() - t1, 1)
            wall = round(time.perf_counter() - t0, 1)
            bad = cs._launcher_gates(res, n)
            ex = res["example"]
            if ex.returncode != 0 or "done:" not in ex.stdout:
                bad.append(f"the example under the launcher: {ex.stderr[-2000:]}")
            failed |= bool(bad)
            print(json.dumps({"round": rnd, "wall_s": wall, "seconds": secs,
                              "exits": {k: r.returncode for k, r in res.items()},
                              "failures": bad, "card": card}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
