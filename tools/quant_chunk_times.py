#!/usr/bin/env python3
"""Device times of the int8 wire's three kernels (``quant_minmax``,
``quant_encode``, ``quant_decode``) of one tree of the port, on one CUDA
card, at the chunk sizes the ZeRO reduce-scatter gives them (one chunk a
scatter shard of ResNet-50's 25,557,032 gradients: the whole payload at
world 1, four chunks of 6,389,258 at world 4) and at the all-reduce's
256-element chunks; for comparing two trees in one run, e.g. a commit and
its parent unpacked with ``git archive``:

    python3 tools/quant_chunk_times.py --tree PARENT_DIR --label parent
    python3 tools/quant_chunk_times.py --tree . --label change

Per (kernel, chunk), one ``[quant-chunk]`` line: the device time a call
(calls captured in one CUDA graph, median of the replays: ``chip_smoke``'s
``_device_ms``; a call slower than 5 ms is captured once, not 20 times),
its bound (``chip_smoke.quant_bound_ms``: bytes over 3.35 TB/s) and the
share of the bound, and whether every output is bit-identical to the plain
version on the same inputs (error feedback on, qmax 127 // world). The
last line is one JSON object of the same numbers. Exits non-zero without a
card, and when an output differs from its plain version.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

N = 25_557_032  # ResNet-50's trainable parameters
CHUNKS = {"world1": (N, 1), "world4": (N // 4, 4), "allreduce": (256, 1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True,
                    help="root of the tree whose tpu_syncbn_torch is timed")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("quant_chunk_times: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's chip_smoke (timers, bounds), whatever tree is timed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tpu_syncbn_torch.ops import quant_int8 as Q

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[quant-chunk] {args.label}: {Q.__file__} torch {torch.__version__} [{smi}]",
          flush=True)
    g, e = cs._quant_inputs(torch, N, seed=5)
    out, bad = {}, []
    for tag, (chunk, world) in CHUNKS.items():
        qmax = 127 // world
        r = Q.minmax(g, e, chunk=chunk)
        q, s, z, _ = Q.encode(g, e, r, qmax, chunk=chunk)
        e2 = torch.empty_like(e)
        got = {"quant_minmax": [r],
               "quant_encode": list(Q.encode(g, e, r, qmax, chunk=chunk, want_residual=True)),
               "quant_decode": [Q.decode(q, s, z, world=world, n=N, chunk=chunk, mean=True)]}
        want = {"quant_minmax": [Q.minmax_plain(g, e, chunk)],
                "quant_encode": list(Q.encode_plain(g, e, r, qmax, chunk, True)),
                "quant_decode": [Q.decode_plain(q, s, z, world, N, True)]}
        calls = {
            "quant_minmax": lambda: Q.minmax(g, e, chunk=chunk),
            "quant_encode": lambda: Q.encode(g, e, r, qmax, chunk=chunk, want_residual=True,
                                             residual_out=e2),
            "quant_decode": lambda: Q.decode(q, s, z, world=world, n=N, chunk=chunk,
                                             mean=True),
        }
        for k, fn in calls.items():
            same = all(torch.equal(a, b) for a, b in zip(got[k], want[k]))
            if not same:
                bad.append(f"{k} chunk {chunk}")
            once = cs._event_ms(torch, fn, 1, reps=1)
            iters, reps = (1, 3) if once > 5.0 else (20, 5)
            ms = cs._device_ms(torch, fn, iters, reps=reps)
            bound, by = cs.quant_bound_ms(k, N, chunk)
            out[f"{k} {tag}"] = {"chunk": chunk, "ms": ms, "bound_ms": bound,
                                 "bound_by": by, "bit_identical": same}
            print(f"[quant-chunk] {args.label} {k:12s} chunk={chunk} ({tag}, "
                  f"{-(-N // chunk)} chunks, qmax {qmax}): {ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}; {100 * bound / ms:.1f}% of bound), "
                  f"bit-identical to the plain version: {same} [{smi}]", flush=True)
        del q, s, z, r, e2, got, want
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": smi, "times": out}), flush=True)
    if bad:
        print(f"quant_chunk_times: differ from the plain versions: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
