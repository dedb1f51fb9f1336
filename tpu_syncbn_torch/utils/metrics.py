"""Training meters, step timing and the JSONL scalar log — the counterpart
of ``tpu_syncbn.utils.metrics`` (``AverageMeter``, ``ThroughputMeter``,
``step_timer``, ``ScalarLogger``), with the same arithmetic and the same
rank-0 file convention.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time

from tpu_syncbn_torch.runtime import distributed as dist


class AverageMeter:
    """Running average of a scalar (loss, accuracy)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.avg:.4f}"


class ThroughputMeter:
    """Samples/s over a sliding window of steps; call ``tick(n)`` once per
    step *after* waiting for the step's result."""

    def __init__(self, window: int = 20):
        self.window = window
        self._times: list[float] = []
        self._counts: list[int] = []

    def tick(self, n_samples: int) -> None:
        self._times.append(time.perf_counter())
        self._counts.append(n_samples)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._counts.pop(0)

    @property
    def samples_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        n = sum(self._counts[1:])  # the first tick only anchors the clock
        return n / dt if dt > 0 else 0.0


@contextlib.contextmanager
def step_timer():
    """Times a block (a device wait included only if the block waits):
    yields a dict filled with ``seconds`` on exit."""
    out: dict = {}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["seconds"] = time.perf_counter() - t0


class ScalarLogger:
    """Append-only JSONL training-curve log, written by the master process
    only: one line ``{"step": N, "wall_time": ..., **scalars}`` per
    ``log()``. Other ranks construct it and no-op, so call sites need no
    rank check. Values go through ``float()`` at log time (a device tensor
    waits there); a non-finite value is written as null."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        if dist.is_master():
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", buffering=1)  # line-buffered

    def log(self, step: int, **scalars) -> None:
        if self._fh is None:
            return
        row = {"step": int(step), "wall_time": round(time.time(), 3)}
        for k, v in scalars.items():
            f = float(v)
            row[k] = f if math.isfinite(f) else None
        self._fh.write(json.dumps(row, allow_nan=False) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
