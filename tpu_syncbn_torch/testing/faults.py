"""Deterministic fault injection — the training half of
``tpu_syncbn.testing.faults``, kept as a copy.

Every recovery path of the resilience layer (``runtime.resilience``,
``utils.checkpoint``'s manifests, the trainer's divergence guard) gets a
repeatable way to trigger its failure:

* checkpoint corruption — :func:`truncate_file`, :func:`bitflip_file`,
  :func:`corrupt_checkpoint`;
* dead data workers — :func:`kill_loader_worker`;
* NaN blow-ups — :func:`poison_nan` (a batch poisoned upstream of the
  model drives the non-finite guard);
* a stalled input pipeline — :func:`delay_batch` (trips
  ``resilience.stall_guard``);
* preemption — :func:`signal_at` (SIGTERM at an exact step boundary),
  :func:`sigterm_self`.

No wall-clock randomness: anything pseudo-random (the bit to flip, the
truncation point of :class:`FaultInjector`) comes from an explicit seed,
by default the ``TPU_SYNCBN_FAULT_SEED`` environment variable
(:func:`fault_seed`), so a failing fault test replays bit for bit. The
serving faults of the JAX module come with the serving port (ROADMAP
A.12).
"""

from __future__ import annotations

import os
import random
import signal as _signal
import time
from typing import Any, Callable, Iterable, Iterator

_SEED_ENV = "TPU_SYNCBN_FAULT_SEED"


def fault_seed(default: int = 0) -> int:
    """The harness seed: ``TPU_SYNCBN_FAULT_SEED`` or ``default``."""
    return int(os.environ.get(_SEED_ENV, default))


# ---------------------------------------------------------------------------
# file corruption


def truncate_file(path: str, *, frac: float = 0.5,
                  keep_bytes: int | None = None) -> int:
    """Truncate ``path`` to ``keep_bytes`` (or ``frac`` of its size) — the
    on-disk signature of a writer killed mid-write without an atomic
    rename. Returns the new size."""
    size = os.path.getsize(path)
    keep = keep_bytes if keep_bytes is not None else int(size * frac)
    keep = max(0, min(size, keep))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def bitflip_file(path: str, *, seed: int | None = None) -> int:
    """Flip ONE bit at a seed-determined offset — silent media or transfer
    corruption that leaves the length intact (only a checksum catches
    it). Returns the byte offset flipped."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot bitflip empty file {path!r}")
    rng = random.Random(fault_seed() if seed is None else seed)
    offset = rng.randrange(size)
    bit = rng.randrange(8)
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([byte ^ (1 << bit)]))
    return offset


def corrupt_checkpoint(directory: str, step: int, mode: str = "truncate", *,
                       seed: int | None = None):
    """Corrupt checkpoint ``step``'s payload in place (``truncate`` or
    ``bitflip``) WITHOUT touching its manifest — the state an interrupted
    writer or a bad disk leaves, which manifest verification must catch."""
    from tpu_syncbn_torch.utils.checkpoint import _path

    path = _path(directory, step)
    if mode == "truncate":
        return truncate_file(path)
    if mode == "bitflip":
        return bitflip_file(path, seed=seed)
    raise ValueError(f"mode must be 'truncate' or 'bitflip', got {mode!r}")


# ---------------------------------------------------------------------------
# process faults


def kill_loader_worker(loader, wid: int = 0) -> int:
    """Hard-kill one persistent process worker of a
    ``data.DataLoader(worker_type="process")`` — the loader must surface a
    ``WorkerError`` (not hang) and stay closeable. Returns the pid."""
    pool = getattr(loader, "_pool", None)
    if not pool:
        raise ValueError(
            "loader has no live process pool (worker_type='process' and at "
            "least one started iteration required)")
    proc = pool["procs"][wid]
    pid = proc.pid
    proc.terminate()
    proc.join(timeout=10)
    return pid


def sigterm_self() -> None:
    """Deliver SIGTERM to this process (the preemption notice)."""
    os.kill(os.getpid(), _signal.SIGTERM)


# ---------------------------------------------------------------------------
# iterator-level faults (deterministic by step index)


def _nanify_tree(tree):
    """Every floating leaf of a batch (numpy arrays, tensors, in tuples,
    lists and dicts) replaced with NaN; other leaves pass through."""
    import numpy as np
    import torch

    from tpu_syncbn_torch.parallel.scan_driver import _map

    def nanify(x):
        if isinstance(x, torch.Tensor):
            return torch.full_like(x, float("nan")) if x.is_floating_point() else x
        arr = np.asarray(x)
        return np.full_like(arr, np.nan) if np.issubdtype(arr.dtype, np.floating) else x

    return _map(nanify, tree)


def poison_nan(batches: Iterable, at_step: int, *,
               leaf_selector: Callable[[Any], Any] | None = None) -> Iterator:
    """Yield ``batches`` unchanged except batch ``at_step`` (0-based), whose
    every float leaf becomes NaN — upstream of the model, this drives the
    trainer's non-finite guard. ``leaf_selector`` may instead transform
    the batch itself."""
    for i, batch in enumerate(batches):
        if i == at_step:
            batch = (leaf_selector(batch) if leaf_selector is not None
                     else _nanify_tree(batch))
        yield batch


def delay_batch(batches: Iterable, at_step: int, delay_s: float) -> Iterator:
    """Yield ``batches``, sleeping ``delay_s`` before batch ``at_step`` — a
    stand-in for a wedged data worker, sized to trip (or not) a
    ``stall_guard`` deadline."""
    for i, batch in enumerate(batches):
        if i == at_step:
            time.sleep(delay_s)
        yield batch


def signal_at(batches: Iterable, at_step: int,
              sig: int = _signal.SIGTERM) -> Iterator:
    """Yield ``batches``, delivering ``sig`` to this process right before
    batch ``at_step`` — preemption at a reproducible step, for
    :class:`~tpu_syncbn_torch.runtime.resilience.PreemptionGuard`'s
    boundary checkpoint."""
    for i, batch in enumerate(batches):
        if i == at_step:
            os.kill(os.getpid(), sig)
        yield batch


class FaultInjector:
    """Seeded façade over the checkpoint faults for multi-fault scripts:
    one ``FaultInjector(seed)`` gives a reproducible sequence of
    corruptions (each draw advances its private RNG; no global state)."""

    def __init__(self, seed: int | None = None):
        self.seed = fault_seed() if seed is None else seed
        self._rng = random.Random(self.seed)

    def next_seed(self) -> int:
        return self._rng.randrange(2**31)

    def bitflip_file(self, path: str) -> int:
        return bitflip_file(path, seed=self.next_seed())

    def truncate_file(self, path: str, frac: float | None = None) -> int:
        f = self._rng.uniform(0.1, 0.9) if frac is None else frac
        return truncate_file(path, frac=f)

    def corrupt_checkpoint(self, directory: str, step: int,
                           mode: str | None = None):
        m = self._rng.choice(["truncate", "bitflip"]) if mode is None else mode
        return corrupt_checkpoint(directory, step, m, seed=self.next_seed())
