"""Deterministic fault injection — the counterpart of
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
(:func:`fault_seed`), so a failing fault test replays bit for bit.

The serving faults wrap an engine (deterministic by engine-call index):
:func:`slow_engine`, :func:`crash_engine_at_batch`,
:func:`poison_request` with :func:`poison_sensitive_engine`, and
:func:`crash_engine_on_version`. The weight-publication faults drive the
swap chaos matrix of ``serve.publish``: :func:`corrupt_publication`,
:func:`skew_published_manifest` and :func:`signal_at_phase`.
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


# ---------------------------------------------------------------------------
# serving faults (deterministic by engine-call index)


class PoisonedRequestError(RuntimeError):
    """Raised by :func:`poison_sensitive_engine` when a batch contains a
    poisoned payload — the stand-in for a malformed request crashing the
    program call it was coalesced into."""


class _EngineProxy:
    """Duck-typed engine wrapper: forwards the batcher-facing surface
    (``bucket_for`` / ``max_bucket`` / ``predict`` / ``warm`` /
    ``stats`` / ``health``) and lets a subclass intervene around
    ``predict``. ``self.calls`` counts predict invocations — the
    deterministic index every serving fault keys off (no wall clock)."""

    def __init__(self, engine):
        self._engine = engine
        self.calls = 0

    @property
    def max_bucket(self):
        return self._engine.max_bucket

    def bucket_for(self, n):
        return self._engine.bucket_for(n)

    def warm(self, batch):
        return self._engine.warm(batch)

    def stats(self):
        return self._engine.stats()

    def health(self):
        inner = getattr(self._engine, "health", None)
        return inner() if callable(inner) else {}

    def _before_predict(self, call_index: int, batch) -> None:
        """Hook: raise or sleep to inject the fault."""

    def predict(self, batch):
        i = self.calls
        self.calls += 1
        self._before_predict(i, batch)
        return self._engine.predict(batch)

    # versioned-swap surface (a swap controller duck-types the engine,
    # so a faulted proxy must stay swappable)

    @property
    def version(self):
        return getattr(self._engine, "version", 0)

    @property
    def previous_version(self):
        return getattr(self._engine, "previous_version", None)

    def swap_params(self, params, rest=None, *, version):
        return self._engine.swap_params(params, rest, version=version)

    def rollback(self):
        return self._engine.rollback()

    def params_nbytes(self):
        fn = getattr(self._engine, "params_nbytes", None)
        return int(fn()) if callable(fn) else 0


def slow_engine(engine, delay_s: float, *,
                at_calls: Iterable[int] | None = None):
    """Wrap ``engine`` so ``predict`` sleeps ``delay_s`` before running —
    on every call, or only on the 0-based call indices in ``at_calls``.
    A delay sized past a request deadline deterministically drives the
    admission layer's predicted-completion shedding (the estimator
    observes the slow calls, then sheds what cannot finish in time)."""
    if delay_s < 0:
        raise ValueError(f"delay_s must be >= 0, got {delay_s}")
    at = None if at_calls is None else frozenset(int(i) for i in at_calls)

    class _Slow(_EngineProxy):
        def _before_predict(self, i, batch):
            if at is None or i in at:
                time.sleep(delay_s)

    return _Slow(engine)


def crash_engine_at_batch(engine, at_batch: int, *,
                          n_batches: int | None = 1,
                          exc_factory=None):
    """Wrap ``engine`` so ``predict`` raises for call indices in
    ``[at_batch, at_batch + n_batches)`` (``n_batches=None`` = forever) —
    the deterministic engine-crash window that opens the circuit
    breaker; a finite window lets the half-open probe find a recovered
    engine. ``exc_factory()`` builds the exception (default
    ``RuntimeError``)."""
    if at_batch < 0:
        raise ValueError(f"at_batch must be >= 0, got {at_batch}")
    if n_batches is not None and n_batches < 1:
        raise ValueError(f"n_batches must be >= 1 or None, got {n_batches}")
    make_exc = exc_factory if exc_factory is not None else (
        lambda: RuntimeError("injected engine crash")
    )

    class _Crash(_EngineProxy):
        def _before_predict(self, i, batch):
            if i >= at_batch and (n_batches is None
                                  or i < at_batch + n_batches):
                raise make_exc()

    return _Crash(engine)


def poison_request(item):
    """A poisoned copy of request payload ``item``: every float leaf
    replaced with NaN (:func:`_nanify_tree` — the exact transform
    :func:`poison_nan` applies to training batches) — shape- and
    dtype-compatible with its batchmates, so it coalesces cleanly and
    the failure happens where it does in production: inside the engine
    call."""
    return _nanify_tree(item)


def poison_sensitive_engine(engine):
    """Wrap ``engine`` so ``predict`` raises
    :class:`PoisonedRequestError` when the batch contains any non-finite
    float value — the sensitivity that turns a :func:`poison_request`
    payload into a crashed batch. The isolation contract under test:
    ONLY the batch the poison was coalesced into fails; the batcher
    keeps serving and the circuit stays closed."""
    import numpy as np

    from tpu_syncbn_torch.serve.engine import tree_leaves

    class _PoisonSensitive(_EngineProxy):
        def _before_predict(self, i, batch):
            for leaf in tree_leaves(batch):
                arr = np.asarray(leaf)
                if np.issubdtype(arr.dtype, np.floating) \
                        and not np.all(np.isfinite(arr)):
                    raise PoisonedRequestError(
                        f"poisoned payload in engine call {i}"
                    )

    return _PoisonSensitive(engine)


# ---------------------------------------------------------------------------
# weight-publication faults (the serve.publish swap chaos matrix)


def corrupt_publication(directory: str, mode: str = "truncate", *,
                        target: str = "payload",
                        version: int | None = None,
                        seed: int | None = None):
    """Corrupt the *published* weight version in place — the pointed-at
    version by default (the one a serving process would swap in next).
    ``target='payload'`` hits the versioned weights file,
    ``target='manifest'`` deletes the manifest outright (mode ignored — a
    missing manifest must be treated as corruption, never as "verification
    optional"). The pointer file itself is left intact: the injected state
    is exactly "the pointer promises bytes the disk can no longer back",
    which ``load_published`` verification must catch BEFORE any request
    touches the new weights."""
    from tpu_syncbn_torch.utils.checkpoint import (
        _pub_manifest_path, _pub_path, published_version,
    )

    if version is None:
        version = published_version(directory)
    if version is None:
        raise ValueError(f"no published version in {directory!r}")
    if target == "manifest":
        os.unlink(_pub_manifest_path(directory, version))
        return None
    if target != "payload":
        raise ValueError(f"target must be 'payload' or 'manifest', got {target!r}")
    path = _pub_path(directory, version)
    if mode == "truncate":
        return truncate_file(path)
    if mode == "bitflip":
        return bitflip_file(path, seed=seed)
    raise ValueError(f"mode must be 'truncate' or 'bitflip', got {mode!r}")


def skew_published_manifest(directory: str, *, version: int | None = None,
                            seed: int | None = None) -> str:
    """Rewrite the published manifest's declared ``tree_hash`` to a
    seed-determined wrong value, leaving the payload bytes INTACT — the
    on-disk signature of a publisher running different code than the
    server (version skew: the bytes are fine, the structure they decode to
    is not). ``load_published(expect_tree_hash=...)`` must reject this with
    :class:`~tpu_syncbn_torch.utils.checkpoint.PublicationSkewError`
    *before* deserializing. Returns the bogus hash."""
    import json

    from tpu_syncbn_torch.utils.checkpoint import (
        _pub_manifest_path, published_version,
    )

    if version is None:
        version = published_version(directory)
    if version is None:
        raise ValueError(f"no published version in {directory!r}")
    rng = random.Random(fault_seed() if seed is None else seed)
    bogus = f"{rng.getrandbits(64):016x}"
    path = _pub_manifest_path(directory, version)
    with open(path, "r", encoding="utf-8") as f:
        manifest = json.load(f)
    manifest["tree_hash"] = bogus
    with open(path, "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    return bogus


def signal_at_phase(at_phase: str, sig: int = _signal.SIGTERM, *,
                    calls: list | None = None) -> Callable[[str], None]:
    """A ``SwapController(phase_hook=...)`` that delivers ``sig`` to this
    process the first time the swap crosses ``at_phase`` — the preemption
    notice landing at an exact, reproducible point of the swap's critical
    window (phase names: ``serve.publish.SWAP_PHASES``). ``calls``
    (optional list) collects every phase crossing for assertion. Install a
    handler for ``sig`` first (a ``PreemptionGuard``): the default SIGTERM
    handler ends the process."""
    from tpu_syncbn_torch.serve.publish import SWAP_PHASES

    if at_phase not in SWAP_PHASES:
        raise ValueError(f"at_phase must be one of {SWAP_PHASES}, got {at_phase!r}")
    fired = [False]

    def hook(phase: str) -> None:
        if calls is not None:
            calls.append(phase)
        if phase == at_phase and not fired[0]:
            fired[0] = True
            os.kill(os.getpid(), sig)

    return hook


def crash_engine_on_version(engine, version: int, *, exc_factory=None):
    """Wrap ``engine`` so ``predict`` raises on EVERY call made while
    the engine serves weight version ``version`` — the new weights are
    structurally valid but behaviorally broken (the failure mode
    verification cannot catch). Behind a batcher it fails every call
    after a swap to that version and opens the circuit breaker; after a
    rollback to the previous version the same proxy serves cleanly."""
    make_exc = exc_factory if exc_factory is not None else (
        lambda: RuntimeError(f"injected crash on weight version {version}")
    )

    class _CrashOnVersion(_EngineProxy):
        def _before_predict(self, i, batch):
            if getattr(self._engine, "version", None) == version:
                raise make_exc()

    return _CrashOnVersion(engine)


class FaultInjector:
    """Seeded façade over the file faults for multi-fault scripts:
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

    def corrupt_publication(self, directory: str, mode: str | None = None, *,
                            target: str = "payload", version: int | None = None):
        m = self._rng.choice(["truncate", "bitflip"]) if mode is None else mode
        return corrupt_publication(directory, m, target=target, version=version,
                                   seed=self.next_seed())

    def skew_published_manifest(self, directory: str,
                                version: int | None = None) -> str:
        return skew_published_manifest(directory, version=version,
                                       seed=self.next_seed())
