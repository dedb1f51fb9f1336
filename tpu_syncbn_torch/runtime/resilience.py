"""Fault-tolerant training runtime — the counterpart of
``tpu_syncbn.runtime.resilience``, kept as a copy (that module is
framework-free, but the JAX package's ``__init__`` imports JAX, so the
port never imports it):

* :class:`PreemptionGuard` — SIGTERM/SIGINT become a checkpoint request
  at the next step boundary instead of a mid-step kill.
* :class:`Watchdog` / :func:`stall_guard` — a step or data fetch that
  stalls past a deadline dumps per-host diagnostics (thread stacks,
  process identity) and, for a fetch, raises :class:`StallError` in the
  consumer instead of hanging.
* :func:`retry_with_backoff` — bounded exponential backoff with
  deterministic jitter (keyed off a string through CRC32, not a
  wall-clock RNG), shared by the rendezvous in
  ``runtime.distributed.initialize``.
* :class:`ResilientLoop` — the above with the manifest-verified
  checkpoints (``utils.checkpoint``) and the trainer's divergence guard:
  a preemption-safe step loop with resume and ``restore_last_good``.

Observability (``obs``): the ``resilience`` counters mirror into the
telemetry registry; a stall counts ``resilience.watchdog_stalls`` or
``resilience.data_stalls``, marks the trace with an instant carrying the
newest open span's id and fires the flight recorder's ``watchdog_stall``
trigger, and a divergence restore fires ``divergence_restore``
(``obs.flightrec``: one incident bundle each when a recorder is
installed). ``ResilientLoop.run`` starts the monitoring server when
``TPU_SYNCBN_METRICS_PORT`` asks for it, installs the recorder and the
memory sampler when ``TPU_SYNCBN_FLIGHTREC`` / ``TPU_SYNCBN_MEMWATCH`` ask
for them, beats the ``"train"`` heartbeat and registers the ``"train"``
readiness hook (``obs.server``), services ``POST /profilez`` captures at
its step boundaries on the main thread (``obs.profiling``), records every
step or chunk in the recorder's step ring, instruments its data wait and
steps (``obs.stepstats``), sets the ``train.step`` gauge, publishes the
numerics monitors (``obs.numerics.NumericsPublisher``) and counts its
collective bytes (``collectives.DispatchWireTally``).

With ``publish_dir`` the loop also writes manifest-verified serving
publications (``utils.checkpoint.publish_version``) at its own cadence,
which a serving process hot-swaps in (``serve.publish``). With
``autopilot=`` (``runtime.autopilot.Autopilot``) it runs the controller's
policy step at every chunk boundary, follows its live K and suppresses it
while a divergence rollback is in flight.
"""

from __future__ import annotations

import contextlib
import io
import os
import signal
import socket
import sys
import threading
import time
import traceback
import zlib
from collections import deque
from typing import Any, Callable, Iterable, Iterator

from tpu_syncbn_torch.runtime import distributed as dist


class StallError(RuntimeError):
    """A step or data fetch exceeded its watchdog deadline."""


# ---------------------------------------------------------------------------
# preemption


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a "checkpoint at the next step
    boundary, then exit" request::

        with PreemptionGuard() as guard:
            for batch in loader:
                dp.train_step(batch)
                if guard.preempted:
                    save_checkpoint(ckpt_dir, step, dp.state_dict())
                    break

    The first signal only sets a flag (read at step boundaries, so the
    saved state is a step-exact snapshot). A second signal re-raises
    through the previously installed handler: a double Ctrl-C still kills
    the process at once.

    Signal handlers are process-global and only installable from the main
    thread; entering the guard elsewhere raises ``ValueError`` (from
    ``signal.signal``) rather than silently protecting nothing."""

    def __init__(
        self,
        signals: tuple = (signal.SIGTERM, signal.SIGINT),
        *,
        callback: Callable[[int], None] | None = None,
    ):
        self._signals = tuple(signals)
        self._callback = callback
        self._subscribers: list[Callable[[int], None]] = []
        self._event = threading.Event()
        self._prev: dict[int, Any] = {}
        self._received: int | None = None
        self._installed = False

    def subscribe(self, fn: Callable[[int], None]) -> None:
        """Add a listener called (after the construction ``callback``) on
        the FIRST signal. Listener exceptions are swallowed: a broken
        subscriber must not turn a polite drain into a crash inside a
        signal handler."""
        self._subscribers.append(fn)

    def _handle(self, signum, frame):
        if self._event.is_set():
            # second delivery: the original disposition (usually fatal)
            self._restore()
            os.kill(os.getpid(), signum)
            return
        self._received = signum
        self._event.set()
        dist.get_logger("tpu_syncbn_torch.resilience").warning(
            "received signal %d: will checkpoint at the next step boundary "
            "and exit", signum)
        if self._callback is not None:
            self._callback(signum)
        for fn in self._subscribers:
            with contextlib.suppress(Exception):
                fn(signum)

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handle)
        self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        self._restore()

    def _restore(self) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                with contextlib.suppress(Exception):
                    signal.signal(s, prev)
            self._installed = False

    @property
    def preempted(self) -> bool:
        """True once a shutdown signal has been received."""
        return self._event.is_set()

    @property
    def signum(self) -> int | None:
        return self._received

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


# ---------------------------------------------------------------------------
# watchdog


def dump_stacks(header: str = "") -> str:
    """Per-host diagnostic snapshot: process identity (rank and world from
    the process group, the host name, the CUDA devices seen) and every
    Python thread's stack — what each host must show to tell which rank a
    stalled collective waits on."""
    buf = io.StringIO()
    if header:
        buf.write(header + "\n")
    try:
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        buf.write(f"host {dist.process_index()}/{dist.process_count()} "
                  f"({socket.gethostname()}, pid {os.getpid()}, {cards} CUDA "
                  "device(s))\n")
    except Exception as e:  # diagnostics must never throw past themselves
        buf.write(f"process identity unavailable: {e}\n")
    frames = sys._current_frames()
    threads = {t.ident: t for t in threading.enumerate()}
    for ident, frame in frames.items():
        t = threads.get(ident)
        name = t.name if t else f"thread-{ident}"
        buf.write(f"--- thread {name} ---\n")
        buf.write("".join(traceback.format_stack(frame)))
    return buf.getvalue()


class Watchdog:
    """Deadline monitor for the step loop: if :meth:`pat` is not called
    within ``deadline_s``, dump per-host diagnostics (once per stall) and
    call ``on_stall`` with the dump — after logging it at ERROR, so a hung
    collective leaves evidence on every host instead of a silent freeze.
    A daemon thread; ``close()`` (or leaving the context) stops it."""

    def __init__(
        self,
        deadline_s: float,
        *,
        name: str = "step",
        on_stall: Callable[[str], None] | None = None,
        poll_s: float | None = None,
        start_armed: bool = True,
    ):
        """``start_armed=False`` starts the deadline clock at the first
        :meth:`pat`: for loops whose first iteration legitimately dwarfs
        the steady deadline (kernels built, a graph captured)."""
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.name = name
        self._on_stall = on_stall
        self._poll_s = poll_s if poll_s is not None else min(0.05, deadline_s / 4)
        self._last = time.monotonic() if start_armed else None
        self._stalled_since: float | None = None
        self.stall_count = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=f"watchdog-{name}",
                                        daemon=True)
        self._thread.start()

    def pat(self) -> None:
        """Mark liveness (once per step or chunk)."""
        self._last = time.monotonic()
        self._stalled_since = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            if self._last is None:
                continue  # not armed yet
            idle = time.monotonic() - self._last
            if idle > self.deadline_s and self._stalled_since is None:
                self._stalled_since = self._last
                self.stall_count += 1
                # tag the dump with the most recently opened trace span
                # (this thread has no span stack of its own), so a
                # Perfetto trace and the log join on the span id
                from tpu_syncbn_torch.obs import flightrec, telemetry, tracing

                span_id = tracing.latest_open_span_id()
                telemetry.count("resilience.watchdog_stalls")
                tracing.instant(
                    "watchdog_stall", watchdog=self.name, idle_s=round(idle, 2),
                    **({"span_id": span_id} if span_id is not None else {}))
                tag = f", trace_span={span_id}" if span_id is not None else ""
                diag = dump_stacks(
                    f"WATCHDOG: {self.name!r} stalled for {idle:.1f}s "
                    f"(deadline {self.deadline_s}s{tag})")
                dist.get_logger("tpu_syncbn_torch.resilience").error("%s", diag)
                # the stack dump says where THIS host is stuck; the incident
                # bundle says what the process was doing in the seconds
                # before (its step ring never waits on the stalled work)
                flightrec.trigger("watchdog_stall", {
                    "watchdog": self.name, "idle_s": round(idle, 2),
                    "deadline_s": self.deadline_s,
                    **({"span_id": span_id} if span_id is not None else {}),
                })
                if self._on_stall is not None:
                    with contextlib.suppress(Exception):
                        self._on_stall(diag)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stall_guard(iterator: Iterable, deadline_s: float, *,
                name: str = "batch") -> Iterator:
    """Wrap a (possibly hanging) batch iterator so the consumer never
    blocks past ``deadline_s`` on one item: a fetcher thread pulls from the
    source while the consumer waits on a queue with a timeout, raising
    :class:`StallError` (with per-host stacks logged) when the deadline
    passes — a hung data worker becomes a catchable fault at the step
    boundary instead of an indefinite hang.

    The fetcher prefetches at most one item. Once the consumer is done
    (StallError raised, generator closed, source exhausted) a stop flag
    makes the fetcher exit as soon as its pending ``next()`` returns,
    so an abandoned guard stops pulling from the source."""
    import queue as _queue

    if deadline_s <= 0:
        raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
    q: Any = _queue.Queue(maxsize=1)
    DONE, ERR = object(), object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def fetch():
        try:
            for item in iterator:
                if not put(("ok", item)):
                    return  # consumer gone: do not touch the source again
        except BaseException as e:
            put((ERR, e))
            return
        put((DONE, None))

    t = threading.Thread(target=fetch, name=f"stall-guard-{name}", daemon=True)
    t.start()
    try:
        while True:
            try:
                tag, payload = q.get(timeout=deadline_s)
            except _queue.Empty:
                from tpu_syncbn_torch.obs import flightrec, telemetry, tracing

                span_id = tracing.latest_open_span_id()
                telemetry.count("resilience.data_stalls")
                tracing.instant(
                    "data_stall", source=name,
                    **({"span_id": span_id} if span_id is not None else {}))
                tag = f" (trace_span={span_id})" if span_id is not None else ""
                diag = dump_stacks(f"WATCHDOG: {name!r} fetch exceeded {deadline_s}s{tag}")
                dist.get_logger("tpu_syncbn_torch.resilience").error("%s", diag)
                flightrec.trigger("watchdog_stall", {
                    "source": name, "deadline_s": deadline_s,
                    "stall": "data_fetch",
                })
                raise StallError(
                    f"{name} fetch exceeded the {deadline_s}s watchdog "
                    "deadline") from None
            if tag is DONE:
                return
            if tag is ERR:
                raise payload
            yield payload
    finally:
        stop.set()


# ---------------------------------------------------------------------------
# retry / backoff


def backoff_delays(
    attempts: int,
    *,
    base_s: float = 1.0,
    max_s: float = 30.0,
    jitter: float = 0.25,
    key: str = "",
) -> list[float]:
    """The ``attempts - 1`` sleeps between retries: ``base_s · 2**i``
    capped at ``max_s``, spread by ±``jitter`` of itself with a unit
    interval hashed from ``(key, i)``."""
    delays = []
    for i in range(max(0, attempts - 1)):
        d = min(max_s, base_s * (2 ** i))
        u = (zlib.crc32(f"{key}:{i}".encode()) & 0xFFFFFFFF) / 0xFFFFFFFF
        delays.append(d * (1.0 + jitter * (2.0 * u - 1.0)))
    return delays


def retry_with_backoff(
    fn: Callable[[], Any],
    *,
    attempts: int = 3,
    base_s: float = 1.0,
    max_s: float = 30.0,
    jitter: float = 0.25,
    key: str = "",
    retry_on: tuple = (Exception,),
    describe: str = "operation",
    sleep: Callable[[float], None] | None = None,
) -> Any:
    """Call ``fn`` up to ``attempts`` times with :func:`backoff_delays`
    between failures; the last failure re-raises. Each retry is logged
    with its exception (WARNING, so every rank shows it)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if sleep is None:
        sleep = time.sleep
    delays = backoff_delays(attempts, base_s=base_s, max_s=max_s,
                            jitter=jitter, key=key)
    logger = dist.get_logger("tpu_syncbn_torch.resilience")
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if i == attempts - 1:
                raise
            logger.warning(
                "%s failed (attempt %d/%d: %s: %s); retrying in %.2fs",
                describe, i + 1, attempts, type(e).__name__, e, delays[i],
            )
            sleep(delays[i])
    raise AssertionError("unreachable")


# ---------------------------------------------------------------------------
# orchestration


def _default_counters():
    from tpu_syncbn_torch.obs.telemetry import CounterGroup

    return CounterGroup("resilience")


def _nonfinite_steps(metrics: dict) -> int:
    """Skipped steps a step's (scalar) or a chunk's ((K,)) ``nonfinite``
    metric counts: one host read."""
    v = metrics.get("nonfinite")
    if v is None:
        return 0
    import torch

    return int(round(float(torch.as_tensor(v).double().sum())))


class ResilientLoop:
    """Preemption-safe training driver over any trainer with the
    ``state_dict``/``load_state_dict``/``train_step`` surface
    (``DataParallel``'s; ``train_steps_batches`` too for ``scan_steps``)::

        loop = ResilientLoop(dp, ckpt_dir, ckpt_every=100)
        start = loop.resume()                  # newest VERIFIED checkpoint
        summary = loop.run(batches)            # SIGTERM-safe, NaN-guarded

    * resume: :meth:`resume` restores the newest verified checkpoint and
      returns the step to continue from (0 when there is none).
    * preemption: SIGTERM/SIGINT set a flag; the loop finishes the
      in-flight step (or chunk), saves at the boundary and returns with
      ``summary["preempted"] = True`` — exit code 0, and the restarted
      job resumes exactly there.
    * divergence: with ``divergence_guard="restore_last_good"`` a step
      reporting ``nonfinite`` reloads the last verified checkpoint;
      ``max_restores`` bounds the thrash (beyond it the loop raises
      ``FloatingPointError``). ``skip_step`` and ``halve_lr`` need no host
      help: the loop only counts them.
    * liveness: ``step_deadline_s`` arms a :class:`Watchdog` patted every
      step; data stalls are guarded at the iterator with
      :func:`stall_guard` (it raises, so the loop leaves through its
      exception path, which still flushes pending checkpoint writes)."""

    #: Bounded wait for async checkpoint writes while a training failure
    #: is already propagating: long enough for any healthy write, short
    #: enough that a wedged writer cannot turn a StallError into a hang.
    _EXC_FLUSH_TIMEOUT_S = 60.0

    def __init__(
        self,
        trainer,
        ckpt_dir: str,
        *,
        ckpt_every: int = 100,
        keep: int = 3,
        max_restores: int = 3,
        step_deadline_s: float | None = None,
        counters=None,
        scan_steps: int = 1,
        async_checkpoint: bool = False,
        publish_dir: str | None = None,
        publish_every: int | None = None,
        publish_keep: int = 3,
        autopilot=None,
    ):
        """``scan_steps=K > 1`` drives the fused path: ``batches`` must
        yield K-stacked chunks (``data.device_prefetch(scan_steps=K)``) and
        the loop calls ``trainer.train_steps_batches`` once per chunk (one
        graph replay on the card), honouring preemption, checkpoint
        cadence and divergence policies at chunk boundaries; the guard
        still skips each bad step inside the chunk. ``step_deadline_s``
        stays a per-STEP deadline: the watchdog is armed at
        ``step_deadline_s * K``, since it is patted once a chunk.

        ``async_checkpoint=True`` saves through
        ``utils.checkpoint.AsyncCheckpointer`` (the loop pays the host
        snapshot) and flushes pending writes on every exit path, so the
        preemption checkpoint is durable before the process yields.

        ``publish_dir`` additionally emits manifest-verified *serving*
        publications (``utils.checkpoint.publish_version``) every
        ``publish_every`` steps (default: ``ckpt_every``), versioned by the
        step counter and keeping the newest ``publish_keep``: the inference
        pair ``{"params", "rest"}`` of the trainer's module (the BN running
        statistics ride along; ``serve.publish.serving_state``) that a
        serving process hot-swaps in through
        ``serve.publish.SwapController.swap_from_publication``.
        Publications follow the checkpoint transport: through the
        ``AsyncCheckpointer`` when ``async_checkpoint=True``.

        ``autopilot`` attaches a
        :class:`~tpu_syncbn_torch.runtime.autopilot.Autopilot`: the loop
        calls its :meth:`~tpu_syncbn_torch.runtime.autopilot.Autopilot.on_chunk`
        at every chunk boundary (with ``recovering=True`` right after a
        ``restore_last_good``, so the rollback suppresses every knob),
        mirrors its live ``scan_k`` into ``self.scan_steps`` in chunked
        mode, and recomputes the watchdog deadline from the live K at every
        chunk. Feed the loop through
        :func:`~tpu_syncbn_torch.runtime.autopilot.chunked_batches` so the
        data side follows the K actuator; a chunk of one step still runs
        through ``train_steps_batches``."""
        if ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
        if scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        if publish_every is not None and publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, got {publish_every}")
        self.trainer = trainer
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.max_restores = max_restores
        self.step_deadline_s = step_deadline_s
        self.scan_steps = scan_steps
        self.autopilot = autopilot
        self.publish_dir = publish_dir
        self.publish_every = int(publish_every) if publish_every is not None else ckpt_every
        self.publish_keep = publish_keep
        self.counters = counters if counters is not None else _default_counters()
        self.step = 0
        #: True from a divergence restore until a finite step lands on the
        #: restored state (read by :meth:`readiness`)
        self.recovering = False
        #: the newest verdicts of :meth:`readiness` (whoever asked: a
        #: ``/readyz`` probe, an incident bundle), oldest first
        self.readiness_log: deque = deque(maxlen=256)
        self._guard: PreemptionGuard | None = None
        self._async = None
        if async_checkpoint:
            from tpu_syncbn_torch.utils.checkpoint import AsyncCheckpointer

            self._async = AsyncCheckpointer(keep=keep)
        self._log = dist.get_logger("tpu_syncbn_torch.resilience")

    # -- checkpoint plumbing ----------------------------------------------

    def flush_checkpoints(self, timeout: float | None = None) -> bool:
        """Block until async checkpoint writes (if any) are durable —
        called on every ``run()`` exit path and before any read of the
        checkpoint directory. Returns False when ``timeout`` expired with
        writes still in flight."""
        if self._async is not None:
            return self._async.flush(timeout)
        return True

    def close(self) -> None:
        """Flush and stop the async checkpoint worker (no-op without
        ``async_checkpoint=True``). Idempotent."""
        if self._async is not None:
            self._async.close()

    def __enter__(self) -> "ResilientLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def readiness(self) -> tuple[bool, dict]:
        """The loop's readiness check (registered as the ``"train"`` hook
        of ``obs.server`` while :meth:`run` is active): not ready once
        preemption has been signaled (the process is about to checkpoint
        and exit) or while a divergence rollback is in flight. The detail
        carries the live step counter. Each verdict is kept in
        :attr:`readiness_log`."""
        guard = self._guard
        preempted = bool(guard.preempted) if guard is not None else False
        recovering = self.recovering
        ok = not preempted and not recovering
        detail = {"step": self.step, "preempted": preempted,
                  "recovering": recovering}
        self.readiness_log.append({"ok": ok, **detail})
        return ok, detail

    def resume(self) -> int:
        """Restore the newest verified checkpoint (if any); returns the
        step training continues from."""
        from tpu_syncbn_torch.parallel.trainer import resume_latest

        self.flush_checkpoints()
        self.step = resume_latest(self.trainer, self.ckpt_dir)
        if self.step:
            self.counters.bump("resumes")
        return self.step

    def save(self) -> None:
        from tpu_syncbn_torch.utils import checkpoint as ckpt

        if self._async is not None:
            self._async.save(self.ckpt_dir, self.step, self.trainer.state_dict(),
                             keep=self.keep)
        else:
            ckpt.save_checkpoint(self.ckpt_dir, self.step,
                                 self.trainer.state_dict(), keep=self.keep)
        self.counters.bump("checkpoints")

    def publish(self) -> None:
        """Emit a manifest-verified serving publication of the trainer's
        current weights at ``publish_dir``, versioned by the step counter
        (no-op without ``publish_dir``): the inference pair ``{"params",
        "rest"}`` of ``serve.publish.serving_state``."""
        if self.publish_dir is None:
            return
        from tpu_syncbn_torch.serve.publish import serving_state
        from tpu_syncbn_torch.utils import checkpoint as ckpt

        params, rest = serving_state(self.trainer)
        tree = {"params": params, "rest": rest}
        if self._async is not None:
            self._async.publish(self.publish_dir, self.step, tree, keep=self.publish_keep)
        else:
            ckpt.publish_version(self.publish_dir, self.step, tree,
                                 keep=self.publish_keep, step=self.step)
        self.counters.bump("publishes")

    def _restore_last_good(self) -> None:
        from tpu_syncbn_torch.parallel.trainer import resume_latest
        from tpu_syncbn_torch.utils import checkpoint as ckpt

        self.flush_checkpoints()
        if not ckpt.available_steps(self.ckpt_dir):
            # divergence before the first save: the guard already skipped
            # the update on the device, so skip-step semantics are safe
            self.counters.bump("divergence_skips_without_checkpoint")
            self._log.warning(
                "non-finite loss/grads at step %d with no checkpoint to "
                "restore; the guard already skipped the update — continuing",
                self.step)
            return
        restored = resume_latest(self.trainer, self.ckpt_dir)
        # the restored error-feedback residual holds quantization error of
        # the unwound trajectory: zero it so the recovered run does not
        # replay stale updates (an ordinary resume keeps it)
        reset = getattr(self.trainer, "reset_compression_residual", None)
        if callable(reset):
            reset()
        self.counters.bump("divergence_restores")
        # not ready until a finite step lands on the restored state
        # (cleared in run(); read through readiness())
        self.recovering = True
        # tag the rollback with the current trace span, so the timeline
        # and this log line correlate
        from tpu_syncbn_torch.obs import flightrec, tracing

        span_id = tracing.latest_open_span_id()
        tracing.instant("divergence_restore", step=self.step, restored_step=restored,
                        **({"span_id": span_id} if span_id is not None else {}))
        self._log.warning(
            "non-finite loss/grads at step %d: restored last good "
            "checkpoint (step %d)%s", self.step, restored,
            f" (trace_span={span_id})" if span_id is not None else "")
        # the bundle holds the step records from the steps BEFORE the
        # blow-up — the evidence a post-mortem of the divergence needs
        flightrec.trigger("divergence_restore", {
            "step": self.step, "restored_step": restored,
            **({"span_id": span_id} if span_id is not None else {}),
        })
        self.step = restored

    # -- the loop ---------------------------------------------------------

    def run(self, batches: Iterable, *, max_steps: int | None = None) -> dict:
        """Drive ``trainer.train_step`` over ``batches`` (or
        ``trainer.train_steps_batches`` over K-stacked chunks when
        ``scan_steps=K > 1``) with preemption, divergence and liveness
        handling. Returns a summary (``steps``, ``step``, ``preempted``,
        and the counters).

        In chunked mode host policies fire at chunk boundaries: a SIGTERM
        landing mid-chunk lets the chunk finish (its K steps are one
        program), then checkpoints and exits; ``ckpt_every`` saves when
        the step counter crosses a multiple; ``max_steps`` is checked
        before each chunk, so a run may overshoot it by at most K-1 steps.
        Pending async writes are flushed on every exit path."""
        from tpu_syncbn_torch.obs import (
            flightrec, memwatch, numerics as obs_numerics, profiling,
            server as obs_server, stepstats, telemetry,
        )
        from tpu_syncbn_torch.parallel.collectives import DispatchWireTally

        policy = getattr(self.trainer, "divergence_guard", None)
        scanned = self.scan_steps > 1
        preempted = False
        steps_run = 0
        # live monitoring: with TPU_SYNCBN_METRICS_PORT set this run answers
        # /metrics, /healthz (the step heartbeat below), /readyz (the
        # "train" hook), /statusz, /incidentz and /profilez
        obs_server.start_from_env()
        # flight recorder and memory watermarks: with TPU_SYNCBN_FLIGHTREC
        # set this run keeps bounded rings of recent spans and steps and
        # dumps an incident bundle on a divergence restore or a stall; with
        # TPU_SYNCBN_MEMWATCH set it samples memory in the background
        flightrec.install_from_env()
        memwatch.install_from_env()
        obs_server.register_readiness("train", self.readiness)
        wire_tally = DispatchWireTally()
        # the numerics monitors reach the registry once their device
        # values have landed on the host (never a forced synchronize)
        numerics_pub = obs_numerics.NumericsPublisher()
        try:
            with contextlib.ExitStack() as stack:
                guard = stack.enter_context(PreemptionGuard())
                self._guard = guard
                watchdog = None
                if self.step_deadline_s is not None:
                    # armed at the first pat: the first step builds kernels
                    # (and captures its graph) well past a steady deadline
                    watchdog = stack.enter_context(
                        Watchdog(self.step_deadline_s * self.scan_steps,
                                 name="train-step", start_armed=False))
                # each blocking fetch is a "data_wait" span and histogram
                # sample, each step (or chunk) a span: the seams the bench
                # instruments, so any loop's trace reads the same way
                for batch in stepstats.instrumented_batches(batches):
                    if max_steps is not None and steps_run >= max_steps:
                        break
                    if scanned:
                        with stepstats.timed_span("scan_chunk", "step.chunk_time_s",
                                                  step=self.step + 1):
                            out = self.trainer.train_steps_batches(batch)
                        k = int(out.loss.shape[0])
                    else:
                        with stepstats.timed_span("step", "step.time_s",
                                                  step=self.step + 1):
                            out = self.trainer.train_step(batch)
                        k = 1
                    self.step += k
                    steps_run += k
                    if watchdog is not None:
                        watchdog.pat()
                    # the step heartbeat: its age says whether the loop moves
                    obs_server.HEARTBEATS.beat("train")
                    # a /profilez capture handed to this (main) thread opens
                    # and closes at step boundaries
                    profiling.service_profile_request()
                    telemetry.set_gauge("train.step", self.step)
                    mon = getattr(out, "monitors", None)
                    if scanned and mon:
                        # (K,)-stacked: publish the chunk's last step
                        mon = {name: v[-1] for name, v in mon.items()}
                    if flightrec.get() is not None:
                        # step ring: the loss and metrics (a chunk's final
                        # slice) copied to the host behind the step, no
                        # synchronize (obs.flightrec)
                        metrics = {"loss": out.loss, **(out.metrics or {})}
                        if scanned:
                            metrics = {name: v[-1] if getattr(v, "ndim", 0) else v
                                       for name, v in metrics.items()}
                        flightrec.record_step(self.step, metrics=metrics, monitors=mon)
                    numerics_pub.publish(self.step, mon)
                    wire_tally.after_dispatch(k)
                    if policy is not None:
                        nonfinite = _nonfinite_steps(out.metrics)
                        if not nonfinite:
                            # a finite step on the (possibly restored)
                            # state: the rollback, if any, is complete
                            self.recovering = False
                        if nonfinite:
                            self.counters.bump("nonfinite_steps", nonfinite)
                            if policy == "restore_last_good":
                                if (self.counters.count("divergence_restores")
                                        >= self.max_restores):
                                    raise FloatingPointError(
                                        "divergence persisted through "
                                        f"{self.max_restores} restore_last_good "
                                        "recoveries — refusing to thrash")
                                self._restore_last_good()
                                if self.autopilot is not None:
                                    # the guard owns the process during a
                                    # rollback: the policy step is
                                    # suppressed, and recorded as such
                                    self.autopilot.on_chunk(step=self.step, k=k,
                                                            recovering=True)
                                if guard.preempted:
                                    # the restored state IS the last durable
                                    # checkpoint: exit now
                                    preempted = True
                                    self._log.warning(
                                        "preempted during divergence recovery "
                                        "at step %d; state already durable; "
                                        "exiting cleanly", self.step)
                                    break
                                continue
                    if self.autopilot is not None:
                        # the chunk-boundary policy step, the only place
                        # knobs turn; the loop mirrors the live K (the data
                        # side follows through chunked_batches)
                        self.autopilot.on_chunk(step=self.step, k=k,
                                                recovering=self.recovering)
                        if scanned:
                            self.scan_steps = max(1, int(self.autopilot.scan_k))
                    if watchdog is not None and self.step_deadline_s is not None:
                        # recomputed a chunk from the live K: a K actuation
                        # must not leave a stale stall threshold
                        watchdog.deadline_s = self.step_deadline_s * max(1, self.scan_steps)
                    if guard.preempted:
                        self.save()
                        preempted = True
                        self._log.warning(
                            "preemption checkpoint written at step %d; "
                            "exiting cleanly", self.step)
                        break
                    if self.step // self.ckpt_every != (self.step - k) // self.ckpt_every:
                        self.save()
                    if (self.publish_dir is not None and self.step // self.publish_every
                            != (self.step - k) // self.publish_every):
                        self.publish()
        except BaseException:
            # async writes still get their chance, but a flush failure must
            # not replace the loop's own failure (a FloatingPointError or
            # StallError handler has to see its type), and a wedged writer
            # must not turn it into a hang: bounded wait, log, propagate
            try:
                if not self.flush_checkpoints(timeout=self._EXC_FLUSH_TIMEOUT_S):
                    self._log.error(
                        "async checkpoint flush still pending after %.0fs "
                        "while a training failure was propagating; abandoning "
                        "the write (checkpoint directory may be stale)",
                        self._EXC_FLUSH_TIMEOUT_S)
            except Exception:
                self._log.exception(
                    "async checkpoint flush failed while a training failure "
                    "was already propagating")
            raise
        finally:
            # neither the hook nor the beat outlives the run: a finished
            # loop is no readiness claim and no stale liveness source
            obs_server.unregister_readiness("train")
            obs_server.HEARTBEATS.clear("train")
            self._guard = None
            try:
                # the profiler does not outlive the loop that started it
                profiling.finish_profile_request()
            except Exception:
                self._log.exception("closing a /profilez capture failed on loop exit")
            try:
                # non-blocking tail drain: a blocking flush here could hang
                # on the exit that matters most (a stalled device)
                numerics_pub.publish(self.step, None)
            except Exception:
                self._log.exception("numerics publisher drain failed on loop exit")
        # durable before control leaves the loop; a flush error DOES raise
        # here: {"preempted": True} over a failed boundary write would
        # claim a durability it lacks
        self.flush_checkpoints()
        # clean exit: the loop's last step was dispatched, so the blocking
        # drain is safe and the final steps' monitors reach the registry
        numerics_pub.flush()
        return {"steps": steps_run, "step": self.step, "preempted": preempted,
                **self.counters.summary()}
