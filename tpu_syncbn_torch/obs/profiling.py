"""Compile observability and on-demand ``torch.profiler`` capture — the
counterpart of ``tpu_syncbn.obs.profiling`` (the JAX package's
``__init__`` imports JAX, so the port keeps its own copy; the
``compile.*`` and ``obs.profilez.*`` names and the environment knobs are
the JAX module's).

**Compile observability.** Every compile seam — a
:func:`~tpu_syncbn_torch.parallel.scan_driver.cached_program` miss (the
trainers' K-step programs: on the card a warm-up and a CUDA graph
capture) and the trainers' first eager dispatch (the lazy kernel builds,
cuDNN's autotuning and one step) — reports through :func:`note_compile`:
the ``compile.events_total`` counter, a per-family
``compile.<family>.events`` counter, and the ``compile.time_s``
histogram. The *event count* is the load-bearing signal: a program cache
that keeps evicting and rebuilding the same program (a varying chunk
size, a varying batch signature) fails exactly by compiling the same
program over and over.

That failure mode has a detector: :class:`RecompileDetector` keeps a
rolling per-program window of compile events and, when one program
compiles ``threshold`` times within ``window_s``, bumps
``compile.storms`` and fires the ``recompile_storm`` flight-recorder
trigger — the incident bundle's compile ring then holds the compile
history before it.

**On-demand profiling.** :func:`capture` runs a bounded
``torch.profiler`` run and writes its Chrome trace into an
atomically renamed directory — duration-capped
(``TPU_SYNCBN_PROFILE_MAX_S``), size-capped
(``TPU_SYNCBN_PROFILE_MAX_BYTES``: an over-budget capture is deleted, not
kept) and single-flight (Kineto is a process singleton; a second caller
gets :class:`ProfilerBusy`). :func:`serve_capture` is what the
``POST /profilez`` endpoint (``obs.server``) calls. Kineto starts its CUDA
side only on the main thread, so a request from the HTTP thread of a
process that uses the card is handed to the main thread through a
one-request slot that ``ResilientLoop.run`` services at its step
boundaries (:func:`service_profile_request`), with a bounded wait.
:func:`profiler_trace` is the library context manager (master-gated)
that ``utils.metrics.profiler_trace`` deprecates into, and the ImageNet
example's ``--profile-dir``. :func:`compile_rules` is the SLO form of the
storm check (``obs.slo``). :func:`allocation_peak` is the audit's
allocator reading of one application (layer 3's ``xla_peak_bytes``): the
caching allocator's counters on the card, the CPU allocator's events of a
``profile_memory`` window on the CPU. torch is imported lazily (capture
paths only).
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import tempfile
import threading
import time
from collections import deque

from tpu_syncbn_torch.obs import flightrec, telemetry

_ENV_PROFILE_DIR = "TPU_SYNCBN_PROFILE_DIR"
_ENV_PROFILE_MAX_S = "TPU_SYNCBN_PROFILE_MAX_S"
_ENV_PROFILE_MAX_BYTES = "TPU_SYNCBN_PROFILE_MAX_BYTES"
_ENV_STORM_WINDOW_S = "TPU_SYNCBN_RECOMPILE_WINDOW_S"
_ENV_STORM_THRESHOLD = "TPU_SYNCBN_RECOMPILE_THRESHOLD"

#: Hard caps a ``/profilez`` caller cannot exceed (an unbounded remote
#: trace is a disk-filling DoS on the host it is meant to debug).
DEFAULT_PROFILE_MAX_S = 5.0
DEFAULT_PROFILE_MAX_BYTES = 128 << 20

#: Storm defaults: the same program compiling 5 times inside a minute
#: is churn, not warmup. The detector window is keyed per (family,
#: program) — building five *distinct* programs is a healthy startup
#: (five windows, one event each); the same program being evicted and
#: rebuilt five times is the storm.
DEFAULT_STORM_WINDOW_S = 60.0
DEFAULT_STORM_THRESHOLD = 5

#: Bound on the detector's tracked (family, program) keys — the obs
#: plane's bounded-by-construction rule. Past it, idle keys (nothing in
#: the current window) are pruned; if every key is active, the
#: longest-tracked is dropped.
MAX_TRACKED_PROGRAMS = 512

_FAMILY_SANITIZE_RE = re.compile(r"[^a-z0-9_]+")


def _family_token(family) -> str:
    token = _FAMILY_SANITIZE_RE.sub("_", str(family).lower()).strip("_")
    return token or "program"


# ---------------------------------------------------------------------------
# recompile-storm detection


class RecompileDetector:
    """Rolling per-program compile-event window with a storm trigger.

    ``note(family, program)`` appends a timestamped event keyed by
    ``(family, program)`` — ``program`` distinguishes programs within a
    seam family (a program cache's key, a trainer's scan length), so
    warming N *distinct* programs is quiet while rebuilding
    the SAME one churns. When one key accumulates ``threshold`` events
    within the trailing ``window_s`` the detector bumps
    ``compile.storms``, fires the ``recompile_storm`` flight-recorder
    trigger (on ``recorder`` when given, else the installed process
    recorder), clears that key's window (one storm per burst — the
    recorder's cooldown bounds dump frequency independently), and
    returns ``True``. ``now`` is injectable for deterministic tests.
    Thread-safe: any thread may build a program."""

    def __init__(
        self,
        *,
        window_s: float = DEFAULT_STORM_WINDOW_S,
        threshold: int = DEFAULT_STORM_THRESHOLD,
        recorder=None,
        now=time.monotonic,
    ):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if threshold < 2:
            raise ValueError(f"threshold must be >= 2, got {threshold}")
        self.window_s = float(window_s)
        self.threshold = int(threshold)
        self._recorder = recorder
        self._now = now
        self._lock = threading.Lock()
        self._events: dict[str, deque] = {}
        #: lifetime storms per (family, program) key, newest-bounded
        #: (tests / statusz detail)
        self.storms: dict[str, int] = {}

    def note(self, family: str, program: str | None = None) -> bool:
        """Record one compile of ``program`` within ``family``; returns
        True when this event tipped that program over the storm
        threshold."""
        family = _family_token(family)
        key = family if program is None else f"{family}:{program}"
        t = self._now()
        with self._lock:
            q = self._events.setdefault(key, deque())
            q.append(t)
            cutoff = t - self.window_s
            while q and q[0] < cutoff:
                q.popleft()
            if len(self._events) > MAX_TRACKED_PROGRAMS:
                # bounded by construction: drop keys with no event in
                # the current window, then (all-active worst case) the
                # longest-tracked one — a long-lived multi-tenant
                # server compiles unboundedly many distinct programs
                for stale in [k for k, sq in self._events.items()
                              if k != key and
                              (not sq or sq[-1] < cutoff)]:
                    del self._events[stale]
                while len(self._events) > MAX_TRACKED_PROGRAMS:
                    oldest = next(k for k in self._events if k != key)
                    del self._events[oldest]
            if len(q) < self.threshold:
                return False
            count = len(q)
            q.clear()  # one storm per burst
            self.storms[key] = self.storms.get(key, 0) + 1
            while len(self.storms) > MAX_TRACKED_PROGRAMS:
                del self.storms[next(iter(self.storms))]
        telemetry.count("compile.storms")
        rec = self._recorder if self._recorder is not None \
            else flightrec.get()
        if rec is not None:
            rec.trigger("recompile_storm", {
                "family": family,
                "program": program,
                "compiles": count,
                "window_s": self.window_s,
                "threshold": self.threshold,
            })
        return True


_detector_lock = threading.Lock()
_detector: RecompileDetector | None = None


def detector() -> RecompileDetector:
    """The process storm detector (built lazily from the
    ``TPU_SYNCBN_RECOMPILE_{WINDOW_S,THRESHOLD}`` env knobs)."""
    global _detector
    with _detector_lock:
        if _detector is None:
            # per-knob fallback: a typo in one env var must not
            # silently discard the other valid one
            window_s = _env_float(_ENV_STORM_WINDOW_S,
                                  DEFAULT_STORM_WINDOW_S)
            threshold = int(_env_float(_ENV_STORM_THRESHOLD,
                                       DEFAULT_STORM_THRESHOLD))
            _detector = RecompileDetector(
                window_s=window_s, threshold=threshold
            )
        return _detector


def set_detector(det: RecompileDetector | None) -> RecompileDetector | None:
    """Swap the process detector (tests; ``None`` rebuilds from env on
    the next :func:`detector` call). Returns the previous one."""
    global _detector
    with _detector_lock:
        prev, _detector = _detector, det
        return prev


# ---------------------------------------------------------------------------
# the compile seam API


def note_compile(
    family: str, seconds: float | None = None, *,
    program: str | None = None,
) -> None:
    """Report one compile event at a seam: counters + ``compile.time_s``
    (when the seam measured a duration), the flight recorder's compile
    ring, and the storm detector. ``program`` is the within-family
    program identity (a cache-key token) the detector windows on —
    without it the whole family shares one window. What the duration
    covers differs by seam — a program-cache miss is the program's build
    (on the card: warm-up and the CUDA graph's capture), a trainer's
    first eager dispatch is the lazy kernel builds, cuDNN's autotuning
    and one step — so ``compile.time_s`` is a seam-tagged cost signal,
    not a single comparable quantity; the event counts are."""
    family = _family_token(family)
    telemetry.count("compile.events_total")
    telemetry.count(f"compile.{family}.events")
    if seconds is not None:
        telemetry.observe("compile.time_s", float(seconds))
    if program is None:
        flightrec.record_compile(family, seconds)
    else:
        flightrec.record_compile(family, seconds, program=program)
    detector().note(family, program)


@contextlib.contextmanager
def timed_compile(family: str, program: str | None = None):
    """Time a compile-seam block into :func:`note_compile`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        note_compile(family, time.perf_counter() - t0, program=program)


def compile_rules(
    *,
    total: str = "step.time_s",
    target: float = 0.99,
    windows_s=(60.0, 300.0),
    burn_threshold: float = 2.0,
) -> list:
    """The recompile-storm SLO rule, ready for
    ``SLOTracker(agg, compile_rules()).attach()`` (``obs.slo``): compiles
    (``compile.events_total``) as a budgeted fraction of ``total`` (steps
    by default; pass ``"serve.requests"`` for a serving process) — a
    steady-state run compiles ~never, so more than ``1 - target`` of
    recent steps triggering a compile is churn, burning the budget."""
    from tpu_syncbn_torch.obs import slo

    return [
        slo.AlertRule(
            "recompile_storm",
            slo.SubsetRate(total=total, bad="compile.events_total",
                           target=target),
            windows_s=windows_s, burn_threshold=burn_threshold,
        ),
    ]


# ---------------------------------------------------------------------------
# on-demand profiler capture


class ProfilerUnavailable(RuntimeError):
    """No capture directory configured (``TPU_SYNCBN_PROFILE_DIR``) and
    none passed explicitly — or, in a process that uses CUDA, a capture
    that recorded no CUDA activity (the profiler's CUDA side is missing)."""


class ProfilerBusy(RuntimeError):
    """A capture (or another ``torch.profiler`` run) is already
    running — Kineto is a process singleton."""


#: single-flight: concurrent captures must not interleave starts and
#: stops of the process-global profiler
_capture_lock = threading.Lock()
#: per-process capture sequence: two captures in the same wall-clock
#: second must not collide on the final directory name (os.replace
#: onto an existing non-empty dir would delete the second capture)
_capture_seq = 0


def configured_dir() -> str | None:
    """The env-configured capture root, or ``None`` (the ``/profilez``
    gate: no knob, no remote profiling)."""
    d = os.environ.get(_ENV_PROFILE_DIR, "").strip()
    return d or None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "").strip() or default)
    except ValueError:
        return default


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for fn in files:
            with contextlib.suppress(OSError):
                total += os.path.getsize(os.path.join(root, fn))
    return total


class _Capture:
    """One bounded ``torch.profiler`` run in two halves — :meth:`start` and
    :meth:`finish` — so the ``/profilez`` hand-off can open the window at
    one step boundary of the main thread's loop and close it at a later
    one. :func:`capture` runs both around a sleep."""

    def __init__(self, duration_s: float, log_dir: str | None = None):
        self.root = log_dir or configured_dir()
        if not self.root:
            raise ProfilerUnavailable(
                f"no profiler capture directory — set {_ENV_PROFILE_DIR}"
            )
        max_s = _env_float(_ENV_PROFILE_MAX_S, DEFAULT_PROFILE_MAX_S)
        self.max_bytes = int(
            _env_float(_ENV_PROFILE_MAX_BYTES, DEFAULT_PROFILE_MAX_BYTES)
        )
        self.duration_s = min(max(0.0, float(duration_s)), max_s)
        self._prof = None
        self._tmp = None
        self._cuda = False
        self._t0 = 0.0

    def start(self) -> "_Capture":
        """Take the single-flight lock and start the profiler (a probe
        kernel inside the window when CUDA is initialized). Raises
        :class:`ProfilerBusy` when a capture is already running, and
        :class:`ProfilerUnavailable` for a CUDA capture off the main
        thread; the lock is released on any failure."""
        if not _capture_lock.acquire(blocking=False):
            raise ProfilerBusy("a profiler capture is already in flight")
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            self._cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            _check_thread(self._cuda)
            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.root, exist_ok=True)
            self._tmp = tempfile.mkdtemp(dir=self.root, prefix=".capture_")
            self._t0 = time.perf_counter()
            prof = profile(activities=activities)
            try:
                prof.start()
            except Exception as e:
                raise ProfilerBusy(
                    f"torch profiler would not start: {type(e).__name__}: {e}"
                )
            self._prof = prof
            if self._cuda:
                # one kernel of our own in the window: an idle card still
                # shows whether the device side recorded
                with record_function("profiling.capture.probe"):
                    torch.zeros(1, device="cuda").add_(1)
        except BaseException:
            self.abort()
            raise
        return self

    def abort(self) -> None:
        """Stop a started profiler without keeping its trace; releases the
        lock."""
        if self._prof is not None:
            with contextlib.suppress(Exception):
                self._prof.stop()
        self._cleanup()

    def _cleanup(self) -> None:
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None
        _capture_lock.release()

    def finish(self) -> dict:
        """Stop the profiler, export its Chrome trace and rename it into
        place; returns :func:`capture`'s payload. Releases the lock."""
        global _capture_seq
        from torch.autograd import DeviceType

        try:
            self._prof.stop()
            events = self._prof.events()
            device_events = sum(
                1 for e in events if e.device_type == DeviceType.CUDA)
            if self._cuda and device_events == 0:
                raise ProfilerUnavailable(
                    "the capture recorded no CUDA activity (is CUPTI "
                    "available?) — refusing a host-only trace"
                )
            self._prof.export_chrome_trace(os.path.join(self._tmp, "trace.json"))
            nbytes = _dir_bytes(self._tmp)
            if nbytes > self.max_bytes:
                raise ValueError(
                    f"capture is {nbytes} bytes, over the "
                    f"{self.max_bytes}-byte cap ({_ENV_PROFILE_MAX_BYTES}) — "
                    "deleted"
                )
            _capture_seq += 1  # under _capture_lock
            final = os.path.join(
                self.root, "capture_" + time.strftime("%Y%m%dT%H%M%S")
                + f"_{os.getpid()}_{_capture_seq:03d}"
            )
            os.replace(self._tmp, final)
            self._tmp = None
        finally:
            self._cleanup()
        elapsed = time.perf_counter() - self._t0
        telemetry.count("obs.profilez.captures")
        telemetry.observe("obs.profilez.capture_s", elapsed)
        telemetry.set_gauge("obs.profilez.bytes", nbytes)
        return {
            "ok": True,
            "path": final,
            "bytes": nbytes,
            "duration_s": round(self.duration_s, 3),
            "events": len(events),
            "device_events": device_events,
        }


def capture(
    duration_s: float = 1.0, log_dir: str | None = None
) -> dict:
    """Run one bounded ``torch.profiler`` capture; returns
    ``{"ok": True, "path", "bytes", "duration_s", "events",
    "device_events"}``.

    ``duration_s`` is clamped to ``TPU_SYNCBN_PROFILE_MAX_S`` (default
    5s). The capture is exported as a Chrome trace (``trace.json``,
    Perfetto) into a hidden temporary directory under ``log_dir`` (or
    ``TPU_SYNCBN_PROFILE_DIR``), renamed to ``capture_<stamp>`` only once
    complete — a reader never sees a half-written capture. A capture
    exceeding ``TPU_SYNCBN_PROFILE_MAX_BYTES`` is deleted and raises
    ``ValueError`` (the size cap is a promise, not a suggestion).

    In a process whose CUDA is initialized the capture records CUDA
    activity as well as the host's: a probe kernel is launched inside the
    window, and a capture holding no device event raises
    :class:`ProfilerUnavailable` instead of quietly keeping host events
    only. Kineto starts its CUDA side only on the thread that registered
    it (the process's main thread, which initializes CUDA): from another
    thread, a CUDA capture raises :class:`ProfilerUnavailable` at once
    rather than wedge in Kineto's init. Raises
    :class:`ProfilerUnavailable` with no directory configured,
    :class:`ProfilerBusy` when a capture or another profiler run is
    already running."""
    cap = _Capture(duration_s, log_dir).start()
    try:
        time.sleep(cap.duration_s)
    except BaseException:
        cap.abort()
        raise
    return cap.finish()


def _check_thread(cuda: bool) -> None:
    """Refuse a CUDA profiler run off the main thread: Kineto's CUDA init
    must run on the thread that registered its client, and from any other
    it errors and blocks."""
    if cuda and threading.current_thread() is not threading.main_thread():
        raise ProfilerUnavailable(
            "torch.profiler's CUDA side starts only on the thread that "
            "registered it (the main thread); capture from there"
        )


def _needs_main_thread() -> bool:
    """A capture from this thread would have to record CUDA off the main
    thread. Reads ``sys.modules`` instead of importing torch: a process
    that never imported it has no CUDA to record."""
    import sys

    if threading.current_thread() is threading.main_thread():
        return False
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_available()
                and torch.cuda.is_initialized())


# ---------------------------------------------------------------------------
# the /profilez hand-off to the main thread


#: How long past its duration a ``/profilez`` request handed to the main
#: thread may wait for a loop there to take it and finish it: the next
#: step boundary (a captured chunk is ~0.1 s; a first chunk that builds
#: its graph, seconds) plus the trace's export (seconds for tens of MB).
HANDOFF_GRACE_S = 10.0


class _Request:
    """One ``/profilez`` request waiting in the hand-off slot."""

    __slots__ = ("duration_s", "done", "state", "capture", "t_start", "code",
                 "payload")

    def __init__(self, duration_s: float):
        self.duration_s = duration_s
        self.done = threading.Event()
        self.state = "posted"  # -> "running" -> answered; or "abandoned"
        self.capture: _Capture | None = None
        self.t_start = 0.0
        self.code, self.payload = 503, {}


_slot_lock = threading.Lock()
_slot: _Request | None = None


def _answer(req: _Request, code: int, payload: dict) -> None:
    global _slot
    req.code, req.payload = code, payload
    with _slot_lock:
        if _slot is req:
            _slot = None
    req.done.set()


def _handoff(duration_s: float) -> tuple[int, dict]:
    """Post a capture of ``duration_s`` to the slot and wait at most
    ``duration_s`` + the grace for the main thread's loop to run it."""
    global _slot
    duration_s = min(max(0.0, float(duration_s)),
                     _env_float(_ENV_PROFILE_MAX_S, DEFAULT_PROFILE_MAX_S))
    bound = duration_s + HANDOFF_GRACE_S
    req = _Request(duration_s)
    with _slot_lock:
        if _slot is not None:
            return 503, {"ok": False,
                         "error": "a profiler capture is already waiting for "
                                  "the main thread"}
        _slot = req
    telemetry.count("obs.profilez.handoffs")
    if req.done.wait(bound):
        return req.code, req.payload
    with _slot_lock:
        if req.done.is_set():  # answered between the wait and the lock
            return req.code, req.payload
        taken = req.state != "posted"
        req.state = "abandoned"
        if not taken and _slot is req:
            _slot = None
    telemetry.count("obs.profilez.handoff_timeouts")
    if taken:
        error = (f"the capture the main thread started is still running "
                 f"{bound:g}s after the request; its trace will land under "
                 f"{configured_dir()} without an answer here")
    else:
        error = (f"no loop on the main thread took the capture within "
                 f"{bound:g}s (duration {duration_s:g}s + grace "
                 f"{bound - duration_s:g}s): torch.profiler's CUDA side "
                 "starts only on the thread that registered it (the main "
                 "thread), and this process's CUDA is initialized, so the "
                 "capture must run there — a ResilientLoop on the main "
                 "thread takes it at its step boundaries")
    return 503, {"ok": False, "error": error}


def service_profile_request() -> None:
    """Run the hand-off slot's capture on this thread — the loop calls
    this at every step or chunk boundary, on the main thread (elsewhere it
    returns at once): a posted request starts the profiler here, and the
    first boundary ``duration_s`` after the start stops it, exports the
    trace and answers the waiting request with :func:`capture`'s payload.
    A failure answers 503 (busy) or 500; nothing raises into the loop."""
    req = _slot
    if req is None or threading.current_thread() is not threading.main_thread():
        return
    if req.capture is None:
        with _slot_lock:
            if req.state != "posted":
                return
            req.state = "running"
        try:
            req.capture = _Capture(req.duration_s).start()
        except ProfilerBusy as e:
            _answer(req, 503, {"ok": False, "error": str(e)})
            return
        except Exception as e:
            _answer(req, 500, {"ok": False, "error": f"{type(e).__name__}: {e}"})
            return
        req.t_start = time.monotonic()
        return
    if time.monotonic() - req.t_start >= req.duration_s:
        finish_profile_request()


def finish_profile_request() -> None:
    """Close the hand-off's running capture now, whatever its duration
    (the loop calls this as it exits: the profiler does not outlive the
    loop that started it), and answer its request."""
    req = _slot
    if req is None or req.capture is None or req.done.is_set() \
            or threading.current_thread() is not threading.main_thread():
        return
    try:
        result = req.capture.finish()
    except ProfilerBusy as e:
        _answer(req, 503, {"ok": False, "error": str(e)})
    except Exception as e:
        _answer(req, 500, {"ok": False, "error": f"{type(e).__name__}: {e}"})
    else:
        _answer(req, 200, result)


def serve_capture(duration_s: float | None = None) -> tuple[int, dict]:
    """The ``POST /profilez`` body: ``(http_status, json_payload)``. 503
    without the env knob or while busy; 500 on a failed capture — the
    endpoint must answer, never raise into the server loop.

    Off the main thread of a process whose CUDA is initialized (the HTTP
    handler's thread in a training process) the capture cannot run here
    (Kineto's thread rule), so it is handed to the main thread: the
    request waits in a one-request slot that ``ResilientLoop.run``
    services at its step boundaries (:func:`service_profile_request`), and
    this call returns the capture's answer, or 503 naming the rule once
    ``duration_s`` plus :data:`HANDOFF_GRACE_S` has passed with no loop to
    take it. Elsewhere the capture runs on the calling thread."""
    if configured_dir() is None:
        return 503, {
            "ok": False,
            "error": f"profiling disabled — set {_ENV_PROFILE_DIR}",
        }
    duration_s = 1.0 if duration_s is None else duration_s
    if _needs_main_thread():
        return _handoff(duration_s)
    try:
        result = capture(duration_s)
    except ProfilerBusy as e:
        return 503, {"ok": False, "error": str(e)}
    except Exception as e:
        return 500, {"ok": False,
                     "error": f"{type(e).__name__}: {e}"}
    return 200, result


@contextlib.contextmanager
def profiler_trace(log_dir: str, *, enabled: bool = True):
    """``torch.profiler`` trace around a code region, written as a Chrome
    trace (Perfetto, TensorBoard's profiler plugin) to
    ``log_dir/trace_h<rank>_<pid>.json``. Master host only; no-op when
    disabled. The library (with-block) form of :func:`capture`, sharing
    its single-flight lock (a concurrent capture raises
    :class:`ProfilerBusy`) and its main-thread rule for CUDA; the
    historical ``utils.metrics.profiler_trace`` deprecates into this.
    Records CUDA activity when CUDA is initialized when the region
    starts."""
    from tpu_syncbn_torch.runtime import distributed as dist

    if not enabled or not dist.is_master():
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already in flight")
    try:
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        _check_thread(cuda)
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_h{telemetry._host_index()}_{os.getpid()}.json"))
    finally:
        _capture_lock.release()


# ---------------------------------------------------------------------------
# the audit's allocator reading


@contextlib.contextmanager
def allocation_peak(device=None):
    """The most the allocator held, over the block, above what it held
    when the block began: a dict whose ``"bytes"`` is set at exit, and
    ``"source"``. On a CUDA ``device`` it is ``max_memory_allocated()``
    after ``reset_peak_memory_stats()``, minus ``memory_allocated()``
    before (the caching allocator's counters; the peak statistics are
    reset). On the CPU it is the CPU allocator's allocation and free
    events of a ``torch.profiler`` window with ``profile_memory=True``,
    summed in their order (a free of a tensor made before the block
    lowers the sum): the window shares :func:`capture`'s single-flight
    lock (:class:`ProfilerBusy`)."""
    import torch

    dev = torch.device(device if device is not None else "cpu")
    reading: dict = {"bytes": None, "source": None}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        yield reading
        reading.update(bytes=int(torch.cuda.max_memory_allocated(dev) - before),
                       source="cuda_caching_allocator")
        return
    from torch._C._profiler import _EventType
    from torch.profiler import ProfilerActivity, profile

    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already in flight")
    try:
        with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
            yield reading
        events = []
        stack = list(prof.profiler.kineto_results.experimental_event_tree())
        while stack:
            node = stack.pop()
            stack.extend(node.children)
            f = node.extra_fields
            if node.tag == _EventType.Allocation and f.device.type == "cpu":
                events.append((node.start_time_ns, f.alloc_size, f.ptr))
        # frees of blocks made before the window are not the block's: the
        # window's own allocations, held at once
        live: dict = {}
        held = most = 0
        for _, size, ptr in sorted(events):
            if size > 0:
                live[ptr] = size
            elif ptr not in live:
                continue
            else:
                size = -live.pop(ptr)
            held += size
            most = max(most, held)
        reading.update(bytes=int(most), source="cpu_profiler")
    finally:
        _capture_lock.release()
