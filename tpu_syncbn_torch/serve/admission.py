"""Overload-aware admission: deadlines, EDF dispatch, load shedding,
and circuit breaking for the serving stack — the counterpart of
``tpu_syncbn.serve.admission``, kept as a copy (it uses no framework).

``bench --serve``'s closed-loop sweep can never push the batcher
past saturation — each client waits for its answer before sending the
next request, so offered load self-limits. Real traffic is *open-loop*:
arrivals do not care how backed up the server is, and past the
saturation point a FIFO queue grows without bound, every queued request
eventually times out client-side, and the engine spends 100% of its
time computing answers nobody is still waiting for — queueing collapse.
This module is the robustness layer that keeps the engine's work *good*
under overload:

* **deadlines** — every request carries an absolute completion deadline
  (``time.monotonic`` based; assigned from the batcher's
  ``deadline_ms`` default or per-request);
* **earliest-deadline-first dispatch** — :class:`AdmissionController`
  is a deadline-ordered priority queue, so the collector always works
  on the request that will expire soonest (under load, FIFO order and
  EDF order diverge exactly when it matters);
* **shedding before dead work** — at dispatch time, a request whose
  *predicted* completion (:class:`LatencyEstimator`: the rolling
  ``serve.infer_s`` estimate from a
  :class:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator` when telemetry
  feeds one, an EWMA of observed engine calls otherwise) already misses
  its deadline is failed immediately (:class:`DeadlineExceededError`)
  instead of being padded into a program — the engine's cycles go to
  requests that can still be answered in time (goodput, not
  throughput);
* **circuit breaking** — :class:`CircuitBreaker`: N *consecutive*
  engine failures open the circuit (submits fast-fail with a
  retry-after, :class:`CircuitOpenError`), the resilience layer's deterministic-
  jitter backoff (:func:`tpu_syncbn_torch.runtime.resilience.backoff_delays`)
  schedules half-open probes, and one successful probe batch closes it
  again. Circuit state feeds the batcher's ``/readyz`` hook and the
  ``serve.circuit_state`` gauge (0 closed / 1 half-open / 2 open).

Telemetry (docs/OBSERVABILITY.md): ``serve.shed`` counter (requests
failed by the shed/deadline path), ``serve.deadline_miss_total``
counter (sheds + answers that landed past their deadline), and the
``serve.circuit_state`` gauge. The degradation paths are proven by
injection — ``testing.faults.slow_engine`` / ``crash_engine_at_batch``
/ ``poison_request`` drive them in tests/test_torch_serve_chaos.py, the same
way the training recovery paths are proven.
"""

from __future__ import annotations

import heapq
import queue
import re
import threading
import time
from typing import Callable

from tpu_syncbn_torch.obs import telemetry

__all__ = [
    "RejectedError",
    "DeadlineExceededError",
    "CircuitOpenError",
    "LatencyEstimator",
    "AdmissionController",
    "CircuitBreaker",
]


class RejectedError(RuntimeError):
    """The batcher refused a request: queue full (backpressure), the
    batcher is draining/closed, or an overload policy shed it. Clients
    should retry elsewhere. ``retry_after_s`` (when not ``None``) is
    the server's backoff hint."""

    def __init__(self, message: str, *, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(RejectedError):
    """The request's deadline passed (or its predicted completion
    already misses it) — shed instead of computed."""


class CircuitOpenError(RejectedError):
    """The engine circuit is open after consecutive failures — the
    request is fast-failed without queueing. ``retry_after_s`` is the
    remaining backoff before the next half-open probe window."""


# ---------------------------------------------------------------------------
# rolling engine-latency estimate


class LatencyEstimator:
    """Predicted engine-call duration for shed decisions.

    Two sources, in preference order:

    1. the rolling windowed quantile of ``metric`` (default
       ``serve.infer_s``) from a
       :class:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator` — the
       live estimate a monitored process already maintains (requires
       the telemetry gate on, since the aggregator samples the
       registry);
    2. an EWMA of durations fed directly via :meth:`observe` (the
       batcher reports every engine call) — always available, telemetry
       gate or not.

    With *no* evidence yet, :meth:`predict` returns ``None`` and the
    admission controller sheds nothing: an overload policy must act on
    measurements, never on a cold guess."""

    def __init__(
        self,
        aggregator=None,
        *,
        metric: str = "serve.infer_s",
        quantile: float = 0.9,
        window_s: float = 30.0,
        alpha: float = 0.3,
    ):
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self._agg = aggregator
        self.metric = metric
        self.quantile = quantile
        self.window_s = float(window_s)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma: float | None = None

    def observe(self, seconds: float) -> None:
        """Feed one observed engine-call duration into the EWMA."""
        s = float(seconds)
        if s < 0:
            return
        with self._lock:
            self._ewma = s if self._ewma is None else (
                self.alpha * s + (1.0 - self.alpha) * self._ewma
            )

    def predict(self) -> float | None:
        """The current per-call duration estimate in seconds, or
        ``None`` before any evidence exists."""
        if self._agg is not None:
            try:
                q = self._agg.quantile(self.metric, self.quantile,
                                       self.window_s)
            except Exception:
                q = None
            if q is not None:
                return float(q)
        with self._lock:
            return self._ewma


# ---------------------------------------------------------------------------
# deadline-ordered admission queue


class AdmissionController:
    """Bounded deadline-priority request queue with dispatch-time
    shedding — the drop-in replacement for the batcher's FIFO
    ``queue.Queue`` (same ``put_nowait`` / ``get`` / ``get_nowait`` /
    ``qsize`` / ``empty`` / ``maxsize`` surface, so the collector loop
    is policy-agnostic).

    Ordering: earliest absolute deadline first; deadline-less requests
    sort after every deadlined one, FIFO among themselves (an admission
    sequence number breaks ties, so the no-deadline configuration is
    *exactly* the old FIFO batcher).

    Shedding happens in :meth:`get`/:meth:`get_nowait`, at the moment a
    request would enter a batch: if its deadline has already passed, or
    ``now + estimator.predict()`` lands past it, the request is handed
    to ``on_shed`` (the batcher fails its future with
    :class:`DeadlineExceededError` and counts ``serve.shed``) and the
    pop moves on — the engine never computes a dead answer. With no
    estimator evidence only already-expired requests are shed.

    ``now`` is injectable for deterministic fault tests."""

    def __init__(
        self,
        *,
        max_queue: int,
        estimator: LatencyEstimator | None = None,
        on_shed: Callable[[object], None] | None = None,
        now: Callable[[], float] = time.monotonic,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.maxsize = int(max_queue)
        self.estimator = estimator
        self.on_shed = on_shed
        self._now = now
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._heap: list = []  # (deadline or +inf, seq, request)
        self._seq = 0

    # -- queue surface (matches queue.Queue where the batcher uses it) ----

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)

    def empty(self) -> bool:
        return self.qsize() == 0

    def put_nowait(self, req) -> None:
        """Admit ``req`` (anything with an optional ``deadline``
        attribute). Raises ``queue.Full`` at capacity — backpressure
        stays the batcher's concern."""
        deadline = getattr(req, "deadline", None)
        key = float("inf") if deadline is None else float(deadline)
        with self._not_empty:
            if len(self._heap) >= self.maxsize:
                raise queue.Full
            heapq.heappush(self._heap, (key, self._seq, req))
            self._seq += 1
            self._not_empty.notify()

    def _predict(self) -> float | None:
        """One estimator read per pop pass — computed by the callers
        *outside* the queue lock (a windowed-quantile merge per shed,
        serialized against every submitter, would slow admission down
        exactly at saturation)."""
        return self.estimator.predict() if self.estimator is not None else None

    def _pop_viable_locked(self, shed: list, predicted: float | None):
        """Earliest-deadline request that can still make its deadline;
        doomed ones land in ``shed`` (the caller fires ``on_shed``
        *outside* the lock — shedding resolves client futures, whose
        done-callbacks must never run under the queue lock). ``None``
        when the heap empties."""
        while self._heap:
            _, _, req = heapq.heappop(self._heap)
            deadline = getattr(req, "deadline", None)
            if deadline is None:
                return req
            t = self._now()
            eta = t if predicted is None else t + predicted
            if eta > deadline:
                shed.append(req)
                continue
            return req
        return None

    def _fire_sheds(self, shed: list) -> None:
        if self.on_shed is None:
            return
        for req in shed:
            self.on_shed(req)

    def get_nowait(self):
        shed: list = []
        predicted = self._predict()
        with self._not_empty:
            req = self._pop_viable_locked(shed, predicted)
        self._fire_sheds(shed)
        if req is None:
            raise queue.Empty
        return req

    def get(self, timeout: float | None = None):
        end = None if timeout is None else self._now() + float(timeout)
        while True:
            shed: list = []
            timed_out = False
            predicted = self._predict()
            with self._not_empty:
                req = self._pop_viable_locked(shed, predicted)
                if req is None:
                    remaining = None if end is None else end - self._now()
                    if remaining is not None and remaining <= 0:
                        timed_out = True
                    else:
                        timed_out = not self._not_empty.wait(remaining)
            self._fire_sheds(shed)
            if req is not None:
                return req
            if timed_out:
                raise queue.Empty


# ---------------------------------------------------------------------------
# circuit breaker


class CircuitBreaker:
    """Consecutive-failure circuit breaker with deterministic-jitter
    backoff (the resilience layer's :func:`~tpu_syncbn_torch.runtime.resilience.backoff_delays`
    — reproducible under the fault harness, de-synchronized across
    hosts by ``key``).

    States: ``closed`` (normal; failures counted), ``open`` (submits
    fast-fail with retry-after until the backoff expires), ``half_open``
    (up to ``probe_limit`` submits — one probe batch's worth — admitted
    until the probe's outcome lands, everything beyond keeps
    fast-failing; success closes, failure re-opens with the next,
    longer backoff). Repeated open→probe→fail cycles walk up the
    backoff schedule; a success resets it.

    State changes publish a circuit-state gauge (0 closed / 1 half-open
    / 2 open): ``serve.circuit_state`` for the default/``serve`` key,
    ``serve.circuit_state.<key>`` otherwise — keyed like the
    ``/healthz`` heartbeats, so two batchers in one process (each with
    its own breaker key) can never mask each other's state. Thread-safe;
    ``now`` injectable for deterministic tests."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    _CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        backoff_steps: int = 8,
        probe_limit: int = 8,
        key: str = "",
        now: Callable[[], float] = time.monotonic,
    ):
        from tpu_syncbn_torch.runtime.resilience import backoff_delays

        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.failure_threshold = int(failure_threshold)
        # backoff_delays(n) yields n-1 sleeps; +1 so backoff_steps is
        # the number of distinct open->probe delays before saturating
        self._delays = backoff_delays(
            int(backoff_steps) + 1, base_s=backoff_base_s,
            max_s=backoff_max_s, key=key or "serve-circuit",
        )
        if not self._delays:
            raise ValueError(f"backoff_steps must be >= 1, got {backoff_steps}")
        if probe_limit < 1:
            raise ValueError(f"probe_limit must be >= 1, got {probe_limit}")
        self.probe_limit = int(probe_limit)
        token = re.sub(r"[^a-z0-9_]", "_", key.lower())
        if token in ("", "serve"):
            # the default breaker keeps the plain process-wide gauge
            self._labels = None
            self.gauge_name = "serve.circuit_state"
        else:
            # non-default breakers publish the labeled family; the old
            # flat dotted-suffix name mirrors behind a DeprecationWarning
            self._labels = {"family": token}
            self.gauge_name = telemetry.labeled_name(
                "serve.circuit_state", self._labels
            )
            self._legacy_gauge_name = f"serve.circuit_state.{token}"
        self._now = now
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._open_streak = 0  # opens since the last success
        self._opened_at: float | None = None
        self._retry_after: float = 0.0
        self._probes_admitted = 0  # submits let through while half-open
        self.open_count = 0  # lifetime opens (stats)
        self._publish()

    def _publish(self) -> None:
        code = self._CODES[self._state]
        if self._labels is None:
            telemetry.set_gauge(self.gauge_name, code)
        else:
            telemetry.set_gauge("serve.circuit_state", code,
                                labels=self._labels)
            telemetry.warn_deprecated_name(
                self._legacy_gauge_name, self.gauge_name
            )
            telemetry.set_gauge(self._legacy_gauge_name, code)
        # breaker transitions land in the flight recorder's serve ring
        # (no-op without a recorder; record_serve only takes the
        # recorder's own ring lock — no cross-lock cycle with ours)
        from tpu_syncbn_torch.obs import flightrec

        flightrec.record_serve("circuit_state", state=self._state,
                               breaker=self.gauge_name)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    @property
    def state_code(self) -> int:
        return self._CODES[self.state]

    def _maybe_half_open_locked(self) -> None:
        if self._state == self.OPEN and \
                self._now() - self._opened_at >= self._retry_after:
            self._state = self.HALF_OPEN
            self._probes_admitted = 0
            self._publish()

    def retry_after_s(self) -> float:
        """Seconds until the next half-open probe window (0 when the
        circuit is not open)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0,
                       self._retry_after - (self._now() - self._opened_at))

    def allow(self) -> tuple[bool, float]:
        """Admission verdict: ``(admit, retry_after_s)``. Open circuit
        with backoff remaining → ``(False, remaining)``; an expired
        backoff transitions to half-open and admits up to
        ``probe_limit`` submits (one probe batch's worth) until the
        probe's outcome lands — everything beyond the quota keeps
        fast-failing rather than queueing behind a still-suspect
        engine."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.OPEN:
                remaining = max(
                    0.0,
                    self._retry_after - (self._now() - self._opened_at),
                )
                return False, remaining
            if self._state == self.HALF_OPEN:
                if self._probes_admitted >= self.probe_limit:
                    # quota spent, probe outcome pending: the hint is
                    # the backoff a failed probe would impose
                    idx = min(self._open_streak, len(self._delays) - 1)
                    return False, self._delays[idx]
                self._probes_admitted += 1
            return True, 0.0

    def record_success(self) -> None:
        """One engine call succeeded: half-open probe success closes
        the circuit; any success resets the failure count and the
        backoff schedule."""
        with self._lock:
            changed = self._state != self.CLOSED
            self._state = self.CLOSED
            self._consecutive = 0
            self._open_streak = 0
            self._opened_at = None
            self._probes_admitted = 0
            if changed:
                self._publish()

    def record_failure(self) -> bool:
        """One engine call failed. Returns True when this failure
        opened (or re-opened) the circuit."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.HALF_OPEN:
                # failed probe: straight back to open, longer backoff
                opened = True
            else:
                self._consecutive += 1
                opened = (self._state == self.CLOSED
                          and self._consecutive >= self.failure_threshold)
            if opened:
                self._state = self.OPEN
                self._opened_at = self._now()
                idx = min(self._open_streak, len(self._delays) - 1)
                self._retry_after = self._delays[idx]
                self._open_streak += 1
                self.open_count += 1
                self._consecutive = 0
                self._publish()
            retry_after = self._retry_after
        if opened:
            # incident capture OUTSIDE the breaker lock: the dump reads
            # readiness hooks, which read this breaker's stats() — a
            # trigger under self._lock would deadlock on itself
            from tpu_syncbn_torch.obs import flightrec

            flightrec.trigger("circuit_open", {
                "breaker": self.gauge_name,
                "open_count": self.open_count,
                "retry_after_s": round(retry_after, 4),
            })
        return opened

    def stats(self) -> dict:
        """JSON-ready breaker state for readiness detail blocks."""
        with self._lock:
            self._maybe_half_open_locked()
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "open_count": self.open_count,
                "retry_after_s": round(max(
                    0.0,
                    (self._retry_after - (self._now() - self._opened_at))
                    if self._state == self.OPEN else 0.0,
                ), 4),
            }
