"""Dynamic request batching: queueing, admission, backpressure, drain —
the counterpart of ``tpu_syncbn.serve.batcher``.

The engine (:mod:`tpu_syncbn_torch.serve.engine`) executes *batches*; real
traffic arrives as small independent requests. :class:`DynamicBatcher`
sits between them — the reference recipe has no serving story at all, so
this is the standard dynamic-batching design (bounded queue + a single
collector thread) rebuilt on this codebase's seams:

* **admission policy** — a batch dispatches when it reaches
  ``max_batch`` items OR its oldest request has waited ``max_wait_ms``,
  whichever comes first: full batches under load (throughput), bounded
  queueing delay when idle (latency);
* **backpressure** — the request queue is bounded (``max_queue``); a
  full queue *rejects* the submit (:class:`RejectedError`) instead of
  growing latency without bound — load shedding at the edge, where the
  client can retry against another replica;
* **deadlines + shedding** — with ``deadline_ms`` set (or per-request
  via ``submit(..., deadline_ms=)``) the queue becomes
  earliest-deadline-first (:class:`~tpu_syncbn_torch.serve.admission.
  AdmissionController`), and requests whose predicted completion
  already misses their deadline are shed
  (:class:`~tpu_syncbn_torch.serve.admission.DeadlineExceededError`,
  ``serve.shed`` / ``serve.deadline_miss_total``) before the engine
  does dead work — bounded p99 past saturation instead of queueing
  collapse;
* **circuit breaking** — consecutive engine failures open a
  :class:`~tpu_syncbn_torch.serve.admission.CircuitBreaker`: submits
  fast-fail with a retry-after hint, the resilience layer's
  deterministic-jitter backoff schedules half-open probes, circuit state feeds ``/readyz``
  and the ``serve.circuit_state`` gauge;
* **graceful drain** — wired to the resilience layer's preemption
  contract: give the batcher a
  :class:`~tpu_syncbn_torch.runtime.resilience.PreemptionGuard`
  (anything with a truthy ``preempted`` property works) and the first
  SIGTERM flips it into drain mode — new submits are rejected, every
  already-admitted request is answered, then the worker exits. The same
  drain runs on ``close(drain=True)``.

Coalesced requests are concatenated along the batch axis, padded to a
bucket by the engine, and each caller's slice is handed back through its
``concurrent.futures.Future``. The engine is only ever called from the
single collector thread, so a batcher never dispatches concurrently.

Observability (docs/OBSERVABILITY.md): ``serve.latency_s``
enqueue→response histogram, ``serve.queue_depth`` gauge,
``serve.batch_fill_ratio`` histogram, a ``serve.batch`` trace span per
executed batch, and a ``CounterGroup`` (prefix ``serve``) whose counts —
``requests`` / ``rejected`` / ``batches`` / ``items`` / ``slots`` /
``errors`` — always accumulate locally and mirror into the process
registry when telemetry is enabled.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np

from tpu_syncbn_torch.obs import flightrec
from tpu_syncbn_torch.obs import server as obs_server
from tpu_syncbn_torch.obs import stepstats as obs_stepstats
from tpu_syncbn_torch.obs import telemetry
from tpu_syncbn_torch.obs.tracing import get as active_tracer
from tpu_syncbn_torch.runtime import distributed as dist
from tpu_syncbn_torch.serve.admission import (  # noqa: F401  (re-exported API)
    AdmissionController,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    LatencyEstimator,
    RejectedError,
)
from tpu_syncbn_torch.serve.engine import _leading_dim, tree_map

__all__ = ["DynamicBatcher", "RejectedError", "DeadlineExceededError",
           "CircuitOpenError"]

#: Fill-ratio histogram boundaries (a ratio in (0, 1], not a duration).
FILL_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


#: Process-unique request ids — the Perfetto flow ids linking each
#: request's enqueue span to the batch span that answered it.
_request_ids = itertools.count(1)


class _Request:
    __slots__ = ("payload", "n", "future", "t0", "deadline", "rid")

    def __init__(self, payload, n: int, deadline: float | None = None):
        self.payload = payload
        self.n = n
        self.future: Future = Future()
        self.t0 = time.perf_counter()
        #: absolute completion deadline on time.monotonic, or None
        self.deadline = deadline
        self.rid = next(_request_ids)


class DynamicBatcher:
    """Coalesce single requests into engine batches.

    ``engine`` needs ``bucket_for(n)``, ``max_bucket``, and
    ``predict(batch) -> host outputs`` (duck-typed; tests drive the
    queueing logic with a stub). ``max_batch`` defaults to the engine's
    largest bucket and may not exceed it — an admitted batch must always
    fit one program. ``guard`` is the preemption hook (see module
    docstring).

    ``submit(item)`` takes a host batch (a numpy array, or a dict,
    tuple or list of them) with a leading axis of
    ``n >= 1`` (a single example is ``x[i:i+1]``) and returns a
    ``Future`` resolving to that request's output slice.

    Overload policy knobs (docs/RESILIENCE.md "Serving failure modes"):

    * ``deadline_ms`` — default completion deadline per request
      (``submit(..., deadline_ms=)`` overrides per call; ``None``
      disables deadlines entirely, which is exactly the historical FIFO
      batcher). Deadlined requests dispatch earliest-deadline-first and
      are shed once their predicted completion misses the deadline.
    * ``estimator`` — the :class:`~tpu_syncbn_torch.serve.admission.
      LatencyEstimator` feeding shed decisions; by default one is built
      that EWMAs this batcher's own observed engine calls (hand it one
      wrapping a :class:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator`
      to use the rolling windowed ``serve.infer_s`` quantile instead).
    * ``breaker`` — the engine :class:`~tpu_syncbn_torch.serve.admission.
      CircuitBreaker`; default-constructed (5 consecutive failures
      open). Pass a configured instance, or ``False`` to disable.
    * ``tenant`` — optional tenant name: traffic series (``requests`` /
      ``rejected`` / ``shed`` / ``deadline_miss_total`` counters, the
      ``serve.latency_s`` histogram, the ``serve.queue_depth`` gauge)
      additionally publish ``{tenant="..."}``-labeled twins, and serve-
      ring entries carry the tenant — the per-tenant SLO substrate
      (docs/OBSERVABILITY.md "Labels & cardinality").
    """

    def __init__(
        self,
        engine,
        *,
        max_batch: int | None = None,
        max_wait_ms: float = 5.0,
        max_queue: int = 64,
        guard: Any = None,
        ready_depth: int | None = None,
        health_name: str = "serve",
        deadline_ms: float | None = None,
        estimator: LatencyEstimator | None = None,
        breaker: CircuitBreaker | bool | None = None,
        tenant: str | None = None,
    ):
        if max_batch is None:
            max_batch = int(engine.max_bucket)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_batch > engine.max_bucket:
            raise ValueError(
                f"max_batch={max_batch} exceeds the engine's largest "
                f"bucket {engine.max_bucket} — a full batch must fit one "
                "compiled program"
            )
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        self._engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._guard = guard
        #: optional ``tenant`` label: when set, this batcher publishes
        #: labeled twins of its serve.* traffic series alongside the
        #: unlabeled process-wide ones, so two tenants sharing one mesh
        #: get separately addressable rates/quantiles/burn rates
        self.tenant = tenant
        self._tenant_labels = {"tenant": tenant} if tenant else None
        #: tenant attribution for flight-recorder serve-ring entries
        self._detail = {"tenant": tenant} if tenant else {}
        self.default_deadline_ms = deadline_ms
        self.estimator = (estimator if estimator is not None
                          else LatencyEstimator())
        if breaker is None:
            breaker = CircuitBreaker(key=health_name)
        self._breaker: CircuitBreaker | None = breaker or None
        self._q = AdmissionController(
            max_queue=max_queue, estimator=self.estimator,
            on_shed=self._shed,
        )
        self._closing = False
        self._drain_on_close = True
        self._stopped = threading.Event()
        #: always-on local counts; mirrored into the registry as
        #: ``serve.*`` when telemetry is enabled (obs.CounterGroup)
        self.counters = telemetry.CounterGroup(prefix="serve")
        self._log = dist.get_logger("tpu_syncbn_torch.serve")
        # live monitoring (docs/OBSERVABILITY.md "Live monitoring"):
        # with TPU_SYNCBN_METRICS_PORT set this process answers
        # /metrics + /healthz (collector heartbeat) + /readyz (the
        # ``health_name`` hook below — give each batcher in a
        # multi-model process a distinct name: registration replaces,
        # and close() clears, whatever holds that name).
        # ready_depth defaults to 90% of
        # the queue bound: readiness must flip BEFORE the queue-full
        # rejection path starts shedding, so a balancer routes away
        # while there is still headroom.
        if ready_depth is None:
            ready_depth = max(1, (9 * max_queue) // 10)
        if not 1 <= ready_depth <= max_queue:
            raise ValueError(
                f"ready_depth must be in [1, max_queue={max_queue}], "
                f"got {ready_depth}"
            )
        self.ready_depth = int(ready_depth)
        self._health_name = str(health_name)
        obs_server.start_from_env()
        # flight recorder (docs/OBSERVABILITY.md "Incidents"): serve
        # decisions (sheds, rejections, deadline misses, breaker
        # transitions) ring-buffer into it; a circuit open dumps a
        # bundle. TPU_SYNCBN_FLIGHTREC is the whole knob.
        flightrec.install_from_env()
        # memory watermarks (docs/OBSERVABILITY.md "Memory & compile"):
        # TPU_SYNCBN_MEMWATCH arms the background sampler — bucket churn
        # evicting programs and a tenant walking toward OOM both become
        # visible (and incident-triggering) without code changes
        from tpu_syncbn_torch.obs import memwatch

        memwatch.install_from_env()
        obs_server.register_readiness(self._health_name, self.readiness)
        self._thread = threading.Thread(
            target=self._run, name="dynamic-batcher", daemon=True
        )
        self._thread.start()

    # -- accessors ---------------------------------------------------------
    # public views for the publication path (a swap controller pulls the
    # breaker as its post-swap health signal and the guard as its drain
    # signal, and swaps versions on the engine underneath a running
    # batcher)

    @property
    def engine(self):
        """The engine this batcher feeds."""
        return self._engine

    @property
    def breaker(self) -> "CircuitBreaker | None":
        """The admission circuit breaker (None when disabled)."""
        return self._breaker

    @property
    def guard(self):
        """The preemption guard wired at construction (or None)."""
        return self._guard

    # -- admission ---------------------------------------------------------

    @property
    def draining(self) -> bool:
        """True once a preemption signal or close() stopped admission."""
        return self._closing or (
            self._guard is not None and bool(self._guard.preempted)
        )

    @property
    def drained(self) -> bool:
        """True once the worker has answered everything and exited."""
        return self._stopped.is_set() and self._q.empty()

    @property
    def fill_ratio(self) -> float | None:
        """Aggregate batch-fill ratio so far: admitted items over padded
        program slots (1.0 = every program ran completely full)."""
        slots = self.counters.count("slots")
        if not slots:
            return None
        return self.counters.count("items") / slots

    def readiness(self) -> tuple[bool, dict]:
        """The batcher's ``/readyz`` contribution (registered as the
        ``health_name`` hook, default ``serve``): ready while admission
        is open (not draining/closed), the queue depth is below
        ``ready_depth`` — overload flips the probe before backpressure
        has to reject — AND the engine circuit is not open (a broken
        engine flips the probe before clients pay fast-rejections;
        half-open reads ready again, since probe traffic has to come
        from somewhere). The detail block carries the live queue +
        circuit state plus the engine's health summary when it offers
        one."""
        depth = self._q.qsize()
        draining = self.draining
        circuit_open = (self._breaker is not None
                        and self._breaker.state == CircuitBreaker.OPEN)
        ok = not draining and not self._stopped.is_set() \
            and depth < self.ready_depth and not circuit_open
        detail = {
            "queue_depth": depth,
            "ready_depth": self.ready_depth,
            "max_queue": self._q.maxsize,
            "draining": draining,
        }
        if self._breaker is not None:
            detail["circuit"] = self._breaker.stats()
        engine_health = getattr(self._engine, "health", None)
        if callable(engine_health):
            try:
                detail["engine"] = engine_health()
            except Exception as e:  # detail, never the verdict
                detail["engine"] = {"error": f"{type(e).__name__}: {e}"}
        return ok, detail

    def _shed(self, req: _Request) -> None:
        """Fail one deadline-doomed request (the admission controller's
        ``on_shed``): the engine never sees it — shedding dead work is
        the point. Counts ``serve.shed`` and ``serve.deadline_miss_total``."""
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(DeadlineExceededError(
                "shed: predicted completion misses the request deadline"
            ))
        self.counters.bump("shed", labels=self._tenant_labels)
        self.counters.bump("deadline_miss_total",
                           labels=self._tenant_labels)
        flightrec.record_serve("shed", rid=req.rid, n=req.n,
                               **self._detail)

    def submit(self, item, *, deadline_ms: float | None = None) -> Future:
        """Enqueue one request; returns its ``Future``. Raises
        :class:`RejectedError` on backpressure (queue full), once the
        batcher is draining/closed, or — fast, without queueing — while
        the engine circuit is open (:class:`CircuitOpenError`, with a
        ``retry_after_s`` hint). ``deadline_ms`` overrides the
        batcher's default completion deadline for this request."""
        n = _leading(item)
        if n > self.max_batch:
            raise RejectedError(
                f"request of {n} items exceeds max_batch={self.max_batch}; "
                "split it or call the engine directly"
            )
        if self.draining or self._stopped.is_set():
            self.counters.bump("rejected", labels=self._tenant_labels)
            flightrec.record_serve("rejected", reason="draining", n=n,
                                   **self._detail)
            raise RejectedError("batcher is draining — not admitting")
        if self._breaker is not None:
            admit, retry_after = self._breaker.allow()
            if not admit:
                self.counters.bump("rejected",
                                   labels=self._tenant_labels)
                flightrec.record_serve("rejected", reason="circuit_open",
                                       n=n, **self._detail)
                raise CircuitOpenError(
                    "engine circuit open after consecutive failures — "
                    f"retry in {retry_after:.2f}s",
                    retry_after_s=retry_after,
                )
        dl_ms = (deadline_ms if deadline_ms is not None
                 else self.default_deadline_ms)
        if dl_ms is not None and dl_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {dl_ms}")
        deadline = (None if dl_ms is None
                    else time.monotonic() + float(dl_ms) / 1e3)
        req = _Request(item, n, deadline)
        tracer = active_tracer()
        if tracer is not None:
            # flow start: Perfetto draws an arrow from this enqueue
            # span to the serve.batch span that answers the request
            # (flow id = request id), making batching latency visually
            # attributable in any trace of this process
            with tracer.span("serve.enqueue", rid=req.rid, n=n):
                tracer.flow_start("serve.request", req.rid)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.counters.bump("rejected", labels=self._tenant_labels)
            flightrec.record_serve("rejected", reason="queue_full", n=n,
                                   **self._detail)
            raise RejectedError(
                f"request queue full ({self._q.maxsize}) — shed load"
            ) from None
        if self._stopped.is_set():
            # the worker can drain-and-exit between the admission check
            # above and the put landing — nothing may rot in a dead
            # queue, so fail whatever is still in it (possibly our own
            # request; a result already set by the worker wins)
            self._reject_dead_queue()
            if req.future.done() and req.future.exception() is not None:
                self.counters.bump("rejected", labels=self._tenant_labels)
                raise RejectedError("batcher is draining — not admitting")
        self.counters.bump("requests", labels=self._tenant_labels)
        telemetry.set_gauge("serve.queue_depth", self._q.qsize())
        if self._tenant_labels is not None:
            telemetry.set_gauge("serve.queue_depth", self._q.qsize(),
                                labels=self._tenant_labels)
        return req.future

    def _reject_dead_queue(self) -> None:
        """The worker has exited; answer anything still queued with the
        drain rejection so no Future blocks forever."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(
                    RejectedError("batcher is draining — not admitting")
                )

    # -- collector ---------------------------------------------------------

    def _run(self) -> None:
        carry: _Request | None = None
        try:
            while True:
                # collector liveness: a wedged engine call stops this
                # beat, and /healthz goes stale — the "stuck mid-batch"
                # signal a balancer can act on. Keyed by health_name so
                # two batchers in one process (give the second a
                # distinct name) cannot mask each other's stall.
                obs_server.HEARTBEATS.beat(self._health_name)
                if carry is not None:
                    first, carry = carry, None
                else:
                    try:
                        first = self._q.get(timeout=0.01)
                    except queue.Empty:
                        if self.draining:
                            break
                        continue
                if self._closing and not self._drain_on_close:
                    if first.future.set_running_or_notify_cancel():
                        first.future.set_exception(
                            RejectedError("batcher closed without drain")
                        )
                    continue
                if self._breaker is not None:
                    admit, retry_after = self._breaker.allow()
                    if not admit:
                        # open circuit: already-queued work fast-fails
                        # too — dispatching it into a known-broken
                        # engine would only delay the client's retry
                        self.counters.bump("rejected",
                                           labels=self._tenant_labels)
                        if first.future.set_running_or_notify_cancel():
                            first.future.set_exception(CircuitOpenError(
                                "engine circuit open — retry in "
                                f"{retry_after:.2f}s",
                                retry_after_s=retry_after,
                            ))
                        continue
                reqs, n = [first], first.n
                deadline = first.t0 + self.max_wait_s
                while n < self.max_batch:
                    wait = (0.0 if self.draining
                            else deadline - time.perf_counter())
                    try:
                        r = (self._q.get(timeout=wait) if wait > 0
                             else self._q.get_nowait())
                    except queue.Empty:
                        break
                    if n + r.n > self.max_batch:
                        carry = r  # opens the next batch
                        break
                    reqs.append(r)
                    n += r.n
                self._execute(reqs)
        finally:
            self._stopped.set()

    def _execute(self, reqs: list[_Request]) -> None:
        # claim every request (RUNNING) before touching payloads: a
        # client that cancelled while queued is silently dropped, and a
        # claimed future can no longer be cancelled out from under the
        # set_result below
        live = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not live:
            return
        n = sum(r.n for r in live)
        try:
            bucket = self._engine.bucket_for(n)
            payload = tree_map(
                lambda *ls: np.concatenate(
                    [np.asarray(l) for l in ls], axis=0
                ),
                *[r.payload for r in live],
            )
        except Exception as e:
            # coalescing failures (e.g. requests whose trailing shapes
            # disagree reach np.concatenate) are *request* errors: fail
            # the batch, never the collector thread — and never the
            # circuit breaker, which guards the ENGINE
            self.counters.bump("errors")
            self._log.exception("serve coalesce failed (%d requests)",
                                len(live))
            for r in live:
                r.future.set_exception(e)
            return
        t_call = time.perf_counter()
        try:
            with obs_stepstats.timed_span(
                "serve.batch", "serve.batch_s", n=n, bucket=bucket,
                requests=len(live),
            ):
                tracer = active_tracer()
                if tracer is not None:
                    # flow ends INSIDE the batch span so the arrows
                    # terminate on it (bp="e" binds to the enclosing
                    # slice)
                    for r in live:
                        tracer.flow_end("serve.request", r.rid)
                out = self._engine.predict(payload)
        except Exception as e:  # answer everyone; keep serving
            self.counters.bump("errors")
            self._log.exception("serve batch failed (%d requests)",
                                len(live))
            if self._breaker is not None \
                    and self._breaker.record_failure():
                self._log.error(
                    "engine circuit OPENED after %d consecutive "
                    "failures — fast-rejecting with retry-after %.2fs",
                    self._breaker.failure_threshold,
                    self._breaker.retry_after_s(),
                )
            for r in live:
                r.future.set_exception(e)
            return
        self.estimator.observe(time.perf_counter() - t_call)
        if self._breaker is not None:
            self._breaker.record_success()
        reqs = live
        now = time.perf_counter()
        mono = time.monotonic()
        off = 0
        for r in reqs:
            lo = off
            off += r.n
            telemetry.observe("serve.latency_s", now - r.t0)
            if self._tenant_labels is not None:
                telemetry.observe("serve.latency_s", now - r.t0,
                                  labels=self._tenant_labels)
            if r.deadline is not None and mono > r.deadline:
                # answered, but late: the client may already have given
                # up — count it so the miss rate covers late answers,
                # not just sheds
                self.counters.bump("deadline_miss_total",
                                   labels=self._tenant_labels)
                flightrec.record_serve(
                    "deadline_miss", rid=r.rid,
                    late_s=round(mono - r.deadline, 4), **self._detail,
                )
            r.future.set_result(tree_map(
                lambda a: a[lo:lo + r.n], out
            ))
        self.counters.bump("batches")
        self.counters.bump("items", n)
        self.counters.bump("slots", bucket)
        telemetry.observe("serve.batch_fill_ratio", n / bucket, FILL_BUCKETS)
        telemetry.set_gauge("serve.queue_depth", self._q.qsize())

    # -- shutdown ----------------------------------------------------------

    def close(self, *, drain: bool = True, timeout: float | None = None) -> None:
        """Stop the batcher. ``drain=True`` (default) answers every
        already-admitted request first — the preemption-exit path;
        ``drain=False`` fails pending requests with
        :class:`RejectedError`. Idempotent.

        With a ``timeout``, a collector thread that fails to join —
        an engine call wedged inside :meth:`_execute` — is **surfaced**
        (logged and raised as :class:`TimeoutError`), never reported as
        a clean shutdown; the heartbeat and readiness hook are left
        registered so ``/healthz`` keeps naming the stall."""
        self._drain_on_close = self._drain_on_close and drain
        self._closing = True
        self._thread.join(timeout)
        if self._thread.is_alive():
            self.counters.bump("close_timeouts")
            self._log.error(
                "batcher close(timeout=%s) did NOT stop the collector — "
                "the engine call is wedged; /healthz heartbeat %r stays "
                "registered to flag the stall", timeout, self._health_name,
            )
            raise TimeoutError(
                f"DynamicBatcher collector failed to join within "
                f"{timeout}s — engine call wedged; not a clean shutdown"
            )
        # a cleanly-closed batcher must not leave a stale heartbeat
        # (false liveness failure) or a permanently not-ready hook
        obs_server.HEARTBEATS.clear(self._health_name)
        obs_server.unregister_readiness(self._health_name)

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _leading(item) -> int:
    n = _leading_dim(item)  # validates cross-leaf agreement up front
    if n < 1:
        raise ValueError(
            "requests need a leading batch axis of >= 1 (a single example "
            "is x[i:i+1])"
        )
    return n
