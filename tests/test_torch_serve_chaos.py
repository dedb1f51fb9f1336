"""The serving chaos matrix of the port (``tpu_syncbn_torch.serve``):
JAX's tests/test_serve_chaos.py case for case — every overload path
proven by deterministic fault injection (``testing.faults``' serving
faults) on stub engines — plus the port's equalities with the JAX
package: the breaker's backoff schedule and ``poisson_arrivals`` for the
same keys and seeds, and the ``circuit_open`` incident bundle (valid
under both packages' schema gates, its serve ring holding the failures).

Failure modes under test: a slow engine past its deadline sheds; an
engine crash opens the circuit and a half-open probe recovers it; a
poisoned request fails only its own batch; a wedged engine at shutdown
surfaces; ``/readyz`` flips 503 while the circuit is open. Pure
admission semantics (EDF order, the estimator, the breaker's state
machine) run on injected clocks. Every server binds port 0; every wait
and request is bounded.
"""

import glob
import json
import os
import time
import urllib.error
from urllib.request import urlopen

import numpy as np
import pytest

from tpu_syncbn_torch import serve
from tpu_syncbn_torch.obs import flightrec, incident
from tpu_syncbn_torch.obs import server as obs_server
from tpu_syncbn_torch.obs import telemetry, tracing
from tpu_syncbn_torch.serve.admission import (
    AdmissionController,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    LatencyEstimator,
)
from tpu_syncbn_torch.testing import faults


@pytest.fixture(autouse=True)
def _clean_obs_state():
    def reset():
        telemetry.set_enabled(None)
        telemetry.REGISTRY.reset()
        tracing.uninstall()
        rec = flightrec.uninstall()
        if rec is not None:
            rec.close()

    reset()
    yield
    reset()


class StubEngine:
    """Duck-typed engine (the established test stub): fixed bucket,
    predict doubles the payload after an optional delay."""

    def __init__(self, bucket=4, delay=0.0):
        self.max_bucket = bucket
        self._delay = delay
        self.calls: list[int] = []

    def bucket_for(self, n):
        if n > self.max_bucket:
            raise ValueError(f"batch of {n} exceeds bucket {self.max_bucket}")
        return self.max_bucket

    def predict(self, b):
        self.calls.append(int(np.shape(b)[0]))
        if self._delay:
            time.sleep(self._delay)
        return np.asarray(b) * 2.0


def _item(v, n=1):
    return np.full((n, 1), v, np.float32)


# --------------------------------------------------------- unit: estimator


class TestLatencyEstimator:
    def test_cold_estimator_predicts_none(self):
        est = LatencyEstimator()
        assert est.predict() is None

    def test_ewma_tracks_observations(self):
        est = LatencyEstimator(alpha=0.5)
        est.observe(0.1)
        assert est.predict() == pytest.approx(0.1)
        est.observe(0.3)
        assert est.predict() == pytest.approx(0.2)

    def test_windowed_aggregator_preferred_over_ewma(self):
        """With telemetry on, the rolling serve.infer_s quantile from a
        WindowedAggregator wins over the local EWMA."""
        from tpu_syncbn_torch.obs import timeseries

        telemetry.set_enabled(True)
        agg = timeseries.WindowedAggregator()
        t = time.monotonic()  # rate/quantile windows filter on this clock
        agg.tick(now=t - 1.0)  # anchor
        for _ in range(20):
            telemetry.observe("serve.infer_s", 0.05)
        agg.tick(now=t)
        est = LatencyEstimator(agg, quantile=0.5)
        est.observe(10.0)  # EWMA says 10s; the window must win
        p = est.predict()
        assert p is not None and p < 1.0

    def test_aggregator_without_data_falls_back_to_ewma(self):
        from tpu_syncbn_torch.obs import timeseries

        agg = timeseries.WindowedAggregator()
        est = LatencyEstimator(agg)
        est.observe(0.25)
        assert est.predict() == pytest.approx(0.25)


# ------------------------------------------------- unit: admission queue


class _Req:
    def __init__(self, deadline=None, tag=None):
        self.deadline = deadline
        self.tag = tag


class TestAdmissionController:
    def test_edf_order_beats_fifo_order(self):
        ctrl = AdmissionController(max_queue=8, now=lambda: 0.0)
        late = _Req(deadline=10.0, tag="late")
        soon = _Req(deadline=1.0, tag="soon")
        none = _Req(deadline=None, tag="none")
        for r in (late, none, soon):
            ctrl.put_nowait(r)
        order = [ctrl.get_nowait().tag for _ in range(3)]
        # earliest deadline first; deadline-less requests sort last
        assert order == ["soon", "late", "none"]

    def test_no_deadlines_is_plain_fifo(self):
        ctrl = AdmissionController(max_queue=8)
        for i in range(5):
            ctrl.put_nowait(_Req(tag=i))
        assert [ctrl.get_nowait().tag for _ in range(5)] == list(range(5))

    def test_capacity_enforced(self):
        import queue

        ctrl = AdmissionController(max_queue=2)
        ctrl.put_nowait(_Req())
        ctrl.put_nowait(_Req())
        with pytest.raises(queue.Full):
            ctrl.put_nowait(_Req())

    def test_doomed_requests_shed_at_dispatch(self):
        """A request whose deadline cannot be met by the predicted
        engine time is handed to on_shed, never returned — and a
        viable one behind it is."""
        clock = [0.0]
        est = LatencyEstimator()
        est.observe(5.0)  # every call predicted to take 5s
        shed = []
        ctrl = AdmissionController(
            max_queue=8, estimator=est, on_shed=shed.append,
            now=lambda: clock[0],
        )
        ctrl.put_nowait(_Req(deadline=2.0, tag="doomed"))   # 0+5 > 2
        ctrl.put_nowait(_Req(deadline=9.0, tag="viable"))   # 0+5 < 9
        got = ctrl.get_nowait()
        assert got.tag == "viable"
        assert [r.tag for r in shed] == ["doomed"]

    def test_expired_requests_shed_without_estimator(self):
        """No evidence → no *predictive* shedding, but an already-
        expired deadline always sheds."""
        import queue

        clock = [0.0]
        shed = []
        ctrl = AdmissionController(max_queue=8, on_shed=shed.append,
                                   now=lambda: clock[0])
        ctrl.put_nowait(_Req(deadline=1.0, tag="a"))
        clock[0] = 2.0  # past the deadline
        with pytest.raises(queue.Empty):
            ctrl.get_nowait()
        assert [r.tag for r in shed] == ["a"]

    def test_cold_estimator_sheds_nothing_early(self):
        ctrl = AdmissionController(
            max_queue=8, estimator=LatencyEstimator(), now=lambda: 0.0,
        )
        ctrl.put_nowait(_Req(deadline=0.5, tag="tight"))
        assert ctrl.get_nowait().tag == "tight"


# ---------------------------------------------------- unit: circuit breaker


class TestCircuitBreaker:
    def _breaker(self, clock, **kw):
        kw.setdefault("failure_threshold", 3)
        kw.setdefault("backoff_base_s", 1.0)
        kw.setdefault("backoff_max_s", 8.0)
        return CircuitBreaker(now=lambda: clock[0], **kw)

    def test_opens_after_threshold_consecutive_failures(self):
        clock = [0.0]
        br = self._breaker(clock)
        assert br.record_failure() is False
        assert br.record_failure() is False
        assert br.state == CircuitBreaker.CLOSED
        assert br.record_failure() is True
        assert br.state == CircuitBreaker.OPEN
        ok, retry = br.allow()
        assert not ok and retry > 0

    def test_success_resets_the_consecutive_count(self):
        clock = [0.0]
        br = self._breaker(clock)
        br.record_failure()
        br.record_failure()
        br.record_success()  # isolated failures never accumulate
        br.record_failure()
        br.record_failure()
        assert br.state == CircuitBreaker.CLOSED

    def test_backoff_expiry_half_opens_then_success_closes(self):
        clock = [0.0]
        br = self._breaker(clock)
        for _ in range(3):
            br.record_failure()
        _, retry = br.allow()
        clock[0] = retry + 1e-6
        ok, _ = br.allow()
        assert ok  # probe admitted
        assert br.state == CircuitBreaker.HALF_OPEN
        br.record_success()
        assert br.state == CircuitBreaker.CLOSED

    def test_failed_probe_reopens_with_longer_backoff(self):
        clock = [0.0]
        br = self._breaker(clock)
        for _ in range(3):
            br.record_failure()
        _, retry1 = br.allow()
        clock[0] = retry1 + 1e-6
        assert br.allow()[0]
        br.record_failure()  # probe fails: straight back to open
        assert br.state == CircuitBreaker.OPEN
        _, retry2 = br.allow()
        # deterministic-jitter exponential schedule: strictly longer
        assert retry2 > retry1
        assert br.open_count == 2

    def test_half_open_probe_quota_bounds_admission(self):
        """Half-open is not an open door: only probe_limit submits get
        through until the probe's outcome lands — the rest keep
        fast-failing instead of queueing behind a suspect engine."""
        clock = [0.0]
        br = self._breaker(clock, probe_limit=2)
        for _ in range(3):
            br.record_failure()
        _, retry = br.allow()
        clock[0] = retry + 1e-6
        assert br.allow()[0] and br.allow()[0]  # quota of 2
        ok, hint = br.allow()                   # third: quota spent
        assert not ok and hint > 0
        br.record_success()                     # probe outcome lands
        assert br.allow() == (True, 0.0)        # closed: unlimited again

    def test_backoff_schedule_is_deterministic(self):
        """Jitter comes from backoff_delays' CRC hash, so two breakers
        with the same key agree exactly."""
        a = CircuitBreaker(key="host0", now=lambda: 0.0)
        b = CircuitBreaker(key="host0", now=lambda: 0.0)
        assert a._delays == b._delays
        c = CircuitBreaker(key="host1", now=lambda: 0.0)
        assert a._delays != c._delays  # de-synchronized across hosts

    def test_circuit_state_gauge_published(self):
        telemetry.set_enabled(True)
        clock = [0.0]
        br = self._breaker(clock)
        assert telemetry.snapshot()["gauges"]["serve.circuit_state"] == 0
        for _ in range(3):
            br.record_failure()
        assert telemetry.snapshot()["gauges"]["serve.circuit_state"] == 2
        _, retry = br.allow()
        clock[0] = retry + 1e-6
        br.allow()
        assert telemetry.snapshot()["gauges"]["serve.circuit_state"] == 1
        br.record_success()
        assert telemetry.snapshot()["gauges"]["serve.circuit_state"] == 0


# ----------------------------------------------- chaos: slow engine sheds


class TestSlowEngineSheds:
    def test_slow_engine_past_deadline_sheds_instead_of_queueing(self):
        """faults.slow_engine: engine calls take ~10x the request
        deadline. After the estimator sees the first slow call, queued
        deadlined requests are shed (DeadlineExceededError +
        serve.shed) rather than dispatched dead."""
        eng = faults.slow_engine(StubEngine(bucket=1), 0.25)
        bat = serve.DynamicBatcher(eng, max_batch=1, max_wait_ms=1,
                                   max_queue=32, deadline_ms=60.0)
        try:
            futs = [bat.submit(_item(i)) for i in range(6)]
            outcomes = {"shed": 0, "answered": 0, "late": 0}
            for f in futs:
                try:
                    f.result(timeout=30)
                    outcomes["answered"] += 1
                except DeadlineExceededError:
                    outcomes["shed"] += 1
            assert outcomes["shed"] >= 1, outcomes
            assert bat.counters.count("shed") == outcomes["shed"]
            # every shed is also a deadline miss; late answers may add
            assert bat.counters.count("deadline_miss_total") \
                >= outcomes["shed"]
        finally:
            bat.close()

    def test_fast_engine_with_deadlines_sheds_nothing(self):
        """Control: same deadlines, healthy engine — nothing sheds,
        everything answers in time."""
        bat = serve.DynamicBatcher(StubEngine(bucket=4), max_batch=4,
                                   max_wait_ms=5, max_queue=32,
                                   deadline_ms=5000.0)
        try:
            futs = [bat.submit(_item(i)) for i in range(8)]
            for i, f in enumerate(futs):
                assert float(f.result(timeout=10)[0, 0]) == 2.0 * i
            assert bat.counters.count("shed") == 0
            assert bat.counters.count("deadline_miss_total") == 0
        finally:
            bat.close()


# ------------------------------------- chaos: crash -> circuit -> recovery


class TestCircuitBreakerChaos:
    def test_crash_opens_circuit_then_half_open_probe_recovers(self):
        """faults.crash_engine_at_batch: the engine fails every call in
        a finite window. Consecutive failures open the circuit (fast
        CircuitOpenError with retry_after_s), the deterministic backoff
        expires, a half-open probe finds the recovered engine, and
        serving resumes."""
        eng = faults.crash_engine_at_batch(StubEngine(bucket=1),
                                           0, n_batches=3)
        breaker = CircuitBreaker(failure_threshold=3,
                                 backoff_base_s=0.05, backoff_max_s=0.2,
                                 key="chaos")
        bat = serve.DynamicBatcher(eng, max_batch=1, max_wait_ms=1,
                                   max_queue=16, breaker=breaker)
        try:
            # 3 failing batches -> circuit opens
            futs = [bat.submit(_item(i)) for i in range(3)]
            for f in futs:
                with pytest.raises(RuntimeError, match="injected"):
                    f.result(timeout=10)
            assert breaker.state == CircuitBreaker.OPEN
            # while open: fast rejection with a retry-after hint
            with pytest.raises(CircuitOpenError) as ei:
                bat.submit(_item(9))
            assert ei.value.retry_after_s is not None
            assert bat.counters.count("rejected") >= 1
            # wait out the deterministic backoff -> half-open probe;
            # the fault window is over, so the probe succeeds
            deadline = time.monotonic() + 10.0
            while breaker.state == CircuitBreaker.OPEN \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            f = bat.submit(_item(5))
            assert float(f.result(timeout=10)[0, 0]) == 10.0
            assert breaker.state == CircuitBreaker.CLOSED
            # and steady serving is back
            f2 = bat.submit(_item(7))
            assert float(f2.result(timeout=10)[0, 0]) == 14.0
        finally:
            bat.close()

    def test_open_circuit_fast_fails_already_queued_work(self):
        """Requests sitting in the queue when the circuit opens are
        failed fast (CircuitOpenError) — not dispatched into a known-
        broken engine."""
        eng = faults.crash_engine_at_batch(
            StubEngine(bucket=1, delay=0.05), 0, n_batches=None,
        )
        breaker = CircuitBreaker(failure_threshold=2,
                                 backoff_base_s=5.0, key="chaos2")
        bat = serve.DynamicBatcher(eng, max_batch=1, max_wait_ms=1,
                                   max_queue=32, breaker=breaker)
        try:
            futs = [bat.submit(_item(i)) for i in range(8)]
            kinds = []
            for f in futs:
                try:
                    f.result(timeout=10)
                    kinds.append("ok")
                except CircuitOpenError:
                    kinds.append("circuit")
                except RuntimeError:
                    kinds.append("crash")
            assert "crash" in kinds      # the failures that opened it
            assert "circuit" in kinds    # queued work failed fast
            assert "ok" not in kinds
        finally:
            bat.close()


# --------------------------------------------- chaos: poisoned request


class TestPoisonedRequest:
    def test_poison_fails_its_batch_only_circuit_stays_closed(self):
        """faults.poison_request: the poisoned payload coalesces
        cleanly, crashes exactly the engine call it rode in, and the
        batcher keeps serving — neighbors in OTHER batches are fine and
        the circuit never opens (isolated failures reset on the next
        success)."""
        eng = faults.poison_sensitive_engine(StubEngine(bucket=2))
        breaker = CircuitBreaker(failure_threshold=3, key="poison")
        bat = serve.DynamicBatcher(eng, max_batch=2, max_wait_ms=5,
                                   max_queue=32, breaker=breaker)
        try:
            # full batch of poison + its batchmate
            f_poison = bat.submit(faults.poison_request(_item(1.0)))
            f_mate = bat.submit(_item(2.0))
            with pytest.raises(faults.PoisonedRequestError):
                f_poison.result(timeout=10)
            with pytest.raises(faults.PoisonedRequestError):
                f_mate.result(timeout=10)
            # subsequent clean batches are answered; circuit closed
            for v in (3.0, 4.0, 5.0):
                f = bat.submit(_item(v))
                assert float(f.result(timeout=10)[0, 0]) == 2.0 * v
            assert breaker.state == CircuitBreaker.CLOSED
            assert bat.counters.count("errors") == 1
        finally:
            bat.close()


# -------------------------------------------- chaos: wedged-engine close


class TestWedgedClose:
    def test_close_timeout_surfaces_wedged_collector(self):
        """close(timeout=) on a batcher whose engine call is
        wedged raises TimeoutError (and counts close_timeouts) instead
        of silently returning — and the health hooks stay registered so
        /healthz keeps naming the stall."""
        eng = StubEngine(bucket=1, delay=1.0)  # wedged vs the timeout
        bat = serve.DynamicBatcher(eng, max_batch=1, max_wait_ms=1,
                                   max_queue=8, health_name="wedge_test")
        fut = bat.submit(_item(1.0))
        time.sleep(0.05)  # let the collector enter the engine call
        with pytest.raises(TimeoutError, match="wedged"):
            bat.close(timeout=0.1)
        assert bat.counters.count("close_timeouts") == 1
        # the stall stays visible: heartbeat still registered
        assert "wedge_test" in obs_server.HEARTBEATS.ages()
        # the engine eventually finishes; a second close is clean
        fut.result(timeout=30)
        bat.close(timeout=10.0)
        assert "wedge_test" not in obs_server.HEARTBEATS.ages()

    def test_clean_close_with_timeout_stays_silent(self):
        bat = serve.DynamicBatcher(StubEngine(bucket=1), max_batch=1,
                                   max_queue=8)
        bat.submit(_item(1.0)).result(timeout=10)
        bat.close(timeout=10.0)  # joins fine: no raise
        assert bat.counters.count("close_timeouts") == 0


# ---------------------------------------------- monitor: /readyz flip


class TestCircuitReadyzFlip:
    def _probe(self, url):
        try:
            with urlopen(url, timeout=10) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def test_readyz_flips_503_while_circuit_open_and_recovers(self):
        """The circuit is an operable signal: /readyz answers 503
        naming the serve hook while open, 200 again after the half-open
        probe recovers the engine."""
        eng = faults.crash_engine_at_batch(StubEngine(bucket=1),
                                           0, n_batches=2)
        breaker = CircuitBreaker(failure_threshold=2,
                                 backoff_base_s=0.05, backoff_max_s=0.2,
                                 key="readyz")
        srv = obs_server.MonitoringServer(port=0, host="127.0.0.1")
        bat = serve.DynamicBatcher(eng, max_batch=1, max_wait_ms=1,
                                   max_queue=16, breaker=breaker,
                                   health_name="serve_chaos")
        try:
            base = f"http://127.0.0.1:{srv.port}"
            status, body = self._probe(base + "/readyz")
            assert status == 200 and body["ok"]
            # crash window: 2 failures open the circuit
            futs = [bat.submit(_item(i)) for i in range(2)]
            for f in futs:
                with pytest.raises(RuntimeError):
                    f.result(timeout=10)
            assert breaker.state == CircuitBreaker.OPEN
            status, body = self._probe(base + "/readyz")
            assert status == 503 and not body["ok"]
            check = body["checks"]["serve_chaos"]
            assert not check["ok"]
            assert check["circuit"]["state"] == "open"
            # backoff expires; probe succeeds (fault window over)
            deadline = time.monotonic() + 10.0
            while breaker.state == CircuitBreaker.OPEN \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            f = bat.submit(_item(3.0))
            assert float(f.result(timeout=10)[0, 0]) == 6.0
            status, body = self._probe(base + "/readyz")
            assert status == 200 and body["ok"]
            assert body["checks"]["serve_chaos"]["circuit"]["state"] \
                == "closed"
        finally:
            bat.close()
            srv.close()


# ------------------------------------------------ overload SLO rules


class TestServeOverloadSLO:
    def test_overload_rule_fires_on_deadline_miss_burn(self):
        """slo.serve_overload_rules: a miss rate far past the budget
        (0.1% target, ~17% observed) fires the serve_overload rule in
        every window; a healthy window keeps it quiet."""
        from tpu_syncbn_torch.obs import slo, timeseries

        telemetry.set_enabled(True)
        agg = timeseries.WindowedAggregator()
        t = time.monotonic()
        agg.tick(now=t - 2.0)
        telemetry.count("serve.requests", 1000)
        telemetry.count("serve.deadline_miss_total", 200)
        agg.tick(now=t)
        rules = slo.serve_overload_rules()
        assert [r.name for r in rules] == ["serve_latency",
                                           "serve_overload"]
        tracker = slo.SLOTracker(agg, rules)
        state = tracker.evaluate()
        assert state["serve_overload"]["firing"] is True
        # no latency observations: the latency rule cannot fire on
        # no evidence
        assert state["serve_latency"]["firing"] is False

    def test_subset_rate_reports_the_true_miss_rate(self):
        """Misses are a subset of requests: at total collapse the rate
        must read 100%, not the 50% the disjoint Availability form
        would report (halving the burn the alert acts on)."""
        from tpu_syncbn_torch.obs import slo

        obj = slo.SubsetRate(total="serve.requests",
                             bad="serve.deadline_miss_total",
                             target=0.999)

        class FakeAgg:
            def rate(self, name, w, now=None):
                return {"serve.requests": 100.0,
                        "serve.deadline_miss_total": 100.0}[name]

        assert obj.error_rate(FakeAgg(), 60.0) == 1.0
        assert "serve.deadline_miss_total / serve.requests" \
            in obj.describe()

    def test_overload_rule_quiet_within_budget(self):
        from tpu_syncbn_torch.obs import slo, timeseries

        telemetry.set_enabled(True)
        agg = timeseries.WindowedAggregator()
        t = time.monotonic()
        agg.tick(now=t - 2.0)
        telemetry.count("serve.requests", 100000)
        telemetry.count("serve.deadline_miss_total", 10)  # 0.01% << 0.1%
        agg.tick(now=t)
        tracker = slo.SLOTracker(agg, slo.serve_overload_rules())
        state = tracker.evaluate()
        assert state["serve_overload"]["firing"] is False


# ------------------------------------------------- open-loop loadgen


class TestOpenLoopLoadGen:
    def test_poisson_arrivals_are_seed_deterministic(self):
        a = serve.poisson_arrivals(100.0, 1.0, seed=7)
        b = serve.poisson_arrivals(100.0, 1.0, seed=7)
        c = serve.poisson_arrivals(100.0, 1.0, seed=8)
        assert a == b
        assert a != c
        assert all(0 <= t < 1.0 for t in a)
        assert a == sorted(a)
        # roughly rate * duration arrivals (Poisson, generous band)
        assert 40 <= len(a) <= 200

    def test_trace_arrivals_validates(self):
        assert serve.trace_arrivals([0.0, 0.1, 0.5]) == [0.0, 0.1, 0.5]
        with pytest.raises(ValueError, match="sorted"):
            serve.trace_arrivals([0.2, 0.1])
        with pytest.raises(ValueError, match=">= 0"):
            serve.trace_arrivals([-1.0])

    def test_open_loop_past_saturation_degrades_gracefully(self):
        """The acceptance shape on a stub with a fixed service time:
        offered load ~4x capacity -> goodput holds near capacity, p99
        of answers stays bounded by the deadline policy, and the excess
        is shed/rejected — never lost, never unboundedly queued."""
        # service: 20ms per batch of up to 8 -> capacity ~400 items/s
        eng = StubEngine(bucket=8, delay=0.02)
        bat = serve.DynamicBatcher(eng, max_batch=8, max_wait_ms=5,
                                   max_queue=32, deadline_ms=150.0)
        try:
            gen = serve.OpenLoopLoadGen(
                bat.submit, make_request=lambda i: _item(float(i)),
                deadline_ms=150.0,
            )
            report = gen.run(
                serve.poisson_arrivals(1600.0, 0.75, seed=3),
                collect_timeout_s=60.0,
            )
        finally:
            bat.close()
        assert report.lost == 0
        assert report.offered >= 800
        # the stack dropped the un-serveable excess...
        assert report.shed + report.rejected > 0
        # ...while still delivering real goodput
        assert report.answered > 0
        assert report.goodput_rps > 0
        # accounting closes: every request has exactly one outcome
        assert (report.answered + report.late + report.shed
                + report.rejected + report.errored) == report.offered

    def test_submit_time_rejections_counted(self):
        def always_reject(payload, deadline_ms=None):
            raise serve.RejectedError("full")

        gen = serve.OpenLoopLoadGen(always_reject)
        report = gen.run([0.0, 0.001, 0.002])
        assert report.offered == 3
        assert report.rejected == 3
        assert report.answered == 0 and report.lost == 0


# ------------------------------------------------- equal to the JAX package


@pytest.mark.parametrize("key,kw", [
    ("", {}), ("host0", {}), ("serve", {"backoff_base_s": 0.05, "backoff_max_s": 0.2}),
    ("chaos", {"backoff_steps": 3, "backoff_base_s": 2.0}),
])
def test_breaker_backoff_schedule_equals_jax(key, kw):
    """The same key and knobs give JAX's delays exactly, and the same
    gauge name; the state machine walks them identically."""
    from tpu_syncbn.serve.admission import CircuitBreaker as JBreaker

    ours = CircuitBreaker(key=key, now=lambda: 0.0, **kw)
    theirs = JBreaker(key=key, now=lambda: 0.0, **kw)
    assert ours._delays == theirs._delays
    assert ours.gauge_name == theirs.gauge_name
    clocks = {id(ours): [0.0], id(theirs): [0.0]}
    a = CircuitBreaker(key=key, failure_threshold=2, now=lambda: clocks[id(ours)][0], **kw)
    b = JBreaker(key=key, failure_threshold=2, now=lambda: clocks[id(theirs)][0], **kw)
    trace = []
    for br, clock in ((a, clocks[id(ours)]), (b, clocks[id(theirs)])):
        seen = []
        for _ in range(4):  # open, wait out the backoff, fail the probe
            br.record_failure()
            br.record_failure()
            ok, retry = br.allow()
            seen.append((br.state, ok, round(retry, 12), br.open_count))
            clock[0] += retry + 1e-6
            seen.append((br.state, br.allow()))
        br.record_success()
        seen.append(br.stats())
        trace.append(seen)
    assert trace[0] == trace[1]


@pytest.mark.parametrize("rate,duration,seed", [(100.0, 1.0, 7), (1600.0, 0.75, 3),
                                                (3.5, 10.0, 0)])
def test_poisson_arrivals_equal_jax(rate, duration, seed):
    from tpu_syncbn.serve import loadgen as jloadgen

    assert serve.poisson_arrivals(rate, duration, seed=seed) == \
        jloadgen.poisson_arrivals(rate, duration, seed=seed)


def test_load_report_summary_equals_jax():
    from tpu_syncbn.serve import loadgen as jloadgen

    kw = dict(offered=10, duration_s=0.5, answered=6, late=1, shed=2, rejected=1,
              errored=0, lost=0, latencies_s=[0.01 * i for i in range(7)])
    assert serve.LoadReport(**kw).summary() == jloadgen.LoadReport(**kw).summary()


def test_circuit_open_leaves_one_valid_bundle_with_the_failures(tmp_path):
    """The breaker's trigger: a crash window that opens the circuit dumps
    exactly one ``circuit_open`` bundle, valid under both packages'
    schema gates, whose serve ring holds the breaker's transitions up to
    the open and whose readiness block names the open circuit."""
    from tpu_syncbn.obs import incident as jinc

    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path)))
    eng = faults.crash_engine_at_batch(StubEngine(bucket=1), 0, n_batches=2)
    breaker = CircuitBreaker(failure_threshold=2, backoff_base_s=5.0, key="bundle")
    bat = serve.DynamicBatcher(eng, max_batch=1, max_wait_ms=1, max_queue=8,
                               breaker=breaker, health_name="serve_bundle")
    try:
        for f in [bat.submit(_item(i)) for i in range(2)]:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=10)
        assert breaker.state == CircuitBreaker.OPEN
        with pytest.raises(CircuitOpenError):
            bat.submit(_item(9))
    finally:
        bat.close()
    paths = sorted(glob.glob(os.path.join(str(tmp_path), "incident_*.json")))
    assert len(paths) == 1
    bundle = incident.load_bundle(paths[0])
    jinc.validate_bundle(json.loads(json.dumps(bundle)))
    assert bundle["trigger"]["kind"] == "circuit_open"
    assert bundle["trigger"]["detail"]["open_count"] == 1
    kinds = [e["kind"] for e in bundle["rings"]["serve"]]
    assert "circuit_state" in kinds
    states = [e.get("state") for e in bundle["rings"]["serve"] if e["kind"] == "circuit_state"]
    assert states[-1] == "open"
    check = bundle["state"]["readiness"]["checks"]["serve_bundle"]
    assert not check["ok"] and check["circuit"]["state"] == "open"
    assert rec.last_incident is not None
