"""The port's monitoring server (``tpu_syncbn_torch.obs.server``) against
the JAX package's (``tpu_syncbn.obs.server``): ``render_prometheus`` and
``render_statusz`` byte for byte on the same snapshot or report (the JAX
suite's goldens included, and a seeded registry with integers, ``NaN``,
``±Inf``, exponent forms and labeled families driven through both
packages), ``statusz_report`` equal on the same live state, the six
``MONITOR_METRICS`` names equal and each produced; then the endpoints over
a live port-0 server — the JAX suite's ``TestPrometheusExposition``,
``TestHealthz``, ``TestReadyz``, ``TestTrainReadinessFlips`` and the
training half of ``TestEnvGatedRuns`` on the port's ``ResilientLoop``,
``TestServeReadinessFlips`` and the serving half on the port's
``DynamicBatcher`` —
``/statusz``, ``POST /incidentz`` and ``POST /profilez`` on the CPU,
including the hand-off of a capture to the main thread's loop and its
bounded 503 when no loop takes it.

Every server binds port 0 and is closed by its test; every test that sets
``TPU_SYNCBN_METRICS_PORT`` stops the env server in teardown; every HTTP
request carries a timeout.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_syncbn_torch.obs import flightrec, profiling, server as obs_server
from tpu_syncbn_torch.obs import slo as obs_slo
from tpu_syncbn_torch.obs import telemetry, timeseries, tracing
from tpu_syncbn_torch.runtime import resilience

HTTP_TIMEOUT_S = 10


def _jax():
    from tpu_syncbn.obs import flightrec as jfr, server as jsrv, slo as jslo
    from tpu_syncbn.obs import telemetry as jtel, timeseries as jts, tracing as jtr

    return dict(fr=jfr, srv=jsrv, slo=jslo, tel=jtel, ts=jts, tr=jtr)


PORT = dict(fr=flightrec, srv=obs_server, slo=obs_slo, tel=telemetry, ts=timeseries,
            tr=tracing)


@pytest.fixture(autouse=True)
def _clean_monitor_state():
    """Both packages start and end with telemetry at its default, empty
    registries, no tracer, recorder, heartbeat, readiness hook, attached
    tracker, env-gated server or pending ``/profilez`` hand-off."""
    pkgs = (PORT, _jax())

    def reset():
        for p in pkgs:
            p["tel"].set_enabled(None)
            p["tel"].REGISTRY.reset()
            p["tr"].uninstall()
            rec = p["fr"].uninstall()
            if rec is not None:
                rec.close()
            p["srv"].HEARTBEATS.clear()
            with p["srv"]._readiness_lock:
                p["srv"]._readiness.clear()
            with p["slo"]._attached_lock:
                p["slo"]._attached.clear()
            p["srv"].stop_env_server()
        with profiling._slot_lock:
            profiling._slot = None

    reset()
    yield
    reset()


def _get(url, timeout=HTTP_TIMEOUT_S, method="GET"):
    """(status, parsed-or-text) without raising on 4xx/5xx."""
    req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body, status = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    text = body.decode()
    try:
        return status, json.loads(text)
    except json.JSONDecodeError:
        return status, text


def _post(url, timeout=HTTP_TIMEOUT_S):
    return _get(url, timeout=timeout, method="POST")


def _server(**kw):
    return obs_server.MonitoringServer(port=0, host="127.0.0.1", **kw)


# -- /metrics exposition: byte for byte ------------------------------------------

GOLDEN = (
    "# TYPE tpu_syncbn_serve_requests_total counter\n"
    "tpu_syncbn_serve_requests_total 3\n"
    "# TYPE tpu_syncbn_serve_queue_depth gauge\n"
    "tpu_syncbn_serve_queue_depth 2.5\n"
    "# TYPE tpu_syncbn_serve_latency_s histogram\n"
    'tpu_syncbn_serve_latency_s_bucket{le="0.1"} 2\n'
    'tpu_syncbn_serve_latency_s_bucket{le="1"} 2\n'
    'tpu_syncbn_serve_latency_s_bucket{le="+Inf"} 3\n'
    "tpu_syncbn_serve_latency_s_sum 5.1\n"
    "tpu_syncbn_serve_latency_s_count 3\n"
)
LABELED_GOLDEN = (
    "# TYPE tpu_syncbn_serve_requests_total counter\n"
    "tpu_syncbn_serve_requests_total 3\n"
    'tpu_syncbn_serve_requests_total{tenant="a"} 2\n'
    'tpu_syncbn_serve_requests_total{tenant="we\\"ird\\\\x"} 1\n'
    "# TYPE tpu_syncbn_serve_requests2_total counter\n"
    "tpu_syncbn_serve_requests2_total 4\n"
    "# TYPE tpu_syncbn_serve_queue_depth gauge\n"
    'tpu_syncbn_serve_queue_depth{tenant="a"} 2.5\n'
    "# TYPE tpu_syncbn_serve_latency_s histogram\n"
    'tpu_syncbn_serve_latency_s_bucket{tenant="a",le="0.1"} 1\n'
    'tpu_syncbn_serve_latency_s_bucket{tenant="a",le="1"} 1\n'
    'tpu_syncbn_serve_latency_s_bucket{tenant="a",le="+Inf"} 2\n'
    'tpu_syncbn_serve_latency_s_sum{tenant="a"} 5.05\n'
    'tpu_syncbn_serve_latency_s_count{tenant="a"} 2\n'
)


def _golden_registry(tel):
    r = tel.Registry()
    r.counter("serve.requests").inc(3)
    r.gauge("serve.queue_depth").set(2.5)
    h = r.histogram("serve.latency_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.05, 5.0):
        h.observe(v)
    return r


def _labeled_registry(tel):
    r = tel.Registry()
    r.counter("serve.requests").inc(3)
    r.counter("serve.requests", labels={"tenant": "a"}).inc(2)
    r.counter("serve.requests", labels={"tenant": 'we"ird\\x'}).inc(1)
    r.counter("serve.requests2").inc(4)
    r.gauge("serve.queue_depth", labels={"tenant": "a"}).set(2.5)
    h = r.histogram("serve.latency_s", buckets=(0.1, 1.0), labels={"tenant": "a"})
    h.observe(0.05)
    h.observe(5.0)
    return r


def _seeded_registry(tel):
    """Every number form ``_prom_num`` knows (integers, halves, exponent
    forms, ``NaN``, ``±Inf``, negatives) and names whose raw sort would
    interleave label variants, from one seed."""
    rng = np.random.RandomState(11)
    r = tel.Registry()
    for i, name in enumerate(("a.b", "a.b2", "a.b_c", "z.y", "obs.server.requests")):
        r.counter(name).inc(int(rng.randint(0, 10 ** (i + 1))))
        r.counter(name, labels={"k": f"v{i}", "a": "x"}).inc(i + 1)
    specials = {"g.nan": float("nan"), "g.pinf": float("inf"), "g.ninf": float("-inf"),
                "g.tiny": 1e-07, "g.huge": 1e20, "g.neg": -2.5, "g.int": 7.0,
                "g.third": 1.0 / 3.0, "g.zero": 0.0, "g.big_int": float(2 ** 60)}
    for name, v in specials.items():
        r.gauge(name).set(v)
    r.gauge("g.nan", labels={"tenant": "b"}).set(float("nan"))
    for name, buckets in (("h.time_s", (0.001, 0.01, 0.1, 1.0)),
                          ("h.bytes", (1e3, 1e6, 1e9)), ("h.time_s2", (0.5,))):
        h = r.histogram(name, buckets=buckets)
        for v in rng.exponential(buckets[-1] / 3, size=37):
            h.observe(float(v))
        hl = r.histogram(name, buckets=buckets, labels={"tenant": "a"})
        for v in rng.uniform(0, buckets[-1] * 2, size=5):
            hl.observe(float(v))
    return r


@pytest.mark.parametrize("build,golden", [(_golden_registry, GOLDEN),
                                          (_labeled_registry, LABELED_GOLDEN),
                                          (_seeded_registry, None)])
@pytest.mark.parametrize("namespace", [None, "port_ns"])
def test_render_prometheus_byte_for_byte(build, golden, namespace):
    j = _jax()
    snap, jsnap = build(telemetry).snapshot(), build(j["tel"]).snapshot()
    assert json.dumps(snap, sort_keys=True) == json.dumps(jsnap, sort_keys=True)
    kw = {} if namespace is None else {"namespace": namespace}
    got = obs_server.render_prometheus(snap, **kw)
    assert got == j["srv"].render_prometheus(jsnap, **kw)
    if golden is not None and namespace is None:
        assert got == golden
    if build is _seeded_registry:
        for form in ("NaN", "+Inf", "-Inf", "1e-07", "100000000000000000000", " -2.5\n",
                     "_g_int 7\n", " 0.3333333333333333\n"):
            assert form in got, form
        assert got.count("# TYPE ") == len(set(got.split("# TYPE ")[1:]))


def test_prom_helpers_equal_jax():
    j = _jax()["srv"]
    for v in (0.0, -0.0, 1.0, 3.0, 2.5, 1e-07, 1e20, 1.5e300, float("nan"), float("inf"),
              float("-inf"), -7.0, 123456789.0, 0.1 + 0.2):
        assert obs_server._prom_num(v) == j._prom_num(v), v
    names = ["serve.latency_s2", 'serve.latency_s{tenant="a"}', "serve.latency_s",
             "a.b{x=\"1\"}", "a.b", "a.b_c", "a.b2", "A-b.c"]
    assert sorted(names, key=obs_server._prom_sort_key) == sorted(names, key=j._prom_sort_key)
    assert [obs_server._prom_name(n, "ns") for n in names] == [
        j._prom_name(n, "ns") for n in names]


# -- /statusz: byte for byte ------------------------------------------------------

STATUSZ_REPORT = {
    "train_step": 42.0,
    "heartbeat_age_s": {"serve": 0.25, "train": 1.5},
    "readiness": {"ok": False, "checks": {"serve": {"ok": False, "queue_depth": 9},
                                         "train": {"ok": True, "step": 42}}},
    "alerts": {"slo": {"serve_latency": {"firing": True, "fired_count": 2,
                                         "burns": {"60.0": 4.1}}}},
    "circuits": {"serve": 0.0, "tenant_b": 2.0},
    "program_caches": {"serve": {"hits": 4, "misses": 2}},
    "publication": {"serve.version.active": 7.0, "serve.version.previous": 6.0,
                    "serve.swaps_total": 3, "serve.rollbacks_total": 1,
                    "serve.swap_s.count": 3, "serve.swap_s.sum": 0.0042},
    "numerics": {"numerics.bn_mean_skew": {"count": 12, "max": 0.5}},
    "numerics_counters": {"numerics.samples": 12},
    "memory": {"mem.device.bytes_in_use": 4096.0, "mem.headroom_frac": 0.25},
    "memory_counters": {"mem.samples": 12},
    "compiles": {"compile.events_total": 3, "compile.storms": 1, "compile.train.events": 2},
    "autopilot": {"autopilot.compress_rung": 1.0, "autopilot.scan_k": 4.0,
                  "autopilot.actuations": 2, "autopilot.clamped": 1},
    "last_incident": {"id": "20260804T000000-h0-001-manual", "trigger": "manual",
                      "path": "/tmp/i.json"},
    "recorder_installed": True,
}
STATUSZ_GOLDEN = (
    "tpu_syncbn statusz\n"
    "==================\n"
    "train step: 42\n"
    "\n"
    "heartbeats (age s)\n"
    "  serve                0.25\n"
    "  train                1.5\n"
    "\n"
    "readiness: NOT READY\n"
    "  serve                FAIL {'queue_depth': 9}\n"
    "  train                ok  {'step': 42}\n"
    "\n"
    "alerts\n"
    "  slo/serve_latency        FIRING (fired 2x, burns {'60.0': 4.1})\n"
    "\n"
    "circuit breakers\n"
    "  serve                        closed (0)\n"
    "  tenant_b                     open (2)\n"
    "\n"
    "program caches\n"
    "  serve    hits=4 misses=2\n"
    "\n"
    "publication\n"
    "  serve.rollbacks_total                1\n"
    "  serve.swap_s.count                   3\n"
    "  serve.swap_s.sum                     0.0042\n"
    "  serve.swaps_total                    3\n"
    "  serve.version.active                 7\n"
    "  serve.version.previous               6\n"
    "\n"
    "numerics\n"
    "  numerics.bn_mean_skew                count=12 max=0.5\n"
    "  numerics.samples                     12\n"
    "\n"
    "memory\n"
    "  mem.device.bytes_in_use              4096\n"
    "  mem.headroom_frac                    0.25\n"
    "  mem.samples                          12\n"
    "\n"
    "compiles\n"
    "  compile.events_total                 3\n"
    "  compile.storms                       1\n"
    "  compile.train.events                 2\n"
    "\n"
    "autopilot\n"
    "  autopilot.actuations                 2\n"
    "  autopilot.clamped                    1\n"
    "  autopilot.compress_rung              1\n"
    "  autopilot.scan_k                     4\n"
    "\n"
    "last incident\n"
    "  id=20260804T000000-h0-001-manual trigger=manual\n"
    "  path=/tmp/i.json\n"
)


@pytest.mark.parametrize("report", ["golden", "empty", "no_recorder", "recorder_idle"])
def test_render_statusz_byte_for_byte(report):
    rep = {"golden": STATUSZ_REPORT, "empty": {},
           "no_recorder": {**STATUSZ_REPORT, "last_incident": None, "alerts": {},
                           "recorder_installed": False, "train_step": None},
           "recorder_idle": {**STATUSZ_REPORT, "last_incident": None,
                             "circuits": {"x": 1.0, "y": 5.0}}}[report]
    got = obs_server.render_statusz(rep)
    assert got == _jax()["srv"].render_statusz(rep)
    if report == "golden":
        assert got == STATUSZ_GOLDEN
    if report == "empty":
        for s in ("(none registered)", "(no SLO tracker attached)",
                  "(no weight swaps observed)", "(no numerics monitors published)",
                  "set TPU_SYNCBN_MEMWATCH=1", "(none observed)", "(no autopilot attached)",
                  "set TPU_SYNCBN_FLIGHTREC=1"):
            assert s in got, s


def _live_state(p):
    """The same process state in ``p``: series every statusz section reads,
    heartbeats, two readiness hooks and an attached, firing tracker."""
    tel = p["tel"]
    reg = tel.Registry()
    reg.gauge("train.step").set(17)
    reg.gauge("serve.circuit_state").set(0)
    reg.gauge("serve.circuit_state", labels={"family": "tenant_b"}).set(2)
    reg.gauge("serve.circuit_state.legacy").set(1)
    reg.counter("scan.program_cache.hits", labels={"family": "train"}).inc(5)
    reg.counter("scan.program_cache.misses", labels={"family": "train"}).inc(1)
    reg.counter("gan.program_cache.hits").inc(2)
    reg.gauge("serve.version", labels={"mode": "active"}).set(3)
    reg.gauge("serve.version.previous").set(2)
    reg.counter("serve.swaps_total").inc(4)
    reg.histogram("serve.swap_s").observe(0.01234)
    reg.histogram("numerics.bn_mean_skew").observe(0.25)
    reg.counter("numerics.samples").inc(9)
    reg.gauge("mem.used_frac").set(0.5)
    reg.counter("mem.samples").inc(3)
    reg.counter("compile.events_total").inc(2)
    reg.histogram("compile.time_s").observe(1.5)
    reg.gauge("autopilot.scan_k").set(4)
    p["srv"].HEARTBEATS.beat("train", now=100.0)
    p["srv"].HEARTBEATS.beat("serve", now=99.25)
    p["srv"].register_readiness("train", lambda: (True, {"step": 17}))
    p["srv"].register_readiness("gate", lambda: (False, {"why": "draining"}))
    agg = p["ts"].WindowedAggregator(reg, interval_s=1.0)
    agg.tick(now=0.0)
    for v in (0.5,) * 10:
        reg.histogram("step.time_s").observe(v)
    agg.tick(now=1.0)
    tracker = p["slo"].SLOTracker(agg, [p["slo"].AlertRule(
        "step_p99", "step.time_s p99 < 0.1", windows_s=(1e6,), clear_for=5)]).attach()
    tracker.evaluate(now=1.0)
    return reg


def test_statusz_report_equal_jax_on_the_same_state():
    jax = _jax()
    got = obs_server.statusz_report(registry=_live_state(PORT), now=101.0)
    want = jax["srv"].statusz_report(registry=_live_state(jax), now=101.0)
    assert got == want
    assert got["alerts"]["slo"]["step_p99"]["firing"] is True
    assert got["circuits"] == {"serve": 0.0, "tenant_b": 2.0, "legacy": 1.0}
    assert got["readiness"]["ok"] is False and got["last_incident"] is None
    assert obs_server.render_statusz(got) == jax["srv"].render_statusz(want)


# -- the pinned names ---------------------------------------------------------------


def test_monitor_metrics_equal_jax_and_each_produced():
    assert obs_server.MONITOR_METRICS == _jax()["srv"].MONITOR_METRICS == (
        "obs.server.requests", "obs.server.scrape_s", "obs.alert.fired",
        "obs.alert.resolved", "slo.evaluations", "monitor.heartbeat_age_s")
    telemetry.set_enabled(True)
    r = telemetry.Registry()
    agg = timeseries.WindowedAggregator(r, interval_s=1.0)
    agg.tick(now=0.0)
    for _ in range(100):
        r.histogram("serve.latency_s", buckets=(0.01, 1.0)).observe(0.5)
    agg.tick(now=1.0)
    tracker = obs_slo.SLOTracker(agg, [obs_slo.AlertRule(
        "latency", "serve.latency_s p99 < 0.05", windows_s=(2.0,), clear_for=1)])
    tracker.evaluate(now=1.0)  # obs.alert.fired + slo.evaluations
    for t in (2.0, 3.0):
        agg.tick(now=t)
    for _ in range(500):
        r.histogram("serve.latency_s", buckets=(0.01, 1.0)).observe(0.001)
    agg.tick(now=4.0)
    tracker.evaluate(now=4.0)  # obs.alert.resolved
    with _server(registry=r) as srv:
        assert _get(f"http://127.0.0.1:{srv.port}/metrics")[0] == 200
        assert _get(f"http://127.0.0.1:{srv.port}/healthz")[0] == 200
    snap = telemetry.validate_snapshot(telemetry.snapshot())
    produced = set(snap["counters"]) | set(snap["gauges"]) | set(snap["histograms"])
    assert set(obs_server.MONITOR_METRICS) <= produced


# -- the endpoints (the JAX suite's cases on the port) ------------------------------


def test_metrics_endpoint_serves_exposition_equal_to_render():
    r = _seeded_registry(telemetry)
    with _server(registry=r) as srv:
        status, text = _get(f"http://127.0.0.1:{srv.port}/metrics")
    assert status == 200 and text == obs_server.render_prometheus(r.snapshot())


def test_unknown_routes_404_with_route_list():
    with _server(registry=telemetry.Registry()) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        status, doc = _get(base + "/nope")
        assert status == 404 and "/metrics" in doc["routes"] and "/statusz" in doc["routes"]
        status, doc = _post(base + "/nope")
        assert status == 404 and doc["routes"] == ["POST /incidentz", "POST /profilez"]


def test_env_gate_off_means_no_server(monkeypatch):
    monkeypatch.delenv("TPU_SYNCBN_METRICS_PORT", raising=False)
    assert obs_server.start_from_env() is None and obs_server.active_server() is None


def test_env_gate_starts_once_and_is_shared(monkeypatch):
    monkeypatch.setenv("TPU_SYNCBN_METRICS_PORT", "0")
    srv = obs_server.start_from_env()
    assert srv is not None and srv.port > 0
    assert obs_server.start_from_env() is srv and obs_server.active_server() is srv
    assert _get(f"http://127.0.0.1:{srv.port}/healthz")[0] == 200
    obs_server.stop_env_server()
    assert obs_server.active_server() is None


def test_failed_bind_leaks_no_thread_and_env_start_logs(monkeypatch):
    with _server(registry=telemetry.Registry()) as taken:
        before = threading.active_count()
        with pytest.raises(OSError):
            obs_server.MonitoringServer(port=taken.port, host="127.0.0.1")
        assert threading.active_count() == before
        monkeypatch.setenv("TPU_SYNCBN_METRICS_PORT", str(taken.port))
        monkeypatch.setattr(obs_server, "MonitoringServer",
                            lambda port: obs_server.ThreadingHTTPServer(
                                ("127.0.0.1", port), obs_server._Handler))
        assert obs_server.start_from_env() is None  # logged, not raised
        assert threading.active_count() == before


def test_fresh_heartbeats_are_live():
    with _server(registry=telemetry.Registry(), max_age_s=60.0) as srv:
        obs_server.HEARTBEATS.beat("train")
        status, doc = _get(f"http://127.0.0.1:{srv.port}/healthz")
    assert status == 200 and doc["ok"] is True and "train" in doc["heartbeat_age_s"]


def test_stalled_heartbeat_flips_503_and_recovers():
    with _server(registry=telemetry.Registry(), max_age_s=0.05) as srv:
        obs_server.HEARTBEATS.beat("train")
        time.sleep(0.15)  # the stall
        status, doc = _get(f"http://127.0.0.1:{srv.port}/healthz")
        assert status == 503 and doc["ok"] is False and doc["stale"] == ["train"]
        obs_server.HEARTBEATS.beat("train")
        status2, doc2 = _get(f"http://127.0.0.1:{srv.port}/healthz")
    assert status2 == 200 and doc2["stale"] == []


def test_liveness_publishes_heartbeat_age_gauge_as_jax():
    j = _jax()
    for p in (PORT, j):
        p["tel"].set_enabled(True)
        p["srv"].HEARTBEATS.beat("train", now=0.0)
    srv = _server(registry=telemetry.Registry())
    jsrv = j["srv"].MonitoringServer(port=0, host="127.0.0.1", registry=j["tel"].Registry())
    try:
        assert srv.liveness(now=2.5) == jsrv.liveness(now=2.5)
        assert telemetry.REGISTRY.gauge("monitor.heartbeat_age_s").value == pytest.approx(2.5)
    finally:
        srv.close()
        jsrv.close()
    with pytest.raises(ValueError, match="max_age_s"):
        obs_server.MonitoringServer(port=0, max_age_s=0)


def test_readiness_hook_conjunction_and_fail_closed():
    obs_server.register_readiness("a", lambda: (True, {"x": 1}))
    obs_server.register_readiness("b", lambda: (True, {}))
    ok, checks = obs_server.evaluate_readiness()
    assert ok and checks["a"]["x"] == 1
    obs_server.register_readiness("b", lambda: (False, {"why": "nope"}))
    ok, checks = obs_server.evaluate_readiness()
    assert not ok and checks["b"]["why"] == "nope"

    def boom():
        raise RuntimeError("hook crashed")

    obs_server.register_readiness("b", boom)
    ok, checks = obs_server.evaluate_readiness()
    assert not ok and "RuntimeError" in checks["b"]["error"]
    obs_server.unregister_readiness("b")
    assert obs_server.evaluate_readiness()[0]


def test_readyz_endpoint_reflects_hooks():
    with _server(registry=telemetry.Registry()) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        obs_server.register_readiness("gate", lambda: (True, {}))
        status, doc = _get(base + "/readyz")
        assert status == 200 and doc["ok"] is True
        obs_server.register_readiness("gate", lambda: (False, {}))
        status, doc = _get(base + "/readyz")
    assert status == 503 and doc["checks"]["gate"]["ok"] is False


def test_statusz_endpoint_serves_live_state(tmp_path):
    telemetry.set_enabled(True)
    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path)))
    rec.trigger("manual", force=True)
    obs_server.HEARTBEATS.beat("train")
    with _server() as srv:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/statusz",
                                    timeout=HTTP_TIMEOUT_S) as resp:
            assert resp.status == 200 and "text/plain" in resp.headers["Content-Type"]
            text = resp.read().decode()
    assert text.startswith("tpu_syncbn statusz") and "train" in text
    assert rec.last_incident["id"] in text


def test_incidentz_post_dumps_a_bundle(tmp_path):
    from tpu_syncbn_torch.obs import incident

    with _server(registry=telemetry.Registry()) as srv:
        url = f"http://127.0.0.1:{srv.port}/incidentz"
        status, doc = _post(url)
        assert status == 503 and "TPU_SYNCBN_FLIGHTREC" in doc["error"]
        rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path)))
        status, doc = _post(url)
    assert status == 200 and doc["ok"] is True
    bundle = incident.load_bundle(doc["path"])
    assert bundle["incident_id"] == doc["incident_id"] == rec.last_incident["id"]
    assert bundle["trigger"]["kind"] == "manual"
    assert bundle["trigger"]["detail"] == {"source": "http", "client": "127.0.0.1"}


def test_profilez_post_on_the_cpu(tmp_path, monkeypatch):
    """Off without the knob (503), a bad duration is 400, and with the knob
    a capture from the handler's thread answers 200 (no CUDA here, so no
    hand-off) within its bound."""
    with _server(registry=telemetry.Registry()) as srv:
        base = f"http://127.0.0.1:{srv.port}/profilez"
        monkeypatch.delenv("TPU_SYNCBN_PROFILE_DIR", raising=False)
        status, doc = _post(base + "?duration_s=0.05")
        assert status == 503 and "TPU_SYNCBN_PROFILE_DIR" in doc["error"]
        monkeypatch.setenv("TPU_SYNCBN_PROFILE_DIR", str(tmp_path))
        assert _post(base + "?duration_s=abc")[0] == 400
        t0 = time.perf_counter()
        status, doc = _post(base + "?duration_s=0.05")
        assert time.perf_counter() - t0 < HTTP_TIMEOUT_S
    assert status == 200 and doc["ok"] is True and doc["duration_s"] == 0.05
    assert os.path.isfile(os.path.join(doc["path"], "trace.json"))


def _in_thread(fn):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", fn()), daemon=True)
    t.start()
    return t, out


def test_profilez_handoff_served_by_the_main_thread(tmp_path, monkeypatch):
    """The hand-off protocol on the CPU: a request posted from another
    thread waits in the slot; the main thread starts the capture at one
    boundary and stops it at the first boundary ``duration_s`` later; the
    request gets the capture's payload. A second request while the first
    waits is 503 at once."""
    monkeypatch.setenv("TPU_SYNCBN_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(profiling, "_needs_main_thread", lambda: True)
    t, out = _in_thread(lambda: profiling.serve_capture(0.1))
    deadline = time.monotonic() + HTTP_TIMEOUT_S
    while profiling._slot is None and time.monotonic() < deadline:
        time.sleep(0.001)
    busy = profiling.serve_capture(0.1)
    assert busy[0] == 503 and "already waiting" in busy[1]["error"]
    boundaries = 0
    while t.is_alive() and time.monotonic() < deadline:
        profiling.service_profile_request()  # a step boundary
        boundaries += 1
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()  # a "step"
        time.sleep(0.01)
    t.join(timeout=HTTP_TIMEOUT_S)
    code, payload = out["r"]
    assert code == 200 and payload["ok"] and payload["events"] > 0, payload
    assert boundaries >= 3 and profiling._slot is None
    assert not profiling._capture_lock.locked()


def test_profilez_handoff_without_a_loop_answers_503_within_its_bound(tmp_path,
                                                                        monkeypatch):
    monkeypatch.setenv("TPU_SYNCBN_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(profiling, "_needs_main_thread", lambda: True)
    monkeypatch.setattr(profiling, "HANDOFF_GRACE_S", 0.2)
    t0 = time.perf_counter()
    t, out = _in_thread(lambda: profiling.serve_capture(0.1))
    t.join(timeout=HTTP_TIMEOUT_S)
    waited = time.perf_counter() - t0
    code, payload = out["r"]
    assert code == 503 and "main thread" in payload["error"]
    assert 0.3 <= waited < 0.3 + 2.0
    assert profiling._slot is None and os.listdir(tmp_path) == []
    profiling.service_profile_request()  # a late boundary finds nothing to do
    assert not profiling._capture_lock.locked()


# -- ResilientLoop: readiness flips, the env-gated run, the /profilez slot ----------


class _Trainer:
    """``state_dict``/``load_state_dict``/``train_step`` with a scripted
    ``nonfinite`` metric — the divergence path's driver."""

    divergence_guard = "restore_last_good"

    def __init__(self, script, step_s=0.0):
        self._script = list(script)
        self._state = {"w": torch.zeros(2)}
        self._step_s = step_s

    def state_dict(self):
        return {k: v.clone() for k, v in self._state.items()}

    def load_state_dict(self, d):
        self._state = {k: torch.as_tensor(v).clone() for k, v in d.items()}

    def train_step(self, batch):
        if self._step_s:
            time.sleep(self._step_s)
        nonfinite = float(self._script.pop(0)) if self._script else 0.0

        class Out:
            loss = torch.tensor(0.1)
            metrics = {"nonfinite": torch.tensor(nonfinite)}
            monitors = {}

        return Out()


def test_divergence_rollback_flips_recovering_then_clears(tmp_path):
    trainer = _Trainer(script=[0.0, 1.0, 0.0, 0.0])
    loop = resilience.ResilientLoop(trainer, str(tmp_path), ckpt_every=1)
    seen = []

    def probe():
        while True:
            seen.append(loop.readiness())
            if len(seen) > 4:
                return
            yield torch.zeros(2)

    summary = loop.run(probe())
    assert summary["divergence_restores"] == 1
    assert any(not ok and d["recovering"] for ok, d in seen)
    ok, detail = loop.readiness()
    assert ok and not detail["recovering"]
    # the check's own record holds each verdict, the not-ready one included
    assert any(not r["ok"] and r["recovering"] for r in loop.readiness_log)
    assert loop.readiness_log[-1] == {"ok": True, **detail}


def test_loop_registers_train_hook_and_heartbeat(tmp_path):
    telemetry.set_enabled(True)
    trainer = _Trainer(script=[])
    trainer.divergence_guard = None
    loop = resilience.ResilientLoop(trainer, str(tmp_path), ckpt_every=100)
    during = []

    def probe():
        while True:
            ok, checks = obs_server.evaluate_readiness()
            during.append(("train" in checks, dict(obs_server.HEARTBEATS.ages())))
            if len(during) > 2:
                return
            yield torch.zeros(2)

    loop.run(probe())
    assert during[-1][0] is True and "train" in during[-1][1]
    assert telemetry.REGISTRY.gauge("train.step").value == 2
    assert "train" not in obs_server.evaluate_readiness()[1]


def test_preempted_loop_reports_not_ready(tmp_path):
    from tpu_syncbn_torch.testing import faults

    trainer = _Trainer(script=[])
    trainer.divergence_guard = None
    loop = resilience.ResilientLoop(trainer, str(tmp_path), ckpt_every=100)
    seen = []

    def probe():
        for _ in faults.signal_at(iter(range(6)), at_step=2, sig=signal.SIGTERM):
            seen.append(loop.readiness())
            yield torch.zeros(2)

    summary = loop.run(probe())
    assert summary["preempted"] is True
    assert any(not ok and d["preempted"] for ok, d in seen)


def test_training_run_answers_endpoints_mid_run(monkeypatch, tmp_path):
    """``TPU_SYNCBN_METRICS_PORT`` is the whole knob: the loop starts the
    server, which answers /metrics, /healthz, /readyz and /statusz from
    inside the step loop."""
    monkeypatch.setenv("TPU_SYNCBN_METRICS_PORT", "0")
    telemetry.set_enabled(True)
    trainer = _Trainer(script=[])
    trainer.divergence_guard = None
    loop = resilience.ResilientLoop(trainer, str(tmp_path), ckpt_every=100)
    probes = {}

    def batches():
        for i in range(3):
            if i == 2:
                srv = obs_server.active_server()
                assert srv is not None, "env gate did not start a server"
                base = f"http://127.0.0.1:{srv.port}"
                for name in ("metrics", "healthz", "readyz", "statusz"):
                    probes[name] = _get(f"{base}/{name}")
            yield torch.zeros(2)

    loop.run(batches())
    status, text = probes["metrics"]
    assert status == 200 and "# TYPE tpu_syncbn_train_step gauge" in text
    status, doc = probes["healthz"]
    assert status == 200 and doc["ok"] and "train" in doc["heartbeat_age_s"]
    status, doc = probes["readyz"]
    assert status == 200 and doc["checks"]["train"]["ok"]
    status, text = probes["statusz"]
    assert status == 200 and "train step: 2" in text


def test_resilient_loop_services_profilez_on_the_main_thread(monkeypatch, tmp_path):
    """A hand-off posted while the loop runs is captured between the loop's
    step boundaries and answered 200; the loop's exit closes nothing
    pending."""
    monkeypatch.setenv("TPU_SYNCBN_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setattr(profiling, "_needs_main_thread", lambda: True)
    trainer = _Trainer(script=[], step_s=0.01)
    trainer.divergence_guard = None
    loop = resilience.ResilientLoop(trainer, str(tmp_path / "ck"), ckpt_every=1000)
    started = {}

    def batches():
        for i in range(60):
            if i == 2:
                started["t"] = _in_thread(lambda: profiling.serve_capture(0.1))
            if i > 2 and not started["t"][0].is_alive():
                return
            yield torch.zeros(2)

    loop.run(batches())
    t, out = started["t"]
    t.join(timeout=HTTP_TIMEOUT_S)
    code, payload = out["r"]
    assert code == 200 and payload["events"] > 0, payload
    assert profiling._slot is None and not profiling._capture_lock.locked()


# -- the serving half of readiness (JAX's TestServeReadinessFlips and
# -- TestEnvGatedRuns.test_serving_run_answers_endpoints) -------------------


class _StubEngine:
    """Duck-typed engine with a blockable predict, so overload is
    deterministic."""

    def __init__(self, bucket=4, release=None):
        self.max_bucket = bucket
        self._release = release

    def bucket_for(self, n):
        return self.max_bucket

    def predict(self, b):
        if self._release is not None:
            assert self._release.wait(timeout=30)
        return np.asarray(b) * 2.0


def _item(v, n=1):
    return np.full((n, 1), v, np.float32)


def test_serve_queue_overload_flips_not_ready_then_recovers():
    """Queue depth >= ``ready_depth`` flips the serve hook before
    queue-full rejection starts shedding, and drains back to ready."""
    from tpu_syncbn_torch import serve

    release = threading.Event()
    bat = serve.DynamicBatcher(_StubEngine(bucket=2, release=release), max_batch=2,
                               max_wait_ms=1, max_queue=8, ready_depth=3)
    try:
        ok, detail = bat.readiness()
        assert ok and detail["queue_depth"] < 3
        futs = [bat.submit(_item(i)) for i in range(6)]
        deadline = time.monotonic() + 5
        while bat._q.qsize() < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        ok, detail = bat.readiness()
        assert not ok and detail["queue_depth"] >= 3
        release.set()
        for f in futs:
            f.result(timeout=HTTP_TIMEOUT_S)
        ok, _ = bat.readiness()
        assert ok
    finally:
        release.set()
        bat.close()


def test_serve_preemption_drain_flips_readyz_on_the_wire():
    """A serving process answers ``/readyz`` 200, then SIGUSR1-shaped
    preemption flips it 503 while admitted requests still drain; close()
    removes the hook."""
    from tpu_syncbn_torch import serve

    with _server() as srv:
        base = f"http://127.0.0.1:{srv.port}"
        with resilience.PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
            bat = serve.DynamicBatcher(_StubEngine(bucket=4), max_batch=4, max_wait_ms=5,
                                       max_queue=16, guard=g)
            status, doc = _get(base + "/readyz")
            assert status == 200 and doc["checks"]["serve"]["ok"]
            futs = [bat.submit(_item(i)) for i in range(4)]
            os.kill(os.getpid(), signal.SIGUSR1)
            assert g.preempted
            status, doc = _get(base + "/readyz")
            assert status == 503
            assert doc["checks"]["serve"]["draining"] is True
            for i, f in enumerate(futs):
                assert float(f.result(timeout=HTTP_TIMEOUT_S)[0, 0]) == 2.0 * i
            bat.close()
        _, doc = _get(base + "/readyz")
        assert "serve" not in doc["checks"]


def test_serve_collector_heartbeat_feeds_healthz():
    from tpu_syncbn_torch import serve

    bat = serve.DynamicBatcher(_StubEngine(bucket=4), max_batch=4, max_wait_ms=5,
                               max_queue=16)
    try:
        deadline = time.monotonic() + 5
        while "serve" not in obs_server.HEARTBEATS.ages() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert "serve" in obs_server.HEARTBEATS.ages()
    finally:
        bat.close()
    assert "serve" not in obs_server.HEARTBEATS.ages()


def test_serve_engine_health_rides_readiness_detail():
    from tpu_syncbn_torch import serve

    class Healthy(_StubEngine):
        def health(self):
            return {"buckets": [4], "programs_live": 1, "programs_compiled": 1}

    with serve.DynamicBatcher(Healthy(bucket=4), max_batch=4, max_wait_ms=5,
                              max_queue=16) as bat:
        _, detail = bat.readiness()
    assert detail["engine"]["programs_live"] == 1


def test_serving_run_answers_endpoints(monkeypatch):
    """``TPU_SYNCBN_METRICS_PORT=0``: the batcher starts the server; its
    ``/metrics`` counts the requests, ``/readyz`` carries the serve hook
    and ``/healthz`` the collector's heartbeat — the same exposition line
    as JAX's."""
    from tpu_syncbn_torch import serve

    monkeypatch.setenv("TPU_SYNCBN_METRICS_PORT", "0")
    telemetry.set_enabled(True)
    bat = serve.DynamicBatcher(_StubEngine(bucket=4), max_batch=4, max_wait_ms=5,
                               max_queue=16)
    try:
        srv = obs_server.active_server()
        assert srv is not None, "env gate did not start a server"
        base = f"http://127.0.0.1:{srv.port}"
        for f in [bat.submit(_item(i)) for i in range(4)]:
            f.result(timeout=HTTP_TIMEOUT_S)
        status, text = _get(base + "/metrics")
        assert status == 200
        assert "tpu_syncbn_serve_requests_total 4" in text
        status, doc = _get(base + "/readyz")
        assert status == 200 and doc["checks"]["serve"]["ok"]
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            status, doc = _get(base + "/healthz")
            if doc["ok"] and "serve" in doc["heartbeat_age_s"]:
                break
            time.sleep(0.01)
        assert status == 200 and "serve" in doc["heartbeat_age_s"]
    finally:
        bat.close()
