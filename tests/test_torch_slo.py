"""The port's SLO layer (``tpu_syncbn_torch.obs.slo`` and the rule sets
beside their producers) against the JAX package's (``tpu_syncbn.obs.slo``):
the same objective specs parse to the same objectives or the same errors;
every rule set, ``standard_rules`` included, is equal field by field; and
the same seeded windowed series, ticked on an explicit clock into each
package's registry and aggregator, drive each package's ``SLOTracker``
through fire, hold and resolve (``clear_for`` hysteresis) with equal
evaluation results, states, burn gauges, ``obs.alert.*`` counters and
trace instants — both sides run the same Python float arithmetic, so the
tolerance is equality. Plus the JAX suite's own ``TestSLO`` cases on the
port, the ``slo_alert`` trigger's bundle with ``state.alerts`` filled,
and the readiness wiring of ``attach``/``detach``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from tpu_syncbn_torch.obs import flightrec, incident, server as obs_server
from tpu_syncbn_torch.obs import slo as obs_slo
from tpu_syncbn_torch.obs import telemetry, timeseries, tracing


def _jax():
    from tpu_syncbn.obs import flightrec as jfr, incident as jinc
    from tpu_syncbn.obs import server as jsrv, slo as jslo
    from tpu_syncbn.obs import telemetry as jtel, timeseries as jts, tracing as jtr

    return dict(fr=jfr, inc=jinc, srv=jsrv, slo=jslo, tel=jtel, ts=jts, tr=jtr)


PORT = dict(fr=flightrec, inc=incident, srv=obs_server, slo=obs_slo, tel=telemetry,
            ts=timeseries, tr=tracing)


@pytest.fixture(autouse=True)
def _clean():
    """Both packages: telemetry at its default, empty registries, no
    tracer, recorder, heartbeat, readiness hook or attached tracker."""
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

    reset()
    yield
    reset()


# -- parsing ------------------------------------------------------------------

ACCEPTED = ["serve.latency_s p99 < 0.25", "step.time_s p50 < 2", "step.time_s p99.9 < 1e-3",
            "numerics.bn_mean_skew p99 < 4.0", 'serve.latency_s{tenant="a"} p99 < 0.25',
            'serve.latency_s{tenant="a",zone="b"} p95 < 1.5E+1', "  a.b_c p1 <3  "]
REJECTED = ["serve.latency_s p99 > 0.25", "latency p99 < 1", "serve.latency_s < 0.25", "",
            "serve.latency_s{} p99 < 0.25", "serve.latency_s{tenant} p99 < 0.25",
            "serve.latency_s p100 < 1", "serve.latency_s p99 < 0", "Serve.Latency p99 < 1",
            "serve.latency_s p99 < -1"]


@pytest.mark.parametrize("spec", ACCEPTED)
def test_parse_objective_accepts_as_jax(spec):
    got = obs_slo.parse_objective(spec)
    want = _jax()["slo"].parse_objective(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe() and got.budget == want.budget
    assert obs_slo.objective_labels(got) == _jax()["slo"].objective_labels(want)


def _error(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("spec", REJECTED)
def test_parse_objective_rejects_as_jax(spec):
    got = _error(obs_slo.parse_objective, spec)
    assert got is not None and got == _error(_jax()["slo"].parse_objective, spec)


def test_objective_shapes_and_validation_as_jax():
    j = _jax()["slo"]
    for cls, kw in (("Availability", dict(good="a.ok", bad="a.bad", target=0.999)),
                    ("SubsetRate", dict(total='s.req{t="b"}', bad='s.miss{t="b"}',
                                        target=0.9))):
        got, want = getattr(obs_slo, cls)(**kw), getattr(j, cls)(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.describe(), got.budget) == (want.describe(), want.budget)
        assert obs_slo.objective_labels(got) == j.objective_labels(want)
        for target in (0.0, 1.0, 1.5):
            msg = _error(getattr(obs_slo, cls), **{**kw, "target": target})
            assert msg and msg == _error(getattr(j, cls), **{**kw, "target": target})
    for q, thr in ((0.0, 1.0), (1.0, 1.0), (0.5, 0.0)):
        msg = _error(obs_slo.LatencyObjective, "a.b", q, thr)
        assert msg and msg == _error(j.LatencyObjective, "a.b", q, thr)


# -- rule sets ----------------------------------------------------------------


def _fields(rule) -> tuple:
    obj = rule.objective
    return (rule.name, type(obj).__name__, tuple(sorted(dataclasses.asdict(obj).items())),
            tuple(rule.windows_s), rule.burn_threshold, rule.clear_threshold,
            rule.clear_for)


def _rule_sets(p):
    from importlib import import_module

    base = "tpu_syncbn_torch.obs" if p is PORT else "tpu_syncbn.obs"
    num, mem, prof = (import_module(f"{base}.{m}") for m in ("numerics", "memwatch",
                                                              "profiling"))
    slo = p["slo"]
    return {
        "numerics": num.numerics_rules(),
        "numerics_tuned": num.numerics_rules(clip_target=0.9, windows_s=(10, 20),
                                             skew_slo="numerics.bn_mean_skew p95 < 2"),
        "mem": mem.mem_rules(),
        "mem_tuned": mem.mem_rules(pressure_slo="mem.used_frac p90 < 0.8",
                                   burn_threshold=3.0),
        "compile": prof.compile_rules(),
        "compile_serve": prof.compile_rules(total="serve.requests", target=0.999),
        "serve": slo.serve_overload_rules(),
        "serve_tuned": slo.serve_overload_rules(latency_slo="serve.latency_s p95 < 0.1",
                                                miss_target=0.99),
        "publication": slo.publication_rules(),
        "standard": slo.standard_rules(),
        "standard_some": slo.standard_rules(("mem", "serve"),
                                            serve={"burn_threshold": 4.0}),
        "standard_one": slo.standard_rules(("numerics",),
                                           numerics={"clip_target": 0.9}),
    }


@pytest.mark.parametrize("which", ["numerics", "numerics_tuned", "mem", "mem_tuned",
                                   "compile", "compile_serve", "serve", "serve_tuned",
                                   "publication", "standard", "standard_some",
                                   "standard_one"])
def test_rule_sets_equal_field_by_field(which):
    got = [_fields(r) for r in _rule_sets(PORT)[which]]
    want = [_fields(r) for r in _rule_sets(_jax())[which]]
    assert got == want and got


def test_standard_rules_families_and_refusals_as_jax():
    j = _jax()["slo"]
    assert obs_slo.STANDARD_RULE_FAMILIES == j.STANDARD_RULE_FAMILIES
    names = [r.name for r in obs_slo.standard_rules()]
    assert names == ["numerics_residual", "numerics_skew", "numerics_clip", "mem_pressure",
                     "recompile_storm", "serve_latency", "serve_overload",
                     "publication_rollbacks"]
    for args, kw in ((("nope",), {}), (("mem",), {"serve": {}})):
        msg = _error(obs_slo.standard_rules, args, **kw)
        assert msg and msg == _error(j.standard_rules, args, **kw)


@pytest.mark.parametrize("bad", [dict(name="Bad Name"), dict(windows_s=()),
                                 dict(windows_s=(0.0,)), dict(burn_threshold=0.0),
                                 dict(clear_for=0)])
def test_rule_validation_as_jax(bad):
    kw = {"name": "r", "objective": "serve.latency_s p99 < 1", **bad}
    msg = _error(obs_slo.AlertRule, **kw)
    assert msg and msg == _error(_jax()["slo"].AlertRule, **kw)


# -- the tracker through fire, hold and resolve --------------------------------

#: the injected clock and, per tick, the share of slow observations: hot,
#: hot, one cool tick (hysteresis holds), hot again, then cool until the
#: rules resolve, a quiet stretch with no data, and a late second burst
CLOCK = [float(t) for t in range(1, 21)]
SLOW = [0.3, 0.25, 0.0, 0.3, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, None, None, None, None,
        0.5, 0.5, 0.0, 0.0, 0.0, 0.0]


def _tracker_run(p):
    """The seeded series through ``p``'s registry, aggregator and tracker;
    returns every evaluation, the states, the registry and the trace's
    instants."""
    tel, ts, slo = p["tel"], p["ts"], p["slo"]
    tel.set_enabled(True)
    tracer = p["tr"].install()
    reg = tel.Registry()
    agg = ts.WindowedAggregator(reg, interval_s=1.0, capacity=30)
    rng = np.random.RandomState(3)
    rules = [
        slo.AlertRule("latency", "serve.latency_s p99 < 0.05", windows_s=(2.0, 4.0),
                      burn_threshold=2.0, clear_for=2),
        slo.AlertRule("latency_fast", "serve.latency_s p90 < 0.05", windows_s=(1.0,),
                      burn_threshold=1.5, clear_threshold=0.2, clear_for=3),
        slo.AlertRule("tenant_a", 'serve.latency_s{tenant="a"} p99 < 0.05',
                      windows_s=(3.0,), burn_threshold=2.0, clear_for=1),
        slo.AlertRule("avail", slo.Availability(good="serve.requests", bad="serve.rejected",
                                                target=0.99), windows_s=(2.0,)),
        slo.AlertRule("misses", slo.SubsetRate(total="serve.requests",
                                               bad="serve.deadline_miss_total",
                                               target=0.95), windows_s=(1.0, 5.0)),
    ]
    tracker = slo.SLOTracker(agg, rules)
    agg.tick(now=0.0)
    evaluations = []
    for t, frac in zip(CLOCK, SLOW):
        if frac is not None:
            n_slow = int(round(100 * frac))
            for v in rng.uniform(0.1, 0.9, size=n_slow):
                reg.histogram("serve.latency_s", buckets=(0.05, 1.0)).observe(float(v))
            for v in rng.uniform(0.0, 0.05, size=100 - n_slow):
                reg.histogram("serve.latency_s", buckets=(0.05, 1.0)).observe(float(v))
            n_a = int(round(20 * frac))
            for v in np.concatenate([rng.uniform(0.1, 0.9, size=n_a),
                                     rng.uniform(0.0, 0.05, size=20 - n_a)]):
                reg.histogram("serve.latency_s", buckets=(0.05, 1.0),
                              labels={"tenant": "a"}).observe(float(v))
            reg.counter("serve.requests").inc(100)
            reg.counter("serve.rejected").inc(n_slow // 4)
            reg.counter("serve.deadline_miss_total").inc(n_slow // 2)
        agg.tick(now=t)
        evaluations.append(tracker.evaluate(now=t))
        evaluations.append(tracker.evaluate(now=t))  # a second pass: hysteresis
    instants = [(e["name"], e.get("args", {}).get("rule")) for e in tracer.events
                if e.get("ph") == "i"]
    p["tr"].uninstall()
    return evaluations, tracker.state(), tracker.firing(), tel.snapshot(), instants


@pytest.fixture(scope="module")
def tracked():
    return _tracker_run(PORT), _tracker_run(_jax())


def test_tracker_evaluations_equal_jax(tracked):
    (got, *_), (want, *_) = tracked
    assert got == want
    firing = [{n for n, r in e.items() if r["firing"]} for e in got]
    # every rule fires at some point, and each firing one resolves later
    assert set().union(*firing) == {"latency", "latency_fast", "tenant_a", "avail", "misses"}
    assert not firing[-1]


def test_tracker_hysteresis_holds_then_resolves(tracked):
    """``latency`` (clear_for 2) stays firing through the cool tick at t = 3
    and resolves only on a second consecutive cool evaluation."""
    (got, *_), _ = tracked
    seq = [e["latency"]["firing"] for e in got]
    assert seq[0] and seq[5]  # hot at t = 1, still firing over the cool t = 3
    first_off = seq.index(False)
    assert first_off > 5 and not seq[first_off + 1]


def test_tracker_states_gauges_counters_and_instants_equal_jax(tracked):
    (_, s1, f1, snap1, i1), (_, s2, f2, snap2, i2) = tracked
    assert s1 == s2 and f1 == f2
    for kind in ("counters", "gauges"):
        assert snap1[kind] == snap2[kind], kind
    assert snap1["counters"]["slo.evaluations"] == 2 * len(CLOCK)
    assert snap1["counters"]["obs.alert.fired"] >= 5
    assert snap1["counters"]["obs.alert.resolved"] >= 5
    assert 'slo.tenant_a.burn_rate{tenant="a"}' in snap1["gauges"]
    assert i1 == i2 and ("slo_alert_fired", "latency") in i1
    assert ("slo_alert_resolved", "latency") in i1


# -- the JAX suite's TestSLO cases on the port ----------------------------------


def _hot_agg(frac_slow=0.1):
    r = telemetry.Registry()
    agg = timeseries.WindowedAggregator(r, interval_s=1.0)
    agg.tick(now=0.0)
    h = r.histogram("serve.latency_s", buckets=(0.05, 1.0))
    n_slow = int(100 * frac_slow)
    for _ in range(100 - n_slow):
        h.observe(0.01)
    for _ in range(n_slow):
        h.observe(0.5)
    r.counter("serve.requests").inc(95)
    r.counter("serve.rejected").inc(5)
    agg.tick(now=1.0)
    return r, agg


def test_per_tenant_burn_isolation():
    telemetry.set_enabled(True)
    r = telemetry.Registry()
    agg = timeseries.WindowedAggregator(r, interval_s=1.0)
    agg.tick(now=0.0)
    ha = r.histogram("serve.latency_s", buckets=(0.05, 1.0), labels={"tenant": "a"})
    hb = r.histogram("serve.latency_s", buckets=(0.05, 1.0), labels={"tenant": "b"})
    for _ in range(90):
        ha.observe(0.5)
    for _ in range(10):
        ha.observe(0.01)
    for _ in range(100):
        hb.observe(0.01)
    agg.tick(now=1.0)
    tracker = obs_slo.SLOTracker(agg, [
        obs_slo.AlertRule(f"lat_{t}", f'serve.latency_s{{tenant="{t}"}} p99 < 0.05',
                          windows_s=(2.0,), burn_threshold=2.0) for t in ("a", "b")])
    out = tracker.evaluate(now=1.0)
    assert out["lat_a"]["firing"] is True and out["lat_b"]["firing"] is False
    snap = telemetry.snapshot()
    assert snap["gauges"]['slo.lat_a.burn_rate{tenant="a"}'] > 2.0
    assert snap["gauges"]['slo.lat_b.burn_rate{tenant="b"}'] <= 2.0
    assert snap["counters"]["obs.alert.fired"] == 1


def test_availability_objective_from_counters():
    _, agg = _hot_agg()
    obj = obs_slo.Availability(good="serve.requests", bad="serve.rejected", target=0.99)
    assert obj.error_rate(agg, 2.0, now=1.0) == pytest.approx(0.05)
    tracker = obs_slo.SLOTracker(agg, [obs_slo.AlertRule("avail", obj, windows_s=(2.0,),
                                                         burn_threshold=2.0)])
    assert tracker.evaluate(now=1.0)["avail"]["firing"] is True


def test_no_data_means_no_alert():
    agg = timeseries.WindowedAggregator(telemetry.Registry(), interval_s=1.0)
    tracker = obs_slo.SLOTracker(agg, [obs_slo.AlertRule(
        "latency", "serve.latency_s p99 < 0.05", windows_s=(1.0,))])
    out = tracker.evaluate(now=1.0)
    assert out["latency"]["firing"] is False and out["latency"]["burns"]["1.0"] is None


def test_duplicate_rule_names_refused():
    with pytest.raises(ValueError, match="duplicate"):
        obs_slo.SLOTracker(None, [obs_slo.AlertRule("r", "serve.latency_s p99 < 1"),
                                  obs_slo.AlertRule("r", "serve.latency_s p50 < 1")])


def test_attach_feeds_readyz_and_tracker_states_then_detach():
    _, agg = _hot_agg(frac_slow=0.2)
    tracker = obs_slo.SLOTracker(agg, [obs_slo.AlertRule(
        "latency", "serve.latency_s p99 < 0.05", windows_s=(1e6,), burn_threshold=2.0,
        clear_for=1)]).attach()
    ok, checks = obs_server.evaluate_readiness()
    assert not ok and checks["slo"]["firing"] == ["latency"]
    states = obs_slo.tracker_states()
    assert states["slo"]["latency"]["firing"] is True
    assert states["slo"]["latency"]["fired_count"] == 1
    tracker.detach()
    assert obs_slo.tracker_states() == {} and obs_server.evaluate_readiness() == (True, {})


# -- firing dumps an slo_alert bundle -------------------------------------------


def _slo_alert_bundle(p, d):
    """A tracker attached under ``"slo"`` fires over ``p``'s recorder: the
    one bundle it dumps, loaded through ``p``'s validator."""
    p["tel"].set_enabled(True)
    rec = p["fr"].install(p["fr"].FlightRecorder(incident_dir=d, cooldown_s=0.0))
    reg = p["tel"].Registry()
    agg = p["ts"].WindowedAggregator(reg, interval_s=1.0)
    agg.tick(now=0.0)
    for v in (0.01,) * 80 + (0.5,) * 20:
        reg.histogram("serve.latency_s", buckets=(0.05, 1.0),
                      labels={"tenant": "a"}).observe(v)
    agg.tick(now=1.0)
    tracker = p["slo"].SLOTracker(agg, [p["slo"].AlertRule(
        "tenant_latency", 'serve.latency_s{tenant="a"} p99 < 0.05', windows_s=(2.0,),
        clear_for=3)]).attach()  # the dump's own probe evaluates on the wall clock
    try:
        tracker.evaluate(now=1.0)
        tracker.evaluate(now=1.0)  # still firing: no second bundle
    finally:
        tracker.detach()
        p["fr"].uninstall()
        rec.close()
    names = sorted(n for n in os.listdir(d) if n.endswith(".json"))
    return [p["inc"].load_bundle(os.path.join(d, n)) for n in names]


def test_firing_dumps_one_slo_alert_bundle_as_jax(tmp_path):
    got = _slo_alert_bundle(PORT, str(tmp_path / "port"))
    want = _slo_alert_bundle(_jax(), str(tmp_path / "jax"))
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert g["trigger"] == w["trigger"] == {"kind": "slo_alert", "detail": {
        "rule": "tenant_latency", "burn": 20.0,
        "objective": 'serve.latency_s{tenant="a"} p99 < 0.05'}}
    assert g["state"]["alerts"] == w["state"]["alerts"]
    alert = g["state"]["alerts"]["slo"]["tenant_latency"]
    assert alert["firing"] is True and alert["fired_count"] == 1
    # the readiness probe inside the dump re-entered evaluate() without a
    # deadlock, and saw the alert
    assert g["state"]["readiness"]["checks"]["slo"]["firing"] == ["tenant_latency"]
    # each package's validator takes the other's bundle
    incident.validate_bundle(json.loads(json.dumps(w)))
    _jax()["inc"].validate_bundle(json.loads(json.dumps(g)))
