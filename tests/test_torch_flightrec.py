"""The port's flight recorder and incident bundles
(``tpu_syncbn_torch.obs.flightrec`` / ``incident`` / ``server``) against
the JAX package's (``tpu_syncbn.obs``):

* the trigger matrix the port wires — ``divergence_restore``,
  ``watchdog_stall`` (a step watchdog and a data stall),
  ``numerics_drift``, ``mem_pressure``, ``recompile_storm`` and ``manual``
  (a direct call and the signal) — each yields exactly one bundle that
  passes the port's ``validate_bundle`` and the JAX package's; a JAX
  bundle passes the port's; one port and one JAX bundle merge through
  both packages' ``merge_bundles`` to the same summary;
* the step ring records a small ``DataParallel`` (through
  ``ResilientLoop``, eager and K = 2 chunks) and a ``GANTrainer`` (eager
  and ``train_steps``) on the CPU, its values equal to the step outputs;
  a CUDA entry's host copy reads ``"pending"`` until its marker lands
  (a stand-in here; the real copy is in tests/test_torch_gpu.py); CPU
  values scalarize as the JAX recorder's do;
* the trigger discipline of tests/test_incident.py: cooldown and
  ``suppressed``, a re-entrant trigger dropped, a failed dump that does
  not spend the cooldown, pruning; no allocation without a recorder
  (``tracemalloc``);
* ``attribution`` / ``diff_attribution`` equal to JAX's on the same
  bundle dicts with explicit rates; the CLI; the heartbeat and readiness
  a running loop leaves in its bundles.
"""

import glob
import json
import os
import signal
import time
import tracemalloc

import numpy as np
import pytest
import torch

from tpu_syncbn_torch.obs import (
    flightrec,
    incident,
    memwatch,
    numerics,
    profiling,
    server as obs_server,
    telemetry,
    tracing,
)
from tpu_syncbn_torch.parallel import scan_driver
from tpu_syncbn_torch.runtime import resilience
from tpu_syncbn_torch.utils import checkpoint as ckpt


def _jax_obs():
    from tpu_syncbn.obs import (flightrec as jfr, incident as jinc, numerics as jnum,
                                server as jsrv, telemetry as jtel, tracing as jtr)

    return jfr, jinc, jnum, jsrv, jtel, jtr


@pytest.fixture(autouse=True)
def clean_obs():
    """No recorder, sampler, tracer, heartbeat or readiness hook in either
    package, empty registries, a default storm detector; telemetry on."""
    jfr, _, _, jsrv, jtel, jtr = _jax_obs()

    def reset():
        for fr, srv, tel, tr in ((flightrec, obs_server, telemetry, tracing),
                                 (jfr, jsrv, jtel, jtr)):
            rec = fr.uninstall()
            if rec is not None:
                rec.close()
            tr.uninstall()
            srv.HEARTBEATS.clear()
            with srv._readiness_lock:
                srv._readiness.clear()
            tel.REGISTRY.reset()
        sampler = memwatch.uninstall()
        if sampler is not None:
            sampler.close()
        profiling.set_detector(None)

    reset()
    for tel in (telemetry, jtel):
        tel.set_enabled(True)
    yield
    reset()
    for tel in (telemetry, jtel):
        tel.set_enabled(None)


def _install(tmp_path, **kw) -> flightrec.FlightRecorder:
    kw.setdefault("incident_dir", str(tmp_path / "incidents"))
    return flightrec.install(flightrec.FlightRecorder(**kw))


def _bundles(rec) -> list:
    return sorted(glob.glob(os.path.join(rec.incident_dir, "incident_*.json")))


def _one_valid_bundle(rec, kind, *, min_ring_steps=0) -> dict:
    """Exactly one bundle, valid under both packages' schema gates, with
    its trace slice loadable and the ring data from before the trigger."""
    _, jinc, _, _, _, jtr = _jax_obs()
    paths = _bundles(rec)
    assert len(paths) == 1, f"expected 1 bundle for {kind}, got {paths}"
    bundle = incident.load_bundle(paths[0])
    jinc.validate_bundle(json.loads(json.dumps(bundle)))
    assert bundle["trigger"]["kind"] == kind
    tracing.validate_trace(bundle["trace"]["traceEvents"])
    jtr.validate_trace(bundle["trace"]["traceEvents"])
    assert len(bundle["rings"]["steps"]) >= min_ring_steps
    assert set(bundle["rings"]) == {"steps", "serve", "mem", "compile", "autopilot"}
    return bundle


def _prefill(n=3):
    for i in range(n):
        flightrec.record_step(i + 1, metrics={"loss": torch.tensor(0.1 * (i + 1))})


class _StubTrainer:
    def __init__(self):
        self.state = {"w": torch.zeros(2)}
        self.loads = 0

    def state_dict(self):
        return self.state

    def load_state_dict(self, state):
        self.state = state
        self.loads += 1


# -- the trigger matrix ----------------------------------------------------------


def _fire_divergence_restore(tmp_path):
    trainer = _StubTrainer()
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 3, {"w": torch.ones(2)})
    loop = resilience.ResilientLoop(trainer, d)
    loop.step = 7
    loop._restore_last_good()
    assert loop.step == 3 and trainer.loads == 1 and loop.recovering
    assert loop.readiness()[0] is False
    return {"step": 7, "restored_step": 3}


def _wait_for_bundle(rec, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not _bundles(rec) and time.monotonic() < deadline:
        time.sleep(0.01)


def _fire_watchdog(tmp_path, rec):
    with resilience.Watchdog(0.05, name="t-stall", poll_s=0.01):
        _wait_for_bundle(rec)
    return {"watchdog": "t-stall", "deadline_s": 0.05}


def _fire_data_stall(tmp_path, rec):
    import threading

    gate = threading.Event()

    def slow():
        gate.wait(5)
        yield 1

    with pytest.raises(resilience.StallError):
        list(resilience.stall_guard(slow(), 0.05, name="data"))
    gate.set()
    return {"source": "data", "stall": "data_fetch", "deadline_s": 0.05}


def _fire_numerics_drift(tmp_path, rec):
    pub = numerics.NumericsPublisher(thresholds={"bn_mean_skew": 1.0})
    pub.publish(9, {"bn_mean_skew": torch.tensor(5.0), "bn_var_skew": torch.tensor(0.1)})
    return {"monitor": "bn_mean_skew", "value": 5.0, "threshold": 1.0, "step": 9}


def _fire_mem_pressure(tmp_path, rec):
    s = memwatch.MemorySampler(device_reader=lambda: None,
                               host_reader=lambda cap: {"rss_bytes": 500_000},
                               contract_bytes_per_device=10_000_000)
    s.sample()
    s.set_contract(100_000, source="test_drill")
    for _ in range(3):  # stays hot: the cooldown absorbs the repeats
        s.sample()
    return {"used_frac": 5.0, "contract_source": "test_drill"}


def _fire_recompile_storm(tmp_path, rec):
    profiling.set_detector(profiling.RecompileDetector(window_s=3600.0, threshold=4))
    cache = scan_driver.ProgramCache(name="gan", max_entries=2)
    for i in range(10):  # 3 keys through 2 slots: every call a rebuild
        scan_driver.cached_program(cache, i % 3, lambda: object())
    return {"family": "gan", "compiles": 4}


def _fire_manual(tmp_path, rec):
    assert flightrec.trigger("manual", {"source": "test"}, force=True) is not None
    return {"source": "test"}


def _fire_signal(tmp_path, rec):
    prev = flightrec.install_signal_trigger(signal.SIGUSR2)
    try:
        os.kill(os.getpid(), signal.SIGUSR2)
        _wait_for_bundle(rec)
    finally:
        signal.signal(signal.SIGUSR2, prev)
    return {"source": "signal"}


MATRIX = {
    "divergence_restore": ("divergence_restore", lambda p, r: _fire_divergence_restore(p)),
    "watchdog": ("watchdog_stall", _fire_watchdog),
    "data_stall": ("watchdog_stall", _fire_data_stall),
    "numerics_drift": ("numerics_drift", _fire_numerics_drift),
    "mem_pressure": ("mem_pressure", _fire_mem_pressure),
    "recompile_storm": ("recompile_storm", _fire_recompile_storm),
    "manual": ("manual", _fire_manual),
    "signal": ("manual", _fire_signal),
}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_each_wired_trigger_yields_one_bundle_valid_in_both_packages(case, tmp_path):
    kind, fire = MATRIX[case]
    rec = _install(tmp_path)
    _prefill()
    want = fire(tmp_path, rec)
    bundle = _one_valid_bundle(rec, kind, min_ring_steps=3)
    assert kind in incident.TRIGGER_KINDS
    detail = bundle["trigger"]["detail"]
    assert {k: detail[k] for k in want} == want
    assert [e["metrics"]["loss"] for e in bundle["rings"]["steps"]] == \
        [float(torch.tensor(0.1 * i)) for i in (1, 2, 3)]
    # the port's audit goldens (tpu_syncbn_torch/audit/goldens/)
    assert bundle["contract"]["fingerprint"] == incident.contract_fingerprint(
        os.path.join(os.path.dirname(incident.__file__), "..", "audit", "goldens"))
    assert bundle["contract"]["fingerprint"]["programs"] == 23
    assert bundle["state"]["alerts"] == {}
    if case == "mem_pressure":
        assert [e["used_frac"] for e in bundle["rings"]["mem"]][:2] == [0.05, 5.0]
        assert telemetry.snapshot()["counters"]["mem.pressure_trips"] == 3
    if case == "recompile_storm":
        assert len(bundle["rings"]["compile"]) >= 4
        assert telemetry.snapshot()["counters"]["compile.storms"] == 1


def test_numerics_drift_detail_equals_the_jax_publishers(tmp_path):
    """The same crossing through both publishers: the same trigger detail."""
    import jax.numpy as jnp

    jfr, jinc, jnum, _, _, _ = _jax_obs()
    rec = _install(tmp_path)
    jrec = jfr.install(jfr.FlightRecorder(incident_dir=str(tmp_path / "jax")))
    for pub, v in ((numerics.NumericsPublisher(), torch.tensor(float("nan"))),
                   (jnum.NumericsPublisher(), jnp.float32(jnp.nan))):
        pub.publish(4, {"ef_residual_ratio": v})
    mine = _one_valid_bundle(rec, "numerics_drift")["trigger"]
    (jpath,) = glob.glob(os.path.join(jrec.incident_dir, "incident_*.json"))
    theirs = jinc.load_bundle(jpath)["trigger"]
    assert mine == theirs and mine["detail"]["value"] == "nan"


def test_jax_bundle_validates_here_and_mixed_bundles_merge(tmp_path):
    jfr, jinc, _, _, jtel, _ = _jax_obs()
    rec = _install(tmp_path)
    telemetry.count("serve.requests", 5)
    telemetry.observe("step.time_s", 0.1)
    mine = rec.trigger("manual", force=True)
    jrec = jfr.FlightRecorder(incident_dir=str(tmp_path / "jax"))
    jtel.count("serve.requests", 3)
    jtel.observe("step.time_s", 0.2)
    jrec.record_step(1, metrics={"loss": 0.5})
    theirs = jrec.trigger("manual", force=True)
    b = incident.load_bundle(theirs)
    assert b["rings"]["steps"][0]["metrics"] == {"loss": 0.5}
    with open(theirs) as f:
        raw = json.load(f)
    raw["host"] = 1  # host 1's bundle in a two-host merge
    other = str(tmp_path / "h1.json")
    with open(other, "w") as f:
        json.dump(raw, f)
    merged = incident.merge_bundles([mine, other], str(tmp_path / "merged.json"))
    assert merged == jinc.merge_bundles([mine, other])
    assert merged["kind"] == incident.MERGED_KIND and merged["hosts"] == [0, 1]
    assert merged["registry"]["counters"]["serve.requests"] == 8
    assert merged["registry"]["histograms"]["step.time_s"]["count"] == 2
    for tel in (telemetry, jtel):
        tel.validate_snapshot({k: merged["registry"][k] for k in
                               ("schema", "counters", "gauges", "histograms")}
                              | {"schema": tel.SCHEMA_VERSION})
    with open(tmp_path / "bad.json", "w") as f:
        json.dump({"schema": 99}, f)
    with pytest.raises(ValueError, match="schema"):
        incident.merge_bundles([str(tmp_path / "bad.json")])


# -- the step ring ---------------------------------------------------------------


def _ring(rec):
    return rec.rings_snapshot()["steps"]


@pytest.mark.parametrize("k", [1, 2])
def test_loop_step_ring_holds_the_step_outputs(k, tmp_path):
    from test_torch_resilience import build_dp, chunks_of, make_batches

    rec = _install(tmp_path, step_capacity=3)
    dp = build_dp(divergence_guard="skip_step")
    outs = []
    real = dp.train_step if k == 1 else dp.train_steps_batches

    def spy(batch):
        outs.append(real(batch))
        return outs[-1]

    if k == 1:
        dp.train_step = spy
    else:
        dp.train_steps_batches = spy
    batches = make_batches(8, seed=3)
    loop = resilience.ResilientLoop(dp, str(tmp_path / "ck"), ckpt_every=100,
                                    scan_steps=k)
    loop.run(batches if k == 1 else chunks_of(batches, k))
    ring = _ring(rec)
    last = lambda v: v[-1] if k > 1 else v  # noqa: E731 (a chunk's final slice)
    assert [e["step"] for e in ring] == [8 - 2 * k, 8 - k, 8]
    for e, out in zip(ring, outs[-3:]):
        assert e["metrics"]["loss"] == float(last(out.loss))
        assert e["metrics"]["nonfinite"] == 0.0
        assert e["monitors"]["grad_norm"] == float(last(out.monitors["grad_norm"]))
        assert set(e["monitors"]) == set(out.monitors)


@pytest.mark.parametrize("chunked", [False, True])
def test_gan_step_ring_holds_the_iteration_outputs(chunked, tmp_path):
    from test_torch_gan_trainer import host_data, port_trainer

    rec = _install(tmp_path)
    tr = port_trainer("dcgan")
    data = host_data(2)
    if chunked:
        out = tr.train_steps(*(np.stack([d[i] for d in data]) for i in range(3)))
        pick = lambda v: v[-1]  # noqa: E731
    else:
        for batch in data:
            out = tr.train_step(*batch)
        pick = lambda v: v  # noqa: E731
    ring = _ring(rec)
    assert [e["step"] for e in ring] == ([2] if chunked else [1, 2])
    e = ring[-1]
    assert e["metrics"] == {"d_loss": float(pick(out.d_loss)), "g_loss": float(pick(out.g_loss)),
                            "d_real": float(pick(out.metrics["d_real"])),
                            "d_fake": float(pick(out.metrics["d_fake"]))}
    assert e["monitors"] == {n: float(pick(v)) for n, v in out.monitors.items()}


def test_cpu_values_scalarize_as_the_jax_recorder_does():
    import jax.numpy as jnp

    jfr = _jax_obs()[0]
    values = [0.25, float("inf"), float("-inf"), float("nan"), 3, True, None, "x", 1e-30]
    for v in values:
        want = jfr._scalarize(v)
        assert flightrec._scalarize(v) == want or (v != v and want == "nan")
        if isinstance(v, float):
            assert flightrec._scalarize(torch.tensor(v)) == \
                jfr._scalarize(jnp.float32(v)), v
            assert flightrec._scalarize(np.float32(v)) == jfr._scalarize(np.float32(v))
    assert flightrec._scalarize(object()) is None is jfr._scalarize(object())
    assert flightrec._scalarize(torch.tensor([1.0, 2.0])) is None


def test_a_host_copy_in_flight_reads_pending_without_a_cuda_call(tmp_path, monkeypatch):
    """A CUDA entry's values land in page-locked memory behind a marker; a
    dump reads the marker from host memory and never synchronizes, reads
    a device tensor or queries an event (a CPU stand-in for the copy)."""
    def forbidden(*a, **k):
        raise AssertionError("a CUDA call at dump time")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    monkeypatch.setattr(torch.cuda.Event, "query", forbidden)
    rec = _install(tmp_path)
    copy = object.__new__(flightrec._HostCopy)
    copy.keys = [(0, "loss"), (1, "grad_norm")]
    copy.host = torch.zeros(3, dtype=torch.float64)
    rec.record_step(5, metrics={"top1": 0.5})
    rec._steps[-1]["copy"] = copy
    entry = _ring(rec)[-1]
    assert entry["metrics"] == {"top1": 0.5, "loss": flightrec.PENDING}
    assert entry["monitors"] == {"grad_norm": flightrec.PENDING}
    copy.host[:2] = torch.tensor([0.75, float("inf")], dtype=torch.float64)
    assert _ring(rec)[-1]["metrics"]["loss"] == flightrec.PENDING  # values, no marker
    copy.host[2] = 1.0  # the marker copy landed
    entry = _ring(rec)[-1]
    assert entry["metrics"]["loss"] == 0.75 and entry["monitors"]["grad_norm"] == "inf"
    assert rec.trigger("manual", force=True) is not None


def test_step_ring_evicts_and_the_other_rings_are_bounded(tmp_path):
    rec = _install(tmp_path, step_capacity=4, serve_capacity=3, compile_capacity=2)
    for i in range(10):
        flightrec.record_step(i, metrics={"loss": float(i)})
        flightrec.record_serve("shed", rid=i)
        flightrec.record_compile("train", 0.5, program=str(i))
        flightrec.record_autopilot("scan_k", action="hold", value=i)
    rings = rec.rings_snapshot()
    assert [e["step"] for e in rings["steps"]] == [6, 7, 8, 9]
    assert [e["rid"] for e in rings["serve"]] == [7, 8, 9]
    assert [e["program"] for e in rings["compile"]] == ["8", "9"]
    assert rings["compile"][0]["seconds"] == 0.5 and len(rings["autopilot"]) == 10
    assert rec.ring_coverage()["steps"] == 4


def test_the_recorder_taps_an_installed_tracer_or_owns_a_ring(tmp_path):
    rec = _install(tmp_path, span_capacity=5)
    own = tracing.get()
    assert isinstance(own, tracing.RingTracer) and own.capacity == 5
    for i in range(12):
        with tracing.span(f"s{i}"):
            pass
    rec.close()
    assert tracing.get() is None
    mine = tracing.install()
    rec2 = _install(tmp_path)
    assert tracing.get() is mine
    rec2.close()
    assert tracing.get() is mine  # close removes only its own tracer


# -- the trigger discipline ------------------------------------------------------


def test_helpers_without_a_recorder_allocate_nothing():
    assert flightrec.get() is None
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(20_000):
            flightrec.record_step(1)
            flightrec.record_serve("shed")
            flightrec.record_compile("train")
            flightrec.trigger("manual")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    where = [tracemalloc.Filter(True, flightrec.__file__)]
    grown = [d for d in after.filter_traces(where).compare_to(
        before.filter_traces(where), "lineno") if d.size_diff > 0]
    assert grown == []
    assert len(telemetry.REGISTRY) == 0


def test_env_gate(monkeypatch, tmp_path):
    monkeypatch.delenv("TPU_SYNCBN_FLIGHTREC", raising=False)
    assert flightrec.install_from_env() is None
    monkeypatch.setenv("TPU_SYNCBN_FLIGHTREC", "1")
    monkeypatch.setenv("TPU_SYNCBN_INCIDENT_DIR", str(tmp_path / "inc"))
    rec = flightrec.install_from_env()
    assert rec is not None and flightrec.install_from_env() is rec
    assert rec.incident_dir == str(tmp_path / "inc")


def test_cooldown_suppresses_and_force_bypasses(tmp_path):
    rec = _install(tmp_path, cooldown_s=60.0)
    assert rec.trigger("manual") is not None
    assert rec.trigger("manual") is None
    assert rec.trigger("manual", force=True) is not None
    assert len(_bundles(rec)) == 2
    assert rec.counters.count("suppressed") == 1
    assert telemetry.snapshot()["counters"]["incident.bundles"] == 2


def test_reentrant_trigger_drops_instead_of_deadlocking(tmp_path):
    rec = _install(tmp_path, cooldown_s=0.0)

    def evil_hook():
        flightrec.trigger("manual", force=True)
        return True, {}

    obs_server.register_readiness("evil", evil_hook)
    assert rec.trigger("manual", force=True) is not None
    assert len(_bundles(rec)) == 1 and rec.counters.count("suppressed") == 1


def test_failed_dump_never_raises_nor_spends_the_cooldown(tmp_path, monkeypatch):
    rec = _install(tmp_path, cooldown_s=3600.0)
    real = incident.build_bundle
    monkeypatch.setattr(incident, "build_bundle", lambda *a, **k: 1 / 0)
    assert rec.trigger("mem_pressure") is None
    assert rec.counters.count("errors") == 1
    monkeypatch.setattr(incident, "build_bundle", real)
    assert rec.trigger("mem_pressure") is not None
    assert len(_bundles(rec)) == 1


def test_max_bundles_prunes_the_oldest(tmp_path):
    rec = _install(tmp_path, max_bundles=2)
    assert all(rec.trigger("manual", force=True) for _ in range(4))
    assert len(_bundles(rec)) == 2
    with pytest.raises(ValueError):
        flightrec.FlightRecorder(step_capacity=0)
    with pytest.raises(ValueError):
        flightrec.FlightRecorder(cooldown_s=-1)


# -- heartbeat and readiness -----------------------------------------------------


def test_a_running_loop_beats_and_is_ready_in_its_bundles(tmp_path):
    from test_torch_resilience import build_dp, make_batches

    rec = _install(tmp_path)
    dp = build_dp()
    real = dp.train_step
    seen = []

    def step(batch):
        out = real(batch)
        if len(seen) == 1:
            rec.trigger("manual", force=True)
        seen.append(obs_server.evaluate_readiness())
        return out

    dp.train_step = step
    resilience.ResilientLoop(dp, str(tmp_path / "ck")).run(make_batches(3))
    bundle = _one_valid_bundle(rec, "manual")
    assert "train" in bundle["state"]["heartbeat_age_s"]
    assert bundle["state"]["readiness"]["checks"]["train"]["ok"] is True
    assert seen[-1][1]["train"] == {"ok": True, "step": 2, "preempted": False,
                                    "recovering": False}
    assert obs_server.evaluate_readiness() == (True, {})  # the hook left with run()
    assert "train" not in obs_server.HEARTBEATS.ages()


def test_heartbeats_and_readiness_match_the_jax_module():
    jsrv = _jax_obs()[3]
    for srv in (obs_server, jsrv):
        hb = srv.Heartbeats()
        hb.beat("a", now=1.0)
        hb.beat("b", now=2.5)
        assert hb.ages(now=4.0) == {"a": 3.0, "b": 1.5}
        hb.clear("a")
        assert hb.ages(now=1.0) == {"b": 0.0}
        srv.register_readiness("ok", lambda: (True, {"x": 1}))
        srv.register_readiness("boom", lambda: 1 / 0)
    assert obs_server.evaluate_readiness() == jsrv.evaluate_readiness()
    assert obs_server.evaluate_readiness()[0] is False


# -- attribution -----------------------------------------------------------------


def _synthetic(*, dispatch_s, data_wait_s, covered_s, steps, flops=None,
               bytes_per_step=None, counts=None, live_bytes=None, chunked=False):
    def hist(total, count):
        return {"buckets": [60.0], "counts": [count, 0], "count": count,
                "sum": total, "min": None, "max": None}

    counters = {} if live_bytes is None else {"collectives.dispatched_bytes": live_bytes}
    windows = {"schema": 1, "counters": counters, "gauges": {},
               "histograms": {("step.chunk_time_s" if chunked else "step.time_s"):
                              hist(dispatch_s, steps),
                              "step.data_wait_s": hist(data_wait_s, steps)},
               "window": {"covered_s": covered_s, "frames": 1, "interval_s": 1.0}}
    return {"schema": incident.BUNDLE_SCHEMA, "kind": incident.BUNDLE_KIND,
            "incident_id": "t-0", "host": 0, "wall_time": 0.0,
            "trigger": {"kind": "manual", "detail": {}},
            "config": {"env": {}, "argv": []},
            "contract": {"flops_per_step": flops, "collective_bytes_per_step": bytes_per_step,
                         "collective_counts": counts},
            "registry": {"schema": 1, "counters": {"collectives.psum.bytes": 4096},
                         "gauges": {}, "histograms": {}},
            "windows": windows, "rings": {"steps": [], "serve": []},
            "trace": {"traceEvents": []},
            "state": {"heartbeat_age_s": {}, "readiness": {"ok": True}}}


ATTR_CASES = {
    "cost_model": dict(dispatch_s=0.8, data_wait_s=0.1, covered_s=1.0, steps=10,
                       flops=3.1e12, bytes_per_step=1.0e8, counts={"psum": 2}),
    "no_contract": dict(dispatch_s=0.5, data_wait_s=0.2, covered_s=1.0, steps=4),
    "bytes_without_flops": dict(dispatch_s=0.5, data_wait_s=0.0, covered_s=0.7, steps=3,
                                bytes_per_step=5e7),
    "live_bytes": dict(dispatch_s=2.0, data_wait_s=0.3, covered_s=1.0, steps=6,
                       flops=1e12, live_bytes=3e9),
    "chunked": dict(dispatch_s=1.2, data_wait_s=0.05, covered_s=2.0, steps=2,
                    flops=8e12, bytes_per_step=2e8, chunked=True),
    "empty": dict(dispatch_s=0.0, data_wait_s=0.0, covered_s=0.0, steps=0),
}


@pytest.mark.parametrize("case", sorted(ATTR_CASES))
def test_attribution_equals_jax_with_explicit_rates(case):
    jinc = _jax_obs()[1]
    bundle = _synthetic(**ATTR_CASES[case])
    for rates in (dict(flop_rate=989.4e12, wire_rate=900e9),
                  dict(flop_rate=1e12, wire_rate=25e9)):
        mine = incident.attribution(bundle, **rates)
        assert mine == jinc.attribution(bundle, **rates)
        if mine is not None:
            assert abs(mine["share_sum"] - 1.0) < 1e-5
    base = incident.attribution(_synthetic(**ATTR_CASES["no_contract"]),
                                flop_rate=1e12, wire_rate=25e9)
    other = incident.attribution(bundle, flop_rate=1e12, wire_rate=25e9)
    assert incident.diff_attribution(base, other) == jinc.diff_attribution(base, other)
    assert incident.DEFAULT_FLOP_RATE == 989.4e12 and incident.DEFAULT_WIRE_RATE == 900e9


def test_the_cli_inspects_diffs_and_merges(tmp_path, capsys):
    rec = _install(tmp_path, cooldown_s=0.0)
    telemetry.observe("step.time_s", 0.05)
    a = rec.trigger("manual", force=True)
    telemetry.observe("step.data_wait_s", 0.5)
    b = rec.trigger("divergence_restore", {"step": 4})
    assert incident.main(["inspect", a]) == 0
    assert "trigger 'manual'" in capsys.readouterr().out
    assert incident.main(["inspect", b, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["trigger"]["kind"] == "divergence_restore" and doc["attribution"]["steps"] == 1
    assert incident.main(["diff", a, b]) == 0
    assert "moved most" in capsys.readouterr().out
    assert incident.main(["merge", str(tmp_path / "m.json"), a, b]) == 0
    assert os.path.exists(tmp_path / "m.json")
    assert incident.main(["inspect", str(tmp_path / "missing.json")]) == 1


def test_host_ring_rows_recycle_and_growth_is_counted(monkeypatch):
    """The page-locked rows of the step ring's host copies (plain host
    memory here): one row a ring entry plus one, handed out in turn, a row
    coming round only after the ring has moved past its entry; a wider
    record widens the block, and the recorder counts each widening
    (``incident.host_block_grows``)."""
    monkeypatch.setattr(flightrec._HostRing, "_alloc", lambda self: torch.zeros(
        (self.rows, self.width + 1), dtype=torch.float64))
    ring = flightrec._HostRing(rows=4, width=3)
    views = [ring.take(2) for _ in range(5)]
    assert all(v.shape == (3,) for v in views)
    assert len({v.data_ptr() for v in views[:4]}) == 4
    assert views[4].data_ptr() == views[0].data_ptr()
    assert not ring.reserve(3) and ring.reserve(5) and ring.width == 6
    rec = flightrec.FlightRecorder(step_capacity=3)
    assert rec._host_ring is None  # no CUDA here: nothing taken
    rec._host_ring = flightrec._HostRing(4, flightrec.STEP_RING_WIDTH)
    assert rec._ring_for(13) is rec._host_ring and rec.counters.count("host_block_grows") == 0
    wide = flightrec.STEP_RING_WIDTH + 1
    assert rec._ring_for(wide).width >= wide and rec.counters.count("host_block_grows") == 1
    assert rec._ring_for(5).width >= wide and rec.counters.count("host_block_grows") == 1
