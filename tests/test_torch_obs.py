"""The port's observability slice (``tpu_syncbn_torch.obs``: telemetry,
tracing, stepstats, numerics) against the JAX package's
(``tpu_syncbn.obs``), and its hooks in the ported modules:

* the registry: one script of operations (labeled counters past the
  cardinality cap, gauges with inc/dec, histograms with boundary and
  overflow values, ``CounterGroup`` mirrors, the disabled path) fed to
  both packages gives equal snapshots; each package's JSONL export merges
  through both ``merge_exports`` to one summary; the label helpers and
  ``validate_snapshot`` agree;
* traces: a port trace passes the JAX ``validate_trace`` and a JAX trace
  the port's, with the same event shapes; the ``torch.profiler`` bridge;
* the numerics producers against the JAX functions on the same arrays
  (``record_bn_skew``, ``merge_max``, ``cross_replica_monitors`` at world
  1); ``NumericsPublisher`` on CPU tensors (ready at once) and with
  pending events (queued, dropped past its bound, drained by ``flush``);
* hooks: checkpoint spans and counters, the loader's counters, one
  ``ResilientLoop`` export holding its spans, gauge and mirrored counters,
  the watchdog's and the data stall's span-tagged instants, rendezvous and
  probe counters, ``ProgramCache``'s labeled counters and gauges,
  ``EventCounter``; ``DispatchWireTally`` with CPU stand-ins for a
  captured program (its real replay is in tests/test_torch_gpu.py).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import parallel
from tpu_syncbn_torch.obs import numerics, stepstats, telemetry, tracing


@pytest.fixture(autouse=True)
def clean_obs():
    """Each test starts with telemetry on, empty registries (both
    packages') and no tracer, and leaves them so."""
    from tpu_syncbn.obs import telemetry as jtel
    from tpu_syncbn.obs import tracing as jtr

    for mod in (telemetry, jtel):
        mod.REGISTRY.reset()
        mod.set_enabled(True)
        mod.reset_deprecated_warnings()
    yield
    for mod in (telemetry, jtel):
        mod.REGISTRY.reset()
        mod.set_enabled(None)
    for mod in (tracing, jtr):
        mod.uninstall()


# -- the registry ----------------------------------------------------------------


def _script(tel) -> dict:
    """The operation script, on a private registry and on the module
    helpers; returns both snapshots."""
    reg = tel.Registry()
    reg.counter("a.b").inc(3)
    reg.set_label_cardinality("fam", 2)
    for i in range(4):  # two admitted, two collapse into "other"
        reg.counter("fam", labels={"tenant": f"t{i}"}).inc(i + 1)
    g = reg.gauge("q")
    g.set(3)
    g.inc(2)
    g.dec(0.5)
    reg.gauge("esc", labels={"path": 'a"b\\c\nd', "k": "v"}).set(-1.25)
    h = reg.histogram("h")
    for v in (0.0001, 0.00011, 1.0, 7.0, 301.0, 0.0):
        h.observe(v)
    reg.histogram("hb", buckets=(1, 2, 4)).observe(3)
    reg.histogram("hb", buckets=(9,)).observe(5)  # buckets apply at creation only
    cg = tel.CounterGroup("resilience", registry=reg)
    cg.bump("checkpoints", 2)
    cg.bump("stalls", labels={"source": "data"})
    tel.set_enabled(False)
    tel.count("off.counter")
    tel.observe("off.hist", 1.0)
    tel.set_gauge("off.gauge", 1.0)
    with tel.timed("off.timed"):
        pass
    off_len = len(tel.REGISTRY)
    tel.set_enabled(True)
    tel.count("on.counter", 2, labels={"x": "1"})
    tel.inc_gauge("on.level", 3)
    tel.inc_gauge("on.level", -1)
    tel.observe("on.hist", 0.3, buckets=(0.1, 1.0))
    return {"private": reg.snapshot(), "process": tel.snapshot(),
            "off_len": off_len, "group": cg.summary()}


def test_same_script_gives_equal_snapshots():
    from tpu_syncbn.obs import telemetry as jtel

    got, want = _script(telemetry), _script(jtel)
    assert got == want
    assert got["off_len"] == 0
    assert got["private"]["counters"]["telemetry.cardinality_dropped"] == 2
    assert got["private"]["counters"]['fam{tenant="other"}'] == 7
    assert got["private"]["gauges"]["q"] == 4.5
    assert telemetry.SCHEMA_VERSION == jtel.SCHEMA_VERSION
    assert telemetry.DEFAULT_TIME_BUCKETS_S == jtel.DEFAULT_TIME_BUCKETS_S


def test_exports_merge_through_both_packages(tmp_path):
    from tpu_syncbn.obs import telemetry as jtel

    paths = []
    for host, tel in enumerate((telemetry, jtel)):
        snap = _script(tel)["private"]
        paths.append(tel.export_snapshot_jsonl(snap, str(tmp_path / f"h{host}.jsonl"),
                                               host=host))
    rows = [[{k: v for k, v in r.items() if k != "host"} for r in telemetry.read_jsonl(p)[1:]]
            for p in paths]
    assert rows[0] == rows[1]  # the same lines but for the host
    merged = telemetry.merge_exports(paths)
    assert merged == jtel.merge_exports(paths)
    assert merged["hosts"] == [0, 1]
    assert merged["counters"]["a.b"] == 6
    assert merged["histograms"]["h"]["count"] == 12
    telemetry.validate_snapshot(merged)
    out = tmp_path / "summary.json"
    assert telemetry.write_merged_summary(paths, str(out)) == json.loads(out.read_text())


def test_label_helpers_and_validation_agree():
    from tpu_syncbn.obs import telemetry as jtel

    names = ['serve.latency_s{tenant="a"}', "plain", 'f{a="x\\"y",b="z"}', "odd{"]
    for n in names:
        assert telemetry.split_labels(n) == jtel.split_labels(n)
        assert telemetry.parse_selector(n) == jtel.parse_selector(n)
    assert (telemetry.labeled_name("f", {"b": 'q"', "a": "1\n"})
            == jtel.labeled_name("f", {"b": 'q"', "a": "1\n"}))
    for series, sel in (({"a": "1", "b": "2"}, {"a": "1"}), (None, {}), ({}, {"a": "1"})):
        assert telemetry.labels_match(series, sel) == jtel.labels_match(series, sel)
    with pytest.raises(ValueError):
        telemetry.labeled_name("f", {"Bad": 1})
    bad = [{"schema": 2, "counters": {}, "gauges": {}, "histograms": {}},
           {"schema": 1, "counters": {"c": 1.5}, "gauges": {}, "histograms": {}},
           {"schema": 1, "counters": {}, "gauges": {}, "histograms": {
               "h": {"buckets": [1], "counts": [1, 0], "count": 2, "sum": 0.0}}}]
    for block in bad:
        for tel in (telemetry, jtel):
            with pytest.raises(ValueError):
                tel.validate_snapshot(block)


def test_host_index_never_initializes(monkeypatch):
    monkeypatch.setenv("RANK", "3")
    assert telemetry._host_index() == 3
    monkeypatch.delenv("RANK")
    assert telemetry._host_index() == 0


# -- traces -------------------------------------------------------------------------


def _record(tr_mod):
    t = tr_mod.install(tr_mod.Tracer())
    with tr_mod.span("outer", step=1) as outer:
        with tr_mod.span("inner"):
            assert tr_mod.current_span_id() != outer
        tr_mod.instant("mark", why="x")
        tr_mod.flow_start("req", 7)
        tr_mod.flow_end("req", 7)
        assert tr_mod.latest_open_span_id() == outer
    tr_mod.uninstall()
    return t


def test_traces_validate_both_ways(tmp_path):
    from tpu_syncbn.obs import tracing as jtr

    mine, theirs = _record(tracing), _record(jtr)
    p1, p2 = mine.save(str(tmp_path / "port.json")), theirs.save(str(tmp_path / "jax.json"))
    ev1 = jtr.validate_trace(jtr.load_trace(p1))
    ev2 = tracing.validate_trace(tracing.load_trace(p2))
    shape = [(e["name"], e["ph"], sorted(e), sorted(e.get("args", {}))) for e in ev1
             if e["ph"] != "M"]
    assert shape == [(e["name"], e["ph"], sorted(e), sorted(e.get("args", {}))) for e in ev2
                     if e["ph"] != "M"]
    assert ev1[0] == {"name": "process_name", "ph": "M", "pid": ev1[0]["pid"],
                      "args": {"name": "tpu_syncbn host 0"}}
    inner = next(e for e in ev1 if e["name"] == "inner")
    outer = next(e for e in ev1 if e["name"] == "outer")
    assert inner["args"]["parent_id"] == outer["args"]["span_id"]
    assert tracing.span("off") is tracing.span("off")  # no tracer: a shared no-op
    ring = tracing.RingTracer(capacity=2)
    for i in range(5):
        ring.instant(f"e{i}")
    assert [e["name"] for e in ring.recent_events()] == ["e3", "e4"]
    with pytest.raises(ValueError, match="phase"):
        tracing.validate_trace([{"name": "x", "ph": "?", "ts": 0}])


def test_profiler_bridge_names_the_spans():
    t = tracing.Tracer(profiler_bridge=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("bridged_span"):
            torch.ones(4).sum()
    assert any(e.key == "bridged_span" for e in prof.key_averages())
    assert t.events[0]["name"] == "bridged_span"


# -- numerics -----------------------------------------------------------------------


def test_skew_and_folds_match_the_jax_functions():
    import jax.numpy as jnp

    from tpu_syncbn.obs import numerics as jnum

    rs = np.random.RandomState(5)
    s, sq = rs.randn(6).astype(np.float32), (rs.rand(6) * 4 + 2).astype(np.float32)
    cnt = np.float32(4.0)
    mean, var = rs.randn(6).astype(np.float32) * 0.1, (rs.rand(6) + 0.5).astype(np.float32)
    with jnum.collect() as jcol:
        jnum.record_bn_skew(jnp.asarray(s), jnp.asarray(sq), jnp.asarray(cnt),
                            jnp.asarray(mean), jnp.asarray(var))
        jnum.record_bn_skew(jnp.asarray(s * 2), jnp.asarray(sq), jnp.asarray(cnt),
                            jnp.asarray(mean), jnp.asarray(var))
    with numerics.collect() as col:
        t = torch.from_numpy
        numerics.record_bn_skew(t(s), t(sq), torch.tensor(cnt), t(mean), t(var))
        numerics.record_bn_skew(t(s * 2), t(sq), torch.tensor(cnt), t(mean), t(var))
        numerics.record_bn_skew_alone(torch.device("cpu"))
    assert not numerics.active()
    want, got = jcol.summary(), col.summary()
    assert set(got) == set(want) == {"bn_mean_skew", "bn_var_skew", "bn_skew_layers"}
    for k in ("bn_mean_skew", "bn_var_skew"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assert float(got["bn_skew_layers"]) == 3.0 and float(want["bn_skew_layers"]) == 2.0
    merged = numerics.merge_max({"a": torch.tensor(1.0)}, {"a": torch.tensor(3.0),
                                                           "b": torch.tensor(2.0)})
    assert {k: float(v) for k, v in merged.items()} == {"a": 3.0, "b": 2.0}
    with numerics.collect(enabled=False) as off:
        numerics.record("x", torch.tensor(1.0))
    assert off.summary() == {}
    grads = [torch.from_numpy(rs.randn(3, 4).astype(np.float32)) for _ in range(3)]
    np.testing.assert_allclose(float(numerics.grad_norm_scalar(grads)),
                               float(jnum.grad_norm_scalar([g.numpy() for g in grads])),
                               rtol=1e-6)


def test_cross_replica_monitors_alone():
    out = numerics.cross_replica_monitors(
        {"replica_grad_norm": torch.tensor(2.5), "bn_mean_skew": torch.tensor(0.0)},
        None, disp_keys=("replica_grad_norm",))
    assert {k: float(v) for k, v in out.items()} == {
        "replica_grad_norm": 2.5, "bn_mean_skew": 0.0, "replica_grad_norm_disp": 0.0}
    assert numerics.cross_replica_monitors({}, None) == {}


def test_publisher_on_cpu_tensors_is_ready_at_once(tmp_path):
    from tpu_syncbn_torch.obs import flightrec

    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path)))
    pub = numerics.NumericsPublisher()
    mon = {"bn_mean_skew": torch.tensor(9.0), "clip_fraction": torch.tensor(0.5),
           "replica_grad_norm": torch.tensor(float("nan")), "grad_norm": torch.tensor(1.0)}
    assert pub.publish(1, mon) == 1
    snap = telemetry.snapshot()
    assert snap["counters"]["numerics.samples"] == 1
    assert snap["counters"]["numerics.clip_saturated"] == 1
    # the skew over its threshold and the non-finite norm: two trips, and
    # one numerics_drift bundle (the recorder's cooldown takes the second)
    assert snap["counters"]["numerics.drift_trips"] == 2
    flightrec.uninstall()
    rec.close()
    assert rec.counters.count("bundles") == 1 and rec.counters.count("suppressed") == 1
    assert rec.last_incident["trigger"] == "numerics_drift"
    assert "numerics.grad_norm" not in snap["histograms"]  # not a published key
    assert pub.last == {"bn_mean_skew": 9.0, "clip_fraction": 0.5}
    assert pub.publish(2, {"grad_norm": torch.tensor(1.0)}) == 0  # nothing published
    telemetry.set_enabled(False)
    assert pub.publish(3, mon) == 0 and pub.flush() == 0
    assert telemetry.snapshot()["counters"]["numerics.samples"] == 1


def test_publisher_waits_for_events_and_bounds_its_queue(monkeypatch):
    """Stand-in events for CUDA's: an entry whose event has not completed
    stays queued (``publish`` never waits), the queue drops its oldest past
    ``max_pending``, and ``flush()`` synchronizes on the rest."""

    class Event:
        def __init__(self):
            self.done = False
            self.waited = False

        def query(self):
            return self.done

        def synchronize(self):
            self.waited = self.done = True

    events = []

    def to_host(values):
        events.append(Event())
        return [v.clone() for v in values], events[-1]

    pub = numerics.NumericsPublisher(max_pending=2)
    monkeypatch.setattr(pub, "_to_host", to_host)
    for step in range(3):
        assert pub.publish(step, {"bn_var_skew": torch.tensor(float(step))}) == 0
    assert telemetry.snapshot()["counters"]["numerics.dropped"] == 1
    events[1].done = True
    assert pub.publish(3, None) == 1  # the oldest queued entry has landed
    assert pub.flush() == 1 and events[2].waited
    assert telemetry.snapshot()["histograms"]["numerics.bn_var_skew"]["count"] == 2


# -- hooks ----------------------------------------------------------------------------


def test_checkpoint_spans_and_counters(tmp_path):
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    t = tracing.install()
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    ckpt.load_checkpoint(str(tmp_path), tree)
    assert ckpt.verify_checkpoint(str(tmp_path), 1)
    assert not ckpt.verify_checkpoint(str(tmp_path), 2)
    with ckpt.AsyncCheckpointer() as ac:
        ac.save(str(tmp_path), 3, tree)
    snap = telemetry.snapshot()
    assert snap["counters"]["checkpoint.saves"] == 2  # one sync, one async
    assert snap["counters"]["checkpoint.loads"] == 1
    assert snap["counters"]["checkpoint.verify_failures"] == 1
    assert snap["counters"]["checkpoint.async_saves"] == 1
    for h, n in (("save_s", 2), ("load_s", 1), ("verify_s", 2), ("async_snapshot_s", 1)):
        assert snap["histograms"][f"checkpoint.{h}"]["count"] == n
    names = {e["name"] for e in t.events}
    assert {"checkpoint_save", "checkpoint_load", "checkpoint_verify"} <= names


def test_loader_counters():
    from tpu_syncbn_torch.data import DataLoader, device_prefetch

    class DS:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return np.full((4,), i, np.float32)

    assert len(list(DataLoader(DS(), batch_size=4, num_workers=2))) == 4
    snap = telemetry.snapshot()
    assert snap["counters"]["loader.batches"] == 4
    assert snap["histograms"]["loader.fetch_wait_s"]["count"] == 4
    assert "loader.queue_depth" in snap["gauges"]
    chunks = list(device_prefetch(iter([np.ones(4, np.float32)] * 3), device="cpu",
                                  scan_steps=2))
    assert [c.shape[0] for c in chunks] == [2, 1]
    assert telemetry.snapshot()["gauges"]["loader.stage_depth"] == 1


def _small_dp(**kw):
    from test_torch_monitors import SmallNet, _sq_loss

    from tpu_syncbn_torch import nn

    torch.manual_seed(0)
    model = nn.convert_sync_batchnorm(SmallNet())
    return parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                 _sq_loss, device="cpu", **kw)


def test_resilient_loop_spans_gauge_and_counters_share_one_export(tmp_path):
    from tpu_syncbn_torch.runtime import resilience

    t = tracing.install()
    loop = resilience.ResilientLoop(_small_dp(), str(tmp_path / "ck"), ckpt_every=2)
    summary = loop.run([torch.ones(16, 8)] * 4)
    assert summary["steps"] == 4 and summary["checkpoints"] == 2
    path = telemetry.REGISTRY.export_jsonl(str(tmp_path / "t.jsonl"))
    snap = telemetry.validate_snapshot(telemetry.merge_exports([path]))
    assert snap["counters"]["resilience.checkpoints"] == 2  # the mirrored group
    assert snap["histograms"]["step.time_s"]["count"] == 4
    assert snap["histograms"]["step.data_wait_s"]["count"] == 4
    assert snap["histograms"]["checkpoint.save_s"]["count"] == 2
    assert snap["gauges"]["train.step"] == 4
    assert snap["counters"]["numerics.samples"] == 4  # published, then flushed
    names = [e["name"] for e in t.events]
    assert names.count("step") == 4 and names.count("data_wait") == 5  # + the end
    steps = [e["args"]["step"] for e in t.events if e["name"] == "step"]
    assert steps == [1, 2, 3, 4]


def test_scan_chunks_publish_their_last_step(tmp_path):
    from tpu_syncbn_torch.runtime import resilience

    t = tracing.install()
    loop = resilience.ResilientLoop(_small_dp(), str(tmp_path / "ck"), ckpt_every=100,
                                    scan_steps=2)
    loop.run([torch.ones(2, 16, 8)] * 2)
    snap = telemetry.snapshot()
    assert snap["histograms"]["step.chunk_time_s"]["count"] == 2
    assert snap["counters"]["numerics.samples"] == 2
    assert [e["name"] for e in t.events].count("scan_chunk") == 2


def test_stalls_count_and_carry_the_open_span(tmp_path):
    from tpu_syncbn_torch.obs import flightrec
    from tpu_syncbn_torch.runtime import resilience

    t = tracing.install()
    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path),
                                                     cooldown_s=0.0))
    with t.span("step") as sid:
        with resilience.Watchdog(0.05, name="corr-test", poll_s=0.01) as wd:
            deadline = time.monotonic() + 5
            while wd.stall_count == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
    assert wd.stall_count >= 1
    assert telemetry.snapshot()["counters"]["resilience.watchdog_stalls"] >= 1
    marks = [e for e in t.events if e["name"] == "watchdog_stall"]
    assert marks and marks[0]["args"]["span_id"] == sid
    gate = threading.Event()

    def slow():
        gate.wait(5)
        yield 1

    with t.span("fetch") as fid:
        with pytest.raises(resilience.StallError):
            list(resilience.stall_guard(slow(), 0.05, name="data"))
    gate.set()
    assert telemetry.snapshot()["counters"]["resilience.data_stalls"] == 1
    mark = next(e for e in t.events if e["name"] == "data_stall")
    assert mark["args"] == {"source": "data", "span_id": fid}
    flightrec.uninstall()
    rec.close()
    # each stall also dumped its watchdog_stall bundle (one per stall)
    assert rec.counters.count("bundles") == wd.stall_count + 1
    assert rec.last_incident["trigger"] == "watchdog_stall"


def test_rendezvous_and_probe_counters(monkeypatch):
    import torch.distributed as tdist

    from tpu_syncbn_torch.runtime import distributed, probe

    calls = []

    def flaky(**kw):
        calls.append(kw)
        if len(calls) == 1:
            raise RuntimeError("store not up yet")

    monkeypatch.setattr(tdist, "init_process_group", flaky)
    distributed._rendezvous_with_retry({}, attempts=3, timeout_s=None, backoff_s=0.0,
                                       jitter_key="t")
    counters = telemetry.snapshot()["counters"]
    assert counters["rendezvous.attempts"] == 2 and counters["rendezvous.failures"] == 1
    monkeypatch.setattr(probe, "_probe_cache", {})
    monkeypatch.setattr(probe, "_probe_uncached", lambda timeout: None)
    assert probe.probe_backend() is None
    monkeypatch.setattr(probe, "_probe_cache", {})
    monkeypatch.setattr(probe, "_probe_uncached",
                        lambda timeout: probe.BackendInfo("gpu", 4, "card", (9, 0)))
    assert probe.probe_backend().device_count == 4
    monkeypatch.setenv(distributed.FORCE_CPU_ENV, "1")
    probe.ensure_backend(device="cpu")
    snap = telemetry.snapshot()
    assert snap["counters"]["probe.failed"] == 1 and snap["counters"]["probe.ok"] == 1
    assert snap["counters"]["probe.forced_cpu"] == 1
    assert snap["gauges"]["probe.device_count"] == 4 and "probe.latency_s" in snap["gauges"]


def test_program_cache_publishes_labeled_series():
    from tpu_syncbn_torch.parallel import scan_driver

    cache = scan_driver.ProgramCache(name="train", max_bytes=1000)
    with pytest.warns(DeprecationWarning, match="deprecated flat mirror"):
        scan_driver.cached_program(cache, 1, lambda: "p1", size_of=lambda p: 400)
    scan_driver.cached_program(cache, 1, lambda: "p1")
    snap = telemetry.snapshot()
    fam = '{family="train"}'
    assert snap["counters"][f"scan.program_cache.misses{fam}"] == 1
    assert snap["counters"][f"scan.program_cache.hits{fam}"] == 1
    assert snap["counters"]["train.program_cache.hits"] == 1
    assert snap["gauges"][f"scan.program_cache.bytes_live{fam}"] == 400
    assert snap["gauges"][f"scan.program_cache.fill_frac{fam}"] == 0.4
    assert snap["gauges"]["train.program_cache.live"] == 1


def test_event_counter_is_a_deprecated_mirrored_group():
    from tpu_syncbn_torch.utils import EventCounter

    with pytest.warns(DeprecationWarning, match="CounterGroup"):
        ev = EventCounter()
    assert ev.bump("restarts") == 1 and ev.summary() == {"restarts": 1}
    assert telemetry.snapshot()["counters"]["events.restarts"] == 1


def test_collective_tallies_and_dispatch_wire_tally():
    """An eager call tallies its own bytes and the wire tally adds exactly
    those; stand-ins for a captured K-step program (``capturing()`` around
    the calls, ``note_replay`` as each replay): the capture moves nothing,
    each replay its K steps' inventory."""
    from tpu_syncbn_torch.parallel import collectives as C

    x = torch.ones(64)
    wire = C.DispatchWireTally()
    C.ppermute(x, [(0, 0)], None)  # tallied even alone
    assert wire.after_dispatch() == 256
    assert wire.after_dispatch() == 0  # nothing ran
    tallies = stepstats.collective_tallies()
    assert tallies["collectives.ppermute.calls"] == 1
    assert tallies["collectives.ppermute.bytes"] == 256
    k = 3
    with C.capturing() as inventory:
        for _ in range(k):
            C.ppermute(x, [(0, 0)], None)
    assert inventory == [k * 256]
    assert wire.after_dispatch(k) == 0  # the capture itself moved nothing
    for _ in range(2):
        C.note_replay(inventory[0])
        assert wire.after_dispatch(k) == k * 256
    assert telemetry.snapshot()["counters"]["collectives.dispatched_bytes"] == 256 + 2 * k * 256
    C.compressed_pmean(torch.ones(512), None, mode="int8")
    snap = telemetry.snapshot()
    assert snap["counters"]["collectives.compressed_bytes"] == 512 + 8 * 2
    assert snap["gauges"]["collectives.compression_ratio"] == pytest.approx(2048 / 528)
