"""The port's windowed time series (``tpu_syncbn_torch.obs.timeseries``)
against the JAX package's (``tpu_syncbn.obs.timeseries``): the same
counter, labeled-counter, histogram and gauge events on the same injected
monotonic clock, fed to each package's own registry and aggregator, give
exactly equal rates, quantiles, fractions above a threshold and windowed
snapshots — both sides run the same Python float arithmetic, so the
tolerance is equality. Plus ``quantile_from_counts`` on the same counts,
the selector errors, and a windowed snapshot's export merged through both
packages' ``merge_exports``.
"""

import time

import numpy as np
import pytest

from tpu_syncbn_torch.obs import telemetry, timeseries

#: the injected clock: one tick a second, one late tick (a sampler that
#: slipped), and a registry reset between two ticks
TICKS = (1.0, 2.0, 3.0, 4.5, 5.0, 6.0, 7.0, 8.0)
RESET_AT = 6


def _jax():
    from tpu_syncbn.obs import telemetry as jtel, timeseries as jts

    return jtel, jts


def _drive(tel, ts, *, capacity=5):
    """One event script through ``tel``'s registry, ticked into ``ts``'s
    aggregator on the injected clock; returns the aggregator."""
    reg = tel.Registry()
    agg = ts.WindowedAggregator(reg, interval_s=1.0, capacity=capacity)
    rng = np.random.RandomState(0)
    agg.tick(now=0.0)
    for i, t in enumerate(TICKS, start=1):
        if i == RESET_AT:
            reg.reset()  # negative deltas: the aggregator re-anchors
        reg.counter("steps").inc(i)
        reg.counter("serve.requests", labels={"tenant": "a"}).inc(2 * i)
        reg.counter("serve.requests", labels={"tenant": "b", "x": "1"}).inc(1)
        for v in rng.exponential(0.04, size=9):
            reg.histogram("step.time_s").observe(float(v))
        for v in rng.uniform(0.0, 0.7, size=5):
            reg.histogram("lat", buckets=(0.1, 0.2, 0.5),
                          labels={"tenant": "a"}).observe(float(v))
        reg.histogram("lat", buckets=(0.1, 0.2, 0.5),
                      labels={"tenant": "b"}).observe(0.15 * i)
        reg.gauge("queue").set(1.5 * i)
        agg.tick(now=t)
    return agg


@pytest.fixture(scope="module")
def pair():
    jtel, jts = _jax()
    return _drive(telemetry, timeseries), _drive(jtel, jts)


WINDOWS = (None, 2.0, 3.5, 100.0)


@pytest.mark.parametrize("name", ["steps", "step.time_s", "serve.requests{}",
                                  'serve.requests{tenant="a"}', 'lat{tenant="b"}',
                                  "lat{}", "absent"])
@pytest.mark.parametrize("window", WINDOWS)
def test_rates_equal(pair, name, window):
    port, jax = pair
    got = port.rate(name, window, now=8.0)
    assert got == jax.rate(name, window, now=8.0)
    if name == "absent":
        assert got == 0.0


@pytest.mark.parametrize("name", ["step.time_s", 'lat{tenant="a"}', 'lat{tenant="b"}',
                                  "lat{}", "absent"])
@pytest.mark.parametrize("window", WINDOWS)
def test_quantiles_and_fractions_equal(pair, name, window):
    port, jax = pair
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert port.quantile(name, q, window, now=8.0) \
            == jax.quantile(name, q, window, now=8.0), q
    for th in (0.0, 0.05, 0.1, 0.15, 0.3, 0.5, 0.6, 2.0):
        assert port.fraction_above(name, th, window, now=8.0) \
            == jax.fraction_above(name, th, window, now=8.0), th


@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_snapshots_equal_and_validate(pair, window):
    port, jax = pair
    jtel, _ = _jax()
    got = port.windowed_snapshot(window, now=8.0)
    assert got == jax.windowed_snapshot(window, now=8.0)
    telemetry.validate_snapshot(got)
    jtel.validate_snapshot(got)
    assert got["window"]["frames"] == len(port._window_frames(window, 8.0)[0])


def test_capacity_bounds_the_ring_and_the_first_tick_anchors():
    jtel, jts = _jax()
    for tel, ts in ((telemetry, timeseries), (jtel, jts)):
        agg = _drive(tel, ts, capacity=3)
        assert len(agg._frames) == 3
        one = ts.WindowedAggregator(tel.Registry())
        one.tick(now=1.0)
        assert one.rate("steps") is None and one.windowed_snapshot()["window"]["frames"] == 0


@pytest.mark.parametrize("counts", [[0, 0, 0, 0], [5, 0, 0, 0], [1, 2, 3, 4], [0, 0, 0, 9],
                                    [3, 0, 7, 1]])
def test_quantile_from_counts_equal(counts):
    _, jts = _jax()
    buckets = (0.1, 0.2, 0.5)
    for q in (0.0, 0.25, 0.5, 0.75, 0.999, 1.0):
        assert timeseries.quantile_from_counts(buckets, counts, q) \
            == jts.quantile_from_counts(buckets, counts, q)
    for mod in (timeseries, jts):
        with pytest.raises(ValueError, match="quantile"):
            mod.quantile_from_counts(buckets, counts, 1.5)


def test_selector_over_mismatched_buckets_raises_in_both():
    jtel, jts = _jax()
    for tel, ts in ((telemetry, timeseries), (jtel, jts)):
        reg = tel.Registry()
        agg = ts.WindowedAggregator(reg)
        agg.tick(now=0.0)
        reg.histogram("h", buckets=(1.0,), labels={"k": "a"}).observe(0.5)
        reg.histogram("h", buckets=(2.0,), labels={"k": "b"}).observe(0.5)
        agg.tick(now=1.0)
        with pytest.raises(ValueError, match="different bucket boundaries"):
            agg.quantile("h{}", 0.5)
        for bad in (dict(interval_s=0), dict(capacity=0)):
            with pytest.raises(ValueError):
                ts.WindowedAggregator(reg, **bad)


def test_background_sampler_ticks_and_stops():
    reg = telemetry.Registry()
    with timeseries.WindowedAggregator(reg, interval_s=0.01).start() as agg:
        assert agg.start() is agg  # idempotent
        reg.counter("c").inc()
        deadline = time.monotonic() + 5.0
        while not agg._frames and time.monotonic() < deadline:
            time.sleep(0.01)
    assert agg._frames and not agg._thread.is_alive()


def test_windowed_exports_merge_through_both_packages(pair, tmp_path):
    port, jax = pair
    jtel, _ = _jax()
    snap = port.windowed_snapshot(None, now=8.0)
    a = telemetry.export_snapshot_jsonl(snap, str(tmp_path / "h0.jsonl"), host=0)
    b = jtel.export_snapshot_jsonl(jax.windowed_snapshot(None, now=8.0),
                                   str(tmp_path / "h1.jsonl"), host=1)
    merged = telemetry.merge_exports([a, b])
    assert merged == jtel.merge_exports([a, b])
    assert merged["hosts"] == [0, 1]
    assert merged["counters"]["steps"] == 2 * snap["counters"]["steps"]
