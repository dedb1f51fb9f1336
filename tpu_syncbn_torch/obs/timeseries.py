"""Windowed time series over the telemetry registry: rolling rates and
rolling-window quantiles for a *running* process — the counterpart of
``tpu_syncbn.obs.timeseries``, kept as a copy (stdlib only; the JAX
package's ``__init__`` imports JAX, so the port never imports it). The
frame layout, the arithmetic and the snapshot it renders are the JAX
module's, so the same events on the same clock give the same numbers in
either package.

The registry (:mod:`tpu_syncbn_torch.obs.telemetry`) accumulates process-
lifetime totals — the right shape for an end-of-run export, useless for
the operator question "what is this host doing *now*?" (current steps/s,
rolling p99, whether the step counter is still moving). This module is
the delta layer between the two:

* :class:`WindowedAggregator` samples the registry on a fixed interval
  (:meth:`~WindowedAggregator.tick`, or the :meth:`~WindowedAggregator.start`
  background sampler) into a ring buffer of **per-interval deltas** —
  counter increments, histogram bucket-count increments, gauge readings.
  Memory is bounded by ``capacity`` frames regardless of run length.
* :meth:`~WindowedAggregator.rate` turns counter (or histogram-count)
  deltas into events/second over the trailing window — steps/s,
  collective bytes/s (``collectives.<op>.bytes`` counters feed straight
  in).
* :meth:`~WindowedAggregator.quantile` estimates p50/p99 over the last N
  seconds from the merged windowed bucket counts (linear interpolation
  inside the straddling bucket), and
  :meth:`~WindowedAggregator.fraction_above` the share of observations
  past a threshold — the inputs of the SLO layer
  (:mod:`~tpu_syncbn_torch.obs.slo`).
* :meth:`~WindowedAggregator.windowed_snapshot` renders the window as a
  **snapshot-shaped dict** (``telemetry.SCHEMA_VERSION``), so it passes
  :func:`~tpu_syncbn_torch.obs.telemetry.validate_snapshot` and exports
  through :func:`~tpu_syncbn_torch.obs.telemetry.export_snapshot_jsonl`
  into the existing :func:`~tpu_syncbn_torch.obs.telemetry.merge_exports`
  rank-0 path — windowed multi-host aggregation reuses the cumulative
  schema instead of inventing a second one.

All timing is ``time.monotonic()``: the wall clock steps and slews under
NTP, and a rate window fed wall-clock deltas would read those as traffic.
Tests inject ``now``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Sequence

from tpu_syncbn_torch.obs import telemetry


def quantile_from_counts(
    buckets: Sequence[float], counts: Sequence[int], q: float
) -> float | None:
    """Quantile estimate from fixed-bucket histogram counts
    (``len(counts) == len(buckets) + 1``, trailing overflow). Linear
    interpolation inside the straddling bucket; the overflow bucket
    reports its lower boundary (the estimate saturates there — fixed
    buckets cannot see beyond their last edge). ``None`` when empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if seen + c >= target:
            lo = buckets[i - 1] if i >= 1 else 0.0
            hi = buckets[i] if i < len(buckets) else None
            if hi is None:
                return float(lo)  # overflow: saturate at the last edge
            frac = (target - seen) / c
            return float(lo + (hi - lo) * min(1.0, max(0.0, frac)))
        seen += c
    return float(buckets[-1])


def _series_matches(series: str, family: str, sel: dict) -> bool:
    """Does windowed series ``series`` satisfy a label selector? The
    series' family must equal the selector's and its labels must be a
    superset of the selector's pairs (``family{}`` matches every
    labeled series of the family)."""
    s_family, s_labels = telemetry.split_labels(series)
    return s_family == family and telemetry.labels_match(s_labels, sel)


class _Frame:
    """One sampling interval's deltas (and gauge readings)."""

    __slots__ = ("t0", "t1", "counters", "hists", "gauges")

    def __init__(self, t0: float, t1: float, counters: dict,
                 hists: dict, gauges: dict):
        self.t0 = t0
        self.t1 = t1
        self.counters = counters  # name -> int delta
        self.hists = hists        # name -> {"buckets", "counts", "count", "sum"}
        self.gauges = gauges      # name -> float reading at t1


class WindowedAggregator:
    """Ring buffer of per-interval registry deltas.

    ``interval_s`` is the target sampling cadence of the background
    sampler (:meth:`start`); :meth:`tick` can also be driven manually
    (tests inject ``now`` for determinism). ``capacity`` bounds retained
    frames — the longest answerable window is ``capacity x interval_s``
    (defaults: 120 x 1s = 2 minutes).

    Thread-safe: the sampler thread ticks while HTTP handlers
    (the monitoring server) and the SLO evaluator read.
    """

    def __init__(
        self,
        registry: telemetry.Registry | None = None,
        *,
        interval_s: float = 1.0,
        capacity: int = 120,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._registry = registry if registry is not None else telemetry.REGISTRY
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._frames: deque[_Frame] = deque(maxlen=capacity)
        self._prev: dict | None = None  # last cumulative snapshot
        self._prev_t: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- sampling ----------------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        """Sample the registry once: record the delta since the previous
        tick as a frame. The first tick only anchors the baseline (there
        is no interval to delta over yet)."""
        t = time.monotonic() if now is None else float(now)
        snap = self._registry.snapshot()
        with self._lock:
            prev, prev_t = self._prev, self._prev_t
            self._prev, self._prev_t = snap, t
            if prev is None or t <= prev_t:
                return
            counters = {}
            for name, v in snap["counters"].items():
                d = v - prev["counters"].get(name, 0)
                if d > 0:  # negative = registry reset: re-anchor silently
                    counters[name] = d
            hists = {}
            for name, h in snap["histograms"].items():
                ph = prev["histograms"].get(name)
                if ph is not None and ph["buckets"] != h["buckets"]:
                    ph = None  # registry reset/rebuilt: re-anchor
                pc = ph["counts"] if ph else [0] * len(h["counts"])
                dc = [a - b for a, b in zip(h["counts"], pc)]
                d_count = h["count"] - (ph["count"] if ph else 0)
                if d_count <= 0 or any(c < 0 for c in dc):
                    continue  # reset between ticks, or nothing new
                hists[name] = {
                    "buckets": list(h["buckets"]),
                    "counts": dc,
                    "count": d_count,
                    "sum": h["sum"] - (ph["sum"] if ph else 0.0),
                }
            self._frames.append(_Frame(
                prev_t, t, counters, hists, dict(snap["gauges"])
            ))

    def start(self) -> "WindowedAggregator":
        """Start the background sampler thread (daemon; idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-timeseries", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        self.tick()  # anchor the baseline immediately
        while not self._stop.wait(self.interval_s):
            self.tick()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)

    def __enter__(self) -> "WindowedAggregator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- queries -----------------------------------------------------------

    def _window_frames(
        self, window_s: float | None, now: float | None = None
    ) -> tuple[list[_Frame], float]:
        """Frames overlapping the trailing window, plus the covered
        duration (sum of frame spans — gaps in sampling are not counted
        as observed time, so a stalled sampler cannot dilute a rate)."""
        with self._lock:
            frames = list(self._frames)
        if not frames:
            return [], 0.0
        if window_s is not None:
            t = (time.monotonic() if now is None else float(now))
            cutoff = t - float(window_s)
            frames = [f for f in frames if f.t1 > cutoff]
        covered = sum(f.t1 - f.t0 for f in frames)
        return frames, covered

    def rate(
        self, name: str, window_s: float | None = None,
        *, now: float | None = None,
    ) -> float | None:
        """Events/second for counter ``name`` over the trailing window
        (whole ring when ``window_s`` is None). Histogram names report
        their observation-count rate — ``rate("step.time_s")`` IS
        steps/s. ``None`` with no covered frames.

        ``name`` may be a label selector (``serve.requests{tenant="a"}``):
        a plain name matches exactly that series (labeled children are
        NOT summed in), while a selector sums deltas across every series
        of the family whose labels contain the selector's pairs."""
        frames, covered = self._window_frames(window_s, now)
        if covered <= 0:
            return None
        family, sel = telemetry.parse_selector(name)
        total = 0.0
        for f in frames:
            if sel is None:
                total += f.counters.get(name, 0)
                h = f.hists.get(name)
                if h is not None:
                    total += h["count"]
            else:
                for series, d in f.counters.items():
                    if _series_matches(series, family, sel):
                        total += d
                for series, h in f.hists.items():
                    if _series_matches(series, family, sel):
                        total += h["count"]
        return total / covered

    def _merged_counts(
        self, name: str, window_s: float | None, now: float | None,
    ) -> tuple[list[float], list[int]] | None:
        """Histogram ``name``'s bucket boundaries + summed windowed
        counts over the trailing window, or ``None`` when absent.
        Selector names merge every matching labeled series; a bucket-
        boundary mismatch across matched series raises (summing counts
        from differently-bucketed histograms is silent nonsense). Plain
        names keep the historical behavior: exact match only, frames
        with drifted buckets re-anchor silently."""
        frames, _ = self._window_frames(window_s, now)
        family, sel = telemetry.parse_selector(name)
        buckets: list[float] | None = None
        counts: list[int] | None = None
        for f in frames:
            if sel is None:
                matched = [f.hists[name]] if name in f.hists else []
            else:
                matched = [
                    h for series, h in f.hists.items()
                    if _series_matches(series, family, sel)
                ]
            for h in matched:
                if buckets is None:
                    buckets = h["buckets"]
                    counts = list(h["counts"])
                elif h["buckets"] == buckets:
                    counts = [a + b for a, b in zip(counts, h["counts"])]
                elif sel is not None:
                    raise ValueError(
                        f"selector {name!r} matched histograms with "
                        f"different bucket boundaries: {buckets} vs "
                        f"{h['buckets']}"
                    )
        if buckets is None or counts is None:
            return None
        return buckets, counts

    def quantile(
        self, name: str, q: float, window_s: float | None = None,
        *, now: float | None = None,
    ) -> float | None:
        """Quantile estimate for histogram ``name`` over the trailing
        window (merged windowed bucket counts). ``None`` when the window
        holds no observations."""
        merged = self._merged_counts(name, window_s, now)
        if merged is None:
            return None
        return quantile_from_counts(*merged, q)

    def fraction_above(
        self, name: str, threshold: float,
        window_s: float | None = None, *, now: float | None = None,
    ) -> float | None:
        """Fraction of windowed observations of histogram ``name`` above
        ``threshold`` (linear interpolation inside the straddling
        bucket) — the latency-SLO error-rate estimator
        (``obs.slo``). ``None`` when the window is empty.

        Overflow attribution: observations beyond the last bucket edge
        count as above only when ``threshold <= last edge`` — with a
        threshold past the edge their position is unknowable, and an
        alert engine must fire on evidence, not on bucket blindness
        (pick buckets that cover the objective's threshold)."""
        merged = self._merged_counts(name, window_s, now)
        if merged is None:
            return None
        buckets, counts = merged
        total = sum(counts)
        if total <= 0:
            return None
        above = 0.0
        for i, c in enumerate(counts):
            lo = buckets[i - 1] if i >= 1 else 0.0
            hi = buckets[i] if i < len(buckets) else None
            if hi is not None and hi <= threshold:
                continue
            if lo >= threshold:
                above += c
            elif hi is not None:  # straddling bucket: assume uniform
                above += c * (hi - threshold) / (hi - lo)
            # else: overflow with threshold past the last edge —
            # unattributable, excluded (see docstring)
        return above / total

    def windowed_snapshot(
        self, window_s: float | None = None, *, now: float | None = None,
    ) -> dict:
        """The trailing window rendered in the cumulative snapshot's
        schema (``validate_snapshot``-clean): counters are windowed
        deltas, histograms windowed bucket counts (min/max are ``None``
        — extremes are not derivable from cumulative extremes), gauges
        the latest reading, plus a ``window`` block (covered seconds,
        frame count) the merge path ignores. Export per host via
        :func:`telemetry.export_snapshot_jsonl`, merge with
        :func:`telemetry.merge_exports`."""
        frames, covered = self._window_frames(window_s, now)
        counters: dict[str, int] = {}
        hists: dict[str, dict] = {}
        gauges: dict[str, float] = {}
        for f in frames:
            for name, d in f.counters.items():
                counters[name] = counters.get(name, 0) + d
            for name, h in f.hists.items():
                cur = hists.get(name)
                if cur is None:
                    hists[name] = {
                        "buckets": list(h["buckets"]),
                        "counts": list(h["counts"]),
                        "count": h["count"],
                        "sum": h["sum"],
                        "min": None,
                        "max": None,
                    }
                elif cur["buckets"] == h["buckets"]:
                    cur["counts"] = [
                        a + b for a, b in zip(cur["counts"], h["counts"])
                    ]
                    cur["count"] += h["count"]
                    cur["sum"] += h["sum"]
            gauges.update(f.gauges)
        return {
            "schema": telemetry.SCHEMA_VERSION,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "window": {
                "covered_s": round(covered, 6),
                "frames": len(frames),
                "interval_s": self.interval_s,
            },
        }
