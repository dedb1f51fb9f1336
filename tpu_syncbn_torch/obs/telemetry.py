"""Process-wide structured telemetry: counters, gauges, histograms — the
counterpart of ``tpu_syncbn.obs.telemetry``, kept as a copy (that module is
framework-free, but the JAX package's ``__init__`` imports JAX, so the port
never imports it). The metric names, the snapshot and JSONL schema, the
label encoding and the merge semantics are the JAX module's letter for
letter, so one host's export merges with another's whichever package wrote
it, and one deployment's environment drives both.

Every subsystem (trainers, loader, checkpoints, resilience layer,
rendezvous, collectives, backend probe) records into ONE process-wide
:class:`Registry`, exported as JSONL per host and mergeable into a rank-0
summary. ``tpu_syncbn_torch.bench`` embeds the registry snapshot as the
``telemetry`` block of its JSON line.

Cost contract: telemetry is **off by default** and gated by the
``TPU_SYNCBN_TELEMETRY`` env var (truthy: ``1/true/on/yes``) or an
explicit :func:`set_enabled`. The module-level helpers (:func:`count`,
:func:`observe`, :func:`set_gauge`, :func:`timed`) check one cached bool
and return immediately when disabled — no allocation, no lock, no
instrument creation — so instrumentation can live on hot paths.
Instrument objects obtained directly from a :class:`Registry` (and
:class:`CounterGroup`, the resilience layer's counter surface) always
record: a recovery event must leave a countable trace whether or not
telemetry export is on.

Stdlib only (no torch import at module scope), so any layer can import it
without ordering hazards.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
import warnings
from bisect import bisect_left
from typing import Any, Iterable, Mapping, Sequence

_ENV_FLAG = "TPU_SYNCBN_TELEMETRY"
_TRUTHY = ("1", "true", "on", "yes")

#: Bump when the snapshot/JSONL schema changes incompatibly
#: (tests/test_torch_bench.py pins the bench's block against this).
SCHEMA_VERSION = 1

#: Default histogram buckets for durations in seconds: a 1-2.5-5 log
#: ladder from 100µs to 5min. Fixed buckets (not t-digests) keep
#: ``observe`` O(log n) with no allocation and make cross-host merges a
#: plain vector add.
DEFAULT_TIME_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

#: Default per-family label-combination cap. Labels are a bounded
#: dimension by contract: the first ``cap`` distinct combinations of a
#: family are admitted first-come-first-kept; every later combination
#: collapses deterministically into ONE ``other`` series (all label
#: values ``"other"``) and bumps ``telemetry.cardinality_dropped`` —
#: a producer labeling with request ids degrades to a visible counter,
#: never to unbounded registry growth.
DEFAULT_LABEL_CARDINALITY = 32

#: The label value every overflowed combination collapses to.
OVERFLOW_LABEL_VALUE = "other"

_LABEL_KEY_RE = re.compile(r"[a-z][a-z0-9_]*\Z")
_LABEL_PAIR_RE = re.compile(r'([a-z][a-z0-9_]*)="((?:[^"\\]|\\.)*)"')

_enabled: bool | None = None


def escape_label_value(value: Any) -> str:
    """Prometheus 0.0.4 label-value escaping (backslash, quote, newline)
    — also the canonical form labels take inside an encoded series name,
    so exposition can re-emit the encoded chunk verbatim."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label_value(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def labeled_name(family: str, labels: Mapping[str, Any] | None) -> str:
    """Canonical encoded series name: ``family{k1="v1",k2="v2"}`` with
    keys sorted and values escaped. The encoding IS the registry key —
    snapshot, JSONL export, merge, and windowing machinery all operate
    on encoded names unchanged, and two hosts labeling the same way
    produce byte-identical merge keys."""
    if not labels:
        return family
    if "{" in family or "}" in family:
        raise ValueError(f"metric family {family!r} must not contain braces")
    items = []
    for key in sorted(labels):
        if not _LABEL_KEY_RE.match(key):
            raise ValueError(
                f"label key {key!r} must match [a-z][a-z0-9_]* "
                f"(family {family!r})"
            )
        items.append(f'{key}="{escape_label_value(labels[key])}"')
    return family + "{" + ",".join(items) + "}"


def split_labels(name: str) -> tuple[str, dict[str, str] | None]:
    """Inverse of :func:`labeled_name`: ``(family, labels)`` for an
    encoded series name, ``(name, None)`` for a plain one."""
    if not name.endswith("}"):
        return name, None
    i = name.find("{")
    if i <= 0:
        return name, None
    labels = {m.group(1): _unescape_label_value(m.group(2))
              for m in _LABEL_PAIR_RE.finditer(name[i + 1:-1])}
    return name[:i], labels


def parse_selector(name: str) -> tuple[str, dict[str, str] | None]:
    """Parse an inline label selector (``serve.latency_s{tenant="a"}``)
    into ``(family, selector)``; a plain name parses to ``(name, None)``
    — exact-match semantics, not a match-all selector."""
    return split_labels(name)


def labels_match(series: Mapping[str, str] | None,
                 selector: Mapping[str, str]) -> bool:
    """Superset match: a series satisfies a selector when it carries
    every selector pair (extra series labels are fine)."""
    if not selector:
        return series is not None
    if not series:
        return False
    return all(series.get(k) == v for k, v in selector.items())


def enabled() -> bool:
    """Is telemetry recording on? Cached after the first env read — the
    disabled path is one global load + one ``is None`` + one bool test."""
    global _enabled
    if _enabled is None:
        _enabled = (
            os.environ.get(_ENV_FLAG, "").strip().lower() in _TRUTHY
        )
    return _enabled


def set_enabled(value: bool | None) -> None:
    """Force telemetry on/off, or ``None`` to re-read the env gate on the
    next :func:`enabled` call (tests; ``bench.py`` forces True so its
    ``telemetry`` block is never empty)."""
    global _enabled
    _enabled = None if value is None else bool(value)


# ---------------------------------------------------------------------------
# instruments


class Counter:
    """Monotonic integer counter."""

    kind = "counter"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> int:
        """Add ``n``; returns the new value."""
        with self._lock:
            self._value += int(n)
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """Last-written float value (queue depth, probe latency, load)."""

    kind = "gauge"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> float:
        """Add ``n`` atomically; returns the new value. The level-gauge
        API (in-flight requests, queue depth): producers on different
        threads must NOT read-modify-write via :meth:`set` — two
        concurrent ``set(value + 1)`` calls lose an increment."""
        with self._lock:
            self._value += float(n)
            return self._value

    def dec(self, n: float = 1.0) -> float:
        """Subtract ``n`` atomically; returns the new value."""
        return self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram. ``counts[i]`` is the number of observations
    ``<= buckets[i]`` (and ``counts[-1]`` the overflow above the last
    boundary), so ``len(counts) == len(buckets) + 1``. Also tracks
    count/sum/min/max for cheap means and ranges."""

    kind = "histogram"
    __slots__ = ("name", "buckets", "_lock", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S):
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(set(b)):
            raise ValueError(
                f"histogram buckets must be strictly increasing, got {buckets!r}"
            )
        self.name = name
        self.buckets = b
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)
        self._count = 0
        self._sum = 0.0
        self._min: float | None = None
        self._max: float | None = None

    def observe(self, value: float) -> None:
        v = float(value)
        # bisect_left: v equal to a boundary belongs to that boundary's
        # "<=" bucket, anything above the last boundary to the overflow
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
            }


# ---------------------------------------------------------------------------
# registry


class Registry:
    """Thread-safe name → instrument map. One process-wide instance
    (:data:`REGISTRY`) backs the module helpers; tests build private
    ones. A name is permanently bound to its first kind — a
    counter/gauge/histogram clash raises instead of silently aliasing."""

    def __init__(self):
        self._lock = threading.RLock()
        self._instruments: dict[str, Any] = {}
        # per-family admitted label combinations (encoded names) and
        # explicit cardinality-cap overrides
        self._label_seen: dict[str, set[str]] = {}
        self._label_caps: dict[str, int] = {}

    def _get(self, name: str, factory, kind: str):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif inst.kind != kind:
                raise ValueError(
                    f"telemetry name {name!r} is already a {inst.kind}, "
                    f"not a {kind}"
                )
            return inst

    def set_label_cardinality(self, family: str, cap: int) -> None:
        """Explicit per-family cap on distinct label combinations
        (default :data:`DEFAULT_LABEL_CARDINALITY`). Lowering the cap
        affects only combinations not yet admitted."""
        if int(cap) < 1:
            raise ValueError(f"label cardinality cap must be >= 1, got {cap}")
        with self._lock:
            self._label_caps[family] = int(cap)

    def _labeled(self, family: str, labels: Mapping[str, Any]) -> str:
        """Resolve ``(family, labels)`` to the encoded series name,
        enforcing the per-family cardinality cap: combinations past the
        cap collapse deterministically into the ``other`` series and
        bump ``telemetry.cardinality_dropped`` per routed call."""
        full = labeled_name(family, labels)
        with self._lock:
            seen = self._label_seen.setdefault(family, set())
            if full in seen:
                return full
            cap = self._label_caps.get(family, DEFAULT_LABEL_CARDINALITY)
            if len(seen) < cap:
                seen.add(full)
                return full
        self._get("telemetry.cardinality_dropped",
                  lambda: Counter("telemetry.cardinality_dropped"),
                  "counter").inc()
        return labeled_name(
            family, {k: OVERFLOW_LABEL_VALUE for k in labels})

    def counter(self, name: str, *,
                labels: Mapping[str, Any] | None = None) -> Counter:
        if labels:
            name = self._labeled(name, labels)
        return self._get(name, lambda: Counter(name), "counter")

    def gauge(self, name: str, *,
              labels: Mapping[str, Any] | None = None) -> Gauge:
        if labels:
            name = self._labeled(name, labels)
        return self._get(name, lambda: Gauge(name), "gauge")

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S,
        *, labels: Mapping[str, Any] | None = None,
    ) -> Histogram:
        """Get/create a histogram. ``buckets`` applies only at creation;
        later calls return the existing instrument unchanged."""
        if labels:
            name = self._labeled(name, labels)
        return self._get(name, lambda: Histogram(name, buckets), "histogram")

    def __len__(self) -> int:
        with self._lock:
            return len(self._instruments)

    def reset(self) -> None:
        """Drop every instrument (tests; between bench phases)."""
        with self._lock:
            self._instruments.clear()
            self._label_seen.clear()
            self._label_caps.clear()

    def snapshot(self) -> dict:
        """JSON-ready state of every instrument, grouped by kind:
        ``{"schema": 1, "counters": {...}, "gauges": {...},
        "histograms": {...}}`` — the shape of bench's ``telemetry``
        block (validated by :func:`validate_snapshot`)."""
        with self._lock:
            instruments = list(self._instruments.values())
        out: dict = {
            "schema": SCHEMA_VERSION,
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        for inst in instruments:
            out[inst.kind + "s"][inst.name] = inst.snapshot()
        return out

    def export_jsonl(self, path: str, *, host: int | None = None) -> str:
        """Write one JSON line per instrument (plus a leading ``meta``
        line) — the per-host export half of the rank-0 merge contract
        (:func:`merge_exports`). ``host`` defaults to this process's
        rank (:func:`_host_index`)."""
        return export_snapshot_jsonl(self.snapshot(), path, host=host)


def export_snapshot_jsonl(
    snap: dict, path: str, *, host: int | None = None
) -> str:
    """Write any snapshot-shaped dict (:meth:`Registry.snapshot`, or a
    windowed view from :meth:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator.windowed_snapshot`)
    as a per-host JSONL export that :func:`merge_exports` accepts — ONE
    serialization for cumulative and windowed views, so rank-0
    aggregation of rolling metrics reuses the existing merge/validation
    path instead of growing a second schema."""
    validate_snapshot(snap)
    if host is None:
        host = _host_index()
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({
            "kind": "meta", "schema": SCHEMA_VERSION, "host": host,
            "wall_time": round(time.time(), 3),
        }) + "\n")
        for name, v in snap["counters"].items():
            f.write(json.dumps({
                "kind": "counter", "name": name, "host": host, "value": v,
            }) + "\n")
        for name, v in snap["gauges"].items():
            f.write(json.dumps({
                "kind": "gauge", "name": name, "host": host, "value": v,
            }) + "\n")
        for name, h in snap["histograms"].items():
            f.write(json.dumps({
                "kind": "histogram", "name": name, "host": host, **h,
            }) + "\n")
    return path


def _host_index() -> int:
    """This process's rank when a ``torch.distributed`` group is already
    initialized, else ``RANK`` from the environment (the launcher's), else
    0. Never initializes anything: telemetry must work before (or
    without) a process group, and a trace or export must never touch a
    possibly-hung backend."""
    try:
        import sys

        tdist = sys.modules.get("torch.distributed")
        if (tdist is not None and tdist.is_available()
                and tdist.is_initialized()):
            return int(tdist.get_rank())
    except Exception:
        pass
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


#: The process-wide registry every subsystem records into.
REGISTRY = Registry()


# ---------------------------------------------------------------------------
# module helpers (the hot-path API: no-ops when disabled)


def count(name: str, n: int = 1,
          labels: Mapping[str, Any] | None = None) -> None:
    """Bump counter ``name`` in the process registry (no-op when
    telemetry is disabled). ``labels`` routes to the encoded labeled
    series (cardinality-capped); the unlabeled path is unchanged."""
    if not enabled():
        return
    if labels is None:
        REGISTRY.counter(name).inc(n)
    else:
        REGISTRY.counter(name, labels=labels).inc(n)


def set_gauge(name: str, value: float,
              labels: Mapping[str, Any] | None = None) -> None:
    if not enabled():
        return
    if labels is None:
        REGISTRY.gauge(name).set(value)
    else:
        REGISTRY.gauge(name, labels=labels).set(value)


def inc_gauge(name: str, n: float = 1.0,
              labels: Mapping[str, Any] | None = None) -> None:
    """Atomically add ``n`` to gauge ``name`` (no-op when disabled) —
    the level-gauge producer path (:meth:`Gauge.inc`): concurrent
    producers must not ``set(read() + 1)``."""
    if not enabled():
        return
    if labels is None:
        REGISTRY.gauge(name).inc(n)
    else:
        REGISTRY.gauge(name, labels=labels).inc(n)


def observe(
    name: str, value: float,
    buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S,
    labels: Mapping[str, Any] | None = None,
) -> None:
    if not enabled():
        return
    if labels is None:
        REGISTRY.histogram(name, buckets).observe(value)
    else:
        REGISTRY.histogram(name, buckets, labels=labels).observe(value)


@contextlib.contextmanager
def timed(name: str, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S,
          labels: Mapping[str, Any] | None = None):
    """Time a block into histogram ``name`` (seconds). Disabled path:
    zero instruments touched, one clock read avoided."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe(name, time.perf_counter() - t0, buckets, labels)


# once-per-process-per-name DeprecationWarning for renamed metric
# families (the suffix-metric -> label migration): old flat names keep
# publishing so dashboards and BASELINE anchors keep resolving, but each
# warns once at its first mirror
_deprecated_lock = threading.Lock()
_deprecated_warned: set[str] = set()


def warn_deprecated_name(old: str, new: str) -> None:
    """Warn (once per process per ``old``) that a flat metric name is a
    deprecated mirror of a labeled family."""
    with _deprecated_lock:
        if old in _deprecated_warned:
            return
        _deprecated_warned.add(old)
    warnings.warn(
        f"telemetry name {old!r} is a deprecated flat mirror; read the "
        f"labeled family {new!r} instead",
        DeprecationWarning, stacklevel=3,
    )


def reset_deprecated_warnings() -> None:
    """Forget which deprecated names already warned (tests)."""
    with _deprecated_lock:
        _deprecated_warned.clear()


def snapshot() -> dict:
    """Snapshot of the process registry (see :meth:`Registry.snapshot`)."""
    return REGISTRY.snapshot()


# ---------------------------------------------------------------------------
# counter groups (the EventCounter surface)


class CounterGroup:
    """Instance-local monotonic named counters — the resilience layer's
    event-count surface (``utils.EventCounter`` is a deprecated alias).
    Thread-safe: signal handlers and watchdog threads bump concurrently
    with the step loop.

    ``prefix`` is the bridge into the shared export path: when set and
    telemetry is enabled, every bump is mirrored into the process
    :data:`REGISTRY` as ``{prefix}.{name}`` — so resilience events
    (rollbacks, rendezvous retries, watchdog stalls) ride the same JSONL
    export and bench ``telemetry`` block as everything else, while the
    instance's own counts keep working unconditionally (ResilientLoop's
    summary does not depend on the telemetry gate)."""

    def __init__(self, prefix: str | None = None, *, registry: Registry | None = None):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self.prefix = prefix
        self._registry = registry

    def bump(self, name: str, n: int = 1,
             labels: Mapping[str, Any] | None = None) -> int:
        """Increment ``name`` by ``n``; returns the new count. The
        instance-local count and the unlabeled registry mirror always
        aggregate across labels; ``labels`` additionally mirrors the
        labeled series (so per-tenant counters ride next to the
        aggregate, never instead of it)."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            value = self._counts[name]
        if self.prefix and enabled():
            reg = self._registry if self._registry is not None else REGISTRY
            reg.counter(f"{self.prefix}.{name}").inc(n)
            if labels:
                reg.counter(f"{self.prefix}.{name}", labels=labels).inc(n)
        return value

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def summary(self) -> dict:
        """Snapshot of every counter (plain dict, JSON-ready)."""
        with self._lock:
            return dict(self._counts)

    def __repr__(self):
        return f"{type(self).__name__}({self.summary()!r})"


# ---------------------------------------------------------------------------
# merge / validation


def read_jsonl(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def merge_exports(paths: Iterable[str]) -> dict:
    """Rank-0 merge of per-host JSONL exports (:meth:`Registry.export_jsonl`)
    into one summary dict shaped like :meth:`Registry.snapshot` plus a
    ``hosts`` list.

    Merge semantics: counters and histogram vectors **sum** across hosts
    (bucket boundaries must agree — drift raises, it means the hosts ran
    different code); histogram min/max take the elementwise extremes;
    gauges are last-write-wins in ``paths`` order (they are point-in-time
    readings, not accumulations) — per-host gauge values survive in the
    per-host files."""
    hosts: set[int] = set()
    counters: dict[str, int] = {}
    gauges: dict[str, float] = {}
    hists: dict[str, dict] = {}
    for path in paths:
        for row in read_jsonl(path):
            kind = row.get("kind")
            if kind == "meta":
                if row.get("schema") != SCHEMA_VERSION:
                    raise ValueError(
                        f"telemetry export {path!r} has schema "
                        f"{row.get('schema')!r}, expected {SCHEMA_VERSION}"
                    )
                hosts.add(int(row.get("host", 0)))
                continue
            name = row["name"]
            hosts.add(int(row.get("host", 0)))
            if kind == "counter":
                counters[name] = counters.get(name, 0) + int(row["value"])
            elif kind == "gauge":
                gauges[name] = float(row["value"])
            elif kind == "histogram":
                cur = hists.get(name)
                if cur is None:
                    hists[name] = {
                        "buckets": list(row["buckets"]),
                        "counts": list(row["counts"]),
                        "count": int(row["count"]),
                        "sum": float(row["sum"]),
                        "min": row.get("min"),
                        "max": row.get("max"),
                    }
                else:
                    if cur["buckets"] != list(row["buckets"]):
                        raise ValueError(
                            f"histogram {name!r} bucket boundaries differ "
                            "across hosts — refusing to merge mismatched "
                            "schemas"
                        )
                    cur["counts"] = [
                        a + b for a, b in zip(cur["counts"], row["counts"])
                    ]
                    cur["count"] += int(row["count"])
                    cur["sum"] += float(row["sum"])
                    for key, pick in (("min", min), ("max", max)):
                        vals = [v for v in (cur[key], row.get(key))
                                if v is not None]
                        cur[key] = pick(vals) if vals else None
    return {
        "schema": SCHEMA_VERSION,
        "hosts": sorted(hosts),
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
    }


def write_merged_summary(paths: Iterable[str], out_path: str) -> dict:
    """Merge per-host exports and write the summary JSON (master-host
    convenience; call it from rank 0 only)."""
    summary = merge_exports(paths)
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def validate_snapshot(snap: Any) -> dict:
    """Schema check for a snapshot / bench ``telemetry`` block; returns
    it on success, raises ``ValueError`` on drift (what
    tests/test_torch_bench.py pins, so output drift fails the tests)."""
    if not isinstance(snap, dict):
        raise ValueError(f"telemetry block must be a dict, got {type(snap)}")
    if snap.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"telemetry schema {snap.get('schema')!r} != {SCHEMA_VERSION}"
        )
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(snap.get(section), dict):
            raise ValueError(f"telemetry block missing dict section {section!r}")
    for name, v in snap["counters"].items():
        if not isinstance(v, int) or isinstance(v, bool):
            raise ValueError(f"counter {name!r} value {v!r} is not an int")
    for name, v in snap["gauges"].items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"gauge {name!r} value {v!r} is not numeric")
    for name, h in snap["histograms"].items():
        if not isinstance(h, dict):
            raise ValueError(f"histogram {name!r} is not a dict")
        buckets, counts = h.get("buckets"), h.get("counts")
        if (not isinstance(buckets, list) or not isinstance(counts, list)
                or len(counts) != len(buckets) + 1):
            raise ValueError(
                f"histogram {name!r} needs len(counts) == len(buckets)+1"
            )
        if h.get("count") != sum(counts):
            raise ValueError(
                f"histogram {name!r} count {h.get('count')!r} != sum of "
                "bucket counts"
            )
        if not isinstance(h.get("sum"), (int, float)):
            raise ValueError(f"histogram {name!r} sum is not numeric")
    return snap
