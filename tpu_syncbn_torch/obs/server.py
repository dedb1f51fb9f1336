"""Live monitoring endpoints: ``/metrics``, ``/healthz``, ``/readyz``,
``/statusz``, ``POST /incidentz`` and ``POST /profilez`` — the
counterpart of ``tpu_syncbn.obs.server`` (the JAX package's ``__init__``
imports JAX, so the port keeps its own copy; routes, payloads, metric
names, the exposition and the status page are the JAX module's, byte for
byte on the same inputs).

The surface a load balancer, a Prometheus scraper or a k8s probe points
at. Stdlib only (``http.server`` on a daemon thread), **off by default**:
nothing listens unless ``TPU_SYNCBN_METRICS_PORT`` is set
(:func:`start_from_env` — :class:`~tpu_syncbn_torch.runtime.resilience.ResilientLoop`
calls it, so exporting the port is the only knob a training run needs) or
a :class:`MonitoringServer` is built explicitly (tests bind port 0).

* ``/metrics`` — Prometheus text exposition (``text/plain; version=0.0.4``)
  rendered from the telemetry registry: counters as ``*_total``, gauges
  plain, histograms as cumulative ``_bucket{le=...}`` / ``_sum`` /
  ``_count`` families with correct ``# TYPE`` lines.
* ``/healthz`` — liveness: every registered heartbeat
  (:data:`HEARTBEATS`; ``ResilientLoop`` beats once a step or chunk, as
  ``"train"``) must be younger than ``max_age``; otherwise 503 with the
  stale sources named. A process that answers but whose step loop stopped
  moving is the "stuck host" a cumulative export cannot see.
* ``/readyz`` — readiness: every hook in the process readiness registry
  (:func:`register_readiness`) must pass — the loop's hook (preemption
  not signaled, no divergence rollback in progress) and any attached SLO
  alert state (:meth:`tpu_syncbn_torch.obs.slo.SLOTracker.attach`). A
  raising hook reads as not ready (fail closed).
* ``/statusz`` — one text page of process state (:func:`statusz_report`,
  :func:`render_statusz`); ``POST /incidentz`` dumps a flight-recorder
  bundle; ``POST /profilez`` runs a bounded ``torch.profiler`` capture
  (``obs.profiling.serve_capture``, which hands a CUDA capture to the main
  thread's loop).

The HTTP thread touches no CUDA tensor: a scrape renders the registry's
host values, so it issues no synchronize and never waits on the card.
Incident bundles (:mod:`tpu_syncbn_torch.obs.incident`) embed the
heartbeat ages and the readiness verdict. Six monitoring metric names are
pinned (:data:`MONITOR_METRICS`).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from tpu_syncbn_torch.obs import telemetry

_ENV_PORT = "TPU_SYNCBN_METRICS_PORT"

#: The live-monitoring layer's own pinned metric names (the JAX module's).
MONITOR_METRICS = (
    "obs.server.requests",      # counter: HTTP requests answered
    "obs.server.scrape_s",      # histogram: /metrics render+serve latency
    "obs.alert.fired",          # counter: SLO alert rule transitions to firing
    "obs.alert.resolved",       # counter: SLO alert rule resolutions
    "slo.evaluations",          # counter: SLO rule-set evaluations
    "monitor.heartbeat_age_s",  # gauge: oldest registered heartbeat age
)


# ---------------------------------------------------------------------------
# liveness: heartbeats


class Heartbeats:
    """Named liveness beats on the monotonic clock. Producers call
    :meth:`beat` from their hot loop (a dict store under a lock — cheap
    enough per step); ``/healthz`` reads :meth:`ages`. ``now`` is
    injectable for deterministic tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._beats: dict[str, float] = {}

    def beat(self, source: str, now: float | None = None) -> None:
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._beats[source] = t

    def clear(self, source: str | None = None) -> None:
        with self._lock:
            if source is None:
                self._beats.clear()
            else:
                self._beats.pop(source, None)

    def ages(self, now: float | None = None) -> dict[str, float]:
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            return {name: max(0.0, t - ts) for name, ts in self._beats.items()}


#: Process-wide heartbeat table every producer beats into.
HEARTBEATS = Heartbeats()


# ---------------------------------------------------------------------------
# readiness: hook registry


_readiness_lock = threading.Lock()
_readiness: dict[str, Callable[[], tuple[bool, dict]]] = {}


def register_readiness(
    name: str, fn: Callable[[], tuple[bool, dict]]
) -> None:
    """Register (or replace) readiness hook ``name``. ``fn`` returns
    ``(ok, detail_dict)``; a raising hook reads as NOT ready (fail
    closed — an un-evaluable readiness claim is not a ready signal)."""
    with _readiness_lock:
        _readiness[name] = fn


def unregister_readiness(name: str) -> None:
    with _readiness_lock:
        _readiness.pop(name, None)


def evaluate_readiness() -> tuple[bool, dict]:
    """Run every registered hook; overall ok is the conjunction."""
    with _readiness_lock:
        hooks = dict(_readiness)
    ok = True
    checks: dict[str, dict] = {}
    for name, fn in sorted(hooks.items()):
        try:
            hook_ok, detail = fn()
            hook_ok = bool(hook_ok)
        except Exception as e:  # fail closed, never crash the endpoint
            hook_ok, detail = False, {"error": f"{type(e).__name__}: {e}"}
        checks[name] = {"ok": hook_ok, **dict(detail)}
        ok = ok and hook_ok
    return ok, checks


# ---------------------------------------------------------------------------
# Prometheus text exposition


_NAME_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, namespace: str) -> str:
    return f"{namespace}_{_NAME_SANITIZE_RE.sub('_', name)}"


def _prom_num(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _prom_split(name: str) -> tuple[str, str]:
    """Split a registry name into (family, label chunk). The encoded
    chunk (``{k="v",...}`` — keys sorted, values escaped by
    :func:`telemetry.labeled_name`) is already valid Prometheus label
    syntax, so it re-emits verbatim; only the family passes through the
    name-charset sanitizer."""
    family, sep, rest = name.partition("{")
    return family, sep + rest


def _prom_sort_key(name: str) -> tuple[str, str]:
    # group label variants under their family: ``{`` sorts after every
    # name character (ASCII 123), so a raw sort would interleave e.g.
    # ``serve.latency_s2`` between ``serve.latency_s`` and its labeled
    # series and duplicate the family's # TYPE line
    return _prom_split(name)


def render_prometheus(snap: dict, *, namespace: str = "tpu_syncbn") -> str:
    """Render a snapshot-shaped dict (``Registry.snapshot()``) as
    Prometheus text exposition format 0.0.4: counters become
    ``<ns>_<name>_total``, gauges ``<ns>_<name>``, histograms the
    ``_bucket{le=...}`` (cumulative counts, closed with ``le="+Inf"``) /
    ``_sum`` / ``_count`` family — each with its ``# TYPE`` line.
    Dots in registry names become underscores (Prometheus name charset).
    Labeled series (``family{k="v"}`` registry names) render under
    their family's single ``# TYPE`` line, unlabeled series first, with
    the label chunk emitted verbatim; histogram bucket lines splice
    ``le`` after the series labels."""
    lines: list[str] = []
    prev = None
    for name in sorted(snap.get("counters", {}), key=_prom_sort_key):
        family, chunk = _prom_split(name)
        pn = _prom_name(family, namespace) + "_total"
        if family != prev:
            lines.append(f"# TYPE {pn} counter")
            prev = family
        lines.append(f"{pn}{chunk} {_prom_num(snap['counters'][name])}")
    prev = None
    for name in sorted(snap.get("gauges", {}), key=_prom_sort_key):
        family, chunk = _prom_split(name)
        pn = _prom_name(family, namespace)
        if family != prev:
            lines.append(f"# TYPE {pn} gauge")
            prev = family
        lines.append(f"{pn}{chunk} {_prom_num(snap['gauges'][name])}")
    prev = None
    for name in sorted(snap.get("histograms", {}), key=_prom_sort_key):
        h = snap["histograms"][name]
        family, chunk = _prom_split(name)
        pn = _prom_name(family, namespace)
        if family != prev:
            lines.append(f"# TYPE {pn} histogram")
            prev = family
        # series labels precede ``le`` inside one brace pair
        le_open = "{" + chunk[1:-1] + "," if chunk else "{"
        cum = 0
        for edge, c in zip(h["buckets"], h["counts"]):
            cum += c
            lines.append(
                f'{pn}_bucket{le_open}le="{_prom_num(edge)}"}} {cum}'
            )
        lines.append(f'{pn}_bucket{le_open}le="+Inf"}} {h["count"]}')
        lines.append(f"{pn}_sum{chunk} {_prom_num(h['sum'])}")
        lines.append(f"{pn}_count{chunk} {h['count']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# /statusz: one human-readable page of process state


def statusz_report(
    *, registry: telemetry.Registry | None = None, now: float | None = None,
) -> dict:
    """Gather the ``/statusz`` inputs into one JSON-ready dict:
    heartbeats, readiness checks, attached SLO alert state, circuit-
    breaker gauges, program-cache counters, and the last incident. The
    rendering (:func:`render_statusz`) is a pure function of this dict,
    so the page text is golden-pinnable like ``/metrics``."""
    from tpu_syncbn_torch.obs import flightrec, slo as obs_slo

    reg = registry if registry is not None else telemetry.REGISTRY
    snap = reg.snapshot()
    ready_ok, checks = evaluate_readiness()
    # circuit breakers, grouped by breaker family: the default breaker's
    # plain ``serve.circuit_state`` gauge keys as "serve", labeled
    # series key by their ``family`` label, and legacy dotted-suffix
    # names (mirrored behind a DeprecationWarning) fill in only when no
    # labeled twin exists
    circuits: dict[str, float] = {}
    for name, value in snap["gauges"].items():
        if name == "serve.circuit_state":
            circuits["serve"] = value
        elif name.startswith("serve.circuit_state{"):
            _, labels = telemetry.split_labels(name)
            circuits[(labels or {}).get("family", name)] = value
    for name, value in snap["gauges"].items():
        if name.startswith("serve.circuit_state."):
            circuits.setdefault(
                name[len("serve.circuit_state."):], value
            )
    # program caches, grouped by cache family: labeled
    # ``scan.program_cache.<field>{family=...}`` counters first, then
    # legacy ``<name>.program_cache.<field>`` mirrors fill gaps
    caches: dict[str, dict] = {}
    legacy_caches: list[tuple[str, str, float]] = []
    for name, value in snap["counters"].items():
        base, sep, rest = name.partition(".program_cache.")
        if not sep:
            continue
        field, brace, _ = rest.partition("{")
        if brace:
            _, labels = telemetry.split_labels(name)
            caches.setdefault(
                (labels or {}).get("family", base), {}
            )[field] = value
        else:
            legacy_caches.append((base, field, value))
    for base, field, value in legacy_caches:
        caches.setdefault(base, {}).setdefault(field, value)
    # weight publication (serve.publish): live version pair + swap /
    # rollback / rejection tallies, so "which weights is this process
    # serving, and how did they get there" is on the one-glance page.
    # Reads the labeled ``serve.version{mode=...}`` series, falling back
    # to the legacy flat names, but keeps the legacy report keys so the
    # page layout is stable.
    publication: dict = {}
    for mode, legacy in (("active", "serve.version.active"),
                         ("previous", "serve.version.previous")):
        labeled = telemetry.labeled_name("serve.version", {"mode": mode})
        if labeled in snap["gauges"]:
            publication[legacy] = snap["gauges"][labeled]
        elif legacy in snap["gauges"]:
            publication[legacy] = snap["gauges"][legacy]
    for name in ("serve.swaps_total", "serve.rollbacks_total",
                 "serve.swap_rejected_total"):
        if name in snap["counters"]:
            publication[name] = snap["counters"][name]
    swap_hist = snap["histograms"].get("serve.swap_s")
    if swap_hist is not None:
        publication["serve.swap_s.count"] = swap_hist.get("count")
        publication["serve.swap_s.sum"] = round(
            swap_hist.get("sum", 0.0), 4
        )
    # numerics drift/compression health (obs.numerics): the
    # published per-monitor histograms plus the sample/saturation/trip
    # counters, so the drift story is on the one-glance page
    numerics: dict[str, dict] = {}
    for name, h in snap["histograms"].items():
        if name.startswith("numerics."):
            numerics[name] = {"count": h.get("count"), "max": h.get("max")}
    numerics_counters = {
        name: value for name, value in snap["counters"].items()
        if name.startswith("numerics.")
    }
    # memory + compile (obs.memwatch / obs.profiling): live
    # watermark gauges vs the pinned contract, and the compile-seam
    # counters with the time histogram's totals, so recompile churn and
    # shrinking headroom are on the one-glance page
    memory = {
        name: value for name, value in snap["gauges"].items()
        if name.startswith("mem.")
    }
    memory_counters = {
        name: value for name, value in snap["counters"].items()
        if name.startswith("mem.")
    }
    compiles = {
        name: value for name, value in snap["counters"].items()
        if name.startswith("compile.")
    }
    compile_hist = snap["histograms"].get("compile.time_s")
    if compile_hist is not None:
        compiles["compile.time_s.count"] = compile_hist.get("count")
        compiles["compile.time_s.sum"] = round(
            compile_hist.get("sum", 0.0), 4
        )
    # autopilot (runtime.autopilot.Autopilot): per-knob state gauges
    # and the actuation/clamp/suppression tallies, read from the
    # registry (no runtime import — the controller publishes, /statusz
    # renders), so "is something turning my knobs, and where are they"
    # is on the one-glance page
    autopilot: dict = {}
    for name, value in snap["gauges"].items():
        if name.startswith("autopilot."):
            autopilot[name] = value
    for name, value in snap["counters"].items():
        if name.startswith("autopilot."):
            autopilot[name] = value
    rec = flightrec.get()
    return {
        "heartbeat_age_s": {
            n: round(a, 3) for n, a in sorted(HEARTBEATS.ages(now).items())
        },
        "readiness": {"ok": ready_ok, "checks": checks},
        "alerts": obs_slo.tracker_states(),
        "circuits": circuits,
        "program_caches": caches,
        "publication": publication,
        "numerics": numerics,
        "numerics_counters": numerics_counters,
        "memory": memory,
        "memory_counters": memory_counters,
        "compiles": compiles,
        "autopilot": autopilot,
        "train_step": snap["gauges"].get("train.step"),
        "last_incident": rec.last_incident if rec is not None else None,
        "recorder_installed": rec is not None,
    }


_CIRCUIT_NAMES = {0: "closed", 1: "half_open", 2: "open"}


def render_statusz(report: dict) -> str:
    """Render a :func:`statusz_report` dict as the ``/statusz`` text
    page — deterministic for a given report (sorted keys, fixed layout),
    so the page text is golden-pinnable like the ``/metrics``
    exposition."""
    lines = ["tpu_syncbn statusz", "=================="]
    step = report.get("train_step")
    if step is not None:
        lines.append(f"train step: {step:g}")
    lines.append("")
    lines.append("heartbeats (age s)")
    hb = report.get("heartbeat_age_s") or {}
    if hb:
        for name, age in sorted(hb.items()):
            lines.append(f"  {name:<20} {age:g}")
    else:
        lines.append("  (none registered)")
    lines.append("")
    ready = report.get("readiness") or {}
    lines.append(
        "readiness: " + ("ok" if ready.get("ok") else "NOT READY")
    )
    for name, check in sorted((ready.get("checks") or {}).items()):
        verdict = "ok " if check.get("ok") else "FAIL"
        detail = {k: v for k, v in check.items() if k != "ok"}
        lines.append(f"  {name:<20} {verdict} {detail}")
    lines.append("")
    lines.append("alerts")
    alerts = report.get("alerts") or {}
    if alerts:
        for tracker, rules in sorted(alerts.items()):
            for rule, st in sorted(rules.items()):
                state = "FIRING" if st.get("firing") else "quiet"
                lines.append(
                    f"  {tracker}/{rule:<20} {state} "
                    f"(fired {st.get('fired_count', 0)}x, "
                    f"burns {st.get('burns', {})})"
                )
    else:
        lines.append("  (no SLO tracker attached)")
    lines.append("")
    lines.append("circuit breakers")
    circuits = report.get("circuits") or {}
    if circuits:
        for name, code in sorted(circuits.items()):
            state = _CIRCUIT_NAMES.get(int(code), f"?{code}")
            lines.append(f"  {name:<28} {state} ({int(code)})")
    else:
        lines.append("  (none)")
    lines.append("")
    lines.append("program caches")
    caches = report.get("program_caches") or {}
    if caches:
        for family, fields in sorted(caches.items()):
            stats = " ".join(
                f"{k}={fields[k]}" for k in sorted(fields)
            )
            lines.append(f"  {family:<8} {stats}")
    else:
        lines.append("  (none)")
    lines.append("")
    lines.append("publication")
    publication = report.get("publication") or {}
    if publication:
        for name, value in sorted(publication.items()):
            v_s = f"{value:g}" if isinstance(value, (int, float)) else value
            lines.append(f"  {name:<36} {v_s}")
    else:
        lines.append("  (no weight swaps observed)")
    lines.append("")
    lines.append("numerics")
    numerics = report.get("numerics") or {}
    ncounters = report.get("numerics_counters") or {}
    if numerics or ncounters:
        for name, fields in sorted(numerics.items()):
            mx = fields.get("max")
            mx_s = f"{mx:g}" if isinstance(mx, (int, float)) else "-"
            lines.append(
                f"  {name:<36} count={fields.get('count', 0)} max={mx_s}"
            )
        for name, value in sorted(ncounters.items()):
            lines.append(f"  {name:<36} {value}")
    else:
        lines.append("  (no numerics monitors published)")
    lines.append("")
    lines.append("memory")
    memory = report.get("memory") or {}
    mcounters = report.get("memory_counters") or {}
    if memory or mcounters:
        for name, value in sorted(memory.items()):
            v_s = f"{value:g}" if isinstance(value, (int, float)) else value
            lines.append(f"  {name:<36} {v_s}")
        for name, value in sorted(mcounters.items()):
            lines.append(f"  {name:<36} {value}")
    else:
        lines.append("  (no memory telemetry — set TPU_SYNCBN_MEMWATCH=1)")
    lines.append("")
    lines.append("compiles")
    compiles = report.get("compiles") or {}
    if compiles:
        for name, value in sorted(compiles.items()):
            v_s = f"{value:g}" if isinstance(value, (int, float)) else value
            lines.append(f"  {name:<36} {v_s}")
    else:
        lines.append("  (none observed)")
    lines.append("")
    lines.append("autopilot")
    autopilot = report.get("autopilot") or {}
    if autopilot:
        for name, value in sorted(autopilot.items()):
            v_s = f"{value:g}" if isinstance(value, (int, float)) else value
            lines.append(f"  {name:<36} {v_s}")
    else:
        lines.append("  (no autopilot attached)")
    lines.append("")
    lines.append("last incident")
    inc = report.get("last_incident")
    if inc:
        lines.append(f"  id={inc.get('id')} trigger={inc.get('trigger')}")
        lines.append(f"  path={inc.get('path')}")
    elif report.get("recorder_installed"):
        lines.append("  (recorder armed, no incident yet)")
    else:
        lines.append("  (no flight recorder — set TPU_SYNCBN_FLIGHTREC=1)")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the server


class _Handler(BaseHTTPRequestHandler):
    # the stdlib default logs every request to stderr; route to the
    # package logger at debug so a scraper doesn't spam the console
    def log_message(self, fmt, *args):
        from tpu_syncbn_torch.runtime import distributed as dist

        dist.get_logger("tpu_syncbn_torch.obs").debug(
            "metrics-server: " + fmt, *args
        )

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload, indent=1).encode(),
                   "application/json; charset=utf-8")

    def do_GET(self):  # noqa: N802 (http.server API)
        mon: "MonitoringServer" = self.server.monitor  # type: ignore[attr-defined]
        telemetry.count("obs.server.requests")
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            t0 = time.perf_counter()
            body = render_prometheus(
                mon.registry.snapshot(), namespace=mon.namespace
            ).encode()
            self._send(200, body,
                       "text/plain; version=0.0.4; charset=utf-8")
            telemetry.observe("obs.server.scrape_s",
                              time.perf_counter() - t0)
        elif path == "/healthz":
            ok, payload = mon.liveness()
            self._send_json(200 if ok else 503, payload)
        elif path == "/readyz":
            ok, checks = evaluate_readiness()
            self._send_json(200 if ok else 503,
                            {"ok": ok, "checks": checks})
        elif path == "/statusz":
            body = render_statusz(
                statusz_report(registry=mon.registry)
            ).encode()
            self._send(200, body, "text/plain; charset=utf-8")
        else:
            self._send_json(404, {"error": f"no route {path!r}",
                                  "routes": ["/metrics", "/healthz",
                                             "/readyz", "/statusz",
                                             "POST /incidentz",
                                             "POST /profilez"]})

    def do_POST(self):  # noqa: N802 (http.server API)
        from tpu_syncbn_torch.obs import flightrec

        telemetry.count("obs.server.requests")
        path, _, query = self.path.partition("?")
        if path == "/profilez":
            from urllib.parse import parse_qs

            from tpu_syncbn_torch.obs import profiling

            duration_s = None
            try:
                raw = parse_qs(query).get("duration_s")
                if raw:
                    duration_s = float(raw[0])
            except ValueError:
                self._send_json(400, {
                    "ok": False,
                    "error": "duration_s must be a number",
                })
                return
            code, payload = profiling.serve_capture(duration_s)
            self._send_json(code, payload)
            return
        if path != "/incidentz":
            self._send_json(404, {"error": f"no POST route {path!r}",
                                  "routes": ["POST /incidentz",
                                             "POST /profilez"]})
            return
        rec = flightrec.get()
        if rec is None:
            self._send_json(503, {
                "ok": False,
                "error": "no flight recorder installed — set "
                         "TPU_SYNCBN_FLIGHTREC=1",
            })
            return
        bundle_path = rec.trigger(
            "manual", {"source": "http", "client": self.client_address[0]},
            force=True,
        )
        if bundle_path is None:
            self._send_json(503, {
                "ok": False,
                "error": "trigger suppressed or dump failed "
                         "(a dump may already be in flight)",
            })
            return
        self._send_json(200, {
            "ok": True,
            "incident_id": (rec.last_incident or {}).get("id"),
            "path": bundle_path,
        })


class MonitoringServer:
    """Background HTTP server exposing the monitoring endpoints.

    ``port=0`` binds an ephemeral port (tests; read it back from
    :attr:`port`). ``max_age_s`` is the liveness threshold for
    registered heartbeats. Pass an existing
    :class:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator` to share one
    sampler; otherwise the server owns (and closes) its own, so rolling
    rates/quantiles are being collected whenever the server is up."""

    def __init__(
        self,
        *,
        port: int = 0,
        host: str = "0.0.0.0",
        registry: telemetry.Registry | None = None,
        aggregator=None,
        max_age_s: float = 60.0,
        namespace: str = "tpu_syncbn",
    ):
        from tpu_syncbn_torch.obs import timeseries

        if max_age_s <= 0:
            raise ValueError(f"max_age_s must be > 0, got {max_age_s}")
        self.registry = registry if registry is not None else telemetry.REGISTRY
        self.max_age_s = float(max_age_s)
        self.namespace = namespace
        # bind FIRST: a bind failure (port taken) must raise before any
        # background thread exists — start_from_env retries on every
        # producer construction, and each retry must leak nothing
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._owns_aggregator = aggregator is None
        self.aggregator = (
            timeseries.WindowedAggregator(self.registry).start()
            if aggregator is None else aggregator
        )
        self._httpd.monitor = self  # type: ignore[attr-defined]
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-server",
            daemon=True,
        )
        self._thread.start()

    def liveness(self, now: float | None = None) -> tuple[bool, dict]:
        """The /healthz evaluation: every registered heartbeat younger
        than ``max_age_s``. With no heartbeats registered the answer
        itself is the liveness claim (the process is serving HTTP)."""
        ages = HEARTBEATS.ages(now)
        stale = sorted(n for n, a in ages.items() if a > self.max_age_s)
        ok = not stale
        worst = max(ages.values()) if ages else 0.0
        telemetry.set_gauge("monitor.heartbeat_age_s", round(worst, 3))
        return ok, {
            "ok": ok,
            "max_age_s": self.max_age_s,
            "heartbeat_age_s": {n: round(a, 3) for n, a in sorted(ages.items())},
            "stale": stale,
        }

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if self._owns_aggregator:
            self.aggregator.close()

    def __enter__(self) -> "MonitoringServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# env-gated process server


_active_lock = threading.Lock()
_active: MonitoringServer | None = None


def start_from_env() -> MonitoringServer | None:
    """Start (once) the process monitoring server if
    ``TPU_SYNCBN_METRICS_PORT`` is set; return it (or the one already
    running, or ``None`` when the env gate is off). Idempotent and
    safe to call from every subsystem's constructor — the first caller
    with the gate set pays the (small) startup; everyone else gets the
    existing instance. A bind failure is logged, not raised: monitoring
    must never take down the workload it monitors."""
    import os

    global _active
    port_s = os.environ.get(_ENV_PORT, "").strip()
    if not port_s:
        return None
    with _active_lock:
        if _active is not None:
            return _active
        try:
            _active = MonitoringServer(port=int(port_s))
        except Exception as e:
            from tpu_syncbn_torch.runtime import distributed as dist

            dist.get_logger("tpu_syncbn_torch.obs").error(
                "could not start the monitoring server on %s=%s: %s: %s",
                _ENV_PORT, port_s, type(e).__name__, e,
            )
            return None
        from tpu_syncbn_torch.runtime import distributed as dist

        dist.get_logger("tpu_syncbn_torch.obs").info(
            "monitoring server listening on port %d "
            "(/metrics /healthz /readyz)", _active.port,
        )
        return _active


def active_server() -> MonitoringServer | None:
    return _active


def stop_env_server() -> None:
    """Stop the env-gated process server (tests / clean shutdown)."""
    global _active
    with _active_lock:
        srv, _active = _active, None
    if srv is not None:
        srv.close()
