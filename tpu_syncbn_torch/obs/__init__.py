"""Observability (ROADMAP A.11a–A.11c) — the counterpart of
``tpu_syncbn.obs`` for what the training step feeds, returns and leaves
behind:

* :mod:`~tpu_syncbn_torch.obs.telemetry` — process-wide named counters,
  gauges and fixed-bucket histograms; env-gated (``TPU_SYNCBN_TELEMETRY``),
  JSONL export per host, rank-0 merged summary; the JAX module's names,
  schema and merge letter for letter;
* :mod:`~tpu_syncbn_torch.obs.tracing` — nestable wall-clock spans in
  Chrome trace-event format (Perfetto, ``chrome://tracing``), with span
  ids for log correlation and an optional ``torch.profiler`` bridge;
* :mod:`~tpu_syncbn_torch.obs.stepstats` — the host seams of a step loop
  (data wait, step) and the on-device step monitors (gradient norm,
  non-finite counts, BN running-statistic health);
* :mod:`~tpu_syncbn_torch.obs.numerics` — the cross-replica drift and
  compression-health monitors (one all-reduce) and the non-blocking
  ``numerics.*`` publisher;
* :mod:`~tpu_syncbn_torch.obs.timeseries` — windowed rates, quantiles and
  snapshots over the registry;
* :mod:`~tpu_syncbn_torch.obs.server` — the heartbeat table, the
  readiness registry and the env-gated (``TPU_SYNCBN_METRICS_PORT``)
  stdlib HTTP server: ``/metrics`` Prometheus exposition, ``/healthz``,
  ``/readyz``, ``/statusz``, ``POST /incidentz`` and ``POST /profilez``;
* :mod:`~tpu_syncbn_torch.obs.slo` — declarative SLO objectives with
  multi-window error-budget burn-rate alert rules (hysteresis), feeding
  ``/readyz``, the ``obs.alert.*`` counters and the ``slo_alert``
  incident trigger, and the rule sets (``standard_rules``);
* :mod:`~tpu_syncbn_torch.obs.flightrec` and
  :mod:`~tpu_syncbn_torch.obs.incident` — the flight recorder's bounded
  rings, its triggers (``TPU_SYNCBN_FLIGHTREC``, bundles under
  ``TPU_SYNCBN_INCIDENT_DIR``) and the incident bundle with its
  attribution report and CLI (``python -m tpu_syncbn_torch.obs.incident``);
* :mod:`~tpu_syncbn_torch.obs.memwatch` — live memory watermarks from the
  caching allocator against a contract (``TPU_SYNCBN_MEMWATCH``);
* :mod:`~tpu_syncbn_torch.obs.profiling` — compile events, the
  recompile-storm detector and the bounded ``torch.profiler`` capture
  (``TPU_SYNCBN_PROFILE_DIR``).
"""

from tpu_syncbn_torch.obs import (
    flightrec,
    incident,
    memwatch,
    numerics,
    profiling,
    server,
    slo,
    stepstats,
    telemetry,
    timeseries,
    tracing,
)
from tpu_syncbn_torch.obs.flightrec import FlightRecorder
from tpu_syncbn_torch.obs.memwatch import MemorySampler
from tpu_syncbn_torch.obs.numerics import NumericsPublisher
from tpu_syncbn_torch.obs.profiling import RecompileDetector
from tpu_syncbn_torch.obs.server import MONITOR_METRICS, MonitoringServer
from tpu_syncbn_torch.obs.slo import AlertRule, Availability, SLOTracker
from tpu_syncbn_torch.obs.telemetry import (
    REGISTRY,
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    Registry,
)
from tpu_syncbn_torch.obs.timeseries import WindowedAggregator
from tpu_syncbn_torch.obs.tracing import RingTracer, Tracer

__all__ = [
    "telemetry",
    "tracing",
    "stepstats",
    "numerics",
    "timeseries",
    "server",
    "slo",
    "flightrec",
    "incident",
    "memwatch",
    "profiling",
    "FlightRecorder",
    "MemorySampler",
    "NumericsPublisher",
    "RecompileDetector",
    "WindowedAggregator",
    "REGISTRY",
    "Registry",
    "Counter",
    "CounterGroup",
    "Gauge",
    "Histogram",
    "RingTracer",
    "Tracer",
    "MonitoringServer",
    "MONITOR_METRICS",
    "SLOTracker",
    "AlertRule",
    "Availability",
]
