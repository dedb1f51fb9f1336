"""Observability, part one (ROADMAP A.11a) — the counterpart of the part of
``tpu_syncbn.obs`` that the training step feeds and returns:

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
  ``numerics.*`` publisher.

Still to port: ``timeseries``, ``flightrec``, ``incident``, ``memwatch``
and ``profiling`` (ROADMAP A.11b), then ``server``, ``slo`` and the
``*_rules`` SLO rule sets (A.11c).
"""

from tpu_syncbn_torch.obs import numerics, stepstats, telemetry, tracing
from tpu_syncbn_torch.obs.numerics import NumericsPublisher
from tpu_syncbn_torch.obs.telemetry import (
    REGISTRY,
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    Registry,
)
from tpu_syncbn_torch.obs.tracing import RingTracer, Tracer

__all__ = [
    "telemetry",
    "tracing",
    "stepstats",
    "numerics",
    "NumericsPublisher",
    "REGISTRY",
    "Registry",
    "Counter",
    "CounterGroup",
    "Gauge",
    "Histogram",
    "RingTracer",
    "Tracer",
]
