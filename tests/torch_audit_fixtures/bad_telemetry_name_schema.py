"""PLANTED VIOLATIONS — telemetry_name_schema.

Metric names outside the dotted-lowercase subsystem schema (or outside
the port's subsystem vocabulary) break the JSONL export/merge and the
incident bundles that key on it.
"""

from tpu_syncbn_torch.obs import telemetry
from tpu_syncbn_torch.obs.telemetry import CounterGroup, Registry

REGISTRY = Registry()


def record(n):
    telemetry.count("Serve.Latency")  # bad: uppercase, no subsystem dot
    telemetry.count("queue_depth", n)  # bad: no subsystem prefix
    telemetry.count("serve.queue_depth", n)  # ok
    telemetry.count("sevre.latency_s", n)  # bad: typo'd subsystem token
    REGISTRY.counter("serve-errors")  # bad: dash not in schema
    CounterGroup(prefix="metricz")  # bad: unknown subsystem token
    return CounterGroup(prefix="serve.batcher")  # bad: prefix is one token


def labeled(n):
    telemetry.count("serve.requests", n, labels={"Tenant": "a"})  # bad: key schema
    telemetry.count("serve.requests", n, labels={"zone": "us"})  # bad: key not in the vocabulary
    telemetry.count("serve.requests", n, labels={"tenant": "a"})  # ok
