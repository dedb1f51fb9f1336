"""Observability: so far the resilience layer's event counters
(:class:`~tpu_syncbn_torch.obs.telemetry.CounterGroup`)."""

from tpu_syncbn_torch.obs.telemetry import CounterGroup

__all__ = ["CounterGroup"]
