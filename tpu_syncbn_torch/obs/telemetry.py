"""Telemetry — the part of ``tpu_syncbn.obs.telemetry`` the resilience
layer needs: :class:`CounterGroup`, kept as a copy. The process registry
its bumps mirror into in the JAX package (and the exporters, gauges and
histograms around it) come with ROADMAP A.11.
"""

from __future__ import annotations

import threading


class CounterGroup:
    """Instance-local monotonic named counters — the resilience layer's
    event counts (restores, skipped steps, checkpoints). Thread-safe:
    signal handlers and watchdog threads bump concurrently with the step
    loop. ``prefix`` names the group (``resilience``); in the JAX package
    every bump is also mirrored into the telemetry registry as
    ``{prefix}.{name}``, which waits for the port's registry (A.11)."""

    def __init__(self, prefix: str | None = None):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self.prefix = prefix

    def bump(self, name: str, n: int = 1) -> int:
        """Increment ``name`` by ``n``; returns the new count."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            return self._counts[name]

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def summary(self) -> dict:
        """Snapshot of every counter (plain dict, JSON-ready)."""
        with self._lock:
            return dict(self._counts)

    def __repr__(self):
        return f"{type(self).__name__}({self.summary()!r})"
