"""Liveness and readiness state: the heartbeat table and the readiness
hook registry — the liveness half of ``tpu_syncbn.obs.server``, kept as a
copy (stdlib only; the JAX package's ``__init__`` imports JAX, so the port
never imports it).

* :data:`HEARTBEATS` — named beats on the monotonic clock. Producers beat
  from their hot loop (``ResilientLoop`` once a step or chunk, as
  ``"train"``); :meth:`Heartbeats.ages` says how long each source has
  been silent. A process that answers but whose step loop stopped moving
  is the "stuck host" a cumulative export cannot see.
* :func:`register_readiness` / :func:`evaluate_readiness` — the process
  readiness registry: every hook must pass (the loop's hook: preemption
  not signaled, no divergence rollback in progress). A raising hook reads
  as not ready (fail closed).

Incident bundles (:mod:`tpu_syncbn_torch.obs.incident`) embed the
heartbeat ages and the readiness verdict, so an incident shows which
source stopped beating and which check was failing when it fired.

Still to port (ROADMAP A.11c): the HTTP half — the monitoring server with
``/metrics`` (Prometheus exposition), ``/healthz`` and ``/readyz`` over
this state, ``/statusz``, ``/incidentz`` and ``/profilez``, and the
``TPU_SYNCBN_METRICS_PORT`` gate.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

# ---------------------------------------------------------------------------
# liveness: heartbeats


class Heartbeats:
    """Named liveness beats on the monotonic clock. Producers call
    :meth:`beat` from their hot loop (a dict store under a lock — cheap
    enough per step); readers call :meth:`ages`. ``now`` is injectable for
    deterministic tests."""

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
        except Exception as e:  # fail closed, never crash the reader
            hook_ok, detail = False, {"error": f"{type(e).__name__}: {e}"}
        checks[name] = {"ok": hook_ok, **dict(detail)}
        ok = ok and hook_ok
    return ok, checks
