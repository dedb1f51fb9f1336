"""Nestable wall-clock spans in Chrome trace-event format — the
counterpart of ``tpu_syncbn.obs.tracing``, kept as a copy (framework-free;
the JAX package's ``__init__`` imports JAX). Events, ids and the file
format are the JAX module's, so either package's validator reads the
other's traces.

A :class:`Tracer` records *complete* events (``ph: "X"``) with
microsecond timestamps and durations; :meth:`Tracer.save` writes the
``{"traceEvents": [...]}`` JSON object that ``chrome://tracing`` and
Perfetto (https://ui.perfetto.dev) open directly —
``python -m tpu_syncbn_torch.bench --trace out.json`` is the one-command
producer.

Span identity is the correlation currency: every span gets a
process-unique integer id, carried in the event's ``args.span_id`` (and
``args.parent_id`` for nesting). The resilience layer stamps the id of
the newest open span into its watchdog-stall and data-stall markers
(:func:`latest_open_span_id`), so an event log and a Perfetto timeline
join on it.

Like telemetry, the disabled path is near-free: with no tracer installed
(:func:`install` not called), the module-level :func:`span` returns a
shared ``nullcontext`` — no clock reads, no allocation.

The optional ``profiler_bridge`` (the JAX tracer's ``jax_bridge``) wraps
every span in ``torch.profiler.record_function(name)`` as well, so the
host spans line up with the device activity inside a ``torch.profiler``
trace when both are active.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

_NULL = contextlib.nullcontext()


class Tracer:
    """Collects Chrome trace events in memory; thread-safe (each thread
    keeps its own span stack, event append is locked)."""

    def __init__(self, *, profiler_bridge: bool = False):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._tls = threading.local()
        # insertion-ordered map of currently-open span ids → name; the
        # newest entry is what a watchdog thread should correlate with
        self._open: dict[int, str] = {}
        self._next_id = 1
        self.profiler_bridge = bool(profiler_bridge)
        self.events: list[dict] = []

    # -- internals --------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _emit(self, event: dict) -> None:
        with self._lock:
            self.events.append(event)

    # -- recording --------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a complete event around the block; yields the span id.
        Nest freely (including across threads — each thread nests its own
        stack). ``args`` must be JSON-serializable."""
        st = self._stack()
        parent = st[-1] if st else None
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._open[sid] = name
        st.append(sid)
        bridge = None
        if self.profiler_bridge:
            try:
                import torch

                bridge = torch.profiler.record_function(name)
                bridge.__enter__()
            except Exception:
                bridge = None
        t0 = self._now_us()
        try:
            yield sid
        finally:
            dur = self._now_us() - t0
            if bridge is not None:
                with contextlib.suppress(Exception):
                    bridge.__exit__(None, None, None)
            st.pop()
            ev_args: dict = {"span_id": sid}
            if parent is not None:
                ev_args["parent_id"] = parent
            ev_args.update(args)
            event = {
                "name": name,
                "ph": "X",
                "ts": round(t0, 3),
                "dur": round(dur, 3),
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "cat": "tpu_syncbn",
                "args": ev_args,
            }
            with self._lock:
                self._open.pop(sid, None)
                self.events.append(event)

    def instant(self, name: str, **args) -> None:
        """Record an instant event (``ph: "i"``) — a point-in-time marker
        (watchdog stall, divergence restore) on the timeline."""
        self._emit({
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped marker
            "ts": round(self._now_us(), 3),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "cat": "tpu_syncbn",
            "args": dict(args),
        })

    def _flow(self, ph: str, name: str, flow_id: int, extra: dict,
              args: dict) -> None:
        event = {
            "name": name,
            "ph": ph,
            "id": int(flow_id),
            "ts": round(self._now_us(), 3),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "cat": "tpu_syncbn",
            "args": dict(args),
        }
        event.update(extra)
        self._emit(event)

    def flow_start(self, name: str, flow_id: int, **args) -> None:
        """Open a flow arrow (``ph: "s"``): Perfetto draws an arrow from
        the slice enclosing this timestamp on this thread to wherever the
        matching :meth:`flow_end` lands (same ``name`` + ``flow_id``).
        The serving stack uses request ids as flow ids, so a request's
        enqueue span and the batch span that eventually answered it are
        visually linked in the trace."""
        self._flow("s", name, flow_id, {}, args)

    def flow_end(self, name: str, flow_id: int, **args) -> None:
        """Close a flow arrow (``ph: "f"``, ``bp: "e"`` — bind to the
        enclosing slice, so the arrow terminates at the span currently
        open on this thread rather than at a bare point)."""
        self._flow("f", name, flow_id, {"bp": "e"}, args)

    def recent_events(self, limit: int | None = None) -> list[dict]:
        """The newest ``limit`` recorded events (all when ``None``) —
        the flight recorder's span-ring read: a self-contained,
        Perfetto-loadable slice of recent activity without writing a
        trace file."""
        with self._lock:
            events = list(self.events)
        if limit is not None and len(events) > limit:
            events = events[-limit:]
        return events

    # -- queries ----------------------------------------------------------

    def current_span_id(self) -> int | None:
        """The innermost open span on THIS thread, or None."""
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def latest_open_span_id(self) -> int | None:
        """The most recently opened, still-open span in ANY thread — what
        a watchdog/monitor thread tags its diagnostics with (its own
        thread-local stack is empty by construction)."""
        with self._lock:
            if not self._open:
                return None
            return next(reversed(self._open))

    # -- output -----------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the Chrome trace JSON object. Adds process metadata so
        Perfetto labels the track with the rank: the process group's when
        one is already initialized, else the launcher's ``RANK``, else 0
        (nothing is initialized to ask)."""
        from tpu_syncbn_torch.obs.telemetry import _host_index

        meta = [{
            "name": "process_name", "ph": "M", "pid": os.getpid(),
            "args": {"name": f"tpu_syncbn host {_host_index()}"},
        }]
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with self._lock:
            events = meta + list(self.events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


class RingTracer(Tracer):
    """A :class:`Tracer` whose event store is a bounded ring: the newest
    ``capacity`` events survive, older ones fall off. This is the
    always-on form the flight recorder installs when no tracer is
    (:mod:`tpu_syncbn_torch.obs.flightrec`) — span recording with memory
    bounded by construction, so it can run for days and still hold the
    seconds *before* an incident. :meth:`Tracer.save` and
    :meth:`Tracer.recent_events` work unchanged (they copy the ring)."""

    def __init__(self, capacity: int = 2048, **kwargs):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        super().__init__(**kwargs)
        self.capacity = int(capacity)
        # deque.append matches the list API every recording path uses;
        # maxlen makes eviction O(1) and allocation-free
        self.events = deque(maxlen=self.capacity)  # type: ignore[assignment]


# ---------------------------------------------------------------------------
# module-level installed tracer


_installed: Tracer | None = None
_install_lock = threading.Lock()


def install(tracer: Tracer | None = None) -> Tracer:
    """Install ``tracer`` (or a fresh one) as the process tracer that the
    module-level :func:`span`/:func:`instant` record into. Returns it."""
    global _installed
    with _install_lock:
        if tracer is None:
            tracer = Tracer()
        _installed = tracer
        return tracer


def uninstall() -> Tracer | None:
    """Remove and return the installed tracer (its events stay intact)."""
    global _installed
    with _install_lock:
        t, _installed = _installed, None
        return t


def get() -> Tracer | None:
    return _installed


def span(name: str, **args):
    """Context manager: a span on the installed tracer, or a shared
    no-op context when tracing is off."""
    t = _installed
    if t is None:
        return _NULL
    return t.span(name, **args)


def instant(name: str, **args) -> None:
    t = _installed
    if t is not None:
        t.instant(name, **args)


def flow_start(name: str, flow_id: int, **args) -> None:
    """Flow-arrow start on the installed tracer (no-op when off)."""
    t = _installed
    if t is not None:
        t.flow_start(name, flow_id, **args)


def flow_end(name: str, flow_id: int, **args) -> None:
    """Flow-arrow end on the installed tracer (no-op when off)."""
    t = _installed
    if t is not None:
        t.flow_end(name, flow_id, **args)


def current_span_id() -> int | None:
    t = _installed
    return t.current_span_id() if t is not None else None


def latest_open_span_id() -> int | None:
    t = _installed
    return t.latest_open_span_id() if t is not None else None


# ---------------------------------------------------------------------------
# loading / validation


def load_trace(path: str) -> list[dict]:
    """Parse a Chrome trace file (object-with-``traceEvents`` or bare
    array form) and return its event list."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError(
                f"{path!r} is JSON but has no traceEvents list"
            )
        return events
    if isinstance(doc, list):
        return doc
    raise ValueError(f"{path!r} is not a Chrome trace (dict or list)")


def validate_trace(events: list) -> list[dict]:
    """Minimal Chrome trace-event validation: every event is a dict with
    a name, a phase, and a numeric ``ts``. Returns the events; raises
    ``ValueError`` on drift."""
    if not isinstance(events, list):
        raise ValueError("trace events must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"trace event {i} is not a dict")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"trace event {i} has no name")
        if ev.get("ph") not in ("X", "B", "E", "i", "I", "M", "C",
                                "s", "t", "f"):
            raise ValueError(f"trace event {i} has unknown phase {ev.get('ph')!r}")
        if ev["ph"] != "M" and not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"trace event {i} has no numeric ts")
        if ev["ph"] == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"complete event {i} has no numeric dur")
        if ev["ph"] in ("s", "t", "f") and not isinstance(
                ev.get("id"), (int, str)):
            raise ValueError(f"flow event {i} has no id")
    return events
