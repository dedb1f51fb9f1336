"""Process-wide flight recorder: bounded, always-on rings of recent
activity, dumped as an incident bundle when something goes wrong — the
counterpart of ``tpu_syncbn.obs.flightrec`` (the JAX package's
``__init__`` imports JAX, so the port keeps its own copy).

Counters are cumulative, windowed frames roll off and a trace file exists
only when an operator asked for one in advance: by the time a divergence
guard rolls back, the watchdog declares a stall or memory climbs past its
contract, the seconds *before* the event are gone. The
:class:`FlightRecorder` is the black box. It keeps

* a bounded ring of recent **trace spans** — the
  :mod:`tpu_syncbn_torch.obs.tracing` records a ``--trace`` file holds,
  kept in a :class:`~tpu_syncbn_torch.obs.tracing.RingTracer` when no
  tracer was installed (memory bounded by construction, no file written
  in steady state);
* the **windowed registry** ring of a
  :class:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator` (shared, or
  owned and sampled in the background) — per-interval counter and
  histogram deltas covering the recent past;
* a ring of recent **step records** — the loss, metrics and on-device
  monitors of each step (``ResilientLoop``, ``GANTrainer``);
* rings of recent **memory watermarks**
  (:class:`~tpu_syncbn_torch.obs.memwatch.MemorySampler`), **compile
  events** (:func:`tpu_syncbn_torch.obs.profiling.note_compile`), and the
  **serve** ring (the batcher's sheds, rejections, deadline misses and
  circuit-breaker transitions) and the **autopilot** ring (every decision
  of :class:`~tpu_syncbn_torch.runtime.autopilot.Autopilot`: actuations,
  clamps and suppressions).

On a trigger (:meth:`FlightRecorder.trigger` — fired by the divergence
restore, the watchdog and the data stall, the numerics publisher, the
memory sampler, the recompile detector, or by hand) the rings plus a full
registry snapshot, the heartbeat and readiness state and the config/env
are written atomically as one schema-versioned **incident bundle**
(:mod:`tpu_syncbn_torch.obs.incident`). A cooldown keeps a flapping
trigger from flooding the disk, and a non-blocking trigger lock makes a
re-entrant trigger (one fired during a dump's readiness probe) drop
instead of deadlock.

**Step values on the card.** The JAX recorder keeps the 0-d device arrays
themselves and probes ``is_ready()`` at dump time. A CUDA tensor has no
such probe, reading one (``float``, ``.item()``) synchronizes — a
``watchdog_stall`` dump would wait behind the very work it reports — and
a captured chunk's outputs live in its graph's buffers, which the next
replay rewrites. So :meth:`FlightRecorder.record_step` stacks a step's
CUDA scalars on the device and copies them ``non_blocking`` into a row of
a page-locked host block the recorder took when it was built (a
process's first page-locked allocation waits for the device, so none
happens on a step), then copies a marker behind them on the same
stream. At dump time the entry reads ``"pending"`` until the marker has
landed — a plain read of host memory: the dump makes no CUDA runtime call
at all (not even ``cudaEventQuery``, which is illegal from any thread
while another captures a graph in global mode), so it is safe from the
watchdog's and the memory sampler's threads. Values are the step's own:
the copy is stream-ordered before any later replay. CPU tensors and
Python numbers are kept and scalarized at dump time as in JAX; non-finite
values become strings.

Cost contract (the ``TPU_SYNCBN_TELEMETRY`` discipline): with no recorder
installed, the module helpers (:func:`record_step`, :func:`record_serve`,
:func:`trigger`, ...) are one global load and a ``None`` test — no
allocation, no lock. Installation is gated by ``TPU_SYNCBN_FLIGHTREC``
(:func:`install_from_env`, called by ``ResilientLoop.run``) or an explicit
:func:`install`; bundles go to ``TPU_SYNCBN_INCIDENT_DIR`` (default
``./incidents``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any

import torch

from tpu_syncbn_torch.obs import telemetry, timeseries, tracing

_ENV_FLAG = "TPU_SYNCBN_FLIGHTREC"
_ENV_DIR = "TPU_SYNCBN_INCIDENT_DIR"
_TRUTHY = ("1", "true", "on", "yes")

#: Default incident-bundle directory when neither the constructor nor
#: ``TPU_SYNCBN_INCIDENT_DIR`` names one.
DEFAULT_INCIDENT_DIR = "incidents"

#: What an entry of a step record reads while its host copy is in flight.
PENDING = "pending"

#: CUDA scalars a step record may hold before its page-locked rows must
#: widen (the ResNet-50 loop records 13: the loss and 12 monitors).
STEP_RING_WIDTH = 128

#: The value the marker copy writes into the last host slot.
_LANDED = 1.0


def _scalarize(value) -> Any:
    """JSON-safe scalar from a ring entry's recorded value: CPU tensors,
    numpy scalars and numbers go through ``float()``; non-finite floats
    become strings (strict-JSON safe); anything unconvertible — a CUDA
    tensor included, which only a synchronizing read could convert — is
    dropped by the caller (``None``)."""
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, str)) or value is None:
        return value
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        return None  # never read a device tensor here (that would sync)
    try:
        f = float(value)
    except Exception:
        return None
    if f != f or f in (float("inf"), float("-inf")):
        return str(f)
    return f


def _scalarize_dict(d) -> dict:
    if not isinstance(d, dict):
        return {}
    out = {}
    for k, v in d.items():
        s = _scalarize(v)
        if s is not None:
            out[str(k)] = s
    return out


class _HostRing:
    """The page-locked rows a recorder's step copies land in, taken once:
    ``rows`` rows of ``width`` float64 values and a marker slot each. Rows
    are handed out in turn; with one row more than the step ring holds, a
    row comes round again only after the entry that used it has left the
    ring. A record wider than ``width`` needs a wider block
    (:meth:`reserve`, counted by the recorder)."""

    def __init__(self, rows: int, width: int):
        self.rows, self.width = int(rows), int(width)
        self.block = self._alloc()
        self._next = 0

    def _alloc(self) -> torch.Tensor:
        return torch.empty((self.rows, self.width + 1), dtype=torch.float64,
                           pin_memory=True)

    def reserve(self, width: int) -> bool:
        """Make every row hold ``width`` values; True when the block grew
        (copies already made keep their rows of the old block)."""
        if width <= self.width:
            return False
        self.width = max(int(width), 2 * self.width)
        self.block = self._alloc()
        return True

    def take(self, n: int) -> torch.Tensor:
        """The next row's first ``n + 1`` slots: ``n`` values, then the
        marker."""
        row = self.block[self._next]
        self._next = (self._next + 1) % self.rows
        return row[:n + 1]


class _HostCopy:
    """One step's CUDA scalars, stacked on the device and copied into a
    page-locked row of the recorder's :class:`_HostRing` without a
    synchronize; a one-element marker copy follows on the same stream, so
    the values have landed once the row's marker slot reads
    :data:`_LANDED` (a host read, no CUDA call)."""

    __slots__ = ("keys", "host")

    _markers: dict = {}

    def __init__(self, keys: list, values: list, ring: _HostRing):
        self.keys = keys
        by_dtype: dict = {}
        for i, v in enumerate(values):
            by_dtype.setdefault(v.dtype, []).append(i)
        with torch.no_grad():
            # one stack and one cast a dtype; the keys follow that grouping
            parts = [torch.stack([values[i].detach().reshape(()) for i in idx])
                     .to(torch.float64) for idx in by_dtype.values()]
            dev = parts[0] if len(parts) == 1 else torch.cat(parts)
        if len(by_dtype) > 1:
            order = [i for idx in by_dtype.values() for i in idx]
            self.keys = [keys[i] for i in order]
        n = len(values)
        host = ring.take(n)
        host[n] = 0.0
        host[:n].copy_(dev, non_blocking=True)
        host[n:].copy_(self._marker(dev.device), non_blocking=True)
        self.host = host

    @classmethod
    def _marker(cls, device) -> torch.Tensor:
        m = cls._markers.get(device)
        if m is None:
            m = cls._markers[device] = torch.full((1,), _LANDED, dtype=torch.float64,
                                                  device=device)
        return m

    def values(self) -> list:
        """The landed values, or :data:`PENDING` for each while the copy is
        in flight."""
        host = self.host
        if float(host[-1]) != _LANDED:
            return [PENDING] * len(self.keys)
        return [_scalarize(v) for v in host[:-1].tolist()]


def _split_on_card(metrics, monitors, ring_for) -> tuple[dict, dict, _HostCopy | None]:
    """``(metrics, monitors, copy)``: the two dicts without their
    single-element CUDA tensors, and those tensors' host copy into a row of
    ``ring_for(number of values)``."""
    keys, values, plain = [], [], []
    for slot, d in enumerate((metrics, monitors)):
        kept = {}
        if isinstance(d, dict):
            for k, v in d.items():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    if v.numel() == 1:
                        keys.append((slot, k))
                        values.append(v)
                else:
                    kept[k] = v.detach() if isinstance(v, torch.Tensor) else v
        plain.append(kept)
    return plain[0], plain[1], (_HostCopy(keys, values, ring_for(len(values)))
                                if values else None)


class FlightRecorder:
    """Bounded rings of recent cross-subsystem activity plus the
    incident-dump trigger machinery (module docstring has the design).

    ``aggregator`` shares an existing
    :class:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator` —
    otherwise the recorder owns one and :meth:`start` runs its background
    sampler. ``cooldown_s`` bounds dump frequency per recorder
    (``force=True`` — the manual trigger — bypasses it). ``incident_dir``
    defaults to ``TPU_SYNCBN_INCIDENT_DIR`` or ``./incidents``; at most
    ``max_bundles`` bundles are retained (oldest pruned).

    Where CUDA is available the recorder takes here the page-locked rows
    the step ring's CUDA scalars are copied into (one row a ring entry,
    plus one, :data:`STEP_RING_WIDTH` values wide) and launches each
    kernel of the copy path once (a kernel's first launch waits for queued
    device work): a step record of at most that many CUDA scalars then
    allocates nothing. A wider record widens the rows on its step, counted
    as ``incident.host_block_grows``.
    """

    def __init__(
        self,
        *,
        span_capacity: int = 2048,
        step_capacity: int = 512,
        serve_capacity: int = 512,
        mem_capacity: int = 512,
        compile_capacity: int = 256,
        autopilot_capacity: int = 256,
        registry: telemetry.Registry | None = None,
        aggregator: timeseries.WindowedAggregator | None = None,
        interval_s: float = 1.0,
        window_capacity: int = 120,
        cooldown_s: float = 30.0,
        incident_dir: str | None = None,
        max_bundles: int = 16,
        now=time.monotonic,
    ):
        for name, v in (("span_capacity", span_capacity),
                        ("step_capacity", step_capacity),
                        ("serve_capacity", serve_capacity),
                        ("mem_capacity", mem_capacity),
                        ("compile_capacity", compile_capacity),
                        ("autopilot_capacity", autopilot_capacity),
                        ("max_bundles", max_bundles)):
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.registry = registry if registry is not None else telemetry.REGISTRY
        self._owns_aggregator = aggregator is None
        self.aggregator = (
            timeseries.WindowedAggregator(
                self.registry, interval_s=interval_s,
                capacity=window_capacity,
            ) if aggregator is None else aggregator
        )
        self.span_capacity = int(span_capacity)
        self.cooldown_s = float(cooldown_s)
        self.incident_dir = (
            incident_dir
            or os.environ.get(_ENV_DIR, "").strip()
            or DEFAULT_INCIDENT_DIR
        )
        self.max_bundles = int(max_bundles)
        self._now = now
        self._lock = threading.Lock()
        self._steps: deque = deque(maxlen=int(step_capacity))
        self._serve: deque = deque(maxlen=int(serve_capacity))
        self._mem: deque = deque(maxlen=int(mem_capacity))
        self._compile: deque = deque(maxlen=int(compile_capacity))
        self._autopilot: deque = deque(maxlen=int(autopilot_capacity))
        self._contract: dict = {}
        self._seq = 0
        self._last_dump_t: float | None = None
        # non-blocking: a trigger landing while a dump is in flight (or
        # re-entering from the dump's own readiness probe) is dropped,
        # never queued — one bundle per incident, no deadlock
        self._trigger_lock = threading.Lock()
        self._own_tracer: tracing.Tracer | None = None
        #: ``{"id", "path", "trigger", "wall_time"}`` of the newest bundle,
        #: or None.
        self.last_incident: dict | None = None
        #: always-on local counts (triggers/bundles/suppressed/errors);
        #: mirrored into the registry as ``incident.*`` when telemetry is
        #: enabled.
        self.counters = telemetry.CounterGroup(prefix="incident")
        self._log = None
        self._host_ring: _HostRing | None = None
        if torch.cuda.is_available():
            self._host_ring = _HostRing(int(step_capacity) + 1, STEP_RING_WIDTH)
            self._warm_copy_path()

    @staticmethod
    def _warm_copy_path() -> None:
        """One launch of each kernel a step record's host copy runs (the
        stacks and float64 casts, the concatenation, the marker), here and
        not on a step: a kernel's first launch waits for all queued device
        work (``obs.numerics.warm_scalar_stack``)."""
        from tpu_syncbn_torch.obs.numerics import warm_scalar_stack

        warm_scalar_stack(torch.float64, 16)
        _HostCopy._marker(torch.device("cuda", torch.cuda.current_device()))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FlightRecorder":
        """Arm the recorder: install a bounded
        :class:`~tpu_syncbn_torch.obs.tracing.RingTracer` if no tracer is
        recording (an existing tracer — e.g. ``bench --trace`` — is
        tapped, not replaced), and start the owned aggregator's background
        sampler. Idempotent."""
        if tracing.get() is None:
            self._own_tracer = tracing.install(
                tracing.RingTracer(self.span_capacity)
            )
        if self._owns_aggregator:
            self.aggregator.start()
        return self

    def close(self) -> None:
        """Stop the owned sampler and uninstall the recorder's own ring
        tracer (only if it is still the installed one)."""
        if self._owns_aggregator:
            self.aggregator.close()
        if self._own_tracer is not None \
                and tracing.get() is self._own_tracer:
            tracing.uninstall()
        self._own_tracer = None

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _logger(self):
        if self._log is None:
            from tpu_syncbn_torch.runtime import distributed as dist

            self._log = dist.get_logger("tpu_syncbn_torch.obs")
        return self._log

    # -- recording ---------------------------------------------------------

    def _ring_for(self, n: int) -> _HostRing:
        """The page-locked rows, wide enough for ``n`` CUDA scalars (CUDA
        scalars exist only where CUDA is available, so the rows do)."""
        if self._host_ring.reserve(n):
            self.counters.bump("host_block_grows")
        return self._host_ring

    def record_step(self, step: int, metrics=None, monitors=None) -> None:
        """Append one step's health record to the step ring. CUDA scalars
        are copied to the host behind the step on its stream, into the
        page-locked rows taken at construction (no synchronize, no
        allocation; module docstring); everything else is kept as it is
        and converted to JSON scalars at dump time."""
        metrics, monitors, copy = _split_on_card(metrics, monitors, self._ring_for)
        entry = {"step": int(step), "t": self._now(),
                 "metrics": metrics, "monitors": monitors, "copy": copy}
        with self._lock:
            self._steps.append(entry)

    def record_serve(self, kind: str, **detail) -> None:
        """Append one serve decision (shed / rejected / deadline_miss /
        circuit transition / …) to the serve ring."""
        entry = {"kind": str(kind), "t": self._now(), **detail}
        with self._lock:
            self._serve.append(entry)

    def record_mem(self, **reading) -> None:
        """Append one memory-watermark reading (JSON scalars — the sampler
        already flattened the device stats) to the mem ring."""
        entry = {"t": self._now(), **reading}
        with self._lock:
            self._mem.append(entry)

    def record_compile(self, family: str, seconds=None, **detail) -> None:
        """Append one compile-seam event to the compile ring."""
        entry = {"family": str(family), "t": self._now(), **detail}
        if seconds is not None:
            entry["seconds"] = round(float(seconds), 6)
        with self._lock:
            self._compile.append(entry)

    def record_autopilot(self, knob: str, **detail) -> None:
        """Append one autopilot decision to the autopilot ring (fed by
        ``runtime.autopilot.Autopilot`` at every decision)."""
        entry = {"knob": str(knob), "t": self._now(), **detail}
        with self._lock:
            self._autopilot.append(entry)

    def set_contract(self, **fields) -> None:
        """Merge static program-contract facts into the recorder —
        ``flops_per_step`` (``torch.utils.flop_counter``, as the bench
        counts), ``collective_bytes_per_step`` (``collectives.tallies()``),
        ``fingerprint`` — the join key the attribution report
        (``python -m tpu_syncbn_torch.obs.incident inspect``) uses to split
        step time into compute and collective shares."""
        with self._lock:
            self._contract.update(fields)

    # -- queries -----------------------------------------------------------

    def contract(self) -> dict:
        with self._lock:
            return dict(self._contract)

    @staticmethod
    def _step_entry(e: dict) -> dict:
        metrics = _scalarize_dict(e["metrics"])
        monitors = _scalarize_dict(e["monitors"])
        copy = e["copy"]
        if copy is not None:
            for (slot, k), v in zip(copy.keys, copy.values()):
                if v is not None:
                    (metrics if slot == 0 else monitors)[str(k)] = v
        return {"step": e["step"], "t": round(e["t"], 6),
                "metrics": metrics, "monitors": monitors}

    def rings_snapshot(self) -> dict:
        """JSON-ready copy of the rings (values converted here — dump
        time, not record time; a step whose host copy is still in flight
        reads ``"pending"``)."""
        with self._lock:
            steps = list(self._steps)
            serve = list(self._serve)
            mem = list(self._mem)
            compiles = list(self._compile)
            autopilot = list(self._autopilot)
        return {
            "steps": [self._step_entry(e) for e in steps],
            "serve": [
                {k: (_scalarize(v) if k != "kind" else v)
                 for k, v in e.items()}
                for e in serve
            ],
            "mem": [
                {k: (_scalarize(v) if k not in ("source",
                                                "contract_source") else v)
                 for k, v in e.items()}
                for e in mem
            ],
            "compile": [
                {k: (_scalarize(v) if k != "family" else v)
                 for k, v in e.items()}
                for e in compiles
            ],
            # decision fields (knob/action/signal/from/to) are strings by
            # construction; scalarize only the numeric payload
            "autopilot": [
                {k: (v if isinstance(v, str) else _scalarize(v))
                 for k, v in e.items()}
                for e in autopilot
            ],
        }

    def ring_coverage(self) -> dict:
        """How far back the step ring reaches: entry count and the
        monotonic span between its oldest and newest entries."""
        with self._lock:
            steps = list(self._steps)
        seconds = (steps[-1]["t"] - steps[0]["t"]) if len(steps) > 1 else 0.0
        return {"steps": len(steps), "seconds": round(seconds, 6)}

    # -- the trigger -------------------------------------------------------

    def trigger(
        self, kind: str, detail: dict | None = None, *, force: bool = False,
    ) -> str | None:
        """Dump an incident bundle now; returns its path, or ``None`` when
        the trigger was suppressed (cooldown, a dump already in flight) or
        the dump failed (logged — a recorder must never take down the
        workload it records). ``force=True`` (the manual trigger) bypasses
        the cooldown."""
        if not self._trigger_lock.acquire(blocking=False):
            self.counters.bump("suppressed")
            return None
        try:
            t = self._now()
            with self._lock:
                cooled = (force or self._last_dump_t is None
                          or t - self._last_dump_t >= self.cooldown_s)
                if cooled:
                    self._last_dump_t = t
                    self._seq += 1
                    seq = self._seq
            if not cooled:
                self.counters.bump("suppressed")
                return None
            self.counters.bump("triggers")
            from tpu_syncbn_torch.obs import incident as incident_mod

            t0 = time.perf_counter()
            bundle = incident_mod.build_bundle(
                self, kind, dict(detail or {}), seq=seq
            )
            path = incident_mod.write_bundle(
                bundle, self.incident_dir, max_bundles=self.max_bundles
            )
            dump_s = time.perf_counter() - t0
            with self._lock:
                self.last_incident = {
                    "id": bundle["incident_id"], "path": path,
                    "trigger": kind, "wall_time": bundle["wall_time"],
                }
            self.counters.bump("bundles")
            telemetry.observe("incident.dump_s", dump_s)
            telemetry.set_gauge("incident.bundle_bytes",
                                os.path.getsize(path))
            tracing.instant("incident_bundle", trigger=kind,
                            incident_id=bundle["incident_id"])
            self._logger().warning(
                "incident bundle %s dumped to %s (trigger=%s, %.0f ms)",
                bundle["incident_id"], path, kind, dump_s * 1e3,
            )
            return path
        except Exception:
            self.counters.bump("errors")
            # a failed dump must not spend the cooldown: the NEXT trigger
            # for this incident should get its chance at a bundle
            with self._lock:
                if self._last_dump_t == t:
                    self._last_dump_t = None
            self._logger().exception(
                "incident dump failed (trigger=%s) — continuing", kind,
            )
            return None
        finally:
            self._trigger_lock.release()


# ---------------------------------------------------------------------------
# module-level installed recorder (the hot-path API)


_installed: FlightRecorder | None = None
_install_lock = threading.Lock()


def install(recorder: FlightRecorder | None = None) -> FlightRecorder:
    """Install ``recorder`` (or a fresh default one) as the process flight
    recorder the module helpers feed; starts it. Returns it."""
    global _installed
    with _install_lock:
        if recorder is None:
            recorder = FlightRecorder()
        recorder.start()
        _installed = recorder
        return recorder


def uninstall() -> FlightRecorder | None:
    """Remove and return the installed recorder (closing it is the
    caller's choice — its rings stay intact for inspection)."""
    global _installed
    with _install_lock:
        rec, _installed = _installed, None
        return rec


def get() -> FlightRecorder | None:
    return _installed


def install_from_env() -> FlightRecorder | None:
    """Install (once) the process recorder if ``TPU_SYNCBN_FLIGHTREC`` is
    truthy; return it (or the one already installed, or ``None`` when the
    env gate is off). Idempotent — ``ResilientLoop.run`` calls it, so
    exporting the env var is the whole knob."""
    global _installed
    if os.environ.get(_ENV_FLAG, "").strip().lower() not in _TRUTHY:
        return None
    with _install_lock:
        if _installed is not None:
            return _installed
        _installed = FlightRecorder().start()
        return _installed


def record_step(step: int, metrics=None, monitors=None) -> None:
    """Feed one step record to the installed recorder (one global load +
    None test when no recorder is installed — hot-loop safe)."""
    rec = _installed
    if rec is not None:
        rec.record_step(step, metrics=metrics, monitors=monitors)


def record_serve(kind: str, **detail) -> None:
    """Feed one serve decision to the installed recorder (no-op without a
    recorder)."""
    rec = _installed
    if rec is not None:
        rec.record_serve(kind, **detail)


def record_compile(family: str, seconds=None, **detail) -> None:
    """Feed one compile-seam event to the installed recorder (no-op
    without one)."""
    rec = _installed
    if rec is not None:
        rec.record_compile(family, seconds, **detail)


def record_autopilot(knob: str, **detail) -> None:
    """Feed one autopilot decision to the installed recorder (no-op
    without one)."""
    rec = _installed
    if rec is not None:
        rec.record_autopilot(knob, **detail)


def trigger(
    kind: str, detail: dict | None = None, *, force: bool = False,
) -> str | None:
    """Fire the installed recorder's trigger (no-op without one)."""
    rec = _installed
    if rec is not None:
        return rec.trigger(kind, detail, force=force)
    return None


def install_signal_trigger(signum: int | None = None):
    """Opt-in: make a signal the manual trigger (``kill -USR2 <pid>`` dumps
    a bundle). Signal handlers are process-global and main-thread-only, so
    this defaults to SIGUSR2 and is never installed implicitly. Returns the
    previous handler."""
    import signal as _signal

    if signum is None:
        signum = _signal.SIGUSR2

    def _handle(sig, frame):
        trigger("manual", {"source": "signal", "signum": int(sig)},
                force=True)

    return _signal.signal(signum, _handle)
