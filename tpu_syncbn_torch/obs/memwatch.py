"""Live device-memory telemetry: watermarks against a pinned contract —
the counterpart of ``tpu_syncbn.obs.memwatch`` (the JAX package's
``__init__`` imports JAX, so the port keeps its own copy; the ``mem.*``
metric names, the reading's keys and the mem ring are the JAX module's).

* :class:`MemorySampler` — a background sampler (the
  :class:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator` discipline:
  injectable clock and readers, manual :meth:`~MemorySampler.sample` for
  tests, ``start()``/``close()`` daemon thread) publishing per-device
  ``mem.device.bytes_in_use`` / ``mem.device.peak_bytes`` gauges from the
  caching allocator (:func:`device_readings`). Without CUDA (the CPU) it
  degrades to host evidence: process RSS and the live
  :class:`~tpu_syncbn_torch.parallel.scan_driver.ProgramCache` bytes.
* the **static-against-live reconciler** —
  :meth:`MemorySampler.set_contract` takes a per-device byte budget; every
  sample then publishes ``mem.used_frac`` (live bytes / contract,
  histogram) and the ``mem.headroom_frac`` gauge, and a sample past
  ``pressure_threshold`` bumps ``mem.pressure_trips`` and fires the
  ``mem_pressure`` flight-recorder trigger — an incident bundle with the
  watermark ring from before the pressure, ahead of an out-of-memory
  error.

Every sample also feeds the flight recorder's bounded **mem ring**
(:meth:`~tpu_syncbn_torch.obs.flightrec.FlightRecorder.record_mem`), so
any incident bundle carries the recent watermark history.

**Beside a graph capture.** A CUDA graph captured in the default global
mode (``torch.cuda.graph``'s; ``parallel.scan_driver`` captures in
thread-local mode) is invalidated by an unsafe CUDA runtime call from
*any* thread. The sampler's thread therefore makes none: no
``mem_get_info``, no ``synchronize``, no ``reset_peak_memory_stats``. It
reads the allocator's host-side counters
(``torch.cuda.memory_stats_as_nested_dict``) and the device's
``total_memory`` (cached after the first read), and a ``mem_pressure``
dump reads the step ring without a CUDA call
(:mod:`~tpu_syncbn_torch.obs.flightrec`).

Cost contract: sampling is **off by default** — nothing runs unless
``TPU_SYNCBN_MEMWATCH`` is truthy (:func:`install_from_env`, called by
``ResilientLoop.run``; interval ``TPU_SYNCBN_MEMWATCH_INTERVAL_S``) or a
sampler is built explicitly. The readers consult CUDA only when
``torch.cuda.is_initialized()``: a sampler never initializes the card.

:func:`mem_rules` is the SLO form of the pressure check (``obs.slo``).
"""

from __future__ import annotations

import os
import threading
import time

from tpu_syncbn_torch.obs import flightrec, telemetry

_ENV_FLAG = "TPU_SYNCBN_MEMWATCH"
_ENV_INTERVAL_S = "TPU_SYNCBN_MEMWATCH_INTERVAL_S"
_TRUTHY = ("1", "true", "on", "yes")

DEFAULT_INTERVAL_S = 1.0

#: Fraction of the pinned per-device contract at which a sample is
#: memory *pressure* (trip counter + incident trigger). 0.9 leaves the
#: allocator its fragmentation slack.
DEFAULT_PRESSURE_THRESHOLD = 0.9

#: Upper bound on a live-array census walk (the JAX module's
#: ``jax.live_arrays()`` cap; the port's census reads allocator counters
#: and walks nothing, :func:`host_readings`).
ARRAY_CENSUS_CAP = 4096

#: ``mem.used_frac`` histogram buckets: fraction-of-contract edges with
#: resolution around the pressure threshold and headroom for >1 (over
#: contract IS the signal the reconciler exists to catch).
FRAC_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                0.95, 1.0, 1.1, 1.25, 1.5, 2.0)


# ---------------------------------------------------------------------------
# readers (injectable for deterministic tests)

#: ``total_memory`` per device index, read once (``get_device_properties``
#: asks the CUDA runtime the first time only).
_limits: dict[int, int] = {}


def _cuda_ready():
    """``torch`` when CUDA is already initialized in this process, else
    ``None``. Never initializes it (the telemetry ``_host_index`` rule): a
    sampler must never be what wakes the card."""
    try:
        import torch

        if torch.cuda.is_initialized():
            return torch
    except Exception:
        pass
    return None


def _limit_bytes(torch, index: int) -> int | None:
    limit = _limits.get(index)
    if limit is None:
        try:
            limit = _limits[index] = int(
                torch.cuda.get_device_properties(index).total_memory)
        except Exception:
            return None
    return limit or None


def device_readings() -> list[dict] | None:
    """Per-local-device ``{"id", "bytes_in_use", "peak_bytes",
    "limit_bytes"}`` from the caching allocator's counters
    (``torch.cuda.memory_stats_as_nested_dict(i)``, unflattened:
    ``allocated_bytes.all.current`` and ``.peak``, what
    ``memory_allocated`` / ``max_memory_allocated`` report) and
    ``get_device_properties(i).total_memory``, or ``None`` when CUDA is
    not initialized in this process (never initializes it).

    The allocator's counters are host-side and reading them makes no CUDA
    runtime call, so a sampler thread may read them while another thread
    captures a CUDA graph in global mode (an unsafe runtime call from any
    thread would invalidate that capture)."""
    torch = _cuda_ready()
    if torch is None:
        return None
    try:
        n = torch.cuda.device_count()
    except Exception:
        return None
    out = []
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats_as_nested_dict(i)
            allocated = stats["allocated_bytes"]["all"]
        except Exception:
            return None  # one silent device would skew the max
        used = int(allocated["current"])
        out.append({
            "id": i,
            "bytes_in_use": used,
            "peak_bytes": int(allocated["peak"]),
            "limit_bytes": _limit_bytes(torch, i),
        })
    return out or None


def host_readings(census_cap: int = ARRAY_CENSUS_CAP) -> dict:
    """Host-side evidence: process RSS and peak RSS, the live program-cache
    bytes (:func:`tpu_syncbn_torch.parallel.scan_driver.live_cache_bytes`:
    the captured graphs' pools), and the allocator's live-tensor census.

    The JAX module walks ``jax.live_arrays()`` (at most ``census_cap``
    arrays); torch has no such list. When CUDA is initialized the census
    comes from the caching allocator's own counters instead —
    ``arrays_count`` is ``active.all.current`` (live blocks) and
    ``arrays_bytes`` ``active_bytes.all.current``
    (``memory_stats_as_nested_dict``), summed over the devices,
    with no object walk, so ``census_cap`` bounds nothing here and
    ``arrays_truncated`` stays False. On the CPU both stay ``None``, as in
    JAX when it reads nothing."""
    out = {
        "rss_bytes": None,
        "peak_rss_bytes": None,
        "cache_bytes_live": 0,
        "arrays_bytes": None,
        "arrays_count": None,
        "arrays_truncated": False,
    }
    try:
        import resource
        import sys

        ru = resource.getrusage(resource.RUSAGE_SELF)
        # ru_maxrss unit is platform-defined: KiB on linux/BSD, bytes on
        # darwin — an unconditional *1024 would inflate macOS peaks 1024x
        unit = 1 if sys.platform == "darwin" else 1024
        out["peak_rss_bytes"] = int(ru.ru_maxrss) * unit
    except Exception:
        pass
    try:
        with open("/proc/self/statm") as f:
            out["rss_bytes"] = (
                int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
            )
    except Exception:
        out["rss_bytes"] = out["peak_rss_bytes"]
    try:
        from tpu_syncbn_torch.parallel import scan_driver

        out["cache_bytes_live"] = int(scan_driver.live_cache_bytes())
    except Exception:
        pass
    torch = _cuda_ready()
    if torch is not None:
        try:
            count = nbytes = 0
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats_as_nested_dict(i)
                count += int(stats["active"]["all"]["current"])
                nbytes += int(stats["active_bytes"]["all"]["current"])
            out["arrays_count"], out["arrays_bytes"] = count, nbytes
        except Exception:
            pass
    return out


# ---------------------------------------------------------------------------
# the sampler


class MemorySampler:
    """Publish live memory watermarks into the telemetry registry and
    reconcile them against a pinned per-device contract (module
    docstring has the design).

    ``registry`` defaults to the process registry; publishing is gated
    on :func:`telemetry.enabled` (the obs cost contract). ``recorder``
    overrides where the mem ring + ``mem_pressure`` trigger go (default:
    the installed process flight recorder; the bench's planted drill passes
    its own). ``pressure_threshold=None`` disables triggering (the
    reconciler still publishes). ``device_reader`` / ``host_reader`` /
    ``now`` are injectable for deterministic tests."""

    def __init__(
        self,
        *,
        registry: telemetry.Registry | None = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        contract_bytes_per_device: int | None = None,
        contract_source: str | None = None,
        pressure_threshold: float | None = DEFAULT_PRESSURE_THRESHOLD,
        census_cap: int = ARRAY_CENSUS_CAP,
        device_reader=device_readings,
        host_reader=host_readings,
        recorder=None,
        now=time.monotonic,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if contract_bytes_per_device is not None \
                and contract_bytes_per_device < 1:
            raise ValueError(
                "contract_bytes_per_device must be >= 1, got "
                f"{contract_bytes_per_device}"
            )
        if pressure_threshold is not None and pressure_threshold <= 0:
            raise ValueError(
                f"pressure_threshold must be > 0, got {pressure_threshold}"
            )
        self._registry = registry if registry is not None \
            else telemetry.REGISTRY
        self.interval_s = float(interval_s)
        self.pressure_threshold = pressure_threshold
        self.census_cap = int(census_cap)
        self._device_reader = device_reader
        self._host_reader = host_reader
        self._recorder = recorder
        self._now = now
        self._lock = threading.Lock()
        self._contract_bytes = contract_bytes_per_device
        self._contract_source = contract_source
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: newest reading (JSON scalars), for tests and the bench
        self.last: dict = {}
        self.samples = 0

    # -- contract ----------------------------------------------------------

    def set_contract(
        self, bytes_per_device: int | None, *, source: str | None = None,
    ) -> None:
        """Pin (or clear, with ``None``) the per-device peak the
        reconciler divides live usage by — a measured steady peak (the
        bench feeds its warm step's ``max_memory_allocated``; the port has
        no audited peak until its contract extractor, ROADMAP A.14b) or a
        deliberate operator budget. ``source`` is recorded in every
        reading so a bundle says whose number the headroom was
        computed against."""
        if bytes_per_device is not None and bytes_per_device < 1:
            raise ValueError(
                f"bytes_per_device must be >= 1, got {bytes_per_device}"
            )
        with self._lock:
            self._contract_bytes = (
                None if bytes_per_device is None else int(bytes_per_device)
            )
            self._contract_source = source

    def contract(self) -> dict:
        with self._lock:
            return {
                "bytes_per_device": self._contract_bytes,
                "source": self._contract_source,
            }

    # -- sampling ----------------------------------------------------------

    def sample(self) -> dict:
        """Take one reading, publish it (when telemetry is enabled),
        feed the flight recorder's mem ring, and evaluate the pressure
        trigger. Returns the reading."""
        t0 = time.perf_counter()
        devices = None
        try:
            devices = self._device_reader()
        except Exception:
            devices = None
        host = {}
        try:
            host = self._host_reader(
                self.census_cap if devices is None else 0
            ) or {}
        except Exception:
            host = {}
        with self._lock:
            contract = self._contract_bytes
            contract_source = self._contract_source

        reading: dict = {
            "t": round(self._now(), 6),
            "source": "device" if devices else "host",
            "devices": len(devices) if devices else 0,
            "contract_bytes_per_device": contract,
            "contract_source": contract_source,
        }
        if devices:
            used = max(d["bytes_in_use"] for d in devices)
            peak = max(d["peak_bytes"] for d in devices)
            limits = [d["limit_bytes"] for d in devices
                      if d["limit_bytes"]]
            reading["bytes_in_use"] = used
            reading["peak_bytes"] = peak
            reading["limit_bytes"] = min(limits) if limits else None
        else:
            # host fallback: the live-array census is the closest thing
            # to "bytes on the (one) device"; RSS is the whole-process
            # watermark (the CPU has no census: RSS it is)
            used = host.get("arrays_bytes")
            if used is None:
                used = host.get("rss_bytes") or 0
            reading["bytes_in_use"] = int(used)
            reading["peak_bytes"] = int(
                host.get("peak_rss_bytes") or used
            )
            reading["limit_bytes"] = None
        for key in ("rss_bytes", "peak_rss_bytes", "cache_bytes_live",
                    "arrays_bytes", "arrays_count", "arrays_truncated"):
            if host.get(key) is not None:
                reading[key] = host[key]

        used_frac = headroom_frac = None
        if contract:
            used_frac = reading["bytes_in_use"] / contract
            headroom_frac = 1.0 - used_frac
            reading["used_frac"] = round(used_frac, 6)
            reading["headroom_frac"] = round(headroom_frac, 6)

        self._publish(reading, devices, used_frac, headroom_frac)

        rec = self._recorder if self._recorder is not None \
            else flightrec.get()
        if rec is not None:
            rec.record_mem(**{k: v for k, v in reading.items()
                              if k != "t"})
        tripped = (
            self.pressure_threshold is not None
            and used_frac is not None
            and used_frac > self.pressure_threshold
        )
        if tripped:
            if telemetry.enabled():
                self._registry.counter("mem.pressure_trips").inc()
            if rec is not None:
                rec.trigger("mem_pressure", {
                    "bytes_in_use": reading["bytes_in_use"],
                    "contract_bytes_per_device": contract,
                    "contract_source": contract_source,
                    "used_frac": round(used_frac, 6),
                    "threshold": self.pressure_threshold,
                    "source": reading["source"],
                })
        reading["pressure"] = bool(tripped)
        with self._lock:
            self.samples += 1
            self.last = reading
        if telemetry.enabled():
            self._registry.histogram("mem.sample_s").observe(
                time.perf_counter() - t0
            )
        return reading

    def _publish(self, reading, devices, used_frac, headroom_frac) -> None:
        if not telemetry.enabled():
            return
        reg = self._registry
        reg.counter("mem.samples").inc()
        reg.gauge("mem.device.bytes_in_use").set(reading["bytes_in_use"])
        reg.gauge("mem.device.peak_bytes").set(reading["peak_bytes"])
        if reading.get("limit_bytes"):
            reg.gauge("mem.device.limit_bytes").set(reading["limit_bytes"])
        if devices:
            for d in devices:
                reg.gauge(
                    f"mem.device.bytes_in_use.d{d['id']}"
                ).set(d["bytes_in_use"])
                reg.gauge(
                    f"mem.device.peak_bytes.d{d['id']}"
                ).set(d["peak_bytes"])
        for key, name in (
            ("rss_bytes", "mem.host.rss_bytes"),
            ("peak_rss_bytes", "mem.host.peak_rss_bytes"),
            ("cache_bytes_live", "mem.cache.bytes_live"),
            ("arrays_bytes", "mem.arrays.bytes"),
            ("arrays_count", "mem.arrays.count"),
        ):
            if reading.get(key) is not None:
                reg.gauge(name).set(reading[key])
        if reading.get("arrays_count") is not None:
            # unconditional 0/1: a single historical cap hit must not
            # read as "still an undercount" forever
            reg.gauge("mem.arrays.truncated").set(
                1.0 if reading.get("arrays_truncated") else 0.0
            )
        if used_frac is not None:
            reg.histogram("mem.used_frac", FRAC_BUCKETS).observe(used_frac)
            reg.gauge("mem.headroom_frac").set(round(headroom_frac, 6))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MemorySampler":
        """Start the background sampler thread (daemon; idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-memwatch", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:
                # a broken reader must not kill the sampler thread; the
                # next interval retries
                pass

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)

    def __enter__(self) -> "MemorySampler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# SLO rules


def mem_rules(
    *,
    pressure_slo: str = "mem.used_frac p99 < 0.9",
    windows_s=(60.0, 300.0),
    burn_threshold: float = 2.0,
) -> list:
    """The memory-pressure SLO rule, ready for
    ``SLOTracker(agg, mem_rules()).attach()`` (``obs.slo``): the windowed
    p99 of live bytes over the contract must stay under the pressure
    threshold — sustained samples above it mean the contract no longer
    describes the running program (layout drift, a leak, a tenant over
    budget) and the process is walking toward an out-of-memory error."""
    from tpu_syncbn_torch.obs import slo

    return [
        slo.AlertRule("mem_pressure", pressure_slo,
                      windows_s=windows_s, burn_threshold=burn_threshold),
    ]


# ---------------------------------------------------------------------------
# module-level installed sampler (env-gated, like flightrec)


_installed: MemorySampler | None = None
_install_lock = threading.Lock()


def install(sampler: MemorySampler | None = None) -> MemorySampler:
    """Install ``sampler`` (or a fresh default one) as the process
    memory sampler and start its background thread. Returns it."""
    global _installed
    with _install_lock:
        if sampler is None:
            sampler = MemorySampler()
        sampler.start()
        _installed = sampler
        return sampler


def uninstall() -> MemorySampler | None:
    """Remove and return the installed sampler (closing it is the
    caller's choice)."""
    global _installed
    with _install_lock:
        sampler, _installed = _installed, None
        return sampler


def get() -> MemorySampler | None:
    return _installed


def install_from_env() -> MemorySampler | None:
    """Install (once) the process sampler if ``TPU_SYNCBN_MEMWATCH`` is
    truthy (interval from ``TPU_SYNCBN_MEMWATCH_INTERVAL_S``); return
    it, the one already installed, or ``None``. Idempotent —
    ``ResilientLoop.run`` calls it, so exporting the env var is the whole
    knob."""
    global _installed
    if os.environ.get(_ENV_FLAG, "").strip().lower() not in _TRUTHY:
        return None
    with _install_lock:
        if _installed is not None:
            return _installed
        try:
            interval_s = float(
                os.environ.get(_ENV_INTERVAL_S, "").strip()
                or DEFAULT_INTERVAL_S
            )
        except ValueError:
            interval_s = DEFAULT_INTERVAL_S
        _installed = MemorySampler(interval_s=interval_s).start()
        return _installed
