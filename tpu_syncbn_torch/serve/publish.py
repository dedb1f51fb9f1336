"""Zero-downtime weight publication: manifest-verified versioned hot swap
with drain, rollback and a bounded transient footprint — the counterpart
of ``tpu_syncbn.serve.publish``.

A :class:`SwapController` rolls a new weight version into a *running*
:class:`~tpu_syncbn_torch.serve.engine.InferenceEngine`, without the cold
start of building a new engine (a deep copy of the module and one CUDA
graph capture a bucket):

* **sources** — :meth:`SwapController.swap_from_trainer` takes a live
  ``DataParallel``'s weights from its module: the parameters and, riding
  along, the BN running statistics from its buffers. Under a layout that
  shards the parameters (``zero=True``, FSDP) the trainer all-gathers its
  flat shards back into the module after every step, so the module holds
  the full values and no gather is needed here.
  :meth:`SwapController.swap_from_publication` loads the published version
  (:func:`tpu_syncbn_torch.utils.checkpoint.load_published`) into host
  memory: a truncated or bit-flipped publication is **rejected** (the old
  version keeps serving), and a structurally skewed one is rejected
  before its payload is read
  (:class:`~tpu_syncbn_torch.utils.checkpoint.PublicationSkewError`).
* **one live weight set** — every captured graph reads the engine's own
  tensors by address, so each source ends in
  :meth:`~tpu_syncbn_torch.serve.engine.InferenceEngine.swap_params`, which
  copies the new values *into* them and keeps the outgoing values as a
  device copy (the rollback target): a swap reuses every captured graph,
  and a batch in flight finishes on the version it started on. That copy
  doubles the serving state's device bytes while it is held; with a
  ``memwatch`` contract installed, a swap whose projected usage would
  cross the pressure threshold fires ``mem_pressure`` and **aborts
  cleanly** instead of running the allocator out of memory under traffic.
* **drain / readiness** — the controller registers a ``/readyz`` hook
  (``health_name``, default ``publication``) that is not ready exactly for
  the critical window (pre-commit to probe settled); a
  :class:`~tpu_syncbn_torch.runtime.resilience.PreemptionGuard` that has
  fired aborts a swap not yet committed and cuts the probe window of a
  committed one short, so a draining process never wedges mid-swap.
* **rollback** — a failed post-swap health probe (the canary batch
  raising, or the serving circuit breaker opening within
  ``probe_window_s``) rolls back to the retained previous version, bit
  for bit.
* **observability** — the ``serve.version{mode=active|previous}`` gauges
  (and their deprecated flat mirrors), the ``serve.swap_s`` histogram, the
  ``serve.swaps_total`` / ``serve.rollbacks_total`` /
  ``serve.swap_rejected_total`` counters; every swap, rejection and
  rollback lands in the flight recorder's serve ring and fires a
  ``weight_swap`` incident bundle; ``/statusz`` renders the publication
  section and ``obs.slo.publication_rules`` watches the rollback budget.

The chaos matrix over this path (corrupt publication, SIGTERM mid-swap,
crash on the new version, version skew, memwatch abort) is in
:mod:`tpu_syncbn_torch.testing.faults`; ``python -m tpu_syncbn_torch.bench
--serve`` measures a swap under load in the serve block's ``publish``
section.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from tpu_syncbn_torch.obs import flightrec, telemetry

__all__ = [
    "SWAP_PHASES",
    "PublicationError",
    "SwapAbortedError",
    "SwapController",
]

#: The swap's phase sequence, in order. ``phase_hook(phase)`` fires at
#: each boundary — the deterministic injection seam the fault harness
#: keys on (``testing.faults.signal_at_phase``).
SWAP_PHASES = ("verify", "preflight", "not_ready", "commit", "probe", "ready")


def _publish_version(mode: str, value: float) -> None:
    """Publish the ``serve.version{mode=...}`` gauge (``mode`` is
    ``active`` or ``previous``), mirrored to the legacy flat
    ``serve.version.<mode>`` name behind a DeprecationWarning so
    dashboards that predate labels keep resolving."""
    telemetry.set_gauge("serve.version", value, labels={"mode": mode})
    legacy = f"serve.version.{mode}"
    telemetry.warn_deprecated_name(
        legacy, telemetry.labeled_name("serve.version", {"mode": mode}))
    telemetry.set_gauge(legacy, value)


def serving_state(trainer) -> tuple[dict, dict]:
    """A live ``DataParallel``'s weights in the serving structure:
    ``({name: parameter}, {name: buffer})`` of its module, detached. This
    holds for every layout: under one that shards the parameters the
    trainer writes the all-gathered values into the module's parameters
    after each step (``DataParallel._gather_params``), so the module is
    already the full tree and reading it costs no collective."""
    model = trainer.model
    params = {n: p.detach() for n, p in model.named_parameters()}
    rest = {n: b.detach() for n, b in model.named_buffers() if b is not None}
    return params, rest


class PublicationError(RuntimeError):
    """A weight swap could not be performed; serving state untouched."""


class SwapAbortedError(PublicationError):
    """The swap aborted cleanly before commit (preemption drain, or the
    projected double buffer would cross the memwatch pressure threshold).
    The engine still serves the pre-swap version."""


class SwapController:
    """Orchestrates versioned hot swaps on one
    :class:`~tpu_syncbn_torch.serve.engine.InferenceEngine` (duck-typed:
    ``swap_params`` / ``rollback`` / ``version`` / ``previous_version`` —
    the fault harness swaps stand-ins in).

    ``batcher`` (optional) donates its circuit breaker and preemption guard
    — the breaker is the post-swap health signal (it opens when the NEW
    version's engine calls fail, which is exactly the automatic rollback
    trigger), the guard is the drain signal. Both can also be passed
    explicitly. ``probe_window_s`` bounds how long a committed swap watches
    the breaker before declaring the new version healthy (0 = only the
    synchronous ``canary`` probe, no wait). ``phase_hook`` is called with
    each :data:`SWAP_PHASES` name as the swap crosses it (the fault
    injection seam; an exception from the hook propagates like a real
    fault at that point)."""

    def __init__(
        self,
        engine,
        *,
        batcher=None,
        guard=None,
        breaker=None,
        health_name: str = "publication",
        probe_window_s: float = 0.0,
        probe_poll_s: float = 0.05,
        phase_hook: Callable[[str], None] | None = None,
    ):
        from tpu_syncbn_torch.obs import server as obs_server

        self.engine = engine
        self._guard = guard if guard is not None else (
            getattr(batcher, "guard", None) if batcher is not None else None)
        self._breaker = breaker if breaker is not None else (
            getattr(batcher, "breaker", None) if batcher is not None else None)
        if probe_window_s < 0:
            raise ValueError(f"probe_window_s must be >= 0, got {probe_window_s}")
        self.probe_window_s = float(probe_window_s)
        self.probe_poll_s = float(probe_poll_s)
        self._phase_hook = phase_hook
        self._health_name = str(health_name)
        self._swapping = False
        # RLock: the reject/abort accounting runs both under swap()'s hold
        # and bare (swap_from_publication rejects before swapping)
        self._lock = threading.RLock()
        self.swaps = 0
        self.rollbacks = 0
        self.rejected = 0
        self.last: dict | None = None
        _publish_version("active", int(getattr(engine, "version", 0)))
        obs_server.register_readiness(self._health_name, self.readiness)
        self._registered = True

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        from tpu_syncbn_torch.obs import server as obs_server

        if self._registered:
            obs_server.unregister_readiness(self._health_name)
            self._registered = False

    def __enter__(self) -> "SwapController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- readiness ---------------------------------------------------------

    def readiness(self) -> tuple[bool, dict]:
        """The ``/readyz`` contribution (the ``health_name`` hook): NOT
        ready exactly while a swap is inside its critical window
        (pre-commit to probe settled) — the window a balancer should route
        around — ready otherwise, with the live version pair and the swap,
        rollback and rejection counts as detail."""
        swapping = self._swapping
        return not swapping, {
            "swapping": swapping,
            "version": int(getattr(self.engine, "version", 0)),
            "previous_version": getattr(self.engine, "previous_version", None),
            "swaps": self.swaps,
            "rollbacks": self.rollbacks,
            "rejected": self.rejected,
        }

    # -- internals ---------------------------------------------------------

    def _phase(self, name: str) -> None:
        if self._phase_hook is not None:
            self._phase_hook(name)

    def _preempted(self) -> bool:
        return self._guard is not None and bool(self._guard.preempted)

    def _reject(self, *, version, source: str, reason: str) -> None:
        """Account a rejected publication or swap (serving untouched)."""
        with self._lock:
            self.rejected += 1
        telemetry.count("serve.swap_rejected_total")
        detail = {
            "outcome": "rejected", "version": version, "source": source,
            "reason": reason,
            "serving_version": int(getattr(self.engine, "version", 0)),
        }
        flightrec.record_serve("weight_swap", **detail)
        flightrec.trigger("weight_swap", detail)

    def _preflight_memory(self, version, source: str) -> None:
        """The memwatch double-buffer bound: with a sampler installed AND a
        pinned contract, project the bytes in use plus the engine's serving
        state (``params_nbytes``: live, and retained when a rollback target
        is held) against the pressure threshold; a swap that would cross
        it fires ``mem_pressure`` and aborts cleanly (the alternative is
        the allocator failing live traffic mid-swap)."""
        from tpu_syncbn_torch.obs import memwatch

        sampler = memwatch.get()
        if sampler is None:
            return
        contract = sampler.contract().get("bytes_per_device")
        threshold = sampler.pressure_threshold
        if not contract or threshold is None:
            return
        nbytes = getattr(self.engine, "params_nbytes", None)
        if not callable(nbytes):
            return
        incoming = int(nbytes())
        reading = sampler.sample()
        used = int(reading.get("bytes_in_use") or 0)
        projected = (used + incoming) / contract
        if projected <= threshold:
            return
        detail = {
            "outcome": "aborted", "version": version, "source": source,
            "reason": "mem_pressure",
            "bytes_in_use": used,
            "double_buffer_bytes": incoming,
            "projected_frac": round(projected, 6),
            "threshold": threshold,
            "contract_bytes_per_device": contract,
        }
        flightrec.record_serve("weight_swap", **detail)
        flightrec.trigger("mem_pressure", detail)
        telemetry.count("serve.swap_rejected_total")
        with self._lock:
            self.rejected += 1
        raise SwapAbortedError(
            f"swap to v{version} would put projected device usage at "
            f"{projected:.2f}x the memwatch contract (threshold {threshold}) "
            f"— double buffer of {incoming} B does not fit; aborting with "
            "the old version serving")

    def _probe(self, canary) -> str | None:
        """Post-swap health probe. Returns a failure reason, or None when
        the new version looks healthy: first the synchronous canary (a
        batch through the new version — an engine that cannot answer it is
        dead on arrival), then the circuit-breaker watch — the breaker
        opening inside ``probe_window_s`` means real traffic is failing on
        the new version."""
        if canary is not None:
            try:
                self.engine.predict(canary)
            except Exception as e:
                return f"canary failed: {type(e).__name__}: {e}"
        breaker = self._breaker
        if breaker is None or self.probe_window_s <= 0:
            return None
        deadline = time.monotonic() + self.probe_window_s
        while time.monotonic() < deadline:
            if getattr(breaker, "state", None) == "open":
                return "circuit breaker opened on the new version"
            if self._preempted():
                return None  # draining: stop watching, keep the swap
            time.sleep(min(self.probe_poll_s, max(0.0, deadline - time.monotonic())))
        return None

    # -- the swap ----------------------------------------------------------

    def swap(self, params, rest=None, *, version: int | None = None,
             source: str = "direct", canary=None) -> dict:
        """Roll ``params`` (and ``rest``, the buffers) in as the next
        weight version. Returns a result dict (``outcome`` ``"swapped"`` or
        ``"rolled_back"``, versions, timings). Raises
        :class:`SwapAbortedError` on a clean pre-commit abort (preemption
        drain, memwatch bound) and
        :class:`~tpu_syncbn_torch.serve.engine.VersionSkewError` on a
        structure mismatch — in every raising case the engine still serves
        its pre-swap version."""
        from tpu_syncbn_torch.serve.engine import VersionSkewError

        with self._lock:
            t0 = time.perf_counter()
            if version is None:
                version = int(getattr(self.engine, "version", 0)) + 1
            version = int(version)
            self._phase("verify")
            if self._preempted():
                self._reject(version=version, source=source, reason="preempted")
                raise SwapAbortedError(
                    "preemption signaled: draining, not starting a swap")
            self._phase("preflight")
            self._preflight_memory(version, source)
            self._swapping = True  # the /readyz critical window opens
            try:
                self._phase("not_ready")
                if self._preempted():
                    self._reject(version=version, source=source, reason="preempted")
                    raise SwapAbortedError(
                        "preemption signaled mid-swap before commit: draining "
                        "with the old version serving")
                self._phase("commit")
                try:
                    old = self.engine.swap_params(params, rest, version=version)
                except VersionSkewError:
                    self._reject(version=version, source=source, reason="version_skew")
                    raise
                commit_s = time.perf_counter() - t0
                self._phase("probe")
                failure = self._probe(canary)
                if failure is not None:
                    restored = self.engine.rollback()
                    self.rollbacks += 1
                    swap_s = time.perf_counter() - t0
                    telemetry.count("serve.rollbacks_total")
                    _publish_version("active", restored)
                    _publish_version("previous", version)
                    result = {
                        "outcome": "rolled_back", "version": restored,
                        "failed_version": version, "source": source,
                        "reason": failure,
                        "commit_s": round(commit_s, 6),
                        "swap_s": round(swap_s, 6),
                    }
                    flightrec.record_serve("weight_swap", **result)
                    flightrec.trigger("weight_swap", result)
                    self.last = result
                    return result
            finally:
                self._phase("ready")
                self._swapping = False  # the critical window closes
            swap_s = time.perf_counter() - t0
            self.swaps += 1
            telemetry.count("serve.swaps_total")
            telemetry.observe("serve.swap_s", swap_s)
            _publish_version("active", version)
            _publish_version("previous", old)
            result = {
                "outcome": "swapped", "version": version,
                "previous_version": old, "source": source,
                "commit_s": round(commit_s, 6),
                "swap_s": round(swap_s, 6),
            }
            flightrec.record_serve("weight_swap", **result)
            flightrec.trigger("weight_swap", result)
            self.last = result
            return result

    def rollback(self, *, reason: str = "manual") -> dict:
        """Roll serving back to the retained previous version (the
        operator's big red button; the probe path calls the same engine
        primitive). Returns a result dict."""
        with self._lock:
            t0 = time.perf_counter()
            bad = int(getattr(self.engine, "version", 0))
            restored = self.engine.rollback()
            self.rollbacks += 1
            telemetry.count("serve.rollbacks_total")
            _publish_version("active", restored)
            _publish_version("previous", bad)
            result = {
                "outcome": "rolled_back", "version": restored,
                "failed_version": bad, "source": "manual",
                "reason": reason,
                "swap_s": round(time.perf_counter() - t0, 6),
            }
            flightrec.record_serve("weight_swap", **result)
            flightrec.trigger("weight_swap", result)
            self.last = result
            return result

    # -- sources -----------------------------------------------------------

    def swap_from_trainer(self, trainer, *, version: int | None = None,
                          canary=None) -> dict:
        """Hot-swap straight from a live ``DataParallel`` in this process
        (:func:`serving_state`: its module's parameters, full under every
        layout, and the BN running statistics from its buffers). The engine
        copies them into its own tensors, so the trainer trains on without
        touching what is served."""
        params, rest = serving_state(trainer)
        return self.swap(params, rest, version=version, source="trainer",
                         canary=canary)

    def swap_from_publication(self, directory: str, *, canary=None) -> dict:
        """Load the currently published weight version
        (:func:`tpu_syncbn_torch.utils.checkpoint.load_published`) into
        host memory and swap it in. Verification is the gate: a corrupt
        publication (truncated, bit-flipped, manifest missing) or a
        structurally skewed one (its manifest's ``tree_hash`` against this
        engine's ``{"params", "rest"}`` template, checked before the
        payload is read) is REJECTED — accounted in
        ``serve.swap_rejected_total`` and the flight recorder — and the
        exception propagates with the old version still serving; no
        request ever touches the bad bytes."""
        from tpu_syncbn_torch.utils import checkpoint as ckpt

        template = {"params": self.engine.param_template(),
                    "rest": self.engine._live()[1]}
        expect = ckpt.tree_structure_hash(template)
        try:
            tree, version = ckpt.load_published(directory, template,
                                                expect_tree_hash=expect)
        except ckpt.PublicationSkewError:
            self._reject(version=ckpt.published_version(directory),
                         source="publication", reason="version_skew")
            raise
        except (FileNotFoundError, ckpt.CheckpointCorruptError):
            self._reject(version=ckpt.published_version(directory),
                         source="publication", reason="corrupt")
            raise
        return self.swap(tree["params"], tree["rest"], version=version,
                         source="publication", canary=canary)
