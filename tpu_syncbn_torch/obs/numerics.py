"""Numerics observability: cross-replica drift and compression-health
monitors computed on the step's own tensors — the counterpart of
``tpu_syncbn.obs.numerics``.

Per-replica BN statistics silently diverging from the global batch's are
the hazard SyncBN exists to remove, and the compressed collectives add a
second one: int8 clip saturation and error-feedback residual growth. This
module gives both a metric.

**Device side** (no host read, no synchronize):

* a **collector** (:func:`collect` / :func:`record`) that the SyncBN
  moment reduction and the quantized collectives feed local health
  scalars into while a step runs — per-layer batch-moment skew against
  the synced value (``collectives.reduce_moments``, and at world 1 the
  fused BN's zero skew against itself), int8 per-chunk clip fraction and
  shared-range overflow headroom (``collectives._int8_qparams`` and the
  int8 sums). Producers are gated on :func:`active`, so a step built
  without monitors runs exactly the operations it always did;
* :func:`cross_replica_monitors` — ONE all-reduce of the stacked scalar
  vector that turns the per-replica local scalars into replicated
  monitors: the replica mean of every scalar and, for requested keys, the
  cross-replica relative dispersion (std/mean, from the Σx and Σx² halves
  of the same vector).

In JAX recording happens at trace time, once per compilation. Here it
happens on every eager step, and once at the capture of a CUDA graph
(``parallel.scan_driver``): the recorded tensors are then the graph's
outputs, rewritten by every replay, which gives the same values a step.

**Host side** (:class:`NumericsPublisher`): the monitors come back as
device tensors in ``StepOutput.monitors``. The publisher copies the
published ones without blocking into rows of a page-locked host block it
took when it was built (a process's first page-locked allocation waits
for the device, so none happens on a step) and records a CUDA event; an
entry lands as ``numerics.<key>`` histogram samples once its event has
completed, so the registry fills at step cadence with no forced
synchronize on the loop (the publisher launches its own kernels once when
it is built, too: a kernel's first launch waits for queued device work). A threshold crossing counts
``numerics.drift_trips`` and fires the flight recorder's
``numerics_drift`` trigger (``obs.flightrec``). :func:`numerics_rules` is
the SLO rule set over those series (``obs.slo``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Iterable, Mapping

import torch

from tpu_syncbn_torch.obs import telemetry

#: Denominator guard for the relative-skew / dispersion ratios.
EPS = 1e-6

#: Monitor keys the publisher exports as ``numerics.<key>`` histograms.
#: Everything else in ``StepOutput.monitors`` (grad_norm, BN health,
#: per-layer keys) stays a step output only.
PUBLISHED_MONITORS = frozenset({
    "bn_mean_skew", "bn_var_skew",
    "replica_grad_norm", "replica_grad_norm_disp",
    "d_replica_grad_norm", "d_replica_grad_norm_disp",
    "g_replica_grad_norm", "g_replica_grad_norm_disp",
    "clip_fraction", "overflow_headroom", "ef_residual_ratio",
})

#: A step whose ``clip_fraction`` exceeds this bumps the
#: ``numerics.clip_saturated`` counter: a chunk with a quarter of its
#: elements pinned at the int8 range edge is saturating, not quantizing.
CLIP_SATURATED_FRAC = 0.25

#: Default drift thresholds (``numerics.drift_trips``). Units are the
#: monitors' own: BN skew in global σ, dispersions as relative std, the EF
#: residual ratio as ‖residual‖/‖grad‖. ``NumericsPublisher(thresholds={})``
#: disables them.
DEFAULT_DRIFT_THRESHOLDS: dict[str, float] = {
    "bn_mean_skew": 8.0,
    "bn_var_skew": 8.0,
    "replica_grad_norm_disp": 4.0,
    "d_replica_grad_norm_disp": 4.0,
    "g_replica_grad_norm_disp": 4.0,
    "ef_residual_ratio": 4.0,
}


# ---------------------------------------------------------------------------
# collector (device side)


class Collector:
    """Accumulates the local health scalars recorded while a step runs.
    ``summary()`` folds repeated records of one key (one per BN layer, one
    per quantized payload) with ``max`` — drift anywhere is drift — in one
    ``stack`` and one ``amax`` a key, whatever the layer count, and adds
    ``bn_skew_layers``. The SyncBN layers' moments are kept as recorded
    (:meth:`record_moments`) and their skews computed in ``summary()`` over
    the concatenation of every layer's channels: the maximum over layers of
    each layer's maximum over channels, in a dozen launches instead of a
    dozen a layer. A disabled collector records nothing and summarizes to
    ``{}``."""

    __slots__ = ("enabled", "_records", "_moments")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._records: dict[str, list] = {}
        self._moments: list[tuple] = []

    def record(self, key: str, value) -> None:
        self._records.setdefault(key, []).append(value)

    def record_moments(self, local_sum, local_sumsq, local_count, mean, var) -> None:
        """One SyncBN reduction: this replica's ``(Σx, Σx², n)`` and the
        synced ``(mean, var)``, per channel (``n`` a scalar or per channel)."""
        self._moments.append(tuple(_flat_f32(t) for t in
                                   (local_sum, local_sumsq, local_count, mean, var)))

    def _skews(self) -> tuple[torch.Tensor, torch.Tensor]:
        from tpu_syncbn_torch.parallel.collectives import moments_from_stats

        ms = self._moments

        def cat(i):
            return torch.cat([m[i] for m in ms]) if len(ms) > 1 else ms[0][i]

        with torch.no_grad():
            count = torch.cat([m[2].expand(m[0].numel()) for m in ms])
            lmean, lvar = moments_from_stats(cat(0), cat(1), count)
            mean, var = cat(3), cat(4)
            sigma = torch.sqrt(torch.clamp_min(var, 0.0)) + EPS
            return (((lmean - mean).abs() / sigma).amax(),
                    ((lvar - var).abs() / (var + EPS)).amax())

    def summary(self) -> dict:
        records = {k: list(v) for k, v in self._records.items()}
        if self._moments:
            for key, value in zip(("bn_mean_skew", "bn_var_skew"), self._skews()):
                records.setdefault(key, []).append(value)
        layers = len(self._records.get("bn_mean_skew", ())) + len(self._moments)
        out: dict = {}
        for key, values in records.items():
            # one tensor recorded over and over (a lone layer's zero skew)
            # is its own maximum
            same = all(v is values[0] for v in values)
            out[key] = values[0] if same else torch.stack(values).amax()
        if layers:
            # how many synced-BN reductions fed the skew monitors: 0 would
            # mean the bn_*_skew keys are absent, not vacuous
            out["bn_skew_layers"] = torch.full(
                (), float(layers), dtype=torch.float32,
                device=records["bn_mean_skew"][0].device)
        return out


def _flat_f32(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    return t if t.dim() == 1 else t.reshape(-1)


# The stack is thread-local: two trainers stepping on two threads must not
# record into each other's step.
_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class collect:
    """Context manager activating a :class:`Collector` around the region a
    step's producers run in::

        with numerics.collect(enabled=bool(self.monitors)) as col:
            out = self.loss_fn(model, batch)
        monitors = col.summary()

    ``enabled=False`` yields an inert collector (producers see no active
    collector and do nothing), keeping one code shape for both modes.
    Nestable; exception-safe."""

    __slots__ = ("_col",)

    def __init__(self, enabled: bool = True):
        self._col = Collector(enabled)

    def __enter__(self) -> Collector:
        if self._col.enabled:
            _stack().append(self._col)
        return self._col

    def __exit__(self, *exc) -> None:
        if self._col.enabled:
            stack = _stack()
            if stack and stack[-1] is self._col:
                stack.pop()


def active() -> bool:
    """Is a collector active on this thread? Producers gate their health
    arithmetic on this."""
    return bool(getattr(_tls, "stack", None))


def record(key: str, value) -> None:
    """Record one local health scalar (a 0-d tensor, detached) into the
    innermost active collector (no-op without one)."""
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1].record(key, value)


def record_bn_skew(local_sum, local_sumsq, local_count, mean, var) -> None:
    """Producer for ``collectives.reduce_moments``: this replica's batch
    moments against the just-synced global ones, as max-over-channel
    relative deviations (mean skew in units of the global σ, var skew
    relative to the global var). Local arithmetic after the statistics'
    all-reduce, done for every layer at once when the collector summarizes
    (:meth:`Collector.record_moments`); no collective; no-op without an
    active collector."""
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1].record_moments(local_sum, local_sumsq, local_count, mean, var)


_ZEROS: dict = {}


def record_bn_skew_alone(device: torch.device) -> None:
    """The skew of a synced BN layer with no one to sync with (world 1): its
    moments ARE the global ones, so both skews are exactly 0, as the JAX
    package's mesh of one computes them. One cached zero a device, so the
    record launches nothing."""
    if not active():
        return
    zero = _ZEROS.get(device)
    if zero is None:
        zero = _ZEROS[device] = torch.zeros((), dtype=torch.float32, device=device)
    record("bn_mean_skew", zero)
    record("bn_var_skew", zero)


def merge_max(*summaries: Mapping) -> dict:
    """Union of monitor summaries with elementwise ``max`` on shared keys —
    how the GAN step folds its D- and G-substep collections."""
    out: dict = {}
    for summary in summaries:
        for key, value in summary.items():
            out[key] = value if key not in out else torch.maximum(out[key], value)
    return out


def grad_norm_scalar(grads) -> torch.Tensor:
    """Global L2 norm of a list of tensors with f32 accumulation — the
    per-replica (pre-reduction) half of the grad-norm dispersion monitor.
    ``torch._foreach_norm`` a tensor, then the norm of the norms: three
    launches whatever the tensor count."""
    by: dict = {}
    for g in grads:
        if g.numel():
            by.setdefault(g.dtype, []).append(g)
    if not by:
        return torch.zeros((), dtype=torch.float32)
    norms: list = []
    with torch.no_grad():
        for dt, ts in by.items():
            # f32 takes the multi-tensor kernel; an output dtype would not
            norms += (torch._foreach_norm(ts, 2) if dt == torch.float32
                      else torch._foreach_norm(ts, 2, dtype=torch.float32))
        return torch.linalg.vector_norm(torch.stack(norms))


def residual_ratio(residual, grad_norm: torch.Tensor) -> torch.Tensor:
    """‖EF residual‖ / (‖local grads‖ + eps): how much compression error is
    being re-sent relative to the signal."""
    if isinstance(residual, torch.Tensor):
        residual = [residual]
    elif isinstance(residual, Mapping):
        residual = list(residual.values())
    return grad_norm_scalar(list(residual)) / (grad_norm + EPS)


def _f32_scalar(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    return t if t.dim() == 0 else t.reshape(())


def cross_replica_monitors(
    scalars: Mapping[str, torch.Tensor],
    group,
    *,
    disp_keys: Iterable[str] = (),
) -> dict:
    """Replicated monitors from per-replica local scalars with ONE
    all-reduce of their stacked vector (tallied as one ``psum``) — the
    whole wire cost of the numerics monitors.

    Every key yields its replica mean under its own name; keys in
    ``disp_keys`` also yield ``<key>_disp``, the cross-replica relative
    dispersion std/mean from the Σx and Σx² halves of the same vector (a
    max would be a second collective, so it is not offered)."""
    if not scalars:
        return {}
    from tpu_syncbn_torch.parallel import collectives

    world = collectives.world_size(group)
    keys = sorted(scalars)
    dset = set(disp_keys)
    didx = [i for i, k in enumerate(keys) if k in dset]
    with torch.no_grad():
        vals = [_f32_scalar(scalars[k]) for k in keys]
        fused = torch.stack(vals + [vals[i] * vals[i] for i in didx])
        summed = collectives.psum(fused, group) / world
        out: dict = {k: summed[i] for i, k in enumerate(keys)}
        for j, i in enumerate(didx):
            mean = summed[i]
            var = torch.clamp_min(summed[len(keys) + j] - mean * mean, 0.0)
            out[f"{keys[i]}_disp"] = torch.sqrt(var) / (mean.abs() + EPS)
    return out


# ---------------------------------------------------------------------------
# host side: publisher


#: Dtypes a step's scalar outputs come in (losses, monitors, counts).
SCALAR_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                 torch.int32, torch.int64)


def warm_scalar_stack(to_dtype: torch.dtype, max_n: int) -> None:
    """Launch once, on the current CUDA device, each kernel a host copy of
    step scalars runs — the stack of 1 to ``max_n`` 0-d tensors of each of
    :data:`SCALAR_DTYPES`, their cast to ``to_dtype`` and the concatenation
    of two casts. CUDA loads a kernel at its first launch, and the load
    waits for every piece of work already queued on the device (lazy
    module loading), so a publisher's or recorder's first call behind a
    running step would wait for it; taken here, when the publisher or
    recorder is built, outside a step. Nothing is read back."""
    with torch.no_grad():
        for dtype in SCALAR_DTYPES:
            vals = torch.zeros(max_n, dtype=dtype, device="cuda").unbind(0)
            for n in range(1, max_n + 1):
                torch.stack(vals[:n]).to(to_dtype)
        part = torch.zeros(2, dtype=to_dtype, device="cuda")
        torch.cat([part, part])


class NumericsPublisher:
    """Publish each step's numerics monitors into the telemetry registry
    without forcing a synchronize on the step loop.

    ``publish(step, monitors)`` takes the step's :data:`PUBLISHED_MONITORS`
    subset, stacks it on the device and copies it ``non_blocking`` into a
    free row of the page-locked block taken at construction (one row a
    queued entry, ``max_pending`` rows; a row comes back when its entry is
    drained or dropped, and copies run on the current stream, so a reused
    row's earlier copy lands first), recording a CUDA event behind the
    copy (a CPU tensor is ready at once). The constructor also launches
    each kernel of that path once (:func:`warm_scalar_stack`): a kernel's
    first launch waits for all queued device work. Where CUDA is not
    available no block is taken (no monitor can be on the card). Then it drains the queued entries whose
    events have completed (``event.query()``, which never waits): they land
    as ``numerics.<key>`` histogram samples plus the ``numerics.samples`` /
    ``numerics.clip_saturated`` counters. ``flush()`` synchronizes on the
    remaining events and drains everything (end of a run only).

    Each published value is checked against ``thresholds``
    (:data:`DEFAULT_DRIFT_THRESHOLDS`; ``{}`` disables): a crossing, or a
    non-finite monitor (drift by definition), bumps
    ``numerics.drift_trips`` and fires the ``numerics_drift``
    flight-recorder trigger (one bundle when a recorder is installed and
    its cooldown allows). A queue past ``max_pending`` drops its oldest
    entry and counts ``numerics.dropped``."""

    def __init__(
        self,
        *,
        thresholds: Mapping[str, float] | None = None,
        clip_saturated_frac: float = CLIP_SATURATED_FRAC,
        max_pending: int = 64,
    ):
        self.thresholds = (dict(DEFAULT_DRIFT_THRESHOLDS)
                           if thresholds is None else dict(thresholds))
        self.clip_saturated_frac = float(clip_saturated_frac)
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._pending: deque = deque()
        self._max_pending = int(max_pending)
        #: newest published values, for tests and inspection
        self.last: dict[str, float] = {}
        self.published = 0
        self._host: torch.Tensor | None = None
        self._free: list[int] = []
        self._row_of: dict[int, int] = {}  # id(event) -> its entry's row
        if torch.cuda.is_available():
            self._take_host_block()

    def _take_host_block(self) -> None:
        """One page-locked row of every published key for each entry the
        queue may hold, and one launch of each kernel the device path runs
        (:func:`warm_scalar_stack`)."""
        self._host = torch.empty((self._max_pending, len(PUBLISHED_MONITORS)),
                                 dtype=torch.float32, pin_memory=True)
        self._free = list(range(self._max_pending - 1, -1, -1))
        warm_scalar_stack(torch.float32, len(PUBLISHED_MONITORS))

    def publish(self, step: int, monitors) -> int:
        """Queue one step's monitors; drain every queued entry that is
        ready. Returns the number of entries published by this call. No-op
        (and no queue growth) while telemetry is disabled or the monitors
        carry no published key."""
        if not telemetry.enabled():
            return 0
        if isinstance(monitors, dict):
            keys = sorted(k for k in monitors if k in PUBLISHED_MONITORS)
            if keys:
                while len(self._pending) >= self._max_pending:
                    # a wedged device must bound the queue, not grow it
                    self._release(self._pending.popleft())
                    telemetry.count("numerics.dropped")
                self._pending.append((int(step), keys, *self._to_host(
                    [monitors[k] for k in keys])))
        return self._drain(block=False)

    def _to_host(self, values: list):
        """``(host values, event or None)``: device tensors stacked and
        copied into a page-locked row behind a recorded event; anything
        else as it is."""
        on_card = [isinstance(v, torch.Tensor) and v.is_cuda for v in values]
        if not all(on_card):
            return [v.detach() if isinstance(v, torch.Tensor) else v
                    for v in values], None
        with torch.no_grad():
            dev = torch.stack([v.detach().to(torch.float32).reshape(()) for v in values])
        row = self._free.pop()
        host = self._host[row, :len(values)]
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._row_of[id(event)] = row
        return list(host.unbind(0)), event

    def _release(self, entry) -> None:
        """Give a drained or dropped entry's row back."""
        row = self._row_of.pop(id(entry[-1]), None)
        if row is not None:
            self._free.append(row)

    def flush(self) -> int:
        """Drain everything still queued, synchronizing on each entry's
        event (end of a run only)."""
        return self._drain(block=True)

    def _drain(self, *, block: bool) -> int:
        published = 0
        while self._pending:
            step, keys, values, event = self._pending[0]
            if event is not None:
                if block:
                    event.synchronize()
                elif not event.query():
                    break
            entry = self._pending.popleft()
            try:
                self._emit(step, dict(zip(keys, values)))
            finally:
                self._release(entry)
            published += 1
        self.published += published
        return published

    def _emit(self, step: int, vals: dict) -> None:
        from tpu_syncbn_torch.obs import flightrec

        telemetry.count("numerics.samples")
        for key, raw in vals.items():
            try:
                value = float(raw)
            except (TypeError, ValueError):
                continue
            finite = value == value and abs(value) != float("inf")
            if finite:
                telemetry.observe(f"numerics.{key}", value)
                self.last[key] = value
            if key == "clip_fraction" and finite \
                    and value > self.clip_saturated_frac:
                telemetry.count("numerics.clip_saturated")
            threshold = self.thresholds.get(key)
            if (threshold is not None and finite and value > threshold) \
                    or not finite:
                telemetry.count("numerics.drift_trips")
                flightrec.trigger("numerics_drift", {
                    "monitor": key,
                    "value": value if finite else str(value),
                    "threshold": threshold,
                    "step": step,
                })


# ---------------------------------------------------------------------------
# SLO rules


def numerics_rules(
    *,
    residual_slo: str = "numerics.ef_residual_ratio p99 < 0.5",
    skew_slo: str = "numerics.bn_mean_skew p99 < 4.0",
    clip_target: float = 0.99,
    windows_s=(60.0, 300.0),
    burn_threshold: float = 2.0,
) -> list:
    """The numerics-health rule set, ready for
    ``SLOTracker(agg, numerics_rules()).attach()`` (``obs.slo``):

    * ``numerics_residual`` — the EF residual ratio quantile objective
      (error feedback re-sending more than half the gradient norm at
      p99 means quantization is drowning the signal);
    * ``numerics_skew`` — the BN batch-mean skew quantile objective
      (sustained multi-σ local-vs-synced deviation is replica drift,
      the exact failure SyncBN exists to prevent);
    * ``numerics_clip`` — clip-saturation budget: at most
      ``1 - clip_target`` of published steps may be clip-saturated
      (``SubsetRate`` — saturated steps are a subset of samples)."""
    from tpu_syncbn_torch.obs import slo

    return [
        slo.AlertRule("numerics_residual", residual_slo,
                      windows_s=windows_s, burn_threshold=burn_threshold),
        slo.AlertRule("numerics_skew", skew_slo,
                      windows_s=windows_s, burn_threshold=burn_threshold),
        slo.AlertRule("numerics_clip",
                      slo.SubsetRate(total="numerics.samples",
                                     bad="numerics.clip_saturated",
                                     target=clip_target),
                      windows_s=windows_s, burn_threshold=burn_threshold),
    ]
