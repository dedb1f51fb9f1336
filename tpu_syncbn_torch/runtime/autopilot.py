"""Closed-loop autopilot — the counterpart of
``tpu_syncbn.runtime.autopilot``: the observability plane turns its own
knobs.

The monitors (numerics drift, memory watermarks, recompile storms, the
windowed step-time attribution) are read-only; the :class:`Autopilot`
consumes the signals they publish and actuates, **only at fused-chunk
boundaries and only within fixed candidate sets**, the knobs the port
already exposes:

* **compression precision** — escalate int8 → bf16 → none when the
  ``numerics_rules()`` SLOs burn, de-escalate one rung at a time after a
  sustained-healthy hysteresis window
  (:meth:`~tpu_syncbn_torch.parallel.trainer.DataParallel.set_compress`:
  the residual keeps its buffer across every rung and is zeroed in place,
  and each rung's K-step programs are parked and recalled);
* **scan chunk length K** — raise it while the windowed attribution says
  host gap dominates and ``mem.headroom_frac`` allows; lower it when
  ``mem_pressure`` fires (the loop's per-chunk watchdog deadline follows
  the live K; :func:`chunked_batches` is the data side);
* **program-cache byte budgets** — halve under memory pressure down to a
  floor, double back toward a ceiling after the healthy window
  (:meth:`~tpu_syncbn_torch.parallel.scan_driver.ProgramCache.set_max_bytes`:
  on the card an evicted program's CUDA graph pool returns to the
  allocator);
* **pipeline microbatch count M** — raise M when the tick tables
  (``parallel.pipeline_schedule``) promise a materially smaller bubble
  *and* the measured ``pipeline.bubble_frac`` gauge confirms there is
  bubble to reclaim; lower it under memory pressure
  (:meth:`~tpu_syncbn_torch.parallel.pipeline.PipelineTrainer.set_microbatches`);
* **layout** — over rank-ordered ``(name, predicted_step_s)`` pairs,
  escalate to the next one when the measured mean step time exceeds the
  current one's prediction by more than ``plan_tolerance``x. Escalate-only;
  its actuation fires the ``plan_change`` incident trigger, every other
  knob's fires ``autopilot``. The planner that ranks such pairs from
  contracts is ROADMAP A.14c; the knob itself needs only the pairs.

**The pinned variants.** The JAX controller moves only between program
variants that its audit has golden-pinned (the ``autopilot.*`` program
contracts of ``python -m tpu_syncbn.audit``). So does this one: its three
compress rungs are the port's ``autopilot.compressed_{fp32,bf16,int8}.train_step``
contracts (``python -m tpu_syncbn_torch.audit``; one trainer built at int8
with error feedback, then ``set_compress``ed, as the controller runs it).
It also keeps its cache guarantee: after warm-up, moving between rungs or
K candidates that were already visited captures no new CUDA graph — the
trainer's ``ProgramCache.misses`` do not move and the recompile-storm
detector (``obs.profiling``) stays quiet.
One gap follows from ``set_compress`` as JAX has it: a rung first visited
after a cache shrink starts with a fresh cache whose budget is unset,
until the next cache actuation sets it.

Every decision — actuations, but also **clamped** attempts (the policy
wanted to leave the candidate set) and **suppressed** ones (divergence
recovery in flight) — lands in the flight recorder's ``autopilot`` ring
with the triggering signal and its windowed burns quoted, and as a trace
instant. Telemetry: the ``autopilot.actuations`` / ``autopilot.suppressed``
/ ``autopilot.clamped`` counters, the per-knob gauges
``autopilot.compress_rung`` / ``autopilot.scan_k`` /
``autopilot.cache_max_bytes`` (plus ``autopilot.microbatch_m`` /
``autopilot.plan_rank`` when those knobs are configured, all read by
``/statusz``'s autopilot section) and the ``autopilot.decision_s``
histogram (the policy's own cost a chunk boundary).

Clocks are injectable (``now=``) and the SLO tracker is evaluated at the
same timestamp, so the state machine is deterministic under test. The
module moves no tensor: on the card the trainer's actuators do the work.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Sequence

from tpu_syncbn_torch.obs import flightrec, slo, telemetry, tracing

#: The compression ladder, most- to least-compressed. ``escalate`` moves
#: right (toward the exact f32 wire), ``deescalate`` left. Build the
#: trainer at the leftmost rung you include so the error-feedback residual
#: exists on every rung (``DataParallel`` fixes it at construction).
COMPRESS_LADDER = ("int8", "bf16", "none")

#: Default SLO families the autopilot watches. Serving families exist
#: (:func:`tpu_syncbn_torch.obs.slo.standard_rules`) but no training knob
#: answers to them.
DEFAULT_RULE_FAMILIES = ("numerics", "mem", "compile")

_COMPRESS_KNOB = "compress"
_K_KNOB = "scan_k"
_CACHE_KNOB = "cache_bytes"
_M_KNOB = "microbatch_m"
_LAYOUT_KNOB = "layout"
_KNOBS = (_COMPRESS_KNOB, _K_KNOB, _CACHE_KNOB, _M_KNOB, _LAYOUT_KNOB)


def _dispatch_seconds(snap: dict) -> float:
    """Summed in-dispatch seconds in a windowed snapshot: the histogram
    families the incident attribution counts as device-bound step time."""
    from tpu_syncbn_torch.obs import incident

    hists = snap.get("histograms", {})
    return sum(hists[name]["sum"] for name in incident._DISPATCH_HISTS if name in hists)


def chunked_batches(batches, autopilot: "Autopilot"):
    """Adapt a per-STEP batch stream into K-stacked chunks whose K is the
    autopilot's live ``scan_k``, re-read at every chunk boundary: the data
    side of the K actuator (the trainer side needs nothing, since
    ``train_steps_batches`` keys its program cache by K). The tail chunk is
    emitted at whatever length remains."""
    from tpu_syncbn_torch.parallel import scan_driver

    it = iter(batches)
    while True:
        k = max(1, int(autopilot.scan_k))
        chunk = list(itertools.islice(it, k))
        if not chunk:
            return
        yield scan_driver.stack_batches(chunk)


class Autopilot:
    """The policy engine. One instance a training process; drive
    :meth:`on_chunk` at every fused-chunk boundary
    (``ResilientLoop(autopilot=...)`` does).

    ``trainer`` needs the
    :class:`~tpu_syncbn_torch.parallel.trainer.DataParallel` knob surface
    (``compress``, ``set_compress``, ``program_caches``); ``None`` runs the
    compression knob open-loop (decisions are still recorded: a shadow-mode
    dry run). ``aggregator`` is the
    :class:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator` the
    signals live in; ``rules`` defaults to
    ``slo.standard_rules(DEFAULT_RULE_FAMILIES)``.

    Knob bounds, the candidate sets:

    * ``modes`` — orderable subset of :data:`COMPRESS_LADDER` (ladder order
      enforced); a burn at the top rung is *clamped*, counted, never an
      error;
    * ``k_candidates`` — ascending scan-K set; empty disables the K knob.
      ``set_scan_k`` is the actuation callback;
    * ``cache_bytes_bounds`` — ``(floor, ceiling)`` for every cache in
      ``trainer.program_caches`` (plus ``extra_caches``); ``None`` disables
      the knob;
    * ``m_candidates`` — ascending microbatch-count set for the pipeline M
      actuator (needs ``pipe_schedule`` + ``pipe_stages`` so every
      candidate's bubble is derivable up front; ``set_microbatch`` is the
      actuation callback, normally ``PipelineTrainer.set_microbatches``);
      empty disables the knob;
    * ``plan_candidates`` — rank-ordered ``(name, predicted_step_s)`` pairs
      (or objects with ``candidate``, ``name`` and ``predicted_step_s``,
      as JAX's planner ranks them) for the layout knob; ``set_layout``
      receives the next plan's name on escalation; fewer than two
      candidates disables the knob.

    Policy timing: ``window_s`` is the evaluation window (signals are read
    over it; at most one decision a knob a window), ``healthy_for_s`` the
    de-escalation/regrow hysteresis (that long with no burn on the
    relevant family, measured from the later of the last burn and the
    knob's last actuation: a controller that just moved re-observes before
    moving back)."""

    def __init__(
        self,
        trainer=None,
        *,
        aggregator,
        rules: Sequence | None = None,
        modes: Sequence[str] | None = None,
        k_candidates: Sequence[int] = (),
        set_scan_k: Callable[[int], None] | None = None,
        initial_k: int | None = None,
        cache_bytes_bounds: tuple[int, int] | None = None,
        extra_caches: Sequence = (),
        m_candidates: Sequence[int] = (),
        set_microbatch: Callable[[int], None] | None = None,
        initial_m: int | None = None,
        pipe_schedule: str | None = None,
        pipe_stages: int | None = None,
        bubble_margin: float = 0.02,
        plan_candidates: Sequence = (),
        set_layout: Callable[[str], None] | None = None,
        plan_tolerance: float = 1.5,
        window_s: float = 60.0,
        healthy_for_s: float = 300.0,
        host_gap_threshold: float = 0.3,
        headroom_min: float = 0.25,
        now=time.monotonic,
    ):
        if modes is None:
            modes = COMPRESS_LADDER if trainer is None else tuple(
                m for m in COMPRESS_LADDER
                if COMPRESS_LADDER.index(m) >= COMPRESS_LADDER.index(trainer.compress))
        modes = tuple(modes)
        unknown = [m for m in modes if m not in COMPRESS_LADDER]
        if unknown:
            raise ValueError(f"modes {unknown} not in the audited ladder {COMPRESS_LADDER}")
        if list(modes) != sorted(modes, key=COMPRESS_LADDER.index):
            raise ValueError(f"modes must follow ladder order {COMPRESS_LADDER}, got {modes}")
        if not modes:
            raise ValueError("modes must name at least one rung")
        if trainer is not None and trainer.compress not in modes:
            raise ValueError(
                f"trainer is at {trainer.compress!r}, outside the candidate set {modes}")
        ks = tuple(int(k) for k in k_candidates)
        if list(ks) != sorted(set(ks)) or any(k < 1 for k in ks):
            raise ValueError(
                f"k_candidates must be ascending positive ints, got {k_candidates}")
        if cache_bytes_bounds is not None:
            floor, ceiling = cache_bytes_bounds
            if not 1 <= floor <= ceiling:
                raise ValueError(
                    f"cache_bytes_bounds needs 1 <= floor <= ceiling, got {cache_bytes_bounds}")
        ms = tuple(int(m) for m in m_candidates)
        if list(ms) != sorted(set(ms)) or any(m < 1 for m in ms):
            raise ValueError(
                f"m_candidates must be ascending positive ints, got {m_candidates}")
        if ms and (pipe_schedule is None or pipe_stages is None):
            raise ValueError(
                "the microbatch knob needs pipe_schedule and pipe_stages (the "
                "predicted-bubble side of the policy comes from the static tick tables)")
        if ms and pipe_stages is not None:
            from tpu_syncbn_torch.parallel import pipeline_schedule

            for m in ms:
                # every candidate's schedule derivable up front: no
                # first-actuation surprise
                pipeline_schedule.get_schedule(pipe_schedule, m, int(pipe_stages))
        plans = []
        for cand in plan_candidates:
            if hasattr(cand, "candidate"):  # a planner PlannedCandidate
                plans.append((cand.name, float(cand.predicted_step_s)))
            else:
                name, predicted = cand
                plans.append((str(name), float(predicted)))
        if plans and len({n for n, _ in plans}) != len(plans):
            raise ValueError(f"plan_candidates repeat a layout name: {[n for n, _ in plans]}")
        if plan_tolerance < 1.0:
            raise ValueError(
                f"plan_tolerance must be >= 1.0 (a plan is violated only when "
                f"measured exceeds predicted), got {plan_tolerance}")
        if window_s <= 0 or healthy_for_s <= 0:
            raise ValueError(
                f"window_s and healthy_for_s must be > 0, got {window_s}/{healthy_for_s}")
        self.trainer = trainer
        self.aggregator = aggregator
        self.tracker = slo.SLOTracker(
            aggregator,
            list(rules) if rules is not None else slo.standard_rules(DEFAULT_RULE_FAMILIES))
        self.modes = modes
        self.k_candidates = ks
        self._set_scan_k = set_scan_k
        self.cache_bytes_bounds = cache_bytes_bounds
        self.extra_caches = tuple(extra_caches)
        self.m_candidates = ms
        self._set_microbatch = set_microbatch
        self.pipe_schedule = pipe_schedule
        self.pipe_stages = int(pipe_stages) if pipe_stages is not None else None
        self.bubble_margin = float(bubble_margin)
        self.plan_candidates = tuple(plans)
        self._set_layout = set_layout
        self.plan_tolerance = float(plan_tolerance)
        self.plan_rank = 0
        self.window_s = float(window_s)
        self.healthy_for_s = float(healthy_for_s)
        self.host_gap_threshold = float(host_gap_threshold)
        self.headroom_min = float(headroom_min)
        self._now = now
        self.counters = telemetry.CounterGroup(prefix="autopilot")
        # knob state
        self.compress_rung = modes.index(trainer.compress) if trainer is not None else 0
        if initial_k is None:
            initial_k = ks[0] if ks else 1
        if ks and initial_k not in ks:
            raise ValueError(f"initial_k {initial_k} not in k_candidates {ks}")
        self.scan_k = int(initial_k)
        if initial_m is None:
            initial_m = ms[0] if ms else None
        if ms and initial_m not in ms:
            raise ValueError(f"initial_m {initial_m} not in m_candidates {ms}")
        self.microbatch_m = int(initial_m) if initial_m is not None else None
        # per-knob last-actuation clocks (None = never): the hysteresis
        # anchors; only real knob turns move them
        self._last_actuation: dict[str, float | None] = {knob: None for knob in _KNOBS}
        # per-knob last-decision clocks: the cooldown; clamps count too, so a
        # sustained burn at a bound writes one ring entry a window
        self._last_decision_t: dict[str, float | None] = {knob: None for knob in _KNOBS}
        # last time the knob's driving family burned (None = never seen
        # burning: de-escalation then keys off the first chunk's clock)
        self._last_numerics_burn: float | None = None
        self._last_mem_burn: float | None = None
        self._first_chunk_t: float | None = None
        self.last_decision: dict | None = None
        self.chunks = 0
        self._export_gauges()

    # -- helpers -----------------------------------------------------------

    def _caches(self) -> tuple:
        trainer_caches = (
            tuple(self.trainer.program_caches)
            if self.trainer is not None and hasattr(self.trainer, "program_caches") else ())
        return trainer_caches + self.extra_caches

    def _cache_budget(self) -> int | None:
        """Current per-cache budget: the max over live budgets (they move in
        lockstep), or the ceiling when none is set yet."""
        if self.cache_bytes_bounds is None:
            return None
        budgets = [c.max_bytes for c in self._caches() if c.max_bytes is not None]
        return max(budgets) if budgets else self.cache_bytes_bounds[1]

    def _healthy_since(self, knob: str, last_burn: float | None, now: float) -> bool:
        """Sustained-healthy hysteresis: ``healthy_for_s`` elapsed since the
        later of (last burn on the driving family, this knob's last
        actuation, the first observed chunk)."""
        anchors = [t for t in (last_burn, self._last_actuation[knob], self._first_chunk_t)
                   if t is not None]
        if not anchors:
            return False
        return now - max(anchors) >= self.healthy_for_s

    def _in_cooldown(self, knob: str, now: float) -> bool:
        last = self._last_decision_t[knob]
        return last is not None and now - last < self.window_s

    def _record(self, decision: dict, now: float) -> dict:
        """Every decision — actuation, clamp or suppression — lands in the
        ring and the trace; actuations also fire the incident trigger (the
        recorder's cooldown bounds bundle frequency, the ring drops
        nothing). Returns the enriched decision (``t_mono``, ``chunk``)."""
        decision = dict(decision, t_mono=round(now, 6), chunk=self.chunks)
        self.last_decision = decision
        flightrec.record_autopilot(**decision)
        tracing.instant("autopilot", **{k: v for k, v in decision.items()
                                        if isinstance(v, (str, int, float, bool))})
        action = decision["action"]
        knob = decision["knob"]
        if action == "clamp":
            self.counters.bump("clamped")
            self._last_decision_t[knob] = now
        elif action == "suppress":
            self.counters.bump("suppressed")
        else:
            self.counters.bump("actuations")
            self._last_actuation[knob] = now
            self._last_decision_t[knob] = now
            # a layout swap is a topology event: its own incident kind, so
            # post-mortems tell plan moves from routine knob turns
            kind = "plan_change" if knob == _LAYOUT_KNOB else "autopilot"
            flightrec.trigger(kind, decision)
        return decision

    def _export_gauges(self) -> None:
        telemetry.set_gauge("autopilot.compress_rung", self.compress_rung)
        telemetry.set_gauge("autopilot.scan_k", self.scan_k)
        budget = self._cache_budget()
        if budget is not None:
            telemetry.set_gauge("autopilot.cache_max_bytes", budget)
        if self.microbatch_m is not None:
            telemetry.set_gauge("autopilot.microbatch_m", self.microbatch_m)
        if self.plan_candidates:
            telemetry.set_gauge("autopilot.plan_rank", self.plan_rank)

    @staticmethod
    def _quote(state: dict, rule: str) -> dict:
        """The triggering signal's evidence, quoted into the decision: the
        rule's burn rate a window."""
        burns = state.get(rule, {}).get("burns", {})
        return {str(w): (round(b, 4) if b is not None else None) for w, b in burns.items()}

    # -- the policy step ---------------------------------------------------

    def on_chunk(self, *, step: int | None = None, k: int | None = None,
                 recovering: bool = False) -> list[dict]:
        """One policy evaluation at a fused-chunk boundary; returns the
        decisions made (possibly none). ``recovering=True`` (a divergence
        rollback is being re-validated) records one suppression and
        actuates nothing: the guard owns the process until a finite step
        lands on the restored state."""
        t0 = time.perf_counter()
        now = self._now()
        self.chunks += 1
        if self._first_chunk_t is None:
            self._first_chunk_t = now
        decisions: list[dict] = []
        if recovering:
            d = self._record({"knob": "all", "action": "suppress",
                              "signal": "divergence_recovery", "step": step}, now)
            decisions.append(d)
            telemetry.observe("autopilot.decision_s", time.perf_counter() - t0)
            return decisions
        state = self.tracker.evaluate(now=now)
        snap = self.aggregator.windowed_snapshot(self.window_s, now=now)
        numerics_firing = [r for r in state
                           if r.startswith("numerics") and state[r]["firing"]]
        mem_firing = state.get("mem_pressure", {}).get("firing", False)
        if numerics_firing:
            self._last_numerics_burn = now
        if mem_firing:
            self._last_mem_burn = now
        decisions += self._compress_policy(state, numerics_firing, now, step)
        decisions += self._k_policy(state, snap, mem_firing, now, step)
        decisions += self._cache_policy(state, mem_firing, now, step)
        decisions += self._m_policy(state, snap, mem_firing, now, step)
        decisions += self._layout_policy(snap, now, step)
        self._export_gauges()
        telemetry.observe("autopilot.decision_s", time.perf_counter() - t0)
        return decisions

    # -- knob policies -----------------------------------------------------

    def _compress_policy(self, state, numerics_firing, now, step):
        if len(self.modes) < 2:
            return []
        if self._in_cooldown(_COMPRESS_KNOB, now):
            return []
        base = {"knob": _COMPRESS_KNOB, "step": step, "window_s": self.window_s}
        if numerics_firing:
            signal = numerics_firing[0]
            base.update(signal=signal, burns=self._quote(state, signal))
            if self.compress_rung + 1 < len(self.modes):
                frm = self.modes[self.compress_rung]
                self.compress_rung += 1
                to = self.modes[self.compress_rung]
                if self.trainer is not None:
                    self.trainer.set_compress(to)
                d = dict(base, action="escalate", frm=frm, to=to)
            else:
                # burning at the least-compressed rung: nowhere to go
                d = dict(base, action="clamp", frm=self.modes[self.compress_rung])
            return [self._record(d, now)]
        if (self.compress_rung > 0
                and self._healthy_since(_COMPRESS_KNOB, self._last_numerics_burn, now)):
            frm = self.modes[self.compress_rung]
            self.compress_rung -= 1
            to = self.modes[self.compress_rung]
            if self.trainer is not None:
                self.trainer.set_compress(to)
            d = dict(base, action="deescalate", frm=frm, to=to, signal="numerics_healthy",
                     healthy_for_s=self.healthy_for_s)
            return [self._record(d, now)]
        return []

    def _k_policy(self, state, snap, mem_firing, now, step):
        if not self.k_candidates or len(self.k_candidates) < 2:
            return []
        if self._in_cooldown(_K_KNOB, now):
            return []
        base = {"knob": _K_KNOB, "step": step, "window_s": self.window_s}
        idx = self.k_candidates.index(self.scan_k)
        if mem_firing:
            base.update(signal="mem_pressure", burns=self._quote(state, "mem_pressure"))
            if idx > 0:
                frm, self.scan_k = self.scan_k, self.k_candidates[idx - 1]
                if self._set_scan_k is not None:
                    self._set_scan_k(self.scan_k)
                d = dict(base, action="lower", frm=frm, to=self.scan_k)
            else:
                d = dict(base, action="clamp", frm=self.scan_k)
            return [self._record(d, now)]
        covered = snap.get("window", {}).get("covered_s", 0.0)
        if covered <= 0:
            return []
        host_gap = max(0.0, 1.0 - _dispatch_seconds(snap) / covered)
        headroom = snap.get("gauges", {}).get("mem.headroom_frac")
        if (host_gap > self.host_gap_threshold
                and headroom is not None
                and headroom > self.headroom_min
                and self._healthy_since(_K_KNOB, self._last_mem_burn, now)):
            base.update(signal="host_gap", host_gap_frac=round(host_gap, 4),
                        headroom_frac=round(headroom, 4))
            if idx + 1 < len(self.k_candidates):
                frm, self.scan_k = self.scan_k, self.k_candidates[idx + 1]
                if self._set_scan_k is not None:
                    self._set_scan_k(self.scan_k)
                d = dict(base, action="raise", frm=frm, to=self.scan_k)
            else:
                d = dict(base, action="clamp", frm=self.scan_k)
            return [self._record(d, now)]
        return []

    def _cache_policy(self, state, mem_firing, now, step):
        if self.cache_bytes_bounds is None or not self._caches():
            return []
        if self._in_cooldown(_CACHE_KNOB, now):
            return []
        floor, ceiling = self.cache_bytes_bounds
        budget = self._cache_budget()
        base = {"knob": _CACHE_KNOB, "step": step, "window_s": self.window_s}
        if mem_firing:
            base.update(signal="mem_pressure", burns=self._quote(state, "mem_pressure"))
            if budget > floor:
                new = max(floor, budget // 2)
                for c in self._caches():
                    c.set_max_bytes(new)
                d = dict(base, action="shrink", frm=budget, to=new)
            else:
                d = dict(base, action="clamp", frm=budget)
            return [self._record(d, now)]
        if budget < ceiling and self._healthy_since(_CACHE_KNOB, self._last_mem_burn, now):
            new = min(ceiling, budget * 2)
            for c in self._caches():
                c.set_max_bytes(new)
            d = dict(base, action="grow", frm=budget, to=new, signal="mem_healthy",
                     healthy_for_s=self.healthy_for_s)
            return [self._record(d, now)]
        return []

    def _predicted_bubble(self, m: int) -> float:
        from tpu_syncbn_torch.parallel import pipeline_schedule

        return pipeline_schedule.get_schedule(
            self.pipe_schedule, m, self.pipe_stages).predicted_bubble_frac

    def _m_policy(self, state, snap, mem_firing, now, step):
        """Drive M toward the schedule's predicted bubble optimum: raise it
        when the NEXT candidate's tick table predicts at least
        ``bubble_margin`` less bubble and the measured
        ``pipeline.bubble_frac`` confirms that much to reclaim; lower it
        when ``mem_pressure`` fires (GPipe's in-flight activation stash
        grows with M). The measured-against-predicted gap is quoted into
        the decision."""
        if not self.m_candidates or len(self.m_candidates) < 2:
            return []
        if self._in_cooldown(_M_KNOB, now):
            return []
        base = {"knob": _M_KNOB, "step": step, "window_s": self.window_s}
        idx = self.m_candidates.index(self.microbatch_m)
        if mem_firing:
            base.update(signal="mem_pressure", burns=self._quote(state, "mem_pressure"))
            if idx > 0:
                frm = self.microbatch_m
                self.microbatch_m = self.m_candidates[idx - 1]
                if self._set_microbatch is not None:
                    self._set_microbatch(self.microbatch_m)
                d = dict(base, action="lower", frm=frm, to=self.microbatch_m)
            else:
                d = dict(base, action="clamp", frm=self.microbatch_m)
            return [self._record(d, now)]
        measured = snap.get("gauges", {}).get("pipeline.bubble_frac")
        if measured is None:
            return []
        if not self._healthy_since(_M_KNOB, self._last_mem_burn, now):
            return []
        cur = self._predicted_bubble(self.microbatch_m)
        if idx + 1 < len(self.m_candidates):
            nxt_m = self.m_candidates[idx + 1]
            nxt = self._predicted_bubble(nxt_m)
            # the tick table promises a material win, and the measurement
            # confirms that much to reclaim (a noisy low reading must not
            # drive M up)
            if cur - nxt >= self.bubble_margin and measured >= nxt + self.bubble_margin:
                frm = self.microbatch_m
                self.microbatch_m = nxt_m
                if self._set_microbatch is not None:
                    self._set_microbatch(nxt_m)
                d = dict(base, action="raise", frm=frm, to=nxt_m, signal="bubble_gap",
                         bubble_measured=round(measured, 4), bubble_predicted=round(cur, 4),
                         bubble_predicted_next=round(nxt, 4))
                return [self._record(d, now)]
            return []
        # top of the candidate set but still paying a bubble the margin
        # says matters: clamp, visibly
        if measured >= cur + self.bubble_margin:
            d = dict(base, action="clamp", frm=self.microbatch_m, signal="bubble_gap",
                     bubble_measured=round(measured, 4), bubble_predicted=round(cur, 4))
            return [self._record(d, now)]
        return []

    def _layout_policy(self, snap, now, step):
        """Hold the rank-ordered plans, compare the windowed mean step time
        with the current plan's prediction, escalate one rank when it is
        exceeded by more than ``plan_tolerance``x. Escalate-only (ranking is
        offline work; the controller never walks back), and the actuation
        fires the ``plan_change`` incident trigger."""
        if len(self.plan_candidates) < 2:
            return []
        if self._in_cooldown(_LAYOUT_KNOB, now):
            return []
        hists = snap.get("histograms", {})
        from tpu_syncbn_torch.obs import incident

        count = sum(hists[name]["count"] for name in incident._DISPATCH_HISTS
                    if name in hists)
        if count <= 0:
            return []
        measured = _dispatch_seconds(snap) / count
        name, predicted = self.plan_candidates[self.plan_rank]
        if measured <= predicted * self.plan_tolerance:
            return []
        base = {"knob": _LAYOUT_KNOB, "step": step, "window_s": self.window_s,
                "signal": "plan_violation", "measured_step_s": round(measured, 6),
                "predicted_step_s": round(predicted, 6),
                "plan_tolerance": self.plan_tolerance}
        if self.plan_rank + 1 < len(self.plan_candidates):
            self.plan_rank += 1
            to_name = self.plan_candidates[self.plan_rank][0]
            if self._set_layout is not None:
                self._set_layout(to_name)
            d = dict(base, action="escalate", frm=name, to=to_name, plan_rank=self.plan_rank)
        else:
            d = dict(base, action="clamp", frm=name)
        return [self._record(d, now)]

    # -- introspection -----------------------------------------------------

    def state(self) -> dict:
        """JSON-ready controller state (what a test or a report reads)."""
        return {
            "compress": self.modes[self.compress_rung],
            "compress_rung": self.compress_rung,
            "modes": list(self.modes),
            "scan_k": self.scan_k,
            "k_candidates": list(self.k_candidates),
            "cache_max_bytes": self._cache_budget(),
            "microbatch_m": self.microbatch_m,
            "m_candidates": list(self.m_candidates),
            "plan": self.plan_candidates[self.plan_rank][0] if self.plan_candidates else None,
            "plan_rank": self.plan_rank,
            "plan_candidates": [n for n, _ in self.plan_candidates],
            "chunks": self.chunks,
            "actuations": self.counters.count("actuations"),
            "clamped": self.counters.count("clamped"),
            "suppressed": self.counters.count("suppressed"),
            "last_decision": self.last_decision,
        }
