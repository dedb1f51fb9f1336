"""Declarative SLOs: objectives, multi-window burn rates, alert rules —
the counterpart of ``tpu_syncbn.obs.slo`` (the JAX package's ``__init__``
imports JAX, so the port keeps its own copy; the objectives, rule names,
metric names and state machine are the JAX module's).

An SLO turns a rolling metric (:mod:`tpu_syncbn_torch.obs.timeseries`)
into an operable yes/no: *is this process meeting its service objective
right now, and how fast is it spending its error budget?* Two objective
shapes cover the stack:

* **latency quantile** — ``"serve.latency_s p99 < 0.25"``
  (:func:`parse_objective`): the error budget is the quantile's
  complement (p99 → 1% of observations may exceed the threshold), and the
  observed error rate is the windowed fraction of observations above it
  (:meth:`~tpu_syncbn_torch.obs.timeseries.WindowedAggregator.fraction_above`);
* **availability** — :class:`Availability`: error rate =
  bad / (good + bad) from two counters (e.g. ``serve.rejected`` over
  ``serve.requests``), budget = ``1 - target``; :class:`SubsetRate` is
  the form whose bad counter counts a subset of the total.

Either way, **burn rate** = observed error rate / budgeted error rate:
1.0 spends the budget exactly on schedule, 10x empties a 30-day budget
in 3 days. :class:`AlertRule` evaluates the burn over *multiple* windows
(the standard fast+slow pair) and fires only when every window agrees —
the short window gives fast detection, the long one keeps a transient
spike from paging. Hysteresis on the way down: a firing rule resolves
only after ``clear_for`` consecutive evaluations below
``clear_threshold``, so an alert flapping around the boundary does not
flap the readiness signal it feeds.

:class:`SLOTracker` owns the rules: each :meth:`~SLOTracker.evaluate`
bumps ``slo.evaluations``, publishes per-rule ``slo.<rule>.burn_rate``
gauges, counts ``obs.alert.fired`` / ``obs.alert.resolved`` transitions
with trace instant markers, fires the flight recorder's ``slo_alert``
trigger on a transition to firing, and (once :meth:`~SLOTracker.attach`-ed)
feeds ``/readyz`` — a firing alert flips the process not-ready. The rule
sets: :func:`serve_overload_rules` and :func:`publication_rules` here (the
first reads the serving batcher's ``serve.*`` series, the second the swap
counters of weight publication, ``serve.publish``), and
``numerics_rules``, ``mem_rules`` and ``compile_rules`` beside their
producers; :func:`standard_rules` gathers them.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Sequence

from tpu_syncbn_torch.obs import telemetry, tracing

_OBJECTIVE_RE = re.compile(
    r"^\s*(?P<metric>[a-z0-9_]+(?:\.[a-z0-9_]+)+(?:\{[^{}]*\})?)\s+"
    r"p(?P<q>\d{1,2}(?:\.\d+)?)\s*<\s*"
    r"(?P<threshold>[0-9.eE+-]+)\s*$"
)


def objective_labels(
    objective: "LatencyObjective | Availability | SubsetRate",
) -> dict[str, str] | None:
    """The label selector an objective binds, pooled across every metric
    name it reads (``serve.latency_s{tenant="a"} p99 < 0.25`` binds
    ``{"tenant": "a"}``). ``None`` for unlabeled objectives. The burn
    gauge publishes a labeled twin under these labels, so per-tenant
    rules surface per-tenant burn series."""
    if isinstance(objective, LatencyObjective):
        names = (objective.metric,)
    elif isinstance(objective, Availability):
        names = (objective.good, objective.bad)
    else:
        names = (objective.total, objective.bad)
    labels: dict[str, str] = {}
    for n in names:
        _, sel = telemetry.parse_selector(n)
        if sel:
            labels.update(sel)
    return labels or None


@dataclasses.dataclass(frozen=True)
class LatencyObjective:
    """``metric``'s ``quantile`` must stay below ``threshold`` (seconds
    or whatever unit the histogram records). Error budget: ``1 - q``."""

    metric: str
    quantile: float  # e.g. 0.99
    threshold: float

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(
                f"quantile must be in (0, 1), got {self.quantile}"
            )
        if self.threshold <= 0:
            raise ValueError(
                f"threshold must be > 0, got {self.threshold}"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.quantile

    def error_rate(self, agg, window_s: float, now=None) -> float | None:
        return agg.fraction_above(
            self.metric, self.threshold, window_s, now=now
        )

    def describe(self) -> str:
        return f"{self.metric} p{self.quantile * 100:g} < {self.threshold:g}"


@dataclasses.dataclass(frozen=True)
class Availability:
    """Error rate = ``bad / (good + bad)`` from two counters; the
    objective is ``1 - error_rate >= target`` (budget ``1 - target``)."""

    good: str
    bad: str
    target: float  # e.g. 0.999

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def error_rate(self, agg, window_s: float, now=None) -> float | None:
        good = agg.rate(self.good, window_s, now=now)
        bad = agg.rate(self.bad, window_s, now=now)
        if good is None and bad is None:
            return None
        total = (good or 0.0) + (bad or 0.0)
        if total <= 0:
            return None  # no traffic: no evidence either way
        return (bad or 0.0) / total

    def describe(self) -> str:
        return (f"availability {self.good} vs {self.bad} "
                f">= {self.target:g}")


@dataclasses.dataclass(frozen=True)
class SubsetRate:
    """Error rate = ``bad / total`` where ``bad`` counts a *subset* of
    the events ``total`` counts (e.g. ``serve.deadline_miss_total`` out
    of ``serve.requests`` — every miss was an admitted request).
    :class:`Availability` is the disjoint-counters form
    (``bad / (good + bad)``); feeding it a subset counter understates
    the error rate (at a real 100% miss rate it reports 50%), which
    halves the burn the alert acts on — hence this objective."""

    total: str
    bad: str
    target: float  # e.g. 0.999 -> at most 0.1% of total may be bad

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def error_rate(self, agg, window_s: float, now=None) -> float | None:
        total = agg.rate(self.total, window_s, now=now)
        bad = agg.rate(self.bad, window_s, now=now)
        if total is None and bad is None:
            return None
        if not total:
            return None  # no traffic: no evidence either way
        return min(1.0, (bad or 0.0) / total)

    def describe(self) -> str:
        return f"{self.bad} / {self.total} <= {1.0 - self.target:g}"


def parse_objective(spec: str) -> LatencyObjective:
    """Parse the declarative latency form: ``"<metric> pQQ < X"``
    (``"serve.latency_s p99 < 0.25"``). Availability objectives are
    built directly (:class:`Availability` — they name two metrics, which
    a one-line string would only obscure)."""
    m = _OBJECTIVE_RE.match(spec)
    if not m:
        raise ValueError(
            f"unparseable SLO objective {spec!r}; expected "
            "'<dotted.metric> p<QQ> < <threshold>' "
            "(e.g. 'serve.latency_s p99 < 0.25', or with a label "
            "selector: 'serve.latency_s{tenant=\"a\"} p99 < 0.25')"
        )
    metric = m.group("metric")
    family, sel = telemetry.parse_selector(metric)
    if "{" in metric and sel is not None and not sel:
        raise ValueError(
            f"unparseable SLO objective {spec!r}: empty or malformed "
            f"label selector on {metric!r}"
        )
    q = float(m.group("q")) / 100.0
    return LatencyObjective(
        metric=metric, quantile=q,
        threshold=float(m.group("threshold")),
    )


def serve_overload_rules(
    *,
    latency_slo: str = "serve.latency_s p99 < 0.25",
    miss_target: float = 0.999,
    windows_s: Sequence[float] = (60.0, 300.0),
    burn_threshold: float = 2.0,
) -> list["AlertRule"]:
    """The serving stack's standard overload rule pair:

    * ``serve_latency`` — the client-visible latency quantile objective
      (``latency_slo``, declarative form);
    * ``serve_overload`` — deadline misses (sheds + late answers,
      ``serve.deadline_miss_total``) as a fraction of admitted requests
      (``serve.requests``; :class:`SubsetRate` — misses are a subset of
      requests, so the disjoint-counters :class:`Availability` form
      would understate the rate): burning more than
      ``burn_threshold``x a ``miss_target`` budget in every window
      means graceful degradation stopped being graceful.

    Attach to a tracker over the process aggregator::

        SLOTracker(agg, serve_overload_rules()).attach()
    """
    return [
        AlertRule("serve_latency", latency_slo,
                  windows_s=windows_s, burn_threshold=burn_threshold),
        AlertRule("serve_overload",
                  SubsetRate(total="serve.requests",
                             bad="serve.deadline_miss_total",
                             target=miss_target),
                  windows_s=windows_s, burn_threshold=burn_threshold),
    ]


def publication_rules(
    *,
    rollback_target: float = 0.99,
    windows_s: Sequence[float] = (3600.0, 21600.0),
    burn_threshold: float = 1.0,
) -> list["AlertRule"]:
    """The weight-publication health rule: rollbacks
    (``serve.rollbacks_total``) as a fraction of attempted swaps
    (``serve.swaps_total + serve.rollbacks_total`` is approximated by
    the swap counter as the total since both tally per attempt;
    :class:`SubsetRate` with ``serve.swaps_total`` as the denominator
    keeps the rate conservative — a rollback storm with few successful
    swaps saturates at 1.0). Swaps are rare events, so the windows are
    hours, not minutes, and a single burn fires: one bad publication
    per window is already worth a page."""
    return [
        AlertRule("publication_rollbacks",
                  SubsetRate(total="serve.swaps_total",
                             bad="serve.rollbacks_total",
                             target=rollback_target),
                  windows_s=windows_s, burn_threshold=burn_threshold),
    ]


#: rule families :func:`standard_rules` knows how to build, in the
#: order they are emitted. Training-side families first, serving-side
#: last — callers slice by name, not position.
STANDARD_RULE_FAMILIES = (
    "numerics", "mem", "compile", "serve", "publication",
)


def standard_rules(
    families: Sequence[str] = STANDARD_RULE_FAMILIES,
    **overrides,
) -> list["AlertRule"]:
    """One-call aggregation of the rule factories scattered across the
    observability plane, so ResilientLoop and the autopilot attach the
    full SLO set with ``SLOTracker(agg, standard_rules()).attach()``
    instead of five imports:

    * ``"numerics"`` — :func:`tpu_syncbn_torch.obs.numerics.numerics_rules`
      (EF residual ratio, BN mean skew, clip saturation);
    * ``"mem"`` — :func:`tpu_syncbn_torch.obs.memwatch.mem_rules`
      (live-bytes-over-contract pressure);
    * ``"compile"`` — :func:`tpu_syncbn_torch.obs.profiling.compile_rules`
      (recompile-storm budget);
    * ``"serve"`` — :func:`serve_overload_rules` (latency + overload);
    * ``"publication"`` — :func:`publication_rules` (rollback budget).

    ``overrides`` are per-family kwarg dicts forwarded to the matching
    factory (``standard_rules(("numerics",), numerics={"clip_target":
    0.9})``) — shared knobs like ``windows_s`` stay with the factory
    that owns them. Unknown families and overrides for families not
    requested raise, so a typo cannot silently drop a rule set."""
    known = set(STANDARD_RULE_FAMILIES)
    requested = list(families)
    unknown = [f for f in requested if f not in known]
    if unknown:
        raise ValueError(
            f"unknown rule families {unknown}; expected a subset of "
            f"{STANDARD_RULE_FAMILIES}"
        )
    stray = [k for k in overrides if k not in requested]
    if stray:
        raise ValueError(
            f"overrides for families not requested: {stray} "
            f"(families={requested})"
        )
    # training-side factories live with their signal producers; import
    # lazily at call time (they import slo the same way)
    from tpu_syncbn_torch.obs import memwatch, numerics, profiling

    factories = {
        "numerics": numerics.numerics_rules,
        "mem": memwatch.mem_rules,
        "compile": profiling.compile_rules,
        "serve": serve_overload_rules,
        "publication": publication_rules,
    }
    rules: list[AlertRule] = []
    for fam in requested:
        rules.extend(factories[fam](**overrides.get(fam, {})))
    return rules


# module registry of attached trackers: /statusz and incident bundles
# read every attached tracker's alert state through tracker_states()
_attached_lock = threading.Lock()
_attached: dict[str, "SLOTracker"] = {}


def tracker_states() -> dict[str, dict]:
    """Alert state of every attached tracker, keyed by its readiness-
    hook name — what ``/statusz`` renders and incident bundles embed."""
    with _attached_lock:
        items = list(_attached.items())
    return {name: tracker.state() for name, tracker in items}


@dataclasses.dataclass
class AlertRule:
    """Fire when the error-budget burn rate exceeds ``burn_threshold``
    in EVERY window of ``windows_s`` (multi-window burn-rate alerting);
    resolve after ``clear_for`` consecutive evaluations with every
    window's burn below ``clear_threshold`` (hysteresis — default half
    the firing threshold). ``objective`` is a :class:`LatencyObjective`,
    an :class:`Availability`, a :class:`SubsetRate`, or the declarative
    string form."""

    name: str
    objective: LatencyObjective | Availability | SubsetRate | str
    windows_s: Sequence[float] = (60.0, 300.0)
    burn_threshold: float = 2.0
    clear_threshold: float | None = None
    clear_for: int = 2

    def __post_init__(self):
        if isinstance(self.objective, str):
            self.objective = parse_objective(self.objective)
        if not re.match(r"^[a-z0-9_]+$", self.name):
            raise ValueError(
                f"rule name {self.name!r} must be a single schema token "
                "(it becomes the slo.<name>.burn_rate gauge)"
            )
        self.windows_s = tuple(float(w) for w in self.windows_s)
        if not self.windows_s or any(w <= 0 for w in self.windows_s):
            raise ValueError(f"windows_s must be positive, got {self.windows_s}")
        if self.burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {self.burn_threshold}"
            )
        if self.clear_threshold is None:
            self.clear_threshold = self.burn_threshold / 2.0
        if self.clear_for < 1:
            raise ValueError(f"clear_for must be >= 1, got {self.clear_for}")


class _RuleState:
    __slots__ = ("firing", "clear_streak", "burns", "fired_count")

    def __init__(self):
        self.firing = False
        self.clear_streak = 0
        self.burns: dict[float, float | None] = {}
        self.fired_count = 0


class SLOTracker:
    """Evaluate a rule set against a windowed aggregator and hold the
    alert state machine. Drive :meth:`evaluate` on the sampling cadence
    (or per ``/readyz`` probe via :meth:`attach` — evaluation is a few
    dict walks over in-memory frames, cheap at probe rates)."""

    def __init__(self, aggregator, rules: Sequence[AlertRule]):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self._agg = aggregator
        self.rules = tuple(rules)
        self._lock = threading.Lock()
        self._states = {r.name: _RuleState() for r in self.rules}
        self._log = None

    # -- evaluation --------------------------------------------------------

    def _burn(self, rule: AlertRule, window_s: float, now) -> float | None:
        err = rule.objective.error_rate(self._agg, window_s, now=now)
        if err is None:
            return None
        return err / rule.objective.budget

    def evaluate(self, now: float | None = None) -> dict[str, dict]:
        """One evaluation pass; returns per-rule
        ``{"firing", "burns", "objective"}``. Windows with no data
        report burn ``None`` and (conservatively for firing, safely for
        resolving) do NOT satisfy the fire condition — an idle process
        is not in violation, and a rule can only fire on evidence."""
        telemetry.count("slo.evaluations")
        out: dict[str, dict] = {}
        fired: list[tuple[str, float, str]] = []
        for rule in self.rules:
            burns = {w: self._burn(rule, w, now) for w in rule.windows_s}
            known = [b for b in burns.values() if b is not None]
            all_hot = (len(known) == len(burns)
                       and all(b > rule.burn_threshold for b in known))
            all_cool = all(b <= rule.clear_threshold for b in known)
            rule_labels = objective_labels(rule.objective)
            with self._lock:
                st = self._states[rule.name]
                st.burns = burns
                worst = max(known) if known else 0.0
                telemetry.set_gauge(f"slo.{rule.name}.burn_rate",
                                    round(worst, 4))
                if rule_labels:
                    # per-label burn twin: an objective bound to a
                    # selector publishes its burn under those labels too
                    telemetry.set_gauge(f"slo.{rule.name}.burn_rate",
                                        round(worst, 4),
                                        labels=rule_labels)
                if not st.firing and all_hot:
                    st.firing = True
                    st.clear_streak = 0
                    st.fired_count += 1
                    telemetry.count("obs.alert.fired")
                    fired.append((rule.name, round(worst, 4),
                                  rule.objective.describe()))
                    tracing.instant(
                        "slo_alert_fired", rule=rule.name,
                        objective=rule.objective.describe(),
                        burn=round(worst, 4),
                    )
                    self._logger().warning(
                        "SLO alert %r FIRED: %s burning at %.2fx budget "
                        "(threshold %.2fx)", rule.name,
                        rule.objective.describe(), worst,
                        rule.burn_threshold,
                    )
                elif st.firing:
                    if all_cool:
                        st.clear_streak += 1
                        if st.clear_streak >= rule.clear_for:
                            st.firing = False
                            st.clear_streak = 0
                            telemetry.count("obs.alert.resolved")
                            tracing.instant("slo_alert_resolved",
                                            rule=rule.name)
                            self._logger().warning(
                                "SLO alert %r resolved", rule.name,
                            )
                    else:
                        st.clear_streak = 0  # hysteresis: streak resets
                firing = st.firing
            out[rule.name] = {
                "firing": firing,
                "burns": {str(w): (round(b, 4) if b is not None else None)
                          for w, b in burns.items()},
                "objective": rule.objective.describe(),
            }
        if fired:
            # incident capture OUTSIDE the tracker lock: the dump's
            # readiness probe re-enters evaluate(), which must not
            # deadlock on self._lock (the recorder's non-blocking
            # trigger lock drops the re-entrant trigger itself)
            from tpu_syncbn_torch.obs import flightrec

            for name, burn, objective in fired:
                flightrec.trigger("slo_alert", {
                    "rule": name, "burn": burn, "objective": objective,
                })
        return out

    def _logger(self):
        if self._log is None:
            from tpu_syncbn_torch.runtime import distributed as dist

            self._log = dist.get_logger("tpu_syncbn_torch.obs")
        return self._log

    # -- queries -----------------------------------------------------------

    def firing(self) -> list[str]:
        with self._lock:
            return sorted(n for n, s in self._states.items() if s.firing)

    def ready(self) -> bool:
        """Readiness contribution: no rule currently firing."""
        return not self.firing()

    def state(self) -> dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "firing": st.firing,
                    "fired_count": st.fired_count,
                    "burns": {str(w): b for w, b in st.burns.items()},
                }
                for name, st in self._states.items()
            }

    # -- readiness wiring --------------------------------------------------

    def attach(self, name: str = "slo"):
        """Register this tracker as a ``/readyz`` hook: each probe
        re-evaluates the rules and reports firing alerts as not-ready.
        Also lists the tracker in the module registry
        (:func:`tracker_states`) so ``/statusz`` and incident bundles
        see its alert state. Returns ``self``; :meth:`detach` undoes
        both."""
        from tpu_syncbn_torch.obs import server as obs_server

        def hook() -> tuple[bool, dict]:
            self.evaluate()
            firing = self.firing()
            return not firing, {"firing": firing}

        obs_server.register_readiness(name, hook)
        with _attached_lock:
            _attached[name] = self
        self._attached_name = name
        return self

    def detach(self, name: str | None = None) -> None:
        """Unregister the readiness hook and drop the tracker from the
        module registry (``name`` defaults to the one :meth:`attach`
        used)."""
        from tpu_syncbn_torch.obs import server as obs_server

        name = name if name is not None \
            else getattr(self, "_attached_name", "slo")
        obs_server.unregister_readiness(name)
        with _attached_lock:
            if _attached.get(name) is self:
                _attached.pop(name, None)
