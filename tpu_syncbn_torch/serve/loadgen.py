"""Open-loop load generation: the only way to see a server past
saturation — the counterpart of ``tpu_syncbn.serve.loadgen``, kept as a
copy (it uses no framework), so the same seed gives the same arrivals.

A *closed-loop* client (``bench --serve``'s closed-loop sweep) waits for each
answer before sending the next request, so offered load self-limits at
the server's capacity — queueing collapse is unobservable by
construction. An *open-loop* generator submits on a fixed arrival
schedule regardless of completions, exactly like independent users: past
saturation the queue grows, deadlines start missing, and what separates
a robust server from a collapsing one is **goodput** (answers delivered
within their deadline) staying near capacity while p99 stays bounded and
the excess is *shed*, not queued.

Determinism contract (same as :mod:`tpu_syncbn_torch.testing.faults`): arrival
schedules are derived from an explicit seed (``random.Random``
exponential gaps for Poisson, or an explicit trace of arrival times) —
a failing overload test reproduces bit-for-bit. Only the *schedule* is
seeded; observed latencies are measurements.

Usage::

    gen = OpenLoopLoadGen(batcher.submit, make_request=lambda i: x[i:i+1])
    report = gen.run(poisson_arrivals(rate_rps=200, duration_s=2.0,
                                      seed=0))
    report.goodput_rps, report.latency_p99_ms, report.shed_rate

``sweep()`` runs several offered-load levels and returns their reports —
the shape ``bench --serve``'s schema-pinned ``open_loop`` section is
built from.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Sequence

from tpu_syncbn_torch.serve.admission import DeadlineExceededError, RejectedError

__all__ = [
    "poisson_arrivals",
    "trace_arrivals",
    "LoadReport",
    "OpenLoopLoadGen",
]


def poisson_arrivals(
    rate_rps: float, duration_s: float, *, seed: int = 0
) -> list[float]:
    """Relative arrival offsets (seconds from start) of a Poisson
    process at ``rate_rps`` over ``duration_s`` — exponential
    inter-arrival gaps from a seeded RNG, no wall-clock randomness."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    rng = random.Random(seed)
    out: list[float] = []
    t = rng.expovariate(rate_rps)
    while t < duration_s:
        out.append(t)
        t += rng.expovariate(rate_rps)
    return out


def trace_arrivals(times: Sequence[float]) -> list[float]:
    """Validate an explicit arrival trace (relative offsets, seconds):
    sorted, non-negative — replayed production traffic or a handcrafted
    burst pattern."""
    out = [float(t) for t in times]
    if any(t < 0 for t in out):
        raise ValueError("arrival offsets must be >= 0")
    if out != sorted(out):
        raise ValueError("arrival offsets must be sorted ascending")
    return out


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(idx)]


@dataclasses.dataclass
class LoadReport:
    """One open-loop level's measurements. ``offered`` counts scheduled
    arrivals; every request ends in exactly one of ``answered`` (in
    time), ``late`` (answered past deadline), ``shed`` (deadline policy
    failed it), ``rejected`` (backpressure/circuit/drain at submit or
    queue-fail), or ``errored`` (engine exception) — plus ``lost`` for
    anything unresolved at the collection timeout (should be 0)."""

    offered: int
    duration_s: float
    answered: int
    late: int
    shed: int
    rejected: int
    errored: int
    lost: int
    #: latency of EVERY answered request, late ones included — so the
    #: reported p99 is the honest client-visible tail, and "p99 stays
    #: bounded" is a claim about shedding policy, not bookkeeping
    latencies_s: list[float] = dataclasses.field(repr=False)

    @property
    def offered_rps(self) -> float:
        return self.offered / self.duration_s if self.duration_s else 0.0

    @property
    def goodput_rps(self) -> float:
        """In-deadline answers per second — the number that must stay
        near capacity past saturation."""
        return self.answered / self.duration_s if self.duration_s else 0.0

    @property
    def deadline_miss_rate(self) -> float:
        """(sheds + late answers) / offered."""
        return ((self.shed + self.late) / self.offered
                if self.offered else 0.0)

    @property
    def shed_rate(self) -> float:
        return self.shed / self.offered if self.offered else 0.0

    @property
    def reject_rate(self) -> float:
        return self.rejected / self.offered if self.offered else 0.0

    def latency_ms(self, q: float) -> float | None:
        """Latency percentile over every answered request (late
        included), in ms."""
        v = _percentile(sorted(self.latencies_s), q)
        return None if v is None else v * 1e3

    def summary(self) -> dict:
        """JSON-ready block (the bench ``open_loop`` level schema)."""
        p50 = self.latency_ms(0.50)
        p99 = self.latency_ms(0.99)
        return {
            "offered": self.offered,
            "offered_rps": round(self.offered_rps, 2),
            "duration_s": round(self.duration_s, 3),
            "answered": self.answered,
            "goodput_rps": round(self.goodput_rps, 2),
            "latency_p50_ms": round(p50, 3) if p50 is not None else None,
            "latency_p99_ms": round(p99, 3) if p99 is not None else None,
            "deadline_miss_rate": round(self.deadline_miss_rate, 4),
            "shed_rate": round(self.shed_rate, 4),
            "reject_rate": round(self.reject_rate, 4),
            "late": self.late,
            "shed": self.shed,
            "rejected": self.rejected,
            "errored": self.errored,
            "lost": self.lost,
        }


class OpenLoopLoadGen:
    """Drive ``submit`` (the batcher's, or any callable returning a
    ``concurrent.futures.Future``) on a fixed arrival schedule.

    ``make_request(i)`` builds the i-th request payload (default: the
    integer index — fine for stub engines). ``deadline_ms`` is threaded
    through to ``submit`` when given (the batcher's per-request
    override); the same value classifies answered-but-late responses.
    The generator never blocks on a response: completions are recorded
    by future callbacks, which is what makes the loop open."""

    def __init__(
        self,
        submit: Callable,
        *,
        make_request: Callable[[int], object] | None = None,
        deadline_ms: float | None = None,
    ):
        self._submit = submit
        self._make_request = (make_request if make_request is not None
                              else lambda i: i)
        self.deadline_ms = deadline_ms

    def run(
        self,
        arrivals: Sequence[float],
        *,
        collect_timeout_s: float = 60.0,
    ) -> LoadReport:
        """Submit one request per arrival offset, sleeping to hold the
        schedule (a late generator — host stall — submits immediately;
        offered load is never silently reduced). Blocks until every
        future resolves or ``collect_timeout_s`` passes, then reports."""
        arrivals = trace_arrivals(arrivals)
        lock = threading.Lock()
        latencies: list[float] = []
        counts = {"late": 0, "shed": 0, "rejected": 0, "errored": 0}
        outstanding = threading.Semaphore(0)
        resolved = [0]
        deadline_s = (None if self.deadline_ms is None
                      else self.deadline_ms / 1e3)

        def done(t_submit: float, fut) -> None:
            dt = time.monotonic() - t_submit
            try:
                fut.result()
            except DeadlineExceededError:
                kind = "shed"
            except RejectedError:
                kind = "rejected"
            except Exception:
                kind = "errored"
            else:
                kind = ("late" if deadline_s is not None and dt > deadline_s
                        else None)
            with lock:
                if kind is None or kind == "late":
                    latencies.append(dt)  # every answer counts in p99
                if kind is not None:
                    counts[kind] += 1
                resolved[0] += 1
            outstanding.release()

        t0 = time.monotonic()
        submitted = 0
        for i, offset in enumerate(arrivals):
            delay = (t0 + offset) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            payload = self._make_request(i)
            t_submit = time.monotonic()
            try:
                if self.deadline_ms is not None:
                    fut = self._submit(payload, deadline_ms=self.deadline_ms)
                else:
                    fut = self._submit(payload)
            except RejectedError:
                with lock:
                    counts["rejected"] += 1
                    resolved[0] += 1
                outstanding.release()
            else:
                fut.add_done_callback(
                    lambda f, t=t_submit: done(t, f)
                )
            submitted += 1
        # the offered window ends with the last submit — rates are
        # per-window; the collection tail below must not dilute them
        duration = time.monotonic() - t0
        # collect: every arrival resolves exactly once (callback or
        # submit-time rejection); anything still pending at the timeout
        # is counted lost, never waited on forever
        end = time.monotonic() + collect_timeout_s
        collected = 0
        while collected < submitted:
            remaining = end - time.monotonic()
            if remaining <= 0 or not outstanding.acquire(timeout=remaining):
                break
            collected += 1
        with lock:
            return LoadReport(
                offered=submitted,
                duration_s=duration,
                answered=len(latencies) - counts["late"],
                late=counts["late"],
                shed=counts["shed"],
                rejected=counts["rejected"],
                errored=counts["errored"],
                lost=submitted - resolved[0],
                latencies_s=list(latencies),
            )

    def sweep(
        self,
        rates_rps: Sequence[float],
        *,
        duration_s: float = 1.0,
        seed: int = 0,
        collect_timeout_s: float = 60.0,
    ) -> list[LoadReport]:
        """One :meth:`run` per offered rate (each level's schedule
        seeded with ``seed + level index`` — distinct but reproducible
        arrival patterns), returned in order."""
        return [
            self.run(
                poisson_arrivals(r, duration_s, seed=seed + i),
                collect_timeout_s=collect_timeout_s,
            )
            for i, r in enumerate(rates_rps)
        ]
