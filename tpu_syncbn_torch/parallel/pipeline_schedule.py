"""Pipeline-parallel *training* schedules as static tick tables — a copy
of ``tpu_syncbn.parallel.pipeline_schedule`` (numpy only, so the port keeps
its own rather than import the JAX package).

A pipeline schedule here is a pair of integer tables ``(fwd, bwd)`` of
shape ``(T, N)``: at tick ``t`` stage ``s`` runs the **forward** of
microbatch ``fwd[t, s]`` and the **backward** of microbatch
``bwd[t, s]`` (``-1`` = that slot is idle). The tables are host-side
numpy constants: :class:`~tpu_syncbn_torch.parallel.pipeline.
PipelineTrainer` walks their rows on the host, every rank reading its own
column.

Why tick tables and not code paths per schedule: the step body is
identical for every schedule (deliver ring payloads, forward slot,
backward slot, two ``ppermute`` hand-offs); a schedule is *data*. GPipe,
1F1B, and anything "Efficient Pipeline Planning for Expedited Distributed
DNN Training" (arXiv:2204.10562) would emit are all points in the same
table space, checked by ONE legality validator (:func:`validate_schedule`)
instead of per-schedule proofs.

Bubble accounting. The tick arithmetic is the JAX package's, table for
table; what each tick executes differs:

* The JAX trainer's compiled body executes BOTH the forward and the
  backward compute on every stage every tick — inactive slots run on
  masked garbage (SPMD lockstep). A device pays ``2·T`` op-slots for its
  ``2·M`` useful ops, and ``predicted_bubble_frac = 1 − 2M / 2T = 1 − M/T``
  is the fraction of executed compute that is masked waste.
* The port's trainer is one process a stage that knows its column of the
  tables on the host, so an idle slot computes nothing; the two
  ``ppermute`` hand-offs still run every tick (carrying zeros when idle),
  so every rank issues ``2·T`` of them a step. ``1 − M/T`` is then the
  share of ticks in which a stage waits on its neighbours rather than
  the share of wasted compute; the bench (``tpu_syncbn_torch.bench``)
  reports it beside the measured ``1 − t_dense / t_schedule``.
* The textbook GPipe figure :func:`canonical_gpipe_bubble`
  ``(N−1)/(M+N−1)`` assumes one-op ticks (idle *slots* over scheduled
  slots). The tick-table GPipe is worse than the textbook number
  because its flush runs the forward and the backward phases in separate
  ticks — the waste 1F1B's fused steady-state ticks (one forward AND one
  backward per tick) reclaim: ``T_gpipe = 2(M+N−1)`` vs
  ``T_1f1b = M + 2(N−1)``, so at ``M ≥ 2N`` 1F1B's bubble is well under
  half of GPipe's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IDLE = -1


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A pipeline training schedule: paired forward/backward tick
    tables over ``n_stages`` stages and ``n_microbatches`` microbatches
    (entries are microbatch indices, :data:`IDLE` for an idle slot).

    Build with :func:`gpipe_schedule` / :func:`one_f1b_schedule` (or
    :func:`get_schedule`); hand-built tables should pass through
    :func:`validate_schedule` before training with them."""

    name: str
    n_stages: int
    n_microbatches: int
    fwd: np.ndarray  # (T, N) int32
    bwd: np.ndarray  # (T, N) int32

    @property
    def ticks(self) -> int:
        return int(self.fwd.shape[0])

    @property
    def predicted_bubble_frac(self) -> float:
        """``1 − M/T``: a stage's useful work is ``2M`` of the ``2T`` op
        slots of the table (the module docstring says what the port runs
        in an idle slot). This is what the measured wall-time bubble
        should track."""
        return 1.0 - self.n_microbatches / self.ticks

    def max_in_flight(self) -> list[int]:
        """Per-stage peak count of forwards whose backward has not yet
        run — the activation-memory bound the schedule implies (1F1B's
        raison d'être: ≤ ``N − s`` instead of GPipe's ``M``)."""
        peaks = []
        for s in range(self.n_stages):
            live = 0
            peak = 0
            for t in range(self.ticks):
                if self.fwd[t, s] != IDLE:
                    live += 1
                    peak = max(peak, live)
                if self.bwd[t, s] != IDLE:
                    live -= 1
            peaks.append(peak)
        return peaks


def canonical_gpipe_bubble(m: int, n: int) -> float:
    """The textbook GPipe fill/drain bubble fraction ``(N−1)/(M+N−1)``
    (one-op-per-tick accounting). The tick-table GPipe's bubble is
    worse — see the module docstring."""
    return (n - 1) / (m + n - 1)


def _check_mn(m: int, n: int) -> None:
    if m < 1:
        raise ValueError(f"need at least one microbatch, got m={m}")
    if n < 2:
        raise ValueError(
            f"a pipeline needs at least two stages, got n={n} "
            "(use DataParallel for the single-stage case)"
        )


def gpipe_schedule(m: int, n: int) -> Schedule:
    """GPipe fill/drain with a flush: every forward completes before
    any backward starts. Forward phase ticks ``0..M+N−2`` (stage ``s``
    forwards microbatch ``t−s``), backward phase mirrors it in reverse
    stage order; ``T = 2(M+N−1)``."""
    _check_mn(m, n)
    t_half = m + n - 1
    fwd = np.full((2 * t_half, n), IDLE, np.int32)
    bwd = np.full((2 * t_half, n), IDLE, np.int32)
    for t in range(t_half):
        for s in range(n):
            j = t - s
            if 0 <= j < m:
                fwd[t, s] = j
            jb = t - (n - 1 - s)
            if 0 <= jb < m:
                bwd[t_half + t, s] = jb
    return Schedule("gpipe", n, m, fwd, bwd)


def one_f1b_schedule(m: int, n: int) -> Schedule:
    """1F1B (PipeDream-flush): after a short warmup every stage runs
    one forward AND one backward per tick, so the steady state has no
    masked slots at all. Built by simulating the greedy depth-limited
    policy with the ring's one-tick message latency: stage ``s`` admits
    a new forward only while fewer than ``2(N−s)−1`` of its forwards
    await their backward — the fused-tick analogue of the classic 1F1B
    ``N−s`` bound, sized to cover the ``2(N−1−s)+1``-tick round trip to
    the loss head so the steady state never starves. In-flight
    activations stay O(N), independent of ``M`` (GPipe holds ``M``);
    ``T = M + 2(N−1)`` for ``M ≥ N``."""
    _check_mn(m, n)
    fwd_rows: list[np.ndarray] = []
    bwd_rows: list[np.ndarray] = []
    # per-stage pending queues; messages sent at tick t arrive at t+1
    fwd_ready = [list(range(m)) if s == 0 else [] for s in range(n)]
    bwd_ready: list[list[int]] = [[] for _ in range(n)]
    in_flight = [0] * n
    done_bwd = 0
    fwd_arrivals: list[tuple[int, int]] = []  # (stage, mb) landing next tick
    bwd_arrivals: list[tuple[int, int]] = []
    cap = 4 * (m + n) + 8
    for _ in range(cap):
        if done_bwd == m * n:
            break
        for s, j in fwd_arrivals:
            fwd_ready[s].append(j)
        for s, j in bwd_arrivals:
            bwd_ready[s].append(j)
        fwd_arrivals, bwd_arrivals = [], []
        frow = np.full(n, IDLE, np.int32)
        brow = np.full(n, IDLE, np.int32)
        for s in range(n):
            # forward slot first: the body computes it first, so the
            # last stage may take the matching backward the same tick.
            # A tick that also runs a backward frees one slot, so the
            # admission check credits it — without the credit every
            # steady-state tick at the limit alternates f-only/b-only
            # and the schedule gains one bubble per microbatch.
            freeing = 1 if bwd_ready[s] else 0
            if fwd_ready[s] and in_flight[s] - freeing < 2 * (n - s) - 1:
                j = fwd_ready[s].pop(0)
                frow[s] = j
                in_flight[s] += 1
                if s < n - 1:
                    fwd_arrivals.append((s + 1, j))
                else:
                    bwd_ready[s].append(j)  # loss head: ready in-tick
            if bwd_ready[s]:
                j = bwd_ready[s].pop(0)
                brow[s] = j
                in_flight[s] -= 1
                done_bwd += 1
                if s > 0:
                    bwd_arrivals.append((s - 1, j))
        fwd_rows.append(frow)
        bwd_rows.append(brow)
    if done_bwd != m * n:
        raise RuntimeError(
            f"1F1B simulation did not converge for m={m}, n={n}"
        )
    return Schedule("1f1b", n, m, np.stack(fwd_rows), np.stack(bwd_rows))


def dense_timing_schedule(m: int, n: int) -> Schedule:
    """A zero-bubble TIMING REFERENCE: every tick runs one forward and
    one backward on every stage (``T = M`` ticks, no idle slots). This
    is NOT a legal pipeline schedule — its dataflow is nonsense and a
    step trained with it computes garbage — but it executes the same
    per-tick body as the real schedules with every slot active, so its
    wall time is the zero-bubble ideal the measured bubble fraction is
    computed against (the bench: ``1 − t_dense / t_schedule``)."""
    _check_mn(m, n)
    col = np.arange(m, dtype=np.int32)
    fwd = np.tile(col[:, None], (1, n))
    return Schedule("_dense_timing", n, m, fwd, fwd.copy())


def get_schedule(schedule, m: int, n: int) -> Schedule:
    """Resolve a schedule argument: a :class:`Schedule` passes through
    (shape-checked against ``m``/``n``); ``"gpipe"``/``"1f1b"`` build
    the named table."""
    if isinstance(schedule, Schedule):
        if schedule.n_stages != n or schedule.n_microbatches != m:
            raise ValueError(
                f"schedule {schedule.name!r} is for "
                f"{schedule.n_microbatches} microbatches x "
                f"{schedule.n_stages} stages, trainer wants {m} x {n}"
            )
        return schedule
    builders = {"gpipe": gpipe_schedule, "1f1b": one_f1b_schedule}
    if schedule not in builders:
        raise ValueError(
            f"unknown schedule {schedule!r}: pass 'gpipe', '1f1b', or a "
            "Schedule instance"
        )
    return builders[schedule](m, n)


def validate_schedule(sched: Schedule) -> None:
    """Legality check for a tick table against the step body's dataflow
    (raises ``ValueError`` naming the first violation):

    * each (stage, microbatch) pair forwards exactly once and backwards
      exactly once, indices in range;
    * forward of microbatch ``j`` on stage ``s`` happens strictly after
      stage ``s−1``'s (the ring delivers with one tick of latency);
    * backward of ``j`` on stage ``s`` happens strictly after stage
      ``s+1``'s, and on the last stage no earlier than its own forward
      (the loss-head cotangent exists in-tick);
    * every backward happens strictly after the same stage's forward
      (its saved input activation must exist) — same-tick is allowed
      only on the last stage, whose forward slot runs first."""
    m, n = sched.n_microbatches, sched.n_stages
    for table, kind in ((sched.fwd, "fwd"), (sched.bwd, "bwd")):
        if table.shape != (sched.ticks, n):
            raise ValueError(
                f"{sched.name}: {kind} table shape {table.shape} != "
                f"({sched.ticks}, {n})"
            )
        bad = (table != IDLE) & ((table < 0) | (table >= m))
        if bad.any():
            t, s = np.argwhere(bad)[0]
            raise ValueError(
                f"{sched.name}: {kind}[{t},{s}] = {table[t, s]} out of "
                f"range [0, {m})"
            )

    def tick_of(table, kind):
        out = np.full((n, m), -1, np.int64)
        for t in range(sched.ticks):
            for s in range(n):
                j = table[t, s]
                if j == IDLE:
                    continue
                if out[s, j] != -1:
                    raise ValueError(
                        f"{sched.name}: stage {s} runs {kind} of "
                        f"microbatch {j} twice (ticks {out[s, j]} and {t})"
                    )
                out[s, j] = t
        missing = np.argwhere(out == -1)
        if missing.size:
            s, j = missing[0]
            raise ValueError(
                f"{sched.name}: stage {s} never runs {kind} of "
                f"microbatch {j}"
            )
        return out

    tf = tick_of(sched.fwd, "fwd")
    tb = tick_of(sched.bwd, "bwd")
    for j in range(m):
        for s in range(1, n):
            if tf[s, j] <= tf[s - 1, j]:
                raise ValueError(
                    f"{sched.name}: stage {s} forwards microbatch {j} at "
                    f"tick {tf[s, j]} but stage {s - 1}'s activation only "
                    f"lands at tick {tf[s - 1, j] + 1}"
                )
        for s in range(n - 1):
            if tb[s, j] <= tb[s + 1, j]:
                raise ValueError(
                    f"{sched.name}: stage {s} backwards microbatch {j} at "
                    f"tick {tb[s, j]} but stage {s + 1}'s cotangent only "
                    f"lands at tick {tb[s + 1, j] + 1}"
                )
        for s in range(n):
            # non-last stages need BOTH the saved activation (own fwd)
            # and the inbound cotangent (covered above); the last stage
            # may fuse fwd+bwd of j into one tick (fwd slot runs first)
            min_gap = 0 if s == n - 1 else 1
            if tb[s, j] - tf[s, j] < min_gap:
                raise ValueError(
                    f"{sched.name}: stage {s} backwards microbatch {j} at "
                    f"tick {tb[s, j]} before its own forward (tick "
                    f"{tf[s, j]}) saved the activation"
                )
