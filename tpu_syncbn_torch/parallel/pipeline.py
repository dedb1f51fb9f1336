"""Pipeline parallelism over a ``pipe`` process group — the counterpart of
``tpu_syncbn.parallel.pipeline``.

Each rank owns ONE stage's parameters; microbatches stream through the
ring of the pipe group with :func:`~tpu_syncbn_torch.parallel.collectives.ppermute`
(the neighbour cycle of ring attention). Two layers live here:

* the forward-only *schedule primitive* (:func:`pipeline_apply` /
  :func:`pipeline_parallel`): the GPipe fill/drain ring of ``M + N − 1``
  ticks, differentiable through ``ppermute``, whose backward sends each
  cotangent back along the inverted pairs;
* :class:`PipelineTrainer`: microbatch pipeline *training* driven by the
  static tick tables of :mod:`~tpu_syncbn_torch.parallel.pipeline_schedule`
  (GPipe and 1F1B): forward ring right, backward ring left, gradient
  accumulation, one optimizer update a step, composed with a data axis on
  a 2-D ``(data, pipe)`` mesh (:func:`pipeline_mesh`).

What differs from the JAX package, and why. JAX runs one SPMD program:
every device executes both op slots of every tick on masked garbage,
because it has no per-device control flow. Here each rank is a process
that knows its stage and reads its column of the tables on the host, so
an idle slot computes nothing, while the two ``ppermute`` hand-offs still
run every tick (carrying zeros when idle): the collective count stays
JAX's ``2·T`` a step, and the results are JAX's, since every masked value
JAX computes is discarded. Garbage never exists, so it cannot leak.

Exactness: the pipeline output equals running the N stages sequentially
on each microbatch, forward and gradients.

The products inside a stage are whatever ``stage_fn`` runs: the trainer
adds no kernel of its own. A stage of the LM's blocks
(:func:`~tpu_syncbn_torch.models.transformer._block` with
``attn_impl="flash_pallas_bwd"``) launches the flash kernels in its
forward slot, its recompute and its backward.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Mapping

import torch
from torch import nn

from tpu_syncbn_torch.mesh_axes import DATA_AXIS, PIPE_AXIS
from tpu_syncbn_torch.parallel import collectives, pipeline_schedule, scan_driver

Pytree = Any


def _ring(n: int, step: int) -> list:
    return [(i, (i + step) % n) for i in range(n)]


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``tied`` tensors hung on it that take a zero
    cotangent. Every ``ppermute`` a rank issued must run its backward on
    that rank (its peers wait for the exchange), including the payloads
    this rank received but never used (stage 0 ignores the ring's
    wrap-around; an idle tick's inbound goes nowhere); tied to the output,
    each is reached, in reverse tick order on every rank."""

    @staticmethod
    def forward(ctx, out, *tied):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tied]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.like))


def pipeline_apply(
    stage_fn: Callable[[Pytree, torch.Tensor], torch.Tensor],
    stage_params: Pytree,
    microbatches: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """Run ``N = world_size(group)`` stages over ``M`` microbatches,
    GPipe-style, on this rank's stage.

    Args:
      stage_fn: ``(params_for_my_stage, x) -> y`` — one stage. Every stage
        maps activations of the same shape and dtype (the payload that
        travels the ring).
      stage_params: THIS rank's stage parameters.
      microbatches: ``(M, mb, ...)``, identical on every rank; stage 0
        consumes them in order.

    Returns ``(M, mb, ...)``: on the last stage the pipeline's output, on
    every other rank zeros (JAX's per-device accumulators).

    At tick ``t`` stage ``s`` runs microbatch ``t − s`` when it is in range
    and computes nothing otherwise; every rank sends its payload (zeros on
    an idle tick) one rank on, every tick. Differentiable: call backward
    on every rank, with this rank's output's cotangent (zeros off the last
    stage). The replicated ``microbatches`` pass through
    ``collectives.copy_to_group``, so their gradient is the full gradient
    on every rank, as JAX's implicit ``pvary`` gives it."""
    n = collectives.world_size(group)
    s = collectives.axis_index(group)
    m = microbatches.shape[0]
    leaves = scan_driver._leaves(stage_params)
    track = torch.is_grad_enabled() and (
        microbatches.requires_grad or any(p.requires_grad for p in leaves))
    right = _ring(n, 1)
    feed = collectives.copy_to_group(microbatches, group)
    zero = microbatches.new_zeros(microbatches.shape[1:])
    rows = [zero] * m
    inbound, tied = zero, [feed]
    for t in range(m + n - 1):
        j = t - s
        if 0 <= j < m:
            y = stage_fn(stage_params, feed[j] if s == 0 else inbound)
            if s == n - 1:
                rows[j] = y
        else:  # idle: zeros, in the graph when the peers' payloads are
            y = torch.zeros_like(zero).requires_grad_(track)
        inbound = collectives.ppermute(y, right, group)
        tied.append(inbound)
    acc = torch.stack(rows)
    return _Tie.apply(acc, *tied) if track else acc


def pipeline_parallel(
    stage_fn: Callable[[Pytree, torch.Tensor], torch.Tensor],
    group=None,
):
    """The per-rank counterpart of the JAX wrapper: returns
    ``f(stacked_params, microbatches)`` where ``stacked_params`` has a
    leading stage axis on every leaf (this rank's row is taken) and
    ``microbatches`` is ``(M, mb, ...)``. The result is this rank's row of
    the JAX function's ``(N, M, mb, ...)`` output, with its leading axis of
    1: stack the ranks' rows and :func:`last_stage_output` is the
    pipeline's output."""

    def run(stacked_params, microbatches):
        s = collectives.axis_index(group)
        params = scan_driver._map(lambda leaf: leaf[s], stacked_params)
        return pipeline_apply(stage_fn, params, microbatches, group)[None]

    return run


def last_stage_output(stacked_out):
    """The true pipeline output from the stage-stacked rows of
    :func:`pipeline_parallel`: row ``N − 1``."""
    return stacked_out[-1]


def split_microbatches(batch: Pytree, num_microbatches: int) -> Pytree:
    """Reshape a ``(batch, ...)`` tree into the trainer's
    ``(M, batch / M, ...)`` microbatch layout (raises when the leading axis
    does not divide)."""

    def leaf(x):
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(
                f"global batch {b} is not divisible by "
                f"num_microbatches={num_microbatches}"
            )
        return x.reshape((num_microbatches, b // num_microbatches) + tuple(x.shape[1:]))

    return scan_driver._map(leaf, batch)


def pipeline_mesh(
    n_stages: int,
    data_axis: str = DATA_AXIS,
    pipe_axis: str = PIPE_AXIS,
    *,
    device="cuda",
):
    """The 2-D ``(data, pipe)`` layout the trainer composes over: every
    process arranged ``(world // n_stages, n_stages)``, the pipe axis
    innermost, so rank ``r`` is stage ``r % n_stages`` of data replica
    ``r // n_stages`` (each pipeline a contiguous ring), as JAX's
    ``make_mesh`` lays the devices out. A
    :class:`~tpu_syncbn_torch.parallel.layout.SpecLayout` over a
    ``DeviceMesh``; its ``group(axis)`` is each axis's process group."""
    from tpu_syncbn_torch.parallel.layout import SpecLayout
    from tpu_syncbn_torch.runtime import distributed as dist

    world = dist.process_count()
    if world % n_stages:
        raise ValueError(
            f"{world} devices do not split into pipelines of "
            f"{n_stages} stages"
        )
    return SpecLayout({data_axis: world // n_stages, pipe_axis: n_stages},
                      param_shard_axis=None, device=device)


class PipelineTrainer:
    """Microbatch pipeline *training* over a 2-D ``(data, pipe)`` mesh: the
    whole schedule — forward microbatch ring, backward ring, gradient
    accumulation across microbatches, ONE optimizer update — runs in
    :meth:`train_step`; :meth:`train_steps_batches` runs K steps as one
    program (``scan_driver.build_scan_steps``: one CUDA graph on the card,
    the step loop on the CPU).

    Model contract (the pipeline shape, not ``DataParallel``'s):

    * ``stage_fn(stage_params, x) -> y`` — one stage. ``stage_params`` is
      a dict ``{name: nn.Parameter}`` of this rank's stage. Every stage
      maps activations of ONE fixed shape and dtype.
    * ``loss_fn(y, target) -> scalar`` — the loss head, applied by the
      last stage per microbatch, in float32; the reported loss is the mean
      over the M microbatches (averaged across data replicas).
    * ``stacked_params`` — a dict of tensors (or arrays), each with a
      leading ``n_stages`` axis, as the JAX tree. Each rank keeps only its
      stage's slice, as ``nn.Parameter``s on the trainer's device; there
      is NO cross-stage parameter collective. Gradients pay one ``pmean``
      a parameter over the data axis; activations and cotangents pay
      exactly two ``ppermute``s a tick (forward ring right, backward ring
      left), ``2·T`` a step.
    * ``optimizer`` — a factory ``params -> torch.optim.Optimizer`` called
      on the stage's parameter list (JAX takes an optax transform). It
      must be elementwise (``zero.check_elementwise``): each rank updates
      its stage alone. ``train_steps_batches`` takes SGD or Adam(W), as
      ``DataParallel.train_steps`` does.
    * each ``batch = (x_mb, t_mb)``: this data replica's ``(M, mb, ...)``
      microbatches (:func:`split_microbatches`), the same on every stage
      of the replica: stage 0 reads ``x_mb``, the last stage ``t_mb``.

    Schedules are static tick tables: ``"gpipe"`` fill/drain or ``"1f1b"``
    (default). Each tick: (1) the payloads sent last tick land in the
    activation buffer and the gradient inbox; (2) the forward slot runs
    the stage without a tape and saves its input (the last stage adds the
    float32 loss); (3) the backward slot recomputes the stage forward from
    the saved input and takes ``torch.autograd.grad`` against the
    parameters and the input — JAX's ``jax.vjp`` remat — with the loss
    head's gradient as the cotangent on the last stage and the inbox row
    elsewhere; (4) the parameter gradients accumulate in tick order, in
    the parameters' dtype; (5) the two ``ppermute``s. An idle slot
    computes nothing (module docstring). After the ticks the loss is
    ``psum`` over pipe / M then ``pmean`` over data; the gradients are
    divided by M and ``pmean``'d over data, never across stages.

    ``divergence_guard="skip_step"``: a world-wide ``pmin`` of the
    gradients' finiteness and the loss's; a non-finite step leaves the
    parameters and the optimizer state as they were, and the ``nonfinite``
    metric and ``guard_state["nonfinite_count"]`` record it.

    Usage::

        tr = PipelineTrainer(stage_fn, loss_fn, stacked,
                             lambda ps: torch.optim.SGD(ps, lr=1e-2),
                             num_microbatches=8, schedule="1f1b")
        out = tr.train_step((split_microbatches(x, 8), split_microbatches(t, 8)))
        out = tr.train_steps_batches(chunk)     # K updates, one program
    """

    def __init__(
        self,
        stage_fn: Callable[[Pytree, torch.Tensor], torch.Tensor],
        loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        stacked_params: Mapping[str, Any],
        optimizer: Callable[[list], torch.optim.Optimizer],
        *,
        num_microbatches: int,
        schedule="1f1b",
        mesh=None,
        layout=None,
        data_axis: str = DATA_AXIS,
        pipe_axis: str = PIPE_AXIS,
        divergence_guard: str | None = None,
        device="cuda",
    ):
        from tpu_syncbn_torch.parallel.layout import SpecLayout
        from tpu_syncbn_torch.parallel.zero import check_elementwise

        if divergence_guard not in (None, "skip_step"):
            raise ValueError(
                "divergence_guard must be None or 'skip_step', got "
                f"{divergence_guard!r}"
            )
        if not stacked_params:
            raise ValueError("stacked_params has no array leaves")
        stage_dims = {leaf.shape[0] for leaf in stacked_params.values()}
        if len(stage_dims) != 1:
            raise ValueError(
                "every stacked_params leaf needs the same leading stage "
                f"axis, got leading dims {sorted(stage_dims)}"
            )
        (self.n_stages,) = stage_dims
        self.num_microbatches = int(num_microbatches)
        # named schedules can be re-derived at a new M by
        # set_microbatches(); an explicit Schedule instance cannot
        self._schedule_name = schedule if isinstance(schedule, str) else None
        self.schedule = pipeline_schedule.get_schedule(
            schedule, self.num_microbatches, self.n_stages)
        if not self.schedule.name.startswith("_"):
            pipeline_schedule.validate_schedule(self.schedule)
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        self.data_axis = data_axis
        self.pipe_axis = pipe_axis
        if layout is None:
            layout = (SpecLayout.from_mesh(mesh, param_shard_axis=None, device=device)
                      if mesh is not None else
                      pipeline_mesh(self.n_stages, data_axis, pipe_axis, device=device))
        elif mesh is not None and mesh is not layout.mesh:
            raise ValueError(
                "pass either layout= or mesh=, not both — the layout "
                "owns the mesh"
            )
        if layout.param_shard_axis is not None:
            raise ValueError(
                "; ".join(layout.reject_reasons()) or
                "PipelineTrainer needs a layout without a param shard axis"
            )
        self.layout = layout
        for ax in (data_axis, pipe_axis):
            if ax not in layout.axis_sizes:
                raise ValueError(
                    f"mesh is missing the {ax!r} axis (has "
                    f"{tuple(layout.axis_sizes)})"
                )
        if layout.axis_sizes[pipe_axis] != self.n_stages:
            raise ValueError(
                f"mesh {pipe_axis!r} axis has {layout.axis_sizes[pipe_axis]} "
                f"devices but stacked_params has {self.n_stages} stages"
            )
        self.device = layout.device
        self.pipe_group = layout.group(pipe_axis)
        self.data_group = layout.group(data_axis)
        self.world_group = layout.group((data_axis, pipe_axis))
        #: this rank's stage: its coordinate on the pipe axis
        self.stage = collectives.axis_index(self.pipe_group)
        self._params = {
            name: nn.Parameter(torch.as_tensor(leaf)[self.stage].detach().to(
                self.device, copy=True))
            for name, leaf in stacked_params.items()}
        self.optimizer = optimizer(list(self._params.values()))
        check_elementwise(self.optimizer)
        self.divergence_guard = divergence_guard
        self.guard_state = {"nonfinite_count": 0}
        self._first_flags = None
        # (K, stacked, M) -> the K-step program
        self._train_cache = scan_driver.ProgramCache(name="pipeline")

    @property
    def params(self) -> dict:
        """This rank's row of the stacked parameter tree:
        ``{name: (1, ...)}``, copies of the live parameters."""
        return {name: p.detach()[None].clone() for name, p in self._params.items()}

    def set_microbatches(self, num_microbatches: int) -> bool:
        """Re-derive the schedule at a new microbatch count M. Only valid
        for named schedules (``gpipe`` / ``1f1b``); an explicit
        :class:`~tpu_syncbn_torch.parallel.pipeline_schedule.Schedule` is
        pinned to its M and this returns ``False`` without touching
        anything. K-step programs for each M are cached apart, so
        flapping between two values does not rebuild. Callers must feed
        batches split at the new M."""
        m = int(num_microbatches)
        if self._schedule_name is None:
            return False
        if m == self.num_microbatches:
            return True
        sched = pipeline_schedule.get_schedule(self._schedule_name, m, self.n_stages)
        if not sched.name.startswith("_"):
            pipeline_schedule.validate_schedule(sched)
        self.num_microbatches = m
        self.schedule = sched
        return True

    # -- the step ---------------------------------------------------------

    @torch.no_grad()
    def _ticks(self, x_mb: torch.Tensor, t_mb: torch.Tensor):
        """The schedule on this rank: ``(loss, grads)`` — the step's loss
        (averaged over microbatches and data replicas) and this stage's
        gradients (averaged likewise), JAX's ``_make_step_fn`` tick by
        tick."""
        n, m, s = self.n_stages, self.num_microbatches, self.stage
        if x_mb.shape[0] != m:
            raise ValueError(
                f"batch carries {x_mb.shape[0]} microbatches, trainer "
                f"was built for num_microbatches={m} (use "
                "split_microbatches)"
            )
        sched, group = self.schedule, self.pipe_group
        right, left = _ring(n, 1), _ring(n, -1)
        last = s == n - 1
        params = self._params
        plist = list(params.values())
        fcol, bcol = sched.fwd[:, s].tolist(), sched.bwd[:, s].tolist()
        # what a neighbour sent LAST tick lands this tick: its slot is static
        f_land = [-1] + sched.fwd[:-1, (s - 1) % n].tolist() if s > 0 else None
        b_land = [-1] + sched.bwd[:-1, (s + 1) % n].tolist() if not last else None
        acts = torch.zeros_like(x_mb)  # saved stage inputs
        ginbox = None if last else torch.zeros_like(x_mb)
        zero = x_mb.new_zeros(x_mb.shape[1:])
        gacc = [torch.zeros_like(p) for p in plist]
        loss_acc = torch.zeros((), dtype=torch.float32, device=x_mb.device)
        fmsg = bmsg = zero
        for t in range(sched.ticks):
            # 1. deliver the ring payloads sent last tick
            if f_land is not None and f_land[t] >= 0:
                acts[f_land[t]].copy_(fmsg)
            if b_land is not None and b_land[t] >= 0:
                ginbox[b_land[t]].copy_(bmsg)
            # 2. forward slot: save the input; the last stage adds the loss
            fout, j = zero, fcol[t]
            if j >= 0:
                if s == 0:
                    acts[j].copy_(x_mb[j])
                y = self.stage_fn(params, acts[j])
                if last:
                    loss_acc = loss_acc + self.loss_fn(y, t_mb[j]).float()
                else:
                    fout = y
            # 3. backward slot: recompute from the saved input, then the
            # vector-Jacobian product with the loss head's gradient (last
            # stage) or the inbox row
            bout, j = zero, bcol[t]
            if j >= 0:
                with torch.enable_grad():
                    xb = acts[j].detach().requires_grad_(s > 0)
                    yb = self.stage_fn(params, xb)
                    if last:
                        yy = yb.detach().requires_grad_()
                        gy, = torch.autograd.grad(
                            self.loss_fn(yy, t_mb[j]).float(), yy)
                    else:
                        gy = ginbox[j]
                    wrt = plist + [xb] if s > 0 else plist
                    grads = torch.autograd.grad(yb, wrt, gy, allow_unused=True)
                # 4. accumulate in tick order
                for a, g in zip(gacc, grads):
                    if g is not None:
                        a.add_(g)
                if s > 0:
                    bout = grads[-1]
            # 5. two collectives a tick: activations right, cotangents left
            fmsg = collectives.ppermute(fout, right, group)
            bmsg = collectives.ppermute(bout, left, group)
        loss = collectives.psum(loss_acc, group) / m
        loss = collectives.pmean(loss, self.data_group)
        grads = [collectives.pmean(g / m, self.data_group) for g in gacc]
        ok = None
        if self.divergence_guard is not None:
            fin = torch.stack([g.isfinite().all() for g in gacc]).all()
            ok = (collectives.pmin(fin.to(torch.int32), self.world_group) > 0) \
                & torch.isfinite(loss)
        return loss, grads, ok

    def _set_grads(self, grads) -> None:
        for p, g in zip(self._params.values(), grads):
            p.grad = g

    def train_step(self, batch):
        """One optimizer step over ``batch = (x_mb, t_mb)``, each this data
        replica's ``(M, mb, ...)``. Returns
        :class:`~tpu_syncbn_torch.parallel.trainer.StepOutput` with the
        scalar microbatch-mean loss (and ``nonfinite`` under the guard)."""
        from tpu_syncbn_torch.parallel.trainer import StepOutput, _to_device

        x_mb, t_mb = _to_device(tuple(batch), self.device)
        loss, grads, ok = self._ticks(x_mb, t_mb)
        self._set_grads(grads)
        metrics = {}
        if ok is None or bool(ok):  # the guard's one host read a step
            self.optimizer.step()
        else:  # skipped: parameters and optimizer state as they were
            self.guard_state["nonfinite_count"] += 1
        if ok is not None:
            metrics["nonfinite"] = (~ok).float()
        return StepOutput(loss=loss, metrics=metrics)

    # -- K steps as one program -------------------------------------------

    def _chunk_step(self, chunk, k: int, batch) -> dict:
        from tpu_syncbn_torch.parallel.trainer import _select_

        x_mb, t_mb = batch
        if self.divergence_guard is not None:
            live = list(self._params.values()) + chunk.opt.state_tensors()
            old = [t.detach().clone() for t in live]
        loss, grads, ok = self._ticks(x_mb, t_mb)
        self._set_grads(grads)
        chunk.opt.step(chunk.opt.lrs[k])
        out = {"loss": loss}
        if ok is not None:
            _select_(ok, live, old)
            with torch.no_grad():
                out["nonfinite"] = (~ok).float()
                chunk.count.add_((~ok).long())
        return out

    def _build_program(self, n_steps: int, stacked: bool, batch):
        import types

        from tpu_syncbn_torch.parallel.trainer import _ChunkOptimizer

        opt = _ChunkOptimizer(self.optimizer, n_steps, self.device, self._first_flags)
        self._first_flags = opt.first
        chunk = types.SimpleNamespace(
            opt=opt, count=torch.zeros((), dtype=torch.int64, device=self.device))
        prog = scan_driver.build_scan_steps(
            functools.partial(self._chunk_step, chunk), n_steps=n_steps,
            stacked=stacked, device=self.device,
            state=lambda: list(self._params.values()) + chunk.opt.state_tensors()
            + [chunk.count])
        prog.chunk = chunk
        return prog.prepare(batch)

    def train_steps_batches(self, batches):
        """K optimizer steps — one per leading-axis slice of
        ``batches = (x, t)``, each ``(K, M, mb, ...)`` — as one program:
        exactly K :meth:`train_step` calls (within one rounding of SGD's
        update, as ``DataParallel.train_steps_batches``), with stacked
        per-step ``loss``/``metrics`` of leading dimension K. On the card
        the K steps are one CUDA graph, which at world > 1 holds the
        collectives: only NCCL's can be captured, so a gloo group raises."""
        from tpu_syncbn_torch.parallel.trainer import (
            StepOutput,
            _check_capturable,
            _schedule_lrs,
            _to_device,
        )

        batches = _to_device(tuple(batches), self.device)
        k = scan_driver.scan_length(batches)
        _check_capturable(self.device, self.layout.world, None)
        prog = scan_driver.cached_scan_steps(
            self._train_cache, (k, True, self.num_microbatches),
            lambda: self._build_program(k, True, batches))
        chunk = prog.chunk
        chunk.opt.fill(_schedule_lrs(self.optimizer, None, k))
        chunk.count.fill_(self.guard_state["nonfinite_count"])
        out = prog(batches)
        if self.divergence_guard is not None:  # the chunk's one host read
            self.guard_state["nonfinite_count"] = int(chunk.count)
        loss = out.pop("loss")
        return StepOutput(loss=loss, metrics=out)
