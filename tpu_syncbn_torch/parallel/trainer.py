"""Data-parallel trainer — the counterpart of
``tpu_syncbn.parallel.trainer`` (``StepOutput``, ``DataParallel`` with
``accum_steps``, ``remat``, ``divergence_guard`` and its state dict, and
``resume_latest``).

One process per GPU, each with its local shard of the batch. A step is
forward, local-mean loss, backward, ONE flat all-reduce of every gradient
divided by the world size (skipped at world 1), then the optimizer step:
with equal shards the update equals single-device large-batch SGD, DDP's
contract. The user brings a ``torch.optim`` optimizer over the model's
parameters; ``optax.sgd(lr, momentum=0.9)`` of the JAX package is
``torch.optim.SGD(params, lr, momentum=0.9)`` here. A learning-rate
schedule the trainer should own (as an optax schedule lives in the JAX
optimizer's state) is passed as ``lr_scheduler``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_syncbn_torch.parallel import collectives
from tpu_syncbn_torch.runtime import distributed as dist
from tpu_syncbn_torch.runtime.distributed import resolve_device

GUARD_POLICIES = (None, "skip_step", "halve_lr", "restore_last_good")


@dataclasses.dataclass
class StepOutput:
    """What a step returns: the replica-averaged loss and metrics, as
    device tensors (reading a value waits for the step)."""

    loss: torch.Tensor
    metrics: dict[str, torch.Tensor]


def _default_group():
    return tdist.group.WORLD if tdist.is_available() and tdist.is_initialized() else None


def sync_module_states(model: nn.Module, src: int = 0, *, group=None) -> None:
    """Broadcast parameters and buffers from rank ``src`` of ``group``
    (``None``: the default world group) — DDP's init-time
    ``_sync_module_states``. No-op at world 1."""
    if group is None:
        group = _default_group()
    tensors = [p.data for p in model.parameters()]
    tensors += [b for b in model.buffers() if b is not None]
    collectives.broadcast_(tensors, group, src)


def _stats_replicated_by_construction(model: nn.Module, group) -> bool:
    """True when every buffer belongs to a SyncBatchNorm syncing over the
    trainer's whole group: its stats come from all-reduced moments, so
    they are identical on every replica and a per-step broadcast would
    move bytes for nothing. A layer scoped to a subgroup (``group_size``,
    or another ``process_group``) has stats that differ between
    subgroups, so the trainer keeps DDP's broadcast from rank 0, as the
    JAX trainer does for group-scoped SyncBN."""
    from tpu_syncbn_torch.nn.normalization import SyncBatchNorm

    for module in model.modules():
        own = [b for b in module.buffers(recurse=False) if b is not None]
        if not own:
            continue
        if not isinstance(module, SyncBatchNorm):
            return False
        if module.scope_group() is not group:
            return False
    return True


def _map_batch(fn, tree):
    """``fn`` applied to every array or tensor leaf of a batch (tuples,
    named tuples, lists and dicts); other leaves pass unchanged."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_batch(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_batch(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_batch(fn, v) for k, v in tree.items()}
    return tree


def _to_device(tree, device: torch.device):
    def put(t):
        if isinstance(t, np.ndarray):  # a host batch straight from the loader
            t = torch.from_numpy(t)
        return t.to(device, non_blocking=True)

    return _map_batch(put, tree)


def _microbatches(batch, n: int) -> list:
    """``n`` microbatches of ``batch``, consecutive slices along dim 0 of
    every tensor (the JAX trainer's reshape to ``(n, B // n, ...)``)."""
    leaves = []
    _map_batch(leaves.append, batch)
    local_bs = leaves[0].shape[0]
    if local_bs % n:
        raise ValueError(
            f"per-replica batch size {local_bs} is not divisible by "
            f"accum_steps={n}"
        )
    m = local_bs // n
    return [_map_batch(lambda t, i=i: t[i * m:(i + 1) * m], batch)
            for i in range(n)]


def _pack(tensors) -> list[tuple[list[torch.Tensor], torch.Tensor]]:
    """``(members, flat copy)`` for each dtype among ``tensors``: one
    concatenation a dtype."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        return [(ts, torch.cat([t.reshape(-1) for t in ts]))
                for ts in by_dtype.values()]


def _unpack_(packed) -> None:
    """Copy each flat buffer of :func:`_pack` back into its members."""
    with torch.no_grad():
        for ts, flat in packed:
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def _grads_for_all_reduce(params, world: int) -> list[torch.Tensor]:
    """The gradients of ``params`` to all-reduce. At world > 1 a parameter
    that requires grad but got none on this rank (its loss did not reach
    it) gets a zero gradient, so all ranks send buffers of one size (the
    JAX trainers' gradients cover every parameter too)."""
    if world > 1:
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    return [p.grad for p in params if p.grad is not None]


def _named_state(model: nn.Module) -> dict:
    """``{"params": ..., "rest": ...}``: copies of the parameters and of
    every buffer, by name."""
    with torch.no_grad():
        return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
                "rest": {n: b.detach().clone() for n, b in model.named_buffers()
                         if b is not None}}


def _load_named_state_(model: nn.Module, params: dict, rest: dict,
                       label: str = "") -> None:
    """Copy ``params`` and ``rest`` (name -> tensor) into ``model`` in
    place; raises ``ValueError`` when the names or a shape are not the
    model's (``label`` prefixes the part's name in the message)."""
    for part, got, live in (
            ("params", params, dict(model.named_parameters())),
            ("rest", rest, {n: b for n, b in model.named_buffers() if b is not None})):
        if set(got) != set(live):
            raise ValueError(
                f"{label}{part} mismatch: the checkpoint's names differ from "
                f"the model's (only in the checkpoint: "
                f"{sorted(set(got) - set(live))[:4]}; only in the model: "
                f"{sorted(set(live) - set(got))[:4]})"
            )
        for name, t in live.items():
            if tuple(got[name].shape) != tuple(t.shape):
                raise ValueError(
                    f"{label}{part} {name}: shape {tuple(got[name].shape)} in "
                    f"the checkpoint, {tuple(t.shape)} in the model")
        with torch.no_grad():
            for name, t in live.items():
                t.copy_(got[name])


def _remat_contexts():
    """``checkpoint``'s ``context_fn``: nothing around the first forward,
    and BN buffer writes off around its recomputation."""
    from tpu_syncbn_torch.nn.normalization import recomputing

    return contextlib.nullcontext(), recomputing()


class DataParallel:
    """Data-parallel training of ``model`` — the recipe's DDP wrap.

    ``loss_fn(model, batch)`` returns a scalar local-mean loss or
    ``(loss, metrics_dict)``. ``batch`` is this replica's shard (the
    DistributedSampler gives each rank its own indices).

    ``broadcast_buffers`` (default ``"auto"``): ``True`` broadcasts the
    buffers from rank 0 after every step (DDP's default), ``False`` keeps
    them per replica, and ``"auto"`` skips the broadcast when every
    buffer is a full-group SyncBatchNorm's (identical by construction) and
    broadcasts otherwise.

    ``accum_steps > 1`` is DDP's ``no_sync()`` pattern: this replica's
    batch splits into ``accum_steps`` microbatches along dim 0 (it must
    divide), each runs forward and backward in turn (BN buffers move once
    a microbatch, in order), gradients accumulate locally, and ONE
    all-reduce at the end averages them over microbatches and replicas.
    The step's loss and metrics are the mean over microbatches.

    ``remat=True`` recomputes the forward during backward
    (``torch.utils.checkpoint`` around the whole ``loss_fn``, as the JAX
    trainer wraps the whole loss in ``jax.checkpoint``): the step's
    numbers are unchanged, the forward runs twice (SyncBN's statistics
    and their all-reduce included), and the recomputation writes no BN
    buffer, so running statistics move once a step.

    ``divergence_guard`` (default ``None``) arms the non-finite guard:
    every step computes a world-consensus "loss and all gradients finite"
    flag (each replica's flag over its accumulated local gradients,
    reduced with MIN over the group, AND the replica-mean loss finite). A
    non-finite step never reaches the weights: the optimizer step and the
    scheduler step are not taken (parameters, momentum buffers and step
    counts stay as they were) and the BN buffers are restored from a copy
    taken before the forward. ``"skip_step"`` does nothing else;
    ``"halve_lr"`` also halves a persistent ``lr_scale`` that multiplies
    every later update (each group's ``lr`` is scaled for the step and put
    back after it); ``"restore_last_good"`` skips like ``"skip_step"``
    (the host loop that reloads the last verified checkpoint is not
    ported). The step's metrics gain ``nonfinite`` (1.0 on a skipped
    step) and ``lr_scale`` (its value before the step); the guard state
    ``{"lr_scale", "nonfinite_count"}`` persists in :meth:`state_dict`.
    Unlike the JAX trainer, which selects old against new state on the
    device, the port reads the flag on the host, once a step and only
    when the guard is armed: a device-side select would copy the
    parameters and optimizer state every step.

    ``lr_scheduler`` (a ``torch.optim.lr_scheduler`` over ``optimizer``)
    is stepped by the trainer after each optimizer step it takes, so a
    skipped step does not advance it and a checkpoint carries it.

    The model's parameters and buffers must already be on ``device``
    (default ``"cuda"``, which raises without a card)."""

    def __init__(
        self,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        loss_fn: Callable[[nn.Module, Any], Any],
        *,
        process_group=None,
        broadcast_buffers: bool | str = "auto",
        accum_steps: int = 1,
        remat: bool = False,
        divergence_guard: str | None = None,
        lr_scheduler=None,
        device: str | torch.device | None = "cuda",
    ):
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        if divergence_guard not in GUARD_POLICIES:
            raise ValueError(
                "divergence_guard must be None, 'skip_step', 'halve_lr', "
                f"or 'restore_last_good', got {divergence_guard!r}"
            )
        if broadcast_buffers not in (True, False, "auto"):
            raise ValueError(
                "broadcast_buffers must be True, False, or 'auto', got "
                f"{broadcast_buffers!r}"
            )
        self.device = resolve_device(device)
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if t is not None and t.device != self.device:
                raise ValueError(
                    f"{name} lives on {t.device}, not on the trainer's "
                    f"device {self.device}; move the model first"
                )
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.accum_steps = accum_steps
        self.remat = remat
        self.divergence_guard = divergence_guard
        self.lr_scheduler = lr_scheduler
        #: the guard's persistent state (checkpointed with the optimizer's)
        self.guard_state = {"lr_scale": 1.0, "nonfinite_count": 0}
        self.group = process_group if process_group is not None else _default_group()
        #: replicas the gradients average over
        self.world = collectives.world_size(self.group)
        if broadcast_buffers == "auto":
            self._per_step_broadcast = not _stats_replicated_by_construction(
                model, self.group)
        else:
            self._per_step_broadcast = bool(broadcast_buffers)
        self.broadcast_buffers = broadcast_buffers
        sync_module_states(model, group=self.group)

    def _split(self, out):
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        return loss, dict(metrics)

    def _replica_mean(self, loss, metrics):
        """Loss and metrics averaged over replicas, in one all-reduce."""
        if self.world == 1:
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}
        keys = list(metrics)
        vals = torch.stack([loss.detach().float()]
                           + [metrics[k].detach().float() for k in keys])
        vals = collectives.pmean(vals, self.group)
        return vals[0], {k: vals[i + 1] for i, k in enumerate(keys)}

    def _forward_backward(self, batch):
        """Forward and backward of one (micro)batch; gradients accumulate
        into ``.grad``. Returns the detached loss and metrics."""
        if self.remat:
            out = checkpoint(self.loss_fn, self.model, batch,
                             use_reentrant=False, context_fn=_remat_contexts)
        else:
            out = self.loss_fn(self.model, batch)
        loss, metrics = self._split(out)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def _optimizer_step(self) -> None:
        """``optimizer.step()``, with every group's ``lr`` times the
        guard's ``lr_scale`` under ``"halve_lr"`` for this step only —
        the JAX trainer's scaled update, for SGD (momentum, Nesterov,
        weight decay) and Adam alike, since each update is linear in
        ``lr``."""
        scale = self.guard_state["lr_scale"]
        if self.divergence_guard != "halve_lr" or scale == 1.0:
            self.optimizer.step()
            return
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        for g, lr in zip(self.optimizer.param_groups, lrs):
            g["lr"] = lr * scale
        try:
            self.optimizer.step()
        finally:
            for g, lr in zip(self.optimizer.param_groups, lrs):
                g["lr"] = lr

    def train_step(self, batch) -> StepOutput:
        """One optimizer step on this replica's shard of the batch."""
        batch = _to_device(batch, self.device)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        buffers = [b for b in self.model.buffers() if b is not None]
        guarded = self.divergence_guard is not None
        before = _pack(buffers) if guarded else None
        if self.accum_steps == 1:
            loss, metrics = self._forward_backward(batch)
        else:
            outs = [self._forward_backward(mb)
                    for mb in _microbatches(batch, self.accum_steps)]
            loss = torch.stack([l_ for l_, _ in outs]).mean(dtype=torch.float32)
            metrics = {k: torch.stack([m[k] for _, m in outs]).mean(dtype=torch.float32)
                       for k in outs[0][1]}
        # DDP gradient averaging: one flat all-reduce per dtype
        grads = _grads_for_all_reduce(
            [p for p in self.model.parameters() if p.requires_grad], self.world)
        if guarded:
            finite = torch.stack(
                [flat.isfinite().all() for _, flat in _pack(grads)]).all()
            agreed = collectives.pmin(finite.to(torch.int32), self.group) > 0
        loss, metrics = self._replica_mean(loss, metrics)
        # the guard's one host read a step
        ok = bool(agreed & torch.isfinite(loss)) if guarded else True
        if ok:
            if self.world > 1:
                collectives.psum_flat_(
                    grads, self.group, scale=1.0 / (self.world * self.accum_steps))
            elif self.accum_steps > 1:
                torch._foreach_mul_(grads, 1.0 / self.accum_steps)
            self._optimizer_step()
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
        else:
            _unpack_(before)  # the forward's buffer writes never happened
        if self._per_step_broadcast:
            collectives.broadcast_(buffers, self.group)
        if guarded:
            lr_scale = self.guard_state["lr_scale"]
            if not ok:
                self.guard_state["nonfinite_count"] += 1
                if self.divergence_guard == "halve_lr":
                    self.guard_state["lr_scale"] = lr_scale * 0.5
            metrics["nonfinite"] = torch.tensor(0.0 if ok else 1.0, device=self.device)
            metrics["lr_scale"] = torch.tensor(lr_scale, device=self.device)
        return StepOutput(loss=loss, metrics=metrics)

    def eval_step(self, batch) -> StepOutput:
        """Loss and metrics in eval mode (running statistics, no
        collective inside the model); the train/eval flag is restored."""
        batch = _to_device(batch, self.device)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                loss, metrics = self._split(self.loss_fn(self.model, batch))
        finally:
            self.model.train(was_training)
        loss, metrics = self._replica_mean(loss, metrics)
        return StepOutput(loss=loss, metrics=metrics)

    # -- checkpointing ----------------------------------------------------

    def state_dict(self) -> dict:
        """Full training state, as copies: ``params`` and ``rest`` (every
        buffer) by name, and ``opt_state`` with the optimizer's
        ``state_dict()``, the scheduler's when the trainer owns one, and
        the guard state when it is armed — feed it to
        ``utils.checkpoint.save_checkpoint`` on the master. The copies stay
        valid while later steps update the live tensors in place."""
        opt_state = {"optimizer": copy.deepcopy(self.optimizer.state_dict())}
        if self.lr_scheduler is not None:
            opt_state["lr_scheduler"] = copy.deepcopy(self.lr_scheduler.state_dict())
        if self.divergence_guard is not None:
            opt_state["guard"] = dict(self.guard_state)
        return {**_named_state(self.model), "opt_state": opt_state}

    def load_state_dict(self, state: dict) -> None:
        """Restore a tree produced by :meth:`state_dict` (or loaded from a
        checkpoint), placing every tensor on the trainer's device; nothing
        is broadcast (every rank loads the same checkpoint). Raises
        ``ValueError`` when the checkpoint's structure is not this
        trainer's."""
        opt_state = state["opt_state"]
        want = {"optimizer"}
        if self.lr_scheduler is not None:
            want.add("lr_scheduler")
        if self.divergence_guard is not None:
            want.add("guard")
        if set(opt_state) != want:
            raise ValueError(
                "opt_state structure mismatch: this checkpoint was saved "
                "by a trainer with a different optimizer, lr_scheduler or "
                f"divergence_guard setting than this one (it holds "
                f"{sorted(opt_state)}, this trainer {sorted(want)}). Rebuild "
                "the trainer with the same settings to resume the optimizer "
                "state."
            )
        _load_named_state_(self.model, state["params"], state["rest"])
        # a copy: torch's load keeps the given tensors where their dtype
        # and device already fit, and the next step would then update the
        # caller's state in place
        self.optimizer.load_state_dict(copy.deepcopy(opt_state["optimizer"]))
        if self.lr_scheduler is not None:
            self.lr_scheduler.load_state_dict(opt_state["lr_scheduler"])
        if self.divergence_guard is not None:
            self.guard_state = {
                "lr_scale": float(opt_state["guard"]["lr_scale"]),
                "nonfinite_count": int(opt_state["guard"]["nonfinite_count"]),
            }


def resume_latest(trainer, directory: str) -> int:
    """Restore ``trainer`` from the newest *verified* checkpoint in
    ``directory`` (manifest-certified; corrupt or truncated candidates are
    skipped by ``utils.checkpoint.load_checkpoint``'s fallback walk).
    Returns the restored step, or 0 when the directory holds no
    checkpoints at all — "first boot or resume, the caller does not care
    which"::

        dp = DataParallel(model, opt, loss_fn)
        start = resume_latest(dp, ckpt_dir)   # 0 on first boot
        for step in range(start, total_steps): ...

    A directory where every candidate fails verification raises
    ``CheckpointCorruptError``: that is an operator's problem, not a
    fresh start."""
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    try:
        state, step = ckpt.load_checkpoint(directory, trainer.state_dict())
    except FileNotFoundError:
        return 0
    trainer.load_state_dict(state)
    dist.get_logger("tpu_syncbn_torch.resilience").info(
        "resumed from verified checkpoint step %d in %s", step, directory)
    return step
