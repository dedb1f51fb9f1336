"""Data-parallel trainer — the main-path subset of
``tpu_syncbn.parallel.trainer`` (``StepOutput``, ``DataParallel``).

One process per GPU, each with its local shard of the batch. A step is
forward, local-mean loss, backward, ONE flat all-reduce of every gradient
divided by the world size (skipped at world 1), then the optimizer step:
with equal shards the update equals single-device large-batch SGD, DDP's
contract. The user brings a ``torch.optim`` optimizer over the model's
parameters; ``optax.sgd(lr, momentum=0.9)`` of the JAX package is
``torch.optim.SGD(params, lr, momentum=0.9)`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn

from tpu_syncbn_torch.parallel import collectives
from tpu_syncbn_torch.runtime.distributed import resolve_device


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


def _to_device(tree, device: torch.device):
    if isinstance(tree, np.ndarray):  # a host batch straight from the loader
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(t, device) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


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
        device: str | torch.device | None = "cuda",
    ):
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

    def train_step(self, batch) -> StepOutput:
        """One optimizer step on this replica's shard of the batch."""
        batch = _to_device(batch, self.device)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._split(self.loss_fn(self.model, batch))
        loss.backward()
        if self.world > 1:
            # DDP gradient averaging: one flat all-reduce per dtype. Every
            # parameter that requires grad takes part, zero-filled where
            # this rank's loss did not reach it, so all ranks send buffers
            # of one size (the JAX trainer's gradients cover every
            # parameter too)
            for p in self.model.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.model.parameters() if p.requires_grad]
            collectives.psum_flat_(grads, self.group, scale=1.0 / self.world)
        self.optimizer.step()
        if self._per_step_broadcast:
            collectives.broadcast_(
                [b for b in self.model.buffers() if b is not None], self.group)
        loss, metrics = self._replica_mean(loss, metrics)
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
