"""Data-parallel trainer — the counterpart of
``tpu_syncbn.parallel.trainer`` (``StepOutput``, ``DataParallel`` with
``accum_steps``, ``remat``, ``divergence_guard``, the compressed gradient
all-reduce with error feedback, ZeRO and the ``SpecLayout`` layouts, its
state dict and its K-step entry points, and ``resume_latest``).

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
import functools
import time
import types
import warnings
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_syncbn_torch.obs import numerics as obs_numerics, stepstats as obs_stepstats
from tpu_syncbn_torch.parallel import collectives, scan_driver
from tpu_syncbn_torch.parallel.scan_driver import _map as _map_batch
from tpu_syncbn_torch.runtime import distributed as dist
from tpu_syncbn_torch.runtime.distributed import resolve_device

GUARD_POLICIES = (None, "skip_step", "halve_lr", "restore_last_good")


def check_monitors(monitors) -> None:
    if monitors not in (True, False, "full"):
        raise ValueError(
            f"monitors must be True, False, or 'full', got {monitors!r}")


@dataclasses.dataclass
class StepOutput:
    """What a step returns: the replica-averaged loss and metrics, as
    device tensors (reading a value waits for the step). ``monitors``
    holds the on-device health scalars (``DataParallel(monitors=)``), also
    device tensors, ``{}`` with monitors off."""

    loss: torch.Tensor
    metrics: dict[str, torch.Tensor]
    monitors: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


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


def _rewire_syncbn_groups(model: nn.Module, group) -> None:
    """Point every default-group SyncBatchNorm at a composed layout's
    batch group: statistics sync over ALL batch replicas, and a composed
    layout shards the batch over more than one mesh axis. Modules given a
    process group of their own are left alone; a group-scoped one
    (``group_size``) raises, as the JAX trainer's does."""
    from tpu_syncbn_torch.nn.normalization import SyncBatchNorm

    for module in model.modules():
        if isinstance(module, SyncBatchNorm) and module.process_group is None:
            if module.group_size is not None:
                raise ValueError(
                    "group-scoped SyncBN cannot ride a composed layout: "
                    "the butterfly group reduction is single-axis "
                    f"(module syncs groups of {module.group_size})"
                )
            module.process_group = group


def _resolve_layout(layout, mesh, zero: bool, process_group, device):
    """The trainer's ``SpecLayout``, resolved as the JAX trainer resolves
    it: none given is ``data_parallel()`` (``None`` here: built on first
    read of ``DataParallel.layout``), or ``zero()`` when ``zero``; a mesh
    alone is adopted. ``process_group`` is the 1-D surface and takes no
    layout."""
    from tpu_syncbn_torch.parallel.layout import SpecLayout

    if process_group is not None and (layout is not None or mesh is not None or zero):
        raise ValueError(
            "process_group= is the 1-D data-parallel surface: pass a layout "
            "(or zero=True, or mesh=) without it — the layout owns the groups")
    if layout is None:
        if mesh is not None:
            return SpecLayout.from_mesh(
                mesh, param_shard_axis="data" if zero else "auto", device=device)
        if zero:
            return SpecLayout.zero(device=device)
        return None
    if mesh is not None and mesh is not layout.mesh:
        raise ValueError(
            "pass either layout= or mesh=, not both — the layout "
            "owns the mesh"
        )
    if zero and layout.param_shard_axis is None:
        raise ValueError(
            "zero=True needs a param-sharding layout: use "
            "SpecLayout.zero() or SpecLayout.fsdp()"
        )
    if layout.device != device:
        raise ValueError(f"the layout's mesh is on {layout.device.type}, the "
                         f"trainer on {device.type}")
    return layout


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


def _grads_for_all_reduce(params, fill: bool) -> list[torch.Tensor]:
    """The gradients of ``params`` to all-reduce. With ``fill`` (at world
    > 1, and on a compressed wire, whose fused payload has a fixed layout)
    a parameter that requires grad but got none on this rank (its loss did
    not reach it) gets a zero gradient, so all ranks send buffers of one
    size (the JAX trainers' gradients cover every parameter too)."""
    if fill:
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


# -- the K-step body's pieces -------------------------------------------------


def _scalar_dtype() -> torch.dtype:
    """The dtype torch's Adam keeps its step count in."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


def _schedule_lrs(optimizer, scheduler, k: int) -> list[list[float]]:
    """Each group's learning rate for the next ``k`` optimizer steps, as
    ``k`` rows: the current ``lr``, then the scheduler stepped on a saved
    state (both put back afterwards)."""
    groups = optimizer.param_groups
    rows = [[float(g["lr"]) for g in groups]]
    if scheduler is None or k == 1:
        return rows * k
    saved = copy.deepcopy(scheduler.state_dict())
    lrs = [g["lr"] for g in groups]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "step() before optimizer.step()"
            for _ in range(k - 1):
                scheduler.step()
                rows.append([float(g["lr"]) for g in groups])
    finally:
        scheduler.load_state_dict(saved)
        for g, lr in zip(groups, lrs):
            g["lr"] = lr
    return rows


def _advance_scheduler(scheduler, n: int) -> None:
    """``scheduler.step()`` ``n`` times after a chunk (its steps were
    taken inside the graph, not by ``optimizer.step()``)."""
    if scheduler is None:
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(n):
            scheduler.step()


class _ChunkOptimizer:
    """An optimizer's update as the K-step body applies it: the update of
    ``optimizer.step()``, with each step's learning rate read from the
    static ``(K, groups)`` device tensor :attr:`lrs` (written by the host
    before each chunk), so a captured graph follows a schedule instead of
    baking in the rate it was recorded with.

    * ``torch.optim.SGD`` (momentum, dampening, Nesterov, weight decay,
      maximize): torch's multi-tensor update op for op, except the last
      one: ``param -= lr · d`` multiplies by the lr tensor and then adds,
      where torch adds with a Python ``alpha`` (a host read of a tensor
      lr). The two differ by at most one rounding. Missing momentum
      buffers are made as zeros before the first chunk; with dampening
      a per-group device flag ``first`` gives torch's undamped first
      step (buffer = gradient).
    * ``torch.optim.Adam`` / ``AdamW``: ``optimizer.step()`` with each
      group's ``lr`` a device tensor. On the card every group becomes
      ``capturable`` (its step counts live on the device, where the
      graph updates them); its state is made before the first chunk as
      torch's first step makes it.
    * Any other optimizer raises ``ValueError``."""

    def __init__(self, optimizer, n_steps: int, device: torch.device,
                 first: torch.Tensor | None):
        if isinstance(optimizer, torch.optim.SGD):
            self.kind = "sgd"
        elif isinstance(optimizer, torch.optim.Adam):
            self.kind = "adam"
        else:
            raise ValueError(
                f"train_steps supports torch.optim.SGD, Adam and AdamW, not "
                f"{type(optimizer).__name__}: the K-step body must take each "
                "step's learning rate from the device")
        self.optimizer = optimizer
        groups = optimizer.param_groups
        for g in groups:
            if g.get("fused") or g.get("differentiable"):
                raise ValueError(
                    f"train_steps: {type(optimizer).__name__} with fused or "
                    "differentiable=True is not supported")
        self.lrs = torch.zeros((n_steps, len(groups)), dtype=torch.float32,
                               device=device)
        state = optimizer.state
        self.first = first
        if self.kind == "sgd":
            fresh = []
            for g in groups:
                missing = False
                if g["momentum"] != 0:
                    for p in g["params"]:
                        if p.requires_grad and state[p].get("momentum_buffer") is None:
                            state[p]["momentum_buffer"] = torch.zeros_like(
                                p, memory_format=torch.preserve_format)
                            missing = True
                fresh.append(1.0 if missing else 0.0)
            if self.first is None and any(g["dampening"] != 0 for g in groups):
                self.first = torch.tensor(fresh, dtype=torch.float32, device=device)
        else:
            capturable = device.type == "cuda"
            self.slot = torch.zeros(len(groups), dtype=torch.float32, device=device)
            for g in groups:
                if capturable:
                    g["capturable"] = True
                for p in g["params"]:
                    if not p.requires_grad:
                        continue
                    st = state[p]
                    if not st:
                        st["step"] = (torch.zeros((), dtype=_scalar_dtype(), device=p.device)
                                      if capturable else torch.tensor(0.0, dtype=_scalar_dtype()))
                        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                        st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                        if g["amsgrad"]:
                            st["max_exp_avg_sq"] = torch.zeros_like(
                                p, memory_format=torch.preserve_format)
                    elif capturable and st["step"].device != p.device:
                        st["step"] = st["step"].to(device=p.device, dtype=_scalar_dtype())

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor of the optimizer's state, in a fixed order (and the
        first-step flags), which the body updates in place."""
        out = []
        for g in self.optimizer.param_groups:
            for p in g["params"]:
                st = self.optimizer.state.get(p, {})
                out += [v for _, v in sorted(st.items()) if isinstance(v, torch.Tensor)]
        if self.first is not None:
            out.append(self.first)
        return out

    def fill(self, rows) -> None:
        """Write the chunk's ``(K, groups)`` learning rates (host floats)
        into :attr:`lrs` without waiting for the device."""
        src = torch.tensor(rows, dtype=torch.float32)
        if self.lrs.is_cuda:
            src = src.pin_memory()  # freed only after the copy ran
        self.lrs.copy_(src, non_blocking=True)

    @torch.no_grad()
    def step(self, lr: torch.Tensor) -> None:
        """One update with the ``(groups,)`` device learning rates ``lr``."""
        if self.kind == "adam":
            self.slot.copy_(lr)
            groups = self.optimizer.param_groups
            saved = [g["lr"] for g in groups]
            for i, g in enumerate(groups):
                g["lr"] = self.slot[i]
            try:
                self.optimizer.step()
            finally:
                for g, v in zip(groups, saved):
                    g["lr"] = v
            return
        for i, g in enumerate(self.optimizer.param_groups):
            params = [p for p in g["params"] if p.grad is not None]
            if params:
                self._sgd(i, g, params, [p.grad for p in params], lr[i])

    def _sgd(self, i, g, params, grads, lr) -> None:
        wd, m, d = g["weight_decay"], g["momentum"], g["dampening"]
        if g["maximize"]:
            grads = torch._foreach_neg(grads)
        if wd != 0:
            if g["maximize"]:
                torch._foreach_add_(grads, params, alpha=wd)
            else:
                grads = torch._foreach_add(grads, params, alpha=wd)
        if m != 0:
            bufs = [self.optimizer.state[p]["momentum_buffer"] for p in params]
            torch._foreach_mul_(bufs, m)
            if d == 0:
                torch._foreach_add_(bufs, grads)
            else:
                first = self.first[i]
                torch._foreach_add_(bufs, torch._foreach_mul(
                    grads, torch.where(first > 0, 1.0, 1.0 - d)))
                first.zero_()
            if g["nesterov"]:
                torch._foreach_add_(grads, bufs, alpha=m)
            else:
                grads = bufs
        torch._foreach_add_(params, torch._foreach_mul(grads, -lr))


def _check_capturable(device: torch.device, world: int, group) -> None:
    """On the card at world > 1 a K-step program holds the collectives in
    its graph: only NCCL's can be captured."""
    if device.type == "cuda" and world > 1:
        backend = tdist.get_backend(group)
        if backend != "nccl":
            raise RuntimeError(
                f"train_steps on CUDA tensors at world {world} needs an NCCL "
                f"process group, not {backend!r}: {backend}'s collectives wait "
                "on the host and cannot run inside a CUDA graph (train_step "
                "runs the eager loop)")


def _select_(ok: torch.Tensor, live: list, old: list) -> None:
    """In place: each live tensor keeps its new value where ``ok`` and
    takes back its old one otherwise (``jnp.where`` never passes the
    not-taken side's NaNs on)."""
    with torch.no_grad():
        for t, o in zip(live, old):
            t.copy_(torch.where(ok, t, o))


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
    :meth:`train_step` reads the flag on the host, once a step and only
    when the guard is armed (a device-side select would copy the
    parameters and optimizer state every step); the K-step entry points
    select old against new state on the device, as the JAX trainer does.

    ``lr_scheduler`` (a ``torch.optim.lr_scheduler`` over ``optimizer``)
    is stepped by the trainer after each optimizer step it takes, so a
    skipped step does not advance it and a checkpoint carries it.

    :meth:`train_steps` and :meth:`train_steps_batches` run K steps as
    one program (``parallel.scan_driver``): on the card, K applications
    of the step body captured into one CUDA graph and replayed once a
    chunk; on the CPU, the same body K times. They take
    ``torch.optim.SGD``, ``Adam`` and ``AdamW`` (:class:`_ChunkOptimizer`)
    and any scheduler but ``ReduceLROnPlateau``; at world > 1 on the card
    the group must be NCCL's (gloo's collectives wait on the host, which
    a graph cannot hold).

    ``compress`` (default ``"none"``) puts the gradient all-reduce on a
    compressed wire (``collectives.compressed_pmean``): ``"bf16"`` halves
    the bytes, ``"int8"`` quarters them (chunk-quantized on a range shared
    by the world, ``ops.quant_int8``'s kernels on the card). The arithmetic
    runs at every world size, world 1 included, where only the wire call
    is skipped (the JAX trainer quantizes on a mesh of one too). Under a
    lossy mode the step's loss and metrics ride bf16 as well (reporting
    scalars); the guard's finiteness consensus, SyncBN's count and
    :meth:`eval_step` stay exact, and SyncBN's moments compress only by
    their own ``stats_compress``. ``grad_compression="bf16"`` is the
    legacy stateless hook (DDP's ``bf16_compress_hook``: gradients cast to
    bf16 for the mean and back); it excludes ``compress``.

    ``error_feedback`` (default: on for ``"int8"``, off for ``"bf16"``;
    ``True`` with ``"none"`` raises) keeps a per-replica f32 residual:
    each replica reduces ``gradients + residual`` and keeps its own
    quantization error for the next step (``collectives.ef_compressed_pmean``).
    The int8 payload fuses the gradients of every parameter that requires
    grad in ``named_parameters()`` order, each in its logical contiguous
    order, in chunks of 256 (the JAX trainer fuses its leaves in
    ``jax.tree_util`` order with JAX layouts, so the two fill chunks with
    other elements: their int8 grids differ while the function is the
    same). The residual is the trainer's own state (one flat f32 buffer
    of that payload, one gradient's size): a guarded skip keeps it, it
    rides the K-step programs' state (selected on the device under the
    guard), :meth:`state_dict` carries it per parameter (this replica's:
    a checkpoint saved by the master gives every rank the master's
    residual, where the JAX checkpoint stores one row a replica),
    :meth:`reset_compression_residual` zeroes it, and
    ``ResilientLoop``'s ``restore_last_good`` calls that.
    :meth:`set_compress` switches the wire mode between steps.

    ``zero=True`` and ``layout=`` (a :class:`~tpu_syncbn_torch.parallel.layout.SpecLayout`;
    ``mesh=`` adopts a ``DeviceMesh`` instead) shard the weight update, as
    the JAX trainer does (ZeRO; beyond DDP, which replicates parameters
    and optimizer state). No layout is ``SpecLayout.data_parallel()``, or
    ``SpecLayout.zero()`` with ``zero=True``; ``SpecLayout.fsdp(data=,
    fsdp=)`` composes DP×FSDP: the batch sharded over both axes (SyncBN
    layers on the default group are rewired to the composed batch group,
    a group-scoped one raises), the update sharded over ``fsdp``.
    ``process_group=`` is the 1-D surface and excludes all three; a layout
    with tensor-parallel ``rules`` raises ``NotImplementedError``: JAX's
    compiler partitions any model around such rules, and the port waits on
    a design (ROADMAP 10d: storage gathered by spec, or a rewrite into
    ``parallel/tensor.py``'s layers). Under a sharding layout:

    * one flat shard a dtype (:class:`~tpu_syncbn_torch.parallel.zero.FlatLayout`
      over the trainable parameters in ``named_parameters()`` order, padded
      to the shard world) is the canonical parameter state. The user's
      optimizer is rebound in place — its one param group's ``params``
      become the shards (``nn.Parameter``) and its state is cleared, so an
      ``lr_scheduler`` keeps working and Adam's moments are born
      1/``shard_world``. It must be elementwise (``zero.check_elementwise``);
    * a step: local gradients (``accum_steps``, ``remat`` as ever), the
      guard's consensus on them, the flatten, then per dtype one
      reduce-scatter over the shard group (``grad_compression="bf16"``: in
      bf16; ``compress=``: ``collectives.compressed_reduce_scatter``, one
      int8 chunk a shard, with a per-replica residual of the padded length
      under error feedback, which covers the scatter stage only), a sum
      over the cross axes when composed, ``/ replica_world``; the optimizer
      step on the shards; then one all-gather a dtype writes the full
      parameters back into the module, which is never stale for
      :meth:`eval_step`, :meth:`state_dict` or a user's read. Freeing the
      full parameters between steps (ZeRO-3 storage) is not done;
    * :meth:`state_dict` holds the optimizer state as full padded flat
      vectors (gathered to every rank), and :meth:`load_state_dict`
      rejects a zero-mode or shard-world mismatch with the JAX messages.

    ``monitors`` (default ``True``, as in the JAX trainer) computes health
    scalars on the step's own tensors and returns them as device tensors in
    ``StepOutput.monitors`` (``obs.stepstats``, ``obs.numerics``; no
    ``.item()``, no synchronize):

    * ``grad_norm`` / ``grad_nonfinite`` over the averaged gradients (under
      a sharding layout over the shards, with one scalar all-reduce over
      the shard group);
    * ``state_nonfinite``, ``bn_layers``, ``bn_mean_max_abs``,
      ``bn_var_max``, ``bn_var_min`` over the buffers after the step
      (reduced to the worst replica with ``broadcast_buffers=False``);
    * the numerics family, each the replica mean through ONE all-reduce of
      their stacked vector: ``bn_mean_skew`` / ``bn_var_skew`` (each SyncBN
      layer's local moments against the synced ones, the worst layer and
      microbatch) with ``bn_skew_layers``, ``replica_grad_norm`` (the local
      gradients' norm before the reduction) and its dispersion
      ``replica_grad_norm_disp``, and on the int8 wire ``clip_fraction`` and
      ``overflow_headroom``, with error feedback ``ef_residual_ratio``.

    ``"full"`` adds ``bn_var_min<path>`` / ``bn_mean_max_abs<path>`` per BN
    layer; ``False`` gives ``{}``; any other value raises ``ValueError``.
    The K-step entry points return each monitor stacked to ``(K,)``. On a
    step the guard skips, :meth:`train_step`'s gradients were never
    reduced, so its gradient monitors describe this replica's local
    gradients (and carry no compression keys).

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
        grad_compression: str | None = None,
        compress: str = "none",
        error_feedback: bool | None = None,
        zero: bool = False,
        layout=None,
        mesh=None,
        monitors: bool | str = True,
        device: str | torch.device | None = "cuda",
    ):
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        check_monitors(monitors)
        if grad_compression not in (None, "bf16"):
            raise ValueError(
                f"grad_compression must be None or 'bf16', got {grad_compression!r}")
        collectives.check_compress_mode(compress)
        if grad_compression is not None and compress != "none":
            raise ValueError(
                "grad_compression (legacy bf16 hook) and compress are "
                "mutually exclusive — use compress='bf16'")
        if error_feedback and compress == "none":
            raise ValueError(
                "error_feedback=True needs a lossy compress mode "
                "('bf16'/'int8') — there is no compression error to "
                "feed back on the exact fp32 wire")
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
        self._layout = _resolve_layout(layout, mesh, zero, process_group, self.device)
        if self._layout is not None:
            if self._layout.rules:
                raise NotImplementedError(
                    "DataParallel with tensor-parallel rules waits on a design "
                    "(ROADMAP 10d): storage gathered by spec, or a module rewrite "
                    "into parallel/tensor.py's layers")
            self._layout.check(compress=compress)
            if isinstance(self._layout.stat_axes, tuple):
                _rewire_syncbn_groups(model, self._layout.batch_group())
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.monitors = monitors
        self.accum_steps = accum_steps
        self.remat = remat
        self.divergence_guard = divergence_guard
        self.lr_scheduler = lr_scheduler
        #: the guard's persistent state (checkpointed with the optimizer's)
        self.guard_state = {"lr_scale": 1.0, "nonfinite_count": 0}
        if self._layout is not None:
            self.group = self._layout.batch_group()
        else:
            self.group = process_group if process_group is not None else _default_group()
        self._legacy_group = process_group is not None
        #: replicas the gradients average over
        self.world = collectives.world_size(self.group)
        #: whether the weight update is sharded (ZeRO / FSDP)
        self.zero = self._layout is not None and self._layout.param_shard_axis is not None
        if broadcast_buffers == "auto":
            self._per_step_broadcast = not _stats_replicated_by_construction(
                model, self.group)
        else:
            self._per_step_broadcast = bool(broadcast_buffers)
        self.broadcast_buffers = broadcast_buffers
        sync_module_states(model, group=self.group)
        self.compress = compress
        self.grad_compression = grad_compression
        #: whether an error-feedback residual is kept (fixed at
        #: construction; set_compress never changes it)
        self._ef = compress != "none" and (
            error_feedback if error_feedback is not None else compress == "int8")
        #: (name, parameter) of every parameter the gradients cover, in the
        #: fused payload's order
        self._trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        if self.zero:
            self._init_shards(optimizer)
        #: the error-feedback residual, this replica's own: one flat f32
        #: buffer over the fused payload, or under a sharding layout one a
        #: dtype over its padded flat vector ({dtype: buffer})
        self._residual = None
        if self._ef and self.zero:
            self._residual = {dt: torch.zeros(n if self._flat.dtypes[dt].is_floating_point
                                              else 0, dtype=torch.float32, device=self.device)
                              for dt, n in self._flat.padded.items()}
        elif self._ef:
            self._residual = torch.zeros(sum(p.numel() for _, p in self._trainable),
                                         dtype=torch.float32, device=self.device)
        # (n_steps, stacked, batch signature) -> captured K-step program
        self._train_steps_cache = scan_driver.ProgramCache(name="train")
        # the first eager step is a compile event (obs.profiling)
        self._first_dispatch_noted = False
        # compress mode -> its parked program cache (set_compress)
        self._mode_programs: dict[str, scan_driver.ProgramCache] = {}
        # SGD's first-step flags (dampening only), kept across programs
        self._first_flags: torch.Tensor | None = None

    @property
    def layout(self):
        """The trainer's :class:`~tpu_syncbn_torch.parallel.layout.SpecLayout`:
        the one given or resolved, else ``SpecLayout.data_parallel()`` over
        the default group (built on first read), or ``None`` on the
        ``process_group=`` surface."""
        if self._layout is None and not self._legacy_group:
            from tpu_syncbn_torch.parallel.layout import SpecLayout

            self._layout = SpecLayout.data_parallel(device=self.device)
        return self._layout

    # -- the sharded weight update (ZeRO / FSDP) --------------------------

    def _init_shards(self, optimizer) -> None:
        """The flat layout, this rank's shard of each dtype's vector as the
        canonical parameter state, and the user's optimizer rebound to the
        shards (its state cleared: it is born sharded)."""
        from tpu_syncbn_torch.parallel.zero import FlatLayout, check_elementwise

        check_elementwise(optimizer)
        group = optimizer.param_groups[0]
        if {id(p) for p in group["params"]} != {id(p) for _, p in self._trainable}:
            raise ValueError(
                "zero=True: the optimizer must cover exactly the model's trainable "
                "parameters (its one param group becomes their flat shards)")
        lay = self._layout
        self._shard_group = lay.group(lay.grad_scatter_axis)
        #: the cross axes' group, summed over after the scatter when composed
        self._cross_group = lay.group(lay.grad_cross_axes)
        self._shard_world = lay.shard_world
        self._shard_rank = collectives._rank(self._shard_group)
        self._flat = FlatLayout(dict(self._trainable), self._shard_world)
        with torch.no_grad():
            full = self._flat.flatten(dict(self._trainable))
            #: {dtype: this rank's contiguous 1/shard_world of its flat vector}
            self._shards = {
                dt: nn.Parameter(v.view(self._shard_world, -1)[self._shard_rank].clone())
                for dt, v in full.items()}
        group["params"] = list(self._shards.values())
        optimizer.state.clear()

    def _scatter_grads(self, grads) -> dict:
        """``{dtype: this rank's shard of the replica-mean gradient}`` of the
        local ``grads`` (trainable order), as the JAX trainer's ``scatter``:
        the reduce-scatter over the shard group (exact, bf16, or compressed
        with the residual), the cross axes' sum when composed, then the
        division by the replicas (a product with its f32 reciprocal)."""
        if self.accum_steps > 1:
            torch._foreach_mul_(grads, 1.0 / self.accum_steps)
        cross = bool(self._layout.grad_cross_axes)
        inv = 1.0 / self.world
        out = {}
        with torch.no_grad():
            for dt, g in self._flat.flatten(grads).items():
                if self.compress != "none" and g.is_floating_point():
                    p = g.to(torch.float32)
                    if self._ef:
                        p = p + self._residual[dt]
                    shard, res = collectives.compressed_reduce_scatter(
                        p, self._shard_group, mode=self.compress, want_residual=self._ef)
                    if self._ef:
                        self._residual[dt].copy_(res)
                    if cross:  # EF covers the scatter stage only
                        shard = collectives.compressed_psum(
                            shard, self._cross_group, mode=self.compress)
                    out[dt] = (shard * inv).to(g.dtype)
                    continue
                if self.grad_compression == "bf16":
                    g = collectives.reduce_scatter(
                        g.to(torch.bfloat16), self._shard_group).to(g.dtype)
                else:
                    g = collectives.reduce_scatter(g, self._shard_group)
                if cross:
                    g = collectives.psum(g, self._cross_group)
                out[dt] = g * inv
        return out

    def _gather_params(self) -> None:
        """One all-gather a dtype over the shard group; the full vectors
        written into the module's parameters (copies in logical order)."""
        with torch.no_grad():
            full = {dt: collectives.all_gather(s.detach(), self._shard_group, tiled=True)
                    for dt, s in self._shards.items()}
            views = self._flat.unflatten(full)
            for name, p in self._trainable:
                p.copy_(views[name])

    def _zero_grad(self) -> None:
        """Clear the gradients a step accumulates into: the optimizer's
        parameters', and under a sharding layout the module's too."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.zero:
            self.model.zero_grad(set_to_none=True)

    def _residuals(self) -> list[torch.Tensor]:
        """The error-feedback buffer(s), if any."""
        r = self._residual
        return [] if r is None else list(r.values()) if isinstance(r, dict) else [r]

    def _split(self, out):
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        return loss, dict(metrics)

    def _replica_mean(self, loss, metrics, lossy: bool = False):
        """Loss and metrics averaged over replicas, in one all-reduce; with
        ``lossy`` on the bf16 wire, at every world size (the training step
        under a lossy ``compress``)."""
        if self.world == 1 and not lossy:
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}
        keys = list(metrics)
        vals = torch.stack([loss.detach().float()]
                           + [metrics[k].detach().float() for k in keys])
        if lossy:
            vals = collectives.compressed_pmean(vals, self.group, mode="bf16")
        else:
            vals = collectives.pmean(vals, self.group)
        return vals[0], {k: vals[i + 1] for i, k in enumerate(keys)}

    def _fill_grads(self) -> bool:
        return (self.world > 1 or self.zero or self.compress != "none"
                or self.grad_compression is not None)

    def _reduce_grads_(self, grads) -> None:
        """Average ``grads`` over the replicas and the microbatches, in
        place: one flat exact all-reduce a dtype (none at world 1), or the
        compressed wire of ``compress`` (with the residual under error
        feedback) or of the legacy ``grad_compression`` hook."""
        if self.compress == "none" and self.grad_compression is None:
            if self.world > 1:
                collectives.psum_flat_(
                    grads, self.group, scale=1.0 / (self.world * self.accum_steps))
            elif self.accum_steps > 1:
                torch._foreach_mul_(grads, 1.0 / self.accum_steps)
            return
        if self.accum_steps > 1:
            torch._foreach_mul_(grads, 1.0 / self.accum_steps)
        with torch.no_grad():
            if self.grad_compression == "bf16":
                # bf16_compress_hook: the mean taken in bf16
                wire = torch.cat([g.reshape(-1).to(torch.bfloat16) for g in grads])
                mean = collectives.psum(wire, self.group) / self.world
            else:
                flat = collectives._fuse_f32(grads)
                mean = collectives._compressed_mean_flat(
                    flat, self.group, mode=self.compress,
                    logical=collectives._nbytes(grads), residual=self._residual)
            for g, part in zip(grads, mean.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    def _forward_backward(self, batch):
        """Forward and backward of one (micro)batch; gradients accumulate
        into ``.grad``. Returns the detached loss and metrics, and the
        numerics scalars the forward's SyncBN reductions recorded (``{}``
        with monitors off; the collector covers the forward only, so a
        remat recomputation records nothing)."""
        with obs_numerics.collect(enabled=bool(self.monitors)) as col:
            if self.remat:
                out = checkpoint(self.loss_fn, self.model, batch,
                                 use_reentrant=False, context_fn=_remat_contexts)
            else:
                out = self.loss_fn(self.model, batch)
        loss, metrics = self._split(out)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, col.summary()

    def _accumulate(self, batch):
        """Forward and backward of the batch, in ``accum_steps``
        microbatches whose gradients accumulate; the loss and metrics are
        their means, the numerics scalars their maxima (skew in any
        microbatch is drift)."""
        if self.accum_steps == 1:
            return self._forward_backward(batch)
        outs = [self._forward_backward(mb)
                for mb in _microbatches(batch, self.accum_steps)]
        loss = torch.stack([o[0] for o in outs]).mean(dtype=torch.float32)
        metrics = {k: torch.stack([o[1][k] for o in outs]).mean(dtype=torch.float32)
                   for k in outs[0][1]}
        return loss, metrics, obs_numerics.merge_max(*[o[2] for o in outs])

    def _reduce_and_update(self, grads, numx: dict, step: Callable[[], None],
                           reduce: bool = True) -> dict:
        """The gradient reduction, the gradient monitors, the update (with
        ``reduce=False``, a step the guard skips: the monitors only).
        ``grads`` are the local accumulated gradients in trainable order;
        ``numx`` gains the numerics scalars of the reduction (the local
        gradient norm before it, the int8 wire's health, the residual
        ratio). Returns the gradient monitors (``{}`` with monitors off)."""
        mon = bool(self.monitors)
        # alone on the exact wire the reduction at most scales by
        # 1/accum_steps, so the local norm is the reduced one
        alone = (self.world == 1 and not self.zero and self.compress == "none"
                 and self.grad_compression is None)
        if mon and not (alone and reduce):
            # per-replica norm BEFORE the reduction: the local half of the
            # dispersion monitor (of the microbatch mean, as JAX's)
            numx["replica_grad_norm"] = (obs_numerics.grad_norm_scalar(grads)
                                         / self.accum_steps)
        if not reduce:
            return obs_stepstats.grad_monitors(grads) if mon else {}
        # the compressed wire records its int8 clip fraction and overflow
        # headroom into this collector
        with obs_numerics.collect(enabled=mon) as ccol:
            if self.zero:
                shards = self._scatter_grads(grads)
            else:
                self._reduce_grads_(grads)
        monitors: dict = {}
        if mon:
            numx.update(ccol.summary())
            if self.zero:
                # shards only: one scalar all-reduce over the shard group
                # (the cross axes hold the reduced value replicated)
                monitors = obs_stepstats.grad_monitors(
                    list(shards.values()), self._shard_group, sharded=True)
            else:
                monitors = obs_stepstats.grad_monitors(grads)
            if alone:
                numx["replica_grad_norm"] = monitors["grad_norm"]
            if self._ef:
                numx["ef_residual_ratio"] = obs_numerics.residual_ratio(
                    self._residuals(), numx["replica_grad_norm"])
        if self.zero:
            for dt, g in shards.items():
                self._shards[dt].grad = g
            step()
            self._gather_params()
        else:
            step()
        return monitors

    def _finish_monitors(self, monitors: dict, numx: dict) -> dict:
        """The numerics family through ONE all-reduce, then the buffers'
        health (after the step's broadcast or restore)."""
        if not self.monitors:
            return {}
        if numx:
            monitors.update(obs_numerics.cross_replica_monitors(
                numx, self.group, disp_keys=("replica_grad_norm",)))
        per_replica = self.broadcast_buffers is False
        monitors.update(obs_stepstats.state_health(
            self.model, self.group, reduce=per_replica,
            per_layer=self.monitors == "full"))
        return monitors

    def _grads_agreed_finite(self, grads) -> torch.Tensor:
        """The world's consensus that every local gradient is finite: each
        replica's flag, reduced with MIN over the group (a device bool)."""
        finite = torch.stack([flat.isfinite().all() for _, flat in _pack(grads)]).all()
        return collectives.pmin(finite.to(torch.int32), self.group) > 0

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
        t0 = time.perf_counter() if not self._first_dispatch_noted else None
        batch = _to_device(batch, self.device)
        self.model.train()
        self._zero_grad()
        buffers = [b for b in self.model.buffers() if b is not None]
        guarded = self.divergence_guard is not None
        before = _pack(buffers) if guarded else None
        loss, metrics, numx = self._accumulate(batch)
        # DDP gradient averaging: one flat all-reduce per dtype, or the
        # compressed wire
        grads = _grads_for_all_reduce(
            [p for p in self.model.parameters() if p.requires_grad], self._fill_grads())
        if guarded:
            agreed = self._grads_agreed_finite(grads)
        loss, metrics = self._replica_mean(loss, metrics, self.compress != "none")
        # the guard's one host read a step
        ok = bool(agreed & torch.isfinite(loss)) if guarded else True
        # a skipped step never reduces, so it keeps the residual
        monitors = self._reduce_and_update(grads, numx, self._optimizer_step, reduce=ok)
        if ok:
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
        monitors = self._finish_monitors(monitors, numx)
        if t0 is not None:
            # the first eager step builds the lazy kernels and runs cuDNN's
            # autotuning (the JAX trainer's first dispatch is its XLA
            # compile): one compile.train event, host time tagged
            self._first_dispatch_noted = True
            from tpu_syncbn_torch.obs import profiling

            profiling.note_compile("train", time.perf_counter() - t0)
        return StepOutput(loss=loss, metrics=metrics, monitors=monitors)

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

    # -- K steps as one program --------------------------------------------

    def _state_tensors(self, chunk) -> list[torch.Tensor]:
        """Every tensor a K-step body updates in place: parameters,
        buffers, the optimizer's state and the error-feedback residual."""
        ts = list(self.model.parameters())
        ts += [b for b in self.model.buffers() if b is not None]
        ts += self._residuals()
        if self.zero:
            ts += list(self._shards.values())
        return ts + chunk.opt.state_tensors()

    def _chunk_step(self, chunk, k: int, batch) -> dict:
        """Step ``k`` of a chunk: :meth:`train_step` with the guard's
        verdict, the learning rate and the guard state on the device."""
        guard = self.divergence_guard
        self.model.train()
        self._zero_grad()
        if guard is not None:
            if k == 0:
                chunk.taken.zero_()
            live = self._state_tensors(chunk)
            old = [t.detach().clone() for t in live]
        loss, metrics, numx = self._accumulate(batch)
        grads = _grads_for_all_reduce(
            [p for p in self.model.parameters() if p.requires_grad], self._fill_grads())
        if guard is not None:
            agreed = self._grads_agreed_finite(grads)
        loss, metrics = self._replica_mean(loss, metrics, self.compress != "none")
        # the update (and the residual's) runs whatever the verdict; a
        # non-finite one is undone by the select below
        lr = (chunk.opt.lrs.index_select(0, chunk.taken.view(1))[0]
              if guard is not None else chunk.opt.lrs[k])
        if guard == "halve_lr":
            lr = lr * chunk.lr_scale
        monitors = self._reduce_and_update(grads, numx, lambda: chunk.opt.step(lr))
        out = {"loss": loss, **{("m", n): v for n, v in metrics.items()}}
        if guard is not None:
            ok = agreed & torch.isfinite(loss)
            _select_(ok, live, old)
            with torch.no_grad():
                out[("m", "nonfinite")] = (~ok).float()
                out[("m", "lr_scale")] = chunk.lr_scale.clone()
                chunk.taken.add_(ok.long())
                chunk.count.add_((~ok).long())
                if guard == "halve_lr":
                    chunk.lr_scale.copy_(
                        torch.where(ok, chunk.lr_scale, chunk.lr_scale * 0.5))
        if self._per_step_broadcast:
            collectives.broadcast_(
                [b for b in self.model.buffers() if b is not None], self.group)
        out.update({("mon", n): v
                    for n, v in self._finish_monitors(monitors, numx).items()})
        return out

    def _program_body(self, n_steps: int, stacked: bool):
        """The K-step program before its capture: ``prog.loop`` is the body
        applied K times eagerly, ``prog.chunk`` its device scalars and
        optimizer (the audit records this body)."""
        if isinstance(self.lr_scheduler, torch.optim.lr_scheduler.ReduceLROnPlateau):
            raise ValueError("train_steps: ReduceLROnPlateau steps on a metric "
                             "the chunk has not produced yet; use train_step")
        opt = _ChunkOptimizer(self.optimizer, n_steps, self.device, self._first_flags)
        self._first_flags = opt.first
        chunk = types.SimpleNamespace(
            opt=opt,
            taken=torch.zeros((), dtype=torch.int64, device=self.device),
            lr_scale=torch.ones((), dtype=torch.float32, device=self.device),
            count=torch.zeros((), dtype=torch.int64, device=self.device))
        prog = scan_driver.build_scan_steps(
            functools.partial(self._chunk_step, chunk), n_steps=n_steps,
            stacked=stacked, device=self.device,
            state=lambda: self._state_tensors(chunk))
        prog.chunk = chunk
        return prog

    def _state_groups(self, chunk) -> dict:
        """The state a step body updates in place, by the audit's labels:
        ``params`` (the module's parameters, and the shards under a
        sharding layout), ``rest`` (the buffers) and ``opt_state`` (the
        optimizer's state and the error-feedback residual)."""
        params = list(self.model.parameters())
        if self.zero:
            params += list(self._shards.values())
        return {"params": params,
                "rest": [b for b in self.model.buffers() if b is not None],
                "opt_state": chunk.opt.state_tensors() + self._residuals()}

    def audit_mesh(self) -> tuple[dict, Any]:
        """``(mesh axes, layout)`` the audit's placement pass reads this
        trainer's collectives through: the layout's axes, or one ``data``
        axis over the trainer's group when none was built."""
        from tpu_syncbn_torch.mesh_axes import DATA_AXIS

        if self._layout is not None:
            return dict(self._layout.axis_sizes), self._layout
        return {DATA_AXIS: self.world}, None

    def _state_specs(self, chunk, batch_spec=None) -> dict:
        """Each leaf's declared spec of :meth:`_state_groups` (and the
        batch's, ``batch_spec``): the module's parameters and buffers and
        the steps' scalars replicated, the flat shards and their optimizer
        state over the shard axis, the error-feedback residual this
        replica's own (over every batch axis)."""
        from tpu_syncbn_torch.mesh_axes import DATA_AXIS
        from tpu_syncbn_torch.parallel.layout import P

        lay = self._layout
        batch = lay.batch_spec if lay is not None else P(DATA_AXIS)
        shard = P(lay.param_shard_axis) if self.zero else P()
        shards = {id(t) for t in self._shards.values()} if self.zero else set()
        opt = []
        for g in self.optimizer.param_groups:
            for p in g["params"]:
                st = self.optimizer.state.get(p, {})
                opt += [shard if id(p) in shards and v.dim() else P()
                        for _, v in sorted(st.items()) if isinstance(v, torch.Tensor)]
        if chunk.opt.first is not None:
            opt.append(P())
        groups = self._state_groups(chunk)
        return {"params": [P()] * len(list(self.model.parameters())) + [shard] * len(shards),
                "rest": [P()] * len(groups["rest"]),
                "opt_state": opt + [batch] * len(self._residuals()),
                **({} if batch_spec is None else {"batch": batch_spec(batch)})}

    def lowered_train_step(self, batch, *, sharding: bool = False, memory: bool = False):
        """One step body recorded on this trainer's state and ``batch`` (the
        JAX trainer's ``lowered_train_step``): the body a K-step program
        captures, applied once eagerly under the audit's recorder, then
        undone. Returns an :class:`~tpu_syncbn_torch.audit.contracts.LoweredStep`
        — ``.cost_analysis()["flops"]``, ``.as_text()`` (the dispatched
        ops), ``.contract(name=...)`` and ``.flow()``. With ``sharding``
        the recorder also runs the audit's layer 3 over the trainer's own
        mesh axes and declared specs (:meth:`audit_mesh`,
        :meth:`_state_specs`; the batch over the layout's batch axes), and
        with ``memory`` it takes the allocator's reading of the application.
        Parameters, buffers, the
        optimizer's state and groups, ``.grad``, the RNG, the train/eval
        flag and the collective tallies are left as they were, also when
        the body raises."""
        from tpu_syncbn_torch.audit import contracts

        batch = _to_device(batch, self.device)
        opt = self.optimizer
        saved_state = {p: dict(st) for p, st in opt.state.items()}
        saved_groups = [dict(g) for g in opt.param_groups]
        owners = list(self.model.parameters()) + (list(self._shards.values())
                                                   if self.zero else [])
        grads = [(p, p.grad) for p in owners]
        first, training = self._first_flags, self.model.training
        rng = torch.get_rng_state()
        cuda_rng = torch.cuda.get_rng_state(self.device) if self.device.type == "cuda" else None
        tallies = collectives._snapshot_tallies()
        try:
            prog = self._program_body(1, False)
            prog.chunk.opt.fill(_schedule_lrs(opt, self.lr_scheduler, 1))
            groups = self._state_groups(prog.chunk)
            layer3: dict = {}
            if sharding:
                mesh_axes, layout = self.audit_mesh()
                layer3 = dict(mesh_axes=mesh_axes, layout=layout, memory=memory,
                              in_specs=self._state_specs(prog.chunk, lambda b: b),
                              declared=[k for k, v in groups.items() if v])
            with contracts.Recorder({**groups, "batch": batch}, restore=True,
                                    **layer3) as rec:
                rec.note_outputs(prog.loop(batch))
        finally:
            opt.state.clear()
            opt.state.update(saved_state)
            for g, s in zip(opt.param_groups, saved_groups):
                g.clear()
                g.update(s)
            for p, g in grads:
                p.grad = g
            self._first_flags = first
            self.model.train(training)
            torch.set_rng_state(rng)
            if cuda_rng is not None:
                torch.cuda.set_rng_state(cuda_rng, self.device)
            collectives._restore_tallies(tallies)
        # a group with no leaf (a model without buffers) has nothing to alias
        return contracts.LoweredStep(rec, world=self.world,
                                     declared_donated=[k for k, v in groups.items() if v])

    def _build_program(self, n_steps: int, stacked: bool, batch, recorder=None):
        """The K-step program captured for batches shaped like ``batch``.
        ``recorder`` (``(state, specs) -> context manager``, the audit's
        :class:`~tpu_syncbn_torch.audit.contracts.Recorder`) is entered
        around the captured applications, given the state groups of
        :meth:`_state_groups` and the graph's static batch as ``batches``,
        and each leaf's declared spec (:meth:`_state_specs`, the batches
        stacked on a leading unsharded axis)."""
        from tpu_syncbn_torch.parallel.layout import P

        prog = self._program_body(n_steps, stacked)
        prog.prepare(batch, recorder=None if recorder is None else (
            lambda static: recorder(
                {**self._state_groups(prog.chunk), "batches": static},
                self._state_specs(prog.chunk, lambda b: P(None, *b)))))
        if prog.graph is not None:
            # the gradients the capture left (the module's parameters', and
            # the shards' under a sharding layout) are the graph's own
            # buffers: every replay of this program rebinds .grad to them
            owners = list(self.model.parameters())
            if self.zero:
                owners += list(self._shards.values())
            prog.grads = [(p, p.grad) for p in owners]
        return prog

    def _run_scanned(self, batch, n_steps: int, stacked: bool) -> StepOutput:
        batch = _to_device(batch, self.device)
        _check_capturable(self.device, self.world, self.group)
        prog = scan_driver.cached_scan_steps(
            self._train_steps_cache, (n_steps, stacked, scan_driver._signature(batch)),
            lambda: self._build_program(n_steps, stacked, batch))
        chunk = prog.chunk
        chunk.opt.fill(_schedule_lrs(self.optimizer, self.lr_scheduler, n_steps))
        guarded = self.divergence_guard is not None
        if guarded:
            chunk.lr_scale.fill_(self.guard_state["lr_scale"])
            chunk.count.fill_(self.guard_state["nonfinite_count"])
        out = prog(batch)
        for p, g in getattr(prog, "grads", ()):
            # .grad follows the program that ran last: another program's
            # buffers hold its own last step, and would keep its memory
            # pool alive after the cache evicted it
            p.grad = g
        taken = n_steps
        if guarded:  # the chunk's one host read
            taken, scale, count = torch.stack(
                [chunk.taken.double(), chunk.lr_scale.double(),
                 chunk.count.double()]).tolist()
            taken = int(taken)
            self.guard_state = {"lr_scale": scale, "nonfinite_count": int(count)}
        _advance_scheduler(self.lr_scheduler, taken)
        loss = out.pop("loss")
        return StepOutput(loss=loss,
                          metrics={name: v for (kind, name), v in out.items() if kind == "m"},
                          monitors={name: v for (kind, name), v in out.items()
                                    if kind == "mon"})

    def train_steps(self, batch, n_steps: int) -> StepOutput:
        """``n_steps`` optimizer steps on the SAME batch as one program
        (one graph replay on the card). Returns stacked per-step ``loss``
        and ``metrics`` of leading dimension ``n_steps``. Each distinct
        ``n_steps`` (and batch shape) builds and caches its own program:
        call it with a fixed n."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        return self._run_scanned(batch, n_steps, False)

    def train_steps_batches(self, batches) -> StepOutput:
        """One optimizer step per leading-axis slice of ``batches``
        (stacked to ``(K, B, ...)``, e.g. a chunk of
        ``data.device_prefetch(scan_steps=K)``) as one program. Exactly K
        sequential :meth:`train_step` calls on the K slices — parameters,
        optimizer state, BN buffers, the schedule and the guard's skips —
        with stacked per-step ``loss``/``metrics`` (``nonfinite`` and
        ``lr_scale`` too when the guard is armed). The chunk is only read.

        After a chunk the parameters' ``.grad`` hold the last step's
        gradients in the graph's memory (the program that ran, whichever of
        the cached ones it was), which the next chunk overwrites."""
        return self._run_scanned(batches, scan_driver.scan_length(batches), True)

    @property
    def program_caches(self) -> tuple:
        """Every :class:`~tpu_syncbn_torch.parallel.scan_driver.ProgramCache`
        this trainer owns: the live mode's first, then any parked by
        :meth:`set_compress`."""
        parked = [c for c in self._mode_programs.values()
                  if c is not self._train_steps_cache]
        return (self._train_steps_cache, *parked)

    # -- compression --------------------------------------------------------

    def reset_compression_residual(self) -> bool:
        """Zero the error-feedback residual in place; returns whether there
        was one. ``ResilientLoop``'s ``restore_last_good`` calls it: after
        a divergence rollback the restored residual holds the quantization
        error of a trajectory that has been unwound. An ordinary resume
        keeps the checkpointed residual."""
        if self._residual is None:
            return False
        with torch.no_grad():
            for r in self._residuals():
                r.zero_()
        return True

    def set_compress(self, mode: str) -> bool:
        """Switch the gradient wire between steps; returns whether anything
        changed. Whether a residual is kept is fixed at construction (build
        the trainer at the lossiest mode you will select, e.g. ``"int8"``;
        under ``"none"`` the residual passes through untouched). Each
        mode's K-step programs are parked on a switch away and recalled on
        the switch back, so a mode revisited captures nothing anew. The
        residual's content belongs to its wire format, so it is zeroed at
        every switch. Not for the legacy ``grad_compression`` hook."""
        collectives.check_compress_mode(mode)
        if self.grad_compression is not None:
            raise ValueError(
                "set_compress does not apply to the legacy "
                "grad_compression hook — construct with compress= instead")
        if mode == self.compress:
            return False
        self._mode_programs[self.compress] = self._train_steps_cache
        self.compress = mode
        parked = self._mode_programs.get(mode)
        self._train_steps_cache = (parked if parked is not None
                                   else scan_driver.ProgramCache(name="train"))
        self.reset_compression_residual()
        return True

    def _residual_views(self) -> dict:
        """``{name: view}`` of the residual buffer, one a parameter."""
        views, offset = {}, 0
        for name, p in self._trainable:
            views[name] = self._residual[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
        return views

    # -- checkpointing ----------------------------------------------------

    def state_dict(self) -> dict:
        """Full training state, as copies: ``params`` and ``rest`` (every
        buffer) by name, and ``opt_state`` with the optimizer's
        ``state_dict()``, the scheduler's when the trainer owns one, and
        the guard state when it is armed, and this replica's error-feedback
        ``residual`` by parameter name when it is kept — feed it to
        ``utils.checkpoint.save_checkpoint`` on the master. The copies stay
        valid while later steps update the live tensors in place."""
        opt_state = {"optimizer": copy.deepcopy(self.optimizer.state_dict())}
        if self.lr_scheduler is not None:
            opt_state["lr_scheduler"] = copy.deepcopy(self.lr_scheduler.state_dict())
        if self.divergence_guard is not None:
            opt_state["guard"] = dict(self.guard_state)
        if self.zero:
            self._gather_optimizer_state(opt_state["optimizer"])
            opt_state["flat"] = {"padded": dict(self._flat.padded)}
            if self._residual is not None:
                opt_state["residual"] = {dt: v.detach().clone()
                                         for dt, v in self._residual.items()}
        elif self._residual is not None:
            opt_state["residual"] = {n: v.detach().clone()
                                     for n, v in self._residual_views().items()}
        return {**_named_state(self.model), "opt_state": opt_state}

    def _state_slots(self, sd: dict):
        """``(dtype, state dict)`` of each shard's entry in an optimizer
        ``state_dict()`` (its params are the shards, in dtype order)."""
        dts = list(self._shards)
        for i, st in sd["state"].items():
            yield dts[sd["param_groups"][0]["params"].index(i)], st

    def _gather_optimizer_state(self, sd: dict) -> None:
        """In place: each shard-sized vector of an optimizer ``state_dict()``
        becomes the full padded flat vector, gathered over the shard group
        (JAX's checkpoint format: the global array)."""
        sizes = self._flat.shard_sizes
        for dt, st in self._state_slots(sd):
            for key, v in st.items():
                if isinstance(v, torch.Tensor) and v.dim() == 1 and v.numel() == sizes[dt]:
                    st[key] = collectives.all_gather(v, self._shard_group, tiled=True).clone()

    def load_state_dict(self, state: dict) -> None:
        """Restore a tree produced by :meth:`state_dict` (or loaded from a
        checkpoint), placing every tensor on the trainer's device; nothing
        is broadcast (every rank loads the same checkpoint). Raises
        ``ValueError`` when the checkpoint's structure is not this
        trainer's."""
        opt_state = state["opt_state"]
        if ("flat" in opt_state) != self.zero:
            raise ValueError(
                "opt_state structure mismatch: this checkpoint was saved "
                "by a trainer with a different optimizer or a different "
                f"`zero` setting than this one (zero={self.zero}). Rebuild "
                "the trainer with the same optimizer and zero flag to "
                "resume the optimizer state."
            )
        want = {"optimizer"}
        if self.zero:
            want.add("flat")
            padded = {dt: int(n) for dt, n in opt_state["flat"]["padded"].items()}
            if padded != self._flat.padded:
                raise ValueError(
                    "zero=True opt_state layout mismatch: this checkpoint "
                    "was saved with a different world size (flat shard "
                    "padding is world-dependent). Resume on the same "
                    f"shard world ({self._shard_world}) or retrain the "
                    "optimizer state."
                )
        if self.lr_scheduler is not None:
            want.add("lr_scheduler")
        if self.divergence_guard is not None:
            want.add("guard")
        if self._residual is not None:
            want.add("residual")
        if set(opt_state) != want:
            raise ValueError(
                "opt_state structure mismatch: this checkpoint was saved "
                "by a trainer with a different optimizer, lr_scheduler, "
                f"divergence_guard or error_feedback setting than this one (it holds "
                f"{sorted(opt_state)}, this trainer {sorted(want)}). Rebuild "
                "the trainer with the same settings to resume the optimizer "
                "state."
            )
        if self._residual is not None:
            views = self._residual if self.zero else self._residual_views()
            got = opt_state["residual"]
            if set(got) != set(views) or any(tuple(got[n].shape) != tuple(v.shape)
                                             for n, v in views.items()):
                raise ValueError("residual mismatch: the checkpoint's residual "
                                 "names or shapes differ from the model's parameters")
        _load_named_state_(self.model, state["params"], state["rest"])
        if self._residual is not None:
            with torch.no_grad():
                for n, v in views.items():
                    v.copy_(got[n])
        # a copy: torch's load keeps the given tensors where their dtype
        # and device already fit, and the next step would then update the
        # caller's state in place
        sd = copy.deepcopy(opt_state["optimizer"])
        if self.zero:
            self._reshard_from_model(sd)
        self.optimizer.load_state_dict(sd)
        # the load replaced the optimizer's state tensors: a captured
        # program (parked ones too) would go on writing the old ones
        for cache in self.program_caches:
            cache.clear()
        self._first_flags = None
        if self.lr_scheduler is not None:
            self.lr_scheduler.load_state_dict(opt_state["lr_scheduler"])
        if self.divergence_guard is not None:
            self.guard_state = {
                "lr_scale": float(opt_state["guard"]["lr_scale"]),
                "nonfinite_count": int(opt_state["guard"]["nonfinite_count"]),
            }


    def _cut_shards(self) -> None:
        """This rank's shards cut anew from the module's parameters (after
        a load wrote them)."""
        w, r = self._shard_world, self._shard_rank
        with torch.no_grad():
            full = self._flat.flatten(dict(self._trainable))
            for dt, shard in self._shards.items():
                shard.copy_(full[dt].view(w, -1)[r])

    def _reshard_from_model(self, sd: dict) -> None:
        """After a load: the shards cut from the module's (loaded)
        parameters, and each full padded vector of the optimizer
        ``state_dict()`` ``sd`` cut to this rank's shard, in place."""
        w, r = self._shard_world, self._shard_rank
        self._cut_shards()
        for dt, st in self._state_slots(sd):
            for key, v in st.items():
                if isinstance(v, torch.Tensor) and v.dim() == 1 \
                        and v.numel() == self._flat.padded[dt]:
                    st[key] = v.view(w, -1)[r].clone()


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
