"""Functional batch-normalization ops — the counterpart of
``tpu_syncbn.ops.batch_norm``, with the same semantics:

* normalization uses the **biased** (1/N) batch variance; the running-var
  update uses the **unbiased** (1/(N−1)) one, except for N ≤ 1, which keeps
  the biased value rather than divide by zero;
* ``momentum=None`` means a cumulative average (factor
  ``1/num_batches_tracked``);
* cross-replica statistics are count-weighted, so uneven and empty shards
  are exact;
* sums accumulate in float32 whatever the input dtype.

Layout: channel-last (N…C) by default; ``channel_axis`` covers others.
``process_group=None`` means local statistics (the JAX ``axis_name=None``);
pass a group to sync across its replicas, and ``group_size`` (an int for
contiguous subgroups, or an explicit rank partition) to sync only within
this rank's subgroup of it (``parallel.collectives.group_for``).

``stats_compress`` (``"none"`` | ``"bf16"`` | ``"int8"``) puts the
statistics' ``(Σx, Σx²)`` on a lossy wire when there is a group to sync
over (the count stays exact); without one it is ignored, as the JAX
``sync_moments`` ignores it without an ``axis_name``. It does not combine
with ``group_size``. ``collectives.ALONE`` is the group of one replica:
compressed statistics still round there, as on the JAX package's mesh of
one. bf16 statistics are differentiable (the cotangent rounds to bf16 on
its way back, as JAX's autodiff of the cast does); int8 statistics have no
gradient, as in the JAX package (its shared range is an all-reduce MAX):
their backward raises.

The training path without a mask goes through the fused kernels of
:mod:`tpu_syncbn_torch.ops.triton_bn`, which take a view whose channel
axis is the dense last one and raise on any other CUDA tensor. A mask or
compressed statistics, as in the JAX package, take the plain PyTorch ops
below (the fused backward's exact all-reduce must stay exact); so does a
CPU tensor of another layout, which has no kernel to run anyway.
"""

from __future__ import annotations

import math

import torch

from tpu_syncbn_torch.obs import numerics as obs_numerics
from tpu_syncbn_torch.ops._triton_common import get_mode as get_kernel_mode
from tpu_syncbn_torch.ops._triton_common import mode as kernel_mode
from tpu_syncbn_torch.ops._triton_common import set_mode as set_kernel_mode
from tpu_syncbn_torch.ops._triton_common import use_kernel
from tpu_syncbn_torch.parallel import collectives
from tpu_syncbn_torch.parallel.collectives import (
    _tally,
    check_compress_mode,
    check_group_compress,
    group_for,
    moments_from_stats,
    psum,
    world_size,
)

__all__ = [
    "batch_norm_elemt", "batch_norm_inference", "batch_norm_stats",
    "batch_norm_train", "check_stats_compress", "fold_scale_shift",
    "get_kernel_mode", "kernel_mode", "set_kernel_mode", "sync_moments",
    "update_running_stats",
]


def check_stats_compress(mode: str) -> str:
    """The statistics' wire mode: one of ``collectives.COMPRESS_MODES``
    (``"none"``, exact float32, by default), else ``ValueError``."""
    return check_compress_mode(mode)


def _sync_group(process_group, group_size, stats_compress):
    """The group the statistics sum over: ``process_group``, or this
    rank's subgroup of it for a ``group_size`` spec; ``None`` without a
    ``process_group`` (local statistics, as the JAX ``axis_name=None``
    ignores ``group_size`` and ``stats_compress``)."""
    check_stats_compress(stats_compress)
    if process_group is None:
        return None
    check_group_compress(group_size, stats_compress)
    return group_for(group_size, process_group)


def _reduction_axes(ndim: int, channel_axis: int) -> tuple[int, ...]:
    ca = channel_axis % ndim
    return tuple(i for i in range(ndim) if i != ca)


def _shape_for_channel(ndim: int, channel_axis: int, c: int) -> list[int]:
    shape = [1] * ndim
    shape[channel_axis % ndim] = c
    return shape


def batch_norm_stats(
    x: torch.Tensor, *, channel_axis: int = -1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel local partial moments ``(sum, sumsq, count)`` in f32.
    Raw sums compose across replicas with one all-reduce."""
    axes = _reduction_axes(x.ndim, channel_axis)
    xf = x.to(torch.float32)
    s = xf.sum(dim=axes)
    sq = (xf * xf).sum(dim=axes)
    count = torch.full((), float(math.prod(x.shape[a] for a in axes)),
                       dtype=torch.float32, device=x.device)
    return s, sq, count


def sync_moments(
    x: torch.Tensor,
    *,
    channel_axis: int = -1,
    process_group=None,
    group_size=None,
    stats_compress: str = "none",
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel ``(mean, biased var, count)`` over the batch, across the
    replicas of ``process_group`` when one is given (within this rank's
    subgroup of it for a ``group_size``).

    ``mask`` (broadcastable to x, channel-axis size 1) marks the valid
    elements: the uneven/empty-shard contract. Differentiable (the
    all-reduce's gradient is an all-reduce), except under
    ``stats_compress="int8"``, whose backward raises (module docstring)."""
    group = _sync_group(process_group, group_size, stats_compress)
    if mask is None:
        s, sq, count = batch_norm_stats(x, channel_axis=channel_axis)
    else:
        axes = _reduction_axes(x.ndim, channel_axis)
        xf = x.to(torch.float32)
        mf = torch.broadcast_to(mask, x.shape).to(torch.float32)
        s = (xf * mf).sum(dim=axes)
        sq = (xf * xf * mf).sum(dim=axes)
        count = mf.sum(dim=axes)
    if group is not None and stats_compress != "none":
        return _compressed_moments(s, sq, count, group, stats_compress)
    if world_size(group) > 1:
        return _differentiable_reduce_moments(s, sq, count, group)
    mean, var = moments_from_stats(s, sq, count)
    if group is not None:
        # a synced layer alone records its zero skew, as the fused path does
        obs_numerics.record_bn_skew_alone(x.device)
    return mean, var, count


class _Bf16Sums(torch.autograd.Function):
    """``(Σx, Σx²)`` summed over ``group`` on the bf16 wire, with the JAX
    package's gradient: there the sum's output is replica-invariant, so the
    replicas' cotangents are summed in f32 where the statistics meet the
    activations, then rounded to bf16 once by the cast's transpose, and
    the sum's own transpose moves nothing. So the backward all-reduces the
    f32 cotangent and rounds the total through bf16."""

    @staticmethod
    def forward(ctx, payload, group):
        ctx.group = group
        wire = payload.to(torch.bfloat16)
        collectives._tally_compressed(payload.numel() * 4, wire.numel() * 2)
        return psum(wire, group).to(torch.float32)

    @staticmethod
    def backward(ctx, grad):
        total = psum(grad.contiguous(), ctx.group)
        return total.to(torch.bfloat16).to(torch.float32), None


class _Int8Sums(torch.autograd.Function):
    """``(Σx, Σx²)`` summed over ``group`` on the int8 wire
    (``collectives.compressed_psum``). No backward: the JAX package's
    gradient through this reduction raises (``jax.grad`` has no rule for
    the range's ``pmax``), so the port's does too rather than invent one."""

    @staticmethod
    def forward(ctx, payload, group):
        return collectives.compressed_psum(payload.detach(), group, mode="int8")

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "stats_compress='int8': int8 SyncBN statistics have no gradient. "
            "Their shared quantization range is an all-reduce MAX, which has "
            "no differentiation rule (the JAX package raises 'Differentiation "
            "rule for pmax not implemented' here too); train with "
            "stats_compress='bf16' or 'none'")


def _compressed_moments(s, sq, count, group, mode):
    """``reduce_moments(mode=...)`` for the module path: ``(Σx, Σx²)`` on
    the lossy wire, at every world size (``collectives.ALONE`` included),
    the count exact. bf16 through :class:`_Bf16Sums` (JAX's gradient),
    int8 through :class:`_Int8Sums`, whose backward raises."""
    c = s.shape[0]
    payload = torch.cat([s, sq])
    sums = _Bf16Sums if mode == "bf16" else _Int8Sums
    total = sums.apply(payload, group)
    tcount = psum(count.reshape(-1), group).reshape(count.shape)
    mean, var = moments_from_stats(total[:c], total[c:], tcount)
    obs_numerics.record_bn_skew(s, sq, count, mean, var)
    return mean, var, tcount


def _differentiable_reduce_moments(s, sq, count, group):
    """``reduce_moments`` whose all-reduce carries a gradient (the sum's
    transpose is a sum), for the plain differentiable path."""
    from torch.distributed.nn.functional import all_reduce

    c = s.shape[0]
    payload = torch.cat([s, sq, count.reshape(-1)])
    _tally("psum", [payload], group)
    total = all_reduce(payload, group=group)
    tcount = total[2 * c:]
    if count.dim() == 0:
        tcount = tcount.reshape(())
    mean, var = moments_from_stats(total[:c], total[c:2 * c], tcount)
    obs_numerics.record_bn_skew(s, sq, count, mean, var)
    return mean, var, tcount


def fold_scale_shift(
    mean: torch.Tensor,
    var: torch.Tensor,
    weight: torch.Tensor | None,
    bias: torch.Tensor | None,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold (mean, var, γ, β, eps) into per-channel f32 ``(scale, shift)``
    so the normalize is one FMA per element: ``y = x·scale + shift``."""
    invstd = torch.rsqrt(var.to(torch.float32) + eps)
    scale = invstd if weight is None else invstd * weight.to(torch.float32)
    shift = -mean.to(torch.float32) * scale
    if bias is not None:
        shift = shift + bias.to(torch.float32)
    return scale, shift


def batch_norm_elemt(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    weight: torch.Tensor | None,
    bias: torch.Tensor | None,
    eps: float,
    *,
    channel_axis: int = -1,
) -> torch.Tensor:
    """Elementwise normalize + affine in f32, returned in ``x.dtype``
    (plain PyTorch ops; differentiable)."""
    shape = _shape_for_channel(x.ndim, channel_axis, mean.shape[0])
    scale, shift = fold_scale_shift(mean, var, weight, bias, eps)
    y = x.to(torch.float32) * scale.reshape(shape) + shift.reshape(shape)
    return y.to(x.dtype)


def update_running_stats(
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    num_batches_tracked: torch.Tensor,
    batch_mean: torch.Tensor,
    batch_var: torch.Tensor,
    count: torch.Tensor,
    momentum: float | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """New ``(running_mean, running_var, num_batches_tracked)`` with torch's
    semantics: factor ``momentum`` (or ``1/num_batches_tracked`` when None),
    running var absorbing the unbiased ``var·n/(n−1)`` (the biased value
    when n ≤ 1). Returns new tensors; the module copies them into its
    buffers."""
    nbt = num_batches_tracked + 1
    # a Python float (not a host tensor) for a fixed momentum: moving a
    # scalar to the card would synchronize the stream once per layer
    factor = 1.0 / nbt.to(torch.float32) if momentum is None else momentum
    unbiased = torch.where(
        count > 1.0,
        batch_var * (count / torch.clamp_min(count - 1.0, 1.0)),
        batch_var,
    )
    new_mean = (1.0 - factor) * running_mean + factor * batch_mean
    new_var = (1.0 - factor) * running_var + factor * unbiased
    return new_mean, new_var, nbt


def batch_norm_train(
    x: torch.Tensor,
    running_mean: torch.Tensor | None,
    running_var: torch.Tensor | None,
    num_batches_tracked: torch.Tensor | None,
    weight: torch.Tensor | None,
    bias: torch.Tensor | None,
    *,
    momentum: float | None = 0.1,
    eps: float = 1e-5,
    channel_axis: int = -1,
    process_group=None,
    group_size=None,
    stats_compress: str = "none",
    mask: torch.Tensor | None = None,
):
    """Full training-mode BN forward, synced across ``process_group``'s
    replicas when one is given (SyncBatchNorm), or within this rank's
    subgroup of it for a ``group_size`` (an int for contiguous groups, or
    an explicit rank partition).

    Returns ``(y, (new_running_mean, new_running_var,
    new_num_batches_tracked))``; the triple is ``(None, None, None)`` when
    no running stats are tracked. The new stats carry no gradient.
    ``stats_compress`` puts the statistics on a lossy wire when
    ``process_group`` is given (module docstring)."""
    group = _sync_group(process_group, group_size, stats_compress)
    compressed = group is not None and stats_compress != "none"
    xv = x.movedim(channel_axis, -1)
    if mask is None and not compressed and (xv.is_contiguous() or use_kernel(xv)):
        # fused kernel path: stats kernel, one all-reduce, normalize
        # kernel; hand-derived backward with one all-reduce. A tensor the
        # kernels would run on goes here whatever its layout, so one they
        # cannot read raises in the wrapper rather than run the plain ops.
        from tpu_syncbn_torch.ops import triton_bn

        yv, mean, var, count = triton_bn.fused_batch_norm(
            xv, weight, bias, eps, group
        )
        y = yv.movedim(-1, channel_axis)
    else:
        mean, var, count = sync_moments(
            x, channel_axis=channel_axis, process_group=group,
            stats_compress=stats_compress if compressed else "none", mask=mask,
        )
        y = batch_norm_elemt(
            x, mean, var, weight, bias, eps, channel_axis=channel_axis
        )
    if running_mean is None:
        return y, (None, None, None)
    with torch.no_grad():
        new = update_running_stats(
            running_mean, running_var, num_batches_tracked,
            mean.detach(), var.detach(), count.detach(), momentum,
        )
    return y, new


def batch_norm_inference(
    x: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    weight: torch.Tensor | None,
    bias: torch.Tensor | None,
    *,
    eps: float = 1e-5,
    channel_axis: int = -1,
) -> torch.Tensor:
    """Eval-mode BN: normalize by the running stats, no collective.

    A tensor the kernels run on (a CUDA tensor, unless the kernel mode is
    ``"off"``) goes through the hand-written normalize kernel
    (``triton_bn.bn_normalize``), as training does, so one the kernel
    cannot read raises in the wrapper rather than run the plain ops. Every
    other tensor takes the plain ``batch_norm_elemt``."""
    xv = x.movedim(channel_axis, -1)
    if use_kernel(xv):
        from tpu_syncbn_torch.ops import triton_bn

        yv = triton_bn.bn_normalize(xv, running_mean, running_var, weight,
                                    bias, eps)
        return yv.movedim(-1, channel_axis)
    return batch_norm_elemt(
        x, running_mean, running_var, weight, bias, eps,
        channel_axis=channel_axis,
    )
