"""BatchNorm / SyncBatchNorm modules — the counterpart of
``tpu_syncbn.nn.normalization``, as ``torch.nn.Module``s.

``SyncBatchNorm`` reduces per-channel batch statistics across every
replica of its process group before normalizing, so each replica
normalizes against the global batch; with ``group_size`` (an int for
contiguous subgroups, or an explicit rank partition) only within this
rank's subgroup. In eval mode, or when there is no one to sync with
(world 1), it is plain BN and issues no collective.

As in the JAX package the layout is channel-last by default
(``channel_axis=-1``, NHWC for 2-D). The ResNet builds its BN layers with
``channel_axis=1`` over NCHW-shaped activations held in
``torch.channels_last`` memory, whose channel-last view is dense, so the
fused kernels read them with no copy.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
from torch import nn

from tpu_syncbn_torch.ops import batch_norm as bn_ops
from tpu_syncbn_torch.parallel.collectives import (
    group_for,
    normalize_group_spec,
    world_size,
)
from tpu_syncbn_torch.runtime.distributed import resolve_device


class BatchNorm(nn.Module):
    """Plain batch normalization over the batch (+ spatial) axes, with
    ``torch.nn.BatchNorm*d`` semantics: biased variance to normalize,
    unbiased for the running buffer, ``momentum=None`` cumulative average,
    optional affine and running stats. ``model.train()`` /
    ``model.eval()`` select batch or running statistics."""

    def __init__(
        self,
        num_features: int,
        *,
        eps: float = 1e-5,
        momentum: float | None = 0.1,
        affine: bool = True,
        track_running_stats: bool = True,
        channel_axis: int = -1,
        process_group=None,
        group_size=None,
        stats_compress: str = "none",
        device: str | torch.device | None = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if (process_group is not None or group_size is not None
                or stats_compress != "none") \
                and not isinstance(self, SyncBatchNorm):
            # plain BN never syncs (per-replica stats are the bug SyncBN
            # exists to fix); accepting a group and ignoring it would
            # silently bring that bug back
            raise ValueError(
                "plain BatchNorm does not sync across replicas; use "
                "SyncBatchNorm (or convert_sync_batchnorm) for "
                f"process_group={process_group!r} / group_size="
                f"{group_size!r} / stats_compress={stats_compress!r}"
            )
        dev = resolve_device(device)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.channel_axis = channel_axis
        self.process_group = process_group
        #: None, an int (contiguous subgroups) or a rank partition as
        #: nested tuples (``collectives.normalize_group_spec``)
        self.group_size = _check_scope(process_group, group_size)
        bn_ops.check_stats_compress(stats_compress)
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, dtype=dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(num_features, dtype=dtype, device=dev))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if track_running_stats:
            self.register_buffer(
                "running_mean", torch.zeros(num_features, dtype=torch.float32, device=dev))
            self.register_buffer(
                "running_var", torch.ones(num_features, dtype=torch.float32, device=dev))
            self.register_buffer(
                "num_batches_tracked", torch.zeros((), dtype=torch.long, device=dev))
        else:
            self.register_buffer("running_mean", None)
            self.register_buffer("running_var", None)
            self.register_buffer("num_batches_tracked", None)

    def extra_repr(self) -> str:
        s = (f"{self.num_features}, eps={self.eps}, momentum={self.momentum}, "
             f"affine={self.affine}, track_running_stats="
             f"{self.track_running_stats}, channel_axis={self.channel_axis}")
        if self.group_size is not None:
            s += f", group_size={self.group_size}"
        return s

    def _check_input(self, x: torch.Tensor) -> None:
        c = x.shape[self.channel_axis]
        if c != self.num_features:
            raise ValueError(
                f"expected {self.num_features} channels on axis "
                f"{self.channel_axis}, got shape {tuple(x.shape)}"
            )

    def _sync_group(self):
        """The process group to sync over, or None for local statistics.
        Plain BatchNorm never syncs."""
        return None

    def forward(self, x: torch.Tensor, *, mask: torch.Tensor | None = None):
        self._check_input(x)
        if not self.training and self.track_running_stats:
            # eval: running statistics, no collective
            return bn_ops.batch_norm_inference(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, eps=self.eps, channel_axis=self.channel_axis,
            )
        y, (rm, rv, nbt) = bn_ops.batch_norm_train(
            x, self.running_mean, self.running_var, self.num_batches_tracked,
            self.weight, self.bias,
            momentum=self.momentum, eps=self.eps,
            channel_axis=self.channel_axis,
            process_group=self._sync_group(), mask=mask,
        )
        if self.track_running_stats:
            with torch.no_grad():
                self.running_mean.copy_(rm)
                self.running_var.copy_(rv)
                self.num_batches_tracked.copy_(nbt)
        return y


class BatchNorm1d(BatchNorm):
    """Rank-2/3 inputs (N, C) or (N, L, C)."""

    def _check_input(self, x):
        if x.ndim not in (2, 3):
            raise ValueError(f"BatchNorm1d expects 2D/3D input, got {x.ndim}D")
        super()._check_input(x)


class BatchNorm2d(BatchNorm):
    """Rank-4 inputs, (N, H, W, C) by default."""

    def _check_input(self, x):
        if x.ndim != 4:
            raise ValueError(f"BatchNorm2d expects 4D input, got {x.ndim}D")
        super()._check_input(x)


class BatchNorm3d(BatchNorm):
    """Rank-5 inputs, (N, D, H, W, C) by default."""

    def _check_input(self, x):
        if x.ndim != 5:
            raise ValueError(f"BatchNorm3d expects 5D input, got {x.ndim}D")
        super()._check_input(x)


class SyncBatchNorm(BatchNorm):
    """Cross-replica synchronized BatchNorm — ``torch.nn.SyncBatchNorm``'s
    contract over the port's fused kernels.

    ``process_group`` picks the replicas that sync together; ``None``
    means the default (world) group once one exists. ``group_size`` scopes
    the sync to this rank's subgroup of the world, as the JAX
    ``SyncBatchNorm(group_size=...)`` does: an int ``g`` for the
    contiguous groups ``[0..g), [g..2g), ...``, or an explicit partition
    of the ranks such as ``((0, 3), (1, 2))``. The subgroups are built
    once per spec and shared by every layer (``collectives.group_for``).
    Give ``process_group`` or ``group_size``, not both.

    In training mode with more than one replica in the group, per-channel
    moments are summed across it with one all-reduce (and the backward's
    two sums with one more). In eval mode, or at world 1, it is plain BN
    with no collective."""

    def scope_group(self):
        """The group this layer's training statistics sum over, or None
        when there is no one to sync with. The first call for a
        ``group_size`` builds (or finds cached) the subgroups, which is
        collective: every rank asks in the same order."""
        group = self.process_group
        if group is None:
            if not (tdist.is_available() and tdist.is_initialized()):
                return None
            group = group_for(self.group_size, tdist.group.WORLD)
        return group if world_size(group) > 1 else None

    def _sync_group(self):
        return self.scope_group() if self.training else None

    @classmethod
    def convert_sync_batchnorm(cls, module, process_group=None,
                               group_size=None, stats_compress: str = "none"):
        """Spelling parity with ``torch.nn.SyncBatchNorm.convert_sync_
        batchnorm``; see :func:`tpu_syncbn_torch.nn.convert_sync_batchnorm`."""
        from tpu_syncbn_torch.nn.convert import convert_sync_batchnorm

        return convert_sync_batchnorm(module, process_group, group_size,
                                      stats_compress)


def _check_scope(process_group, group_size):
    """The normalized ``group_size``; raises when both a group and a
    subgroup spec are given (which of the two would win is a guess)."""
    if process_group is not None and group_size is not None:
        raise ValueError(
            "give SyncBatchNorm a process_group or a group_size, not both "
            f"(process_group={process_group!r}, group_size={group_size!r})"
        )
    return normalize_group_spec(group_size)
