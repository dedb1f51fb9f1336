"""``convert_sync_batchnorm`` — recursive module-tree rewrite, the
counterpart of ``tpu_syncbn.nn.convert``.

Every :class:`~tpu_syncbn_torch.nn.BatchNorm` (and subclass) becomes a
:class:`~tpu_syncbn_torch.nn.SyncBatchNorm` that *shares* the original's
parameters and buffers (the same tensor objects, so an optimizer built
before the conversion still updates them), with eps, momentum, affine,
track and channel-axis settings and the train/eval flag kept.

``group_size`` scopes every converted layer to replica subgroups (an int,
or an explicit rank partition); the layers share one cached set of
groups (``collectives.group_for``).
"""

from __future__ import annotations

from torch import nn

from tpu_syncbn_torch.nn.normalization import (
    BatchNorm,
    SyncBatchNorm,
    _check_scope,
)
from tpu_syncbn_torch.ops.batch_norm import check_stats_compress


def _convert_one(bn: BatchNorm, process_group, group_size) -> SyncBatchNorm:
    out = SyncBatchNorm.__new__(SyncBatchNorm)
    nn.Module.__init__(out)
    for attr in ("num_features", "eps", "momentum", "affine",
                 "track_running_stats", "channel_axis"):
        setattr(out, attr, getattr(bn, attr))
    out.process_group = process_group
    out.group_size = group_size
    # share, not copy: the same Parameter / buffer objects
    out.register_parameter("weight", bn.weight)
    out.register_parameter("bias", bn.bias)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        out.register_buffer(name, getattr(bn, name))
    out.train(bn.training)
    return out


def convert_sync_batchnorm(module: nn.Module, process_group=None,
                           group_size=None,
                           stats_compress: str = "none") -> nn.Module:
    """Recursively replace BatchNorm modules with SyncBatchNorm syncing
    over ``process_group`` (``None``: the default group), or within this
    rank's subgroup for a ``group_size`` (not both). A SyncBatchNorm
    already in the tree is re-scoped in place. Returns the (possibly new)
    root; inner modules are rewritten in place. ``stats_compress`` takes
    ``"none"`` only (exact statistics)."""
    group_size = _check_scope(process_group, group_size)
    check_stats_compress(stats_compress)
    return _convert(module, process_group, group_size)


def _convert(module: nn.Module, process_group, group_size) -> nn.Module:
    if isinstance(module, SyncBatchNorm):
        module.process_group = process_group
        module.group_size = group_size
        return module
    if isinstance(module, BatchNorm):
        return _convert_one(module, process_group, group_size)
    for name, child in list(module.named_children()):
        new = _convert(child, process_group, group_size)
        if new is not child:
            module.add_module(name, new)
    return module
