"""``convert_sync_batchnorm`` — recursive module-tree rewrite, the
counterpart of ``tpu_syncbn.nn.convert``.

Every :class:`~tpu_syncbn_torch.nn.BatchNorm` (and subclass) becomes a
:class:`~tpu_syncbn_torch.nn.SyncBatchNorm` that *shares* the original's
parameters and buffers (the same tensor objects, so an optimizer built
before the conversion still updates them), with eps, momentum, affine,
track and channel-axis settings and the train/eval flag kept.
"""

from __future__ import annotations

from torch import nn

from tpu_syncbn_torch.nn.normalization import BatchNorm, SyncBatchNorm


def _convert_one(bn: BatchNorm, process_group) -> SyncBatchNorm:
    out = SyncBatchNorm.__new__(SyncBatchNorm)
    nn.Module.__init__(out)
    for attr in ("num_features", "eps", "momentum", "affine",
                 "track_running_stats", "channel_axis"):
        setattr(out, attr, getattr(bn, attr))
    out.process_group = process_group
    # share, not copy: the same Parameter / buffer objects
    out.register_parameter("weight", bn.weight)
    out.register_parameter("bias", bn.bias)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        out.register_buffer(name, getattr(bn, name))
    out.train(bn.training)
    return out


def convert_sync_batchnorm(module: nn.Module, process_group=None) -> nn.Module:
    """Recursively replace BatchNorm modules with SyncBatchNorm syncing
    over ``process_group`` (``None``: the default group). A SyncBatchNorm
    already in the tree is re-scoped to ``process_group`` in place. Returns
    the (possibly new) root; inner modules are rewritten in place."""
    if isinstance(module, SyncBatchNorm):
        module.process_group = process_group
        return module
    if isinstance(module, BatchNorm):
        return _convert_one(module, process_group)
    for name, child in list(module.named_children()):
        new = convert_sync_batchnorm(child, process_group)
        if new is not child:
            module.add_module(name, new)
    return module
