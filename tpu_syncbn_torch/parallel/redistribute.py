"""Portable train→serve parameter redistribution on the devices — the
counterpart of ``tpu_syncbn.parallel.redistribute``.

Training under ``DataParallel(zero=True)`` (or a ``SpecLayout.fsdp``
layout) keeps the optimizer's parameters in the ZeRO flat layout
(:class:`~tpu_syncbn_torch.parallel.zero.FlatLayout`): one padded 1-D
vector per dtype, each rank of the shard group holding a contiguous
``1/world`` slice. Serving wants the full parameter tree on every rank.
:func:`~tpu_syncbn_torch.parallel.zero.unshard_params` does that layout
change through host memory; this module does it on the devices (the
layout-change problem of "Memory-efficient array redistribution through
portable collective communication", arXiv 2112.01075, at whole-model
granularity): one tiled ``all_gather`` per dtype over the shard group,
then the unflatten as views of the gathered vectors, with no host copy.
Weight publication needs no gather of its own: the trainer writes the
gathered values into its module after every step, and
``serve.publish.serving_state`` reads the module.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from tpu_syncbn_torch.parallel import collectives

__all__ = ["build_redistribute", "portable_redistribute"]


def build_redistribute(layout, mesh, axis_name: str | None = None) -> Callable:
    """The redistribution for one ``FlatLayout`` on one mesh:
    ``{dtype: this rank's shard}`` in, ``{name: full tensor}`` out on the
    shards' device. ``mesh`` is a :class:`~tpu_syncbn_torch.parallel.layout.SpecLayout`
    (its shard axis, or ``axis_name``, names the group) or a process group
    itself (``None``: world 1). Build once per (layout, mesh) and reuse."""
    from tpu_syncbn_torch.parallel.layout import SpecLayout

    if isinstance(mesh, SpecLayout):
        group = mesh.group(axis_name or mesh.grad_scatter_axis or mesh.data_axes)
    else:
        group = mesh

    def gather_unflatten(store: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        full = {dt: collectives.all_gather(v, group, tiled=True) for dt, v in store.items()}
        return layout.unflatten(full)

    return gather_unflatten


def portable_redistribute(layout, store, mesh, axis_name: str | None = None):
    """Re-shard ZeRO flat parameter shards into the serving layout (the
    full tree on every rank) on the devices — the collective counterpart
    of :func:`~tpu_syncbn_torch.parallel.zero.unshard_params`."""
    return build_redistribute(layout, mesh, axis_name)(store)
