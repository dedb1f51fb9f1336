"""ZeRO-style flat parameter layout for sharded optimizer training — the
counterpart of ``tpu_syncbn.parallel.zero``.

DDP replicates parameters AND optimizer state on every rank. ZeRO
(Rajbhandari et al., 2020) removes that redundancy by partitioning; this
module is the pure-data part of ``DataParallel(zero=True)`` and of the
``SpecLayout.fsdp`` layouts:

* parameters are kept as **flat shards** — one 1-D vector per dtype,
  zero-padded to a multiple of the shard world, each rank holding a
  contiguous ``1/world`` slice — which the user's optimizer updates, so
  its state (Adam's moments, 2× the parameters in f32) is born sharded;
* each step one reduce-scatter averages AND shards the flat gradients,
  and one all-gather a dtype rebuilds the full parameters.

:class:`FlatLayout` flattens a name → tensor mapping (``named_parameters()``
order, each tensor in its logical — contiguous — order, whatever its
memory format: a channels-last weight is read and written by copies,
never by aliasing its storage) and back. Gradients flatten with the SAME
layout, which is what lines the scattered gradient shard up with the
parameter shard.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["FlatLayout", "check_elementwise", "dtype_key", "unshard_params"]


def dtype_key(dtype: torch.dtype) -> str:
    """A dtype's group key, JAX's name for it (``"float32"``,
    ``"bfloat16"``): the keys of every flat store and checkpoint."""
    return str(dtype).removeprefix("torch.")


def check_elementwise(optimizer: torch.optim.Optimizer) -> None:
    """Reject optimizers whose update needs a view across the parameter
    vector (a global-norm clip, say): under ZeRO each rank updates only
    its 1/world shard, so such an update would compute its statistic per
    shard and silently diverge from the replicated trainer. Probe
    numerically, as the JAX package does: 3 steps of non-proportional
    gradients on a 16-vector must equal the same steps on four 4-element
    shards (fresh instances of ``type(optimizer)`` with its group's
    hyperparameters, on the CPU).

    Also rejected: more than one param group (a flat shard mixes
    parameters, so per-group options cannot survive), and optimizers whose
    ``step`` needs a closure (LBFGS)."""
    groups = optimizer.param_groups
    if len(groups) != 1:
        raise ValueError(
            f"zero=True needs an optimizer with one param group, got {len(groups)}: "
            "a flat shard mixes every parameter, so per-group options (weight "
            "decay on some parameters only, say) cannot survive the flattening")
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError(
            "zero=True cannot shard LBFGS: its step needs a closure that "
            "re-evaluates the loss over the whole parameter vector")
    hyper = {k: (float(v) if isinstance(v, torch.Tensor) and v.numel() == 1 else v)
             for k, v in groups[0].items() if k != "params"}
    for k in ("capturable", "fused", "foreach"):  # the probe runs on the CPU
        if k in hyper:
            hyper[k] = False if k == "capturable" else None

    rng = np.random.default_rng(0)
    gs = [torch.from_numpy(rng.standard_normal(16).astype(np.float32) * (k + 1))
          for k in range(3)]
    vec0 = torch.from_numpy(rng.standard_normal(16).astype(np.float32))

    def run(vec, grads):
        p = nn.Parameter(vec.clone())
        opt = type(optimizer)([p], lr=hyper.get("lr", 1e-3))
        opt.param_groups[0].update(hyper)
        for g in grads:
            p.grad = g.clone()
            opt.step()
        return p.detach().numpy()

    full = run(vec0, gs)
    parts = [run(vec0[i * 4:(i + 1) * 4], [g[i * 4:(i + 1) * 4] for g in gs])
             for i in range(4)]
    if not np.allclose(full, np.concatenate(parts), rtol=1e-5, atol=1e-7):
        raise ValueError(
            "zero=True requires an elementwise optimizer: this optimizer's "
            "update on a vector differs from shard-wise updates (a "
            "global-view transform like clip_by_global_norm?). Under ZeRO "
            "each device sees only its 1/world parameter shard, so such a "
            "transform would silently train differently than zero=False."
        )


def unshard_params(layout: "FlatLayout", store: Mapping[str, torch.Tensor], group=None):
    """Gather ZeRO flat parameter shards back into the full tree — the
    serving-side inverse of the training layout, through host memory:
    ``store`` is this rank's ``{dtype: shard}``, gathered over ``group``
    (the shard group; ``None`` at world 1), and the full vectors are
    unflattened on the host into ``{name: CPU tensor}``. The on-device
    alternative is :func:`tpu_syncbn_torch.parallel.redistribute.portable_redistribute`."""
    from tpu_syncbn_torch.parallel import collectives

    full = {dt: collectives.all_gather(v, group, tiled=True) for dt, v in store.items()}
    return layout.unflatten_host(full)


class FlatLayout:
    """Dtype-grouped flat layout of a name → tensor mapping (or of a
    module's ``named_parameters()``).

    Tensors are grouped by dtype (one flat vector per dtype), concatenated
    in the mapping's order, each in its logical order, and zero-padded so
    every vector's length is a multiple of ``world`` (divisible by the
    reduce-scatter and the all-gather)."""

    def __init__(self, tree, world: int):
        named = list(tree.named_parameters()) if isinstance(tree, nn.Module) \
            else list(tree.items())
        self.names = [n for n, _ in named]
        self.world = int(world)
        #: (dtype key, shape, numel) per tensor, in order
        self.specs = [(dtype_key(t.dtype), tuple(t.shape), t.numel()) for _, t in named]
        self.dtypes = {dtype_key(t.dtype): t.dtype for _, t in named}
        #: dtype key -> the indices of its tensors, in order
        self.groups: dict[str, list[int]] = {}
        for i, (dt, _, _) in enumerate(self.specs):
            self.groups.setdefault(dt, []).append(i)
        #: dtype key -> its vector's padded length
        self.padded: dict[str, int] = {}
        for dt, idxs in self.groups.items():
            total = sum(self.specs[i][2] for i in idxs)
            self.padded[dt] = total + (-total) % self.world

    @property
    def shard_sizes(self) -> dict[str, int]:
        return {dt: n // self.world for dt, n in self.padded.items()}

    def _leaves(self, tree) -> list:
        if isinstance(tree, nn.Module):
            tree = dict(tree.named_parameters())
        leaves = list(tree.values()) if isinstance(tree, Mapping) else list(tree)
        if len(leaves) != len(self.specs):
            raise ValueError(
                f"tree has {len(leaves)} leaves, layout expects {len(self.specs)}"
            )
        return leaves

    def flatten(self, tree) -> dict[str, torch.Tensor]:
        """Mapping (or list in the layout's order) -> ``{dtype: padded 1-D
        vector}``, new tensors (copies in logical order). The
        gradient-flattening path too (gradients share the parameters'
        names and shapes)."""
        leaves = self._leaves(tree)
        out = {}
        for dt, idxs in self.groups.items():
            parts = [leaves[i].reshape(-1) for i in idxs]
            pad = self.padded[dt] - sum(self.specs[i][2] for i in idxs)
            if pad:
                parts.append(parts[0].new_zeros(pad))
            out[dt] = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        return out

    def unflatten(self, vecs: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """``{dtype: padded 1-D vector}`` -> ``{name: tensor}``, each a
        contiguous view of its vector in the tensor's logical order (copy
        it into a parameter with ``copy_``, whatever its memory format)."""
        out = {}
        for dt, idxs in self.groups.items():
            vec, off = vecs[dt], 0
            for i in idxs:
                _, shape, size = self.specs[i]
                out[self.names[i]] = vec[off:off + size].view(shape)
                off += size
        return {n: out[n] for n in self.names}

    def unflatten_host(self, vecs: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Host-side inverse for checkpoints and introspection: full
        vectors in, ``{name: CPU tensor}`` out (copies)."""
        host = {dt: v.detach().cpu() for dt, v in vecs.items()}
        return {n: t.clone() for n, t in self.unflatten(host).items()}
