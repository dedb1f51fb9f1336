"""One named-sharding layout for the whole program: :class:`SpecLayout` —
the counterpart of ``tpu_syncbn.parallel.layout``.

A layout is a named N-D mesh of processes (axes canonically from
:mod:`tpu_syncbn_torch.mesh_axes`), per-parameter ``PartitionSpec`` rules
with wildcard name matching, and the *derived* reduce and scatter axes of
gradients, optimizer state and SyncBN statistics. ZeRO is a layout rule,
not a trainer mode: ``zero=True`` is the :meth:`SpecLayout.zero` preset
(the weight update sharded over the lone data axis), DP×FSDP the
:meth:`SpecLayout.fsdp` preset (sharded over a dedicated ``fsdp`` axis,
reduced the rest of the way over ``data``). Derived axes:

* ``stat_axes`` — SyncBN statistics reduce over *every* batch-sharding
  axis: a composed layout has replicas on more than one mesh axis;
* ``grad_reduce_axes`` — full gradient reduction axes for unsharded
  parameters (plain DP);
* ``grad_scatter_axis`` / ``grad_cross_axes`` — a sharded layout
  reduce-scatters the flat gradient over the shard axis first, then sums
  the surviving shard over the remaining batch axes.

In the port the mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(built by ``runtime.make_mesh``) and an axis is a process group:
:meth:`SpecLayout.group` hands each axis's group (``mesh.get_group``) to
the trainers, and the composed batch group over ``('data', 'fsdp')`` that
SyncBN and the loss mean use. At world 1 there is no process group and no
mesh (the port's single-card paths never initialize one): every group is
then ``None``, over which each collective is the identity and the
compressed ones still round. :meth:`SpecLayout.sharding` gives a spec's
DTensor placements (``Shard``/``Replicate``, one a mesh dim), the one
place placements come from.

Layout legality is explicit: :meth:`reject_reasons` names why a
composition is infeasible, in the JAX package's words.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Any, Iterable, Mapping, Sequence

import torch
import torch.distributed as tdist
from torch import nn

from tpu_syncbn_torch.mesh_axes import (
    ALL_AXES,
    DATA_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
)
from tpu_syncbn_torch.runtime import distributed as dist

__all__ = ["P", "SpecLayout"]

#: Axes whose mesh dimension shards the *batch* (replica-like axes). A
#: composed layout's SyncBN/gradient reductions span all of these.
_BATCH_AXES = (DATA_AXIS, FSDP_AXIS)

#: int8 compressed collectives encode the reduction in an i8 accumulator
#: budget: qmax = 127 // world (collectives._int8_qparams).
_INT8_MAX_WORLD = 127


class P(tuple):
    """A ``PartitionSpec``: one entry a tensor dim — ``None``
    (replicated), an axis name, or a tuple of axis names — printed as JAX
    prints its own (``PartitionSpec('data',)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


def _rank_name(entry: Any) -> Iterable[str]:
    """Axis names referenced by one PartitionSpec entry."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class SpecLayout:
    """A named mesh plus the sharding rules every consumer derives from.

    Parameters
    ----------
    axis_sizes:
        Mapping of canonical axis name (:data:`~tpu_syncbn_torch.mesh_axes.ALL_AXES`)
        to mesh dimension. At most one entry may be ``-1`` ("all remaining
        processes"). Ignored when ``mesh`` is given.
    rules:
        Sequence of ``(pattern, P)`` pairs matched against ``/``-joined
        parameter paths with :func:`fnmatch.fnmatchcase` (first match wins;
        unmatched parameters are replicated).
    param_shard_axis:
        Mesh axis the flat parameter/optimizer-state shards live on
        (ZeRO/FSDP), or ``None`` for replicated parameters. The default
        ``"auto"`` picks the ``fsdp`` axis when the mesh has one.
    devices:
        Optional rank list, in mesh order (default: ranks 0..world-1); a
        permutation of every process's rank.
    mesh:
        Adopt an existing ``DeviceMesh`` instead of building one. Its dim
        names must be canonical and in :data:`ALL_AXES` order.
    device:
        ``"cuda"`` (default; raises without a card) or ``"cpu"``: the
        mesh's device type.
    """

    def __init__(
        self,
        axis_sizes: Mapping[str, int] | None = None,
        *,
        rules: Sequence[tuple[str, P]] = (),
        param_shard_axis: str | None = "auto",
        devices: Sequence[int] | None = None,
        mesh: Any | None = None,
        device: str | torch.device | None = "cuda",
    ) -> None:
        self.device = dist.resolve_device(device)
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
        else:
            if not axis_sizes:
                axis_sizes = {DATA_AXIS: -1}
            names = tuple(axis_sizes)
        unknown = [a for a in names if a not in ALL_AXES]
        if unknown:
            raise ValueError(
                f"unknown mesh axes {unknown}; canonical axes are {list(ALL_AXES)}"
                " (tpu_syncbn.mesh_axes)"
            )
        order = sorted(names, key=ALL_AXES.index)
        world = dist.process_count()
        if mesh is not None:
            if tuple(order) != names:
                raise ValueError(
                    f"mesh axes {list(names)} out of canonical order; expected"
                    f" {order} (data-like outermost — mesh_axes.ALL_AXES)"
                )
            self.mesh = mesh
            sizes = tuple(int(s) for s in mesh.mesh.shape)
            ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        else:
            names, sizes = dist.mesh_shape(
                {a: int(axis_sizes[a]) for a in order}, world)
            ranks = list(range(world)) if devices is None else [int(r) for r in devices]
            if sorted(ranks) != list(range(world)):
                raise ValueError(
                    f"devices {list(ranks)} must list every rank 0..{world - 1} "
                    "once: each process is one device of the mesh")
            # world 1: no process group, so no mesh (every group is None)
            self.mesh = (dist.make_mesh(dict(zip(names, sizes)), device=self.device,
                                        devices=ranks) if world > 1 else None)
        #: the mesh's ranks, row-major over its dims
        self.ranks: tuple[int, ...] = tuple(ranks)

        self.axis_sizes: dict[str, int] = dict(zip(names, sizes))
        self.rules: tuple[tuple[str, P], ...] = tuple(
            (str(pat), spec) for pat, spec in rules
        )
        for pat, spec in self.rules:
            for entry in spec:
                for a in _rank_name(entry):
                    if a not in self.axis_sizes:
                        raise ValueError(
                            f"rule {pat!r} names axis {a!r} not in mesh"
                            f" {list(self.axis_sizes)}"
                        )

        if param_shard_axis == "auto":
            param_shard_axis = FSDP_AXIS if FSDP_AXIS in self.axis_sizes else None
        if param_shard_axis is not None:
            if param_shard_axis not in self.axis_sizes:
                raise ValueError(
                    f"param_shard_axis {param_shard_axis!r} not in mesh"
                    f" {list(self.axis_sizes)}"
                )
            if param_shard_axis not in _BATCH_AXES:
                raise ValueError(
                    f"param_shard_axis {param_shard_axis!r} must be a"
                    f" batch-sharding axis {list(_BATCH_AXES)}: flat ZeRO/FSDP"
                    " shards divide the *replicated* weight update"
                )
        self.param_shard_axis: str | None = param_shard_axis

        # ---- derived axes --------------------------------------------
        #: batch-sharding axes present in the mesh, canonical order
        self.data_axes: tuple[str, ...] = tuple(
            a for a in _BATCH_AXES if a in self.axis_sizes
        )
        #: the PartitionSpec *entry* for the batch dimension: a plain
        #: string for 1-D layouts, a tuple when composed, None when the
        #: mesh has no batch axis
        self.batch_entry: str | tuple[str, ...] | None = None
        if len(self.data_axes) == 1:
            self.batch_entry = self.data_axes[0]
        elif self.data_axes:
            self.batch_entry = self.data_axes
        #: axes SyncBN statistics reduce over (== batch axes)
        self.stat_axes = self.batch_entry
        #: axes a full (unsharded) gradient mean runs over
        self.grad_reduce_axes = self.batch_entry
        #: axis the flat gradient is reduce-scattered over (None: no scatter)
        self.grad_scatter_axis = param_shard_axis
        #: batch axes left to sum after the scatter stage
        self.grad_cross_axes: tuple[str, ...] = tuple(
            a for a in self.data_axes if a != param_shard_axis
        )
        #: total number of batch replicas (gradient-mean divisor)
        self.replica_world: int = math.prod(self.axis_sizes[a] for a in self.data_axes)
        #: processes each flat parameter shard is divided over
        self.shard_world: int = (
            self.axis_sizes[param_shard_axis] if param_shard_axis else 1
        )
        #: total processes in the mesh
        self.world: int = math.prod(self.axis_sizes.values())
        # axes tuple -> this rank's process group over them (group())
        self._groups: dict[tuple[str, ...], Any] = {}

    # ---- constructors (the presets) ----------------------------------

    @classmethod
    def data_parallel(
        cls, num_replicas: int | None = None, *, devices=None, rules=(), device="cuda"
    ) -> "SpecLayout":
        """Plain DP: 1-D ``data`` mesh, replicated params."""
        return cls(
            {DATA_AXIS: -1 if num_replicas is None else num_replicas},
            rules=rules, param_shard_axis=None, devices=devices, device=device,
        )

    @classmethod
    def zero(
        cls, num_replicas: int | None = None, *, devices=None, device="cuda"
    ) -> "SpecLayout":
        """``zero=True``: 1-D ``data`` mesh, flat param/opt shards over the
        same axis."""
        return cls(
            {DATA_AXIS: -1 if num_replicas is None else num_replicas},
            param_shard_axis=DATA_AXIS, devices=devices, device=device,
        )

    @classmethod
    def fsdp(
        cls, *, data: int = -1, fsdp: int, devices=None, rules=(), device="cuda"
    ) -> "SpecLayout":
        """Composed DP×FSDP: 2-D ``('data','fsdp')`` mesh, batch sharded
        ``P(('data','fsdp'))``, flat param/opt shards over ``fsdp``."""
        return cls(
            {DATA_AXIS: data, FSDP_AXIS: fsdp},
            param_shard_axis=FSDP_AXIS, devices=devices, rules=rules, device=device,
        )

    @classmethod
    def tensor_parallel(
        cls, *, data: int = -1, model: int, rules: Sequence[tuple[str, P]],
        devices=None, device="cuda",
    ) -> "SpecLayout":
        """Composed DP×TP: 2-D ``('data','model')`` mesh; ``rules`` name
        the tensor-sharded params."""
        return cls(
            {DATA_AXIS: data, MODEL_AXIS: model},
            rules=rules, param_shard_axis=None, devices=devices, device=device,
        )

    @classmethod
    def from_mesh(
        cls, mesh, *, rules=(), param_shard_axis: str | None = "auto", device="cuda"
    ) -> "SpecLayout":
        """Wrap an existing canonical-axis ``DeviceMesh``."""
        return cls(mesh=mesh, rules=rules, param_shard_axis=param_shard_axis,
                   device=device)

    # ---- process groups ------------------------------------------------

    def group(self, axes):
        """This rank's process group over ``axes`` (one axis name or a
        tuple of them): ``None`` when they hold one process (world 1
        included), the default world group when they span the mesh, the
        mesh's own group for one axis (``mesh.get_group``), else a group
        over the ranks that share this rank's coordinates on every other
        axis — built once per layout, by every rank for every subgroup in
        the same order (``torch.distributed`` requires it)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        for a in axes:
            if a not in self.axis_sizes:
                raise ValueError(f"axis {a!r} not in mesh {list(self.axis_sizes)}")
        size = math.prod(self.axis_sizes[a] for a in axes)
        if size == 1:
            return None
        if size == self.world:
            return tdist.group.WORLD
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        key = tuple(sorted(axes, key=ALL_AXES.index))
        if key not in self._groups:
            self._groups[key] = self._subgroup(key)
        return self._groups[key]

    def _subgroup(self, axes: tuple[str, ...]):
        names = list(self.axis_sizes)
        grid = torch.tensor(self.ranks).view(*self.axis_sizes.values())
        # the named axes last, flattened: one row a subgroup
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        rows = grid.permute(*rest, *keep).reshape(-1, math.prod(
            self.axis_sizes[a] for a in axes)).tolist()
        mine, _ = tdist.new_subgroups_by_enumeration(rows)
        return mine

    def group_axes(self, group) -> tuple[str, ...] | None:
        """The mesh axes ``group`` spans among the groups this layout
        hands out (:meth:`group`), or ``None`` for a group it does not
        hold: ``()`` for no group, every axis for the world group, an
        axis for its mesh group, the axes a composed subgroup was built
        for. Builds no group (the audit's placement pass reads it)."""
        if group is None:
            return ()
        if group is tdist.group.WORLD:
            return tuple(self.axis_sizes)
        name = getattr(group, "group_name", None)

        def same(g) -> bool:
            return g is group or (name is not None and getattr(g, "group_name", None) == name)

        if self.mesh is not None:
            for a in self.axis_sizes:
                if self.axis_sizes[a] > 1 and same(self.mesh.get_group(a)):
                    return (a,)
        for axes, g in self._groups.items():
            if g is not None and same(g):
                return axes
        return None

    def batch_group(self):
        """The group SyncBN statistics, the loss mean and the gradient mean
        span: every batch-sharding axis (``stat_axes``)."""
        return self.group(self.data_axes)

    # ---- shardings ----------------------------------------------------

    def sharding(self, spec: P) -> list:
        """The DTensor placements of ``spec`` on this layout's mesh, one a
        mesh dim: ``Shard(i)`` where tensor dim ``i``'s entry names the
        axis, ``Replicate()`` elsewhere — the one place trainers get
        placements from."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for a in self.axis_sizes:
            dims = [i for i, entry in enumerate(spec) if a in _rank_name(entry)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    @property
    def replicated(self) -> list:
        return self.sharding(P())

    @property
    def batch_spec(self) -> P:
        """Leading-dim batch spec: ``P('data')``, ``P(('data','fsdp'))``…"""
        return P(self.batch_entry) if self.batch_entry is not None else P()

    @property
    def batch_sharding(self) -> list:
        return self.sharding(self.batch_spec)

    # ---- per-param rules ----------------------------------------------

    def spec_for(self, name: str) -> P:
        """PartitionSpec for one ``/``-joined param path (first matching
        wildcard rule wins; default replicated)."""
        for pat, spec in self.rules:
            if fnmatch.fnmatchcase(name, pat):
                return spec
        return P()

    def param_specs(self, tree) -> Any:
        """The PartitionSpec of every parameter, from the wildcard rules:
        for an ``nn.Module`` a ``{name: P}`` dict over
        ``named_parameters()`` (each name matched with ``.`` as ``/``);
        for a nested mapping the same nesting, leaf paths ``/``-joined."""
        if isinstance(tree, nn.Module):
            return {n: self.spec_for(n.replace(".", "/"))
                    for n, _ in tree.named_parameters()}

        def walk(node, path):
            if isinstance(node, Mapping):
                return {k: walk(v, f"{path}/{k}" if path else str(k))
                        for k, v in node.items()}
            return self.spec_for(path)

        return walk(tree, "")

    def param_shardings(self, tree) -> Any:
        def walk(node):
            if isinstance(node, P):
                return self.sharding(node)
            return {k: walk(v) for k, v in node.items()}

        return walk(self.param_specs(tree))

    # ---- legality ------------------------------------------------------

    def reject_reasons(
        self, *, compress: str = "none", group_size: int | None = None
    ) -> list[str]:
        """Why this layout (with these knobs) cannot train — empty when
        legal. Reasons are the JAX package's strings, letter for letter."""
        reasons: list[str] = []
        if compress == "int8":
            if self.shard_world > _INT8_MAX_WORLD:
                reasons.append(
                    f"layout: int8 accumulator budget needs shard world"
                    f" <= {_INT8_MAX_WORLD}, got {self.shard_world}"
                )
            cross = 1
            for a in self.grad_cross_axes:
                cross *= self.axis_sizes[a]
            if self.param_shard_axis is None:
                cross = self.replica_world
            if cross > _INT8_MAX_WORLD:
                reasons.append(
                    f"layout: int8 accumulator budget needs reduce world"
                    f" <= {_INT8_MAX_WORLD}, got {cross}"
                )
        if group_size is not None and isinstance(self.stat_axes, tuple):
            reasons.append(
                "layout: grouped BN stats need a single stat axis"
                " (the butterfly permutation is 1-D); composed layout"
                f" syncs over {self.stat_axes}"
            )
        if self.param_shard_axis is not None and MODEL_AXIS in self.axis_sizes:
            reasons.append(
                "layout: fsdp×tensor param sharding not implemented"
                " (flat ZeRO shards and per-param rules both own the params)"
            )
        if self.param_shard_axis is not None and PIPE_AXIS in self.axis_sizes:
            reasons.append(
                "layout: fsdp×pipe not implemented (PipelineTrainer"
                " shards params over the pipe axis)"
            )
        if not self.data_axes and self.param_shard_axis is not None:
            reasons.append("layout: param sharding needs a batch axis")
        return reasons

    def check(self, *, compress: str = "none", group_size=None) -> None:
        """Raise ``ValueError`` with every named reason when illegal."""
        reasons = self.reject_reasons(compress=compress, group_size=group_size)
        if reasons:
            raise ValueError("; ".join(reasons))

    # ---- misc ----------------------------------------------------------

    def describe(self) -> dict:
        """Loggable summary, the JAX package's keys and values."""
        return {
            "axes": dict(self.axis_sizes),
            "batch_spec": str(self.batch_spec),
            "param_shard_axis": self.param_shard_axis,
            "grad_cross_axes": list(self.grad_cross_axes),
            "replica_world": self.replica_world,
            "shard_world": self.shard_world,
            "rules": [(pat, str(spec)) for pat, spec in self.rules],
        }

    def _mesh_key(self) -> tuple:
        return (tuple(self.axis_sizes.items()), self.ranks, self.device.type)

    def __eq__(self, other) -> bool:
        if not isinstance(other, SpecLayout):
            return NotImplemented
        return (
            self._mesh_key() == other._mesh_key()
            and self.rules == other.rules
            and self.param_shard_axis == other.param_shard_axis
        )

    def __hash__(self) -> int:
        return hash((self._mesh_key(), self.rules, self.param_shard_axis))

    def __repr__(self) -> str:
        axes = ",".join(f"{a}={n}" for a, n in self.axis_sizes.items())
        shard = f", shard={self.param_shard_axis}" if self.param_shard_axis else ""
        nrules = f", rules={len(self.rules)}" if self.rules else ""
        return f"SpecLayout({axes}{shard}{nrules})"
