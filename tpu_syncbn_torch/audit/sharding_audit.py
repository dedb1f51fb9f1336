"""Layer 3 of the port's audit: placement and per-device peak memory over a
recorded step body — the counterpart of ``tpu_syncbn.audit.sharding_audit``.

JAX's layer 3 is an abstract interpretation over jaxpr text. The port has
no program text (``DESIGN.md`` §1): it records one application of a body
at the dispatcher (:class:`~tpu_syncbn_torch.audit.contracts.Recorder`),
and this layer runs in that same dispatch mode — one pass, no second walk
of the body (``DESIGN.md`` §8). Every recorded body runs one rank's code on
that rank's tensors, which is JAX's *local* view (a ``shard_map`` body)
everywhere, so the one domain is :class:`LocalLayout`: the set of mesh
axes a value is replicated over. Placement is kept per storage (a view
shares its base's), and propagates so:

* an op's value is replicated over the intersection of its tensor inputs'
  replicated sets (a ``_foreach_`` op element by element); an op with no
  tensor input (``zeros``, ``arange``, a Python scalar) is replicated over
  every axis; a random op (``torch.Tag.nondeterministic_seeded``) draws from
  a per-rank generator, so it is varying over every axis;
* an op that writes a tensor sets its storage's placement to the value
  written;
* the port's collectives (the ``collectives._tally`` seam, which names the
  call's process group) follow JAX's ``_COLLECTIVE_EFFECT``: the ``c10d``
  ops after a seam call add the group's mesh axes to the replicated set of
  what they write (``psum``, ``pmax``, ``pmin``, ``all_gather``,
  ``broadcast``) or remove them (``reduce_scatter``, ``ppermute``,
  ``all_to_all``); each such call is an *explained* layout change.

On top of the placements the pass reports JAX's three things:

* **accidental replication** — a storage the body creates, replicated on
  every device of a mesh of more than one, at or above
  :data:`REPLICATION_THRESHOLD_BYTES`;
* **implicit resharding** — a placement change no declared collective
  explains: an in-place write into a declared state leaf by a value that
  varies over a mesh axis the leaf's declared spec replicates it over (the
  replicas diverge silently), or an output declared over fewer axes than
  it varies over;
* **per-device peak memory** — the largest sum of live storage bytes on the
  rank over the body, from the labelled inputs on, each storage once
  whatever its views, a storage leaving when its weak reference expires:
  what the rank held, not an estimate. ``xla_peak_bytes`` keeps JAX's name
  for the independent reading, the allocator's, of the same application
  (``Recorder(memory=True)``, through ``obs.profiling.allocation_peak``).

Results serialize as a :class:`~tpu_syncbn_torch.audit.contracts.ShardingContract`
block inside each program's golden.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Mapping, Sequence

import torch

#: Fully-replicated intermediates at or above this per-device footprint
#: are reported as accidental replication (``sharding.replication``);
#: JAX's threshold (``tpu_syncbn/audit/sharding_audit.py:76``).
REPLICATION_THRESHOLD_BYTES = 1 << 20

#: How many detail strings each detector keeps (counts are exact).
_MAX_DETAIL = 8

#: The seam's op → its effect on the replicated set of what its ``c10d``
#: ops write: JAX's ``_COLLECTIVE_EFFECT`` over the port's seam names
#: (``pmean`` and ``psum_flat`` are psums; ``broadcast`` replicates).
COLLECTIVE_EFFECT = {
    "psum": "add", "pmean": "add", "psum_flat": "add", "pmax": "add",
    "pmin": "add", "all_gather": "add", "broadcast": "add",
    "reduce_scatter": "sub", "ppermute": "sub", "all_to_all": "sub",
}

#: ``c10d`` op → (index of the argument it writes, index of the argument
#: its written value comes from); ``send`` writes nothing.
_WIRE_IO = {
    "allreduce_": (0, 0),
    "allgather_": (0, 1),
    "_reduce_scatter_base_": (0, 1),
    "alltoall_base_": (0, 1),
    "broadcast_": (0, 0),
    "recv_": (0, 0),
    "send": (None, 0),
}

#: Ops that write arguments their schema does not mark as written: the
#: batch norms' running statistics in training mode — op → (indices of the
#: written arguments, index of the ``training`` flag).
_UNANNOTATED_WRITES = {
    "native_batch_norm": ((3, 4), 5),
    "cudnn_batch_norm": ((3, 4), 5),
    "miopen_batch_norm": ((3, 4), 5),
}

#: In-place ops that overwrite their target whole: its old value is not
#: part of the value written.
_OVERWRITES = frozenset({"copy_", "fill_", "zero_", "_foreach_copy_", "_foreach_zero_"})


@dataclasses.dataclass(frozen=True)
class LocalLayout:
    """The set of mesh axes a per-rank value is *replicated over*
    (identical across). Empty = fully rank-varying; every axis = every
    rank holds the same bytes (JAX's ``LocalLayout``)."""

    replicated: frozenset


# -- spec strings (JAX's helpers, over the port's P) --------------------------


def _norm_entry(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_to_dims(spec, rank: int) -> tuple[tuple[str, ...], ...]:
    """A PartitionSpec (or None) to a rank-padded dims tuple."""
    entries = tuple(spec) if spec is not None else ()
    dims = [_norm_entry(e) for e in entries[:rank]]
    dims += [()] * (rank - len(dims))
    return tuple(dims)


def dims_to_spec_str(dims: Sequence[tuple[str, ...]]) -> str:
    """Canonical spec string for a dims tuple — trailing unsharded dims
    trimmed, so ``P('data')`` and ``P('data', None)`` print the same."""
    dims = list(dims)
    while dims and dims[-1] == ():
        dims.pop()
    if not dims:
        return "P()"
    parts = []
    for d in dims:
        if not d:
            parts.append("None")
        elif len(d) == 1:
            parts.append(f"'{d[0]}'")
        else:
            parts.append("(" + ", ".join(f"'{a}'" for a in d) + ")")
    return f"P({', '.join(parts)})"


def spec_leaf_str(spec) -> str:
    """Canonical string for a declared PartitionSpec leaf."""
    entries = tuple(spec) if spec is not None else ()
    return dims_to_spec_str([_norm_entry(e) for e in entries])


def spec_axes(spec) -> frozenset:
    """Every mesh axis a spec names."""
    return frozenset(a for e in (tuple(spec) if spec is not None else ())
                     for a in _norm_entry(e))


def broadcast_spec(spec, example) -> list:
    """Expand a prefix spec tree (one ``P`` covering a whole argument, or a
    dict/tuple/list container of such prefixes) into one spec per tensor
    leaf of ``example``, in :func:`~tpu_syncbn_torch.audit.contracts.tensor_leaves`
    order (dicts in their own order)."""
    from tpu_syncbn_torch.audit.contracts import tensor_leaves
    from tpu_syncbn_torch.parallel.layout import P

    def rec(s, e) -> list:
        if s is None or isinstance(s, P):
            return [s] * len(tensor_leaves(e))
        if isinstance(s, dict):
            if set(s) != set(e):
                raise ValueError(f"spec keys {sorted(s)} do not match arg keys {sorted(e)}")
            return [x for k in e for x in rec(s[k], e[k])]
        if isinstance(s, (tuple, list)):
            if len(s) != len(e):
                raise ValueError(f"spec arity {len(s)} does not match arg arity {len(e)}")
            return [x for ss, ee in zip(s, e) for x in rec(ss, ee)]
        raise TypeError(f"unsupported spec node {type(s).__name__} — specs are "
                        "PartitionSpecs or dict/tuple/list containers of them")

    return rec(spec, example)


def group_axes(group, mesh_axes: Mapping[str, int], layout=None) -> frozenset | None:
    """The mesh axes a process group spans, through the program's layout
    (``SpecLayout.group_axes``): no group spans none, the default world
    group every axis. ``None``: a group the program does not name."""
    import torch.distributed as tdist

    if layout is not None:
        got = layout.group_axes(group)
        if got is not None:
            return frozenset(got)
    if group is None:
        return frozenset()
    if tdist.is_initialized() and group is tdist.group.WORLD:
        return frozenset(mesh_axes)
    return None


# -- the flow result ------------------------------------------------------------


@dataclasses.dataclass
class ShardingFlow:
    """What one pass learned about one recorded body (counts per
    optimizer step, the peak the body's)."""

    mesh_axes: dict[str, int]
    in_specs: dict[str, list[str]]
    out_specs: list[str]
    collectives_explained: int
    implicit_reshards: int
    reshard_detail: list[str]
    replicated_intermediates: int
    replication_detail: list[str]
    max_replicated_bytes: int
    peak_bytes_per_device: int
    replication_threshold: int
    #: the labelled inputs' bytes (each storage once)
    input_bytes: int = 0
    xla_peak_bytes: int | None = None
    #: each output leaf's (axes it varies over, spec string), state written
    #: in place included: what :func:`merge_out_leaves` combines over ranks
    out_leaves: list = dataclasses.field(default_factory=list)

    def out_spec_strs(self) -> list[str]:
        """Distinct canonical spec strings over the program outputs."""
        return sorted(set(self.out_specs))


#: How long :meth:`Placement.flow` waits for a storage a collective sent to
#: die, when the body no longer holds it: gloo's worker thread drops its own
#: reference to a finished collective's tensors a moment after the wait
#: returns.
WIRE_RELEASE_S = 0.05


class _Storage:
    __slots__ = ("ref", "nbytes", "repl", "counted", "declared", "label", "born", "last",
                 "wire")

    def __init__(self, ref, nbytes, repl, counted, born):
        self.ref, self.nbytes, self.repl, self.counted = ref, nbytes, repl, counted
        self.declared = self.label = None
        self.born = self.last = born
        self.wire = False


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _detail(t: torch.Tensor) -> str:
    return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"


class Placement:
    """The placement and liveness tracker a :class:`Recorder` drives from
    its dispatch mode: ``on_seam`` at each seam call, ``on_op`` after each
    dispatched op, :meth:`flow` at the end.

    ``in_specs`` maps each label of ``state`` to its declared spec tree
    (:func:`broadcast_spec`); ``declared`` names the labels whose leaves are
    state the body updates in place (the implicit-reshard detector's
    targets); ``layout`` maps process groups to mesh axes;
    ``out_specs`` (optional) declares the outputs' specs, as a JAX builder
    declares its ``shard_map`` ``out_specs``."""

    def __init__(self, *, mesh_axes: Mapping[str, int], in_specs: Mapping[str, Any],
                 state: Mapping[str, list], declared: Sequence[str] = (), layout=None,
                 out_specs=None, threshold: int = REPLICATION_THRESHOLD_BYTES):
        from torch.multiprocessing.reductions import StorageWeakRef

        self._ref = StorageWeakRef
        self.mesh_axes = {str(a): int(n) for a, n in mesh_axes.items()}
        self.all_axes = frozenset(self.mesh_axes)
        # nothing varies over an axis of one device (world 1: every axis)
        self.trivial = frozenset(a for a, n in self.mesh_axes.items() if n == 1)
        self.multi = math.prod(self.mesh_axes.values()) > 1
        self.layout = layout
        self.threshold = int(threshold)
        self.out_spec_decl = out_specs
        # every storage seen, by address: the weak references keep the
        # addresses from being reused while the body records
        self._stores: dict[int, _Storage] = {}
        self._op = 0  # index of the dispatched op being recorded
        self._effect = None  # (add|sub, axes) of the last seam call
        self.explained = 0
        self.reshards = 0
        self.reshard_detail: list[str] = []
        self.replicated = 0
        self.replication_detail: list[str] = []
        self.max_replicated_bytes = 0
        self.errors: list[str] = []
        self.in_specs: dict[str, list[str]] = {}
        self._label_specs: list[tuple[torch.Tensor, Any]] = []
        for label, leaves in state.items():
            specs = broadcast_spec(in_specs.get(label), leaves) if label in in_specs \
                else [None] * len(leaves)
            self.in_specs[label] = sorted({spec_leaf_str(s) for s in specs})
            for t, s in zip(leaves, specs):
                repl = (self.all_axes - spec_axes(s)) | self.trivial
                st = self._store(t) or self._add(t, repl, counted=True)
                if st is None:  # a tensor with no storage
                    continue
                st.repl = st.repl & repl
                if label in declared:
                    st.declared, st.label = repl, f"{label} {spec_leaf_str(s)}"
                self._label_specs.append((t, s))
        self.input_bytes = sum(st.nbytes for st in self._stores.values())

    # -- storages --------------------------------------------------------------

    def _store(self, t: torch.Tensor) -> _Storage | None:
        """The tracked storage of ``t``, its last use now."""
        try:
            st = self._stores.get(t.untyped_storage()._cdata)
        except (RuntimeError, NotImplementedError):
            return None
        if st is not None:
            st.last = self._op
        return st

    def _add(self, t: torch.Tensor, repl: frozenset, *, counted: bool) -> _Storage | None:
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None
        st = _Storage(self._ref(s), s.nbytes(), repl, counted, self._op)
        self._stores[s._cdata] = st
        return st

    def placement_of(self, t: torch.Tensor) -> LocalLayout:
        """``t``'s placement now: the mesh axes it is replicated over."""
        return LocalLayout(self._repl(t))

    def _repl(self, t: torch.Tensor) -> frozenset:
        st = self._store(t)
        if st is None:  # made before the body and no label's: replicated
            st = self._add(t, self.all_axes, counted=False)
        return self.all_axes if st is None else st.repl

    def _peak(self) -> int:
        """The most bytes live at once over the recorded ops. A storage is
        live from the op that made it (the labelled inputs: from the start)
        to its last use by an op when it died inside the body, else to the
        end (``DESIGN.md`` §8: its death is read at the end, not when it
        happened, which for a collective's payload races with gloo's
        worker thread)."""
        deadline = time.monotonic() + WIRE_RELEASE_S
        while any(st.wire and not st.ref.expired() for st in self._stores.values()) \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        end = self._op + 1
        delta = [0] * (end + 1)
        for st in self._stores.values():
            if st.counted:
                delta[st.born] += st.nbytes
                delta[st.last + 1 if st.ref.expired() else end] -= st.nbytes
        held = most = 0
        for d in delta:
            held += d
            most = max(most, held)
        return most

    # -- events ------------------------------------------------------------------

    def on_seam(self, op: str, group) -> None:
        axes = group_axes(group, self.mesh_axes, self.layout)
        if axes is None:
            self.errors.append(f"collectives.{op} over a process group the program's "
                               "layout does not name")
            axes = frozenset()
        axes &= self.all_axes
        self._effect = (COLLECTIVE_EFFECT.get(op), axes)
        if axes:
            self.explained += 1

    def _write(self, op: str, t: torch.Tensor, val: frozenset) -> None:
        val = val | self.trivial
        st = self._store(t)
        if st is None:  # made before the body and no label's
            self._add(t, val, counted=False)
            return
        whole = t.numel() * t.element_size() >= st.nbytes
        st.repl = val if whole else st.repl & val
        if st.declared is not None and not st.declared <= val:
            self.reshards += 1
            if len(self.reshard_detail) < _MAX_DETAIL:
                self.reshard_detail.append(
                    f"{op}: {st.label} leaf {_detail(t)} written by a value varying over "
                    f"{sorted(st.declared - val)} that no collective explains")

    def _new(self, op: str, t: torch.Tensor, val: frozenset) -> None:
        val = val | self.trivial
        st = self._add(t, val, counted=True)
        if st is None or not self.multi or val != self.all_axes:
            return
        self.max_replicated_bytes = max(self.max_replicated_bytes, st.nbytes)
        if st.nbytes >= self.threshold:
            self.replicated += 1
            if len(self.replication_detail) < _MAX_DETAIL:
                self.replication_detail.append(f"{op}: {_detail(t)} ({st.nbytes} B/device)")

    def on_op(self, func, args, kwargs, out, written) -> None:
        """One dispatched op: ``written`` holds the tensors its schema
        writes (in place, ``out=``)."""
        ns, name = func.namespace, func._opname
        self._op += 1
        if ns == "c10d":
            self._on_wire(name, args)
            return
        hidden = _UNANNOTATED_WRITES.get(name)
        if hidden is not None and len(args) > hidden[1] and args[hidden[1]]:
            written = list(written) + [args[i] for i in hidden[0]
                                       if isinstance(args[i], torch.Tensor)]
        if torch.Tag.nondeterministic_seeded in func.tags:
            vals = None
            val = frozenset()
        else:
            skip = {id(t) for t in written} if name in _OVERWRITES or not name.endswith("_") \
                else set()
            ins = [t for t in _tensors(list(args) + list(kwargs.values()), [])
                   if id(t) not in skip]
            val = self.all_axes
            for t in ins:
                val = val & self._repl(t)
            vals = self._foreach_vals(name, args, skip) if name.startswith("_foreach_") else None
        for i, t in enumerate(written):
            self._write(name, t, vals[i] if vals and i < len(vals) else val)
        for t in _tensors(out, []):
            if self._store(t) is None:
                self._new(name, t, val)

    def _foreach_vals(self, name: str, args, skip) -> list | None:
        """A ``_foreach_`` op's value element by element: the i-th element
        of each list argument, with every other tensor argument."""
        lists = [a for a in args if isinstance(a, (list, tuple)) and a
                 and isinstance(a[0], torch.Tensor)]
        if not lists:
            return None
        common = self.all_axes
        for a in args:
            if isinstance(a, torch.Tensor):
                common = common & self._repl(a)
        out = []
        for i in range(len(lists[0])):
            v = common
            for a in lists:
                if i < len(a) and id(a[i]) not in skip:
                    v = v & self._repl(a[i])
            out.append(v)
        return out

    def _on_wire(self, name: str, args) -> None:
        io = _WIRE_IO.get(name)
        if io is None:
            return
        dst_i, src_i = io
        base = self.all_axes
        for t in _tensors(args[src_i], []):
            base = base & self._repl(t)
            self._mark_wire(t)
        if dst_i is None:
            return
        kind, axes = self._effect or (None, frozenset())
        val = base | axes if kind == "add" else base - axes if kind == "sub" else base
        for t in _tensors(args[dst_i], []):
            self._write(name, t, val)
            self._mark_wire(t)

    def _mark_wire(self, t: torch.Tensor) -> None:
        st = self._store(t)
        if st is not None:
            st.wire = True

    # -- the result ----------------------------------------------------------------

    def _spec_str(self, repl: frozenset, declared=None) -> str:
        """An output's spec string: ``P()`` replicated over every axis, else
        its own declared spec, else the program's first declared spec
        varying over the same axes, else the axes on dimension 0."""
        varying = self.all_axes - repl
        if not varying:
            return "P()"
        if declared is not None and spec_axes(declared) == varying:
            return spec_leaf_str(declared)
        for _, s in self._label_specs:
            if spec_axes(s) == varying:
                return spec_leaf_str(s)
        return dims_to_spec_str([self._varying(repl)])

    def flow(self, outputs=(), *, steps: int = 1) -> ShardingFlow:
        """The pass's result: ``outputs`` are the body's returned values;
        the declared state leaves are outputs too (written in place).
        Counts are per optimizer step (``steps`` must divide them)."""
        from tpu_syncbn_torch.audit.contracts import ExtractionError

        peak = self._peak()
        reshards, details = self.reshards, list(self.reshard_detail)
        leaves: list[tuple[tuple[str, ...], str]] = []
        decl = None if self.out_spec_decl is None else \
            broadcast_spec(self.out_spec_decl, outputs)
        for i, t in enumerate(_leaf_tensors(outputs)):
            repl = self._repl(t)
            if decl is not None:
                want = self.all_axes - spec_axes(decl[i])
                if not want <= repl:
                    reshards += steps
                    if len(details) < _MAX_DETAIL:
                        details.append(f"output {i}: {_detail(t)} declared "
                                       f"{spec_leaf_str(decl[i])} but varying over "
                                       f"{sorted(want - repl)}")
                leaves.append((self._varying(repl), spec_leaf_str(decl[i])))
            else:
                leaves.append((self._varying(repl), self._spec_str(repl)))
        for t, s in self._label_specs:
            st = self._store(t)
            if st is not None and st.declared is not None:
                leaves.append((self._varying(st.repl), self._spec_str(st.repl, s)))
        counts = {"collectives_explained": self.explained, "implicit_reshards": reshards,
                  "replicated_intermediates": self.replicated}
        for field, n in counts.items():
            if n % steps:
                raise ExtractionError(
                    "contract.scan_variance",
                    f"sharding.{field} = {n} over {steps} steps is not {steps} times one "
                    "step's — the steps of one chunk differ")
        if self.errors:
            raise ExtractionError("contract.extraction", self.errors[0])
        return ShardingFlow(
            mesh_axes=dict(self.mesh_axes),
            in_specs={k: list(v) for k, v in self.in_specs.items()},
            out_specs=sorted({spec for _, spec in leaves}),
            collectives_explained=self.explained // steps,
            implicit_reshards=reshards // steps,
            reshard_detail=details,
            replicated_intermediates=self.replicated // steps,
            replication_detail=list(self.replication_detail),
            max_replicated_bytes=self.max_replicated_bytes,
            peak_bytes_per_device=peak,
            replication_threshold=self.threshold,
            input_bytes=self.input_bytes,
            out_leaves=leaves,
        )

    def _varying(self, repl: frozenset) -> tuple[str, ...]:
        return tuple(a for a in self.mesh_axes if a not in repl)


def merge_out_leaves(per_rank: Sequence[list]) -> list[str]:
    """The outputs' spec strings over every rank: a value is replicated
    over an axis only when it is on every rank (a rank whose Python code
    branches on its index computes a different value: the pipeline's last
    stage), so each leaf varies over the union of the ranks' axes and takes
    the string of a rank that found exactly that union (else the union on
    dimension 0). Ranks that disagree on the number of outputs keep rank
    0's strings."""
    base = [list(v) for v in per_rank[0]]
    if any(len(r) != len(base) for r in per_rank):
        return sorted({spec for _, spec in base})
    out = set()
    for i in range(len(base)):
        axes = [tuple(r[i][0]) for r in per_rank]
        union = tuple(dict.fromkeys(a for ax in axes for a in ax))
        match = [r[i][1] for r, ax in zip(per_rank, axes) if set(ax) == set(union)]
        out.add(match[0] if match else dims_to_spec_str([union]))
    return sorted(out)


def _leaf_tensors(tree) -> list[torch.Tensor]:
    from tpu_syncbn_torch.audit.contracts import tensor_leaves

    return tensor_leaves(tree)


# -- entry points ------------------------------------------------------------------


def analyze_program(fn: Callable, example_args: Sequence, *, mesh_axes: Mapping[str, int],
                    in_specs: Sequence, arg_labels: Sequence[str] | None = None,
                    declared_donated: Sequence[str] = (), layout=None,
                    replication_threshold: int = REPLICATION_THRESHOLD_BYTES) -> ShardingFlow:
    """Apply ``fn(*example_args)`` once under the recorder and return the
    placement pass's result. ``in_specs`` is one prefix spec tree per
    argument (the shapes JAX's trainers hand to ``shard_map``), ``mesh_axes``
    the axis sizes, ``layout`` the ``SpecLayout`` whose groups the body's
    collectives run over. The state is put back afterwards."""
    from tpu_syncbn_torch.audit.contracts import Recorder

    labels = list(arg_labels or [f"arg{i}" for i in range(len(example_args))])
    rec = Recorder(dict(zip(labels, example_args)), restore=True, mesh_axes=mesh_axes,
                   in_specs=dict(zip(labels, in_specs)), declared=declared_donated,
                   layout=layout, replication_threshold=replication_threshold)
    with rec:
        rec.note_outputs(fn(*example_args))
    return rec.flow()
