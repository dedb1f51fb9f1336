"""Program contracts: what a step body is *allowed* to do on the wire and
with its state, recorded at the dispatcher while the body runs — the
counterpart of ``tpu_syncbn.audit.contracts``.

The JAX package traces a jitted callable abstractly and reads the jaxpr.
The port has no program text: a K-step body becomes a CUDA graph by
running it once under capture, and a graph replays exactly the operators
that were dispatched while it was recorded. So the port's extractor is a
:class:`Recorder` — a ``TorchDispatchMode`` around one concrete
application of the body on tiny inputs (``DESIGN.md`` beside this file
says why, and what the alternatives did). A :class:`ProgramContract`
keeps the JAX field names and JSON shape, so a port golden reads like a
JAX one:

* **collectives** — calls by JAX primitive name (``psum``, ``pmax``,
  ``pmin``, ``all_gather``, ``reduce_scatter``, ``ppermute``,
  ``all_to_all``; ``broadcast`` for ``collectives.broadcast_``, which JAX
  writes as a masked ``psum``), with each call's per-replica payload
  bytes. Each call is seen twice: at the dispatcher (``c10d.*`` ops and
  their reduce op) and at the port's own seam (``collectives._tally``);
  the two must agree call for call, or extraction fails.
* **donation** — the state groups the body must update in place
  (``donated_declared``) against the leaves it wrote at an unchanged
  address (``donated_aliased``): an op's mutable argument overlapping
  the leaf, or its version counter advanced. A
  replaced leaf is what ``scan_driver.ScanSteps.stale`` guards against
  and counts zero here.
* **host callbacks** — host reads inside the body: ``aten._local_scalar_dense``
  (``.item()``, ``bool(t)``), ``aten.equal``, ``aten.is_nonzero`` and
  device-to-host copies. A read inside ``torch.optim.Optimizer.step`` is
  keyed ``<op>@optimizer.step`` (ROADMAP C.6).
* **upcasts** — widening float conversions by ``"src->dst"``.
* **sharding** (optional, layer 3: :mod:`~tpu_syncbn_torch.audit.sharding_audit`)
  — given the program's mesh axes and declared specs, where every value
  lives, the collectives that explain each change, implicit reshards,
  accidental replication and the per-device peak, in a
  :class:`ShardingContract` block.

Counts are per optimizer step: a body applied ``steps`` times must total
``steps`` times one application's (else :class:`ExtractionError` under
``contract.scan_variance``). :func:`weighted_cost_summary` is the
execution-weighted figure the planner reads: the flops of
``torch.utils.flop_counter`` and the bytes of every executed collective.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

#: Bump when the contract JSON shape changes incompatibly.
CONTRACT_SCHEMA = 1

#: Bump when the layer-3 sharding block's shape changes incompatibly (the
#: block is optional inside the contract JSON, so adding it did not bump
#: CONTRACT_SCHEMA) — JAX's value (``tpu_syncbn/audit/contracts.py:49``).
SHARDING_SCHEMA = 1

#: Relative tolerance of ``xla_peak_bytes`` against a golden: the
#: allocator's reading is a cross-check, not a number the pass controls.
XLA_PEAK_RTOL = 0.10

#: The port seam's op names (``collectives._tally``) → the JAX primitive a
#: call stands for, and the dispatcher kinds that may carry it.
SEAM_KINDS = {
    "psum": ("psum", {"psum"}),
    "pmean": ("psum", {"psum"}),        # JAX's pmean is a psum, then a scale
    "psum_flat": ("psum", {"psum"}),    # the trainer's fused gradient mean
    "pmax": ("pmax", {"pmax"}),
    "pmin": ("pmin", {"pmin"}),
    "all_gather": ("all_gather", {"all_gather"}),
    # gloo has no reduce-scatter: collectives.reduce_scatter all-reduces
    "reduce_scatter": ("reduce_scatter", {"reduce_scatter", "psum"}),
    "ppermute": ("ppermute", {"ppermute"}),
    "all_to_all": ("all_to_all", {"all_to_all"}),
    "broadcast": ("broadcast", {"broadcast"}),
}

#: Seam kinds that may issue no wire op on a rank: a rank named by no pair
#: of a permutation, and any exchange of a group of one.
SILENT_KINDS = frozenset({"ppermute", "all_to_all"})

#: ``c10d`` dispatcher ops → kind (all-reduces: by their reduce op);
#: ``(kind, index of the argument holding the sent tensors)``.
#: The ops ``parallel.collectives`` issues; any other ``c10d`` op fails the
#: cross-check.
_WIRE_OPS = {
    "allreduce_": (None, 0),
    "allgather_": ("all_gather", 1),
    "_reduce_scatter_base_": ("reduce_scatter", 1),  # reduce_scatter_tensor (NCCL)
    "alltoall_base_": ("all_to_all", 1),
    "broadcast_": ("broadcast", 0),
    "send": ("ppermute", 0),
    "recv_": ("ppermute", None),
}

#: Host reads of a device value: their dispatcher ops.
HOST_READ_OPS = frozenset({"_local_scalar_dense", "equal", "is_nonzero"})

#: ``torch.utils.flop_counter``'s formulas by op: 2·MACs of matmuls and
#: convolutions, forward and backward (``out_val`` the op's output).
_FLOP_FORMULAS = flop_registry

#: The key suffix of a host read made inside ``torch.optim.Optimizer.step``.
OPTIMIZER_SITE = "@optimizer.step"


class ExtractionError(ValueError):
    """A recording that cannot be a contract: the dispatcher and the seam
    disagree, an op is unknown, or a K-step total is not K times a step.
    ``rule`` names the audit rule it is reported under."""

    def __init__(self, rule: str, message: str):
        super().__init__(message)
        self.rule = rule


@dataclasses.dataclass
class ShardingContract:
    """The layer-3 block of one program, JAX's fields
    (``tpu_syncbn/audit/contracts.py:71-141``): the mesh, each label's
    distinct declared spec strings, the outputs' distinct specs (state
    written in place included), the collectives that explain a placement
    change, implicit reshards, accidental replication and the per-device
    peak of the recorded body. ``xla_peak_bytes`` is the allocator's reading
    of the same application (``DESIGN.md`` §8), null when none was taken."""

    name: str
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
    xla_peak_bytes: int | None = None
    #: each output leaf's (axes it varies over, spec string) on this rank,
    #: which the pinned world merges over ranks; not part of the JSON
    out_leaves: list = dataclasses.field(default_factory=list, compare=False, repr=False)

    def to_json(self) -> dict:
        return {
            "schema": SHARDING_SCHEMA,
            "mesh_axes": dict(sorted(self.mesh_axes.items())),
            "in_specs": {k: list(v) for k, v in sorted(self.in_specs.items())},
            "out_specs": list(self.out_specs),
            "collectives_explained": self.collectives_explained,
            "implicit_reshards": self.implicit_reshards,
            "reshard_detail": list(self.reshard_detail),
            "replicated_intermediates": self.replicated_intermediates,
            "replication_detail": list(self.replication_detail),
            "max_replicated_bytes": self.max_replicated_bytes,
            "peak_bytes_per_device": self.peak_bytes_per_device,
            "replication_threshold": self.replication_threshold,
            "xla_peak_bytes": self.xla_peak_bytes,
        }

    @classmethod
    def from_json(cls, name: str, blob: dict) -> "ShardingContract":
        if blob.get("schema") != SHARDING_SCHEMA:
            raise ValueError(
                f"sharding schema {blob.get('schema')!r} != {SHARDING_SCHEMA}"
                " — re-pin the golden (tpu_syncbn_torch/audit/DESIGN.md §8)")
        xla = blob.get("xla_peak_bytes")
        return cls(
            name=name,
            mesh_axes={k: int(v) for k, v in blob["mesh_axes"].items()},
            in_specs={k: list(v) for k, v in blob["in_specs"].items()},
            out_specs=list(blob["out_specs"]),
            collectives_explained=int(blob["collectives_explained"]),
            implicit_reshards=int(blob["implicit_reshards"]),
            reshard_detail=list(blob["reshard_detail"]),
            replicated_intermediates=int(blob["replicated_intermediates"]),
            replication_detail=list(blob["replication_detail"]),
            max_replicated_bytes=int(blob["max_replicated_bytes"]),
            peak_bytes_per_device=int(blob["peak_bytes_per_device"]),
            replication_threshold=int(blob["replication_threshold"]),
            xla_peak_bytes=int(xla) if xla is not None else None,
        )


@dataclasses.dataclass
class ProgramContract:
    """The contract of one step body, per optimizer step.
    ``donated_declared`` lists the argument labels the body must update in
    place; ``donated_aliased`` maps each label to the leaves it wrote in
    place (an undeclared label appears only when written). ``sharding``
    is the optional layer-3 block (:class:`ShardingContract`), there when
    the recorder was given the program's mesh axes and declared specs."""

    name: str
    world: int
    collectives: dict[str, int]
    collective_bytes: dict[str, int]
    donated_declared: list[str]
    donated_aliased: dict[str, int]
    host_callbacks: dict[str, int]
    upcasts: dict[str, int]
    sharding: ShardingContract | None = None

    def to_json(self) -> dict:
        out = {
            "schema": CONTRACT_SCHEMA,
            "name": self.name,
            "world": self.world,
            "collectives": dict(sorted(self.collectives.items())),
            "collective_bytes": dict(sorted(self.collective_bytes.items())),
            "donated_declared": list(self.donated_declared),
            "donated_aliased": dict(sorted(self.donated_aliased.items())),
            "host_callbacks": dict(sorted(self.host_callbacks.items())),
            "upcasts": dict(sorted(self.upcasts.items())),
        }
        if self.sharding is not None:
            out["sharding"] = self.sharding.to_json()
        return out

    @classmethod
    def from_json(cls, blob: dict) -> "ProgramContract":
        """A contract from its JSON, its ``sharding`` block included."""
        if blob.get("schema") != CONTRACT_SCHEMA:
            raise ValueError(
                f"contract schema {blob.get('schema')!r} != {CONTRACT_SCHEMA}"
                " — re-pin the golden (tpu_syncbn_torch/audit/DESIGN.md)"
            )
        sharding = None
        if blob.get("sharding") is not None:
            sharding = ShardingContract.from_json(blob["name"], blob["sharding"])
        return cls(
            name=blob["name"],
            world=int(blob["world"]),
            collectives={k: int(v) for k, v in blob["collectives"].items()},
            collective_bytes={k: int(v) for k, v in blob["collective_bytes"].items()},
            donated_declared=list(blob["donated_declared"]),
            donated_aliased={k: int(v) for k, v in blob["donated_aliased"].items()},
            host_callbacks={k: int(v) for k, v in blob["host_callbacks"].items()},
            upcasts={k: int(v) for k, v in blob["upcasts"].items()},
            sharding=sharding,
        )

    @property
    def total_collectives(self) -> int:
        return sum(self.collectives.values())


# ---------------------------------------------------------------------------
# the recorder


def tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of tuples, lists and dicts, in order."""
    from tpu_syncbn_torch.parallel import scan_driver

    return [t for t in scan_driver._leaves(tree) if isinstance(t, torch.Tensor)]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _is_float_upcast(src: torch.dtype, dst) -> bool:
    return (isinstance(dst, torch.dtype) and src.is_floating_point
            and dst.is_floating_point and dst.itemsize > src.itemsize)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensor_leaves(tensors))


_REDUCE_KINDS: dict[int, str] = {}
# op overload -> ((index, name, keyword-only) of each argument it writes)
_WRITE_ARGS: dict = {}


def _written_args(func) -> tuple:
    got = _WRITE_ARGS.get(func)
    if got is None:
        got = tuple((i, a.name, a.kwarg_only) for i, a in enumerate(func._schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
        _WRITE_ARGS[func] = got
    return got


def _extent(t: torch.Tensor) -> tuple[int, int, int]:
    """(storage address, first byte, end byte) of ``t``'s elements."""
    size = t.element_size()
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()) if n > 0)
    start = t.storage_offset() * size
    return t.untyped_storage().data_ptr(), start, start + span * size


def _reduce_kind(op) -> str:
    """The JAX kind of an all-reduce by its ``ReduceOp`` (the dispatcher
    passes it as a script object whose ``op()`` is the enum's value)."""
    if not _REDUCE_KINDS:
        R = tdist.ReduceOp.RedOpType
        _REDUCE_KINDS.update({int(R.SUM): "psum", int(R.MAX): "pmax", int(R.MIN): "pmin"})
    code = int(op.op())
    return _REDUCE_KINDS.get(code, f"reduce_op_{code}")


class _Dispatch(TorchDispatchMode):
    """The dispatcher half of :class:`Recorder`: every op by name, the
    ``c10d`` wire ops, host reads and widening conversions."""

    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rec._on_op(func, args, kwargs, out)
        return out


class Recorder:
    """Records one or more applications of a step body: a context manager.

    ``state`` maps labels to tensor trees (the trainer's parameter,
    buffer and optimizer-state groups, the batch); their addresses and
    version counters are read at entry and at exit. ``restore=True``
    also copies each leaf at entry and puts the copy back at exit, whether
    the body returned or raised. ``sync_debug=True``
    arms ``torch.cuda.set_sync_debug_mode("error")`` inside, so on the
    card a synchronizing call the dispatcher does not show raises.

    With ``mesh_axes`` and ``in_specs`` (each label's declared spec tree)
    the same dispatch mode also runs layer 3
    (:class:`~tpu_syncbn_torch.audit.sharding_audit.Placement`): ``declared``
    names the state labels the body updates in place, ``layout`` the
    ``SpecLayout`` whose groups its collectives use, ``out_specs`` the
    outputs' declared specs (given to :meth:`note_outputs`); ``memory=True``
    also takes the allocator's reading of the application
    (``xla_peak_bytes``). Read it with :meth:`flow`.

    Inside, every dispatched op is recorded (on every thread the body's
    autograd runs on), every ``collectives`` seam call made on those
    threads is noted (another thread's calls are not the body's), and flops
    are counted by ``torch.utils.flop_counter``'s formulas (the registry
    ``FlopCounterMode`` applies, here applied in this mode's own dispatch:
    the same counts at a fifth of the cost a step). Read the result with
    :meth:`contract`, :meth:`cost` and :meth:`as_text`."""

    def __init__(self, state: Mapping[str, Any] | None = None, *, restore: bool = False,
                 sync_debug: bool = False, mesh_axes: Mapping[str, int] | None = None,
                 in_specs: Mapping[str, Any] | None = None, declared: Sequence[str] = (),
                 layout=None, out_specs=None, memory: bool = False,
                 replication_threshold: int | None = None):
        self._state = {label: tensor_leaves(tree) for label, tree in (state or {}).items()}
        self._restore = restore
        self._sync_debug = sync_debug
        self._layer3 = None
        if mesh_axes is not None and in_specs is not None:
            from tpu_syncbn_torch.audit import sharding_audit

            self._layer3 = dict(
                mesh_axes=mesh_axes, in_specs=in_specs, declared=tuple(declared),
                layout=layout, out_specs=out_specs,
                threshold=(sharding_audit.REPLICATION_THRESHOLD_BYTES
                           if replication_threshold is None else replication_threshold))
        self._memory = memory and self._layer3 is not None
        #: the layer-3 tracker while recording (None without mesh and specs)
        self.placement = None
        self._outputs = ()
        self._reading = None
        self._lock = threading.Lock()
        #: every dispatched op overload, in order
        self.ops: list = []
        #: dispatcher wire events: (kind, bytes sent, op)
        self.wire: list[tuple] = []
        #: seam calls: (op, bytes, index of the first wire event after it)
        self.seam: list[tuple] = []
        self.host_reads: dict[str, int] = {}
        self.upcasts: dict[str, int] = {}
        self.written: dict[str, int] = {}
        self.flops = 0
        # storage address -> [(first byte, end byte)] of every tensor an op
        # wrote (its schema's mutable arguments): a foreach op under a
        # dispatch mode does not advance the version counter
        self._writes: dict[int, list] = {}
        self._in_optimizer = 0
        self._before = None
        self._saved = None
        self._mode = None

    # -- events --------------------------------------------------------------

    def _on_seam(self, op: str, nbytes: int, group=None) -> None:
        # the dispatch mode is on the recording thread's stack and on those
        # of the autograd threads its backward runs on, which inherit it
        if self._mode not in _get_current_dispatch_mode_stack():
            return
        with self._lock:
            self.seam.append((op, int(nbytes), len(self.wire)))
            if self.placement is not None:
                self.placement.on_seam(op, group)

    def _host_read(self, key: str) -> None:
        if self._in_optimizer:
            key += OPTIMIZER_SITE
        self.host_reads[key] = self.host_reads.get(key, 0) + 1

    def _on_op(self, func, args, kwargs, out) -> None:
        ns, op = func.namespace, func._opname
        count = _FLOP_FORMULAS.get(func._overloadpacket)
        with self._lock:
            self.ops.append(func)
            if count is not None:
                self.flops += int(count(*args, **kwargs, out_val=out))
            written = []
            for i, name, kw_only in _written_args(func):
                val = kwargs.get(name) if kw_only or i >= len(args) else args[i]
                for t in tensor_leaves(val):
                    written.append(t)
                    if t.numel():
                        ptr, lo, hi = _extent(t)
                        self._writes.setdefault(ptr, []).append((lo, hi))
            if self.placement is not None:
                self.placement.on_op(func, args, kwargs, out, written)
            if ns == "c10d":
                self._on_wire(op, args)
            elif ns != "aten":
                return
            elif op in HOST_READ_OPS:
                self._host_read(op)
            elif op == "_to_copy" and args and isinstance(args[0], torch.Tensor):
                src = args[0]
                dev = kwargs.get("device")
                if src.is_cuda and dev is not None and torch.device(dev).type == "cpu":
                    self._host_read("d2h_copy")
                dst = kwargs.get("dtype")
                if _is_float_upcast(src.dtype, dst):
                    key = f"{_dtype_name(src.dtype)}->{_dtype_name(dst)}"
                    self.upcasts[key] = self.upcasts.get(key, 0) + 1
            elif op == "copy_" and len(args) > 1 and isinstance(args[1], torch.Tensor):
                dst, src = args[0], args[1]
                if src.is_cuda and dst.device.type == "cpu":
                    self._host_read("d2h_copy")
                if _is_float_upcast(src.dtype, dst.dtype):
                    key = f"{_dtype_name(src.dtype)}->{_dtype_name(dst.dtype)}"
                    self.upcasts[key] = self.upcasts.get(key, 0) + 1

    def _on_wire(self, op: str, args) -> None:
        if op not in _WIRE_OPS:
            self.wire.append((f"c10d.{op}", 0, op))
            return
        kind, where = _WIRE_OPS[op]
        if kind is None:
            kind = _reduce_kind(args[2])
        self.wire.append((kind, 0 if where is None else _nbytes(args[where]), op))

    # -- the context -----------------------------------------------------------

    def _snapshot(self):
        return {label: [(t.data_ptr(), t._version) for t in leaves]
                for label, leaves in self._state.items()}

    def _was_written(self, t: torch.Tensor) -> bool:
        if not t.numel():
            return False
        ptr, lo, hi = _extent(t)
        return any(a < hi and lo < b for a, b in self._writes.get(ptr, ()))

    def __enter__(self) -> "Recorder":
        from torch.optim.optimizer import (
            register_optimizer_step_post_hook,
            register_optimizer_step_pre_hook,
        )

        from tpu_syncbn_torch.parallel import collectives

        if self._restore:
            with torch.no_grad():
                self._saved = {label: [t.detach().clone() for t in leaves]
                               for label, leaves in self._state.items()}
        self._before = self._snapshot()

        # the hooks are global: they run on whichever thread steps an
        # optimizer, beside the recording thread's ops
        def enter_opt(*_):
            with self._lock:
                self._in_optimizer += 1

        def leave_opt(*_):
            with self._lock:
                self._in_optimizer -= 1

        self._hooks = [register_optimizer_step_pre_hook(enter_opt),
                       register_optimizer_step_post_hook(leave_opt)]
        collectives._OBSERVERS.append(self._on_seam)
        if self._layer3 is not None:
            from tpu_syncbn_torch.audit import sharding_audit

            self.placement = sharding_audit.Placement(state=self._state, **self._layer3)
        self._sync_prev = None
        if self._sync_debug and torch.cuda.is_available():
            self._sync_prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        if self._memory:
            from tpu_syncbn_torch.obs import profiling

            cuda = any(t.is_cuda for leaves in self._state.values() for t in leaves)
            self._reading_cm = profiling.allocation_peak("cuda" if cuda else "cpu")
            self._reading = self._reading_cm.__enter__()
        self._mode = _Dispatch(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        from tpu_syncbn_torch.parallel import collectives

        self._mode.__exit__(*exc)
        if self._memory:
            self._reading_cm.__exit__(*exc)
        if self._sync_prev is not None:
            torch.cuda.set_sync_debug_mode(self._sync_prev)
        collectives._OBSERVERS.remove(self._on_seam)
        for h in self._hooks:
            h.remove()
        try:
            after = self._snapshot()
            # published whole: a reader on another thread sees the old
            # counts or the new ones, never a part
            self.written = {
                label: sum(1 for t, (p0, v0), (p1, v1)
                           in zip(self._state[label], leaves, after[label])
                           if p0 == p1 and (v1 > v0 or self._was_written(t)))
                for label, leaves in self._before.items()}
        finally:
            if self._saved is not None:
                with torch.no_grad():
                    for label, leaves in self._state.items():
                        for t, s in zip(leaves, self._saved[label]):
                            t.copy_(s)
                self._saved = None

    # -- results ---------------------------------------------------------------

    def calls(self) -> list[tuple[str, int]]:
        """The executed collective calls as ``(JAX kind, bytes)``, the seam
        and the dispatcher held against each other call for call (raises
        :class:`ExtractionError` under ``contract.extraction``)."""
        out = []
        if self.seam and self.seam[0][2] > 0 or (not self.seam and self.wire):
            first = self.wire[0]
            raise ExtractionError(
                "contract.extraction",
                f"the dispatcher saw {first[2]!r} ({first[0]}) with no call "
                "through tpu_syncbn_torch.parallel.collectives before it — a "
                "collective outside the port's seam")
        for i, (op, nbytes, start) in enumerate(self.seam):
            end = self.seam[i + 1][2] if i + 1 < len(self.seam) else len(self.wire)
            events = self.wire[start:end]
            if op not in SEAM_KINDS:
                raise ExtractionError(
                    "contract.extraction", f"unknown seam op {op!r}")
            kind, carriers = SEAM_KINDS[op]
            if not events:
                if kind in SILENT_KINDS:
                    out.append((kind, nbytes))
                    continue
                raise ExtractionError(
                    "contract.extraction",
                    f"collectives.{op} ({nbytes} B) issued no wire op at the "
                    "dispatcher")
            bad = [e for e in events if e[0] not in carriers]
            if bad or (kind != "ppermute" and len(events) != 1):
                raise ExtractionError(
                    "contract.extraction",
                    f"collectives.{op} ({nbytes} B) reached the dispatcher as "
                    f"{[(e[2], e[0]) for e in events]}")
            sent = [e[1] for e in events if e[2] != "recv_"]
            if sent and sum(sent) != nbytes:
                raise ExtractionError(
                    "contract.extraction",
                    f"collectives.{op} tallied {nbytes} B but sent {sum(sent)} B")
            out.append((kind, nbytes))
        return out

    def contract(self, *, name: str, world: int, declared_donated: Sequence[str] = (),
                 steps: int = 1) -> ProgramContract:
        """The recorded body's contract, per optimizer step: every total
        divided by ``steps`` (which must divide it)."""
        counts: dict[str, int] = {}
        nbytes: dict[str, int] = {}
        for kind, b in self.calls():
            counts[kind] = counts.get(kind, 0) + 1
            nbytes[kind] = nbytes.get(kind, 0) + b

        def per_step(field: str, d: dict) -> dict:
            out = {}
            for k, v in d.items():
                if v % steps:
                    raise ExtractionError(
                        "contract.scan_variance",
                        f"{name}: {field}[{k}] = {v} over {steps} steps is not "
                        f"{steps} times one step's — the steps of one chunk differ")
                if v:
                    out[k] = v // steps
            return out

        written = {k: v for k, v in self.written.items()
                   if v or k in declared_donated}
        flow = self.flow(steps)
        sharding = None if flow is None else ShardingContract(
            name=name, mesh_axes=flow.mesh_axes, in_specs=flow.in_specs,
            out_specs=flow.out_spec_strs(), collectives_explained=flow.collectives_explained,
            implicit_reshards=flow.implicit_reshards, reshard_detail=flow.reshard_detail,
            replicated_intermediates=flow.replicated_intermediates,
            replication_detail=flow.replication_detail,
            max_replicated_bytes=flow.max_replicated_bytes,
            peak_bytes_per_device=flow.peak_bytes_per_device,
            replication_threshold=flow.replication_threshold,
            xla_peak_bytes=flow.xla_peak_bytes, out_leaves=flow.out_leaves)
        return ProgramContract(
            name=name,
            world=int(world),
            collectives=per_step("collectives", counts),
            collective_bytes=per_step("collective_bytes", nbytes),
            donated_declared=list(declared_donated),
            donated_aliased={k: v for k, v in written.items() if v},
            host_callbacks=per_step("host_callbacks", self.host_reads),
            upcasts=per_step("upcasts", self.upcasts),
            sharding=sharding,
        )

    def note_outputs(self, outputs) -> None:
        """The body's returned values: layer 3's outputs, beside the state
        it writes in place."""
        self._outputs = outputs

    def flow(self, steps: int = 1):
        """Layer 3's :class:`~tpu_syncbn_torch.audit.sharding_audit.ShardingFlow`
        of this recording (counts per optimizer step), its ``xla_peak_bytes``
        the allocator's reading when ``memory=True``; None without mesh
        axes and specs."""
        if self.placement is None:
            return None
        flow = self.placement.flow(self._outputs, steps=steps)
        if self._reading is not None and self._reading.get("bytes") is not None:
            flow.xla_peak_bytes = flow.input_bytes + int(self._reading["bytes"])
        return flow

    def cost(self) -> dict:
        """:func:`weighted_cost_summary` of this recording."""
        return weighted_cost_summary(self)

    def as_text(self) -> str:
        """The recorded program: one dispatched op a line, in order."""
        return "\n".join(f"{f.namespace}.{f._opname}" for f in self.ops)


class LoweredStep:
    """One recorded application of a trainer's step body (what
    ``DataParallel.lowered_train_step`` returns; JAX's is a ``Lowered``):
    ``cost_analysis()["flops"]``, ``as_text()`` (the recorded op list),
    ``contract(name=...)`` and ``flow()`` (layer 3)."""

    def __init__(self, recording: Recorder, *, world: int,
                 declared_donated: Sequence[str]):
        self.recording = recording
        self.world = int(world)
        self.declared_donated = tuple(declared_donated)

    def cost_analysis(self) -> dict:
        return weighted_cost_summary(self.recording)

    def as_text(self) -> str:
        return self.recording.as_text()

    def contract(self, name: str = "dataparallel.train_step") -> ProgramContract:
        return self.recording.contract(name=name, world=self.world,
                                       declared_donated=self.declared_donated)

    def flow(self):
        """Layer 3's result (``lowered_train_step(..., sharding=True)``), or
        None."""
        return self.recording.flow()


def weighted_cost_summary(recording: Recorder) -> dict:
    """Execution-weighted cost of a recording (JAX's walk multiplies a
    scan body by its trip count; the port records what ran): ``flops``
    from ``torch.utils.flop_counter`` (2·MACs of matmuls and
    convolutions, forward and backward), ``collective_bytes`` executed by
    kind, their sum ``bytes_total``, and executed ``host_callbacks``."""
    cbytes: dict[str, int] = {}
    for kind, b in recording.calls():
        cbytes[kind] = cbytes.get(kind, 0) + b
    return {
        "flops": int(recording.flops),
        "collective_bytes": cbytes,
        "bytes_total": sum(cbytes.values()),
        "host_callbacks": sum(recording.host_reads.values()),
    }


# ---------------------------------------------------------------------------
# extraction + comparison


def extract_contract(
    fn: Callable,
    example_args: Sequence[Any],
    *,
    name: str,
    world: int,
    arg_labels: Sequence[str],
    declared_donated: Sequence[str] = (),
    steps: int = 1,
    recording: list | None = None,
    mesh_axes: Mapping[str, int] | None = None,
    in_specs: Sequence[Any] | None = None,
    layout=None,
    out_specs=None,
    memory: bool = False,
) -> ProgramContract:
    """Apply ``fn(*example_args)`` once under a :class:`Recorder` and
    assemble its contract, per optimizer step (``steps`` applications of
    the step body in one call). ``arg_labels`` names each argument's
    tensors for the in-place check. Every labelled tensor is put back
    afterwards, so extraction leaves the state as it found it, also when
    ``fn`` raises. ``recording``, a list, receives the
    :class:`Recorder` (its cost and op text).

    With ``mesh_axes`` and ``in_specs`` (one prefix spec tree per argument),
    layer 3 runs in the same recording and its :class:`ShardingContract`
    is attached (``layout``: the ``SpecLayout`` whose groups the body's
    collectives use; ``out_specs``: the outputs' declared specs);
    ``memory=True`` also takes the allocator's reading,
    ``xla_peak_bytes``."""
    rec = Recorder(dict(zip(arg_labels, example_args)), restore=True, mesh_axes=mesh_axes,
                   in_specs=None if in_specs is None else dict(zip(arg_labels, in_specs)),
                   declared=declared_donated, layout=layout, out_specs=out_specs,
                   memory=memory)
    with rec:
        rec.note_outputs(fn(*example_args))
    if recording is not None:
        recording.append(rec)
    return rec.contract(name=name, world=world, declared_donated=declared_donated,
                        steps=steps)


def compare_sharding(actual: ShardingContract, golden: ShardingContract,
                     name: str) -> list[str]:
    """Field-by-field diff of two layer-3 blocks: exact, but
    ``xla_peak_bytes`` at :data:`XLA_PEAK_RTOL`, skipped when either side
    took no reading (``tpu_syncbn/audit/contracts.py:550-596``)."""
    diffs: list[str] = []

    def _ne(field: str, a, g) -> None:
        if a != g:
            diffs.append(f"{name}: sharding.{field} = {a!r}, golden pins {g!r}")

    _ne("mesh_axes", dict(sorted(actual.mesh_axes.items())),
        dict(sorted(golden.mesh_axes.items())))
    for label in sorted(set(actual.in_specs) | set(golden.in_specs)):
        _ne(f"in_specs[{label}]", actual.in_specs.get(label, []),
            golden.in_specs.get(label, []))
    for field in ("out_specs", "collectives_explained", "implicit_reshards",
                  "reshard_detail", "replicated_intermediates", "replication_detail",
                  "max_replicated_bytes", "peak_bytes_per_device", "replication_threshold"):
        _ne(field, getattr(actual, field), getattr(golden, field))
    a, g = actual.xla_peak_bytes, golden.xla_peak_bytes
    if a is not None and g is not None:
        hi = max(a, g)
        if hi and abs(a - g) > XLA_PEAK_RTOL * hi:
            diffs.append(f"{name}: sharding.xla_peak_bytes = {a}, golden pins {g} "
                         f"(>±{XLA_PEAK_RTOL:.0%})")
    return diffs


def compare_contracts(actual: ProgramContract, golden: ProgramContract) -> list[str]:
    """Field-by-field diff; an empty list means the program still honors
    its pinned contract. Contracts of different worlds do not compare."""
    diffs: list[str] = []

    def _dict_diff(field: str, a: dict, g: dict) -> None:
        for key in sorted(set(a) | set(g)):
            av, gv = a.get(key, 0), g.get(key, 0)
            if av != gv:
                diffs.append(f"{actual.name}: {field}[{key}] = {av}, golden pins {gv}")

    if actual.world != golden.world:
        diffs.append(
            f"{actual.name}: recorded at world={actual.world} but golden "
            f"was pinned at world={golden.world} — contracts are only "
            "comparable at the pinned world"
        )
        return diffs
    _dict_diff("collectives", actual.collectives, golden.collectives)
    _dict_diff("collective_bytes", actual.collective_bytes, golden.collective_bytes)
    _dict_diff("host_callbacks", actual.host_callbacks, golden.host_callbacks)
    _dict_diff("upcasts", actual.upcasts, golden.upcasts)
    if list(actual.donated_declared) != list(golden.donated_declared):
        diffs.append(
            f"{actual.name}: declared donation {actual.donated_declared} "
            f"!= golden {golden.donated_declared}"
        )
    _dict_diff("donated_aliased", actual.donated_aliased, golden.donated_aliased)
    if actual.sharding is not None and golden.sharding is not None:
        diffs.extend(compare_sharding(actual.sharding, golden.sharding, actual.name))
    elif actual.sharding is not None:
        diffs.append(f"{actual.name}: program has a layer-3 sharding block but the golden "
                     "pins none — re-pin with --write-goldens (DESIGN.md §8)")
    elif golden.sharding is not None:
        # a registry edit that stops supplying mesh axes and specs would
        # otherwise silently disable every pinned layer-3 field
        diffs.append(f"{actual.name}: golden pins a layer-3 sharding block but the program "
                     "was recorded without one — the recorder lost its mesh axes and specs "
                     "(registry regression), or re-pin deliberately with --write-goldens")
    return diffs


def save_contract(contract: ProgramContract, path: str) -> None:
    with open(path, "w") as f:
        json.dump(contract.to_json(), f, indent=1, sort_keys=False)
        f.write("\n")


def load_contract(path: str) -> ProgramContract:
    with open(path) as f:
        return ProgramContract.from_json(json.load(f))
