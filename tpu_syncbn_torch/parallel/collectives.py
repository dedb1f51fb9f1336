"""Cross-replica collectives over a ``torch.distributed`` process group —
the counterpart of ``tpu_syncbn.parallel.collectives``.

Where the JAX package names a mesh axis, the port names a process group.
``group=None`` means "this replica alone": every collective is then the
identity, which is also what a world-1 group gives. So a single-GPU run
issues no collective at all, as the reference's SyncBN falls back to
plain BN when there is nothing to sync with.

Replica subgroups (``group_size``: contiguous groups of an int size, or an
explicit rank partition) are ``torch.distributed`` groups built once per
(spec, parent group) by :func:`group_for` and cached, so a converted
ResNet-50's 53 layers share one set.

``ppermute`` and ``all_to_all`` move a tensor's bytes (so any dtype
arrives bit for bit; gloo stages CUDA tensors through the host) and are
differentiable, as JAX's are: the backward sends each cotangent back the
way its value came. Ring and Ulysses attention
(:mod:`~tpu_syncbn_torch.parallel.sequence`) train through them.

Every collective issued is tallied per call (:func:`tallies`): op name,
calls and the bytes of the per-replica payload, also counted into the
telemetry registry as ``collectives.<op>.calls`` / ``.bytes`` while
telemetry is enabled. The JAX package tallies at trace time, once per
compiled program; here each call counts, so an eager step tallies its own
traffic. A CUDA-graph replay issues no Python call at all:
``parallel.scan_driver`` notes the bytes a captured program tallied at its
capture and each replay's, and :class:`DispatchWireTally` turns both into
the live ``collectives.dispatched_bytes`` counter.

The compressed collectives (the second half of the module) put a lossy
wire dtype on a reduction: ``"bf16"`` casts, ``"int8"`` quantizes the
fused float payload per chunk on a range shared by the world (the kernels
of :mod:`tpu_syncbn_torch.ops.quant_int8`). Their "tree" is a tensor, a
list or tuple of tensors, or a name-keyed dict of them, flattened in its
own order (a dict in insertion order, where JAX sorts keys); non-float
leaves ride an exact sum. Unlike the plain collectives they do their
arithmetic at every world size, world 1 included: only the wire call is
skipped there, as the JAX package rounds on a mesh of one too.
:func:`compression_tallies` counts their logical and wire bytes.
"""

from __future__ import annotations

import contextlib
import math
import operator
import threading
from typing import Mapping, Sequence

import torch
import torch.distributed as tdist

from tpu_syncbn_torch.obs import numerics as obs_numerics, telemetry

_lock = threading.Lock()
_TALLIES: dict[str, list[int]] = {}  # op -> [calls, bytes]
# compressed calls: [wire bytes, bytes saved against the logical payload,
# logical / wire of the last call]
_COMPRESSED: list = [0, 0, None]
# bytes tallied since the process started, bytes of them tallied while a
# CUDA graph was being captured (the capture moves nothing), and bytes the
# replays of captured graphs moved: O(1) reads for DispatchWireTally
_WIRE = {"tallied": 0, "captured": 0, "replayed": 0}
_capture = threading.local()
# (partition, id(parent)) -> (this rank's group or None, parent): the
# parent is held so its id cannot be reused while the entry lives
_GROUPS: dict[tuple, tuple] = {}
# callables given (op, bytes, group) of every tallied call, from whatever thread
# issues it: the audit's recorders (audit.contracts.Recorder), each of which
# keeps the calls of its own threads
_OBSERVERS: list = []


def _tally(op: str, tensors: Sequence[torch.Tensor], group=None) -> None:
    """Count one call of ``op`` moving ``tensors`` (per-replica payload,
    numel × itemsize: what a ring all-reduce moves within a factor of
    2(N−1)/N) over ``group``. Called at the transmission site, with the
    tensor that is actually sent."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    for observe in list(_OBSERVERS):
        observe(op, nbytes, group)
    with _lock:
        entry = _TALLIES.setdefault(op, [0, 0])
        entry[0] += 1
        entry[1] += nbytes
        _WIRE["tallied"] += nbytes
        box = getattr(_capture, "box", None)
        if box is not None:
            box[0] += nbytes
            _WIRE["captured"] += nbytes
    if telemetry.enabled():
        telemetry.count(f"collectives.{op}.calls")
        telemetry.count(f"collectives.{op}.bytes", nbytes)


def tallies() -> dict[str, dict[str, int]]:
    """``{op: {"calls": n, "bytes": b}}`` since the last
    :func:`reset_tallies`."""
    with _lock:
        return {op: {"calls": c, "bytes": b} for op, (c, b) in _TALLIES.items()}


def bytes_total() -> int:
    """Collective payload bytes tallied since the last :func:`reset_tallies`
    (the JAX package's ``traced_bytes_total``, per call)."""
    with _lock:
        return sum(b for _, b in _TALLIES.values())


def reset_tallies() -> None:
    """Forget the per-op and compression tallies (the process-lifetime
    totals :class:`DispatchWireTally` reads stay)."""
    with _lock:
        _TALLIES.clear()
        _COMPRESSED[:] = [0, 0, None]


def _snapshot_tallies():
    """Every tally of this module, to put back with :func:`_restore_tallies`
    (the audit's extraction applies a step body and then undoes it)."""
    with _lock:
        return ({op: list(v) for op, v in _TALLIES.items()}, list(_COMPRESSED),
                dict(_WIRE))


def _restore_tallies(snapshot) -> None:
    tallies, compressed, wire = snapshot
    with _lock:
        _TALLIES.clear()
        _TALLIES.update({op: list(v) for op, v in tallies.items()})
        _COMPRESSED[:] = compressed
        _WIRE.update(wire)


def traced_bytes_total() -> int:
    """Collective payload bytes tallied in this process since it started
    (the JAX package's ``traced_bytes_total``; here every call counts).
    O(1)."""
    with _lock:
        return _WIRE["tallied"]


def wire_bytes_moved() -> int:
    """Collective payload bytes this process has actually moved: every
    tallied call, less those tallied while a CUDA graph was captured, plus
    what the replays of captured graphs moved (:func:`note_replay`). O(1)."""
    with _lock:
        return _WIRE["tallied"] - _WIRE["captured"] + _WIRE["replayed"]


@contextlib.contextmanager
def capturing():
    """Mark the calls of this thread as recorded into a CUDA graph, not
    run: their bytes still tally, but :func:`wire_bytes_moved` does not
    count them. Yields a one-element list that ends up holding the bytes
    tallied inside — the captured program's inventory, which each of its
    replays moves (:func:`note_replay`)."""
    prev = getattr(_capture, "box", None)
    box = [0]
    _capture.box = box
    try:
        yield box
    finally:
        _capture.box = prev


def note_replay(nbytes: int) -> None:
    """One replay of a captured program whose capture tallied ``nbytes``
    (``parallel.scan_driver`` calls it after ``graph.replay()``)."""
    if nbytes:
        with _lock:
            _WIRE["replayed"] += int(nbytes)


class DispatchWireTally:
    """A live per-dispatch byte counter, ``collectives.dispatched_bytes``:
    the bytes the collectives of each dispatched step or chunk moved.

    The JAX counter derives them from its trace-time inventories: a
    dispatch that grew the traced total compiled a program, whose
    inventory every later dispatch replays (× ``steps`` for a K-step
    program). Here an eager call tallies its own bytes when it runs, so an
    eager step adds exactly its own tallies and nothing else; a captured
    K-step program tallies its K steps' collectives once, at the capture
    (which moves nothing and so counts nothing here), and each replay adds
    that inventory — K steps' worth — through :func:`note_replay`. Both
    come out of :func:`wire_bytes_moved`, so :meth:`after_dispatch` adds
    the bytes moved since the previous dispatch; ``steps`` (the JAX
    signature's multiplier) is not needed for that. Driven by
    ``ResilientLoop``; no-op while telemetry is disabled."""

    def __init__(self):
        self._last = wire_bytes_moved()

    def after_dispatch(self, steps: int = 1) -> int:
        """Record one executed dispatch covering ``steps`` optimizer steps;
        returns the bytes it added."""
        moved = wire_bytes_moved()
        delta, self._last = moved - self._last, moved
        if delta > 0 and telemetry.enabled():
            telemetry.count("collectives.dispatched_bytes", delta)
        return max(delta, 0)


class _Alone:
    """The group of this replica alone, where ``None`` would mean "do not
    sync": every collective over it is the identity, but a compressed one
    still rounds (the JAX package's mesh of one). ``SyncBatchNorm`` with
    ``stats_compress`` passes it at world 1."""

    def __repr__(self) -> str:
        return "collectives.ALONE"


ALONE = _Alone()


def world_size(group) -> int:
    """Replicas in ``group``; 1 for ``None``, :data:`ALONE`, or without a
    process group."""
    if group is None or group is ALONE or not (tdist.is_available() and tdist.is_initialized()):
        return 1
    return tdist.get_world_size(group)


def _rank(group) -> int:
    return 0 if world_size(group) == 1 else tdist.get_rank(group)


# ``lax.axis_size`` / ``lax.axis_index`` over a group: its size, and this
# replica's rank in it (0 for None or ALONE)
axis_size = world_size
axis_index = _rank


def _all_reduce(op: str, tensor: torch.Tensor, group, red) -> torch.Tensor:
    out = tensor.clone()
    _tally(op, [out], group)
    tdist.all_reduce(out, op=red, group=group)
    return out


def psum(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum across the group (``all_reduce(SUM)``); a new tensor, the input
    is untouched. Identity at world 1."""
    if world_size(group) == 1:
        return tensor
    return _all_reduce("psum", tensor, group, tdist.ReduceOp.SUM)


def pmean(tensor: torch.Tensor, group) -> torch.Tensor:
    """Mean across the group: all-reduce then divide by the world size."""
    n = world_size(group)
    if n == 1:
        return tensor
    return _all_reduce("pmean", tensor, group, tdist.ReduceOp.SUM) / n


def pmax(tensor: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max across the group (``all_reduce(MAX)``)."""
    if world_size(group) == 1:
        return tensor
    return _all_reduce("pmax", tensor, group, tdist.ReduceOp.MAX)


def pmin(tensor: torch.Tensor, group) -> torch.Tensor:
    """Elementwise min across the group (``all_reduce(MIN)``)."""
    if world_size(group) == 1:
        return tensor
    return _all_reduce("pmin", tensor, group, tdist.ReduceOp.MIN)


# The three all-reduce rules of a group-sharded model, as JAX's transpose
# rules give them under ``shard_map`` with the VMA checker (the plain
# psum/pmean above clone and reduce outside autograd):
# * a replicated operand meeting rank-varying data gets an implicit
#   ``pvary`` whose transpose is a psum, so its gradient is the full
#   gradient on every rank: :func:`copy_to_group` (Megatron's *f*);
# * a psum of rank-varying values transposes to no communication:
#   :func:`reduce_from_group` (Megatron's *g*) and :func:`mean_from_group`,
#   whose backward divides the cotangent by the world size.


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group).view_as(x)  # a view, never the input itself

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _MeanFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = world_size(group)
        return pmean(x, group).view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def copy_to_group(tensor: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: the identity forward; the backward all-reduces the
    cotangent over ``group`` (one ``psum`` in the tallies), so a replicated
    input used by rank-varying computation gets its full gradient on every
    rank. Identity both ways at world 1."""
    return _CopyToGroup.apply(tensor, group)


def reduce_from_group(tensor: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: :func:`psum` forward, the identity backward (each
    rank's partial takes the replicated result's cotangent as is)."""
    return _ReduceFromGroup.apply(tensor, group)


def mean_from_group(tensor: torch.Tensor, group) -> torch.Tensor:
    """:func:`pmean` forward; the backward divides the cotangent by the
    world size, with no communication."""
    return _MeanFromGroup.apply(tensor, group)


def all_gather(tensor: torch.Tensor, group, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every replica's tensor, in rank order: stacked along a new axis
    ``axis``, or concatenated along the existing ``axis`` when ``tiled``
    (``lax.all_gather``'s contract)."""
    n = world_size(group)
    if n == 1:
        return tensor if tiled else tensor.unsqueeze(axis)
    src = tensor.contiguous()
    outs = [torch.empty_like(src) for _ in range(n)]
    _tally("all_gather", [src], group)
    tdist.all_gather(outs, src, group=group)
    return torch.cat(outs, dim=axis) if tiled else torch.stack(outs, dim=axis)


def reduce_scatter(tensor: torch.Tensor, group, *,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """Sum across the group, then keep this rank's block of
    ``scatter_dimension`` (``lax.psum_scatter(tiled=True)``): block ``i``
    of ``size / world`` rows on the group's rank ``i``.

    NCCL runs ``reduce_scatter_tensor``. gloo has no reduce-scatter, so
    there the whole sum is all-reduced and the block sliced out: the same
    result, at the traffic of an all-reduce."""
    n = world_size(group)
    if tensor.shape[scatter_dimension] % n:
        raise ValueError(
            f"reduce_scatter: dimension {scatter_dimension} of size "
            f"{tensor.shape[scatter_dimension]} is not divisible by the "
            f"group size {n}"
        )
    if n == 1:
        return tensor
    x = tensor.movedim(scatter_dimension, 0).contiguous()
    _tally("reduce_scatter", [x], group)
    if tdist.get_backend(group) == "nccl":
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        tdist.reduce_scatter_tensor(out, x, group=group)
    else:
        total = x.clone()
        tdist.all_reduce(total, group=group)
        out = total.chunk(n)[tdist.get_rank(group)].contiguous()
    return out.movedim(0, scatter_dimension)


def _wire_bytes(x: torch.Tensor, group) -> tuple[torch.Tensor, bool]:
    """``x`` (contiguous) as the flat bytes a permutation or an all-to-all
    sends, and whether they were staged through the host. These collectives
    move bytes and do no arithmetic, so the values arrive bit for bit
    whatever dtypes the backend takes; gloo moves host memory only, so
    there a CUDA tensor goes through the host."""
    host = x.is_cuda and tdist.get_backend(group) == "gloo"
    return (x.cpu() if host else x).reshape(-1).view(torch.uint8), host


def _from_wire(out: torch.Tensor, like: torch.Tensor, host: bool) -> torch.Tensor:
    out = out.view(like.dtype).view(like.shape)
    return out.to(like.device) if host else out


def _ppermute(tensor: torch.Tensor, perm: tuple, group) -> torch.Tensor:
    me = _rank(group)
    x = tensor.contiguous()
    _tally("ppermute", [x], group)
    if world_size(group) == 1:
        return x.clone() if (me, me) in perm else torch.zeros_like(x)
    send, host = _wire_bytes(x, group)
    out = torch.zeros_like(send)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(send)
        elif src == me:
            ops.append(tdist.P2POp(tdist.isend, send, tdist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(tdist.P2POp(tdist.irecv, out, tdist.get_global_rank(group, src), group))
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    return _from_wire(out, x, host)


class _PPermute(torch.autograd.Function):
    """``lax.ppermute``'s transpose rule: the cotangent goes back along the
    inverted ``(source, destination)`` pairs."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, grad):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return _ppermute(grad, inverse, ctx.group), None, None


def ppermute(tensor: torch.Tensor, perm: Sequence[tuple[int, int]], group) -> torch.Tensor:
    """Point-to-point permutation (``lax.ppermute``): ``perm`` holds
    ``(source, destination)`` pairs of ranks of ``group``; this rank sends
    ``tensor`` to each destination it is the source of, and returns what
    its source sent it, or zeros when no pair names it as a destination.
    One ``batch_isend_irecv`` of the pairs that involve this rank, on the
    tensor's bytes (through the host on gloo). Differentiable: the
    backward permutes the cotangent along the inverted pairs."""
    perm = tuple((int(src), int(dst)) for src, dst in perm)
    return _PPermute.apply(tensor, perm, group)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """The all-to-all on a stacked ``(n, ...)`` tensor: row ``j`` goes to
    rank ``j``, and row ``i`` of the result came from rank ``i``. One
    ``all_to_all_single`` on the bytes (through the host on gloo)."""
    x = x.contiguous()
    _tally("all_to_all", [x], group)
    if world_size(group) == 1:
        return x.clone()
    send, host = _wire_bytes(x, group)
    out = torch.empty_like(send)
    tdist.all_to_all_single(out, send, group=group)
    return _from_wire(out, x, host)


class _AllToAll(torch.autograd.Function):
    """:func:`_exchange` is its own transpose: the cotangent of the row
    that came from rank ``i`` goes back to rank ``i``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def all_to_all(tensor: torch.Tensor, group, *, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """All-to-all resharding (``lax.all_to_all``), the sequence- and
    expert-parallel building block. Tiled: ``split_axis`` is cut into
    ``world`` equal chunks, chunk ``j`` goes to rank ``j``, and the chunks
    received are concatenated along ``concat_axis`` in rank order. Untiled:
    ``split_axis`` must have ``world`` entries; entry ``j`` goes to rank
    ``j``, and the received entries are stacked along a new axis at
    ``concat_axis`` of the result. Differentiable: the backward is the same
    exchange with the two axes swapped."""
    n = world_size(group)
    split_axis %= tensor.dim()
    size = tensor.shape[split_axis]
    if (size % n) if tiled else (size != n):
        raise ValueError(
            f"all_to_all: split_axis {split_axis} of size {size} "
            + (f"is not divisible by the group size {n}" if tiled
               else f"must equal the group size {n} when not tiled"))
    recv = _AllToAll.apply(torch.stack(tensor.chunk(n, split_axis)), group).unbind(0)
    if tiled:
        return torch.cat(recv, concat_axis % tensor.dim())
    return torch.stack([r.squeeze(split_axis) for r in recv], concat_axis % tensor.dim())


def ring_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce built from :func:`ppermute` hops
    (the JAX package's ``ring_all_reduce``, chunk for chunk): the flat
    payload, zero-padded to a multiple of the world ``N``, is cut into N
    chunks; N − 1 reduce-scatter hops each add this rank's copy of one
    chunk to the partial sum received from the left neighbour, then N − 1
    all-gather hops circulate the finished chunks. ``psum`` is the
    production path; this pins the ring algebra ring attention rides on.
    Identity at world 1."""
    n = world_size(group)
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.view(n, -1)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    me = _rank(group)
    # reduce-scatter: at hop s this rank receives the partial sum of chunk
    # (me - s) and adds its own copy; it ends owning chunk (me + 1) % n
    acc = chunks[me]
    for s in range(1, n):
        acc = ppermute(acc, fwd, group) + chunks[(me - s) % n]
    # all-gather: hop s brings chunk (me + 1 - s) % n
    gathered = [acc]
    for _ in range(n - 1):
        gathered.append(ppermute(gathered[-1], fwd, group))
    out = torch.stack(gathered)[[(me + 1 - j) % n for j in range(n)]].reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


def _prime_factors(n: int) -> list:
    """Ascending prime factorization (with multiplicity); empty for 1."""
    fs, f = [], 2
    while n > 1:
        while n % f == 0:
            fs.append(f)
            n //= f
        f += 1 if f == 2 else 2
    return fs


def _stage_perm(groups: tuple, stride: int, f: int, k: int) -> list:
    """(source, dest) ppermute pairs for shift ``k`` of a radix-``f``
    mixed-radix butterfly stage at ``stride``, within equal-size replica
    ``groups`` (arbitrary membership): each member receives from the
    group member whose position digit at this stride is ``k`` ahead
    (mod f)."""
    perm = []
    for g in groups:
        for pos, rank in enumerate(g):
            d = (pos // stride) % f
            src_pos = pos + (((d + k) % f) - d) * stride
            perm.append((g[src_pos], rank))
    return perm


def psum_flat_(tensors: Sequence[torch.Tensor], group, *,
               scale: float = 1.0) -> None:
    """In place: every tensor becomes its sum across the group times
    ``scale``, with ONE all-reduce per dtype over a flat buffer (the
    trainer's gradient averaging). No-op at world 1."""
    if world_size(group) == 1 or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        _tally("psum_flat", [flat], group)
        tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
        if scale != 1.0:
            flat.mul_(scale)
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """In place: every rank receives rank ``src``'s values (DDP's
    parameter/buffer broadcast). No-op at world 1."""
    if world_size(group) == 1:
        return
    global_src = tdist.get_global_rank(group, src)
    for t in tensors:
        _tally("broadcast", [t], group)
        tdist.broadcast(t, src=global_src, group=group)


def broadcast(tensor: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s values on every rank, as a new tensor (the JAX
    package's ``broadcast``; :func:`broadcast_` works in place)."""
    out = tensor.clone()
    broadcast_([out], group, src)
    return out


# -- replica subgroups ------------------------------------------------------


def normalize_group_spec(group_size):
    """Canonicalize a ``group_size`` value: an int-like scalar stays an int
    (contiguous groups of that size); anything else must be a rank
    partition and becomes hashable nested tuples of exact ints
    (``operator.index``: a non-integral rank like 1.9 is an error, not a
    silent truncation). One normalization shared by ``SyncBatchNorm``,
    ``convert_sync_batchnorm``, ``batch_norm_train`` and
    :func:`psum_in_groups`, so a spec keys the group cache the same way
    wherever it came from. ``None`` passes through (the whole group)."""
    if group_size is None:
        return None
    if isinstance(group_size, bool):
        raise ValueError(f"group_size must be an int or a rank "
                         f"partition, got {group_size!r}")
    try:
        return operator.index(group_size)  # int, np.integer, ...
    except TypeError:
        pass
    try:
        return tuple(tuple(operator.index(r) for r in g)
                     for g in group_size)
    except (TypeError, ValueError) as e:
        raise ValueError(
            "group_size must be an int or a sequence of rank "
            f"sequences of exact integers, got {group_size!r}"
        ) from e


def _validate_partition(world: int, groups: tuple) -> tuple:
    """Check a normalized rank partition: every rank in [0, world)
    exactly once, no empty groups. Returns it unchanged."""
    flat = [r for g in groups for r in g]
    if any(not g for g in groups) or sorted(flat) != list(range(world)):
        raise ValueError(
            f"groups {groups!r} must partition ranks 0..{world - 1}: "
            "every rank exactly once, no empty groups (each group becomes "
            "one torch.distributed.new_group, which takes the same "
            "constraint)"
        )
    return groups


def partition(group_size, world: int) -> tuple[tuple[int, ...], ...]:
    """The rank partition a ``group_size`` spec names over ``world``
    ranks: an int ``g`` gives ``[0..g), [g..2g), ...`` (``g`` must divide
    ``world``), an explicit partition is checked and returned."""
    spec = normalize_group_spec(group_size)
    if isinstance(spec, int):
        if spec < 1 or world % spec:
            raise ValueError(f"group_size {spec} must divide axis size {world}")
        return tuple(tuple(range(i, i + spec)) for i in range(0, world, spec))
    return _validate_partition(world, spec)


def _build_groups(groups: tuple, parent):
    """Create one ``torch.distributed`` group per member of ``groups``
    (ranks of ``parent``), on EVERY rank and in the same order, as
    ``new_group`` requires; return this rank's."""
    ranks = [[tdist.get_global_rank(parent, r) for r in g] for g in groups]
    mine, _ = tdist.new_subgroups_by_enumeration(ranks)
    return mine


def group_for(group_size, parent):
    """This rank's process group for the subgroup spec ``group_size``
    within ``parent``: ``parent`` itself when the spec is one group (or
    ``None``), ``None`` (local statistics) when every group is one rank,
    else a cached subgroup. ``parent=None`` (or no process group) is world
    1, where only the specs valid for one rank are accepted.

    Building the groups is collective over every process: every rank must
    ask for the same specs in the same order (the layers of one model
    do). The parent must span every process."""
    if group_size is None:
        return parent
    groups = partition(group_size, world_size(parent))
    if len(groups) == 1:
        return parent
    if all(len(g) == 1 for g in groups):
        return None
    if world_size(parent) != tdist.get_world_size():
        raise ValueError(
            "group-scoped SyncBN needs a parent group spanning every "
            f"process; {parent!r} holds {world_size(parent)} of "
            f"{tdist.get_world_size()}"
        )
    key = (groups, id(parent))
    with _lock:
        if key not in _GROUPS:
            _GROUPS[key] = (_build_groups(groups, parent), parent)
        return _GROUPS[key][0]


def clear_group_cache() -> None:
    """Forget the cached subgroups (``runtime.shutdown`` destroys them with
    the process group)."""
    with _lock:
        _GROUPS.clear()


def psum_in_groups(tensor: torch.Tensor, group, group_size) -> torch.Tensor:
    """Sum within the subgroup of ``group`` that holds this rank — the
    port of torch's ``process_group`` scoping as the JAX package spells it
    (``group_size``: an int for contiguous groups, or an explicit
    partition of equal or unequal sizes).

    One ``all_reduce`` on this rank's cached subgroup (:func:`group_for`);
    the JAX package's butterfly and masked gather work around XLA limits
    that ``torch.distributed`` does not have. Floating tensors narrower
    than float32 are summed in float32 and returned in their dtype, as
    the JAX function fuses its payload to float32."""
    sub = group_for(group_size, group)
    widen = tensor.is_floating_point() and tensor.element_size() < 4
    out = psum(tensor.float() if widen else tensor, sub)
    return out.to(tensor.dtype) if widen else out


def moments_from_stats(
    s: torch.Tensor, sq: torch.Tensor, count: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var) from raw partial sums; safe for count == 0 and
    clamps the small negatives that cancellation in ``sq/n - mean²`` can
    give. The exact one-pass formula of the JAX package, kept so the two
    agree to rounding."""
    safe = torch.clamp_min(count, 1.0)
    mean = s / safe
    var = torch.clamp_min(sq / safe - mean * mean, 0.0)
    return mean, var


def check_group_compress(group_size, mode: str) -> None:
    """Lossy statistics cannot be scoped to subgroups: the JAX group
    butterfly re-fuses its payload at f32, so the two flags together raise
    there instead of silently un-compressing, and here alike."""
    if group_size is not None and mode != "none":
        raise ValueError(
            f"compressed SyncBN stats (mode={mode!r}) cannot be combined with "
            f"group_size={group_size!r}: the group butterfly re-fuses payloads "
            "at f32 — sync the full axis or keep stats exact")


def reduce_moments(
    local_sum: torch.Tensor,
    local_sumsq: torch.Tensor,
    local_count: torch.Tensor,
    group,
    *,
    group_size=None,
    mode: str = "none",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count-weighted global (mean, biased var, count) from per-replica
    partial sums: ONE fused all-reduce of ``cat(Σx, Σx², n)`` in f32,
    across ``group``, or within this rank's subgroup of it when
    ``group_size`` is given (:func:`group_for`).

    ``local_count`` is a scalar or per-channel tensor; uneven and empty
    shards are exact (an empty shard adds zeros).

    ``mode`` (default ``"none"``: exact f32) puts ``(Σx, Σx²)`` on a lossy
    wire through :func:`compressed_psum`; the count always rides an exact
    f32 sum (it feeds the safe divide and the empty-shard semantics).
    ``group_size`` with a lossy mode raises (:func:`check_group_compress`)."""
    check_compress_mode(mode)
    check_group_compress(group_size, mode)
    group = group_for(group_size, group)
    c = local_sum.shape[0]
    count_vec = local_count.to(torch.float32).reshape(-1)
    if mode != "none":
        s, sq = compressed_psum([local_sum, local_sumsq], group, mode=mode)
        count = psum(count_vec, group)
    else:
        payload = torch.cat([
            local_sum.to(torch.float32),
            local_sumsq.to(torch.float32),
            count_vec,
        ])
        total = psum(payload, group)
        s, sq = total[:c], total[c:2 * c]
        count = total[2 * c:]
    if local_count.dim() == 0:
        count = count.reshape(())
    mean, var = moments_from_stats(s, sq, count)
    # drift monitor: this replica's batch moments against the synced ones,
    # recorded only under a trainer's active monitor collector
    obs_numerics.record_bn_skew(local_sum, local_sumsq, local_count, mean, var)
    return mean, var, count


# -- compressed collectives ---------------------------------------------------
# (EQuARX-style quantized all-reduce, arxiv 2506.17615; DS-Sync
# shuffle-sharding, arxiv 2007.03298)

#: Wire-compression modes of every ``compressed_*`` function (and the
#: trainers' ``compress=``): ``"none"`` exact f32, ``"bf16"`` a cast (2 B an
#: element), ``"int8"`` chunk-quantized (1 B an element + one f32
#: (min, max) pair a chunk).
COMPRESS_MODES = ("none", "bf16", "int8")

#: Elements per quantization chunk: one (scale, zero-point) pair is shared
#: by this many consecutive elements of the fused payload.
DEFAULT_CHUNK_ELEMS = 256


def check_compress_mode(mode: str) -> str:
    if mode not in COMPRESS_MODES:
        raise ValueError(
            f"compression mode must be one of {COMPRESS_MODES}, got {mode!r}"
        )
    return mode


def _tally_compressed(logical_bytes: int, wire_bytes: int) -> None:
    """Count one compressed call: its wire bytes, the bytes it saved
    against the logical payload, and its ratio (:func:`compression_tallies`;
    in the registry ``collectives.compressed_bytes``,
    ``collectives.compressed_saved_bytes`` and the gauge
    ``collectives.compression_ratio``). At every world size, as the JAX
    inventory counts on a mesh of one."""
    with _lock:
        _COMPRESSED[0] += int(wire_bytes)
        _COMPRESSED[1] += max(0, int(logical_bytes) - int(wire_bytes))
        if wire_bytes:
            _COMPRESSED[2] = logical_bytes / wire_bytes
    if telemetry.enabled():
        telemetry.count("collectives.compressed_bytes", int(wire_bytes))
        telemetry.count("collectives.compressed_saved_bytes",
                        max(0, int(logical_bytes) - int(wire_bytes)))
        if wire_bytes:
            telemetry.set_gauge("collectives.compression_ratio",
                                logical_bytes / wire_bytes)


def compression_tallies() -> dict:
    """``{"compressed_bytes", "saved_bytes", "compression_ratio"}`` since
    the last :func:`reset_tallies`: the wire bytes of every compressed
    call, what they saved against the f32 (logical) payload, and logical
    / wire of the last call (``None`` before the first). The plain
    collectives they issue tally their own bytes in :func:`tallies`."""
    with _lock:
        wire, saved, ratio = _COMPRESSED
        return {"compressed_bytes": wire, "saved_bytes": saved,
                "compression_ratio": ratio}


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def _flatten_tree(tree):
    """``(leaves, rebuild)`` of a tensor, a list or tuple of tensors, or a
    name-keyed dict of them; ``rebuild(leaves)`` makes the same kind."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, Mapping):
        keys = list(tree)
        return [tree[k] for k in keys], lambda ls: dict(zip(keys, ls))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return list(tree), lambda ls: kind(ls)
    raise TypeError(f"expected a tensor, a list/tuple or a dict of tensors, "
                    f"got {type(tree).__name__}")


def _split_float_leaves(tree):
    """``(rebuild, float leaves, their indices, all leaves)``: the
    compressed paths quantize floating leaves and move anything else (int
    flags, counters) through an exact sum."""
    leaves, rebuild = _flatten_tree(tree)
    fidx = [i for i, t in enumerate(leaves) if t.is_floating_point()]
    return rebuild, [leaves[i] for i in fidx], fidx, leaves


def _fuse_f32(leaves) -> torch.Tensor:
    """One flat f32 payload of ``leaves`` (quantization chunks then span
    leaf boundaries), in their order, each in its logical order."""
    parts = [t.reshape(-1).to(torch.float32) for t in leaves]
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)


def _unfuse(flat: torch.Tensor, like_leaves, *, cast: bool = True) -> list:
    out, offset = [], 0
    for t in like_leaves:
        n = t.numel()
        piece = flat[offset:offset + n].reshape(t.shape)
        out.append(piece.to(t.dtype) if cast else piece)
        offset += n
    return out


def _reassemble(rebuild, leaves, fidx, freduced, exact):
    """The compressed float leaves and the exactly reduced others back in
    the tree's order (one implementation for :func:`compressed_psum` and
    :func:`ef_compressed_pmean`)."""
    out = list(leaves)
    fset = set(fidx)
    for i, t in zip(fidx, freduced):
        out[i] = t
    it = iter(exact)
    for i in range(len(out)):
        if i not in fset:
            out[i] = next(it)
    return rebuild(out)


def _chunk_pad(flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """``flat`` padded with zeros to whole chunks (the zeros enter the last
    chunk's range, as in the JAX package)."""
    pad = (-flat.numel()) % chunk
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def _psum_list(tensors: list, group) -> list:
    """Each tensor summed across ``group`` with ONE all-reduce of their
    concatenation (one dtype); the tensors themselves at world 1."""
    if world_size(group) == 1:
        return tensors
    total = psum(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [part.view(t.shape) for part, t in zip(total.split([t.numel() for t in tensors]),
                                                     tensors)]


def _int8_qparams(flat: torch.Tensor, group, world: int, chunk: int, *,
                  residual: torch.Tensor | None = None, want_residual: bool = False,
                  residual_out: torch.Tensor | None = None):
    """Shared-range asymmetric int8 codes of ``p = flat (+ residual)`` in
    chunks of ``chunk``: ``(q, scale, zp, qmax, new residual or None)``.

    The range is the WORLD range (one small f32 all-reduce MAX of the
    per-chunk ``(-min, max)`` pairs), so every replica quantizes on one
    grid, and per-element magnitudes are budgeted to ``qmax = 127 //
    world``: a world sum stays within ±127, so the int8 all-reduce is
    exact. The budget vanishes past 127 replicas, so int8 refuses them
    (use ``"bf16"``). The kernels are :mod:`~tpu_syncbn_torch.ops.quant_int8`'s
    (the plain version for a CPU tensor)."""
    from tpu_syncbn_torch.ops import quant_int8

    if world > 127:
        raise ValueError(
            f"int8 compression supports axis sizes up to 127, got "
            f"{world}: the no-overflow element budget 127 // world is "
            "zero, so world-sums would wrap int8 — use mode='bf16'"
        )
    qmax = 127 // world
    ranges = pmax(quant_int8.minmax(flat, residual, chunk=chunk), group)
    q, scale, zp, res = quant_int8.encode(flat, residual, ranges, qmax, chunk=chunk,
                                          want_residual=want_residual,
                                          residual_out=residual_out)
    if obs_numerics.active():
        # compression health: the share of codes at the clip edge ±qmax
        # (a chunk whose mass pins the shared range edge is saturating)
        with torch.no_grad():
            at_limit = (q.abs() >= qmax).sum().to(torch.float32)
            obs_numerics.record("clip_fraction", at_limit / q.numel())
    return q, scale, zp, qmax, res


def _record_int8_headroom(sumq: torch.Tensor) -> None:
    """Compression health: the shared range's overflow headroom of a
    world-summed int8 payload, 1 − max|Σq| / 127 (the ``127 // world``
    budget keeps it ≥ 0). Local arithmetic on the reduced payload, only
    under an active monitor collector."""
    if obs_numerics.active():
        with torch.no_grad():
            peak = sumq.abs().amax().to(torch.float32)
            obs_numerics.record("overflow_headroom", 1.0 - peak / 127.0)


def _compressed_mean_flat(flat: torch.Tensor, group, *, mode: str, logical: int,
                          chunk: int = DEFAULT_CHUNK_ELEMS,
                          residual: torch.Tensor | None = None,
                          residual_out: torch.Tensor | None = None) -> torch.Tensor:
    """The replica mean of the flat f32 payload ``flat`` over a lossy wire,
    f32. With ``residual`` (error feedback) each replica reduces ``p = flat
    + residual`` and its new residual ``p − C(p)`` is written into
    ``residual_out`` (``residual`` itself by default). ``logical`` is the
    payload's bytes in its own dtypes, for the tallies."""
    from tpu_syncbn_torch.ops import quant_int8

    world = world_size(group)
    if residual is not None and residual_out is None:
        residual_out = residual
    if mode == "bf16":
        p = flat if residual is None else flat + residual
        cast = p.to(torch.bfloat16)
        _tally_compressed(logical, cast.numel() * 2)
        if residual is not None:
            residual_out.copy_(p - cast.to(torch.float32))
        return psum(cast, group).to(torch.float32) * (1.0 / world)
    q, scale, zp, _, _ = _int8_qparams(flat, group, world, chunk, residual=residual,
                                       want_residual=residual is not None,
                                       residual_out=residual_out)
    _tally_compressed(logical, q.numel() + 8 * scale.numel())
    sumq = psum(q, group)
    _record_int8_headroom(sumq)
    return quant_int8.decode(sumq, scale, zp, world=world, n=flat.numel(),
                             chunk=chunk, mean=True)


def compressed_psum(tree, group, *, mode: str, chunk_size: int = DEFAULT_CHUNK_ELEMS):
    """All-reduce SUM with a compressed wire dtype:

    * ``"none"`` — each leaf's exact :func:`psum`;
    * ``"bf16"`` — float leaves cast to bfloat16 for the wire, summed in
      bf16, cast back: 2× fewer bytes, exact when the addends and sums are
      bf16-representable;
    * ``"int8"`` — float leaves fused into one flat f32 payload, quantized
      per chunk on the world's shared range (:func:`_int8_qparams`), summed
      as int8, dequantized: ~4× fewer bytes.

    Non-float leaves (counts, flags) always ride an exact sum. Returns the
    tree's kind with every leaf summed, in its dtype."""
    from tpu_syncbn_torch.ops import quant_int8

    check_compress_mode(mode)
    leaves, rebuild = _flatten_tree(tree)
    if mode == "none":
        return rebuild([psum(t, group) for t in leaves])
    rebuild, fleaves, fidx, leaves = _split_float_leaves(tree)
    exact = [psum(t, group) for i, t in enumerate(leaves) if i not in set(fidx)]
    if not fleaves:
        return rebuild(exact)
    world = world_size(group)
    logical = _nbytes(fleaves)
    if mode == "bf16":
        cast = [t.to(torch.bfloat16) for t in fleaves]
        _tally_compressed(logical, _nbytes(cast))
        fsummed = [s.to(t.dtype) for s, t in zip(_psum_list(cast, group), fleaves)]
    else:
        flat = _fuse_f32(fleaves)
        q, scale, zp, _, _ = _int8_qparams(flat, group, world, chunk_size)
        # the int8 payload plus the f32 (-min, max) pair a chunk that the
        # range all-reduce moves
        _tally_compressed(logical, q.numel() + 8 * scale.numel())
        sumq = psum(q, group)
        _record_int8_headroom(sumq)
        summed = quant_int8.decode(sumq, scale, zp, world=world, n=flat.numel(),
                                   chunk=chunk_size)
        fsummed = _unfuse(summed, fleaves)
    return _reassemble(rebuild, leaves, fidx, fsummed, exact)


def compressed_pmean(tree, group, *, mode: str, chunk_size: int = DEFAULT_CHUNK_ELEMS):
    """:func:`compressed_psum` followed by the division by the world size —
    DDP's gradient averaging on a compressed wire. The division happens
    after the dequantize, in each leaf's dtype (integer leaves become the
    float mean, as ``lax.pmean`` gives). Every division by the world size
    here is a multiplication by its f32 reciprocal, as XLA's CPU backend
    computes the JAX package's ``/ world`` (``ops.quant_int8``)."""
    world = world_size(group)
    summed, rebuild = _flatten_tree(compressed_psum(tree, group, mode=mode,
                                                    chunk_size=chunk_size))
    return rebuild([t * (1.0 / world) for t in summed])


def init_error_feedback(tree):
    """A zero residual for ``tree``: an f32 zero tensor of each float
    leaf's shape, and a zero-size placeholder for every other leaf, so the
    residual keeps the tree's structure."""
    leaves, rebuild = _flatten_tree(tree)
    return rebuild([torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                    if t.is_floating_point()
                    else torch.zeros((0,), dtype=torch.float32, device=t.device)
                    for t in leaves])


def ef_compressed_pmean(tree, residual, group, *, mode: str,
                        chunk_size: int = DEFAULT_CHUNK_ELEMS):
    """Error-feedback compressed gradient mean (EF-SGD lineage): each
    replica reduces ``p = g + e`` instead of ``g`` and keeps ``e' = p −
    C(p)``, its own quantization error, so the error is sent again until
    it lands instead of accumulating. Returns ``(mean over replicas of
    C(p), e')``; ``residual`` is this replica's state, of
    :func:`init_error_feedback`'s structure. ``mode="none"`` is the exact
    :func:`pmean` with the residual untouched."""
    check_compress_mode(mode)
    world = world_size(group)
    leaves, rebuild = _flatten_tree(tree)
    if mode == "none":
        return rebuild([pmean(t, group) for t in leaves]), residual
    rebuild, fleaves, fidx, leaves = _split_float_leaves(tree)
    if not fleaves:
        return rebuild([pmean(t, group) for t in leaves]), residual
    res_leaves, res_rebuild = _flatten_tree(residual)
    if len(res_leaves) != len(leaves):
        raise ValueError(
            f"residual tree has {len(res_leaves)} leaves, expected "
            f"{len(leaves)} (init with init_error_feedback)"
        )
    fres = [res_leaves[i] for i in fidx]
    exact = [pmean(t, group) for i, t in enumerate(leaves) if i not in set(fidx)]
    flat, flat_res = _fuse_f32(fleaves), _fuse_f32(fres)
    new_flat = torch.empty_like(flat_res)
    mean = _compressed_mean_flat(flat, group, mode=mode, logical=_nbytes(fleaves),
                                 chunk=chunk_size, residual=flat_res,
                                 residual_out=new_flat)
    res_out = list(res_leaves)
    for i, r in zip(fidx, _unfuse(new_flat, fres, cast=False)):
        res_out[i] = r
    return (_reassemble(rebuild, leaves, fidx, _unfuse(mean, fleaves), exact),
            res_rebuild(res_out))


def compressed_reduce_scatter(x: torch.Tensor, group, *, mode: str,
                              want_residual: bool = False):
    """Compressed reduce-scatter for the ZeRO path: ``x`` is a flat vector
    whose length divides by the world size; returns ``(this rank's summed
    shard as f32, residual or None)``.

    int8 quantizes one chunk per scatter shard (the chunk boundaries are
    the shard boundaries, so each rank dequantizes its shard with its own
    (scale, zero-point) pair) under the same overflow budget as
    :func:`compressed_psum`, so the int8 reduce-scatter is exact; on gloo
    it is :func:`reduce_scatter`'s all-reduce and slice, exact alike.
    ``want_residual`` also returns this replica's full-size f32 error
    ``x − C(x)`` for error feedback."""
    from tpu_syncbn_torch.ops import quant_int8

    check_compress_mode(mode)
    world = world_size(group)
    n = x.numel()
    if n % world:
        raise ValueError(f"payload size {n} must divide by the axis size {world}")
    xf = x.reshape(-1).to(torch.float32).contiguous()
    if mode == "none":
        return reduce_scatter(xf, group), (torch.zeros_like(xf) if want_residual else None)
    if mode == "bf16":
        cast = xf.to(torch.bfloat16)
        _tally_compressed(n * 4, n * 2)
        shard = reduce_scatter(cast, group).to(torch.float32)
        return shard, (xf - cast.to(torch.float32) if want_residual else None)
    chunk = n // world
    q, scale, zp, _, res = _int8_qparams(xf, group, world, chunk, want_residual=want_residual)
    _tally_compressed(n * 4, q.numel() + 8 * world)
    me = _rank(group)
    sumq = reduce_scatter(q, group)
    _record_int8_headroom(sumq)
    shard = quant_int8.decode(sumq, scale[me:me + 1].contiguous(),
                              zp[me:me + 1].contiguous(), world=world, n=chunk, chunk=chunk)
    return shard, res


def shuffle_sharded_psum(tree, group, *, num_shards: int | None = None, mode: str = "none",
                         chunk_size: int = DEFAULT_CHUNK_ELEMS):
    """DS-Sync-style shuffle-sharded all-reduce (arxiv 2007.03298): the
    fused payload is cut into ``num_shards`` shards (default: the world
    size), and shard ``j`` is summed by its own mixed-radix butterfly of
    :func:`ppermute` stages over the world rotated by ``j``
    (:func:`_stage_perm`), so each stage of each shard uses other links.
    Same total bytes as one butterfly.

    ``"bf16"`` runs the butterflies on the bf16 payload; ``"int8"``
    quantizes once up front on the shared range (its budget keeps every
    partial sum exact) and dequantizes once at the end. Exact for
    ``"none"``. Every leaf, float or not, rides the fused f32 payload and
    comes back in its dtype. The tree itself at world 1."""
    from tpu_syncbn_torch.ops import quant_int8

    check_compress_mode(mode)
    world = world_size(group)
    if world == 1:
        return tree
    shards = world if num_shards is None else int(num_shards)
    if shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {shards}")
    leaves, rebuild = _flatten_tree(tree)
    flat = _fuse_f32(leaves)
    logical = flat.numel() * 4
    if mode == "bf16":
        payload = flat.to(torch.bfloat16)
        _tally_compressed(logical, payload.numel() * 2)
    elif mode == "int8":
        q, scale, zp, _, _ = _int8_qparams(flat, group, world, chunk_size)
        payload = q
        _tally_compressed(logical, q.numel() + 8 * scale.numel())
    else:
        payload = flat
    size = payload.numel()
    payload = _chunk_pad(payload, shards) if size % shards else payload
    segs = payload.view(shards, -1)
    factors = _prime_factors(world)
    outs = []
    for j in range(shards):
        # shard j's butterfly runs over the world rotated by j: same
        # stage count, other (source, destination) links at every stage
        order = tuple((r + j) % world for r in range(world))
        seg = segs[j]
        stride = 1
        for f in factors:
            acc = seg
            for k in range(1, f):
                acc = acc + ppermute(seg, _stage_perm((order,), stride, f, k), group)
            seg = acc
            stride *= f
        outs.append(seg)
    summed = torch.cat(outs)[:size]
    if mode == "bf16":
        summed = summed.to(torch.float32)
    elif mode == "int8":
        summed = quant_int8.decode(summed, scale, zp, world=world, n=flat.numel(),
                                   chunk=chunk_size)
    return rebuild(_unfuse(summed, leaves))
