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

Every collective issued is tallied per call (:func:`tallies`): op name,
calls and the bytes of the per-replica payload. The JAX package tallies at
trace time, once per compiled program; here each call counts.
"""

from __future__ import annotations

import operator
import threading
from typing import Sequence

import torch
import torch.distributed as tdist

_lock = threading.Lock()
_TALLIES: dict[str, list[int]] = {}  # op -> [calls, bytes]
# (partition, id(parent)) -> (this rank's group or None, parent): the
# parent is held so its id cannot be reused while the entry lives
_GROUPS: dict[tuple, tuple] = {}


def _tally(op: str, tensors: Sequence[torch.Tensor]) -> None:
    """Count one call of ``op`` moving ``tensors`` (per-replica payload,
    numel × itemsize: what a ring all-reduce moves within a factor of
    2(N−1)/N). Called at the transmission site, with the tensor that is
    actually sent."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    with _lock:
        entry = _TALLIES.setdefault(op, [0, 0])
        entry[0] += 1
        entry[1] += nbytes


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
    with _lock:
        _TALLIES.clear()


def world_size(group) -> int:
    """Replicas in ``group``; 1 for ``None`` or without a process group."""
    if group is None or not (tdist.is_available() and tdist.is_initialized()):
        return 1
    return tdist.get_world_size(group)


def _all_reduce(op: str, tensor: torch.Tensor, group, red) -> torch.Tensor:
    out = tensor.clone()
    _tally(op, [out])
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
    _tally("all_gather", [src])
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
    _tally("reduce_scatter", [x])
    if tdist.get_backend(group) == "nccl":
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        tdist.reduce_scatter_tensor(out, x, group=group)
    else:
        total = x.clone()
        tdist.all_reduce(total, group=group)
        out = total.chunk(n)[tdist.get_rank(group)].contiguous()
    return out.movedim(0, scatter_dimension)


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
        _tally("psum_flat", [flat])
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
        _tally("broadcast", [t])
        tdist.broadcast(t, src=global_src, group=group)


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


def reduce_moments(
    local_sum: torch.Tensor,
    local_sumsq: torch.Tensor,
    local_count: torch.Tensor,
    group,
    *,
    group_size=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count-weighted global (mean, biased var, count) from per-replica
    partial sums: ONE fused all-reduce of ``cat(Σx, Σx², n)`` in f32,
    across ``group``, or within this rank's subgroup of it when
    ``group_size`` is given (:func:`group_for`).

    ``local_count`` is a scalar or per-channel tensor; uneven and empty
    shards are exact (an empty shard adds zeros)."""
    group = group_for(group_size, group)
    c = local_sum.shape[0]
    count_vec = local_count.to(torch.float32).reshape(-1)
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
    return mean, var, count
