"""Cross-replica collectives over a ``torch.distributed`` process group —
the main-path subset of ``tpu_syncbn.parallel.collectives``.

Where the JAX package names a mesh axis, the port names a process group.
``group=None`` means "this replica alone": every collective is then the
identity, which is also what a world-1 group gives. So a single-GPU run
issues no collective at all, as the reference's SyncBN falls back to
plain BN when there is nothing to sync with.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as tdist


def world_size(group) -> int:
    """Replicas in ``group``; 1 for ``None`` or without a process group."""
    if group is None or not (tdist.is_available() and tdist.is_initialized()):
        return 1
    return tdist.get_world_size(group)


def psum(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum across the group (``all_reduce(SUM)``); a new tensor, the input
    is untouched. Identity at world 1."""
    if world_size(group) == 1:
        return tensor
    out = tensor.clone()
    tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=group)
    return out


def pmean(tensor: torch.Tensor, group) -> torch.Tensor:
    """Mean across the group: all-reduce then divide by the world size."""
    n = world_size(group)
    if n == 1:
        return tensor
    return psum(tensor, group) / n


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
        tdist.broadcast(t, src=global_src, group=group)


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count-weighted global (mean, biased var, count) from per-replica
    partial sums: ONE fused all-reduce of ``cat(Σx, Σx², n)`` in f32.

    ``local_count`` is a scalar or per-channel tensor; uneven and empty
    shards are exact (an empty shard adds zeros)."""
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
