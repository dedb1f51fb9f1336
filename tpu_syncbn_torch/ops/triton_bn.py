"""Hand-written kernels for the BatchNorm hot ops on Hopper — the
counterpart of ``tpu_syncbn.ops.pallas_bn``.

Four kernels over a channel-last view ``(M, C)``, ``M = N·H·W``; the two
forward ones are CUDA C++ (``ops/cuda_bn.py``, ``csrc/bn_*.cu``), the two
backward ones Triton (below):

* :func:`bn_stats`           — per-channel ``(Σx, Σx², n)`` in one read of
                               x, one launch (CUDA ``csrc/bn_stats.cu``;
                               replaces ``pallas_bn._stats_kernel``);
* :func:`bn_normalize`       — ``y = x·scale + shift``, scale and shift
                               folded per channel by ``fold_scale_shift``
                               (CUDA ``csrc/bn_normalize.cu``; replaces
                               ``pallas_bn._normalize_kernel``);
* :func:`bn_backward_reduce` — per-channel ``(Σdy, Σdy·x̂)`` in one fused
                               read of (dy, x) (Triton; replaces
                               ``pallas_bn._bwd_reduce_kernel``);
* :func:`bn_backward_elemt`  — ``dx = (dy − Σdy/n − x̂·Σdy·x̂/n)·invstd·γ``,
                               the elementwise pass the JAX custom VJP leaves
                               to XLA fusion (Triton; ``pallas_bn._fbn_bwd``).

What bounds them on an H100. Each does 1–3 floating-point operations per
element it moves, far below the ~295 operations per byte at which the
card stops being bound by device memory, so every kernel is bound by the
bytes it must move: stats 1 read of x, normalize 1 read + 1 write,
backward-reduce 2 reads, backward-elemt 2 reads + 1 write, each
``M·C·itemsize`` bytes. The designs answer that bound and nothing else:
loads are coalesced along the contiguous channel axis, every element is
read exactly once, accumulation is in f32 registers, and enough programs
are launched to keep every SM streaming.

Reductions across blocks. A Pallas grid runs in order, so the TPU kernels
carry one accumulator across grid steps. Hopper runs blocks in no order;
here M is split across programs, each program loops over its rows and
writes f32 partial sums to an ``(n_row_blocks, 2, C)`` workspace, and the
partials are summed in a fixed order: by a second small Triton pass for
backward-reduce, and inside the same launch by the last block of each
column block to arrive for stats (``csrc/bn_stats.cu``). No atomic touches
a sum, so every result is deterministic. C is tiled in a second grid
dimension, so wide layers (C = 2048) need no large on-chip buffer. Rows
past M are masked, not padded in memory.

Dispatch. Each public wrapper checks its inputs, then runs the kernel for
a CUDA tensor or the plain PyTorch version beside it for a CPU tensor
(see ``_triton_common.use_kernel``). A CUDA tensor never falls back: the
launch succeeds or raises. ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels.
"""

import types

import torch

from tpu_syncbn_torch.obs import numerics as obs_numerics
from tpu_syncbn_torch.ops import _triton_common as _tc
from tpu_syncbn_torch.ops import cuda_bn
from tpu_syncbn_torch.ops.batch_norm import fold_scale_shift
from tpu_syncbn_torch.parallel.collectives import (
    moments_from_stats,
    psum,
    reduce_moments,
    world_size,
)

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {
    "bn_stats": 0,
    "bn_normalize": 0,
    "bn_backward_reduce": 0,
    "bn_backward_elemt": 0,
}

#: Times :class:`FusedBatchNorm` had to make an incoming gradient dense
#: before its kernels could read it (autograd may hand over any strides).
DY_RELAYOUTS = [0]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# Bound on first launch by _kernels(); module globals so the Triton
# compiler resolves ``tl`` inside the kernel bodies.
triton = None
tl = None
_KERNELS = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    DY_RELAYOUTS[0] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


# -- input checks -----------------------------------------------------------


def _as_2d(x: torch.Tensor, name: str = "x") -> torch.Tensor:
    """The ``(M, C)`` view of a channel-last tensor; raises on anything the
    kernels do not take (never copies)."""
    if x.dim() < 1:
        raise ValueError(f"{name} must have a channel axis, got a scalar")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32/bfloat16/float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            f"{name} must be a dense channel-last (..., C) tensor; got shape "
            f"{tuple(x.shape)} with strides {x.stride()}"
        )
    return x.view(-1, x.shape[-1])


def _check_vec(v: torch.Tensor, c: int, like: torch.Tensor, name: str) -> None:
    if v.shape != (c,) or v.dtype != torch.float32:
        raise ValueError(
            f"{name} must be a float32 ({c},) tensor, got {v.dtype} "
            f"{tuple(v.shape)}"
        )
    if v.device != like.device or not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {like.device}")


def _check_pair(dy2: torch.Tensor, x2: torch.Tensor) -> None:
    if dy2.shape != x2.shape or dy2.device != x2.device:
        raise ValueError(
            f"dy {tuple(dy2.shape)} on {dy2.device} does not match x "
            f"{tuple(x2.shape)} on {x2.device}"
        )


# -- plain PyTorch versions (same arithmetic, any device) ------------------


def _acc(*ts) -> torch.dtype:
    """f32 for bf16/f16/f32 inputs, f64 for f64 inputs (the float64
    reference the card's parity check computes)."""
    dt = torch.float32
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def stats_plain(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the stats kernel: per-channel (Σx, Σx²)."""
    xf = x2.to(_acc(x2))
    return xf.sum(0), (xf * xf).sum(0)


def normalize_plain(x2, scale, shift) -> torch.Tensor:
    """Plain version of the normalize kernel: ``x·scale + shift``."""
    acc = _acc(x2, scale)
    y = x2.to(acc) * scale.to(acc) + shift.to(acc)
    return y.to(x2.dtype)


def backward_reduce_plain(dy2, x2, mean, invstd):
    """Plain version of the backward-reduce kernel: (Σdy, Σdy·x̂)."""
    acc = _acc(dy2, x2, mean)
    dyf = dy2.to(acc)
    xhat = (x2.to(acc) - mean.to(acc)) * invstd.to(acc)
    return dyf.sum(0), (dyf * xhat).sum(0)


def backward_elemt_plain(dy2, x2, mean, invstd, weight, sum_dy, sum_dy_xhat,
                         count):
    """Plain version of the backward-elemt kernel."""
    acc = _acc(dy2, x2, mean)
    mean, invstd = mean.to(acc), invstd.to(acc)
    mean_dy = sum_dy.to(acc) / count.to(acc)
    mean_dy_xhat = sum_dy_xhat.to(acc) / count.to(acc)
    xhat = (x2.to(acc) - mean) * invstd
    dx = (dy2.to(acc) - mean_dy - xhat * mean_dy_xhat) * invstd
    if weight is not None:
        dx = dx * weight.to(acc)
    return dx.to(x2.dtype)


# -- the Triton kernels ------------------------------------------------------


def _kernels():
    """Import Triton and define the kernels, once per process. Triton JIT-
    compiles each on its first launch for a new specialization."""
    global triton, tl, _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    triton, tl = _tc.import_triton()

    # Replaces pallas_bn._bwd_reduce_kernel. Bound: one read each of dy
    # and x, 2·M·C·itemsize bytes per call (the stem's 802816x64 bf16
    # views: 206 MB, 61 us at 3.35 TB/s). Design: every element read once,
    # coalesced along C, into f32 register accumulators, ~4 programs per SM
    # keeping loads in flight; x̂ is recomputed in registers, never stored.
    @triton.jit
    def bwd_reduce_partial(dy_ptr, x_ptr, mean_ptr, invstd_ptr, ws_ptr,
                           M, C, rows_per_prog,
                           BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
        # program (pid_m, pid_c): rows [pid_m·rows_per_prog, +rows_per_prog),
        # channels [pid_c·BLOCK_C, +BLOCK_C); partial (Σdy, Σdy·x̂) -> ws[pid_m]
        pid_m = tl.program_id(0)
        pid_c = tl.program_id(1)
        cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        invstd = tl.load(invstd_ptr + cols, mask=cmask, other=0.0)
        acc_a = tl.zeros((BLOCK_M, BLOCK_C), dtype=tl.float32)
        acc_b = tl.zeros((BLOCK_M, BLOCK_C), dtype=tl.float32)
        row0 = pid_m.to(tl.int64) * rows_per_prog
        for i in range(0, rows_per_prog, BLOCK_M):
            rows = row0 + i + tl.arange(0, BLOCK_M)
            mask = (rows < M)[:, None] & cmask[None, :]
            offs = rows[:, None] * C + cols[None, :]
            dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            xhat = (x - mean[None, :]) * invstd[None, :]
            acc_a += dy
            acc_b += dy * xhat
        out = ws_ptr + pid_m.to(tl.int64) * (2 * C) + cols
        tl.store(out, tl.sum(acc_a, axis=0), mask=cmask)
        tl.store(out + C, tl.sum(acc_b, axis=0), mask=cmask)

    # The second pass of the reduction: n_parts·2·C f32 values, a few
    # hundred kilobytes at most, summed in a fixed order (deterministic).
    @triton.jit
    def sum_partials(ws_ptr, out_ptr, n_parts, C,
                     BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        # second pass: out[k, c] = Σ_p ws[p, k, c], summed in a fixed order
        pid = tl.program_id(0)
        cols = pid * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc_a = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
        acc_b = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            parts = p0 + tl.arange(0, BLOCK_P)
            mask = (parts < n_parts)[:, None] & cmask[None, :]
            ptr = ws_ptr + parts[:, None] * (2 * C) + cols[None, :]
            acc_a += tl.load(ptr, mask=mask, other=0.0)
            acc_b += tl.load(ptr + C, mask=mask, other=0.0)
        tl.store(out_ptr + cols, tl.sum(acc_a, axis=0), mask=cmask)
        tl.store(out_ptr + C + cols, tl.sum(acc_b, axis=0), mask=cmask)

    # Replaces the XLA-fused dx tail of pallas_bn._fbn_bwd. Bound: reads
    # of dy and x and a write of dx, 3·M·C·itemsize bytes per call.
    # Design: x̂ and the per-channel terms are recomputed in registers, so
    # the whole backward reads each activation twice and writes once.
    @triton.jit
    def backward_elemt(dy_ptr, x_ptr, dx_ptr, mean_ptr, invstd_ptr, w_ptr,
                       sdy_ptr, sdyx_ptr, count_ptr, M, C,
                       HAS_W: tl.constexpr,
                       BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
        # dx = (dy − Σdy/n − x̂·Σdy·x̂/n)·invstd·γ, one tile per program
        rows = tl.program_id(0).to(tl.int64) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mask = (rows < M)[:, None] & cmask[None, :]
        offs = rows[:, None] * C + cols[None, :]
        n = tl.load(count_ptr)
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        invstd = tl.load(invstd_ptr + cols, mask=cmask, other=0.0)
        mean_dy = tl.load(sdy_ptr + cols, mask=cmask, other=0.0) / n
        mean_dyx = tl.load(sdyx_ptr + cols, mask=cmask, other=0.0) / n
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = (x - mean[None, :]) * invstd[None, :]
        dx = (dy - mean_dy[None, :] - xhat * mean_dyx[None, :]) * invstd[None, :]
        if HAS_W:
            w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
            dx = dx * w[None, :]
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)

    _KERNELS = types.SimpleNamespace(
        bwd_reduce_partial=bwd_reduce_partial,
        sum_partials=sum_partials,
        backward_elemt=backward_elemt,
    )
    return _KERNELS


# Reductions: 64-row tiles, at most 64 channels per program, and about
# four programs per SM so each SM keeps several tiles of loads in flight.
_RED_BLOCK_M = 64
_RED_MAX_C = 64
_RED_PROGRAMS_PER_SM = 4
_PART_BLOCK = 64
# Elementwise: one 4096-element tile per program, up to 128 channels wide.
_EW_TILE = 4096
_EW_MAX_C = 128
_NUM_WARPS = 4


def reduction_plan(m: int, c: int, n_sm: int) -> tuple[int, int, int, int]:
    """``(block_c, n_row_blocks, n_col_blocks, rows_per_prog)`` for a
    reduction over an (m, c) view: rows split so that about
    ``_RED_PROGRAMS_PER_SM · n_sm`` programs run, each over a whole number
    of 64-row tiles, and no program is empty (m = 0 still gets one)."""
    block_c = max(16, min(_RED_MAX_C, _tc.pow2_at_least(c)))
    n_c = _tc.cdiv(c, block_c)
    want = max(1, _tc.cdiv(_RED_PROGRAMS_PER_SM * n_sm, n_c))
    n_m = max(1, min(_tc.cdiv(m, _RED_BLOCK_M), want))
    rows_per_prog = max(1, _tc.cdiv(_tc.cdiv(m, n_m), _RED_BLOCK_M)) * _RED_BLOCK_M
    n_m = max(1, _tc.cdiv(m, rows_per_prog))
    return block_c, n_m, n_c, rows_per_prog


def _elementwise_blocks(c: int) -> tuple[int, int]:
    block_c = max(16, min(_EW_MAX_C, _tc.pow2_at_least(c)))
    return _EW_TILE // block_c, block_c


def _reduce(partial_kernel, args, m: int, c: int, device) -> torch.Tensor:
    """Run a partial-sum kernel and the fixed-order second pass; returns
    the ``(2, C)`` f32 sums."""
    k = _kernels()
    block_c, n_m, n_c, rows_per_prog = reduction_plan(m, c, _tc.sm_count(device))
    ws = torch.empty((n_m, 2, c), dtype=torch.float32, device=device)
    partial_kernel[(n_m, n_c)](
        *args, ws, m, c, rows_per_prog,
        BLOCK_M=_RED_BLOCK_M, BLOCK_C=block_c, num_warps=_NUM_WARPS,
    )
    out = torch.empty((2, c), dtype=torch.float32, device=device)
    fin_c = min(32, block_c)
    k.sum_partials[(_tc.cdiv(c, fin_c),)](
        ws, out, n_m, c, BLOCK_P=_PART_BLOCK, BLOCK_C=fin_c,
        num_warps=_NUM_WARPS,
    )
    return out


def _stats_kernel(x2: torch.Tensor):
    out = cuda_bn.stats(x2)
    LAUNCHES["bn_stats"] += 1
    return out


def _normalize_kernel(x2, scale, shift) -> torch.Tensor:
    y = cuda_bn.normalize(x2, scale, shift)
    if x2.shape[0]:
        LAUNCHES["bn_normalize"] += 1
    return y


def _backward_reduce_kernel(dy2, x2, mean, invstd):
    m, c = x2.shape
    out = _reduce(_kernels().bwd_reduce_partial, (dy2, x2, mean, invstd),
                  m, c, x2.device)
    LAUNCHES["bn_backward_reduce"] += 1
    return out[0], out[1]


def _backward_elemt_kernel(dy2, x2, mean, invstd, weight, sum_dy,
                           sum_dy_xhat, count) -> torch.Tensor:
    m, c = x2.shape
    dx = torch.empty_like(x2)
    if m:
        block_m, block_c = _elementwise_blocks(c)
        _kernels().backward_elemt[(_tc.cdiv(m, block_m), _tc.cdiv(c, block_c))](
            dy2, x2, dx, mean, invstd,
            weight if weight is not None else invstd,
            sum_dy, sum_dy_xhat, count, m, c,
            HAS_W=weight is not None,
            BLOCK_M=block_m, BLOCK_C=block_c, num_warps=_NUM_WARPS,
        )
        LAUNCHES["bn_backward_elemt"] += 1
    return dx


# -- dispatch on (M, C) views ---------------------------------------------


def _stats_2d(x2):
    """``(Σx, Σx², n)``: the kernel's three views of one buffer, or the
    plain sums and the row count."""
    if _tc.use_kernel(x2):
        return _stats_kernel(x2)
    s, sq = stats_plain(x2)
    return s, sq, torch.full((), float(x2.shape[0]), dtype=torch.float32,
                             device=x2.device)


def _normalize_2d(x2, scale, shift):
    if _tc.use_kernel(x2):
        return _normalize_kernel(x2, scale, shift)
    return normalize_plain(x2, scale, shift)


def _backward_reduce_2d(dy2, x2, mean, invstd):
    if _tc.use_kernel(x2):
        return _backward_reduce_kernel(dy2, x2, mean, invstd)
    return backward_reduce_plain(dy2, x2, mean, invstd)


def _backward_elemt_2d(dy2, x2, mean, invstd, weight, sum_dy, sum_dy_xhat,
                       count):
    if _tc.use_kernel(x2):
        return _backward_elemt_kernel(dy2, x2, mean, invstd, weight, sum_dy,
                                      sum_dy_xhat, count)
    return backward_elemt_plain(dy2, x2, mean, invstd, weight, sum_dy,
                                sum_dy_xhat, count)


# -- public wrappers --------------------------------------------------------


def bn_stats(x: torch.Tensor):
    """Per-channel ``(Σx, Σx², count)`` of a channel-last tensor, f32 —
    one read of x. Same contract as ``ops.batch_norm.batch_norm_stats``."""
    return _stats_2d(_as_2d(x))


class _Normalize(torch.autograd.Function):
    """``y = x·scale + shift`` through :func:`_normalize_2d`, with its
    backward (dx = dy·scale, dscale = Σ dy·x, dshift = Σ dy over rows) for
    an eval-mode normalize a gradient flows through."""

    @staticmethod
    def forward(ctx, x2, scale, shift):
        ctx.save_for_backward(x2, scale)
        return _normalize_2d(x2, scale, shift)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dyf = dy.to(torch.float32)
        dx = (dyf * scale).to(x2.dtype) if ctx.needs_input_grad[0] else None
        dscale = (dyf * x2.to(torch.float32)).sum(0) if ctx.needs_input_grad[1] else None
        dshift = dyf.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dscale, dshift


def bn_normalize(x, mean, var, weight, bias, eps: float) -> torch.Tensor:
    """``batch_norm_elemt`` as one fused pass: (mean, var, γ, β, eps) folded
    to per-channel (scale, shift), then ``y = x·scale + shift`` in
    ``x.dtype``. Differentiable in x, γ and β where a gradient is asked
    for (eval-mode BN inside a graph that trains)."""
    x2 = _as_2d(x)
    c = x2.shape[1]
    scale, shift = fold_scale_shift(mean, var, weight, bias, eps)
    _check_vec(scale, c, x2, "scale")
    if torch.is_grad_enabled() and (x2.requires_grad or scale.requires_grad
                                    or shift.requires_grad):
        return _Normalize.apply(x2, scale, shift).view(x.shape)
    return _normalize_2d(x2, scale, shift).view(x.shape)


def bn_backward_reduce(dy, x, mean, invstd):
    """Per-channel ``(Σdy, Σdy·x̂)`` with ``x̂ = (x − mean)·invstd``, f32 —
    one fused read of (dy, x)."""
    dy2, x2 = _as_2d(dy, "dy"), _as_2d(x)
    _check_pair(dy2, x2)
    c = x2.shape[1]
    _check_vec(mean, c, x2, "mean")
    _check_vec(invstd, c, x2, "invstd")
    return _backward_reduce_2d(dy2, x2, mean, invstd)


def bn_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xhat,
                      count) -> torch.Tensor:
    """``dx = (dy − Σdy/n − x̂·Σdy·x̂/n)·invstd·γ`` in ``x.dtype``, with the
    (already all-reduced) sums and the global count ``n``."""
    dy2, x2 = _as_2d(dy, "dy"), _as_2d(x)
    _check_pair(dy2, x2)
    c = x2.shape[1]
    for v, name in ((mean, "mean"), (invstd, "invstd"), (sum_dy, "sum_dy"),
                    (sum_dy_xhat, "sum_dy_xhat")):
        _check_vec(v, c, x2, name)
    if weight is not None:
        _check_vec(weight, c, x2, "weight")
    if count.numel() != 1 or count.dtype != torch.float32 \
            or count.device != x2.device:
        raise ValueError("count must be a one-element float32 tensor on "
                         f"{x2.device}")
    return _backward_elemt_2d(dy2, x2, mean, invstd, weight, sum_dy,
                              sum_dy_xhat, count).view(x.shape)


# -- fused training-mode batch norm ---------------------------------------


class FusedBatchNorm(torch.autograd.Function):
    """Training-mode BN through the kernels, with the hand-derived
    backward — the counterpart of ``pallas_bn.fused_batch_norm``.

    Forward: stats kernel → one all-reduce of ``(Σx, Σx², n)`` (world > 1)
    → fold → normalize kernel. Backward: backward-reduce kernel → one
    all-reduce of ``(Σdy, Σdy·x̂)`` (world > 1) → backward-elemt kernel.
    Those two all-reduces are SyncBN's whole traffic.

    ``apply(x, weight, bias, eps, group)`` returns ``(y, mean, var,
    count)``; x is channel-last and dense. mean, var and count feed the
    running-stat update only: they are non-differentiable, so asking for
    a gradient through them raises."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        x2 = _as_2d(x)
        c = x2.shape[1]
        s, sq, count = bn_stats(x)
        if world_size(group) > 1:
            mean, var, count = reduce_moments(s, sq, count, group)
        else:
            mean, var = moments_from_stats(s, sq, count)
            if group is not None:
                # a synced layer alone: the JAX mesh of one still sums and
                # records its skew (0 against itself), so the monitor key
                # set is the same at every world
                obs_numerics.record_bn_skew_alone(x.device)
        scale, shift = fold_scale_shift(mean, var, weight, bias, eps)
        _check_vec(scale, c, x2, "scale")
        y = _normalize_2d(x2, scale, shift).view(x.shape)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.bias_dtype = bias.dtype if bias is not None else None
        ctx.group = group
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(mean, var, count)
        return y, mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        x, weight, mean, invstd, count = ctx.saved_tensors
        if dy is None:
            return None, None, None, None, None
        if not dy.is_contiguous():
            # autograd may deliver the gradient in any strides; the
            # kernels read dense channel-last rows, so make it so here
            # (counted, so a run shows how often this costs a copy)
            DY_RELAYOUTS[0] += 1
            dy = dy.contiguous()
        dy2, x2 = _as_2d(dy, "dy"), _as_2d(x)
        c = x2.shape[1]
        sum_dy, sum_dy_xhat = _backward_reduce_2d(dy2, x2, mean, invstd)
        # γ/β gradients from the LOCAL sums: the trainer's gradient
        # all-reduce aggregates them across replicas, as DDP does
        gw = sum_dy_xhat.to(weight.dtype) \
            if weight is not None and ctx.needs_input_grad[1] else None
        gb = sum_dy.to(ctx.bias_dtype) \
            if ctx.bias_dtype is not None and ctx.needs_input_grad[2] else None
        dx = None
        if ctx.needs_input_grad[0]:
            if world_size(ctx.group) > 1:
                both = psum(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
                sum_dy, sum_dy_xhat = both[:c], both[c:]
            w = weight.to(torch.float32) if weight is not None else None
            dx = _backward_elemt_2d(dy2, x2, mean, invstd, w, sum_dy,
                                    sum_dy_xhat, count).view(x.shape)
        return dx, gw, gb, None, None


def fused_batch_norm(x, weight, bias, eps: float, group=None):
    """Functional spelling of :class:`FusedBatchNorm`."""
    return FusedBatchNorm.apply(x, weight, bias, eps, group)
