"""The BatchNorm forward kernels in CUDA C++ for Hopper — ``bn_stats`` and
``bn_normalize`` of :mod:`tpu_syncbn_torch.ops.triton_bn` launch them.

* ``csrc/bn_stats.cu``     — per-channel ``(Σx, Σx², n)`` of an ``(M, C)``
                             view in one launch: partial sums per block,
                             then the last block of each column block sums
                             them in a fixed order (replaces
                             ``pallas_bn._stats_kernel``);
* ``csrc/bn_normalize.cu`` — ``y = x·scale + shift``, one tile of 16-byte
                             loads and stores a block, one pass (replaces
                             ``pallas_bn._normalize_kernel``).

Each source is one library, built with ``nvcc`` for ``sm_90a`` at the first
launch of any CUDA kernel of the port (``_cuda_build.build`` compiles every
source) and bound here with ``ctypes``. Both kernels run on PyTorch's
current stream and allocate nothing: the wrappers below allocate the
outputs and the scratch. The grids are planned here (:func:`stats_plan`,
a pure function of the shape, the item size and the card's SM count, so
``bn_stats`` repeats its result bit for bit on a card; and
:func:`normalize_plan`, of the shape and the item size). These functions
take CUDA tensors only; ``triton_bn`` dispatches a CPU tensor to the
plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_syncbn_torch.ops import _cuda_build
from tpu_syncbn_torch.ops import _triton_common as _tc

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# bn_stats: one block of 512 consumer threads per SM (half the partials,
# and twice the threads to sum them, of two blocks of 256); a column block
# spans at least 8 16-byte channel groups (a 128-byte strip of a row), more
# only where C is so wide that the columns alone would exceed the grid
_STATS_THREADS = 512
_STATS_BLOCKS_PER_SM = 1
_STATS_GROUPS = 8
# bn_normalize: blocks of 128 threads (the kernel's THREADS), each loading
# 4 rows of one 16-byte channel group (its UNROLL): a tile of 8 KB, as the
# Triton kernel it replaced
_NORM_THREADS = 128
_NORM_UNROLL = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "bn_stats": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bn_normalize": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

# the arrival counters of bn_stats, one int32 per column block, per device:
# allocated zeroed once, at counter_capacity(n_sm) entries, and left at zero
# by every launch. Once a CUDA graph has recorded a launch on a device its
# buffer is never replaced (the graph holds its address): a shape needing
# more counters raises instead.
_COUNTERS: dict = {}
_CAPTURED: set = set()


def stats_plan(m: int, c: int, itemsize: int, n_sm: int) -> tuple[int, int, int, int]:
    """``(gc, n_c, n_m, rows)`` of ``bn_stats`` over an (m, c) view: column
    blocks of ``gc`` 16-byte channel groups (a power of two), ``n_c`` of
    them; ``n_m`` row blocks of ``rows`` contiguous rows (the last may have
    fewer), so that at most ``n_sm`` blocks run, one wave, and none is
    empty (m = 0 still gets one)."""
    groups = _tc.cdiv(c, 16 // itemsize)
    blocks = _STATS_BLOCKS_PER_SM * n_sm
    gc = min(_tc.pow2_at_least(groups),
             max(_STATS_GROUPS, _tc.pow2_at_least(_tc.cdiv(groups, blocks))),
             _STATS_THREADS)
    n_c = _tc.cdiv(groups, gc)
    lanes = _STATS_THREADS // gc
    n_m = max(1, min(blocks // n_c, _tc.cdiv(m, lanes)))
    rows = max(1, _tc.cdiv(m, n_m))
    return gc, n_c, max(1, _tc.cdiv(m, rows)), rows


def normalize_plan(m: int, c: int, itemsize: int) -> tuple[int, int, int]:
    """``(gcols, n_rb, n_cb)`` of ``bn_normalize`` over an (m, c) view:
    blocks of 128 threads spanning ``gcols`` 16-byte channel groups (the
    row's groups rounded up to a power of two, at most 128) and
    ``128 // gcols`` row lanes of 4 rows each; ``n_rb`` row blocks by
    ``n_cb`` column blocks cover every (row, group) once."""
    groups = _tc.cdiv(c, 16 // itemsize)
    gcols = min(_tc.pow2_at_least(groups), _NORM_THREADS)
    rows = _NORM_THREADS // gcols * _NORM_UNROLL
    return gcols, max(1, _tc.cdiv(m, rows)), _tc.cdiv(groups, gcols)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, *args, device) -> None:
    """Call the C launcher ``name`` of ``csrc/<name>.cu`` (built and bound
    with its argument types on first use) on the current stream; raise if
    it returns a CUDA error."""
    lib = _cuda_build.library(name)
    fn = getattr(lib, name)
    if getattr(fn, "argtypes", None) is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    err = fn(*args, _stream(device))
    _cuda_build.check(lib, err, name)


def counter_capacity(n_sm: int) -> int:
    """Arrival counters allocated for a device of ``n_sm`` SMs: enough for
    every plan of :func:`stats_plan` whose column blocks stay under the
    512-group cap, i.e. every C up to ``512 · capacity`` channel groups
    (over 4 million bf16 channels)."""
    return max(1024, _STATS_BLOCKS_PER_SM * n_sm)


def _counters(device, n: int, n_sm: int, capturing: bool | None = None) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters on ``device``. Every
    ``bn_stats`` launch on a device shares them, so calls on one device
    run in order on one stream at a time (as every caller in the port,
    a graph replay included). The buffer is made once, before any
    capture; after a capture on the device it is never replaced."""
    key = device.index
    if capturing is None:
        capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if capturing:
            raise RuntimeError("bn_stats: call it once on this device before "
                               "capturing it in a CUDA graph (its counters "
                               "are allocated on first use)")
        if key in _CAPTURED:
            raise RuntimeError(
                f"bn_stats: this shape needs {n} arrival counters, more than "
                f"the {buf.numel()} a captured CUDA graph on this device holds; "
                "replacing them would leave the graph writing freed memory")
        buf = torch.zeros(max(n, counter_capacity(n_sm)), dtype=torch.int32,
                          device=device)
        _COUNTERS[key] = buf
    if capturing:
        _CAPTURED.add(key)
    return buf


def _check_2d(x2: torch.Tensor) -> tuple[int, int]:
    m, c = x2.shape
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32/bfloat16/float16, got {x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError("x must be a dense (M, C) view")
    if m >= 2 ** 31 or c >= 2 ** 31:
        raise ValueError(f"(M, C) = {(m, c)}: each must be below 2^31")
    return m, c


def stats(x2: torch.Tensor):
    """``(Σx, Σx², n)`` of a dense (M, C) CUDA view in f32: views of one
    ``2C + 1`` buffer that one launch fills."""
    m, c = _check_2d(x2)
    itemsize = x2.element_size()
    n_sm = _tc.sm_count(x2.device)
    gc, n_c, n_m, rows = stats_plan(m, c, itemsize, n_sm)
    cols = gc * (16 // itemsize)
    ws = torch.empty((n_m, 2, n_c * cols), dtype=torch.float32, device=x2.device)
    out = torch.empty(2 * c + 1, dtype=torch.float32, device=x2.device)
    counters = _counters(x2.device, n_c, n_sm)
    _launch("bn_stats", _DTYPE_CODE[x2.dtype], x2.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), out.data_ptr(),
            m, c, gc, n_c, n_m, rows, device=x2.device)
    return out[:c], out[c:2 * c], out[2 * c]


def normalize(x2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``x·scale + shift`` of a dense (M, C) CUDA view in its dtype; scale
    and shift are contiguous f32 ``(C,)`` on the same device. M = 0
    launches nothing."""
    m, c = _check_2d(x2)
    y = torch.empty_like(x2, memory_format=torch.contiguous_format)
    if m:
        _launch("bn_normalize", _DTYPE_CODE[x2.dtype], x2.data_ptr(), y.data_ptr(),
                scale.data_ptr(), shift.data_ptr(), m, c,
                *normalize_plan(m, c, x2.element_size()), device=x2.device)
    return y
