"""The int8 chunk-quantize kernels in CUDA C++ for Hopper —
:mod:`tpu_syncbn_torch.ops.quant_int8` launches them.

``csrc/quant_int8.cu`` is one library with three launchers (``minmax``,
``encode``, ``decode``; the source's header says what each computes and
what bounds it), built with ``nvcc`` for ``sm_90a`` at the first launch of
any CUDA kernel of the port (``_cuda_build``) and bound here with
``ctypes``. Each runs on PyTorch's current stream and allocates nothing:
the dispatch module allocates the outputs, and minmax's scratch for
chunks above ``quant_int8.WARP_CHUNK_MAX``. These functions take CUDA
tensors only and check nothing the dispatch module has not.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_syncbn_torch.ops import _cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "quant_minmax": [_P, _P, _L, _I, _L, _P, _P, _L, _P],
    "quant_encode": [_P, _P, _L, _I, _L, _P, _I, _P, _P, _P, _P, _P],
    "quant_decode": [_P, _P, _P, _L, _I, _L, _I, _I, _P, _P],
}


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(name: str, *args, device) -> None:
    lib = _cuda_build.library("quant_int8")
    fn = getattr(lib, name)
    if getattr(fn, "argtypes", None) is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _cuda_build.check(lib, err, name)


def minmax(g, e, n: int, chunk: int, n_chunks: int, ranges, partial) -> None:
    _launch("quant_minmax", _ptr(g), _ptr(e), n, chunk, n_chunks, _ptr(ranges),
            _ptr(partial), 0 if partial is None else partial.numel(), device=g.device)


def encode(g, e, n: int, chunk: int, n_chunks: int, ranges, qmax: int, q, scale, zp,
           e_out) -> None:
    _launch("quant_encode", _ptr(g), _ptr(e), n, chunk, n_chunks, _ptr(ranges), qmax,
            _ptr(q), _ptr(scale), _ptr(zp), _ptr(e_out), device=g.device)


def decode(sumq, scale, zp, n: int, chunk: int, n_chunks: int, world: int, mean: bool,
           out) -> None:
    _launch("quant_decode", _ptr(sumq), _ptr(scale), _ptr(zp), n, chunk, n_chunks, world,
            int(mean), _ptr(out), device=sumq.device)
