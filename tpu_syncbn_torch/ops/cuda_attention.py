"""Exact fused softmax attention on hand-written CUDA kernels for Hopper —
the counterpart of ``tpu_syncbn.ops.pallas_attention``.

Three kernel families (``csrc/flash_*.cu``, CUDA C++ for ``sm_90a``, built
with ``nvcc`` at first launch and bound with ``ctypes``), each with a
``causal`` template flag where the TPU needed two Pallas kernels:

* :func:`flash_fwd`      — O and the row logsumexp (replaces
                           ``_attn_kernel_causal`` and ``_attn_kernel_rect``);
* :func:`flash_bwd_dkdv` — dK, dV from P recomputed with the logsumexp
                           (replaces ``_bwd_kv_kernel_c`` and ``_bwd_kv_kernel``);
* :func:`flash_bwd_dq`   — dQ likewise (replaces ``_bwd_q_kernel_c`` and
                           ``_bwd_q_kernel``).

Beside each kernel is its plain PyTorch version with the same arguments
(``flash_fwd_plain``, ``flash_bwd_dkdv_plain``, ``flash_bwd_dq_plain``),
blockwise over query rows so a float64 reference fits on the card at long
L. A wrapper runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (``set_kernel_mode``, shared with the BN
kernels); a CUDA tensor the kernel cannot take raises, it is never copied
or sent to the plain version. ``LAUNCHES`` counts kernel launches.

Layout: every operand is ``(B, L, H, D)`` as the JAX package's public
function takes it. The kernels read q, k and v through their batch, row
and head strides with D contiguous, so views into a fused QKV product
need no transpose copy (the JAX package copies to ``(B*H, L, D)``);
lse and delta are ``(B*H, L)`` float32. D may be any multiple of 8 up to
128. Two designs, chosen by dtype inside the kernels:

* bfloat16 — all three kernels are built for Hopper: a producer warp
  streams tiles by TMA (through per-call tensor maps over the (B, L, H, D)
  strides) into a 3-stage shared-memory ring, and two consumer warpgroups
  multiply with ``wgmma``, P and dS going from one product to the next in
  registers (128 query rows x 128-key tiles forward; 128 KV rows x
  64-query tiles for dK/dV; 128 query rows x 64-key tiles for dQ; the
  backward tiles are 32 rows at D > 64). D is padded to 64 or 128 in
  shared memory only, by TMA's zero fill. P and dS are rounded to bf16
  for their products, as a TPU's default-precision dot rounds them.
* float32 — every kernel computes in full f32 on the CUDA cores (no
  TF32, which is ``wgmma``'s only 32-bit input), on 64 x 64 tiles of
  ``mma.sync``-shaped warp products from padded shared memory.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpu_syncbn_torch.ops import _cuda_build
from tpu_syncbn_torch.ops import _triton_common as _tc
from tpu_syncbn_torch.parallel.sequence import _NEG_BIG, _qk_scale

#: Kernel launches per family since the last :func:`reset_launch_counts`.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

_BLOCK_Q = 128
_BLOCK_K = 128
_MAX_HEAD_DIM = 128
# query rows per step of the plain versions: bounds their (B*H, rows, L)
# score block
_PLAIN_ROWS = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


# -- plain versions ---------------------------------------------------------


def _acc(x: torch.Tensor) -> torch.dtype:
    """Arithmetic dtype of the plain versions: float64 for float64 inputs
    (the card's reference), else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _bh(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(B, L, H, D) -> (B*H, L, D) in ``dt``."""
    b, l, h, d = x.shape
    return x.to(dt).permute(0, 2, 1, 3).reshape(b * h, l, d)


def _blhd(x: torch.Tensor, b: int, h: int, dtype: torch.dtype) -> torch.Tensor:
    """(B*H, L, D) -> contiguous (B, L, H, D) in ``dtype``."""
    _, l, d = x.shape
    return x.reshape(b, h, l, d).transpose(1, 2).contiguous().to(dtype)


def _live(r0: int, r1: int, l: int, causal: bool, device) -> Optional[torch.Tensor]:
    """(rows, L) mask of the keys query rows [r0, r1) may see (None: all)."""
    if not causal:
        return None
    rows = torch.arange(r0, r1, device=device)[:, None]
    return rows >= torch.arange(l, device=device)[None, :]


def flash_fwd_plain(q, k, v, *, causal: bool, scale: float):
    """Plain version of :func:`flash_fwd`: ``(o, lse)``, o ``(B, L, H, D)``
    in q's dtype, lse ``(B*H, L)`` (float32; float64 for float64 inputs).
    The same arithmetic as ``_attend_tile``: masked logits set to the
    finite ``_NEG_BIG``, ``l = max(l, 1e-30)``, ``lse = m + log l``."""
    b, l, h, _ = q.shape
    dt = _acc(q)
    qs, kf, vf = _bh(q, dt) * scale, _bh(k, dt), _bh(v, dt)
    o = torch.empty_like(qs)
    lse = torch.empty(qs.shape[:2], dtype=dt, device=q.device)
    for r0 in range(0, l, _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, l)
        s = qs[:, r0:r1] @ kf.transpose(1, 2)
        live = _live(r0, r1, l, causal, q.device)
        if live is not None:
            s = torch.where(live, s, _NEG_BIG)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o[:, r0:r1] = (p @ vf) / den
        lse[:, r0:r1] = (m + torch.log(den)).squeeze(-1)
    return _blhd(o, b, h, q.dtype), lse if dt == torch.float64 else lse.float()


def _p_ds(qs_c, kf, vf, do_c, lse_c, delta_c, live):
    """``_bwd_p_ds`` for a block of query rows against every key: P from
    the logsumexp with dead entries selected to 0, and dS."""
    p = torch.exp(qs_c @ kf.transpose(1, 2) - lse_c[..., None])
    if live is not None:
        p = torch.where(live, p, 0.0)
    dp = do_c @ vf.transpose(1, 2)
    return p, p * (dp - delta_c[..., None])


def _bwd_operands(q, k, v, do, lse, delta, scale):
    dt = _acc(q)
    return (dt, _bh(q, dt) * scale, _bh(k, dt), _bh(v, dt), _bh(do, dt),
            lse.to(dt), delta.to(dt))


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """Plain version of :func:`flash_bwd_dkdv`: ``(dk, dv)`` in q's dtype
    (``_bwd_kv_kernel``'s arithmetic, every query row against each key)."""
    b, l, h, _ = q.shape
    dt, qs, kf, vf, dof, lsef, deltaf = _bwd_operands(q, k, v, do, lse, delta, scale)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for r0 in range(0, l, _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, l)
        p, ds = _p_ds(qs[:, r0:r1], kf, vf, dof[:, r0:r1], lsef[:, r0:r1],
                      deltaf[:, r0:r1], _live(r0, r1, l, causal, q.device))
        dv += p.transpose(1, 2) @ dof[:, r0:r1]
        dk += ds.transpose(1, 2) @ qs[:, r0:r1]
    return _blhd(dk, b, h, q.dtype), _blhd(dv, b, h, q.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """Plain version of :func:`flash_bwd_dq`: dq in q's dtype
    (``_bwd_q_kernel``'s arithmetic, ``dq = scale * dS K``)."""
    b, l, h, _ = q.shape
    dt, qs, kf, vf, dof, lsef, deltaf = _bwd_operands(q, k, v, do, lse, delta, scale)
    dq = torch.empty_like(qs)
    for r0 in range(0, l, _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, l)
        _, ds = _p_ds(qs[:, r0:r1], kf, vf, dof[:, r0:r1], lsef[:, r0:r1],
                      deltaf[:, r0:r1], _live(r0, r1, l, causal, q.device))
        dq[:, r0:r1] = (ds @ kf) * scale
    return _blhd(dq, b, h, q.dtype)


def row_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ∘ O) as ``(B*H, L)``, float32 (float64 for float64
    inputs): the softmax-Jacobian correction both backward kernels read,
    which the JAX package computes outside its kernels too."""
    dt = _acc(o)
    b, l, h, _ = o.shape
    return (do.to(dt) * o.to(dt)).sum(-1).transpose(1, 2).contiguous().reshape(b * h, l)


def flash_bwd_scan(q, k, v, o, lse, do, *, causal: bool, scale: float,
                   block_k: int):
    """The default backward (``backward="xla"``): ``_flash_bwd_2d``, one
    loop over KV blocks of ``block_k`` keys, each against every query row.
    It has no kernel in the JAX package either (an XLA ``lax.scan``);
    plain PyTorch on every device. Returns ``(dq, dk, dv)`` in q's dtype."""
    b, l, h, _ = q.shape
    dt, qs, kf, vf, dof, lsef, deltaf = _bwd_operands(
        q, k, v, do, lse, row_delta(do, o), scale)
    dq, dk, dv = torch.zeros_like(qs), torch.empty_like(kf), torch.empty_like(vf)
    rows = torch.arange(l, device=q.device)[:, None]
    for c0 in range(0, l, block_k):
        c1 = min(c0 + block_k, l)
        kb, vb = kf[:, c0:c1], vf[:, c0:c1]
        s = qs @ kb.transpose(1, 2)
        if causal:
            s = torch.where(rows >= torch.arange(c0, c1, device=q.device), s,
                            _NEG_BIG)
        p = torch.exp(s - lsef[..., None])
        dv[:, c0:c1] = p.transpose(1, 2) @ dof
        ds = p * (dof @ vb.transpose(1, 2) - deltaf[..., None])
        dq += ds @ kb
        dk[:, c0:c1] = ds.transpose(1, 2) @ qs
    return (_blhd(dq * scale, b, h, q.dtype), _blhd(dk, b, h, q.dtype),
            _blhd(dv, b, h, q.dtype))


# -- kernels ------------------------------------------------------------------


def _readable(x: torch.Tensor) -> bool:
    """Whether the kernels can read ``x`` in place: D contiguous, every
    stride and the address on 16-byte boundaries."""
    per16 = 16 // x.element_size()
    return (x.stride(-1) == 1 and not any(s % per16 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_operand(x: torch.Tensor, like: torch.Tensor, name: str) -> None:
    """What the kernels read: a CUDA (B, L, H, D) tensor of q's dtype
    (float32 or bfloat16), D contiguous and a multiple of 8 up to 128,
    every stride and the address on 16-byte boundaries."""
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(f"{name} must be on {like.device} in {like.dtype}, "
                         f"got {x.device} {x.dtype}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape != like.shape:
        raise ValueError(f"{name} must be (B, L, H, D) like q {tuple(like.shape)}, "
                         f"got {tuple(x.shape)}")
    d = x.shape[-1]
    if d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the flash kernels take multiples of 8 "
                         f"up to {_MAX_HEAD_DIM}")
    if not _readable(x):
        raise ValueError(
            f"{name}: the flash kernels need D contiguous and 16-byte aligned "
            f"strides and address, got strides {x.stride()}")


def _check_rows(x: torch.Tensor, q: torch.Tensor, name: str) -> None:
    b, l, h, _ = q.shape
    if x.device != q.device or x.dtype != torch.float32 \
            or tuple(x.shape) != (b * h, l) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 (B*H, L) = "
                         f"{(b * h, l)} tensor on {q.device}, got "
                         f"{tuple(x.shape)} {x.dtype} {x.device}")


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, ctypes.c_float, _P],
    "flash_bwd_dkdv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                       ctypes.c_float, _P],
    "flash_bwd_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                     ctypes.c_float, _P],
}


def _launcher(name: str):
    """The C launcher ``name`` of ``csrc/<name>.cu``, built and bound with
    its argument types on first use."""
    lib = _cuda_build.library(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return lib, fn


def _launch(name: str, tensors, strides_of, q, causal: bool, scale: float) -> None:
    b, l, h, d = q.shape
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernels' grid limit 65535")
    lib, fn = _launcher(name)
    strides = (ctypes.c_longlong * (3 * len(strides_of)))(
        *[s for x in strides_of for s in x.stride()[:3]])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], int(bool(causal)),
                 *[t.data_ptr() for t in tensors], b, h, l, d,
                 ctypes.cast(strides, ctypes.c_void_p), float(scale), stream)
    _cuda_build.check(lib, err, name)
    LAUNCHES[name] += 1


def _fwd_kernel(q, k, v, causal, scale):
    for x, n in ((k, "k"), (v, "v"), (q, "q")):
        _check_operand(x, q, n)
    b, l, h, d = q.shape
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    if l:
        _launch("flash_fwd", (q, k, v, o, lse), (q, k, v, o), q, causal, scale)
    return o, lse


def _bwd_checks(q, k, v, do, lse, delta):
    for x, n in ((k, "k"), (v, "v"), (do, "do"), (q, "q")):
        _check_operand(x, q, n)
    _check_rows(lse, q, "lse")
    _check_rows(delta, q, "delta")


def _dkdv_kernel(q, k, v, do, lse, delta, causal, scale):
    _bwd_checks(q, k, v, do, lse, delta)
    dk = torch.empty_like(q, memory_format=torch.contiguous_format)
    dv = torch.empty_like(dk)
    if q.shape[1]:
        _launch("flash_bwd_dkdv", (q, k, v, do, lse, delta, dk, dv),
                (q, k, v, do, dk), q, causal, scale)
    return dk, dv


def _dq_kernel(q, k, v, do, lse, delta, causal, scale):
    _bwd_checks(q, k, v, do, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.shape[1]:
        _launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq),
                (q, k, v, do, dq), q, causal, scale)
    return dq


# -- dispatch: kernel for a CUDA tensor, plain version for a CPU tensor ------


def flash_fwd(q, k, v, *, causal: bool, scale: float):
    """``(o, lse)`` of exact softmax attention (see :func:`flash_fwd_plain`)."""
    if _tc.use_kernel(q):
        return _fwd_kernel(q, k, v, causal, scale)
    return flash_fwd_plain(q, k, v, causal=causal, scale=scale)


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """``(dk, dv)`` (see :func:`flash_bwd_dkdv_plain`)."""
    if _tc.use_kernel(q):
        return _dkdv_kernel(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, causal=causal, scale=scale)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """``dq`` (see :func:`flash_bwd_dq_plain`)."""
    if _tc.use_kernel(q):
        return _dq_kernel(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal, scale=scale)


class FlashAttention(torch.autograd.Function):
    """``_flash_2d``'s custom VJP: the forward saves ``(q, k, v, o, lse)``;
    the backward is the two kernels (``backward="pallas"``: dK/dV, then dQ,
    with δ computed between) or the blockwise scan (``"xla"``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_k, backward):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.block_k, ctx.backward = (
            causal, scale, block_k, backward)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.backward == "xla":
            dq, dk, dv = flash_bwd_scan(q, k, v, o, lse, do, causal=ctx.causal,
                                        scale=ctx.scale, block_k=ctx.block_k)
            return dq, dk, dv, None, None, None, None
        if do.is_cuda and not _readable(do):
            # autograd may hand over any strides (an expanded scalar's, say)
            do = do.clone(memory_format=torch.contiguous_format)
        delta = row_delta(do, o)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal=ctx.causal,
                                scale=ctx.scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=ctx.causal,
                          scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = _BLOCK_Q, block_k: int = _BLOCK_K,
                    backward: str = "xla") -> torch.Tensor:
    """Exact fused softmax attention, ``(B, L, H, D) → (B, L, H, D)``,
    differentiable; ``scale`` defaults to ``D**-0.5``. ``backward``:
    ``"xla"`` (default, the blockwise scan in plain PyTorch) or
    ``"pallas"`` (the dK/dV and dQ kernels). ``block_q``/``block_k`` are
    the JAX package's TPU tiling knobs: the scan backward honours
    ``block_k`` as JAX does, while the CUDA kernels choose their own tiles
    by dtype and head dim (see the module docstring), so ``block_q``
    changes nothing here."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, L, H, D), got {tuple(q.shape)}")
    if backward not in ("xla", "pallas"):
        raise ValueError(f"backward must be 'xla' or 'pallas', got {backward!r}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention requires q, k, v of identical (B, L, H, D) "
            f"shape, got q={tuple(q.shape)}, k={tuple(k.shape)}, "
            f"v={tuple(v.shape)}")
    s = _qk_scale(q.shape[-1], scale)
    return FlashAttention.apply(q, k, v, bool(causal), s, int(block_k), backward)
