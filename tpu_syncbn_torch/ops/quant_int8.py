"""The int8 wire of the compressed collectives: per-chunk ranges, the
shared-range int8 encode (with its error-feedback residual) and the decode
of a summed payload — each a hand-written CUDA kernel
(``csrc/quant_int8.cu``, bound by :mod:`tpu_syncbn_torch.ops.cuda_quant`)
beside its plain PyTorch version, which repeats the JAX package's XLA
arithmetic (``tpu_syncbn/parallel/collectives.py`` ``_int8_qparams`` and
the dequantize of ``compressed_psum`` / ``ef_compressed_pmean``) op for
op. :mod:`tpu_syncbn_torch.parallel.collectives` calls these three around
its all-reduces.

One deliberate difference from the JAX source: it writes ``half / qmax``
and ``/ world``, which XLA's CPU backend computes as multiplications by
the f32 reciprocal (``half · f32(1 / qmax)``; checked for every qmax from
1 to 127), so the port multiplies by the reciprocal too: its grid is the
JAX package's bit for bit, and the plain version computes the same on
the CPU and the card (ATen's CUDA division by a scalar multiplies by its
reciprocal as well).

The payload is flat f32 ``p = g (+ e)`` of ``n`` elements, cut into
chunks of ``chunk`` elements, the last padded with zeros (which enter its
range). ``ranges`` is ``cat(-min, max)`` over chunks, the form whose
all-reduce MAX gives every replica the world's range.

Dispatch as every kernel of the port (``_triton_common.use_kernel``): a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises; ``set_kernel_mode("off")`` runs the plain versions on the card
(the A/B). The kernels round after every operation, so on the same
inputs each output is bit-identical to the plain version's. ``LAUNCHES``
counts kernel launches per entry point.
"""

from __future__ import annotations

import torch

from tpu_syncbn_torch.ops import _triton_common as _tc
from tpu_syncbn_torch.ops import cuda_quant

#: Kernel launches per entry point since the last :func:`reset_launch_counts`.
LAUNCHES = {"quant_minmax": 0, "quant_encode": 0, "quant_decode": 0}

#: The kernels' two launch shapes (``csrc/quant_int8.cu``): a chunk of at
#: most this many elements is one warp's; a larger one (the ZeRO
#: reduce-scatter's one chunk a shard) is cut into tiles of :data:`TILE`
#: elements, one block each, and minmax then finishes each chunk over its
#: tiles in a second launch from a scratch of two floats a tile.
WARP_CHUNK_MAX = 4096
TILE = 4096


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _check_flat(t: torch.Tensor, name: str, dtype=torch.float32, like=None) -> None:
    if t.dim() != 1 or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if like is not None and t.device != like.device:
        raise ValueError(f"{name} lives on {t.device}, not on {like.device}")


def _payload(g, e, chunk: int) -> torch.Tensor:
    """``(n_chunks, chunk)`` blocks of ``g (+ e)``, zero-padded."""
    p = g if e is None else g + e
    pad = (-p.numel()) % chunk
    if pad:
        p = torch.cat([p, p.new_zeros(pad)])
    return p.view(-1, chunk)


def minmax_plain(g, e, chunk: int) -> torch.Tensor:
    blocks = _payload(g, e, chunk)
    return torch.cat([-blocks.amin(dim=1), blocks.amax(dim=1)])


def minmax(g: torch.Tensor, e: torch.Tensor | None = None, *, chunk: int) -> torch.Tensor:
    """``cat(-min, max)`` of each chunk of ``g (+ e)``: ``(2 n_chunks,)`` f32."""
    _check_flat(g, "g")
    if e is not None:
        _check_flat(e, "e", like=g)
        if e.shape != g.shape:
            raise ValueError(f"e {tuple(e.shape)} does not match g {tuple(g.shape)}")
    if not _tc.use_kernel(g):
        return minmax_plain(g, e, chunk)
    n_chunks = _tc.cdiv(g.numel(), chunk)
    ranges = torch.empty(2 * n_chunks, dtype=torch.float32, device=g.device)
    partial = None
    if chunk > WARP_CHUNK_MAX:  # the tiled shape's per-tile (min, max)
        partial = torch.empty(2 * n_chunks * _tc.cdiv(chunk, TILE), dtype=torch.float32,
                              device=g.device)
    if n_chunks:
        cuda_quant.minmax(g, e, g.numel(), chunk, n_chunks, ranges, partial)
        LAUNCHES["quant_minmax"] += 1
    return ranges


def encode_plain(g, e, ranges, qmax: int, chunk: int, want_residual: bool):
    blocks = _payload(g, e, chunk)
    n_chunks = blocks.shape[0]
    gmin, gmax = -ranges[:n_chunks], ranges[n_chunks:]
    zp = (gmax + gmin) * 0.5
    half = (gmax - gmin) * 0.5
    # half / qmax as XLA's CPU backend computes a division by a constant:
    # times the f32 reciprocal (the Python float becomes f32 1/qmax)
    scale = torch.where(half > 0, half * (1.0 / qmax), 1.0)
    q = torch.clamp(torch.round((blocks - zp[:, None]) / scale[:, None]),
                    -qmax, qmax).to(torch.int8)
    res = None
    if want_residual:
        own = scale[:, None] * q.to(torch.float32) + zp[:, None]
        res = (blocks - own).reshape(-1)[:g.numel()]
    return q.reshape(-1), scale, zp, res


#: f32's unit roundoff (round to nearest): one rounding moves a result by at
#: most this fraction of its magnitude.
F32_UNIT_ROUNDOFF = 2.0 ** -24


def encode_residual_bound(p, scale, zp, q, chunk: int) -> torch.Tensor:
    """The largest ``|residual|`` the encode's f32 arithmetic allows for
    each element of the payload ``p`` (``n`` f32 values, ``g + e`` as the
    encode rounded it) on the grid ``scale``, ``zp`` (f32 ``(n_chunks,)``)
    with codes ``q`` (int8 over every chunk element), in float64:

        scale/2 + u (1 + 2u) (scale/2 + 2 |p - zp| + 2 scale |q| + |zp|) + 2^-149

    with ``u`` = 2^-24. The encode rounds five times after the payload:
    d = p - zp, t = d / scale (a correctly rounded division), q = rint(t)
    clamped (|q - t| <= 1/2, the clamp included), s = scale * q,
    o = s + zp and r = p - o; adding the five relative errors to the
    exact |p - zp - scale q| <= scale/2 + u|p - zp| + u|d| gives the
    bound, and 2^-149 covers an underflowing product. ``chip_smoke.py``'s
    ``[compress]`` residual gate writes the derivation out step by
    step."""
    n = p.numel()
    sc = scale.double().repeat_interleave(chunk)[:n]
    z = zp.double().repeat_interleave(chunk)[:n]
    pd = p.double()
    qd = q[:n].double().abs()
    u = F32_UNIT_ROUNDOFF
    terms = sc / 2 + 2 * (pd - z).abs() + 2 * sc * qd + z.abs()
    return sc / 2 + u * (1 + 2 * u) * terms + 2.0 ** -149


def encode(g: torch.Tensor, e: torch.Tensor | None, ranges: torch.Tensor, qmax: int, *,
           chunk: int, want_residual: bool = False,
           residual_out: torch.Tensor | None = None):
    """The world grid and codes of ``g (+ e)`` from the world's ``ranges``:
    ``(q, scale, zp, residual)`` — ``q`` int8 over every chunk element
    (``n_chunks · chunk``), ``scale`` and ``zp`` f32 ``(n_chunks,)``, and
    with ``want_residual`` the f32 ``(n,)`` error ``p − (scale·q + zp)``,
    written into ``residual_out`` when one is given (it may be ``e``
    itself: each element is read before it is written)."""
    _check_flat(g, "g")
    n_chunks = _tc.cdiv(g.numel(), chunk)
    for t, name in ((e, "e"), (residual_out, "residual_out")):
        if t is not None:
            _check_flat(t, name, like=g)
            if t.shape != g.shape:
                raise ValueError(f"{name} {tuple(t.shape)} does not match g {tuple(g.shape)}")
    _check_flat(ranges, "ranges", like=g)
    if ranges.numel() != 2 * n_chunks:
        raise ValueError(f"ranges holds {ranges.numel()} values, not 2 x {n_chunks} chunks")
    if not 1 <= qmax <= 127:
        raise ValueError(f"qmax must be in [1, 127], got {qmax}")
    if not _tc.use_kernel(g):
        q, scale, zp, res = encode_plain(g, e, ranges, qmax, chunk, want_residual)
        if res is not None and residual_out is not None:
            residual_out.copy_(res)
            res = residual_out
        return q, scale, zp, res
    dev = g.device
    q = torch.empty(n_chunks * chunk, dtype=torch.int8, device=dev)
    scale = torch.empty(n_chunks, dtype=torch.float32, device=dev)
    zp = torch.empty(n_chunks, dtype=torch.float32, device=dev)
    res = None
    if want_residual:
        res = residual_out if residual_out is not None else torch.empty_like(g)
    if n_chunks:
        cuda_quant.encode(g, e, g.numel(), chunk, n_chunks, ranges, qmax, q, scale, zp, res)
        LAUNCHES["quant_encode"] += 1
        if res is not None and res is residual_out:
            # the kernel wrote the caller's tensor in place, out of torch's
            # sight: advance its version as an in-place op would (autograd's
            # saved-tensor check, the audit's record of state written)
            torch.autograd.graph.increment_version(res)
    return q, scale, zp, res


def decode_plain(sumq, scale, zp, world: int, n: int, mean: bool) -> torch.Tensor:
    n_chunks = scale.numel()
    v = (scale[:, None] * sumq.view(n_chunks, -1).to(torch.float32)
         + world * zp[:, None]).reshape(-1)[:n]
    return v * (1.0 / world) if mean else v


def decode(sumq: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor, *, world: int, n: int,
           chunk: int, mean: bool = False) -> torch.Tensor:
    """``scale·Σq + world·zp`` per chunk (times ``f32(1 / world)`` for the
    mean), the first ``n`` elements, f32."""
    _check_flat(sumq, "sumq", dtype=torch.int8)
    _check_flat(scale, "scale", like=sumq)
    _check_flat(zp, "zp", like=sumq)
    n_chunks = scale.numel()
    if sumq.numel() != n_chunks * chunk or zp.numel() != n_chunks or n > sumq.numel():
        raise ValueError(f"sumq {sumq.numel()}, scale {n_chunks}, zp {zp.numel()} and n {n} "
                         f"do not make chunks of {chunk}")
    if not _tc.use_kernel(sumq):
        return decode_plain(sumq, scale, zp, world, n, mean)
    out = torch.empty(n, dtype=torch.float32, device=sumq.device)
    if n_chunks:
        cuda_quant.decode(sumq, scale, zp, n, chunk, n_chunks, world, mean, out)
        LAUNCHES["quant_decode"] += 1
    return out
