"""Sequence/context parallelism across ranks — the counterpart of
``tpu_syncbn.parallel.sequence``: ring attention, the zigzag ring and
Ulysses all-to-all attention.

Each function takes a process ``group`` where the JAX package takes an
``axis_name``; ``None`` and :data:`~tpu_syncbn_torch.parallel.collectives.ALONE`
are a world of one, where every function is JAX's world-1 case (the dense
attention, or Ulysses' local attention).

* :func:`ring_attention` — exact blockwise attention for a sequence
  sharded across the group: (K, V) blocks rotate around the ring
  (:func:`~tpu_syncbn_torch.parallel.collectives.ppermute`) while each rank
  accumulates its queries' output with an online softmax, so no rank holds
  the whole sequence.
* :func:`ring_attention_zigzag` — the causal ring over the zigzag layout
  (rank ``i`` holds global chunks ``i`` and ``2n-1-i``): two live chunk
  attends a hop on every rank, so causal work stays balanced.
* :func:`ulysses_attention` — two tiled all-to-alls trade the sequence
  sharding for a head sharding, full attention runs on the whole sequence
  for this rank's heads (dense, or the flash kernels), and one more trades
  the output back.

All are exact: output and gradients equal single-device attention on the
gathered sequence, up to rounding. The arguments are this rank's *local*
shard ``(batch, seq_local, heads, head_dim)``; :func:`sharded_self_attention`
takes the global tensors. Everything is differentiable: autograd runs
through ``ppermute`` and ``all_to_all``, whose backward sends the
cotangents back the way the values came. The blockwise online softmax is
plain PyTorch, as the JAX package computes it in XLA outside any kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tpu_syncbn_torch.parallel import collectives

# finite stand-in for -inf in masked logits (-0.7 * float32 max): keeps an
# online-softmax running max finite when a whole KV block is masked out
_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


def _qk_scale(head_dim: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else head_dim ** -0.5


def _single_device_attention(q, k, v, *, causal: bool, scale: Optional[float]):
    """Plain full-softmax attention over ``(B, L, H, D)`` in float32 (the
    score matrix is materialized), returned in q's dtype: the world-1 path
    and the tests' oracle."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bqhk", q.float() * _qk_scale(d, scale), k.float())
    if causal:
        l_q, l_k = q.shape[1], k.shape[1]
        allowed = (torch.arange(l_q, device=q.device)[:, None]
                   >= torch.arange(l_k, device=q.device)[None, :])
        s = torch.where(allowed[None, :, None, :], s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _block_attend(q, k, v, bias, o, l, m):
    """One online-softmax accumulation step over a KV block.

    ``q``: (B, Lq, H, D) float32, pre-scaled; ``k``/``v``: (B, Lk, H, D);
    ``bias``: additive mask broadcast to (B, Lq, H, Lk), 0 or ``_NEG_BIG``;
    carries ``o`` (B, Lq, H, D), ``l`` and ``m`` (B, Lq, H), float32."""
    s = torch.einsum("bqhd,bkhd->bqhk", q, k.float()) + bias
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, v.float())
    return o_new, l_new, m_new


def _fresh_state(b: int, rows: int, h: int, d: int, device):
    """The online softmax's (o, l, m) before any block."""
    return (torch.zeros(b, rows, h, d, device=device),
            torch.zeros(b, rows, h, device=device),
            torch.full((b, rows, h), _NEG_BIG, device=device))


def _finish(o, l):
    # causal attention sees at least the query itself, so l > 0; the guard
    # is for rows a mask left empty
    return o / l.clamp_min(1e-30)[..., None]


def _ring_perm(n: int) -> list:
    return [(i, (i + 1) % n) for i in range(n)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   *, causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence sharded across ``group``.

    ``q``/``k``/``v`` are this rank's contiguous block ``(B, L_local, H,
    D)``: rank ``i`` holds global positions ``[i·L_local, (i+1)·L_local)``.
    Returns the local block of the output, q's shape and dtype.

    The own block first, then exactly N − 1 hops: each ``ppermute``s the
    stacked (K, V) block one rank on, and this rank folds the block that
    started on rank ``(me - s) mod N`` into its online-softmax state.
    Causal masking uses global positions (``q_pos = rank·L_local + i``),
    so the result is the full sequence's causal attention."""
    n = collectives.world_size(group)
    if n == 1:
        return _single_device_attention(q, k, v, causal=causal, scale=scale)
    me = collectives.axis_index(group)
    b, l_q, h, d = q.shape
    l_k = k.shape[1]
    qf = q.float() * _qk_scale(d, scale)
    q_pos = me * l_q + torch.arange(l_q, device=q.device)

    def bias_for(src: int) -> torch.Tensor:
        """Additive mask for the KV block that started on rank ``src``."""
        if not causal:
            return torch.zeros(1, 1, 1, l_k, device=q.device)
        k_pos = src * l_k + torch.arange(l_k, device=q.device)
        allowed = q_pos[:, None] >= k_pos[None, :]
        return torch.where(allowed, 0.0, _NEG_BIG)[None, :, None, :]

    o, l, m = _block_attend(qf, k, v, bias_for(me), *_fresh_state(b, l_q, h, d, q.device))
    kv = torch.stack((k, v))
    for s in range(1, n):
        kv = collectives.ppermute(kv, _ring_perm(n), group)
        o, l, m = _block_attend(qf, kv[0], kv[1], bias_for((me - s) % n), o, l, m)
    return _finish(o, l).to(q.dtype)


def zigzag_chunk_permutation(n_shards: int) -> list:
    """Chunk order of the zigzag layout: the global sequence is cut into
    ``2n`` chunks and rank ``i`` holds chunks ``(i, 2n-1-i)`` — one early,
    one late — so causal work is balanced around the ring."""
    return [c for i in range(n_shards) for c in (i, 2 * n_shards - 1 - i)]


def zigzag_shard(x: torch.Tensor, n_shards: int, axis: int = 1) -> torch.Tensor:
    """Reorder a *global* sequence axis into the zigzag layout, so that
    contiguous blocks put chunk pair ``(i, 2n-1-i)`` on rank ``i``. The
    length must divide by ``2·n_shards``. Inverse: :func:`zigzag_unshard`."""
    length = x.shape[axis]
    if length % (2 * n_shards):
        raise ValueError(f"sequence length {length} must divide by 2*n_shards "
                         f"({2 * n_shards})")
    chunks = x.chunk(2 * n_shards, axis)
    return torch.cat([chunks[c] for c in zigzag_chunk_permutation(n_shards)], axis)


def zigzag_unshard(x: torch.Tensor, n_shards: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard`."""
    perm = zigzag_chunk_permutation(n_shards)
    inverse = [0] * len(perm)
    for pos, c in enumerate(perm):
        inverse[c] = pos
    chunks = x.chunk(2 * n_shards, axis)
    return torch.cat([chunks[p] for p in inverse], axis)


def ring_attention_zigzag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          group=None, *, scale: Optional[float] = None) -> torch.Tensor:
    """Causal ring attention over the **zigzag** layout: this rank's block
    is ``concat(chunk_e, chunk_l)`` with ``e = me`` and ``l = 2n-1-me`` of
    the ``2n`` global chunks (make it with :func:`zigzag_shard` and
    contiguous blocks). Output in the same layout; masking follows the
    original positions.

    The self block attends e×e and l×l causally and l×e fully. Each of the
    N − 1 hops then does exactly two chunk attends, both unmasked: the late
    queries against the incoming early chunk, and either ``q_e × kv_e``
    (the block started earlier on the ring) or ``q_l × kv_l`` (later) —
    the same shapes either way, as JAX selects them with ``jnp.where``."""
    n = collectives.world_size(group)
    if n == 1:
        return _single_device_attention(q, k, v, causal=True, scale=scale)
    me = collectives.axis_index(group)
    b, l_local, h, d = q.shape
    if l_local % 2:
        raise ValueError(f"zigzag local length must be even (chunk pair), got {l_local}")
    c = l_local // 2
    qf = q.float() * _qk_scale(d, scale)
    q_e, q_l = qf[:, :c], qf[:, c:]
    pos = torch.arange(c, device=q.device)
    # in-chunk causal diagonal: a chunk's global positions are consecutive
    tri = torch.where(pos[:, None] >= pos[None, :], 0.0, _NEG_BIG)[None, :, None, :]
    zero_bias = torch.zeros(1, 1, 1, c, device=q.device)

    e_state = _block_attend(q_e, k[:, :c], v[:, :c], tri, *_fresh_state(b, c, h, d, q.device))
    l_state = _block_attend(q_l, k[:, :c], v[:, :c], zero_bias,
                            *_fresh_state(b, c, h, d, q.device))
    l_state = _block_attend(q_l, k[:, c:], v[:, c:], tri, *l_state)
    kv = torch.stack((k, v))
    for s in range(1, n):
        kv = collectives.ppermute(kv, _ring_perm(n), group)
        k_in, v_in = kv[0], kv[1]
        l_state = _block_attend(q_l, k_in[:, :c], v_in[:, :c], zero_bias, *l_state)
        if (me - s) % n < me:  # the block rode from earlier on the ring
            e_state = _block_attend(q_e, k_in[:, :c], v_in[:, :c], zero_bias, *e_state)
        else:
            l_state = _block_attend(q_l, k_in[:, c:], v_in[:, c:], zero_bias, *l_state)
    out = torch.cat([_finish(e_state[0], e_state[1]), _finish(l_state[0], l_state[1])], 1)
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                      *, causal: bool = False, scale: Optional[float] = None,
                      local_impl: Optional[str] = None,
                      local_backward: str = "xla") -> torch.Tensor:
    """Sequence parallelism by head redistribution (DeepSpeed-Ulysses).

    Local blocks ``(B, L_local, H, D)``; ``H`` must divide by the group's
    size. A tiled all-to-all turns each of q, k, v into (full sequence ×
    ``H/N`` heads), full attention runs on it, and another turns the output
    back to the sequence sharding. Exact: heads are independent.

    ``local_impl``: None (the dense attention, score matrix materialized)
    or ``"flash"`` (``ops.cuda_attention.flash_attention``: on a CUDA
    tensor the hand-written kernels, which never materialize the scores).
    ``local_backward`` is the flash backward: ``"xla"`` (the blockwise
    scan) or ``"pallas"`` (the dK/dV and dQ kernels)."""
    if local_impl not in (None, "flash"):
        raise ValueError(f"local_impl must be None or 'flash', got {local_impl!r}")
    if local_impl is None and local_backward != "xla":
        raise ValueError("local_backward applies to local_impl='flash' only")
    if local_impl == "flash":
        # imported here: ops.cuda_attention imports this module's constants
        from tpu_syncbn_torch.ops.cuda_attention import flash_attention

        local_attn = functools.partial(flash_attention, causal=causal, scale=scale,
                                       backward=local_backward)
    else:
        local_attn = functools.partial(_single_device_attention, causal=causal,
                                       scale=scale)
    n = collectives.world_size(group)
    if n == 1:
        return local_attn(q, k, v)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads ({h}) must be divisible by axis size ({n})")

    def to_heads(x):  # (B, L/n, H, D) -> (B, L, H/n, D); the kernels read 16-byte strides
        return collectives.all_to_all(x, group, split_axis=2, concat_axis=1).contiguous()

    oh = local_attn(to_heads(q), to_heads(k), to_heads(v))
    return collectives.all_to_all(oh, group, split_axis=1, concat_axis=2)


def _gather_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block of axis 1, in rank order: an all-gather of the
    bytes, so any dtype arrives bit for bit."""
    x = x.contiguous()
    got = collectives.all_gather(x.view(torch.uint8), group, axis=1, tiled=True)
    return got.view(x.dtype)


def _my_block(x: torch.Tensor, group) -> torch.Tensor:
    n, me = collectives.world_size(group), collectives.axis_index(group)
    size = x.shape[1] // n
    return x.narrow(1, me * size, size).contiguous()


class _Shard(torch.autograd.Function):
    """This rank's contiguous block of axis 1 of a tensor every rank holds
    whole. Its backward all-gathers the blocks' cotangents, so every rank
    gets the whole gradient, as the JAX wrapper's global array does."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _my_block(x, group).clone()

    @staticmethod
    def backward(ctx, grad):
        return _gather_blocks(grad, ctx.group), None


class _Unshard(torch.autograd.Function):
    """The blocks of every rank along axis 1, on every rank; the backward
    keeps this rank's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_blocks(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _my_block(grad, ctx.group), None


SHARDED_IMPLS = ("ring", "ulysses")


def sharded_self_attention(group, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = False, scale: Optional[float] = None,
                           impl: str = "ring", local_impl: Optional[str] = None,
                           local_backward: str = "xla") -> torch.Tensor:
    """Tensor-level wrapper: every rank holds the global ``(B, L, H, D)``
    tensors; each takes its contiguous block of L (``"ring_zigzag"``: its
    zigzag chunk pair), runs ring, zigzag-ring or Ulysses attention
    (``impl``) across ``group``, and the blocks are all-gathered back into
    position order, so every rank returns the whole output.
    Differentiable: the gradient of each global input is whole on every
    rank. ``"ring_zigzag"`` is causal only; ``local_impl`` and
    ``local_backward`` apply to Ulysses only."""
    n = collectives.world_size(group)
    if impl == "ring_zigzag":
        if not causal:
            raise ValueError(
                "ring_zigzag is the causal load-balanced layout; use "
                "impl='ring' for non-causal attention (every block is "
                "live there, so zigzag has nothing to skip)")
        if local_impl is not None:
            raise ValueError("local_impl applies to impl='ulysses' only")
        if local_backward != "xla":
            raise ValueError(f"local_backward applies to impl='ulysses' only, got "
                             f"impl={impl!r}")
        fn = functools.partial(ring_attention_zigzag, group=group, scale=scale)
        q, k, v = (zigzag_shard(x, n) for x in (q, k, v))
    else:
        if impl not in SHARDED_IMPLS:
            raise ValueError(f"impl must be one of {list(SHARDED_IMPLS) + ['ring_zigzag']}, "
                             f"got {impl!r}")
        kw = dict(group=group, causal=causal, scale=scale)
        if impl == "ulysses":
            kw.update(local_impl=local_impl, local_backward=local_backward)
        elif local_impl is not None:
            raise ValueError(f"local_impl applies to impl='ulysses' only, got impl={impl!r}")
        elif local_backward != "xla":
            raise ValueError(f"local_backward applies to impl='ulysses' only, got "
                             f"impl={impl!r}")
        fn = functools.partial(ring_attention if impl == "ring" else ulysses_attention, **kw)
    if n == 1:
        return fn(q, k, v)
    length = q.shape[1]
    if length % n:
        raise ValueError(f"sequence length {length} must divide by the group size {n}")
    out = _Unshard.apply(fn(*(_Shard.apply(x, group) for x in (q, k, v))), group)
    return zigzag_unshard(out, n) if impl == "ring_zigzag" else out
