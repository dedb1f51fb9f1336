"""Causal transformer LM — the counterpart of
``tpu_syncbn.models.transformer``.

Pre-RMSNorm blocks (eps 1e-6, in float32), learned positions, a fused QKV
projection without biases, a tanh-GELU MLP and an output head tied to the
embedding. The parameters carry the JAX pytree's names, shapes and
layouts (``embed``, ``pos``, ``blocks.wqkv`` of shape (n_layers, d, 3d) in
``x @ W`` order, ...), so :func:`~tpu_syncbn_torch.models.weights.load_jax_transformer_params`
copies a JAX parameter tree in without a transpose. A Python loop over
the layer axis takes the place of ``lax.scan``.

Attention (``attn_impl``) is the dense single-device attention (None), the
fused flash kernels over the whole sequence (``"flash"``: kernel forward,
blockwise-scan backward; ``"flash_pallas_bwd"``: the forward and both
backward kernels), or, with a process ``group`` across which the sequence
is sharded, ring (``"ring"``) or Ulysses (``"ulysses"``, with
``local_impl``/``local_backward``) attention — the JAX model's
``axis_name``. Attention is the only cross-rank operation: under a group
of n ranks each holds its contiguous chunk of every sequence, and the
positions default to ``rank·L_local`` on.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tpu_syncbn_torch.ops.cuda_attention import flash_attention
from tpu_syncbn_torch.parallel import collectives
from tpu_syncbn_torch.parallel.sequence import (
    _single_device_attention,
    ring_attention,
    ulysses_attention,
)
from tpu_syncbn_torch.runtime.distributed import resolve_device

ATTN_IMPLS = (None, "flash", "flash_pallas_bwd", "ring", "ulysses")


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm computed in float32, returned in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return (y * scale).to(x.dtype)


def _check_impl(impl: Optional[str], group, local_impl: Optional[str],
                local_backward: str) -> None:
    """The JAX model's argument checks (``transformer_lm`` and
    ``_attend``), made before the first layer."""
    if impl == "ring_zigzag":
        raise ValueError(
            "ring_zigzag is not supported at the LM layer: it requires the "
            "token stream, position embeddings, and next-token labels to "
            "all use the zigzag chunk order, which the LM's contiguous "
            "pos_offset plumbing does not provide. Use "
            "parallel.sequence.ring_attention_zigzag / "
            "sharded_self_attention(impl='ring_zigzag') at the attention "
            "level, or attn_impl='ring' here.")
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if (local_impl is not None or local_backward != "xla") \
            and (impl != "ulysses" or group is None):
        # anything but sharded Ulysses would silently drop the kernel asked for
        raise ValueError(
            "local_impl/local_backward apply to attn_impl='ulysses' with a "
            f"group only, got attn_impl={impl!r}, group={group!r}")
    if impl in ("flash", "flash_pallas_bwd") and group is not None:
        raise ValueError(
            f"attn_impl={impl!r} is the dense single-device kernel; it would "
            "silently attend only the local shard under a sequence-sharded "
            "group. Use attn_impl='ring'/'ulysses' with the group, or "
            f"{impl!r} with group=None.")


def _attend(q, k, v, impl: Optional[str], group, local_impl: Optional[str],
            local_backward: str):
    if impl in ("flash", "flash_pallas_bwd"):
        backward = "pallas" if impl == "flash_pallas_bwd" else "xla"
        return flash_attention(q, k, v, causal=True, backward=backward)
    if impl is None or group is None:
        return _single_device_attention(q, k, v, causal=True, scale=None)
    if impl == "ring":
        return ring_attention(q, k, v, group, causal=True)
    return ulysses_attention(q, k, v, group, causal=True, local_impl=local_impl,
                             local_backward=local_backward)


def _block(x: torch.Tensor, blk, i: int, *, n_heads: int, attn_impl: Optional[str],
           group, local_impl: Optional[str], local_backward: str) -> torch.Tensor:
    """Layer ``i`` of the stacked block parameters ``blk`` (anything with
    the ``_Blocks`` attributes, each indexed by layer) on ``x`` (B, L,
    d_model): the JAX model's inner ``block``. Pre-RMSNorm attention and
    MLP, each added back to the residual stream."""
    b, l, d_model = x.shape
    dh = d_model // n_heads
    h = _rms_norm(x, blk.ln1_scale[i])
    q, k, v = (t.reshape(b, l, n_heads, dh) for t in (h @ blk.wqkv[i]).split(d_model, -1))
    o = _attend(q, k, v, attn_impl, group, local_impl, local_backward)
    x = x + o.reshape(b, l, d_model) @ blk.wo[i]
    h = _rms_norm(x, blk.ln2_scale[i])
    return x + F.gelu(h @ blk.w1[i], approximate="tanh") @ blk.w2[i]


class _Blocks(nn.Module):
    """The stacked per-layer parameters (the JAX tree's ``blocks``)."""

    def __init__(self, n_layers, d_model, d_ff, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1_scale = nn.Parameter(torch.ones(n_layers, d_model, **kw))
        self.ln2_scale = nn.Parameter(torch.ones(n_layers, d_model, **kw))
        self.wqkv = nn.Parameter(torch.empty(n_layers, d_model, 3 * d_model, **kw))
        self.wo = nn.Parameter(torch.empty(n_layers, d_model, d_model, **kw))
        self.w1 = nn.Parameter(torch.empty(n_layers, d_model, d_ff, **kw))
        self.w2 = nn.Parameter(torch.empty(n_layers, d_ff, d_model, **kw))


class TransformerLM(nn.Module):
    """Causal LM: ``tokens`` (B, L) integer → logits (B, L, vocab) float32.

    Parameters are left uninitialized: build one with
    :func:`init_transformer_lm`, or fill it with
    ``load_jax_transformer_params``. ``device`` defaults to the card and
    raises without one."""

    def __init__(self, *, vocab: int, d_model: int, n_heads: int, n_layers: int,
                 d_ff: int, max_len: int, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = "cuda"):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} % n_heads {n_heads} != 0")
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.embed = nn.Parameter(torch.empty(vocab, d_model, **kw))
        self.pos = nn.Parameter(torch.empty(max_len, d_model, **kw))
        self.blocks = _Blocks(n_layers, d_model, d_ff, dtype, device)
        self.ln_f_scale = nn.Parameter(torch.ones(d_model, **kw))

    def forward(self, tokens: torch.Tensor, attn_impl: Optional[str] = None,
                local_impl: Optional[str] = None, local_backward: str = "xla",
                group=None, pos_offset: Optional[int] = None) -> torch.Tensor:
        """``tokens`` (B, L): the whole sequence, or with ``group`` this
        rank's contiguous chunk of it; ``pos_offset`` (default ``rank·L``)
        is the chunk's first global position."""
        _check_impl(attn_impl, group, local_impl, local_backward)
        b, l = tokens.shape
        max_len = self.pos.shape[0]
        if pos_offset is None:
            n = collectives.world_size(group)
            if n * l > max_len:
                # JAX's dynamic_slice would clamp and silently reuse positions
                raise ValueError(f"global sequence {n * l} exceeds max_len {max_len}")
            pos_offset = collectives.axis_index(group) * l
        elif not 0 <= pos_offset <= max_len - l:
            raise ValueError(f"positions [{pos_offset}, {pos_offset + l}) exceed "
                             f"max_len {max_len}")
        x = self.embed[tokens] + self.pos[pos_offset:pos_offset + l]
        for i in range(self.n_layers):
            x = _block(x, self.blocks, i, n_heads=self.n_heads, attn_impl=attn_impl,
                       group=group, local_impl=local_impl,
                       local_backward=local_backward)
        x = _rms_norm(x, self.ln_f_scale)
        return (x @ self.embed.T).float()


def init_transformer_lm(generator: Union[int, torch.Generator, None] = 0, *,
                        vocab: int, d_model: int, n_heads: int, n_layers: int,
                        d_ff: int, max_len: int,
                        dtype: torch.dtype = torch.float32,
                        device: Union[str, torch.device, None] = "cuda"
                        ) -> TransformerLM:
    """A :class:`TransformerLM` with the JAX initializer's distributions:
    each matrix normal × fan_in^-½, embedding and positions normal × 0.02,
    RMSNorm scales 1. ``generator`` is a seed or a CPU ``torch.Generator``
    (the numbers differ from ``jax.random``'s for the same seed)."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator or 0))
    model = TransformerLM(vocab=vocab, d_model=d_model, n_heads=n_heads,
                          n_layers=n_layers, d_ff=d_ff, max_len=max_len,
                          dtype=dtype, device=device)

    def dense(p: torch.Tensor, scale: Optional[float] = None) -> None:
        fan_in = p.shape[-2]
        x = torch.randn(p.shape, generator=generator)
        p.copy_(x * (scale if scale is not None else fan_in ** -0.5))

    with torch.no_grad():
        dense(model.embed, 0.02)
        dense(model.pos, 0.02)
        for p in (model.blocks.wqkv, model.blocks.wo, model.blocks.w1,
                  model.blocks.w2):
            dense(p)
    return model
