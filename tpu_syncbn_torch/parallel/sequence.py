"""Sequence parallelism, world-1 subset — the counterpart of
``tpu_syncbn.parallel.sequence``.

Ported so far: the dense single-device attention (the transformer LM's
default attention and the tests' oracle) and the constants it shares with
the flash kernels. Ring, zigzag-ring and Ulysses attention exchange
sequence shards between devices and wait for the multi-GPU slice of the
port; at one device each of them is this dense attention (or, for Ulysses
with ``local_impl="flash"``, the flash kernel), which is how the port's
training script runs them.
"""

from __future__ import annotations

from typing import Optional

import torch

# finite stand-in for -inf in masked logits (-0.7 * float32 max): keeps an
# online-softmax running max finite when a whole KV block is masked out
_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


def _qk_scale(head_dim: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else head_dim ** -0.5


def _single_device_attention(q, k, v, *, causal: bool, scale: Optional[float]):
    """Plain full-softmax attention over ``(B, L, H, D)`` in float32 (the
    score matrix is materialized), returned in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bqhk", q.float() * _qk_scale(d, scale), k.float())
    if causal:
        l_q, l_k = q.shape[1], k.shape[1]
        allowed = (torch.arange(l_q, device=q.device)[:, None]
                   >= torch.arange(l_k, device=q.device)[None, :])
        s = torch.where(allowed[None, :, None, :], s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v.float()).to(q.dtype)
