"""Tensor (model) parallelism: Megatron-style sharded linear layers over a
process group — the counterpart of ``tpu_syncbn.parallel.tensor``.

Each function takes a process ``group`` where the JAX package takes an
``axis_name`` (``None`` or :data:`~tpu_syncbn_torch.parallel.collectives.ALONE`
is a world of one). The classic pairing keeps collectives to ONE
all-reduce per block:

* :func:`column_parallel` — weight sharded on the *output* feature dim;
  every rank computes its slice of the activations. No communication in
  the forward.
* :func:`row_parallel` — weight sharded on the *input* feature dim over
  activations that are already feature-sharded (a column-parallel
  output); each rank holds a rank-deficient partial product and one
  all-reduce completes it.

So ``column → nonlinearity → row`` (the Megatron MLP) and
``column-QKV → per-head-group attention → row-out`` (the Megatron
attention) each cost exactly one all-reduce in the forward, counted by
``collectives.tallies()`` as one ``psum``.

Weights come pre-sharded in the JAX layouts: ``(D, H)`` sliced by columns
for the column half, ``(H, D)`` by rows for the row half.

The gradient contract. The JAX functions run inside ``shard_map`` with the
VMA checker, so a replicated operand meeting rank-varying data gets an
implicit ``pvary`` whose transpose is a psum, and the psum of rank-varying
partials transposes to no communication. The port makes both rules
explicit (``collectives.copy_to_group`` and ``reduce_from_group``,
Megatron's *f* and *g*):

* the replicated input ``x`` of :func:`column_parallel` (and of the two
  blocks) passes through *f*: its gradient is the full gradient on every
  rank, one all-reduce in the backward;
* :func:`row_parallel`'s all-reduce is *g*: its backward hands each rank
  the replicated output's cotangent as is;
* sharded weights and biases get their own shard's gradient, the
  replicated bias of :func:`row_parallel` the full one.

A trainer that uses these functions all-reduces such gradients over the
data group only, never again over the model group. The products are plain
``@`` and ``einsum``, as the JAX package computes them outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tpu_syncbn_torch.parallel import collectives
from tpu_syncbn_torch.parallel.sequence import _single_device_attention


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def column_parallel(
    x: torch.Tensor,
    w_shard: torch.Tensor,
    b_shard: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """``y_shard = x @ W[:, shard] + b[shard]``. ``x`` is replicated across
    the group and passes through *f* (the module docstring); the output is
    feature-sharded. Zero collectives in the forward."""
    y = collectives.copy_to_group(x, group) @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel(
    x_shard: torch.Tensor,
    w_shard: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """``y = psum_over_shards(x[shard] @ W[shard, :]) + b``. The input is
    feature-sharded (a column-parallel output); ONE all-reduce completes
    the contraction. The bias is added once, after the reduction."""
    y = collectives.reduce_from_group(x_shard @ w_shard, group)
    if b is not None:
        y = y + b
    return y


def tp_mlp(
    x: torch.Tensor,
    w1_shard: torch.Tensor,
    b1_shard: Optional[torch.Tensor],
    w2_shard: torch.Tensor,
    b2: Optional[torch.Tensor],
    group=None,
    activation: Callable[[torch.Tensor], torch.Tensor] = gelu,
) -> torch.Tensor:
    """The Megatron MLP: column-parallel up-projection, elementwise
    nonlinearity on the local shard, row-parallel down-projection — one
    all-reduce in all. ``w1``: (D, H) sharded on H; ``w2``: (H, D) sharded
    on H (its input dim)."""
    h = activation(column_parallel(x, w1_shard, b1_shard, group))
    return row_parallel(h, w2_shard, b2, group)


def tp_attention(
    x: torch.Tensor,
    wq_shard: torch.Tensor,
    wk_shard: torch.Tensor,
    wv_shard: torch.Tensor,
    wo_shard: torch.Tensor,
    group=None,
    *,
    n_local_heads: int,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Megatron attention: Q/K/V projections column-parallel by head group
    (each rank owns ``n_local_heads`` heads end to end), full softmax
    attention over the local heads (``parallel.sequence``'s single-device
    attention, as the JAX function uses its own), output projection
    row-parallel — one all-reduce in all.

    ``x``: (B, L, D) replicated over the group; ``wq/k/v_shard``:
    (D, n_local_heads·Dh); ``wo_shard``: (n_local_heads·Dh, D)."""
    b, l, _ = x.shape
    hd = wq_shard.shape[-1]
    if hd % n_local_heads:
        raise ValueError(
            f"shard width {hd} not divisible by n_local_heads {n_local_heads}"
        )
    dh = hd // n_local_heads
    xr = collectives.copy_to_group(x, group)  # one f for the three projections

    def heads(w):
        return (xr @ w).reshape(b, l, n_local_heads, dh)

    o = _single_device_attention(
        heads(wq_shard), heads(wk_shard), heads(wv_shard), causal=causal, scale=scale,
    )
    return row_parallel(o.reshape(b, l, hd), wo_shard, None, group)


def shard_columns(w, rank: int, world: int):
    """Rank ``rank``'s block of ``w``'s last dim (a column-parallel weight
    or bias, the JAX spec ``P(None, 'model')`` / ``P('model')``)."""
    n = w.shape[-1] // world
    return w[..., rank * n:(rank + 1) * n]


def shard_rows(w, rank: int, world: int):
    """Rank ``rank``'s block of ``w``'s first dim (a row-parallel weight,
    the JAX spec ``P('model', None)``; also an expert shard of an
    ``(E, D, H)`` stack)."""
    n = w.shape[0] // world
    return w[rank * n:(rank + 1) * n]
