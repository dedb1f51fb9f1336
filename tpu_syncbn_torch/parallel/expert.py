"""Expert parallelism: Switch-style mixture-of-experts over a process group —
the counterpart of ``tpu_syncbn.parallel.expert``.

Each function takes a process ``group`` where the JAX package takes an
``axis_name`` (``None`` or :data:`~tpu_syncbn_torch.parallel.collectives.ALONE`
is a world of one). The shape:

* tokens are sharded across the group (data-parallel style);
* expert weights are sharded across the SAME group — rank ``i`` owns
  experts ``[i·E_loc, (i+1)·E_loc)`` (the JAX layout ``(E, D, H)`` sliced
  ``E_loc`` a rank) and only ever materializes those;
* routing is top-1 (Switch) with a per-(expert, source-rank) capacity;
  dispatch/combine are one-hot einsums (static shapes, no gather/scatter);
* two untiled ``all_to_all``s move token slots to their expert's rank and
  back — O(capacity) traffic per rank.

Exactness contract: :func:`expert_parallel_moe` over N ranks equals
:func:`dense_moe` (full weights, zero collectives) applied per shard — the
all_to_alls relocate compute without changing it.

The gradient contract (JAX's transpose rules under ``shard_map``, made
explicit as in :mod:`~tpu_syncbn_torch.parallel.tensor`): the replicated
``router_w`` passes through ``collectives.copy_to_group`` (Megatron's *f*),
so its gradient is the full gradient on every rank; the final ``pmean`` of
``aux`` is ``collectives.mean_from_group``, whose backward divides the
cotangent by the world size with no communication; the expert shards'
gradients come back through the ``all_to_all``'s backward to their owner.
A trainer all-reduces such gradients over the data group only, never again
over the expert group. The products are plain ``einsum``, as the JAX
package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from tpu_syncbn_torch.parallel import collectives


def switch_route(x: torch.Tensor, router_w: torch.Tensor, capacity: int):
    """Top-1 routing with capacity. ``x``: (T, D); ``router_w``: (D, E).

    Returns ``(dispatch, combine, aux)``:
      dispatch (T, E, C) 0/1 — token t occupies slot c of expert e;
      combine  (T, E, C) f32 — dispatch scaled by the router probability
      (the Switch estimator: the router gets gradients through it);
      aux — the Switch load-balance loss ``E * Σ_e fraction_e · mean_prob_e``
      over these tokens.

    Tokens beyond an expert's capacity are dropped (their combine row is
    zero). Slot assignment is by token order, and the chosen expert is the
    first maximum, as ``jnp.argmax`` picks it."""
    e = router_w.shape[-1]
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    idx = torch.argmax(probs, dim=-1)  # (T,), the first maximum
    # jax.nn.one_hot's comparison: F.one_hot reads idx's range on the host
    onehot = (idx[:, None] == torch.arange(e, device=x.device)).float()  # (T, E)
    # rank of each token within its expert's queue (>= 0 at the chosen
    # expert since the cumsum includes the token itself; -1 elsewhere)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    rank = pos.amax(dim=-1).long()  # (T,)
    # all-zeros for rank >= capacity (jax.nn.one_hot's rule): over-capacity
    # tokens drop out of dispatch with no separate mask
    slot = (rank[:, None] == torch.arange(capacity, device=x.device)).float()
    dispatch = onehot[:, :, None] * slot[:, None, :]  # (T, E, C)
    gate = torch.gather(probs, -1, idx[:, None])  # (T, 1)
    combine = dispatch * gate[:, :, None]
    fraction = onehot.mean(dim=0)  # tokens routed to each expert
    mean_prob = probs.mean(dim=0)
    aux = e * torch.sum(fraction * mean_prob)
    return dispatch, combine, aux


def _expert_mlp(inputs: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor):
    """Batched per-expert 2-layer ReLU MLP: (E, C, D) @ (E, D, H) @ (E, H, D)."""
    h = torch.relu(torch.einsum("ecd,edh->ech", inputs, w_in))
    return torch.einsum("ech,ehd->ecd", h, w_out)


def _capacity(t: int, e: int, capacity_factor: float) -> int:
    return max(1, int(-(-t * capacity_factor // e)))  # ceil


def dense_moe(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
              w_out: torch.Tensor, *, capacity_factor: float = 1.25):
    """Single-device MoE: full expert weights, zero collectives. The world-1
    path and the exactness oracle for the expert-parallel version. Returns
    ``(y, aux)`` with ``y`` shaped like ``x``."""
    t = x.shape[0]
    e = router_w.shape[-1]
    c = _capacity(t, e, capacity_factor)
    dispatch, combine, aux = switch_route(x, router_w, c)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x.float())
    expert_out = _expert_mlp(expert_in, w_in, w_out)
    y = torch.einsum("tec,ecd->td", combine, expert_out)
    return y.to(x.dtype), aux


def expert_parallel_moe(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
                        w_out: torch.Tensor, group=None, *,
                        capacity_factor: float = 1.25):
    """Shard-level expert-parallel MoE.

    ``x``: this rank's tokens (T_local, D); ``router_w``: replicated
    (D, E_total); ``w_in``/``w_out``: this rank's expert shard
    (E_local, D, H) / (E_local, H, D) with ``E_total = E_local · world``.

    Flow: route locally against all experts → dispatch into per-expert
    capacity slots → ``all_to_all`` sends each expert's slots to its
    owning rank → batched expert MLP over the local experts → inverse
    ``all_to_all`` → combine. Per-source capacity makes the result exactly
    :func:`dense_moe` per shard. Returns ``(y_local, aux)`` with aux
    averaged across the group (the module docstring's gradient contract)."""
    n = collectives.world_size(group)
    t, d = x.shape
    e_local = w_in.shape[0]
    e = router_w.shape[-1]
    if e != e_local * n:
        raise ValueError(
            f"router has {e} experts but shard has {e_local} × world {n}"
        )
    c = _capacity(t, e, capacity_factor)
    dispatch, combine, aux = switch_route(
        x, collectives.copy_to_group(router_w, group), c)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x.float())

    if n == 1:
        expert_out = _expert_mlp(expert_in, w_in, w_out)
    else:
        # (E, C, D) -> (world, E_local, C, D): send slots to expert owners;
        # received leading axis = source rank
        grouped = expert_in.reshape(n, e_local, c, d)
        inbound = collectives.all_to_all(grouped, group, split_axis=0,
                                         concat_axis=0, tiled=False)
        flat_in = inbound.movedim(0, 1).reshape(e_local, n * c, d)
        flat_out = _expert_mlp(flat_in, w_in, w_out)
        outbound = flat_out.reshape(e_local, n, c, d).movedim(1, 0)
        returned = collectives.all_to_all(outbound, group, split_axis=0,
                                          concat_axis=0, tiled=False)
        expert_out = returned.reshape(e, c, d)

    y = torch.einsum("tec,ecd->td", combine, expert_out)
    return y.to(x.dtype), collectives.mean_from_group(aux, group)
