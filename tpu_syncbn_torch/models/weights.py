"""Weight transfer from the JAX models' parameters.

``load_jax_params(model, params)`` fills a port model (the ResNets, the
GAN's generator and discriminators, RetinaNet) from a flat mapping of
dotted names to numpy arrays, as the JAX package's
``compat.nnx_to_pure_dict(nnx.state(model))`` yields them once flattened
(``"stem_conv.kernel"``, ``"stages.0.0.bn1.running_var"``, ...). The port
names its submodules like the JAX model, so the mapping is by name:

* conv ``kernel`` (HWIO) → ``weight`` (OIHW, written channels_last);
* transposed-conv ``kernel`` (HWIO, of ``nnx.ConvTranspose``) → the
  ``F.conv_transpose2d`` layout (in, out, kh, kw), flipped on both spatial
  axes (``models/gan.py``'s docstring): same shape as a wrong transpose,
  so the converter asks the target module's kind;
* fc ``kernel`` (in, out) → ``weight`` (out, in); ``bias`` as is;
* BN ``weight``/``bias``/``running_mean``/``running_var``/
  ``num_batches_tracked`` and SNConv's ``u`` keep their names;
* RetinaNet's ``anchors`` are not loaded: the port builds them at
  construction, and the converter checks them equal.

``load_jax_transformer_params(model, params)`` fills a port
``TransformerLM`` from the JAX LM's parameter pytree (nested dicts of
arrays, ``init_transformer_lm``'s output), name for name and with no
transpose: both keep matrices in ``x @ W`` (in, out) order.

``load_jax_trainer_state(trainer, state)`` carries a whole JAX
``DataParallel.state_dict()`` (as the JAX checkpoint stores it: nested
dicts of numpy arrays, the optax state as its named tuples) into a port
``DataParallel``: parameters and BN buffers as above, optax's momentum
``trace`` into SGD's ``momentum_buffer``, the schedule's ``count`` into the
trainer's scheduler, the divergence guard's state, and the error-feedback
residual (this rank's row of it); from a JAX ``zero=True`` or
``SpecLayout.fsdp`` trainer too, whose trace and residual are padded flat
vectors in ``jax.tree_util`` order (into a port trainer sharded or not).

``load_jax_gan_trainer_state(trainer, state)`` carries a JAX
``GANTrainer.state_dict()`` into the port's ``GANTrainer``: both networks'
parameters and buffers (BN statistics, SNConv's ``u``), both optax Adam
states into ``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``/``step``,
and ``step_count``.

No JAX import: the arrays arrive as numpy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _port_name(key: str, value, model: nn.Module | None = None) -> tuple[str, np.ndarray]:
    """The port's name for the JAX value at ``key``, and the value in the
    port's layout: kernels transposed, and a transposed conv's also
    flipped, which needs the ``model`` that owns it (without one, every
    4-D kernel is a conv's)."""
    from tpu_syncbn_torch.models.gan import ConvTranspose

    arr = np.asarray(value)
    if not key.endswith(".kernel"):
        return key, arr
    owner = key[: -len(".kernel")]
    if arr.ndim == 4 and model is not None \
            and isinstance(model.get_submodule(owner), ConvTranspose):
        arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]  # -> (in, out, kh, kw)
    elif arr.ndim == 4:    # conv: HWIO -> OIHW
        arr = arr.transpose(3, 2, 0, 1)
    elif arr.ndim == 2:    # linear: (in, out) -> (out, in)
        arr = arr.T
    else:
        raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
    return owner + ".weight", arr


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray]) -> None:
    """Copy ``params`` into ``model`` in place (values cast to each target's
    dtype and device). Raises if a name of either side has no partner, and
    if RetinaNet's ``anchors`` differ from the port's (they are compared,
    not copied)."""
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    seen = set()
    for key, value in params.items():
        name, arr = _port_name(key, value, model)
        if name not in targets:
            raise KeyError(f"{key}: the port model has no {name!r}")
        t = targets[name]
        if name == "anchors":
            if not np.array_equal(t.detach().cpu().numpy(), arr):
                raise ValueError(
                    "anchors: the JAX model's differ from the port's (another "
                    f"image size? JAX {arr.shape}, port {tuple(t.shape)})")
            seen.add(name)
            continue
        if tuple(t.shape) != arr.shape:
            raise ValueError(
                f"{key}: shape {arr.shape} does not match {name} "
                f"{tuple(t.shape)}"
            )
        with torch.no_grad():
            # np.array copies into a writable C-ordered array (0-d stays 0-d)
            t.copy_(torch.from_numpy(np.array(arr, order="C")).to(t.dtype))
        seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"no JAX value for {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def load_jax_transformer_params(model: nn.Module, params: Mapping) -> None:
    """Copy the JAX LM's nested parameter tree into ``model`` in place
    (values cast to each parameter's dtype and device). Raises if a name
    of either side has no partner or a shape differs."""
    flat = _flatten(params)
    targets = dict(model.named_parameters())
    extra = sorted(set(flat) - set(targets))
    missing = sorted(set(targets) - set(flat))
    if extra or missing:
        raise KeyError(f"unpaired names: JAX only {extra}, port only {missing}")
    for name, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        t = targets[name]
        if tuple(t.shape) != arr.shape:
            raise ValueError(f"{name}: shape {arr.shape} does not match "
                             f"{tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(arr, order="C")).to(t.dtype))


def _named_tuples(tree) -> list:
    """Every named tuple in a nest of tuples, lists and dicts, in order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [tree] + [n for v in tree for n in _named_tuples(v)]
    if isinstance(tree, (tuple, list)):
        return [n for v in tree for n in _named_tuples(v)]
    if isinstance(tree, Mapping):
        return [n for v in tree.values() for n in _named_tuples(v)]
    return []


def load_jax_trainer_state(trainer, state: Mapping, *, rank: int | None = None) -> None:
    """Carry a JAX ``DataParallel.state_dict()`` into the port's
    ``DataParallel`` ``trainer`` in place. ``state`` is the JAX tree as
    its checkpoint stores it: ``params`` and ``rest`` nested dicts of numpy
    arrays, ``opt_state`` the optax state (its named tuples kept), wrapped
    as ``(opt_state, guard)`` when the JAX trainer's guard is armed and
    then as ``(..., residual)`` when it keeps an error-feedback residual.

    * params and BN buffers, as :func:`load_jax_params`;
    * optax's momentum ``trace`` becomes ``torch.optim.SGD``'s
      ``momentum_buffer`` per parameter (optax ``trace = g + μ·trace`` is
      torch's ``buf = μ·buf + g`` at dampening 0; a zero trace is the
      empty buffer's first step);
    * a schedule's ``count`` (optimizer steps taken) becomes the trainer's
      ``lr_scheduler`` position: after ``count`` scheduler steps;
    * the guard's ``lr_scale`` and ``nonfinite_count``;
    * the error-feedback residual, which the JAX trainer stores with a
      leading world axis: ``rank``'s row (default: this process's rank in
      the trainer's group), each leaf mapped by name and layout as a
      parameter is. The port's trainer must keep a residual exactly when
      the JAX one did.

    A JAX ``zero=True`` or ``SpecLayout.fsdp`` trainer stores its trace
    and residual as padded flat vectors, one a dtype, in ``jax.tree_util``
    order of its params tree (sorted keys, HWIO kernels): that order is
    recomputed from the ``params`` tree the state carries, each slice
    mapped to its parameter, then laid out as the port's trainer keeps it
    (per parameter, or re-flattened into its own shards under a sharding
    layout, whatever the two shard worlds). A replicated JAX state carries
    into a sharded port trainer alike.

    Only SGD's state is carried: an optax state holding anything but
    ``trace`` and ``count`` (Adam's moments, say) raises ``ValueError``."""
    load_jax_params(trainer.model, {**_flatten(state["params"]),
                                    **_flatten(state["rest"])})
    if trainer.zero:
        trainer._cut_shards()
    opt_state = state["opt_state"]
    if trainer._residual is not None:
        opt_state, residual = opt_state
        _carry_residual(trainer, residual, rank, state["params"])
    if trainer.divergence_guard is not None:
        opt_state, guard = opt_state
        trainer.guard_state = {"lr_scale": float(guard["lr_scale"]),
                               "nonfinite_count": int(guard["nonfinite_count"])}
    traces, counts = [], []
    for node in _named_tuples(opt_state):
        unknown = set(node._fields) - {"trace", "count"}
        if unknown:
            raise ValueError(f"{type(node).__name__}: cannot carry optax "
                             f"state {sorted(unknown)} into the port")
        if "trace" in node._fields:
            traces.append(node.trace)
        if "count" in node._fields:
            counts.append(int(np.asarray(node.count)))
    if len(traces) > 1 or len(set(counts)) > 1:
        raise ValueError(f"expected one momentum trace and one schedule "
                         f"count, got {len(traces)} and {counts}")
    if traces:
        momentum = _by_port_name(traces[0], state["params"], trainer.model)
        if trainer.zero:
            for dt, shard in _port_shards(trainer, momentum).items():
                trainer.optimizer.state[trainer._shards[dt]]["momentum_buffer"] = shard
        else:
            params = dict(trainer.model.named_parameters())
            for name, arr in momentum.items():
                p = params[name]
                trainer.optimizer.state[p]["momentum_buffer"] = torch.from_numpy(
                    np.array(arr, order="C")).to(device=p.device, dtype=p.dtype)
    if counts and counts[0] and trainer.lr_scheduler is not None:
        # position the scheduler one step short, then step it: the
        # scheduler sets every group's lr for step ``count`` itself
        sched = trainer.lr_scheduler
        sched.load_state_dict({**sched.state_dict(),
                               "last_epoch": counts[0] - 1,
                               # past 1: no "step before optimizer.step" warning
                               "_step_count": counts[0] + 1})
        sched.step()


def _sort_key(k):
    """``jax.tree_util``'s order of one dict level: integer keys (an nnx
    list's, also as digit strings after a round trip through a checkpoint)
    by value, others by string."""
    if isinstance(k, (int, np.integer)) or (isinstance(k, str) and k.isdigit()):
        return (0, int(k), "")
    return (1, 0, str(k))


def _jax_leaves(tree: Mapping, prefix: str = "") -> list:
    """``(dotted name, array)`` of every leaf of a JAX params tree, in
    ``jax.tree_util`` order (sorted keys at every level)."""
    out = []
    for key in sorted(tree, key=_sort_key):
        value, name = tree[key], f"{prefix}{key}"
        if isinstance(value, Mapping):
            out += _jax_leaves(value, name + ".")
        else:
            out.append((name, np.asarray(value)))
    return out


def _dtype_name(arr) -> str:
    return "bfloat16" if "bfloat16" in str(arr.dtype) else str(arr.dtype)


def _by_port_name(tree: Mapping, params: Mapping, model: nn.Module) -> dict:
    """``{port parameter name: array in the port's layout}`` of a JAX tree
    shaped like the params (a momentum trace, a residual row), or of its
    ZeRO form, ``{dtype: padded flat vector}`` in ``jax.tree_util`` order
    of ``params``."""
    leaves = _jax_leaves(params)
    dtypes = {_dtype_name(a) for _, a in leaves}
    flat = _flatten(tree)
    if flat and set(flat) <= dtypes and all(np.ndim(v) == 1 for v in flat.values()):
        offsets = dict.fromkeys(flat, 0)
        split = {}
        for key, arr in leaves:
            dt = _dtype_name(arr)
            off = offsets[dt]
            split[key] = np.asarray(flat[dt])[off:off + arr.size].reshape(arr.shape)
            offsets[dt] = off + arr.size
        for dt, off in offsets.items():
            if np.asarray(flat[dt]).size < off:
                raise ValueError(f"flat {dt} vector of {np.asarray(flat[dt]).size} holds "
                                 f"less than the params tree's {off} elements")
        flat = split
    return dict(_port_name(key, value, model) for key, value in flat.items())


def _port_flat(trainer, by_name: Mapping) -> dict:
    """``{dtype: padded flat vector}`` of ``by_name`` (every trainable
    parameter's array) in the sharded ``trainer``'s layout, on its device."""
    named = dict(trainer._trainable)
    missing = sorted(set(named) - set(by_name))
    if missing:
        raise KeyError(f"no JAX value for {missing[:8]}")
    full = trainer._flat.flatten({
        n: torch.from_numpy(np.array(by_name[n], order="C")).to(p.dtype)
        for n, p in named.items()})
    return {dt: v.to(trainer.device) for dt, v in full.items()}


def _port_shards(trainer, by_name: Mapping) -> dict:
    """``{dtype: this rank's shard}`` of :func:`_port_flat`."""
    w, r = trainer._shard_world, trainer._shard_rank
    return {dt: v.view(w, -1)[r].clone() for dt, v in _port_flat(trainer, by_name).items()}


def _carry_residual(trainer, residual: Mapping, rank: int | None,
                    params: Mapping) -> None:
    """Row ``rank`` of the JAX residual (leaves ``(world, *shape)``, or
    ``{dtype: (world, padded)}`` from a sharding layout) into the
    trainer's residual, by the port's parameter names and layouts."""
    from tpu_syncbn_torch.parallel import collectives

    if rank is None:
        rank = collectives._rank(trainer.group)
    rows = {}
    for key, value in _flatten(residual).items():
        arr = np.asarray(value)
        if arr.ndim == 0 or arr.shape[0] <= rank:
            raise ValueError(f"residual {key}: shape {arr.shape} has no row {rank}")
        if arr[rank].size:  # a non-float group's placeholder is empty
            rows[key] = arr[rank]
    names = _by_port_name(rows, params, trainer.model)
    if trainer.zero:  # per replica, over the whole padded vector
        with torch.no_grad():
            for dt, full in _port_flat(trainer, names).items():
                trainer._residual[dt].copy_(full)
        return
    views = trainer._residual_views()
    for name, row in names.items():
        if name not in views or tuple(views[name].shape) != row.shape:
            raise ValueError(f"residual: the port has no residual {name!r} "
                             f"of shape {row.shape}")
    missing = sorted(set(views) - set(names))
    if missing:
        raise KeyError(f"no JAX residual for {missing[:8]}")
    with torch.no_grad():
        for name, row in names.items():
            views[name].copy_(torch.from_numpy(np.array(row, order="C")))


def _carry_adam(optimizer: torch.optim.Optimizer, model: nn.Module,
                opt_state) -> None:
    """optax Adam's ``ScaleByAdamState`` into ``torch.optim.Adam``: ``mu``
    and ``nu`` (optax ``mu = b1·mu + (1 − b1)·g``, torch's ``exp_avg``
    alike; ``nu`` is ``exp_avg_sq``) per parameter, ``count`` as ``step``
    (both bias-correct with the incremented count). Raises on any other
    optax state."""
    adam = []
    for node in _named_tuples(opt_state):
        unknown = set(node._fields) - {"count", "mu", "nu"}
        if unknown:
            raise ValueError(f"{type(node).__name__}: cannot carry optax "
                             f"state {sorted(unknown)} into torch.optim.Adam")
        if node._fields:
            adam.append(node)
    if len(adam) != 1 or set(adam[0]._fields) != {"count", "mu", "nu"}:
        raise ValueError(f"expected one optax Adam state, got {adam}")
    count = int(np.asarray(adam[0].count))
    if count == 0:
        return  # no step taken: torch's state starts empty
    params = dict(model.named_parameters())
    nus = _flatten(adam[0].nu)
    for key, mu in _flatten(adam[0].mu).items():
        name, m_arr = _port_name(key, mu, model)
        _, v_arr = _port_name(key, nus[key], model)
        p = params[name]

        def put(a, p=p):  # in p's dtype, device and memory format
            return torch.empty_like(p).copy_(torch.from_numpy(np.array(a, order="C")))

        optimizer.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": put(m_arr), "exp_avg_sq": put(v_arr)}


def load_jax_gan_trainer_state(trainer, state: Mapping) -> None:
    """Carry a JAX ``GANTrainer.state_dict()`` into the port's
    ``GANTrainer`` in place. ``state`` is the JAX tree as its checkpoint
    stores it: ``g_params``/``g_rest``/``d_params``/``d_rest`` nested dicts
    of numpy arrays, ``g_opt_state``/``d_opt_state`` optax Adam states (the
    named tuples kept), ``step_count`` an int.

    * both networks' parameters and buffers, as :func:`load_jax_params`
      (SNConv's ``u`` is a buffer of the discriminator);
    * each optax Adam state into its ``torch.optim.Adam`` (``mu`` →
      ``exp_avg``, ``nu`` → ``exp_avg_sq``, ``count`` → ``step``);
    * ``step_count``."""
    for net, model, optimizer in (
            ("g", trainer.generator, trainer.g_optimizer),
            ("d", trainer.discriminator, trainer.d_optimizer)):
        load_jax_params(model, {**_flatten(state[f"{net}_params"]),
                                **_flatten(state[f"{net}_rest"])})
        _carry_adam(optimizer, model, state[f"{net}_opt_state"])
    trainer.step_count = int(state.get("step_count", 0))
