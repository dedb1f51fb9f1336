"""Weight transfer from the JAX models' parameters.

``load_jax_params(model, params)`` fills a port ResNet from a flat mapping
of dotted names to numpy arrays, as the JAX package's
``compat.nnx_to_pure_dict(nnx.state(model))`` yields them once flattened
(``"stem_conv.kernel"``, ``"stages.0.0.bn1.running_var"``, ...). The port
names its submodules like the JAX model, so the mapping is by name:

* conv ``kernel`` (HWIO) → ``weight`` (OIHW, written channels_last);
* fc ``kernel`` (in, out) → ``weight`` (out, in); ``bias`` as is;
* BN ``weight``/``bias``/``running_mean``/``running_var``/
  ``num_batches_tracked`` keep their names.

``load_jax_transformer_params(model, params)`` fills a port
``TransformerLM`` from the JAX LM's parameter pytree (nested dicts of
arrays, ``init_transformer_lm``'s output), name for name and with no
transpose: both keep matrices in ``x @ W`` (in, out) order.

No JAX import: the arrays arrive as numpy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray]) -> None:
    """Copy ``params`` into ``model`` in place (values cast to each target's
    dtype and device). Raises if a name of either side has no partner."""
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    seen = set()
    for key, value in params.items():
        arr = np.asarray(value)
        if key.endswith(".kernel"):
            name = key[: -len(".kernel")] + ".weight"
            if arr.ndim == 4:      # conv: HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:    # linear: (in, out) -> (out, in)
                arr = arr.T
            else:
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
        else:
            name = key
        if name not in targets:
            raise KeyError(f"{key}: the port model has no {name!r}")
        t = targets[name]
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
