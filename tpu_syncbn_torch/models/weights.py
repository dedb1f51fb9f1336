"""Weight transfer from the JAX model's flattened state.

``load_jax_params(model, params)`` fills a port ResNet from a flat mapping
of dotted names to numpy arrays, as the JAX package's
``compat.nnx_to_pure_dict(nnx.state(model))`` yields them once flattened
(``"stem_conv.kernel"``, ``"stages.0.0.bn1.running_var"``, ...). The port
names its submodules like the JAX model, so the mapping is by name:

* conv ``kernel`` (HWIO) → ``weight`` (OIHW, written channels_last);
* fc ``kernel`` (in, out) → ``weight`` (out, in); ``bias`` as is;
* BN ``weight``/``bias``/``running_mean``/``running_var``/
  ``num_batches_tracked`` keep their names.

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
