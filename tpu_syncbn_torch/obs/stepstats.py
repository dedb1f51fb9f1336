"""Per-step breakdown: host-side timing seams and on-device step monitors —
the counterpart of ``tpu_syncbn.obs.stepstats``.

**Host side** (:func:`timed_span`, :func:`instrumented_batches`,
:func:`timed_fetch`, copies of the JAX module's): the seams of a training
loop — data wait (blocking on the input iterator) and the step call — each
recorded as a trace span (``obs.tracing``) AND a telemetry histogram
(``obs.telemetry``) in one shot. ``runtime.resilience.ResilientLoop`` and
``tpu_syncbn_torch.bench`` drive their loops through these, so a Perfetto
timeline of any run shows ``data_wait`` / ``step`` / ``checkpoint_*``
spans.

**Device side** (:func:`grad_monitors`, :func:`state_health`): scalar
health monitors computed in torch on the step's own tensors and returned
through ``StepOutput.monitors`` — gradient global norm, non-finite counts,
BN running-statistic health. They never call ``.item()``, ``.cpu()`` or a
synchronize: reading one waits for the step, computing it does not. The
number of launches does not grow with the layer count (one ``torch.cat``
per dtype, the ``torch._foreach_*`` family), since an eager ResNet-50 step
is host-bound. Under a sharding layout the gradient monitors need one
scalar all-reduce over the shard group, since each rank holds a shard.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterable, Iterator

import torch

from tpu_syncbn_torch.obs import telemetry, tracing


# ---------------------------------------------------------------------------
# host side


@contextlib.contextmanager
def timed_span(span_name: str, hist_name: str | None = None, **args):
    """One context manager for the span + histogram pair: a tracing span
    named ``span_name`` (when a tracer is installed) and a telemetry
    histogram observation into ``hist_name`` seconds (when telemetry is
    enabled). With both off this is a bare yield — hot-loop safe."""
    tracer = tracing.get()
    record = telemetry.enabled() and hist_name is not None
    if tracer is None and not record:
        yield
        return
    t0 = time.perf_counter()
    try:
        if tracer is not None:
            with tracer.span(span_name, **args):
                yield
        else:
            yield
    finally:
        if record:
            telemetry.observe(hist_name, time.perf_counter() - t0)


def instrumented_batches(
    iterator: Iterable,
    *,
    span_name: str = "data_wait",
    hist_name: str = "step.data_wait_s",
) -> Iterator:
    """Yield from ``iterator``, recording the time the consumer spent
    blocked waiting for each batch (span + histogram). Wrap the batch
    source of any step loop::

        for batch in stepstats.instrumented_batches(loader):
            with stepstats.timed_span("step", "step.time_s"):
                out = dp.train_step(batch)
    """
    it = iter(iterator)
    while True:
        try:
            batch = timed_fetch(it, span_name, hist_name)
        except StopIteration:
            return
        yield batch


def timed_fetch(it: Iterator, span_name: str = "data_wait",
                hist_name: str | None = "step.data_wait_s"):
    """``next(it)`` under a ``span_name`` span, observing the blocking
    wait into ``hist_name``. The terminal fetch (StopIteration) closes its
    span but is NOT a histogram sample: it would add one end-of-epoch
    outlier per epoch."""
    tracer = tracing.get()
    record = telemetry.enabled() and hist_name is not None
    if tracer is None and not record:
        return next(it)
    t0 = time.perf_counter()
    ctx = (tracer.span(span_name) if tracer is not None
           else contextlib.nullcontext())
    with ctx:
        batch = next(it)  # StopIteration propagates, unrecorded below
    if record:
        telemetry.observe(hist_name, time.perf_counter() - t0)
    return batch


# ---------------------------------------------------------------------------
# device side


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a 1-D tensor, a view when its memory is dense in any order
    (channels-last included), since the monitors do not care about the
    order of the elements."""
    if t.dim() == 1:
        return t
    if t.is_contiguous():
        return t.view(-1)
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1).reshape(-1)
    return t.reshape(-1)


def _flat_by_dtype(tensors) -> list[torch.Tensor]:
    """One flat buffer a dtype over the floating ``tensors`` (one ``cat``
    each)."""
    by: dict = {}
    for t in tensors:
        if t.is_floating_point() and t.numel():
            by.setdefault(t.dtype, []).append(_flat(t))
    return [ts[0] if len(ts) == 1 else torch.cat(ts) for ts in by.values()]


def _nonfinite(flats, device) -> torch.Tensor:
    """Count of non-finite entries over flat buffers, as f32."""
    if not flats:
        return torch.zeros((), dtype=torch.float32, device=device)
    counts = [f.numel() - torch.isfinite(f).sum() for f in flats]
    return (counts[0] if len(counts) == 1 else torch.stack(counts).sum()).to(torch.float32)


def _sq(flats, device) -> torch.Tensor:
    """Σx² over flat buffers, f32 accumulation."""
    if not flats:
        return torch.zeros((), dtype=torch.float32, device=device)
    norms = [torch.linalg.vector_norm(f, dtype=torch.float32) for f in flats]
    return norms[0].square() if len(norms) == 1 else torch.stack(norms).square().sum()


def grad_monitors(grads, group=None, *, sharded: bool = False) -> dict:
    """Scalar gradient monitors over a list of gradient tensors:
    ``grad_norm`` (global L2, f32 accumulation) and ``grad_nonfinite``
    (count of non-finite entries).

    ``sharded=True`` (a sharding layout: each rank holds one flat shard a
    dtype) adds ONE scalar all-reduce of ``(Σx², count)`` over ``group``,
    the shard group, so the norm is the global one. With replicated
    (already averaged) gradients leave it False: the local values ARE the
    global values."""
    grads = [g for g in grads if g is not None]
    device = grads[0].device if grads else torch.device("cpu")
    with torch.no_grad():
        flats = _flat_by_dtype(grads)
        sq, nonfinite = _sq(flats, device), _nonfinite(flats, device)
        if sharded and group is not None:
            from tpu_syncbn_torch.parallel import collectives

            sq, nonfinite = collectives.psum(torch.stack([sq, nonfinite]), group).unbind(0)
        return {"grad_norm": torch.sqrt(sq), "grad_nonfinite": nonfinite}


def _f32(tensors) -> list[torch.Tensor]:
    return [t if t.dtype == torch.float32 else t.to(torch.float32) for t in tensors]


def _foreach_max(tensors) -> list[torch.Tensor]:
    if hasattr(torch, "_foreach_max"):
        return list(torch._foreach_max(tensors))
    return [t.amax() for t in tensors]


def state_health(named_buffers, group=None, *, reduce: bool = False,
                 per_layer: bool = False) -> dict:
    """BN running-statistic health monitors over ``named_buffers`` (a
    module, whose ``named_buffers()`` are read, or ``(name, tensor)``
    pairs):

    * ``bn_mean_max_abs`` — max ``|running_mean|`` over every BN layer
      (drift detector);
    * ``bn_var_max`` / ``bn_var_min`` — extremes of ``running_var`` (a var
      collapsing to 0 or exploding flags a dying or diverging normalizer);
    * ``bn_layers`` — how many ``running_var`` buffers were found (0 means
      the other ``bn_*`` monitors are vacuous zeros);
    * ``state_nonfinite`` — count of non-finite entries across ALL floating
      buffers.

    ``per_layer=True`` also emits ``bn_var_min<path>`` /
    ``bn_mean_max_abs<path>`` per BN buffer (the trainers'
    ``monitors="full"``), the path from the buffer's name
    (``layer1.0.bn1.running_var`` → ``.layer1.0.bn1``). Buffers are
    classified by their names holding ``running_mean`` / ``running_var``.

    ``reduce=True`` (per-replica buffers, ``broadcast_buffers=False``)
    reduces over ``group`` to the worst replica — max for maxima and
    counts, min for ``bn_var_min*`` — with one all-reduce, so the monitors
    stay replicated."""
    if isinstance(named_buffers, torch.nn.Module):
        named_buffers = named_buffers.named_buffers()
    items = [(n, b) for n, b in named_buffers if b is not None]
    floating = [b for _, b in items if b.is_floating_point()]
    means = [(n, b) for n, b in items if "running_mean" in n]
    variances = [(n, b) for n, b in items if "running_var" in n]
    device = items[0][1].device if items else torch.device("cpu")
    zero = torch.zeros((), dtype=torch.float32, device=device)
    with torch.no_grad():
        out = {"state_nonfinite": _nonfinite(_flat_by_dtype(floating), device),
               "bn_layers": torch.full((), float(len(variances)), dtype=torch.float32,
                                       device=device)}
        # the extremes over every layer from one concatenation each (the
        # buffers are 1-D); per layer, the multi-tensor reductions
        m32 = _f32(_flat(b) for _, b in means)
        v32 = _f32(_flat(b) for _, b in variances)
        out["bn_mean_max_abs"] = torch.cat(m32).abs().amax() if m32 else zero
        vcat = torch.cat(v32) if v32 else None
        out["bn_var_max"] = vcat.amax() if v32 else zero
        out["bn_var_min"] = vcat.amin() if v32 else zero
        if per_layer and m32:
            mmax = torch._foreach_norm(m32, float("inf"))
            for (n, _), v in zip(means, mmax):
                out[f"bn_mean_max_abs{_layer_key(n, 'running_mean')}"] = v
        if per_layer and v32:
            vmin = torch._foreach_neg(_foreach_max(torch._foreach_neg(v32)))
            for (n, _), v in zip(variances, vmin):
                out[f"bn_var_min{_layer_key(n, 'running_var')}"] = v
        if reduce and group is not None:
            from tpu_syncbn_torch.parallel import collectives

            keys = list(out)
            signs = [-1.0 if k.startswith("bn_var_min") else 1.0 for k in keys]
            # one all-reduce MAX: min(x) = -max(-x)
            vec = torch.stack([out[k] * s for k, s in zip(keys, signs)])
            vec = collectives.pmax(vec, group)
            out = {k: vec[i] * s for i, (k, s) in enumerate(zip(keys, signs))}
    return out


def _layer_key(path: str, buffer_name: str) -> str:
    """Trim the buffer's own name off a dotted (or JAX keystr) path and
    normalize it into a compact monitor-key suffix:
    ``layers.0.bn.running_var`` → ``.layers.0.bn``."""
    trimmed = path.split(buffer_name)[0]
    out = []
    token = ""
    for ch in trimmed:
        if ch in "[]'\".":
            if token:
                out.append(token)
                token = ""
        else:
            token += ch
    if token:
        out.append(token)
    return ("." + ".".join(out)) if out else ""


def collective_tallies() -> dict:
    """The ``collectives.*`` call/byte counters currently in the process
    registry (``parallel.collectives`` counts every call while telemetry
    is enabled)."""
    snap = telemetry.REGISTRY.snapshot()
    return {k: v for k, v in snap["counters"].items()
            if k.startswith("collectives.")}
