"""Serving: dynamic-batching inference on the trained model, and
zero-downtime weight publication into it — the counterpart of
``tpu_syncbn.serve``.

* :mod:`tpu_syncbn_torch.serve.engine` — :class:`InferenceEngine`: the
  trained module copied and pinned in eval mode (BN on running stats, no
  collective), and a size-bounded LRU set of bucketed programs, one CUDA
  graph per bucket on the card; :meth:`~InferenceEngine.swap_params` and
  :meth:`~InferenceEngine.rollback` change the weights the graphs read.
* :mod:`tpu_syncbn_torch.serve.batcher` — :class:`DynamicBatcher`:
  bounded request queue with a ``max_batch``/``max_wait_ms`` admission
  policy, pad-to-bucket coalescing, queue-full rejection (backpressure),
  and graceful drain wired to
  :class:`~tpu_syncbn_torch.runtime.resilience.PreemptionGuard`.
* :mod:`tpu_syncbn_torch.serve.admission` — deadlines with
  earliest-deadline-first dispatch and predicted-completion load shedding
  (:class:`AdmissionController`, :class:`LatencyEstimator`), and a
  consecutive-failure :class:`CircuitBreaker` with deterministic-jitter
  backoff and half-open probes.
* :mod:`tpu_syncbn_torch.serve.loadgen` — open-loop Poisson/trace-driven
  load generation (:class:`OpenLoopLoadGen`), the offered-load sweep
  ``bench --serve`` runs past saturation.
* :mod:`tpu_syncbn_torch.serve.publish` — zero-downtime weight
  publication: :class:`SwapController` hot-swaps manifest-verified
  published versions (or a live trainer's weights, read from its
  module, which holds them in full under every layout) into a running
  engine with drain, a memwatch-bounded double buffer and automatic
  rollback.

Quickstart::

    from tpu_syncbn_torch import serve

    engine = serve.InferenceEngine.from_trainer(dp, buckets=(8, 32, 128))
    engine.warm(example_batch)                     # one graph a bucket
    with serve.DynamicBatcher(engine, max_batch=128,
                              max_wait_ms=5) as batcher:
        fut = batcher.submit(x[i:i + 1])           # per-request future
        logits = fut.result()

``python -m tpu_syncbn_torch.bench --serve`` runs closed- and open-loop
sweeps against this stack and reports throughput, p50/p99 latency and
batch-fill ratio in the ``serve`` block.
"""

from tpu_syncbn_torch.parallel.zero import unshard_params  # noqa: F401
from tpu_syncbn_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    LatencyEstimator,
    RejectedError,
)
from tpu_syncbn_torch.serve.batcher import DynamicBatcher  # noqa: F401
from tpu_syncbn_torch.serve.engine import (  # noqa: F401
    InferenceEngine,
    VersionSkewError,
)
from tpu_syncbn_torch.serve.publish import (  # noqa: F401
    SWAP_PHASES,
    PublicationError,
    SwapAbortedError,
    SwapController,
)
from tpu_syncbn_torch.serve.loadgen import (  # noqa: F401
    LoadReport,
    OpenLoopLoadGen,
    poisson_arrivals,
    trace_arrivals,
)

__all__ = [
    "InferenceEngine",
    "DynamicBatcher",
    "RejectedError",
    "DeadlineExceededError",
    "CircuitOpenError",
    "CircuitBreaker",
    "AdmissionController",
    "LatencyEstimator",
    "OpenLoopLoadGen",
    "LoadReport",
    "poisson_arrivals",
    "trace_arrivals",
    "unshard_params",
    "SwapController",
    "PublicationError",
    "SwapAbortedError",
    "VersionSkewError",
]
