"""tpu_syncbn_torch — the PyTorch / CUDA port of ``tpu_syncbn``.

Synchronized BatchNorm for data-parallel training, one process per GPU,
with the BatchNorm hot ops as hand-written Triton kernels for Hopper
(:mod:`tpu_syncbn_torch.ops.triton_bn`); and the causal transformer LM
(:mod:`tpu_syncbn_torch.models.transformer`, trained by
:mod:`tpu_syncbn_torch.longcontext_train`) with exact fused attention as
hand-written CUDA C++ kernels for Hopper
(:mod:`tpu_syncbn_torch.ops.cuda_attention`, built by ``nvcc`` at their
first launch, never at import). The package imports ``torch`` and numpy
only; it never imports JAX or the JAX package, which stays in the
repository as the reference the port is tested against.

:mod:`tpu_syncbn_torch.obs` holds the telemetry registry, the trace spans
and the trainers' on-device step monitors (the JAX package's names and
formats). :mod:`tpu_syncbn_torch.serve` serves a trained model: one CUDA
graph per batch bucket behind a dynamic batcher with admission control.

Entry points default to ``device="cuda"`` and raise without a card; pass
``device="cpu"`` to run on the CPU (the kernels' plain versions run there).
"""

from tpu_syncbn_torch import data, models, nn, obs, ops, parallel, runtime, serve, utils
from tpu_syncbn_torch.mesh_axes import DATA_AXIS

__all__ = ["DATA_AXIS", "data", "models", "nn", "obs", "ops", "parallel", "runtime",
           "serve", "utils"]
