"""BatchNorm ops: the functional layer and its Triton kernels."""

from tpu_syncbn_torch.ops import batch_norm, triton_bn
from tpu_syncbn_torch.ops.batch_norm import (
    get_kernel_mode,
    kernel_mode,
    set_kernel_mode,
)

__all__ = ["batch_norm", "get_kernel_mode", "kernel_mode", "set_kernel_mode",
           "triton_bn"]
