"""Ops and their hand-written Hopper kernels: BatchNorm (the functional
layer and its Triton kernels, ``triton_bn``) and exact fused attention
(``cuda_attention``, CUDA C++ kernels built with ``nvcc`` at first launch).
``set_kernel_mode`` governs every kernel of the package."""

from tpu_syncbn_torch.ops import batch_norm, cuda_attention, triton_bn
from tpu_syncbn_torch.ops.batch_norm import (
    get_kernel_mode,
    kernel_mode,
    set_kernel_mode,
)
from tpu_syncbn_torch.ops.cuda_attention import FlashAttention, flash_attention

__all__ = ["FlashAttention", "batch_norm", "cuda_attention", "flash_attention",
           "get_kernel_mode", "kernel_mode", "set_kernel_mode", "triton_bn"]
