"""Models: the ResNet family and weight transfer from the JAX model."""

from tpu_syncbn_torch.models.resnet import (
    RESNETS,
    BasicBlock,
    Bottleneck,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from tpu_syncbn_torch.models.weights import load_jax_params

__all__ = ["RESNETS", "BasicBlock", "Bottleneck", "ResNet", "load_jax_params",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]
