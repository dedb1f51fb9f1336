"""Models: the ResNet family, the causal transformer LM, and weight transfer
from the JAX models."""

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
from tpu_syncbn_torch.models.transformer import (
    TransformerLM,
    init_transformer_lm,
)
from tpu_syncbn_torch.models.weights import (
    load_jax_params,
    load_jax_transformer_params,
)

__all__ = ["RESNETS", "BasicBlock", "Bottleneck", "ResNet", "TransformerLM",
           "init_transformer_lm", "load_jax_params",
           "load_jax_transformer_params", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]
