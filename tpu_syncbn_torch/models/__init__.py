"""Models: the ResNet family, the DCGAN/SNGAN networks, RetinaNet-FPN with
its detection ops, the causal transformer LM, and weight transfer from the
JAX models."""

from tpu_syncbn_torch.models import detection
from tpu_syncbn_torch.models.gan import (
    DCGANDiscriminator,
    DCGANGenerator,
    SNConv,
    SNGANDiscriminator,
    bce_gan_losses,
    hinge_gan_losses,
)
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
from tpu_syncbn_torch.models.retinanet import FPN, RetinaHead, RetinaNet, retinanet_r50_fpn
from tpu_syncbn_torch.models.transformer import (
    TransformerLM,
    init_transformer_lm,
)
from tpu_syncbn_torch.models.weights import (
    load_jax_gan_trainer_state,
    load_jax_params,
    load_jax_trainer_state,
    load_jax_transformer_params,
)

__all__ = ["FPN", "RESNETS", "BasicBlock", "Bottleneck", "DCGANDiscriminator",
           "DCGANGenerator", "ResNet", "RetinaHead", "RetinaNet", "SNConv",
           "SNGANDiscriminator", "TransformerLM", "bce_gan_losses", "detection",
           "hinge_gan_losses", "init_transformer_lm", "load_jax_gan_trainer_state",
           "load_jax_params", "load_jax_trainer_state",
           "load_jax_transformer_params", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "retinanet_r50_fpn"]
