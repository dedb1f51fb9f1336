"""Collectives, the layouts (``SpecLayout``, the ZeRO ``FlatLayout``,
redistribution), the data-parallel trainer, the GAN trainer, the fused
K-step driver and (world 1) sequence attention."""

from tpu_syncbn_torch.parallel import collectives, redistribute, scan_driver, sequence, zero
from tpu_syncbn_torch.parallel.gan_trainer import GANStepOutput, GANTrainer
from tpu_syncbn_torch.parallel.layout import P, SpecLayout
from tpu_syncbn_torch.parallel.trainer import (
    DataParallel,
    StepOutput,
    resume_latest,
    sync_module_states,
)

__all__ = ["DataParallel", "GANStepOutput", "GANTrainer", "P", "SpecLayout", "StepOutput",
           "collectives", "redistribute", "resume_latest", "scan_driver", "sequence",
           "sync_module_states", "zero"]
