"""Collectives, the data-parallel trainer, the GAN trainer and (world 1)
sequence attention."""

from tpu_syncbn_torch.parallel import collectives, sequence
from tpu_syncbn_torch.parallel.gan_trainer import GANStepOutput, GANTrainer
from tpu_syncbn_torch.parallel.trainer import (
    DataParallel,
    StepOutput,
    resume_latest,
    sync_module_states,
)

__all__ = ["DataParallel", "GANStepOutput", "GANTrainer", "StepOutput",
           "collectives", "resume_latest", "sequence", "sync_module_states"]
