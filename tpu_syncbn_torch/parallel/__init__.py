"""Collectives and the data-parallel trainer."""

from tpu_syncbn_torch.parallel import collectives
from tpu_syncbn_torch.parallel.trainer import DataParallel, StepOutput

__all__ = ["DataParallel", "StepOutput", "collectives"]
