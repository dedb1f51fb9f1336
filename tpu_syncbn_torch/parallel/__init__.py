"""Collectives, the data-parallel trainer and (world 1) sequence attention."""

from tpu_syncbn_torch.parallel import collectives, sequence
from tpu_syncbn_torch.parallel.trainer import (
    DataParallel,
    StepOutput,
    sync_module_states,
)

__all__ = ["DataParallel", "StepOutput", "collectives", "sequence",
           "sync_module_states"]
