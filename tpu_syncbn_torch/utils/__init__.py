"""Training meters, step timing and the JSONL scalar log."""

from tpu_syncbn_torch.utils.metrics import (
    AverageMeter,
    ScalarLogger,
    ThroughputMeter,
    step_timer,
)

__all__ = ["AverageMeter", "ScalarLogger", "ThroughputMeter", "step_timer"]
