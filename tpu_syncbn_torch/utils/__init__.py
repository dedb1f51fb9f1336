"""Utilities: checkpoint / resume (rank 0 writes), meters, step timing,
the JSONL scalar log, COCO-style mAP and the Fréchet distance."""

from tpu_syncbn_torch.utils.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptError,
    available_steps,
    load_checkpoint,
    read_manifest,
    save_checkpoint,
    snapshot_to_host,
    verified_steps,
    verify_checkpoint,
)
from tpu_syncbn_torch.utils.coco_map import evaluate_detections
from tpu_syncbn_torch.utils.fid import frechet_distance, gaussian_stats
from tpu_syncbn_torch.utils.metrics import (
    AverageMeter,
    EventCounter,
    ScalarLogger,
    ThroughputMeter,
    profiler_trace,
    step_timer,
)

__all__ = ["AsyncCheckpointer", "AverageMeter", "CheckpointCorruptError", "EventCounter",
           "ScalarLogger", "ThroughputMeter", "available_steps",
           "evaluate_detections", "frechet_distance", "gaussian_stats",
           "load_checkpoint", "profiler_trace", "read_manifest", "save_checkpoint",
           "snapshot_to_host", "step_timer", "verified_steps",
           "verify_checkpoint"]
