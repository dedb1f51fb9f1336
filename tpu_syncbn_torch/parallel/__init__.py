"""Collectives, the layouts (``SpecLayout``, the ZeRO ``FlatLayout``,
redistribution), the data-parallel trainer, the GAN trainer, the fused
K-step driver, sequence-parallel attention across ranks, tensor and expert
parallelism, and pipeline training."""

from tpu_syncbn_torch.parallel import (
    collectives,
    expert,
    pipeline,
    pipeline_schedule,
    redistribute,
    scan_driver,
    sequence,
    tensor,
    zero,
)
from tpu_syncbn_torch.parallel.collectives import (
    COMPRESS_MODES,
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
    broadcast,
    compressed_pmean,
    compressed_psum,
    compressed_reduce_scatter,
    ef_compressed_pmean,
    init_error_feedback,
    normalize_group_spec,
    pmax,
    pmean,
    pmin,
    ppermute,
    psum,
    psum_in_groups,
    reduce_moments,
    reduce_scatter,
    ring_all_reduce,
    shuffle_sharded_psum,
)
from tpu_syncbn_torch.parallel.expert import dense_moe, expert_parallel_moe
from tpu_syncbn_torch.parallel.gan_trainer import GANStepOutput, GANTrainer
from tpu_syncbn_torch.parallel.layout import P, SpecLayout
from tpu_syncbn_torch.parallel.pipeline import (
    PipelineTrainer,
    last_stage_output,
    pipeline_apply,
    pipeline_mesh,
    pipeline_parallel,
    split_microbatches,
)
from tpu_syncbn_torch.parallel.pipeline_schedule import (
    Schedule,
    canonical_gpipe_bubble,
    gpipe_schedule,
    one_f1b_schedule,
    validate_schedule,
)
from tpu_syncbn_torch.parallel.sequence import (
    ring_attention,
    ring_attention_zigzag,
    sharded_self_attention,
    ulysses_attention,
    zigzag_shard,
    zigzag_unshard,
)
from tpu_syncbn_torch.parallel.tensor import (
    column_parallel,
    row_parallel,
    tp_attention,
    tp_mlp,
)
from tpu_syncbn_torch.parallel.trainer import (
    DataParallel,
    StepOutput,
    resume_latest,
    sync_module_states,
)

__all__ = ["COMPRESS_MODES", "DataParallel", "GANStepOutput", "GANTrainer", "P",
           "PipelineTrainer", "Schedule", "SpecLayout", "StepOutput", "all_gather",
           "all_to_all", "axis_index", "axis_size", "broadcast", "canonical_gpipe_bubble",
           "collectives", "column_parallel", "compressed_pmean", "compressed_psum",
           "compressed_reduce_scatter", "dense_moe", "ef_compressed_pmean", "expert",
           "expert_parallel_moe", "gpipe_schedule", "init_error_feedback",
           "last_stage_output", "normalize_group_spec", "one_f1b_schedule", "pipeline",
           "pipeline_apply", "pipeline_mesh", "pipeline_parallel", "pipeline_schedule",
           "pmax", "pmean", "pmin", "ppermute", "psum", "psum_in_groups", "redistribute",
           "reduce_moments", "reduce_scatter", "resume_latest", "ring_all_reduce",
           "ring_attention", "ring_attention_zigzag", "row_parallel", "scan_driver",
           "sequence", "sharded_self_attention", "shuffle_sharded_psum",
           "split_microbatches", "sync_module_states", "tensor", "tp_attention", "tp_mlp",
           "ulysses_attention", "validate_schedule", "zero", "zigzag_shard",
           "zigzag_unshard"]
