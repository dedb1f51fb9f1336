"""Collectives, the layouts (``SpecLayout``, the ZeRO ``FlatLayout``,
redistribution), the data-parallel trainer, the GAN trainer, the fused
K-step driver and sequence-parallel attention across ranks."""

from tpu_syncbn_torch.parallel import collectives, redistribute, scan_driver, sequence, zero
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
from tpu_syncbn_torch.parallel.gan_trainer import GANStepOutput, GANTrainer
from tpu_syncbn_torch.parallel.layout import P, SpecLayout
from tpu_syncbn_torch.parallel.sequence import (
    ring_attention,
    ring_attention_zigzag,
    sharded_self_attention,
    ulysses_attention,
    zigzag_shard,
    zigzag_unshard,
)
from tpu_syncbn_torch.parallel.trainer import (
    DataParallel,
    StepOutput,
    resume_latest,
    sync_module_states,
)

__all__ = ["COMPRESS_MODES", "DataParallel", "GANStepOutput", "GANTrainer", "P",
           "SpecLayout", "StepOutput", "all_gather", "all_to_all", "axis_index",
           "axis_size", "broadcast", "collectives", "compressed_pmean", "compressed_psum",
           "compressed_reduce_scatter", "ef_compressed_pmean", "init_error_feedback",
           "normalize_group_spec", "pmax", "pmean", "pmin", "ppermute", "psum",
           "psum_in_groups", "redistribute", "reduce_moments", "reduce_scatter",
           "resume_latest", "ring_all_reduce", "ring_attention", "ring_attention_zigzag",
           "scan_driver", "sequence", "sharded_self_attention", "shuffle_sharded_psum",
           "sync_module_states", "ulysses_attention", "zero", "zigzag_shard",
           "zigzag_unshard"]
