"""Datasets, the distributed sampler, the loader and device staging."""

from tpu_syncbn_torch.data.dataset import (
    ArrayDataset,
    Dataset,
    SyntheticImageDataset,
)
from tpu_syncbn_torch.data.loader import DataLoader, default_collate, device_prefetch
from tpu_syncbn_torch.data.sampler import (
    DistributedSampler,
    Sampler,
    SequentialSampler,
)

__all__ = ["ArrayDataset", "DataLoader", "Dataset", "DistributedSampler",
           "Sampler", "SequentialSampler", "SyntheticImageDataset",
           "default_collate", "device_prefetch"]
