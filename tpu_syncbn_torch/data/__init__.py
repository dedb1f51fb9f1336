"""Datasets, samplers, transforms, the loader and device staging."""

from tpu_syncbn_torch.data import transforms
from tpu_syncbn_torch.data.dataset import (
    ArrayDataset,
    Dataset,
    SyntheticImageDataset,
    TransformDataset,
    load_cifar10,
)
from tpu_syncbn_torch.data.detection import (
    CocoDetectionDataset,
    SyntheticDetectionDataset,
    pad_ground_truth,
)
from tpu_syncbn_torch.data.image_folder import ImageFolderDataset, decode_image
from tpu_syncbn_torch.data.loader import (
    DataLoader,
    WorkerError,
    WorkerInfo,
    default_collate,
    device_prefetch,
    get_worker_info,
    staged_iter,
)
from tpu_syncbn_torch.data.sampler import (
    DistributedSampler,
    RandomSampler,
    Sampler,
    SequentialSampler,
)

__all__ = ["ArrayDataset", "CocoDetectionDataset", "DataLoader", "Dataset",
           "DistributedSampler", "SyntheticDetectionDataset", "pad_ground_truth",
           "ImageFolderDataset", "RandomSampler", "Sampler",
           "SequentialSampler", "SyntheticImageDataset", "TransformDataset",
           "WorkerError", "WorkerInfo", "decode_image", "default_collate",
           "device_prefetch", "get_worker_info", "load_cifar10",
           "staged_iter", "transforms"]
