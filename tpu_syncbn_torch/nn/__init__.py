"""BatchNorm / SyncBatchNorm modules and the SyncBN tree conversion."""

from tpu_syncbn_torch.nn.convert import convert_sync_batchnorm
from tpu_syncbn_torch.nn.normalization import (
    BatchNorm,
    BatchNorm1d,
    BatchNorm2d,
    BatchNorm3d,
    SyncBatchNorm,
)

__all__ = ["BatchNorm", "BatchNorm1d", "BatchNorm2d", "BatchNorm3d",
           "SyncBatchNorm", "convert_sync_batchnorm"]
