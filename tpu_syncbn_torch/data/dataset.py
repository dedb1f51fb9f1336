"""Map-style datasets — the counterpart of ``tpu_syncbn.data.dataset``.
Samples are numpy arrays; the per-index generation is the same numpy code,
so :class:`SyntheticImageDataset` is bit-identical across the two
packages."""

from __future__ import annotations

from typing import Any

import numpy as np


class Dataset:
    """Map-style dataset protocol (``__len__`` + ``__getitem__``)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Any:
        raise NotImplementedError


class ArrayDataset(Dataset):
    """In-memory arrays → ``(x[i], ..., y[i])`` tuples."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays:
            raise ValueError("ArrayDataset needs at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("all arrays must share the leading dimension")
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, idx):
        out = tuple(a[idx] for a in self.arrays)
        return out if len(out) > 1 else out[0]


class SyntheticImageDataset(Dataset):
    """Deterministic synthetic (image, label) pairs, images NHWC float32 —
    stands in for CIFAR/ImageNet without downloads. Each index seeds its
    own generator, so any shard of any world sees the same samples."""

    def __init__(
        self,
        length: int = 1024,
        shape: tuple[int, int, int] = (32, 32, 3),
        num_classes: int = 10,
        seed: int = 0,
    ):
        self.length = length
        self.shape = shape
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        rng = np.random.RandomState((self.seed * 1_000_003 + idx) % (2**31))
        x = rng.randn(*self.shape).astype(np.float32)
        y = np.int32(rng.randint(self.num_classes))
        return x, y
