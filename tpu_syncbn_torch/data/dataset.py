"""Map-style datasets — the counterpart of ``tpu_syncbn.data.dataset``.
Samples are numpy arrays; the per-index generation is the same numpy code,
so :class:`SyntheticImageDataset` is bit-identical across the two
packages, and :func:`load_cifar10` reads the same on-disk batches into the
same arrays."""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable

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


class TransformDataset(Dataset):
    """Applies ``transform(sample)`` lazily per item (the augmentation
    hook, run by the loader's workers)."""

    def __init__(self, base: Dataset, transform: Callable[[Any], Any]):
        self.base = base
        self.transform = transform

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        return self.transform(self.base[idx])


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


def load_cifar10(root: str, train: bool = True) -> ArrayDataset | None:
    """Load CIFAR-10 from an on-disk copy of the standard python batches
    (``root/cifar-10-batches-py``), images NHWC float32 normalized to
    [-1, 1]. Returns None when a batch file is absent: nothing is
    downloaded, and callers fall back to :class:`SyntheticImageDataset`.
    The files are unpickled, so point ``root`` only at a copy you trust."""
    base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        return None
    names = (
        [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    )
    xs, ys = [], []
    for name in names:
        path = os.path.join(base, name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        xs.append(batch[b"data"])
        ys.extend(batch[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x = (x.astype(np.float32) / 255.0 - 0.5) / 0.5
    return ArrayDataset(x, np.asarray(ys, np.int32))
