"""Real-image ingestion: JPEG/PNG directory datasets (PIL decode) — the
counterpart of ``tpu_syncbn.data.image_folder``, with the same class
mapping, sample order and ``class_to_idx`` pinning.

The ImageNet-style ``root/<class_name>/<image>.jpg`` reader (torchvision's
``ImageFolder`` layout). Decode happens in the loader workers — PIL
releases the interpreter lock during JPEG decode, so the threaded
DataLoader parallelizes it; process workers decode in their own
interpreters.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

from tpu_syncbn_torch.data.dataset import Dataset

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".gif")


def decode_image(path: str) -> np.ndarray:
    """Decode an image file to an RGB uint8 HWC array."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ImageFolderDataset(Dataset):
    """``root/<class_name>/*.jpg`` → ``(image, label)`` samples.

    Classes are the sorted subdirectory names mapped to dense labels
    [0, K) — torchvision ``ImageFolder`` semantics, so an on-disk
    ImageNet/CIFAR tree ports directly. Pass ``class_to_idx`` (e.g. from
    the train split) to pin the mapping for a val split. Samples are
    sorted per class for deterministic indexing; shuffling is the
    sampler's job (``DistributedSampler(shuffle=True)``).
    """

    def __init__(
        self,
        root: str,
        transform: Callable | None = None,
        *,
        extensions: Sequence[str] = IMAGE_EXTENSIONS,
        class_to_idx: dict[str, int] | None = None,
        loader: Callable[[str], np.ndarray] = decode_image,
    ):
        if not os.path.isdir(root):
            raise FileNotFoundError(f"dataset root {root!r} is not a directory")
        self.root = root
        self.transform = transform
        self.loader = loader
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        if class_to_idx is None:
            class_to_idx = {c: i for i, c in enumerate(classes)}
        self.class_to_idx = dict(class_to_idx)
        self.classes = sorted(self.class_to_idx, key=self.class_to_idx.get)
        exts = tuple(e.lower() for e in extensions)
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            if c not in self.class_to_idx:
                continue
            cdir = os.path.join(root, c)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith(exts):
                    self.samples.append(
                        (os.path.join(cdir, name), self.class_to_idx[c])
                    )
        if not self.samples:
            raise FileNotFoundError(
                f"no images with extensions {exts} under {root!r}"
            )

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        image = self.loader(path)
        if self.transform is not None:
            image = self.transform(image)
        return image, np.int32(label)
