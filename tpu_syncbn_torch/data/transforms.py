"""Host-side image transforms (numpy) — a copy of
``tpu_syncbn.data.transforms``, index-exact and bit-exact with it: the
same draws from the same generators, the same PIL bilinear path.
torchvision-transform-style API; all operate on HWC numpy arrays.

Randomness contract: each random transform draws from its own generator —
pass ``rng=`` (a shared ``np.random.RandomState`` you manage) or ``seed=``
(int) for reproducibility; by default a fresh entropy-seeded generator is
used, so composed transforms are independent. Draws are lock-protected,
so transforms are safe under the threaded DataLoader; with
``num_workers=0`` a seeded pipeline is bit-reproducible run to run, with
worker threads the *batch order* stays deterministic but the augmentation
draw order follows thread scheduling. Process workers each own a pickled
copy of every generator: reseed them per worker with :meth:`Compose.reseed`
in a ``worker_init_fn``, and the draws of each batch are reproducible.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np


class _Draws:
    """Lock-protected RandomState shared safely across loader threads.

    Picklable (for process workers): the lock is dropped and recreated;
    the RNG state pickles with numpy. Each worker process then owns a
    COPY of the generator — reseed via ``DataLoader(worker_init_fn=...)``
    if per-worker decorrelated augmentation draws matter (same caveat as
    torch's per-worker seeding)."""

    def __init__(self, rng: np.random.RandomState | None, seed: int | None):
        if rng is not None:
            self._rng = rng
        else:
            self._rng = np.random.RandomState(seed)  # None → OS entropy
        self._lock = threading.Lock()

    def __getstate__(self):
        return {"_rng": self._rng}

    def __setstate__(self, state):
        self._rng = state["_rng"]
        self._lock = threading.Lock()

    def reseed(self, seed: int) -> None:
        with self._lock:
            self._rng = np.random.RandomState(seed)

    def rand(self) -> float:
        with self._lock:
            return float(self._rng.rand())

    def randint(self, n: int) -> int:
        with self._lock:
            return int(self._rng.randint(n))

    def uniform(self, lo: float, hi: float) -> float:
        with self._lock:
            return float(self._rng.uniform(lo, hi))


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x

    def reseed(self, seed: int) -> None:
        """Reseed every random child transform with a seed derived from
        ``seed`` and its position — THE public hook for per-worker
        augmentation decorrelation in a process-worker ``worker_init_fn``
        (each spawn worker inherits an identical pickled RNG state)::

            def init(wid):
                data.get_worker_info().dataset.transform.reseed(1000 + wid)
        """
        for i, t in enumerate(self.transforms):
            if hasattr(t, "reseed"):
                t.reseed(seed * 1_000_003 + i)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, *, rng=None, seed: int | None = None):
        self.p = p
        self._draws = _Draws(rng, seed)

    def reseed(self, seed: int) -> None:
        self._draws.reseed(seed)

    def __call__(self, x):
        if self._draws.rand() < self.p:
            return np.ascontiguousarray(x[:, ::-1])
        return x


class RandomCrop:
    """Pad-then-crop (the CIFAR recipe: pad 4, crop 32). Default padding is
    zero-fill, matching torchvision's ``RandomCrop(32, padding=4)``;
    ``padding_mode="reflect"`` opts into reflect padding."""

    def __init__(self, size: int, padding: int = 4, *,
                 padding_mode: str = "constant",
                 rng=None, seed: int | None = None):
        self.size = size
        self.padding = padding
        self.padding_mode = padding_mode
        self._draws = _Draws(rng, seed)

    def reseed(self, seed: int) -> None:
        self._draws.reseed(seed)

    def __call__(self, x):
        p = self.padding
        kw = {"mode": self.padding_mode}
        if self.padding_mode == "constant":
            kw["constant_values"] = 0
        padded = np.pad(x, ((p, p), (p, p), (0, 0)), **kw)
        if padded.shape[0] < self.size or padded.shape[1] < self.size:
            raise ValueError(
                f"crop size {self.size} larger than padded input "
                f"{padded.shape[:2]}"
            )
        i = self._draws.randint(padded.shape[0] - self.size + 1)
        j = self._draws.randint(padded.shape[1] - self.size + 1)
        return padded[i : i + self.size, j : j + self.size]


class RandomResizedCrop:
    """ImageNet-style scale/aspect jitter crop + resize (bilinear by
    default, matching torchvision)."""

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 *, interpolation: str = "bilinear",
                 rng=None, seed: int | None = None):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation
        self._draws = _Draws(rng, seed)

    def reseed(self, seed: int) -> None:
        self._draws.reseed(seed)

    def __call__(self, x):
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target = self._draws.uniform(*self.scale) * area
            ar = np.exp(
                self._draws.uniform(np.log(self.ratio[0]), np.log(self.ratio[1]))
            )
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = self._draws.randint(h - ch + 1)
                j = self._draws.randint(w - cw + 1)
                crop = x[i : i + ch, j : j + cw]
                return _resize(crop, self.size, self.interpolation)
        side = min(h, w)  # fallback: center crop
        i, j = (h - side) // 2, (w - side) // 2
        return _resize(
            x[i : i + side, j : j + side], self.size, self.interpolation
        )


def _resize_nearest(x: np.ndarray, size: int) -> np.ndarray:
    h, w = x.shape[:2]
    ri = (np.arange(size) * h // size).clip(0, h - 1)
    rj = (np.arange(size) * w // size).clip(0, w - 1)
    return x[ri][:, rj]


def _resize_bilinear(
    x: np.ndarray, size: int | tuple[int, int]
) -> np.ndarray:
    """PIL bilinear resize (the torchvision default filter) to
    ``(size, size)`` or ``(h, w)``; uint8 RGB goes through the fast C
    path, everything else per-channel in 'F' mode (rounded, not
    truncated, when cast back to an integer dtype)."""
    from PIL import Image

    th, tw = (size, size) if isinstance(size, int) else size
    if x.dtype == np.uint8 and x.ndim == 3 and x.shape[2] in (3, 4):
        mode = "RGB" if x.shape[2] == 3 else "RGBA"
        im = Image.fromarray(x, mode)
        return np.asarray(im.resize((tw, th), Image.BILINEAR))
    squeeze = x.ndim == 2
    x3 = np.atleast_3d(x)
    chans = [
        np.asarray(
            Image.fromarray(np.asarray(x3[..., c], np.float32), mode="F")
            .resize((tw, th), Image.BILINEAR)
        )
        for c in range(x3.shape[2])
    ]
    out = np.stack(chans, axis=-1)
    if np.issubdtype(x.dtype, np.integer):
        info = np.iinfo(x.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    out = out.astype(x.dtype)
    return out[..., 0] if squeeze else out


def _resize(x, size, interpolation: str):
    if interpolation == "bilinear":
        return _resize_bilinear(x, size)
    if interpolation == "nearest":
        return _resize_nearest(x, size)
    raise ValueError(
        f"interpolation must be 'bilinear' or 'nearest', got {interpolation!r}"
    )


class Resize:
    """Resize to (size, size); bilinear by default (torchvision's filter,
    needed for top-1 parity on real images), ``interpolation="nearest"``
    for the exact-integer path. NOTE: always square — for torchvision's
    ``Resize(int)`` shorter-side semantics use :class:`ResizeShortestEdge`."""

    def __init__(self, size: int, *, interpolation: str = "bilinear"):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, x):
        return _resize(x, self.size, self.interpolation)


class ResizeShortestEdge:
    """torchvision ``Resize(int)`` semantics: scale the *shorter* side to
    ``size``, preserving aspect ratio (bilinear) — the standard ImageNet
    eval preprocessing (Resize(256) → CenterCrop(224)); a square resize
    there distorts every non-square image and breaks top-1 parity."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, x):
        h, w = x.shape[:2]
        if h <= w:
            th, tw = self.size, max(1, int(round(w * self.size / h)))
        else:
            th, tw = max(1, int(round(h * self.size / w))), self.size
        if (th, tw) == (h, w):
            return x
        return _resize_bilinear(x, (th, tw))


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, x):
        h, w = x.shape[:2]
        if h < self.size or w < self.size:
            raise ValueError(
                f"CenterCrop({self.size}) on smaller input {(h, w)}"
            )
        i, j = (h - self.size) // 2, (w - self.size) // 2
        return x[i : i + self.size, j : j + self.size]


class Normalize:
    """(x - mean) / std per channel (expects float input)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, x):
        return (np.asarray(x, np.float32) - self.mean) / self.std


class ToFloat:
    """uint8 [0,255] → float32 [0,1]."""

    def __call__(self, x):
        if x.dtype == np.uint8:
            return x.astype(np.float32) / 255.0
        return np.asarray(x, np.float32)
