"""Batch loading and device staging — the main-path subset of
``tpu_syncbn.data.loader``: the threaded, order-preserving
:class:`DataLoader` and :func:`device_prefetch` (pinned host memory,
non-blocking host-to-device copies, ``size`` batches in flight).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from tpu_syncbn_torch.data.dataset import Dataset
from tpu_syncbn_torch.data.sampler import Sampler, SequentialSampler
from tpu_syncbn_torch.runtime.distributed import resolve_device


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples into batched numpy arrays (array, tuple,
    list, dict, namedtuple and scalar structures)."""
    first = samples[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):  # namedtuple
        return type(first)(*(default_collate(list(s)) for s in zip(*samples)))
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(s)) for s in zip(*samples))
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Iterates batches of collated samples.

    With ``num_workers > 0``, worker threads build batches concurrently
    (numpy's generators and decoders release the interpreter lock), at
    most ``num_workers · prefetch_batches`` ahead of the consumer; batches
    come out in sampler order, identical to the single-threaded order."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        *,
        sampler: Sampler | None = None,
        num_workers: int = 0,
        drop_last: bool = False,
        collate_fn: Callable = default_collate,
        prefetch_batches: int = 2,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if num_workers < 0:
            raise ValueError("num_workers must be >= 0")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else SequentialSampler(len(dataset))
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch_batches = max(1, prefetch_batches)

    def _batches_of_indices(self) -> Iterator[list[int]]:
        batch: list[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _load(self, idxs: list[int]):
        return self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers == 0:
            for idxs in self._batches_of_indices():
                yield self._load(idxs)
            return
        pool = ThreadPoolExecutor(self.num_workers,
                                  thread_name_prefix="tpu_syncbn_torch-loader")
        pending: collections.deque = collections.deque()
        indices = self._batches_of_indices()

        def submit() -> None:
            idxs = next(indices, None)
            if idxs is not None:
                pending.append(pool.submit(self._load, idxs))

        try:
            for _ in range(self.num_workers * self.prefetch_batches):
                submit()
            while pending:
                batch = pending.popleft().result()  # re-raises a worker error
                submit()
                yield batch
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


def _map_arrays(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_arrays(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_arrays(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    return fn(tree)


def device_prefetch(iterator, *, size: int = 2,
                    device: str | torch.device | None = "cuda"):
    """Wrap a host-batch iterator with device staging: each numpy array
    goes to pinned host memory and on to ``device`` with a non-blocking
    copy, and ``size`` batches stay in flight, so the next batch's copy
    overlaps the current step. With ``device="cpu"`` the arrays only
    become tensors. Raises at once (not at the first batch) when the
    device is unavailable."""
    if size < 1:
        raise ValueError("size must be >= 1")
    dev = resolve_device(device)

    def put_one(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        return t

    def staged():
        buf: collections.deque = collections.deque()
        it = iter(iterator)
        for batch in it:
            buf.append(_map_arrays(put_one, batch))
            if len(buf) >= size:
                yield buf.popleft()
        while buf:
            yield buf.popleft()

    return staged()
