"""Index-space sharding samplers — the counterpart of
``tpu_syncbn.data.sampler``, index-exact with it: the same numpy
``RandomState((seed + epoch) % 2**32)`` permutation, wraparound padding or
``drop_last`` truncation, and ``indices[rank::num_replicas]`` striding of
``torch.utils.data.DistributedSampler``'s algorithm. The shard comes from
the native library (:mod:`tpu_syncbn_torch.runtime.native`, C++ MT19937)
when it is loaded, and from numpy otherwise: the two are bit-identical.
"""

from __future__ import annotations

import numpy as np

from tpu_syncbn_torch.runtime import distributed as dist
from tpu_syncbn_torch.runtime import native


class Sampler:
    """Iterable of dataset indices (protocol base)."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length: int):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """Uniform shuffle, reseeded per epoch via ``set_epoch`` (like the
    distributed sampler, so single-replica runs reshuffle identically)."""

    def __init__(self, length: int, seed: int = 0):
        self._length = length
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState(self._seed + self._epoch)
        return iter(rng.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class DistributedSampler(Sampler):
    """Shard the index space across replicas:

    * seeded per-epoch permutation when ``shuffle``, else ``arange``;
    * ``drop_last=False`` pads by wraparound so every replica gets
      ``ceil(len/world)`` samples; ``drop_last=True`` truncates to
      ``floor(len/world)·world``;
    * strided subsample ``indices[rank::num_replicas]``;
    * call ``set_epoch`` at each epoch start to reshuffle.

    ``num_replicas``/``rank`` default to the process group's."""

    def __init__(
        self,
        dataset_length: int,
        num_replicas: int | None = None,
        rank: int | None = None,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if num_replicas is None:
            num_replicas = dist.process_count()
        if rank is None:
            rank = dist.process_index()
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f"rank {rank} out of range for num_replicas {num_replicas}"
            )
        self.dataset_length = dataset_length
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_length % num_replicas != 0:
            self.num_samples = dataset_length // num_replicas
        else:
            self.num_samples = -(-dataset_length // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        shard = native.sampler_indices(
            self.dataset_length, self.num_replicas, self.rank, self.seed,
            self.epoch, self.shuffle, self.drop_last)
        if shard is not None:
            if len(shard) != self.num_samples:
                raise RuntimeError("native sampler shard has the wrong length")
            return iter(shard.tolist())
        if self.shuffle:
            rng = np.random.RandomState((self.seed + self.epoch) % 2**32)
            indices = rng.permutation(self.dataset_length)
        else:
            indices = np.arange(self.dataset_length)
        if not self.drop_last:
            padding = self.total_size - len(indices)
            if padding > 0:
                reps = -(-padding // max(len(indices), 1))
                indices = np.concatenate([indices, np.tile(indices, reps)[:padding]])
        else:
            indices = indices[: self.total_size]
        if len(indices) != self.total_size:
            raise RuntimeError("sampler index arithmetic is inconsistent")
        shard = indices[self.rank : self.total_size : self.num_replicas]
        return iter(shard.tolist())

    def __len__(self):
        return self.num_samples
