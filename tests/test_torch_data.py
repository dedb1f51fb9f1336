"""The port's data path against tpu_syncbn.data: DistributedSampler is
index-exact (shuffle, wraparound padding, drop_last, several epochs and
world sizes), SyntheticImageDataset and ArrayDataset are bit-identical,
and the DataLoader yields the same batches in the same order. Exact
equality throughout: the two sides run the same numpy code."""

import itertools

import numpy as np
import pytest
import torch

from tpu_syncbn import data as jdata
from tpu_syncbn_torch import data as tdata


@pytest.mark.parametrize("length,world", [(17, 1), (17, 2), (17, 3), (32, 8),
                                          (5, 8), (1, 2)])
@pytest.mark.parametrize("shuffle,drop_last",
                         list(itertools.product([True, False], [True, False])))
def test_distributed_sampler_is_index_exact(length, world, shuffle, drop_last):
    for rank, epoch, seed in itertools.product(range(world), (0, 1, 5),
                                               (0, 7, 2**32 - 3)):
        kw = dict(num_replicas=world, rank=rank, shuffle=shuffle, seed=seed,
                  drop_last=drop_last)
        js, ts = jdata.DistributedSampler(length, **kw), tdata.DistributedSampler(length, **kw)
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        got = list(ts)
        assert got == list(js), (rank, epoch, seed)
        assert len(ts) == len(js) == len(got)


def test_distributed_sampler_shards_cover_the_dataset():
    shards = [list(tdata.DistributedSampler(17, 4, r, shuffle=True, seed=1))
              for r in range(4)]
    flat = sorted(itertools.chain(*shards))
    assert len(flat) == 20 and set(flat) == set(range(17))  # 3 wraparound pads
    with pytest.raises(ValueError, match="out of range"):
        tdata.DistributedSampler(17, 4, 4)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape,classes", [((32, 32, 3), 10), ((8, 6, 3), 1000)])
def test_synthetic_image_dataset_is_bit_identical(seed, shape, classes):
    kw = dict(length=50, shape=shape, num_classes=classes, seed=seed)
    jd, td = jdata.SyntheticImageDataset(**kw), tdata.SyntheticImageDataset(**kw)
    assert len(td) == len(jd) == 50
    for i in (0, 1, 17, 49):
        (jx, jy), (tx, ty) = jd[i], td[i]
        assert tx.dtype == jx.dtype == np.float32 and tx.shape == shape
        assert np.array_equal(tx, jx) and ty == jy and ty.dtype == jy.dtype
    with pytest.raises(IndexError):
        td[50]


def test_array_dataset_matches():
    a, b = np.arange(12).reshape(6, 2), np.arange(6)
    jd, td = jdata.ArrayDataset(a, b), tdata.ArrayDataset(a, b)
    for i in range(6):
        assert all(np.array_equal(x, y) for x, y in zip(td[i], jd[i]))
    assert np.array_equal(tdata.ArrayDataset(a)[2], a[2])
    with pytest.raises(ValueError, match="leading dimension"):
        tdata.ArrayDataset(a, b[:3])


@pytest.mark.parametrize("num_workers", [0, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_yields_the_jax_batches_in_order(num_workers, drop_last):
    ds_kw = dict(length=23, shape=(4, 4, 3), num_classes=5, seed=2)
    s_kw = dict(num_replicas=2, rank=1, shuffle=True, seed=4)
    jl = jdata.DataLoader(jdata.SyntheticImageDataset(**ds_kw), 5,
                          sampler=jdata.DistributedSampler(23, **s_kw),
                          num_workers=num_workers, drop_last=drop_last)
    tl = tdata.DataLoader(tdata.SyntheticImageDataset(**ds_kw), 5,
                          sampler=tdata.DistributedSampler(23, **s_kw),
                          num_workers=num_workers, drop_last=drop_last)
    jb, tb = list(jl), list(tl)
    assert len(tb) == len(jb) == len(tl) == (2 if drop_last else 3)  # 12 samples
    for (jx, jy), (tx, ty) in zip(jb, tb):
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


def test_dataloader_keeps_a_ragged_last_batch_without_drop_last():
    tl = tdata.DataLoader(tdata.ArrayDataset(np.arange(10)), 4, num_workers=2)
    assert [b.tolist() for b in tl] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert len(tl) == 3


def test_dataloader_reraises_a_worker_error():
    class Bad(tdata.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("bad sample")
            return np.zeros(2)

    with pytest.raises(RuntimeError, match="bad sample"):
        list(tdata.DataLoader(Bad(), 2, num_workers=2))


def test_default_collate_structures():
    samples = [{"x": np.ones(2) * i, "y": (i, np.int32(i))} for i in range(3)]
    out = tdata.default_collate(samples)
    assert out["x"].shape == (3, 2) and out["y"][0].tolist() == [0, 1, 2]


def test_device_prefetch_on_the_cpu_yields_tensors_in_order():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2) + i) for i in range(5)]
    out = list(tdata.device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, (x, y) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), float(i)))
        assert y.tolist() == [i, i + 1]
    with pytest.raises(ValueError, match="size"):
        tdata.device_prefetch(iter(batches), size=0, device="cpu")


def write_cifar(root, per_batch=6, seed=0):
    """A tiny ``cifar-10-batches-py``: CIFAR-10's pickled python layout."""
    import os
    import pickle

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rs = np.random.RandomState(seed)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (per_batch, 3072), dtype=np.uint8),
                         b"labels": rs.randint(0, 10, per_batch).tolist()}, f)
    return str(root)


@pytest.mark.parametrize("train", [True, False])
def test_load_cifar10_reads_the_python_batches_like_jax(tmp_path, train):
    import os

    root = write_cifar(tmp_path)
    jd, td = jdata.load_cifar10(root, train), tdata.load_cifar10(root, train)
    assert len(td) == len(jd) == (30 if train else 6)
    for i in range(len(td)):
        (jx, jy), (tx, ty) = jd[i], td[i]
        assert tx.shape == (32, 32, 3) and tx.dtype == np.float32
        assert np.array_equal(tx, jx) and ty == jy and ty.dtype == jy.dtype
    assert -1.0 <= td.arrays[0].min() and td.arrays[0].max() <= 1.0
    # absent: None, nothing downloaded
    assert tdata.load_cifar10(str(tmp_path / "nowhere"), train) is None
    os.remove(os.path.join(root, "cifar-10-batches-py",
                           "data_batch_3" if train else "test_batch"))
    assert tdata.load_cifar10(root, train) is None is jdata.load_cifar10(root, train)


def test_transform_dataset_and_random_sampler_match():
    base_kw = dict(length=9, shape=(4, 4, 3), num_classes=3, seed=1)
    jd = jdata.TransformDataset(jdata.SyntheticImageDataset(**base_kw),
                                lambda s: (s[0] * 2, s[1]))
    td = tdata.TransformDataset(tdata.SyntheticImageDataset(**base_kw),
                                lambda s: (s[0] * 2, s[1]))
    assert len(td) == len(jd) == 9
    for i in range(9):
        assert np.array_equal(td[i][0], jd[i][0]) and td[i][1] == jd[i][1]
    js, ts = jdata.RandomSampler(13, seed=4), tdata.RandomSampler(13, seed=4)
    for epoch in (0, 1, 7):
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        assert list(ts) == list(js) and sorted(ts) == list(range(13))
    assert len(ts) == 13
