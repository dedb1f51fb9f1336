"""The port's loader beyond the thread path (tests/test_torch_data.py):
process workers (order across epochs, an abandoned epoch, one active
iterator, ``close()``, errors and ``worker_init_fn`` on the worker's own
dataset copy), ``staged_iter`` over the native ring, and
``device_prefetch(scan_steps=K)`` against the JAX package's stacking.

Spawned workers unpickle their datasets from the port package and their
init functions from this module, which imports no JAX at its top (the
JAX oracle is imported inside the tests), so a worker never loads JAX.
Process tests spawn two workers each and bound every wait."""

import contextlib
import signal
import sys

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import data as tdata
from tpu_syncbn_torch.runtime import native

T = tdata.transforms


@contextlib.contextmanager
def deadline(seconds: float):
    """Fail the test (instead of hanging the run) if the block takes
    longer than ``seconds``."""
    def expired(signum, frame):
        raise TimeoutError(f"process-worker test still running after {seconds}s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def reseed_worker(wid):
    """Per-worker augmentation seed, on the worker's own dataset copy; and
    proof that the worker runs without JAX."""
    if "jax" in sys.modules:
        raise RuntimeError("a loader worker imported jax")
    tdata.get_worker_info().dataset.transform.reseed(1000 + wid)


def jax_reseed_worker(wid):
    """The same per-worker seed for a JAX-package process worker."""
    from tpu_syncbn import data as jdata

    jdata.get_worker_info().dataset.transform.reseed(1000 + wid)


def failing_init(wid):
    raise ValueError(f"init of worker {wid} refused")


def noisy_dataset(root, n=20):
    """``n`` random images as ``.npy`` files of two classes under ``root``
    (written on the first call), read back through a random crop and flip
    whose draws show which generator made them: port classes and numpy
    only, so a spawned worker unpickles nothing else."""
    import os

    rs = np.random.RandomState(0)
    for i in range(n):
        d = os.path.join(root, f"c{i % 2}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{i:03d}.npy")
        if not os.path.exists(path):
            np.save(path, rs.rand(10, 12, 3).astype(np.float32))
    tf = T.Compose([T.RandomCrop(8, padding=1, seed=0),
                    T.RandomHorizontalFlip(seed=1)])
    return tdata.ImageFolderDataset(str(root), tf, extensions=(".npy",),
                                    loader=np.load)


def same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def synthetic_loader(**kw):
    ds = tdata.SyntheticImageDataset(length=23, shape=(4, 5, 3), num_classes=5, seed=2)
    sampler = tdata.DistributedSampler(23, num_replicas=2, rank=1, shuffle=True, seed=4)
    return tdata.DataLoader(ds, 3, sampler=sampler, **kw), sampler


def test_process_workers_keep_the_order_across_epochs_and_close():
    ref, ref_sampler = synthetic_loader()
    loader, sampler = synthetic_loader(num_workers=2, worker_type="process")
    with deadline(120):
        check_order_abandon_and_close(ref, ref_sampler, loader, sampler)


def check_order_abandon_and_close(ref, ref_sampler, loader, sampler):
    try:
        for epoch in (0, 1):
            sampler.set_epoch(epoch)
            ref_sampler.set_epoch(epoch)
            want = list(ref)
            assert len(want) == len(loader) == 4  # 12 samples, ragged last batch
            same_batches(list(loader), want)
        # abandon an epoch after one batch: the next iteration drops the
        # stale batches still in the pipes and yields its own, in order
        it = iter(loader)
        next(it)
        with pytest.raises(RuntimeError, match="ONE active iterator"):
            next(iter(loader))
        it.close()
        same_batches(list(loader), list(ref))
        procs = list(loader._pool["procs"])
        assert all(p.is_alive() for p in procs)  # persistent across epochs
    finally:
        loader.close()
    assert all(not p.is_alive() for p in procs)
    loader.close()  # idempotent
    tdata.DataLoader(tdata.ArrayDataset(np.arange(4)), 2).close()  # no pool


def test_process_worker_errors_and_init_fn(tmp_path):
    with deadline(180):
        check_errors_and_init_fn(tmp_path)


def check_errors_and_init_fn(tmp_path):
    # worker_init_fn reseeds the worker's own copy: each batch equals the
    # one a generator seeded 1000 + (batch index % 2) draws in order
    ds = noisy_dataset(tmp_path / "npy")
    loader = tdata.DataLoader(ds, 4, num_workers=2, worker_type="process",
                              worker_init_fn=reseed_worker)
    try:
        got = list(loader)
    finally:
        loader.close()
    local = {w: noisy_dataset(tmp_path / "npy") for w in (0, 1)}
    for w, d in local.items():
        d.transform.reseed(1000 + w)
    want = [tdata.default_collate([local[b % 2][i] for i in range(4 * b, 4 * b + 4)])
            for b in range(5)]
    same_batches(got, want)
    assert tdata.get_worker_info() is None  # the parent is no worker

    # a sample that fails to decode raises in the consumer, with the
    # worker's traceback
    for c in ("a", "b"):
        (tmp_path / "jpeg" / c).mkdir(parents=True)
        for i in range(2):
            (tmp_path / "jpeg" / c / f"{i}.jpg").write_bytes(b"not a jpeg")
    bad = tdata.DataLoader(tdata.ImageFolderDataset(str(tmp_path / "jpeg")), 2,
                           num_workers=2, worker_type="process")
    try:
        with pytest.raises(tdata.WorkerError, match="(?s)error in worker 0.*Traceback"):
            list(bad)
    finally:
        bad.close()
    refused = tdata.DataLoader(tdata.ArrayDataset(np.arange(8)), 2, num_workers=2,
                               worker_type="process", worker_init_fn=failing_init)
    try:
        with pytest.raises(tdata.WorkerError, match="(?s)init failed.*refused"):
            list(refused)
    finally:
        refused.close()


def test_loader_checks_its_arguments():
    ds = tdata.ArrayDataset(np.arange(4))
    with pytest.raises(ValueError, match="worker_type"):
        tdata.DataLoader(ds, 2, worker_type="fiber")
    with pytest.raises(ValueError, match="batch_size"):
        tdata.DataLoader(ds, 0)
    with pytest.raises(ValueError, match="num_workers"):
        tdata.DataLoader(ds, 2, num_workers=-1)


def nested_batches(n=6):
    rs = np.random.RandomState(3)
    return [{"image": rs.rand(4, 5, 3).astype(np.float32),
             "meta": (rs.randint(0, 9, (4,)).astype(np.int32),
                      rs.rand(4) > 0.5, np.full((2, 2), i, np.uint8))}
            for i in range(n)]


def flat(batch):
    return [batch["image"], *batch["meta"]]


def test_staged_iter_hands_over_every_batch_through_the_ring():
    if not native.available():
        pytest.skip(f"native library unavailable: {native.load_error()}")
    want = nested_batches()
    got = list(tdata.staged_iter(iter(want), slots=2, slot_mb=1))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == {"image", "meta"} and isinstance(g["meta"], tuple)
        for a, b in zip(flat(g), flat(w)):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
            assert a.flags.writeable  # like every other loader path
    # each batch owns its bytes: later batches do not overwrite earlier ones
    assert np.array_equal(got[0]["image"], want[0]["image"])


def test_staged_iter_bypass_errors_and_abandonment(monkeypatch):
    big = [np.ones((600, 600), np.float32)]  # 1.4 MB, over a 1 MB slot
    got = list(tdata.staged_iter(iter(big + [np.arange(3)]), slots=2, slot_mb=1))
    assert got[0] is big[0] and got[1].tolist() == [0, 1, 2]

    def broken():
        yield np.zeros(2)
        raise KeyError("source failed")

    it = tdata.staged_iter(broken(), slots=2, slot_mb=1)
    assert next(it).tolist() == [0, 0]
    with pytest.raises(KeyError, match="source failed"):
        next(it)
    endless = tdata.staged_iter((np.full(3, i) for i in range(10**9)), slots=2, slot_mb=1)
    assert [next(endless)[0] for _ in range(3)] == [0, 1, 2]
    endless.close()  # stops the producer and frees the ring
    monkeypatch.setattr(native, "available", lambda: False)
    src = nested_batches(2)
    assert all(a is b for a, b in zip(tdata.staged_iter(iter(src)), src))


@pytest.mark.parametrize("k,n", [(1, 5), (3, 7), (3, 6), (4, 2)])
def test_device_prefetch_stacks_like_the_jax_package(k, n):
    from tpu_syncbn.data import loader as jloader

    src = [(np.full((2, 3), i, np.float32), np.arange(2, dtype=np.int32) + i)
           for i in range(n)]
    want = list(jloader.device_prefetch(iter(src), to_device=False, scan_steps=k))
    got = list(tdata.device_prefetch(iter(src), device="cpu", scan_steps=k))
    assert len(got) == len(want) == -(-n // k)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        for g, w in ((gx, wx), (gy, wy)):
            assert tuple(g.shape) == np.shape(w)
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_device_prefetch_chunks_own_their_bytes_and_check_shapes():
    buf = np.zeros(3, np.float32)

    def recycled():  # one buffer, overwritten for every batch
        for i in range(4):
            buf[:] = i
            yield buf

    chunks = list(tdata.device_prefetch(recycled(), device="cpu", scan_steps=2))
    assert [c.tolist() for c in chunks] == [[[0] * 3, [1] * 3], [[2] * 3, [3] * 3]]
    for bad in ([np.zeros(3), np.zeros(4)],
                [np.zeros(3, np.float32), np.zeros(3, np.float64)]):
        with pytest.raises(ValueError, match="static batch shapes and dtypes"):
            list(tdata.device_prefetch(iter(bad), device="cpu", scan_steps=2))
    with pytest.raises(ValueError, match="scan_steps"):
        tdata.device_prefetch(iter([]), device="cpu", scan_steps=0)
