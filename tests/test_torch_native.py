"""The port's native bindings (tpu_syncbn_torch.runtime.native) over the
repository's C++ sources, built by the test into its own directory:
MT19937 permutations and DistributedSampler shards bit-identical with
numpy and with the JAX package's sampler, the staging ring, the TCP store,
and the numpy fallback when no compiler is there. Mirrors
tests/test_native.py."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from tpu_syncbn.data.sampler import DistributedSampler as JaxSampler
from tpu_syncbn_torch.data import DistributedSampler
from tpu_syncbn_torch.runtime import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The library built into a fresh directory, loaded as the module's
    library for the tests of this file; the module's state is restored
    after them. Skips on a machine without a C++ compiler, where the
    numpy path is what runs (the fallback test below)."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler: the native library cannot be built")
    build_dir = str(tmp_path_factory.mktemp("native_build"))
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", build_dir)
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_load_error", None)
        assert native.available(), native.load_error()
        built = os.listdir(build_dir)
        assert len(built) == 1 and built[0].startswith("libtpu_syncbn_native-")
        assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before
        yield native.load()


def numpy_shard(length, world, rank, seed, epoch, shuffle, drop_last):
    """The sampler's numpy path, written out (torch's algorithm)."""
    if shuffle:
        indices = np.random.RandomState((seed + epoch) % 2**32).permutation(length)
    else:
        indices = np.arange(length)
    num = length // world if drop_last and length % world else -(-length // world)
    total = num * world
    if not drop_last and total > length:
        pad = total - length
        indices = np.concatenate([indices, np.tile(indices, -(-pad // length))[:pad]])
    return indices[:total][rank:total:world]


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**32 - 1])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 10_000])
def test_permutation_bit_identical_to_numpy(lib, seed, n):
    ours = native.permutation(seed, n)
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(ours, np.random.RandomState(seed).permutation(n))


@pytest.mark.parametrize("length,world,drop_last,shuffle", [
    (100, 4, False, True),
    (101, 4, True, True),
    (101, 4, False, False),
    (7, 8, False, True),
    (64, 2, True, False),
    (1, 3, False, True),
])
def test_sampler_indices_match_numpy_and_the_jax_sampler(lib, length, world,
                                                         drop_last, shuffle):
    for rank in range(world):
        for epoch, seed in ((0, 5), (3, 5), (2, 2**32 - 1)):
            kw = dict(shuffle=shuffle, seed=seed, drop_last=drop_last)
            got = native.sampler_indices(length, world, rank, epoch=epoch, **kw)
            np.testing.assert_array_equal(
                got, numpy_shard(length, world, rank, seed, epoch, shuffle, drop_last))
            ours, theirs = DistributedSampler(length, world, rank, **kw), \
                JaxSampler(length, world, rank, **kw)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == got.tolist() == list(theirs)


def test_invalid_sampler_arguments(lib):
    for args in ((10, 2, 5), (10, 0, 0), (-1, 2, 0)):
        with pytest.raises(ValueError, match="invalid sampler arguments"):
            native.sampler_indices(*args, seed=0, epoch=0, shuffle=True,
                                   drop_last=False)


def test_without_a_compiler_the_sampler_takes_numpy(tmp_path, monkeypatch):
    """No g++: load() fails once, says why, and the sampler's numpy path
    gives the same shard."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setenv("CXX", "no-such-compiler-tpu-syncbn")
    assert not native.available() and "no C++ compiler" in native.load_error()
    assert native.permutation(0, 4) is None
    assert native.sampler_indices(9, 2, 1, 0, 0, True, False) is None
    assert os.listdir(tmp_path) == []
    s = DistributedSampler(101, 4, 1, shuffle=True, seed=7)
    s.set_epoch(2)
    assert list(s) == numpy_shard(101, 4, 1, 7, 2, True, False).tolist()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.StagingRing(2, 64)


def test_staging_ring_roundtrip_threaded(lib):
    ring = native.StagingRing(n_slots=3, slot_bytes=1024)
    payloads = [np.random.RandomState(i).bytes(100 + i) for i in range(20)]

    def producer():
        for p in payloads:
            slot, addr = ring.acquire()
            ring.view(addr, len(p))[:] = np.frombuffer(p, dtype=np.uint8)
            ring.commit(slot, len(p))

    t = threading.Thread(target=producer)
    t.start()
    got = []
    for _ in payloads:
        slot, addr, size = ring.consume()
        got.append(bytes(ring.view(addr, size)))
        ring.release(slot)
    t.join(timeout=10)
    assert not t.is_alive() and got == payloads
    ring.close()
    ring.close()  # idempotent


def test_staging_ring_alignment_and_bounds(lib):
    ring = native.StagingRing(n_slots=2, slot_bytes=256)
    slot, addr = ring.acquire()
    assert addr % 64 == 0
    with pytest.raises(ValueError, match="outside a slot"):
        ring.view(addr, 257)
    with pytest.raises(ValueError, match="outside a slot"):
        ring.commit(slot, 257)
    ring.commit(slot, 1)
    ring.close()


def test_staging_ring_two_producers(lib):
    ring = native.StagingRing(n_slots=2, slot_bytes=64)
    n_each = 30

    def producer(tag):
        for _ in range(n_each):
            slot, addr = ring.acquire()
            ring.view(addr, 1)[0] = tag
            ring.commit(slot, 1)

    ts = [threading.Thread(target=producer, args=(t,)) for t in (1, 2)]
    for t in ts:
        t.start()
    seen = []
    for _ in range(2 * n_each):
        slot, addr, size = ring.consume()
        seen.append(int(ring.view(addr, 1)[0]))
        ring.release(slot)
    for t in ts:
        t.join(timeout=5)
        assert not t.is_alive()
    assert sorted(seen) == [1] * n_each + [2] * n_each
    ring.close()


def test_tcp_store_set_get_add(lib):
    server = native.TCPStoreServer()
    try:
        c1 = native.TCPStoreClient("127.0.0.1", server.port)
        c2 = native.TCPStoreClient("127.0.0.1", server.port)
        c1.set("addr", b"10.0.0.1:1234")
        assert c2.get("addr") == b"10.0.0.1:1234"
        c1.set("empty", b"")
        assert c2.get("empty") == b""
        assert c1.add("count", 2) == 2
        assert c2.add("count", 3) == 5
        assert c1.get("count") == b"5"
        c1.set("big", b"x" * 100)
        with pytest.raises(ValueError, match="larger than max_bytes"):
            c2.get("big", max_bytes=10)
        c1.close()
        c2.close()
    finally:
        server.stop()


def test_tcp_store_blocking_get_and_barrier(lib):
    server = native.TCPStoreServer()
    try:
        result = {}

        def waiter():
            c = native.TCPStoreClient("127.0.0.1", server.port)
            result["value"] = c.get("late-key")
            c.close()

        t = threading.Thread(target=waiter)
        t.start()
        t.join(timeout=0.3)
        assert t.is_alive()  # blocked until the key is set
        setter = native.TCPStoreClient("127.0.0.1", server.port)
        setter.set("late-key", b"now")
        t.join(timeout=5)
        assert not t.is_alive() and result["value"] == b"now"
        setter.close()

        world, arrived = 4, []
        lock = threading.Lock()

        def participant(i):
            c = native.TCPStoreClient("127.0.0.1", server.port)
            c.barrier("epoch0", world)
            with lock:
                arrived.append(i)
            c.close()

        ts = [threading.Thread(target=participant, args=(i,)) for i in range(world)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert sorted(arrived) == list(range(world))
        c = native.TCPStoreClient("127.0.0.1", server.port)
        with pytest.raises(RuntimeError, match="oversubscribed"):
            c.barrier("epoch0", world)
        c.close()
    finally:
        server.stop()


def test_server_stop_with_a_live_connection_is_prompt(lib):
    server = native.TCPStoreServer()
    c = native.TCPStoreClient("127.0.0.1", server.port)
    c.set("k", b"v")
    t0 = time.monotonic()
    server.stop()
    assert time.monotonic() - t0 < 2
    server.stop()  # idempotent
    c.close()
