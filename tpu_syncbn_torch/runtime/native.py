"""ctypes bindings for the repository's native C++ runtime components —
the counterpart of ``tpu_syncbn.runtime.native``, over the same C ABI and
the same sources (``native/csrc/*.cc``):

* sampler index generation (C++ MT19937 identical to numpy's legacy
  ``RandomState``, so the native shard equals the numpy one bit for bit);
* the staging ring (reusable 64-byte-aligned host slots, producer and
  consumer handing batches over without the interpreter lock);
* a TCP key/value store with counters and a barrier.

``g++`` builds the library at its first use, with the flags of
``native/Makefile``, into ``tpu_syncbn_torch/_build/native/`` (git-ignored)
under a name that carries a hash of the sources and flags, so a stale
build is never loaded. Nothing is written into ``native/``, whose library
belongs to the JAX package. This is host code, not a device kernel: where
the library cannot be built or loaded, :func:`load` returns None and every
consumer takes its numpy path, which gives the same results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG)
CSRC = os.path.join(_REPO_ROOT, "native", "csrc")
SOURCES = ("sampler.cc", "staging.cc", "tcpstore.cc")
#: ``native/Makefile``'s CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-pthread")

#: where :func:`load` builds; a test may point it elsewhere
BUILD_DIR = os.path.join(_PKG, "_build", "native")

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
_load_error: str | None = None


def library_path(build_dir: str) -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"libtpu_syncbn_native-{h.hexdigest()[:16]}.so")


def build(build_dir: str) -> str:
    """Compile the library into ``build_dir`` unless it is there; return
    its path. Raises with the compiler's output if ``g++`` is missing or
    fails."""
    path = library_path(build_dir)
    if os.path.exists(path):
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXXFLAGS, *(os.path.join(CSRC, s) for s in SOURCES),
           *LDFLAGS, "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


def load() -> ctypes.CDLL | None:
    """The loaded library (built first if needed), or None when it cannot
    be built or loaded (:func:`load_error` says why). Tried once per
    process."""
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build(BUILD_DIR))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _load_error = str(e)
            return None
        _configure(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def load_error() -> str | None:
    """Why :func:`load` returned None (None when it has not failed)."""
    return _load_error


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.tsb_permutation.argtypes = [c.c_uint32, c.c_int64, c.POINTER(c.c_int64)]
    lib.tsb_permutation.restype = None
    lib.tsb_sampler_indices.argtypes = [
        c.c_int64, c.c_int32, c.c_int32, c.c_uint32, c.c_int64,
        c.c_int32, c.c_int32, c.POINTER(c.c_int64),
    ]
    lib.tsb_sampler_indices.restype = c.c_int64

    lib.tsb_ring_create.argtypes = [c.c_int32, c.c_int64]
    lib.tsb_ring_create.restype = c.c_void_p
    lib.tsb_ring_destroy.argtypes = [c.c_void_p]
    lib.tsb_ring_destroy.restype = None
    lib.tsb_ring_acquire.argtypes = [c.c_void_p, c.POINTER(c.c_void_p)]
    lib.tsb_ring_acquire.restype = c.c_int64
    lib.tsb_ring_commit.argtypes = [c.c_void_p, c.c_int64, c.c_int64]
    lib.tsb_ring_commit.restype = None
    lib.tsb_ring_consume.argtypes = [
        c.c_void_p, c.POINTER(c.c_void_p), c.POINTER(c.c_int64)
    ]
    lib.tsb_ring_consume.restype = c.c_int64
    lib.tsb_ring_release.argtypes = [c.c_void_p, c.c_int64]
    lib.tsb_ring_release.restype = None
    lib.tsb_ring_slot_bytes.argtypes = [c.c_void_p]
    lib.tsb_ring_slot_bytes.restype = c.c_int64

    lib.tsb_store_server_start.argtypes = [c.c_uint16, c.POINTER(c.c_uint16)]
    lib.tsb_store_server_start.restype = c.c_void_p
    lib.tsb_store_server_stop.argtypes = [c.c_void_p]
    lib.tsb_store_server_stop.restype = None
    lib.tsb_store_connect.argtypes = [c.c_char_p, c.c_uint16]
    lib.tsb_store_connect.restype = c.c_int32
    lib.tsb_store_close.argtypes = [c.c_int32]
    lib.tsb_store_close.restype = None
    lib.tsb_store_set.argtypes = [
        c.c_int32, c.c_char_p, c.POINTER(c.c_uint8), c.c_uint32
    ]
    lib.tsb_store_set.restype = c.c_int32
    lib.tsb_store_get.argtypes = [
        c.c_int32, c.c_char_p, c.POINTER(c.c_uint8), c.c_int64
    ]
    lib.tsb_store_get.restype = c.c_int64
    lib.tsb_store_add.argtypes = [c.c_int32, c.c_char_p, c.c_int64]
    lib.tsb_store_add.restype = c.c_int64


# -- sampler --------------------------------------------------------------


def permutation(seed: int, n: int) -> np.ndarray | None:
    """numpy ``RandomState(seed).permutation(n)`` computed natively
    (bit-identical). An int64 array, or None without the library."""
    lib = load()
    if lib is None:
        return None
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    out = np.empty(n, dtype=np.int64)
    lib.tsb_permutation(
        seed & 0xFFFFFFFF, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    )
    return out


def sampler_indices(length, num_replicas, rank, seed, epoch, shuffle,
                    drop_last) -> np.ndarray | None:
    """One replica's DistributedSampler shard for ``epoch``, computed
    natively; None without the library."""
    lib = load()
    if lib is None:
        return None
    if length < 0 or num_replicas < 1:
        raise ValueError("invalid sampler arguments")
    if drop_last and length % num_replicas != 0:
        num = length // num_replicas
    else:
        num = -(-length // num_replicas)
    out = np.empty(max(num, 1), dtype=np.int64)
    written = lib.tsb_sampler_indices(
        length, num_replicas, rank, seed & 0xFFFFFFFF, epoch,
        1 if shuffle else 0, 1 if drop_last else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if written < 0:
        raise ValueError("invalid sampler arguments")
    return out[:written]


# -- staging ring ---------------------------------------------------------


class StagingRing:
    """Reusable 64-byte-aligned host staging slots. Producers
    ``acquire``/``commit``; the consumer ``consume``\\ s and ``release``\\ s
    in FIFO order; a slot is viewable as a numpy array without a copy."""

    def __init__(self, n_slots: int, slot_bytes: int):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {load_error()}")
        self._lib = lib
        self._ring = lib.tsb_ring_create(n_slots, slot_bytes)
        if not self._ring:
            raise MemoryError("ring allocation failed")
        self.slot_bytes = slot_bytes

    def acquire(self) -> tuple[int, int]:
        """Block until a slot is free; ``(slot, address)``."""
        buf = ctypes.c_void_p()
        slot = self._lib.tsb_ring_acquire(self._ring, ctypes.byref(buf))
        return slot, buf.value

    def commit(self, slot: int, size: int) -> None:
        if not 0 <= size <= self.slot_bytes:
            raise ValueError(f"size {size} outside a slot of {self.slot_bytes} bytes")
        self._lib.tsb_ring_commit(self._ring, slot, size)

    def consume(self) -> tuple[int, int, int]:
        """Block until the next slot is ready; ``(slot, address, size)``."""
        buf = ctypes.c_void_p()
        size = ctypes.c_int64()
        slot = self._lib.tsb_ring_consume(
            self._ring, ctypes.byref(buf), ctypes.byref(size)
        )
        return slot, buf.value, size.value

    def release(self, slot: int) -> None:
        self._lib.tsb_ring_release(self._ring, slot)

    def view(self, addr: int, nbytes: int) -> np.ndarray:
        """A uint8 numpy view of ``nbytes`` of a slot (no copy)."""
        if not 0 <= nbytes <= self.slot_bytes:
            raise ValueError(f"{nbytes} bytes outside a slot of {self.slot_bytes}")
        return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(addr))

    def close(self) -> None:
        if self._ring:
            self._lib.tsb_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# -- TCP store ------------------------------------------------------------


class TCPStoreServer:
    """A key/value store server (rank 0's side of a rendezvous);
    ``port=0`` binds a free port, read back as ``.port``."""

    def __init__(self, port: int = 0):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {load_error()}")
        self._lib = lib
        out_port = ctypes.c_uint16()
        self._handle = lib.tsb_store_server_start(port, ctypes.byref(out_port))
        if not self._handle:
            raise OSError(f"could not bind store server on port {port}")
        self.port = out_port.value

    def stop(self) -> None:
        if self._handle:
            self._lib.tsb_store_server_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class TCPStoreClient:
    """Client of :class:`TCPStoreServer`: ``set``, blocking ``get``,
    ``add`` on counters, and a barrier built from them."""

    def __init__(self, host: str, port: int):
        lib = load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {load_error()}")
        self._lib = lib
        self._fd = lib.tsb_store_connect(host.encode(), port)
        if self._fd < 0:
            raise ConnectionError(f"could not connect to {host}:{port}")

    def set(self, key: str, value: bytes) -> None:
        if self._lib.tsb_store_set(
            self._fd, key.encode(),
            (ctypes.c_uint8 * len(value)).from_buffer_copy(value) if value
            else None,
            len(value),
        ) != 0:
            raise ConnectionError("set failed")

    def get(self, key: str, max_bytes: int = 1 << 20) -> bytes:
        """The value of ``key``, waiting until some client sets it."""
        buf = (ctypes.c_uint8 * max_bytes)()
        n = self._lib.tsb_store_get(self._fd, key.encode(), buf, max_bytes)
        if n < 0:
            raise ConnectionError("get failed")
        if n > max_bytes:
            raise ValueError(
                f"value for {key!r} is {n} bytes, larger than max_bytes="
                f"{max_bytes}; pass a bigger max_bytes"
            )
        return bytes(buf[:n])

    def add(self, key: str, delta: int) -> int:
        result = self._lib.tsb_store_add(self._fd, key.encode(), delta)
        if result == -(2**63):
            raise ConnectionError("add failed")
        return result

    def barrier(self, name: str, world: int) -> None:
        """Block until all ``world`` participants have arrived."""
        arrived = self.add(f"__barrier__{name}", 1)
        if arrived > world:
            raise RuntimeError(f"barrier {name!r} oversubscribed: {arrived}>{world}")
        if arrived == world:
            self.set(f"__barrier_done__{name}", b"1")
        else:
            self.get(f"__barrier_done__{name}")

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.tsb_store_close(self._fd)
            self._fd = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
