"""Batch loading and device staging — the counterpart of
``tpu_syncbn.data.loader``:

* :class:`DataLoader`: ``num_workers`` threads (default) or persistent
  spawned processes (``worker_type="process"``) build batches
  concurrently; batches come out in sampler order, identical to the
  single-process order, whatever the worker type;
* :func:`staged_iter`: batches handed from a producer thread to the
  consumer through the native staging ring;
* :func:`device_prefetch`: a staging thread pins each batch and copies it
  to the card on a side stream while the current step runs, ``size``
  batches ahead; optionally K batches stacked along a new leading axis.

Telemetry (when enabled, ``obs.telemetry``): per batch a worker loader
observes ``loader.fetch_wait_s`` (the consumer's wait on the workers),
sets ``loader.queue_depth`` (batches already built and waiting: 0 with a
step-bound consumer means the loader is the bottleneck) and counts
``loader.batches``; the K-stacking sets ``loader.stage_depth`` (the
batches in the chunk).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from tpu_syncbn_torch.data.dataset import Dataset
from tpu_syncbn_torch.data.sampler import Sampler, SequentialSampler
from tpu_syncbn_torch.obs import telemetry
from tpu_syncbn_torch.runtime.distributed import resolve_device


class WorkerError(RuntimeError):
    """A dataset/collate error raised inside a worker process, carrying
    the worker's traceback text."""


class WorkerInfo:
    """What :func:`get_worker_info` returns inside a worker process.
    ``dataset`` is the worker's OWN (unpickled) copy: mutate or reseed
    THIS object in a ``worker_init_fn``; a transform captured in the init
    function's closure would be another, unrelated pickled copy."""

    def __init__(self, id: int, num_workers: int, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info: WorkerInfo | None = None


def get_worker_info() -> WorkerInfo | None:
    """Inside a process worker: this worker's :class:`WorkerInfo`; in the
    main process (or thread workers, which share objects): ``None``."""
    return _worker_info


# Process-worker wire protocol:
#   index queue:  ("batch", epoch, seq, idxs) | ("epoch_end", epoch) | ("stop",)
#   out queue:    ("ok", epoch, seq, batch) | ("err", epoch, seq, traceback) |
#                 ("epoch_end", epoch) | ("init_err", traceback)
# Every message carries the live epoch, so the outputs of an abandoned
# iteration are dropped by the next one instead of being yielded.


def _persistent_process_worker(
    wid, num_workers, dataset, collate_fn, worker_init_fn, index_q, out_q
):
    """Body of a ``worker_type="process"`` worker (top level, so spawn can
    pickle it). Lives across epochs: ``epoch_end`` is echoed and the loop
    goes on; ``stop`` (or the parent's exit: daemon) ends it."""
    global _worker_info
    _worker_info = WorkerInfo(id=wid, num_workers=num_workers, dataset=dataset)
    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
    except Exception:
        out_q.put(("init_err", traceback.format_exc()))
        return
    while True:
        item = index_q.get()
        tag = item[0]
        if tag == "stop":
            return
        if tag == "epoch_end":
            out_q.put(("epoch_end", item[1]))
            continue
        _, epoch, seq, idxs = item
        try:
            out_q.put(("ok", epoch, seq, collate_fn([dataset[i] for i in idxs])))
        except Exception:
            out_q.put(("err", epoch, seq, traceback.format_exc()))


def _bounded_put(q, item, stop: threading.Event) -> bool:
    """``put`` that gives up once the consumer has abandoned the iterator,
    so no producer blocks forever on a queue no one drains."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _queue_depth(out_queues) -> int:
    """Batches buffered across the worker out queues; -1 where the
    platform's queue cannot answer (``qsize`` on macOS)."""
    try:
        return sum(q.qsize() for q in out_queues)
    except (NotImplementedError, OSError):
        return -1


def _record_batch(t_resume: float, depth: Callable[[], int]) -> None:
    """The loader's per-batch telemetry (module docstring)."""
    if telemetry.enabled():
        telemetry.observe("loader.fetch_wait_s", time.perf_counter() - t_resume)
        telemetry.set_gauge("loader.queue_depth", depth())
        telemetry.count("loader.batches")


def _consume_ordered(out_queues, dispatch_error, *, epoch, idle_check):
    """Yield batches in dispatch order from per-worker out queues (batch
    ``seq`` went to worker ``seq % n``, so reading the queues round-robin
    restores the sampler's order). ``idle_check(wid)`` may return a final
    drained item or raise for a dead worker."""
    n = len(out_queues)
    done = [False] * n
    seq = 0
    t_resume = time.perf_counter()
    while not all(done):
        wid = seq % n
        if done[wid]:
            seq += 1
            continue
        try:
            item = out_queues[wid].get(timeout=0.05)
        except queue.Empty:
            if dispatch_error:
                raise dispatch_error[0]
            item = idle_check(wid)
            if item is None:
                continue
        tag = item[0]
        if tag == "init_err":
            raise WorkerError(f"worker {wid} init failed:\n{item[1]}")
        if item[1] != epoch:
            continue  # stale output of an abandoned iteration: drop
        if tag == "epoch_end":
            done[wid] = True
            seq += 1
            continue
        _, _, got_seq, payload = item
        if got_seq != seq:
            raise RuntimeError(f"loader order violation: {got_seq} != {seq}")
        if tag == "err":
            raise WorkerError(f"error in worker {wid}:\n{payload}")
        _record_batch(t_resume, lambda: _queue_depth(out_queues))
        yield payload
        t_resume = time.perf_counter()
        seq += 1


def _close_pool(pool: dict) -> None:
    """Stop and reap a process-worker pool. Reached from ``close()``, the
    ``weakref.finalize`` finalizer and interpreter exit, so it is
    idempotent and assumes no queue is still alive."""
    if pool.get("closed"):
        return
    pool["closed"] = True
    for q in pool["index_queues"]:
        try:
            q.put_nowait(("stop",))
        except (queue.Full, ValueError, OSError):
            pass  # full, or already closed
    for p in pool["procs"]:
        p.join(timeout=0.5)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)
    for q in (*pool["index_queues"], *pool["out_queues"]):
        try:
            q.cancel_join_thread()
            q.close()
        except (ValueError, OSError):
            pass


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
    """Iterates batches of collated samples, in sampler order.

    ``worker_type="thread"`` (default): ``num_workers`` threads build
    batches concurrently (PIL's decode and numpy release the interpreter
    lock), at most ``num_workers · prefetch_batches`` ahead.

    ``worker_type="process"``: ``num_workers`` spawned processes, started
    once per loader and kept across epochs; the dataset and ``collate_fn``
    must be picklable, each worker owns a frozen pickled copy of the
    dataset (changes made in the parent after the first iteration are not
    seen), and ``worker_init_fn(worker_id)`` runs once per worker — reseed
    per-worker augmentation there through ``get_worker_info().dataset``.
    ``close()`` (or garbage collection) stops the workers. Spawn's contract
    holds: the script's entry must sit under ``if __name__ == "__main__":``.
    """

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
        worker_type: str = "thread",
        worker_init_fn: Callable[[int], None] | None = None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if num_workers < 0:
            raise ValueError("num_workers must be >= 0")
        if worker_type not in ("thread", "process"):
            raise ValueError(
                f"worker_type must be 'thread' or 'process', got {worker_type!r}"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else SequentialSampler(len(dataset))
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch_batches = max(1, prefetch_batches)
        self.worker_type = worker_type
        self.worker_init_fn = worker_init_fn
        self._pool: dict | None = None
        self._pool_finalizer = None
        self._epoch = 0
        self._iterating = False

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
        if self.worker_type == "process":
            yield from self._iter_processes()
            return
        yield from self._iter_threaded()

    def _iter_threaded(self):
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
                t_resume = time.perf_counter()
                batch = pending.popleft().result()  # re-raises a worker error
                submit()
                _record_batch(t_resume, lambda: sum(f.done() for f in pending))
                yield batch
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    # -- process workers ---------------------------------------------------

    def _ensure_pool(self) -> dict:
        """Spawn the persistent workers once per loader (spawn, not fork:
        the parent holds threads, and CUDA does not survive a fork)."""
        if self._pool is not None:
            return self._pool
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        n = self.num_workers
        pool = {
            "index_queues": [ctx.Queue(maxsize=self.prefetch_batches) for _ in range(n)],
            "out_queues": [ctx.Queue(maxsize=self.prefetch_batches) for _ in range(n)],
        }
        pool["procs"] = [
            ctx.Process(
                target=_persistent_process_worker,
                args=(w, n, self.dataset, self.collate_fn, self.worker_init_fn,
                      pool["index_queues"][w], pool["out_queues"][w]),
                daemon=True,
            )
            for w in range(n)
        ]
        for p in pool["procs"]:
            p.start()
        self._pool = pool
        self._pool_finalizer = weakref.finalize(self, _close_pool, pool)
        return pool

    def close(self) -> None:
        """Stop the process workers. Idempotent, and a no-op for a thread
        loader; a loader dropped without ``close()`` is reaped by the
        finalizer installed when its pool was spawned (also at exit)."""
        if self._pool is not None:
            self._pool_finalizer.detach()
            _close_pool(self._pool)
            self._pool = None
            self._pool_finalizer = None

    def _start_dispatcher(self, index_queues, stop, epoch):
        """Feed (epoch, seq)-tagged index batches round-robin, then an
        ``epoch_end`` per worker. Returns the error box the consumer polls
        (a sampler raising mid-iteration surfaces instead of hanging)."""
        dispatch_error: list[BaseException] = []

        def run():
            seq = 0
            try:
                for idxs in self._batches_of_indices():
                    q = index_queues[seq % len(index_queues)]
                    if not _bounded_put(q, ("batch", epoch, seq, idxs), stop):
                        return
                    seq += 1
            except BaseException as e:
                dispatch_error.append(e)
                return
            for q in index_queues:
                if not _bounded_put(q, ("epoch_end", epoch), stop):
                    return

        threading.Thread(target=run, daemon=True,
                         name="tpu_syncbn_torch-dispatch").start()
        return dispatch_error

    def _iter_processes(self):
        if self._iterating:
            # two iterators would share the pool's queues under different
            # epoch tags and starve each other: refuse instead of hanging
            raise RuntimeError(
                "a process-mode DataLoader supports ONE active iterator; "
                "exhaust or abandon the previous iteration first (or use "
                "worker_type='thread' for concurrent iterators)"
            )
        pool = self._ensure_pool()
        self._epoch += 1
        epoch = self._epoch
        self._iterating = True
        stop = threading.Event()
        dispatch_error = self._start_dispatcher(pool["index_queues"], stop, epoch)

        def idle_check(wid):
            if not pool["procs"][wid].is_alive():
                try:
                    # a worker's last items can still be in the pipe after
                    # it exits: drain before declaring it dead
                    return pool["out_queues"][wid].get_nowait()
                except queue.Empty:
                    raise WorkerError(
                        f"worker process {wid} died (exit code "
                        f"{pool['procs'][wid].exitcode}) without reporting"
                    ) from None
            return None

        try:
            yield from _consume_ordered(pool["out_queues"], dispatch_error,
                                        epoch=epoch, idle_check=idle_check)
        finally:
            stop.set()
            self._iterating = False


# -- batch structures -------------------------------------------------------


def _map_arrays(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_arrays(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_arrays(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    out: list = []
    _map_arrays(out.append, tree)
    return out


def _rebuild(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (in :func:`_leaves` order)."""
    it = iter(leaves)
    return _map_arrays(lambda _: next(it), tree)


# -- native staging ring ----------------------------------------------------


def staged_iter(iterator, *, slots: int = 3, slot_mb: int = 64):
    """Route host batches through the native staging ring
    (``native/csrc/staging.cc``): a producer thread serializes each batch
    into a reusable 64-byte-aligned slot while the consumer takes the
    previous one, without a per-batch allocation on the producer's side.

    Batches are structures of numpy arrays (the loader's output); each
    yielded batch owns its bytes (one copy out of the slot, so the slot is
    recycled at once). A batch larger than ``slot_mb`` passes through
    unchanged, and so does every batch when the native library is not
    available.
    """
    from tpu_syncbn_torch.runtime import native

    if not native.available():
        yield from iterator
        return

    ring = native.StagingRing(slots, slot_mb << 20)
    SENTINEL, ERROR = object(), object()
    meta_q: queue.Queue = queue.Queue(maxsize=slots)
    stop = threading.Event()
    # a permit per slot: the producer enters the native acquire only when
    # a slot is free, so it never blocks inside native code, where stop
    # could not reach it
    free_slots = threading.Semaphore(slots)

    def pack(batch):
        leaves = [np.ascontiguousarray(l) for l in _leaves(batch)]
        total = sum(l.nbytes for l in leaves)
        if total > ring.slot_bytes:
            return None  # too big for a slot: bypass
        while not free_slots.acquire(timeout=0.05):
            if stop.is_set():
                return False
        slot, addr = ring.acquire()  # non-blocking: a permit is held
        view = ring.view(addr, total)
        offset = 0
        metas = []
        for l in leaves:
            view[offset:offset + l.nbytes] = l.reshape(-1).view(np.uint8)
            metas.append((l.dtype.str, l.shape, offset, l.nbytes))
            offset += l.nbytes
        ring.commit(slot, total)
        return batch, metas

    def producer():
        try:
            for batch in iterator:
                packed = pack(batch)
                if packed is False:  # stop requested
                    return
                item = ("bypass", batch) if packed is None else ("slot", packed)
                if not _bounded_put(meta_q, item, stop):
                    return
        except BaseException as e:  # surfaces at the consumer
            _bounded_put(meta_q, (ERROR, e), stop)
            return
        _bounded_put(meta_q, (SENTINEL, None), stop)

    t = threading.Thread(target=producer, daemon=True,
                         name="tpu_syncbn_torch-staging")
    t.start()
    try:
        while True:
            try:
                kind, payload = meta_q.get(timeout=1.0)
            except queue.Empty:
                if t.is_alive():
                    continue
                try:  # the producer may have put its last item and exited
                    kind, payload = meta_q.get_nowait()
                except queue.Empty:
                    raise RuntimeError("staging producer thread died without "
                                       "a sentinel or an error") from None
            if kind is SENTINEL:
                break
            if kind is ERROR:
                raise payload
            if kind == "bypass":
                yield payload
                continue
            template, metas = payload
            slot, addr, size = ring.consume()
            full = ring.view(addr, size)
            leaves = [full[o:o + n].copy().view(np.dtype(d)).reshape(s)
                      for d, s, o, n in metas]
            ring.release(slot)
            free_slots.release()
            yield _rebuild(template, leaves)
    finally:
        stop.set()
        t.join(timeout=5)  # the producer never blocks in native code
        ring.close()


# -- device staging ---------------------------------------------------------


def _stacked(iterator, k: int):
    """Chunks of ``k`` consecutive batches stacked along a new leading
    axis; a final partial chunk (leading axis < k) when the stream ends
    short. Each batch is copied into its slot as it arrives, so the chunk
    owns its bytes even if the source recycles its buffers."""
    it = iter(iterator)
    while True:
        slots = template = None
        count = 0
        for b in it:
            leaves = [np.asarray(l) for l in _leaves(b)]
            if slots is None:
                template = b
                slots = [np.empty((k,) + l.shape, l.dtype) for l in leaves]
            for s, l in zip(slots, leaves):
                if l.shape != s.shape[1:] or l.dtype != s.dtype:
                    raise ValueError(
                        f"scan_steps={k} staging needs static batch shapes "
                        f"and dtypes, got {l.shape}/{l.dtype} after "
                        f"{s.shape[1:]}/{s.dtype}; use drop_last=True"
                    )
                s[count] = l
            count += 1
            if count == k:
                break
        if count == 0:
            return
        if telemetry.enabled():
            telemetry.set_gauge("loader.stage_depth", count)
        yield _rebuild(template, [s if count == k else s[:count] for s in slots])


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _pinned(a) -> torch.Tensor:
    src = _host_tensor(a)
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    out.copy_(src)
    return out


def device_prefetch(iterator, *, size: int = 2,
                    device: str | torch.device | None = "cuda",
                    scan_steps: int = 1):
    """Wrap a host-batch iterator with device staging.

    On the card, a staging thread copies each batch into page-locked host
    memory and issues its host-to-device copy (``non_blocking``) on a
    dedicated CUDA stream, ``size`` batches ahead of the consumer. Before
    a batch is yielded, the consumer's current stream waits for its copy,
    and every tensor of it is recorded on that stream, so the caching
    allocator does not hand its memory to a later copy while the step
    still reads it. Pinning and the copy never run on the training
    thread. With ``device="cpu"`` the arrays only become tensors.

    ``scan_steps=K > 1`` yields K consecutive batches stacked along a new
    leading axis (a final partial chunk when the stream ends short), each
    chunk owning its bytes. Raises at once (not at the first batch) when
    the device is unavailable.
    """
    if size < 1:
        raise ValueError("size must be >= 1")
    if scan_steps < 1:
        raise ValueError("scan_steps must be >= 1")
    dev = resolve_device(device)
    chunks = _stacked(iterator, scan_steps) if scan_steps > 1 else iterator
    if dev.type == "cpu":
        return (_map_arrays(_host_tensor, b) for b in chunks)
    return _cuda_staged(chunks, size, dev)


def _cuda_staged(chunks, size: int, dev: torch.device):
    copy_stream = torch.cuda.Stream(device=dev)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    END, ERROR = object(), object()

    def stage():
        try:
            with torch.cuda.device(dev):
                for batch in chunks:
                    pinned = _map_arrays(_pinned, batch)
                    with torch.cuda.stream(copy_stream):
                        on_dev = _map_arrays(
                            lambda t: t.to(dev, non_blocking=True), pinned)
                        copied = torch.cuda.Event()
                        copied.record(copy_stream)
                    if not _bounded_put(q, (on_dev, copied), stop):
                        return
        except BaseException as e:  # surfaces at the consumer
            _bounded_put(q, (ERROR, e), stop)
            return
        _bounded_put(q, (END, None), stop)

    t = threading.Thread(target=stage, daemon=True,
                         name="tpu_syncbn_torch-device-staging")
    t.start()
    try:
        while True:
            try:
                batch, copied = q.get(timeout=1.0)
            except queue.Empty:
                if t.is_alive():
                    continue
                try:  # the thread may have put its last item and exited
                    batch, copied = q.get_nowait()
                except queue.Empty:
                    raise RuntimeError("device staging thread died without "
                                       "a sentinel or an error") from None
            if batch is END:
                return
            if batch is ERROR:
                raise copied
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(copied)
            _map_arrays(lambda t_: t_.record_stream(consumer), batch)
            yield batch
    finally:
        stop.set()
        t.join(timeout=5)
