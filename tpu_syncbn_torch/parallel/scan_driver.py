"""Fused multi-step driver — the counterpart of
``tpu_syncbn.parallel.scan_driver``: K optimizer steps captured into ONE
CUDA graph, for any trainer whose step updates its state in place.

The JAX driver compiles ``lax.scan`` over the step body into one program.
On the card the same program is K applications of the step body recorded
into one ``torch.cuda.CUDAGraph``: every call copies the new inputs into
the graph's static buffers and replays it once, so the host pays one
dispatch per K steps instead of every kernel launch of K steps. On the CPU
the same step body runs K times eagerly: that loop is the plain version,
and since the graph records the very function the loop calls, the CPU
tests pin the captured body's arithmetic; only capture and replay are
card-only.

Contract notes:

* The step body ``step_fn(k, batch) -> {name: 0-d tensor}`` updates the
  trainer's state in place (parameters, optimizer state, buffers) and
  returns the step's scalars; they come back stacked along a leading K
  axis. ``k`` is the step's index in the chunk (a Python int, fixed when
  the graph is recorded).
* A captured body must not read a device value on the host, allocate a
  persistent tensor, or replace a state tensor: the graph keeps the
  addresses it recorded. :meth:`ScanSteps.stale` compares them with the
  live state, so a trainer rebuilds a program whose state was replaced
  (a loaded optimizer state) instead of replaying it into freed memory.
* ``stacked=True``: every batch leaf carries a leading K axis and step k
  reads slice k; ``stacked=False``: every step reads the same batch. The
  caller's batch is never written.
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Any, Callable, Sequence

import numpy as np
import torch

#: Programs retained per trainer cache (LRU beyond this): each distinct
#: (n_steps, stacked, batch signature) is its own captured graph.
MAX_CACHED_PROGRAMS = 4

#: Applications of the step body run on a side stream before capture:
#: they build every kernel (nvcc, Triton's JIT, cuDNN's plans) and
#: allocate every lazily allocated buffer outside the graph. The trainer's
#: state is restored after them.
WARMUP_STEPS = 2

#: Every live ProgramCache, weakly held (keyed by id — a dict subclass is
#: unhashable).
_LIVE_CACHES: "weakref.WeakValueDictionary[int, ProgramCache]" = (
    weakref.WeakValueDictionary()
)


def live_cache_bytes() -> int:
    """Summed ``bytes_live`` over every live :class:`ProgramCache` in the
    process (the graph pools the trainers' programs hold)."""
    return sum(cache.bytes_live for cache in list(_LIVE_CACHES.values()))


def _map(fn, tree):
    """``fn`` applied to every array or tensor leaf of a batch (tuples,
    named tuples, lists and dicts); other leaves pass unchanged."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree) -> list:
    out: list = []
    _map(out.append, tree)
    return out


def stack_batches(batches: Sequence[Any]):
    """Stack identically shaped batches (numpy arrays or tensors, in
    tuples, lists or dicts) along a new leading axis — the layout
    :func:`build_scan_steps` steps over with ``stacked=True``. Copies, so
    callers may recycle the source buffers at once."""
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    leaves = [_leaves(b) for b in batches]
    stacked = [torch.stack(ls) if isinstance(ls[0], torch.Tensor) else np.stack(ls)
               for ls in zip(*leaves)]
    it = iter(stacked)
    return _map(lambda _: next(it), batches[0])


def scan_length(batch) -> int:
    """The leading-axis length of a stacked batch (the K of a chunk)."""
    leaves = _leaves(batch)
    if not leaves:
        raise ValueError("batch has no array leaves")
    return int(leaves[0].shape[0])


def _signature(batch) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype)) for t in _leaves(batch))


class ScanSteps:
    """``n_steps`` applications of ``step_fn`` as one callable (see
    :func:`build_scan_steps`). On a CUDA device the first call (or
    :meth:`prepare`) warms the body up and captures the graph;
    ``capture_s`` and ``pool_bytes`` (the device memory the graph's pool
    reserved while it was recorded) describe it."""

    def __init__(self, step_fn, *, n_steps: int, stacked: bool,
                 device: torch.device, state: Callable[[], list]):
        self.step_fn = step_fn
        self.n_steps = n_steps
        self.stacked = stacked
        self.device = device
        self.state = state
        self.graph = None
        self.capture_s = None
        self.pool_bytes = None
        self._static_in = None
        self._static_out = None
        self._ptrs = None
        self._sig = None
        #: collective bytes the K captured steps tallied at the capture:
        #: what each replay moves (``collectives.DispatchWireTally``)
        self.wire_bytes = 0

    def _slice(self, batch, k: int):
        return _map(lambda t: t[k], batch) if self.stacked else batch

    def loop(self, batch) -> dict:
        """The K steps run eagerly, on any device: the plain version of the
        graph (what a call runs on the CPU), for holding a replay against
        on the card."""
        outs = [self.step_fn(k, self._slice(batch, k)) for k in range(self.n_steps)]
        return {name: torch.stack([o[name] for o in outs]) for name in outs[0]}

    def _state_ptrs(self) -> list[int]:
        return [t.data_ptr() for t in self.state()]

    def stale(self) -> bool:
        """True when a state tensor the graph recorded was replaced since
        (its replay would write memory the state no longer uses)."""
        return self._ptrs is not None and self._ptrs != self._state_ptrs()

    def prepare(self, batch, recorder=None) -> "ScanSteps":
        """Capture the graph for batches shaped like ``batch`` (a no-op on
        the CPU). The trainer's state is left as it was. ``recorder``
        (``static_batch -> context manager``, the audit's
        :class:`~tpu_syncbn_torch.audit.contracts.Recorder`) is entered
        around the captured applications alone, inside the capture."""
        if self.device.type != "cuda" or self.graph is not None:
            return self
        dev = self.device
        t0 = time.perf_counter()
        static = _map(lambda t: t.detach().clone(), batch)
        saved = [t.detach().clone() for t in self.state()]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.step_fn(0, self._slice(static, 0))
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(self.state(), saved):
                t.copy_(s)
        del saved
        # what torch.cuda.graph does on entry, done first so the pool's
        # bytes are all that the reservation gains below
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        # thread-local: the staging thread of device_prefetch may allocate
        # and copy on its own stream while the graph is recorded
        from tpu_syncbn_torch.parallel import collectives

        with collectives.capturing() as inventory, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"), \
                (recorder(static) if recorder is not None else contextlib.nullcontext()):
            out = self.loop(static)
        self.wire_bytes = inventory[0]
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self._static_in, self._static_out = graph, static, out
        self._ptrs = self._state_ptrs()
        self._sig = _signature(static)
        self.capture_s = time.perf_counter() - t0
        return self

    def __call__(self, batch) -> dict:
        """Run the K steps on ``batch``; returns ``{name: (K,) tensor}``."""
        if self.device.type != "cuda":
            return self.loop(batch)
        if self.graph is None:
            self.prepare(batch)
        if _signature(batch) != self._sig:
            raise ValueError(
                f"batch shapes {_signature(batch)} differ from the captured "
                f"graph's {self._sig}")
        if self.stale():
            raise RuntimeError(
                "a state tensor the graph recorded was replaced since the "
                "capture; rebuild the program")
        for dst, src in zip(_leaves(self._static_in), _leaves(batch)):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        if self.wire_bytes:
            from tpu_syncbn_torch.parallel import collectives

            collectives.note_replay(self.wire_bytes)
        # clones: the next replay overwrites the static outputs
        return {k: v.clone() for k, v in self._static_out.items()}


def build_scan_steps(
    step_fn: Callable[[int, Any], dict],
    *,
    n_steps: int,
    stacked: bool,
    device: str | torch.device,
    state: Callable[[], list],
) -> ScanSteps:
    """``n_steps`` applications of ``step_fn`` as one callable.

    ``step_fn(k, batch)`` is step k's body: it updates the trainer's state
    in place and returns ``{name: 0-d tensor}``, which the callable
    returns stacked to ``{name: (n_steps,)}``. ``state()`` lists every
    tensor the body updates in place (parameters, buffers, optimizer
    state, the trainer's device scalars): on the card the warm-up steps
    run on a side stream and then these tensors are restored, so the
    warm-up trains nothing; their addresses are recorded, and
    :meth:`ScanSteps.stale` says when one was replaced.

    On a CUDA device the callable captures the ``n_steps`` applications
    into one ``torch.cuda.CUDAGraph`` at its first call and replays it at
    every call, returning clones of the stacked outputs. On the CPU it
    runs the same body ``n_steps`` times eagerly. A step that reads a
    device value on the host cannot be captured: CUDA raises during
    capture."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    return ScanSteps(step_fn, n_steps=n_steps, stacked=stacked,
                     device=torch.device(device), state=state)


class ProgramCache(dict):
    """A size-aware LRU program cache with hit/miss/eviction accounting.

    Plain ``dict`` semantics with two retention bounds applied by
    :func:`cached_program`:

    * ``max_entries`` — at most this many programs live (default
      :data:`MAX_CACHED_PROGRAMS`);
    * ``max_bytes`` — optional device-memory budget: when the summed
      per-program sizes (the ``size_of`` hook of :func:`cached_program`;
      the trainers give a graph's pool bytes) exceed it, the
      least-recently-used programs are evicted first. Entries whose size
      is unknown count ``0`` toward the budget (the entry bound still
      covers them).

    Eviction order is LRU, not FIFO: a hit moves the program to the back
    of the eviction order. When ``name`` is given and telemetry is
    enabled, every event also lands in the registry as the labeled
    ``scan.program_cache.{hits,misses,evictions}{family=<name>}`` counters,
    with the deprecated flat ``<name>.program_cache.*`` mirrors, and every
    build publishes the occupancy gauges (:meth:`_publish_gauges`)."""

    def __init__(self, name: str | None = None, *,
                 max_entries: int | None = None,
                 max_bytes: int | None = None):
        super().__init__()
        self.name = name
        self.max_entries = (MAX_CACHED_PROGRAMS if max_entries is None
                            else int(max_entries))
        if self.max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {self.max_entries}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._sizes: dict = {}  # key -> known size in bytes
        _LIVE_CACHES[id(self)] = self

    def _record(self, event: str) -> None:
        setattr(self, event, getattr(self, event) + 1)
        if self.name is not None:
            from tpu_syncbn_torch.obs import telemetry

            if not telemetry.enabled():
                return
            telemetry.count("scan.program_cache." + event,
                            labels={"family": self.name})
            telemetry.warn_deprecated_name(
                f"{self.name}.program_cache.{event}",
                telemetry.labeled_name("scan.program_cache." + event,
                                       {"family": self.name}),
            )
            telemetry.count(f"{self.name}.program_cache.{event}")

    def _publish_gauges(self) -> None:
        """The labeled ``scan.program_cache.{bytes_live,live,fill_frac}
        {family=<name>}`` occupancy gauges, with the flat
        ``<name>.program_cache.*`` mirrors. Called on the mutation path (a
        build, a budget change); no-op for anonymous caches and when
        telemetry is off."""
        if self.name is None:
            return
        from tpu_syncbn_torch.obs import telemetry

        labels = {"family": self.name}
        bytes_live = self.bytes_live
        telemetry.set_gauge("scan.program_cache.bytes_live", bytes_live,
                            labels=labels)
        telemetry.set_gauge(f"{self.name}.program_cache.bytes_live", bytes_live)
        telemetry.set_gauge("scan.program_cache.live", len(self), labels=labels)
        telemetry.set_gauge(f"{self.name}.program_cache.live", len(self))
        if self.max_bytes:
            fill = round(bytes_live / self.max_bytes, 4)
            telemetry.set_gauge("scan.program_cache.fill_frac", fill,
                                labels=labels)
            telemetry.set_gauge(f"{self.name}.program_cache.fill_frac", fill)

    @property
    def bytes_live(self) -> int:
        """Summed known sizes of live programs."""
        return sum(self._sizes.get(k, 0) for k in self)

    def _touch(self, key) -> None:
        """LRU bump: move ``key`` to the back of the eviction order."""
        value = super().pop(key)
        super().__setitem__(key, value)

    def _evict_over_budget(self) -> None:
        while len(self) > 1 and (
            len(self) > self.max_entries
            or (self.max_bytes is not None and self.bytes_live > self.max_bytes)
        ):
            oldest = next(iter(self))
            super().pop(oldest)
            self._sizes.pop(oldest, None)
            self._record("evictions")

    def pop(self, key, *default):
        self._sizes.pop(key, None)
        return super().pop(key, *default)

    def clear(self) -> None:
        self._sizes.clear()
        super().clear()

    def set_max_bytes(self, max_bytes: int | None) -> int:
        """Retune the byte budget in place, evicting down to it at once;
        returns the bytes still live. ``None`` removes the budget."""
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = max_bytes
        self._evict_over_budget()
        self._publish_gauges()
        return self.bytes_live

    def stats(self) -> dict:
        """Accounting snapshot: programs live, lifetime hits, misses and
        evictions, and the summed known sizes against the budget."""
        return {
            "live": len(self),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "bytes_live": self.bytes_live,
            "max_bytes": self.max_bytes,
        }


def cached_scan_steps(cache: "ProgramCache", key, build: Callable[[], ScanSteps]) -> ScanSteps:
    """:func:`cached_program` for :class:`ScanSteps`: a program whose
    recorded state tensors were replaced since its capture is dropped and
    rebuilt, and each program counts its graph pool toward the cache's
    byte budget."""
    if cache.get(key) is not None and cache[key].stale():
        cache.pop(key)
    return cached_program(cache, key, build, size_of=lambda p: p.pool_bytes)


def cached_program(cache: dict, key, build: Callable[[], Any],
                   *, size_of: Callable[[Any], int | None] | None = None):
    """Bounded program retention shared by the trainers' caches.

    With a :class:`ProgramCache`: size-aware LRU — a hit refreshes the
    entry's eviction priority, a miss builds and then evicts
    least-recently-used entries past ``max_entries`` or (when sizes are
    known via ``size_of``) past ``max_bytes``. The just-built program is
    never evicted. With a plain ``dict``: FIFO at
    :data:`MAX_CACHED_PROGRAMS`. Either way a varying key set pays fresh
    builds — call with a FIXED chunk size.

    ``size_of(program) -> bytes | None`` is consulted once per build;
    ``None`` (or a raising hook) leaves the entry unsized.

    A stored ``None`` counts as a miss and is rebuilt (both branches): a
    ``None`` program never runs, and returning it forever would turn one
    bad build into a permanent failure."""
    if isinstance(cache, ProgramCache):
        if cache.get(key) is not None:
            cache._record("hits")
            cache._touch(key)
            return dict.__getitem__(cache, key)
        cache._record("misses")
        # every miss is a compile-seam event (obs.profiling): counted,
        # timed (on the card: warm-up and the graph's capture),
        # ring-recorded and fed to the recompile-storm detector, which
        # windows per (family, program) — REBUILDING one key is churn,
        # building N distinct keys is a healthy startup. The import and
        # the token stay on the miss path: a hit costs what it always did.
        from tpu_syncbn_torch.obs import profiling

        with profiling.timed_compile(cache.name or "program",
                                     program=f"{hash(key) & 0xFFFFFFFF:08x}"):
            fn = build()
        if key in cache:  # stale stored None: the rebuilt entry goes to
            dict.pop(cache, key)  # the back of the eviction order
            cache._sizes.pop(key, None)
        dict.__setitem__(cache, key, fn)
        if size_of is not None:
            try:
                size = size_of(fn)
            except Exception:
                size = None
            if size is not None and size > 0:
                cache._sizes[key] = int(size)
        cache._evict_over_budget()
        cache._publish_gauges()
        return fn
    fn = cache.get(key)
    if fn is None:
        while len(cache) >= MAX_CACHED_PROGRAMS:
            cache.pop(next(iter(cache)))
        from tpu_syncbn_torch.obs import profiling

        with profiling.timed_compile(
            "program", program=f"{hash(key) & 0xFFFFFFFF:08x}"
        ):
            fn = cache[key] = build()
    return fn
