"""Bucketed inference engine: the serving-side execution core — the
counterpart of ``tpu_syncbn.serve.engine``.

Training ends with a module in training mode whose BatchNorm layers hold
running statistics. Serving needs the opposite arrangement: a copy of
that module pinned in eval mode, so BatchNorm normalizes with the running
statistics (no collective, so every replica serves alone), and a small,
*fixed* set of programs, so request traffic never waits on a build.

:class:`InferenceEngine` owns that arrangement:

* **shape buckets** — incoming batches are padded up to the nearest
  configured bucket size, so the program cache sees a handful of shapes
  whatever sizes clients send. The engine serves on its rank's one
  device, so the world buckets round to is 1;
* **one CUDA graph per bucket** — on the card each bucket's eval forward
  is run once eagerly on a side stream (cuDNN's algorithm choice and each
  kernel's first, lazy load happen there, before any request) and then
  captured into a ``torch.cuda.CUDAGraph`` with static input and output
  buffers; a request is a copy-in, one replay and a copy-out. The JAX
  engine runs an AOT-compiled XLA program per bucket instead. On a CPU
  tensor a "program" is the eager eval forward under ``torch.no_grad()``,
  built, counted and cached the same way;
* **size-aware LRU program retention** — programs are cached through
  :func:`tpu_syncbn_torch.parallel.scan_driver.cached_program` in a
  :class:`~tpu_syncbn_torch.parallel.scan_driver.ProgramCache`: at most
  :data:`~tpu_syncbn_torch.parallel.scan_driver.MAX_CACHED_PROGRAMS` live
  (and, with ``program_cache_bytes``, at most that many bytes of graph
  pools, measured as the allocator's reserved-bytes rise across each
  capture); evicting a program drops its graph, its pool and its static
  buffers;
* **one live weight set** — every graph records the addresses of the
  engine's parameters and buffers, so :meth:`InferenceEngine.swap_params`
  copies new values *into* them (never replaces them) and keeps the
  outgoing values as a device copy, the rollback target: a swap reuses
  every captured graph, and a batch in flight finishes on the version it
  started on.

The request-coalescing half (queueing, admission policy, backpressure,
drain) lives in :mod:`tpu_syncbn_torch.serve.batcher`.
"""

from __future__ import annotations

import copy
import gc
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from tpu_syncbn_torch.mesh_axes import DATA_AXIS

__all__ = ["InferenceEngine", "VersionSkewError"]


class VersionSkewError(ValueError):
    """A proposed weight swap's parameters do not match the serving
    structure (names, shapes or dtypes) — the publisher is running a
    different model schema than this engine. Rejected *before* any
    serving state is touched: the captured bucket graphs read the current
    tensors, so a skewed swap could never reuse them."""


# -- batch trees: numpy arrays, or dicts, tuples and lists of them ---------
# Dicts are walked in sorted key order, as JAX's tree_util walks them, so
# two batches whose dicts differ only in insertion order have the same
# leaf order and the same program key.


def _flatten(tree) -> tuple[list, Any]:
    """The leaves of a batch tree in order, and its hashable structure
    (containers and dict keys), from one traversal."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return (dict, tuple((k, walk(t[k])) for k in sorted(t)))
        if isinstance(t, (tuple, list)):
            return (type(t), tuple(walk(x) for x in t))
        leaves.append(t)
        return None

    structure = walk(tree)
    return leaves, structure


def tree_leaves(tree) -> list:
    """The array leaves of a batch tree, in order (dicts by sorted key)."""
    return _flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (which must share its structure; ``ValueError`` otherwise),
    rebuilt in ``tree``'s structure (dicts by sorted key)."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys() for r in rest):
            raise ValueError("batch trees differ in structure (dict keys)")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        if any(type(r) is not type(tree) or len(r) != len(tree) for r in rest):
            raise ValueError("batch trees differ in structure (sequences)")
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


def _struct_key(tree):
    """Hashable program key of a batch tree: its structure, and each
    leaf's shape beyond the batch axis and dtype in leaf order."""
    leaves, structure = _flatten(tree)
    return structure, tuple(
        (tuple(np.shape(l)[1:]), str(np.asarray(l).dtype)) for l in leaves)


def _leading_dim(batch) -> int:
    """The (validated) shared leading-axis length of a batch tree."""
    leaves = tree_leaves(batch)
    if not leaves:
        raise ValueError("batch tree has no array leaves")
    ns = {int(np.shape(l)[0]) if np.ndim(l) else None for l in leaves}
    if len(ns) != 1 or None in ns:
        raise ValueError(
            f"batch leaves disagree on the leading (batch) axis: {ns}"
        )
    return ns.pop()


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros((0,), np_dtype)).dtype


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bfloat16 (numpy has none) widens to float32,
    which holds every bfloat16 value exactly."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class _Program:
    """One bucket's eval forward for one batch structure.

    On the CPU, :meth:`run` pads the batch and runs the eager forward. On
    the card, the constructor allocates the static input buffers and a
    page-locked staging buffer a leaf, runs the forward once eagerly on a
    side stream, then captures it (``capture_error_mode="thread_local"``:
    a sampler, recorder or collector thread may make CUDA calls
    meanwhile); ``capture_s`` and ``pool_bytes`` (the reserved-bytes rise
    across the capture) describe it. :meth:`run` stages the rows into the
    page-locked buffers, copies them in on the engine's stream, replays
    the graph, copies the outputs out into page-locked buffers and
    returns them as numpy with the padding sliced off."""

    def __init__(self, engine: "InferenceEngine", bucket: int, batch):
        self.bucket = bucket
        self.graph = None
        self.capture_s = None
        self.pool_bytes = None
        if engine.device.type == "cuda":
            self._capture(engine, batch)

    def _capture(self, engine, batch) -> None:
        dev, b = engine.device, self.bucket
        t0 = time.perf_counter()
        leaves = [np.asarray(l) for l in tree_leaves(batch)]
        specs = [((b,) + l.shape[1:], _torch_dtype(l.dtype)) for l in leaves]
        self.staging = [torch.zeros(s, dtype=d, pin_memory=True) for s, d in specs]
        self.static_in = [torch.zeros(s, dtype=d, device=dev) for s, d in specs]
        it = iter(self.static_in)
        static_batch = tree_map(lambda _: next(it), batch)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad():
            engine._forward(static_batch)
        torch.cuda.current_stream(dev).wait_stream(side)
        # what torch.cuda.graph does on entry, done first so the pool's
        # bytes are all that the reservation gains below
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = engine._forward(static_batch)
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.static_out = graph, out
        self.out_host = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True), out)
        self.capture_s = time.perf_counter() - t0

    def run(self, engine, batch, n: int):
        """Outputs for the ``n`` rows of ``batch`` (host numpy), called
        under the engine's run lock."""
        pad = self.bucket - n
        if self.graph is None:
            def pad_leaf(l):
                a = np.asarray(l)
                if pad == 0:
                    return torch.from_numpy(a)
                return torch.from_numpy(np.concatenate(
                    [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0))

            with torch.no_grad():
                out = engine._forward(tree_map(pad_leaf, batch))
            return tree_map(lambda t: _to_host(t.detach())[:n], out)
        for host, leaf in zip(self.staging, tree_leaves(batch)):
            host[:n].copy_(torch.from_numpy(np.asarray(leaf)))
            host[n:].zero_()
        stream = engine._stream
        with torch.cuda.stream(stream):
            for host, dev_t in zip(self.staging, self.static_in):
                dev_t.copy_(host, non_blocking=True)
            self.graph.replay()
            tree_map(lambda h, d: h.copy_(d, non_blocking=True),
                     self.out_host, self.static_out)
        stream.synchronize()
        # copies: the next call overwrites the page-locked outputs
        return tree_map(lambda h: _to_host(h)[:n].copy(), self.out_host)


class InferenceEngine:
    """Throughput-oriented eval executor for a trained model.

    ``model`` is a trained module (typically ``convert_sync_batchnorm``-
    converted, then trained through ``DataParallel``); the engine serves a
    deep copy of it in eval mode, so the caller's module (a trainer's,
    still training) is never touched and no captured graph aliases a
    tensor the trainer updates. Build one from a live trainer with
    :meth:`from_trainer`. ``device`` (default the card) must hold the
    model; ``"cpu"`` serves the eager forward on the CPU.

    ``apply_fn(model, batch) -> outputs`` is the eval forward (default:
    ``model(batch)``); ``batch`` is the request's tree with each numpy
    leaf as a tensor on ``device``, and every output leaf carries the
    batch axis leading. Requests and answers are host numpy (bfloat16
    outputs come back as float32, which holds them exactly).

    ``buckets`` are batch sizes; each is rounded up to a multiple of the
    world, which is 1: the engine serves on its rank's device alone (eval
    BatchNorm has no collective). :meth:`predict` pads a request batch up
    to the smallest bucket that fits, runs that bucket's program, and
    slices the padding back off; batches larger than the biggest bucket
    are chunked through it.

    ``layout`` is accepted for the trainers' layouts: a replicated or
    ``SpecLayout.zero()`` layout serves as is (the port's module holds
    its full parameters between steps under ZeRO too), a param-sharding
    FSDP layout raises ``NotImplementedError`` (the engine's sharded
    store is ROADMAP A.12c: in a CUDA graph a gathered tree would live in
    the graph's pool for the graph's whole life, so keeping flat shards
    saves nothing until it is designed differently).

    Telemetry (``TPU_SYNCBN_TELEMETRY`` / bench force-enable):
    ``serve.infer_s`` per-program-call histogram, ``serve.compiles``
    counter + ``serve.compile_s`` histogram, the ``serve.inflight`` level
    gauge and a ``serve.infer`` trace span per call; with ``model_label``
    also their ``{model="..."}`` twins.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        device: str | torch.device | None = "cuda",
        layout=None,
        apply_fn: Callable[[Any, Any], Any] | None = None,
        buckets: Sequence[int] = (8, 32, 128),
        program_cache_bytes: int | None = None,
        model_label: str | None = None,
    ):
        from tpu_syncbn_torch.parallel import scan_driver
        from tpu_syncbn_torch.runtime.distributed import resolve_device

        if layout is not None and layout.param_shard_axis not in (None, DATA_AXIS):
            raise NotImplementedError(
                "InferenceEngine: a param-sharding layout "
                f"(param_shard_axis={layout.param_shard_axis!r}) needs the "
                "engine's sharded store, which is not ported yet (ROADMAP A.12c)")
        self.layout = layout
        self.device = resolve_device(device)
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if t is not None and t.device != self.device:
                raise ValueError(
                    f"{name} lives on {t.device}, not on the engine's device "
                    f"{self.device}; move the model first")
        self.world = 1
        self._apply_fn = apply_fn if apply_fn is not None else (
            lambda m, b: m(b)
        )
        if not buckets:
            raise ValueError("need at least one bucket size")
        norm = sorted({
            int(b) + (-int(b)) % self.world for b in buckets if int(b) >= 1
        })
        if not norm:
            raise ValueError(f"no usable bucket sizes in {buckets!r}")
        #: normalized bucket sizes (ascending)
        self.buckets: tuple[int, ...] = tuple(norm)

        # the engine's own copy (a parameter's copy leaves its gradient
        # behind), in eval mode ONCE: BN on running stats. Process groups
        # are shared, not copied: eval BN never uses them.
        memo = {id(m.process_group): m.process_group for m in model.modules()
                if getattr(m, "process_group", None) is not None}
        self.model = copy.deepcopy(model, memo)
        self.model.eval()
        self.model.requires_grad_(False)
        if self.device.type == "cuda":
            # the copy's kernels ran on the current stream; the engine's
            # own stream reads the copy
            torch.cuda.synchronize(self.device)
        self._version = 0
        #: (version, params, buffers) device copies of the outgoing weights
        self._previous: tuple[int, dict, dict] | None = None
        # held from a call's copy-in to its copy-out, and by a swap: a
        # program's static buffers and the live weights have one user
        self._run_lock = threading.Lock()
        self._build_lock = threading.Lock()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # size-aware LRU; hit/miss/eviction accounted so the bucket-program
        # cache hit rate is measurable
        self._programs = scan_driver.ProgramCache(
            name="serve", max_bytes=program_cache_bytes
        )
        self._programs_compiled = 0
        #: optional ``model`` label: the engine also publishes labeled
        #: twins of its serve.* series (multi-model tenancy attribution)
        self.model_label = model_label
        self._model_labels = (
            {"model": model_label} if model_label else None
        )

    # -- versioned state ---------------------------------------------------

    @property
    def version(self) -> int:
        """The weight version new requests run on (0 = as-constructed)."""
        return self._version

    @property
    def previous_version(self) -> int | None:
        """The retained rollback target's version, or None."""
        prev = self._previous
        return prev[0] if prev is not None else None

    def _live(self) -> tuple[dict, dict]:
        return (dict(self.model.named_parameters()),
                {n: b for n, b in self.model.named_buffers() if b is not None})

    @staticmethod
    def _specs(tree: dict) -> dict:
        def dtype(v):
            return v.dtype if isinstance(v, torch.Tensor) else _torch_dtype(np.asarray(v).dtype)

        return {n: (tuple(v.shape), dtype(v)) for n, v in tree.items()}

    def param_template(self) -> dict:
        """The serving parameters by name (the live tensors, detached) —
        the checkpoint/publication template."""
        return {n: p.detach() for n, p in self.model.named_parameters()}

    def params_nbytes(self) -> int:
        """Device bytes of the serving state (parameters + buffers), live
        and retained for rollback — what a swap's double-buffer holds."""
        params, rest = self._live()
        total = sum(t.nbytes for t in params.values()) + sum(t.nbytes for t in rest.values())
        if self._previous is not None:
            _, pp, pr = self._previous
            total += sum(t.nbytes for t in pp.values()) + sum(t.nbytes for t in pr.values())
        return total

    def _copy_in(self, live: dict, new: dict) -> None:
        with torch.no_grad():
            for n, t in live.items():
                v = new[n]
                v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                t.copy_(v, non_blocking=True)

    @staticmethod
    def _clone(tree: dict) -> dict:
        return {n: t.detach().clone() for n, t in tree.items()}

    def _swap_in(self, params: dict, rest: dict | None) -> None:
        """Copy ``params`` (and ``rest``) into the live tensors on the
        engine's stream, then wait for the copies."""
        live_p, live_r = self._live()
        if self._stream is None:
            self._copy_in(live_p, params)
            if rest is not None:
                self._copy_in(live_r, rest)
            return
        # new values computed on the caller's stream are ready first
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            self._copy_in(live_p, params)
            if rest is not None:
                self._copy_in(live_r, rest)
        self._stream.synchronize()

    def swap_params(self, params: dict, rest: dict | None = None, *, version: int) -> int:
        """Replace the serving weights with ``params`` (a name → tensor or
        array mapping, :meth:`param_template`'s structure), and the
        buffers (BN running stats) with ``rest`` when given, as weight
        version ``version``. Returns the version swapped out.

        The new values must match the current structure exactly (names,
        shapes, dtypes), else :class:`VersionSkewError` before anything is
        touched. They are copied into the live tensors the graphs read, so
        a matching swap reuses every captured graph; the swap waits for
        any call between its copy-in and copy-out, so a batch in flight
        finishes on the version it started on. The outgoing values are
        kept as a device copy, the rollback target (:meth:`rollback`)."""
        live_p, live_r = self._live()
        if self._specs(params) != self._specs(live_p):
            raise VersionSkewError(
                "swap_params: new params do not match the serving "
                "structure (names/shape/dtype) — publisher schema skew; "
                "swap rejected")
        if rest is not None and self._specs(rest) != self._specs(live_r):
            raise VersionSkewError(
                "swap_params: new rest state does not match the serving "
                "structure — swap rejected")
        with self._run_lock:
            old = self._version
            self._previous = (old, self._clone(live_p), self._clone(live_r))
            self._swap_in(params, rest)
            self._version = int(version)
            return old

    def rollback(self) -> int:
        """Restore the retained previous version (bit-identical: its
        device copy was kept). The rolled-back-from values become the
        retained ones. Returns the version now serving; raises
        ``RuntimeError`` when there is nothing to roll back to."""
        with self._run_lock:
            if self._previous is None:
                raise RuntimeError(
                    "rollback: no previous weight version retained"
                )
            version, params, rest = self._previous
            live_p, live_r = self._live()
            self._previous = (self._version, self._clone(live_p), self._clone(live_r))
            self._swap_in(params, rest)
            self._version = version
            return version

    # -- construction ------------------------------------------------------

    @classmethod
    def from_trainer(cls, trainer, **kwargs) -> "InferenceEngine":
        """Build an engine from a live ``DataParallel`` (for a
        ``GANTrainer``, pass one of its modules to the constructor). The
        engine deep-copies ``trainer.model`` onto ``trainer.device`` and
        serves the copy in eval mode; the trainer keeps training its own
        module, in training mode. Under ``zero=True`` the trainer's
        module already holds the full parameters between steps, so no
        gather is needed; a param-sharding (FSDP) layout raises
        ``NotImplementedError`` (ROADMAP A.12c).

        Building an engine is a cold start (a deep copy and one graph
        capture a bucket). Use it for the FIRST engine, then roll new
        versions in through the publication path
        (:mod:`tpu_syncbn_torch.serve.publish`), which copies into the
        running engine's tensors; with a trainer world above 1 a warning
        says so."""
        from tpu_syncbn_torch.runtime import distributed as dist

        world = int(getattr(trainer, "world", 1))
        if world > 1:
            dist.get_logger("tpu_syncbn_torch.serve").warning(
                "InferenceEngine.from_trainer on a trainer of world %d builds "
                "a new engine — a cold start (deep copy, one graph capture a "
                "bucket). For rolling weight updates use the zero-downtime "
                "publication path instead (tpu_syncbn_torch.serve.publish."
                "SwapController.swap_from_trainer: on-device redistribution "
                "+ hot swap into the running engine, no restart).", world)
        kwargs.setdefault("layout", getattr(trainer, "_layout", None))
        kwargs.setdefault("device", trainer.device)
        return cls(trainer.model, **kwargs)

    # -- buckets / programs ------------------------------------------------

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """The smallest configured bucket that fits a batch of ``n`` — the
        pad target. ``n`` beyond the largest bucket is a caller error
        (:meth:`predict` chunks before asking)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.max_bucket}"
        )

    def _forward(self, batch):
        """The eval forward on a tree of tensors on the engine's device."""
        return self._apply_fn(self.model, batch)

    def _program(self, bucket: int, batch) -> _Program:
        """The program for ``bucket`` and this batch's structure (leaf
        shapes beyond the batch axis + dtypes), cached through
        ``scan_driver.cached_program`` — size-aware LRU: at most
        ``MAX_CACHED_PROGRAMS`` programs (and, with
        ``program_cache_bytes``, at most that many bytes of graph pools)
        stay live; least-recently-used evicted first."""
        from tpu_syncbn_torch.obs import telemetry
        from tpu_syncbn_torch.parallel import scan_driver

        key = (bucket, _struct_key(batch))

        def build():
            t0 = time.perf_counter()
            with telemetry.timed("serve.compile_s"):
                prog = _Program(self, bucket, batch)
            telemetry.count("serve.compiles")
            if self._model_labels is not None:
                telemetry.observe("serve.compile_s",
                                  time.perf_counter() - t0,
                                  labels=self._model_labels)
                telemetry.count("serve.compiles",
                                labels=self._model_labels)
            # build() runs inside cached_program under _build_lock below,
            # which the rule cannot see lexically (the JAX engine
            # suppresses its int bump at tpu_syncbn/serve/engine.py:579)
            self._programs_compiled += 1  # audit: ok[unlocked_shared_state]
            return prog

        with self._build_lock:
            return scan_driver.cached_program(
                self._programs, key, build, size_of=lambda p: p.pool_bytes
            )

    def warm(self, example_batch) -> None:
        """Build every bucket's program for ``example_batch``'s structure
        (any leading-axis length), off the request path — so the first
        real request of each bucket is a replay, not a capture."""
        for b in self.buckets:
            self._program(b, example_batch)

    def stats(self) -> dict:
        """Program-cache accounting for the serve block / monitoring:
        configured buckets, total programs ever built, programs currently
        live, and the cache's lifetime hits/misses/evictions (hit rate =
        hits / (hits + misses))."""
        return {
            "buckets": list(self.buckets),
            "programs_compiled": self._programs_compiled,
            "programs_live": len(self._programs),
            "program_cache": self._programs.stats(),
            "version": self.version,
            "previous_version": self.previous_version,
        }

    def health(self) -> dict:
        """Compact JSON-ready health summary for readiness probes (the
        batcher folds it into its ``/readyz`` detail): bucket coverage
        and program-cache state — a climbing ``compiled`` with a capped
        ``live`` under steady traffic means shape churn is rebuilding
        programs on the request path."""
        return {
            "buckets": list(self.buckets),
            "programs_live": len(self._programs),
            "programs_compiled": self._programs_compiled,
            "version": self.version,
        }

    # -- execution ---------------------------------------------------------

    def _run_one(self, batch, n: int):
        from tpu_syncbn_torch.obs import stepstats as obs_stepstats
        from tpu_syncbn_torch.obs import telemetry

        bucket = self.bucket_for(n)
        prog = self._program(bucket, batch)
        # level gauge, not set(): concurrent callers each inc/dec their
        # own contribution atomically (obs.telemetry.Gauge.inc)
        telemetry.inc_gauge("serve.inflight")
        if self._model_labels is not None:
            telemetry.inc_gauge("serve.inflight",
                                labels=self._model_labels)
        t0 = time.perf_counter()
        try:
            with obs_stepstats.timed_span(
                "serve.infer", "serve.infer_s", n=n, bucket=bucket
            ), self._run_lock:
                return prog.run(self, batch, n)
        finally:
            if self._model_labels is not None:
                telemetry.observe("serve.infer_s",
                                  time.perf_counter() - t0,
                                  labels=self._model_labels)
                telemetry.inc_gauge("serve.inflight", -1,
                                    labels=self._model_labels)
            telemetry.inc_gauge("serve.inflight", -1)

    def predict(self, batch):
        """Run the eval forward on a host batch tree (leading axis = the
        batch). Pads to the nearest bucket, runs that bucket's program,
        returns host numpy outputs of the *original* length. Batches
        beyond the largest bucket are chunked through it."""
        n = _leading_dim(batch)
        if n <= self.max_bucket:
            return self._run_one(batch, n)
        outs = []
        for off in range(0, n, self.max_bucket):
            take = min(self.max_bucket, n - off)
            part = tree_map(lambda a: np.asarray(a)[off:off + take], batch)
            outs.append(self._run_one(part, take))
        return tree_map(lambda *ls: np.concatenate(ls, axis=0), *outs)

    __call__ = predict
