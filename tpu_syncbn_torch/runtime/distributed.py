"""Process-group runtime: device binding, rendezvous, rank identity,
meshes and rank-0 conventions — the counterpart of
``tpu_syncbn.runtime.distributed``.

The JAX package runs one program per host over a device mesh. The port is
the reference recipe's own model: one process per GPU, joined by
``torch.distributed`` (NCCL on the card, gloo on the CPU). A launcher
(``python -m tpu_syncbn_torch.launch``, ``torchrun`` or any tool that sets
their environment) provides ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
(:class:`DistributedConfig`).

Every entry point takes a ``device`` that defaults to ``"cuda"`` and
raises when there is no card: a run asked for the GPU never drops to the
CPU on its own. Pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import math
import os
import sys
from typing import Mapping, Sequence

import torch
import torch.distributed as tdist

from tpu_syncbn_torch.mesh_axes import DATA_AXIS

_loggers: dict[str, logging.Logger] = {}


#: Set to ``1`` by the launcher's ``--simulate-chips`` (or by the user):
#: the run was asked to stay on the CPU, so a CUDA request raises instead
#: of reaching a card the simulated world does not own.
FORCE_CPU_ENV = "TPU_SYNCBN_FORCE_CPU"


def cpu_forced() -> bool:
    """Whether ``TPU_SYNCBN_FORCE_CPU=1`` holds in this process."""
    return os.environ.get(FORCE_CPU_ENV) == "1"


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The ``torch.device`` to run on. ``None`` means ``"cuda"``. A CUDA
    device without a usable card, or with ``TPU_SYNCBN_FORCE_CPU=1``,
    raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if cpu_forced():
            raise RuntimeError(
                f"tpu_syncbn_torch: device='cuda' requested but {FORCE_CPU_ENV}=1 "
                "(set by the launcher's --simulate-chips): this run stays on "
                "the CPU; pass device='cpu' (train.py: --device cpu)"
            )
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpu_syncbn_torch: device='cuda' requested but no CUDA "
                "device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Explicit wiring of one process into the job: the torchrun contract
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). ``None`` means "not given";
    :func:`initialize` reads a missing one as world 1, rank 0."""

    coordinator_address: str | None = None  # MASTER_ADDR:MASTER_PORT
    num_processes: int | None = None        # WORLD_SIZE (one per GPU)
    process_id: int | None = None           # RANK
    local_rank: int | None = None           # LOCAL_RANK: the GPU index
    local_world_size: int | None = None     # LOCAL_WORLD_SIZE

    @staticmethod
    def from_env() -> "DistributedConfig":
        """Read the torchrun environment. The JAX package's names
        (``TPU_SYNCBN_COORDINATOR``, ``TPU_SYNCBN_NUM_PROCESSES``,
        ``TPU_SYNCBN_PROCESS_ID``) win where set, as they do there."""
        env = os.environ
        addr = env.get("TPU_SYNCBN_COORDINATOR")
        if addr is None and "MASTER_ADDR" in env:
            addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"

        def num(*names):
            for n in names:
                if env.get(n) not in (None, ""):
                    return int(env[n])
            return None

        return DistributedConfig(
            coordinator_address=addr,
            num_processes=num("TPU_SYNCBN_NUM_PROCESSES", "WORLD_SIZE"),
            process_id=num("TPU_SYNCBN_PROCESS_ID", "RANK"),
            local_rank=num("LOCAL_RANK"),
            local_world_size=num("LOCAL_WORLD_SIZE"),
        )


def initialize(
    config: DistributedConfig | str | torch.device | None = None,
    *,
    device: str | torch.device | None = None,
    rendezvous_attempts: int | None = None,
    rendezvous_timeout_s: float | None = None,
    rendezvous_backoff_s: float | None = None,
) -> torch.device:
    """Join the job and bind this process's device; returns the device.

    ``config`` defaults to :meth:`DistributedConfig.from_env`. A string or
    ``torch.device`` in its place is the device (``initialize("cpu")``).
    ``device`` defaults to ``"cuda"``, bound to ``cuda:LOCAL_RANK``, and
    raises without a card.

    At world 1 no process group is made: every collective of the port is
    then the identity. At world > 1 the group uses NCCL for a CUDA device
    and gloo for the CPU, and an existing group is kept (a caller that
    made its own, e.g. gloo over CUDA tensors, keeps it). The rendezvous
    is retried with exponential backoff and a per-rank deterministic
    jitter, and a failed attempt's half-made group is destroyed first.
    Knobs, argument > environment > default: ``rendezvous_attempts`` /
    ``TPU_SYNCBN_RENDEZVOUS_ATTEMPTS`` (3); ``rendezvous_timeout_s`` /
    ``TPU_SYNCBN_RENDEZVOUS_TIMEOUT_S`` (the ``timeout`` of
    ``init_process_group``; torch's default when unset);
    ``rendezvous_backoff_s`` / ``TPU_SYNCBN_RENDEZVOUS_BACKOFF_S`` (1.0 s,
    the first retry's sleep)."""
    if isinstance(config, (str, torch.device)):
        config, device = None, config
    if config is None:
        config = DistributedConfig.from_env()
    world = config.num_processes or 1
    rank = config.process_id or 0
    local_rank = config.local_rank if config.local_rank is not None else rank
    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda":
        resolve_device("cuda")  # raises without a card
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = resolve_device(want)
    if world > 1 and not tdist.is_initialized():
        def knob(arg, name, cast, default):
            if arg is not None:
                return arg
            v = os.environ.get(name)
            return cast(v) if v not in (None, "") else default

        attempts = knob(rendezvous_attempts, "TPU_SYNCBN_RENDEZVOUS_ATTEMPTS",
                        int, 3)
        timeout_s = knob(rendezvous_timeout_s,
                         "TPU_SYNCBN_RENDEZVOUS_TIMEOUT_S", float, None)
        backoff_s = knob(rendezvous_backoff_s,
                         "TPU_SYNCBN_RENDEZVOUS_BACKOFF_S", float, 1.0)
        addr = config.coordinator_address or "localhost:29500"
        _rendezvous_with_retry(
            dict(backend="nccl" if dev.type == "cuda" else "gloo",
                 init_method=f"tcp://{addr}", world_size=world, rank=rank),
            attempts=attempts, timeout_s=timeout_s, backoff_s=backoff_s,
            jitter_key=f"rank{rank}",
        )
    return dev


def _rendezvous_with_retry(
    kwargs: dict,
    *,
    attempts: int,
    timeout_s: float | None,
    backoff_s: float,
    jitter_key: str,
) -> None:
    """``init_process_group(**kwargs)`` under bounded exponential backoff
    with deterministic per-rank jitter, each attempt bounded by
    ``timeout_s`` when given: restarted ranks must not re-storm a
    recovering store in lockstep, and a peer that never arrives ends the
    attempt at its timeout."""
    from tpu_syncbn_torch.runtime import resilience

    if timeout_s is not None:
        kwargs = {**kwargs, "timeout": datetime.timedelta(seconds=timeout_s)}

    from tpu_syncbn_torch.obs import telemetry

    def attempt():
        # attempt/failure counters ride telemetry, so a flaky rendezvous is
        # countable from the exports, not only from the retry log lines
        telemetry.count("rendezvous.attempts")
        try:
            tdist.init_process_group(**kwargs)
        except Exception:
            telemetry.count("rendezvous.failures")
            # a half-made default group would make the next attempt's
            # init_process_group refuse to run
            if tdist.is_initialized():
                with contextlib.suppress(Exception):
                    tdist.destroy_process_group()
            raise

    resilience.retry_with_backoff(
        attempt, attempts=attempts, base_s=backoff_s, key=jitter_key,
        describe="distributed rendezvous",
    )


def is_initialized() -> bool:
    """Whether a process group exists (world > 1)."""
    return tdist.is_available() and tdist.is_initialized()


def shutdown() -> None:
    """Destroy the process group and every subgroup, if any (tests /
    clean exit)."""
    from tpu_syncbn_torch.parallel import collectives

    if is_initialized():
        tdist.destroy_process_group()
    collectives.clear_group_cache()
    _loggers.clear()


def process_index() -> int:
    """This process's rank — the recipe's ``RANK``."""
    return tdist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """Number of processes — the recipe's ``WORLD_SIZE``."""
    return tdist.get_world_size() if is_initialized() else 1


def local_device_count() -> int:
    """GPUs driven on this node: its processes, one GPU each
    (``LOCAL_WORLD_SIZE``; the whole world when unset)."""
    local = DistributedConfig.from_env().local_world_size
    return local if local is not None else process_count()


def global_device_count() -> int:
    """GPUs of the job, one per process: the replica count of data
    parallelism (``nproc_per_node`` × nodes)."""
    return process_count()


def is_master() -> bool:
    """True on rank 0: the recipe prints losses there only."""
    return process_index() == 0


def master_print(*args, **kwargs) -> None:
    """``print`` gated to rank 0."""
    if is_master():
        print(*args, **kwargs)
        sys.stdout.flush()


class _MasterOnlyFilter(logging.Filter):
    """Drops sub-WARNING records off rank 0, deciding at emit time so the
    rank is read after :func:`initialize` has run."""

    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno >= logging.WARNING or is_master()


def get_logger(name: str = "tpu_syncbn_torch") -> logging.Logger:
    """A logger that emits INFO on rank 0 only (WARNING and above
    everywhere). ``TPU_SYNCBN_LOG_STREAM=stderr`` routes it to stderr."""
    if name not in _loggers:
        logger = logging.getLogger(name)
        if not logger.handlers:
            stream = (
                sys.stderr
                if os.environ.get("TPU_SYNCBN_LOG_STREAM", "").lower()
                == "stderr" else sys.stdout
            )
            handler = logging.StreamHandler(stream)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s [%(levelname)s %(name)s] %(message)s",
                datefmt="%H:%M:%S",
            ))
            logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        if not any(isinstance(f, _MasterOnlyFilter) for f in logger.filters):
            logger.addFilter(_MasterOnlyFilter())
        logger.propagate = False
        _loggers[name] = logger
    return _loggers[name]


def mesh_shape(
    axis_sizes: Mapping[str, int] | None, n: int
) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """``(names, sizes)`` of a mesh over ``n`` processes: ``None`` is one
    ``'data'`` axis over all of them; a size of ``-1`` on at most one axis
    means "everything left", like a reshape wildcard. The same rules and
    errors as ``tpu_syncbn.runtime.make_mesh``."""
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: n}
    names = tuple(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if any(s != -1 and s < 1 for s in sizes):
        raise ValueError(f"mesh axis sizes must be positive (or -1): {axis_sizes}")
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one mesh axis may have size -1")
    if wild:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by fixed axes {axis_sizes}")
        sizes[wild[0]] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} do not cover {n} devices"
        )
    return names, tuple(sizes)


def make_mesh(
    axis_sizes: Mapping[str, int] | None = None,
    *,
    device: str | torch.device | None = "cuda",
    devices: Sequence[int] | None = None,
):
    """A named ``torch.distributed.device_mesh.DeviceMesh`` over every
    process of the job (see :func:`mesh_shape` for ``axis_sizes``), its
    ranks in ``devices`` order (default 0..world-1, row-major over the
    dims). Each dim's process group is ``mesh.get_group(name)``; a one-dim
    mesh over the world reuses the default group, the one the trainer and
    ``SyncBatchNorm`` default to. Needs the process group of
    :func:`initialize` (world > 1)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dev = resolve_device(device)
    if not is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: run under a launcher "
            "(world > 1) and call runtime.initialize() first"
        )
    names, sizes = mesh_shape(axis_sizes, process_count())
    if devices is None or list(devices) == list(range(process_count())):
        return init_device_mesh(dev.type, sizes, mesh_dim_names=names)
    ranks = [int(r) for r in devices]
    if sorted(ranks) != list(range(process_count())):
        raise ValueError(f"devices {ranks} must list every rank once")
    return DeviceMesh(dev.type, torch.tensor(ranks).view(*sizes), mesh_dim_names=names)


def data_parallel_mesh(
    num_replicas: int | None = None,
    *,
    device: str | torch.device | None = "cuda",
):
    """The default mesh: one ``'data'`` dim over every process. Each
    process is one replica, so ``num_replicas`` may only name the world
    size."""
    n = process_count()
    if num_replicas is not None:
        if num_replicas > n:
            raise ValueError(
                f"requested {num_replicas} replicas but only "
                f"{n} devices are present"
            )
        if num_replicas < n:
            raise ValueError(
                f"requested {num_replicas} replicas of {n} processes: every "
                "process is one replica, so a mesh spans them all"
            )
    return make_mesh({DATA_AXIS: n}, device=device)


def barrier(name: str = "barrier") -> None:
    """Block until every rank arrives (no-op at world 1). ``name`` labels
    the barrier in a timeout's error, as the JAX package's names its
    ``sync_global_devices`` point."""
    if is_initialized() and tdist.get_world_size() > 1:
        try:
            tdist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r} failed: {e}") from e
