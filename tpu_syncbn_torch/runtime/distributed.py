"""Process-group runtime: device binding, rendezvous, rank identity and
rank-0 conventions — the counterpart of ``tpu_syncbn.runtime.distributed``.

The JAX package runs one program per host over a device mesh. The port is
the reference recipe's own model: one process per GPU, joined by
``torch.distributed`` (NCCL on the card, gloo on the CPU). The launcher
(``torchrun`` or any tool that sets its environment) provides ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.

Every entry point takes a ``device`` that defaults to ``"cuda"`` and
raises when there is no card: a run asked for the GPU never drops to the
CPU on its own. Pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import logging
import os
import sys

import torch
import torch.distributed as tdist

_loggers: dict[str, logging.Logger] = {}


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The ``torch.device`` to run on. ``None`` means ``"cuda"``. A CUDA
    device without a usable card raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
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


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def initialize(device: str | torch.device | None = None) -> torch.device:
    """Join the job and bind this process's device; returns the device.

    Reads the torchrun environment. At world 1 no process group is made:
    every collective of the port is then the identity. At world > 1 the
    group uses NCCL when the device is CUDA (after
    ``torch.cuda.set_device(LOCAL_RANK)``) and gloo when the caller asked
    for the CPU. Idempotent."""
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda":
        resolve_device("cuda")  # raises without a card
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = resolve_device(want)
    if world > 1 and not tdist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        tdist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{addr}:{port}",
            world_size=world,
            rank=rank,
        )
    return dev


def is_initialized() -> bool:
    """Whether a process group exists (world > 1)."""
    return tdist.is_available() and tdist.is_initialized()


def shutdown() -> None:
    """Destroy the process group, if any (tests / clean exit)."""
    if is_initialized():
        tdist.destroy_process_group()
    _loggers.clear()


def process_index() -> int:
    """This process's rank — the recipe's ``RANK``."""
    return tdist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """Number of processes — the recipe's ``WORLD_SIZE``."""
    return tdist.get_world_size() if is_initialized() else 1


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


def barrier() -> None:
    """Block until every rank arrives (no-op at world 1)."""
    if is_initialized() and tdist.get_world_size() > 1:
        tdist.barrier()
