"""Shared bits for the Triton kernel modules — the counterpart of
``tpu_syncbn.ops._pallas_common``: where Triton builds and caches its
kernels, how it is imported, and the kernel mode every wrapper reads.

Triton is imported only from a function that is about to launch a kernel:
the CPU has no Triton, and every module of the package must import there.
"""

from __future__ import annotations

import contextlib
import os

#: Triton's build cache, inside the checkout (listed in ``.gitignore``) so
#: a fresh checkout builds every kernel from its own sources and writes
#: nothing outside it. An explicit ``TRITON_CACHE_DIR`` wins.
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)

_MODES = ("auto", "on", "off")
_mode = "auto"


def set_mode(mode: str) -> None:
    """Select how kernel wrappers run (``ops.batch_norm.set_kernel_mode``):
    ``"auto"`` (default) launches the kernel for a CUDA tensor and runs the
    plain version for a CPU tensor; ``"on"`` launches the kernel and
    raises for a CPU tensor; ``"off"`` runs the plain version everywhere
    (the card's in-place A/B of kernel against plain)."""
    global _mode
    if mode not in _MODES:
        raise ValueError(f"kernel mode must be one of {_MODES}, got {mode!r}")
    _mode = mode


def get_mode() -> str:
    """The active kernel mode (``"auto"``/``"on"``/``"off"``)."""
    return _mode


@contextlib.contextmanager
def mode(m: str):
    """Scoped :func:`set_mode`; restores the previous mode on exit."""
    prev = _mode
    set_mode(m)
    try:
        yield
    finally:
        set_mode(prev)


def use_kernel(t) -> bool:
    """Whether a wrapper given tensor ``t`` launches its kernel (True) or
    runs its plain version (False). Decided by the tensor's device and the
    mode only; a CUDA tensor in ``"auto"``/``"on"`` always means the
    kernel, whose launch then either succeeds or raises."""
    dev = t.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    if _mode == "off":
        return False
    if _mode == "on" and dev != "cuda":
        raise RuntimeError(
            "kernel mode 'on' needs CUDA tensors; got a tensor on "
            f"{t.device} (use mode 'auto' to run the plain version there)"
        )
    return dev == "cuda"


def import_triton():
    """``(triton, triton.language)``, with Triton's cache pointed into the
    checkout before the first import."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))
    import triton
    import triton.language as tl

    return triton, tl


_SM_COUNT: dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per index)."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]
