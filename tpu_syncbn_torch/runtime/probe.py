"""Backend probing that survives a wedged card — the counterpart of
``tpu_syncbn.runtime.probe``.

A driver that hangs in its first CUDA call blocks the process for good, and
no ``except`` clause catches a hang; a process that has touched CUDA cannot
safely fork either. So the card is asked about in a throwaway subprocess
with a hard timeout (:func:`probe_backend`), before this process touches
CUDA.

Unlike the JAX module, nothing here falls back to the CPU:
:func:`ensure_backend` raises when the card is unusable or has too few
GPUs. The CPU runs only when the caller asks for it, with ``device="cpu"``
or ``TPU_SYNCBN_FORCE_CPU=1`` (:func:`force_cpu`, which the launcher's
``--simulate-chips`` sets).

Env overrides:
  ``TPU_SYNCBN_FORCE_CPU=1``      the run stays on the CPU; a CUDA request
                                  raises (``runtime.resolve_device``)
  ``TPU_SYNCBN_PROBE_TIMEOUT=s``  probe timeout in seconds (default 150)
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import NamedTuple, Optional

from tpu_syncbn_torch.runtime.distributed import FORCE_CPU_ENV, cpu_forced


class BackendInfo(NamedTuple):
    platform: str                                # "gpu" or "cpu"
    device_count: int
    name: Optional[str] = None                   # GPU 0's name
    capability: Optional[tuple[int, int]] = None  # GPU 0's (major, minor)


_PROBE_CODE = (
    "import torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "if n:\n"
    "    c = torch.cuda.get_device_capability(0)\n"
    "    print('PROBE', n, c[0], c[1], torch.cuda.get_device_name(0), flush=True)\n"
)

# One probe per process: the answer cannot change within it, and a wedged
# card costs the probe's whole timeout, which a second caller must not pay
# again. Holds the last result, the failure sentinel (None) included.
_probe_cache: dict = {}


def probe_backend(timeout: Optional[float] = None) -> Optional[BackendInfo]:
    """What a fresh process would find: ``BackendInfo("gpu", count, name,
    capability)``, or ``None`` when there is no usable card or the probe
    fails or outlives ``timeout`` seconds. Cached for the process."""
    if "result" not in _probe_cache:
        _probe_cache["result"] = _probe_uncached(timeout)
    return _probe_cache["result"]


def _probe_uncached(timeout: Optional[float]) -> Optional[BackendInfo]:
    if timeout is None:
        timeout = float(os.environ.get("TPU_SYNCBN_PROBE_TIMEOUT", "150"))
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                              capture_output=True, text=True, timeout=timeout)
    except (subprocess.TimeoutExpired, OSError):
        return None
    if proc.returncode != 0:
        return None
    for line in proc.stdout.splitlines():
        parts = line.split(maxsplit=4)
        if len(parts) == 5 and parts[0] == "PROBE":
            return BackendInfo("gpu", int(parts[1]), parts[4],
                               (int(parts[2]), int(parts[3])))
    return None


def force_cpu() -> None:
    """Keep this process, and every process it starts, on the CPU: sets
    ``TPU_SYNCBN_FORCE_CPU=1``, after which a CUDA request raises. Refuses
    once this process has initialized CUDA, since its CUDA tensors would
    then live on a card the run claims not to use."""
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError(
            "cannot force the CPU: this process already initialized CUDA; "
            "call force_cpu() (or ensure_backend(device='cpu')) before any "
            "CUDA work in the process"
        )
    os.environ[FORCE_CPU_ENV] = "1"


def enable_persistent_compilation_cache() -> str:
    """The directory every kernel builds into and is loaded from: nvcc's
    libraries (``ops/_cuda_build.py``) and Triton's cache (unless
    ``TRITON_CACHE_DIR`` names another), inside the checkout. A library's
    name carries the hash of its sources and flags, so a stale one is never
    loaded; a process that finds one built skips its compile."""
    from tpu_syncbn_torch.ops._triton_common import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))
    return BUILD_DIR


def ensure_backend(min_devices: int = 1, *, device: str = "cuda") -> BackendInfo:
    """Check that the run can have what it asks for, before this process
    touches CUDA: at least ``min_devices`` GPUs for ``device="cuda"``
    (probed in a subprocess; raises when the card is unusable or there
    are too few), or the CPU when ``device="cpu"`` or
    ``TPU_SYNCBN_FORCE_CPU=1`` asks for it. Also points the kernel builds
    at :func:`enable_persistent_compilation_cache`."""
    enable_persistent_compilation_cache()
    if device == "cpu" or cpu_forced():
        force_cpu()
        return BackendInfo("cpu", min_devices)
    if device != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    info = probe_backend()
    if info is None:
        raise RuntimeError(
            f"{min_devices} GPU(s) requested but this node has 0: no usable "
            "CUDA device (the probe failed or timed out); pass device='cpu' "
            f"or set {FORCE_CPU_ENV}=1 to run on the CPU"
        )
    if info.device_count < min_devices:
        raise RuntimeError(
            f"{min_devices} GPU(s) requested but this node has "
            f"{info.device_count} ({info.name}); one process drives one GPU, "
            "so two ranks never share a card"
        )
    return info
