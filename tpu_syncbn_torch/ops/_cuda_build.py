"""Build and load the hand-written CUDA kernels — the CUDA counterpart of
the build half of ``_triton_common``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, which ``ctypes``
loads. Nothing is compiled when the package is imported: :func:`library`
builds at a kernel's first launch (``chip_smoke.py`` calls :func:`build`
first, to time it). All sources build in parallel, one ``nvcc`` each.

A library's file name carries a hash of every source in ``csrc/`` and of
the compiler flags, so a stale build is never loaded. A missing ``nvcc``
or a failed build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from tpu_syncbn_torch.ops._triton_common import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

#: ``-Xptxas -v`` prints each kernel's registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: What the last :func:`build` did: seconds, compiled sources, ptxas report.
LAST_BUILD: dict = {}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def sources(csrc: str = CSRC) -> list[str]:
    """The ``.cu`` sources, each one library (headers are shared)."""
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def source_hash(csrc: str = CSRC) -> str:
    """Hash of every file in ``csrc`` and of the flags: any change to a
    source, a header or a flag names new libraries."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(csrc, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(src: str, build_dir: str = BUILD_DIR, csrc: str = CSRC) -> str:
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"lib{stem}-{source_hash(csrc)}.so")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``. Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of tpu_syncbn_torch build from source at their first launch"
    )


def build(build_dir: str = BUILD_DIR, csrc: str = CSRC) -> dict[str, str]:
    """Compile every source whose library is missing, all at once, and
    return ``{stem: library path}``. Raises with the compiler's output if
    any build fails."""
    os.makedirs(build_dir, exist_ok=True)
    t0 = time.perf_counter()
    out, procs = {}, []
    for src in sources(csrc):
        stem = os.path.splitext(os.path.basename(src))[0]
        path = library_path(src, build_dir, csrc)
        out[stem] = path
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((stem, path, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    for stem, path, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        reports[stem] = log
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    LAST_BUILD.clear()
    LAST_BUILD.update(seconds=time.perf_counter() - t0,
                      compiled=sorted(reports), ptxas=reports)
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built first if
    needed). The caller sets ``argtypes`` on the functions it uses."""
    with _LOCK:
        if stem not in _LIBS:
            paths = build()
            if stem not in paths:
                raise KeyError(f"no source csrc/{stem}.cu")
            _LIBS[stem] = ctypes.CDLL(paths[stem])
        return _LIBS[stem]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch is never
    reported by ``torch.cuda.synchronize``). Every library exports
    ``cuda_error_string`` (``csrc/common.cuh``)."""
    if err != 0:
        fn = lib.cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err}: {fn(err).decode()}")
