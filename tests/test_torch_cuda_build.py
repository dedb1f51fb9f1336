"""The nvcc build of the CUDA kernels (``tpu_syncbn_torch.ops._cuda_build``)
without a card: what it compiles, how libraries are named, and that a
missing or failing compiler raises with its output. A stand-in ``nvcc``
script plays the compiler; the real build runs on the card
(``chip_smoke.py``, ``tests/test_torch_gpu.py``)."""

import ctypes
import os
import re
import shutil
import stat

import pytest

from tpu_syncbn_torch.ops import _cuda_build as cb
from tpu_syncbn_torch.ops import cuda_attention as A


def fake_nvcc(tmp_path, body):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "nvcc"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(bindir)


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(cb.CSRC, dst)
    return str(dst)


def test_every_kernel_source_is_one_library():
    stems = [os.path.splitext(os.path.basename(s))[0] for s in cb.sources()]
    assert stems == ["flash_bwd_dkdv", "flash_bwd_dq", "flash_fwd"]
    assert ("-gencode", "arch=compute_90a,code=sm_90a") == cb.NVCC_FLAGS[:2]


def test_library_names_change_with_any_source(csrc_copy):
    src = os.path.join(csrc_copy, "flash_fwd.cu")
    before = cb.library_path(src, "/b", csrc_copy)
    assert before.startswith("/b/libflash_fwd-") and before.endswith(".so")
    with open(os.path.join(csrc_copy, "flash_common.cuh"), "a") as f:
        f.write("// edited\n")
    assert cb.library_path(src, "/b", csrc_copy) != before


def test_missing_nvcc_raises(tmp_path, monkeypatch, csrc_copy):
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cb.build(str(tmp_path / "build"), csrc_copy)


def test_build_runs_one_compiler_per_source_and_reuses_its_output(
        tmp_path, monkeypatch, csrc_copy):
    log = tmp_path / "calls"
    bindir = fake_nvcc(tmp_path, f'echo "$@" >> {log}\n'
                       'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n'
                       'echo "ptxas info: Used 1 registers"\n')
    monkeypatch.setenv("PATH", bindir + os.pathsep + os.environ["PATH"])
    build = str(tmp_path / "build")
    paths = cb.build(build, csrc_copy)
    assert sorted(paths) == ["flash_bwd_dkdv", "flash_bwd_dq", "flash_fwd"]
    assert all(os.path.isfile(p) for p in paths.values())
    assert len(log.read_text().splitlines()) == 3
    assert "Used 1 registers" in cb.LAST_BUILD["ptxas"]["flash_fwd"]
    assert cb.build(build, csrc_copy) == paths  # nothing stale: no new call
    assert len(log.read_text().splitlines()) == 3
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]


def test_a_failed_build_raises_with_the_compiler_output(
        tmp_path, monkeypatch, csrc_copy):
    bindir = fake_nvcc(tmp_path, 'echo "error: no such instruction"; exit 2\n')
    monkeypatch.setenv("PATH", bindir + os.pathsep + os.environ["PATH"])
    with pytest.raises(RuntimeError, match="no such instruction"):
        cb.build(str(tmp_path / "build"), csrc_copy)


# -- the C launchers' signatures against the argument types ctypes passes ----


def c_launchers():
    """``{name: [parameter, ...]}`` of every ``extern "C" int flash_*(...)``
    in ``csrc/*.cu``."""
    found = {}
    for path in cb.sources():
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r'extern "C" int (flash_\w+)\(([^)]*)\)', src):
            found[name] = [" ".join(p.split()) for p in params.split(",")]
    return found


def c_kind(param):
    """pointer, int or float: how ctypes must pass a C parameter."""
    if "*" in param:
        return "pointer"
    return {"int": "int", "float": "float"}[param.replace("const ", "").rsplit(" ", 1)[0]]


CTYPES_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}


def test_every_c_launcher_has_its_ctypes_argument_types():
    """One launcher per source, named after it, each bound in
    ``cuda_attention._ARGTYPES``."""
    stems = sorted(os.path.splitext(os.path.basename(s))[0] for s in cb.sources())
    assert sorted(c_launchers()) == sorted(A._ARGTYPES) == stems


@pytest.mark.parametrize("name", sorted(A._ARGTYPES))
def test_c_launcher_parameters_match_the_ctypes_argument_types(name):
    """A parameter added, dropped or moved in a launcher would be passed
    silently by ctypes in the wrong slot: count and kinds must agree."""
    params = c_launchers()[name]
    assert [c_kind(p) for p in params] == [CTYPES_KIND[t] for t in A._ARGTYPES[name]]
