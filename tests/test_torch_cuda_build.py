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

import numpy as np
import pytest

import torch

from tpu_syncbn_torch.ops import _cuda_build as cb
from tpu_syncbn_torch.ops import cuda_attention as A
from tpu_syncbn_torch.ops import cuda_bn as B
from tpu_syncbn_torch.ops import cuda_quant as Q

STEMS = ["bn_normalize", "bn_stats", "flash_bwd_dkdv", "flash_bwd_dq", "flash_fwd",
         "quant_int8"]
ARGTYPES = {**A._ARGTYPES, **B._ARGTYPES, **Q._ARGTYPES}
# each source's launchers: one named after it, or quant_int8's three
LAUNCHERS = {"quant_int8": ["quant_decode", "quant_encode", "quant_minmax"]}


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
    assert stems == STEMS
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
    assert sorted(paths) == STEMS
    assert all(os.path.isfile(p) for p in paths.values())
    assert len(log.read_text().splitlines()) == len(STEMS)
    assert "Used 1 registers" in cb.LAST_BUILD["ptxas"]["flash_fwd"]
    assert cb.build(build, csrc_copy) == paths  # nothing stale: no new call
    assert len(log.read_text().splitlines()) == len(STEMS)
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]


def test_a_failed_build_raises_with_the_compiler_output(
        tmp_path, monkeypatch, csrc_copy):
    bindir = fake_nvcc(tmp_path, 'echo "error: no such instruction"; exit 2\n')
    monkeypatch.setenv("PATH", bindir + os.pathsep + os.environ["PATH"])
    with pytest.raises(RuntimeError, match="no such instruction"):
        cb.build(str(tmp_path / "build"), csrc_copy)


# -- the C launchers' signatures against the argument types ctypes passes ----


def c_launchers():
    """``{name: [parameter, ...]}`` of every ``extern "C" int flash_*(...)``,
    ``bn_*(...)`` and ``quant_*(...)`` in ``csrc/*.cu``."""
    found = {}
    for path in cb.sources():
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r'extern "C" int ((?:flash|bn|quant)_\w+)\(([^)]*)\)',
                                       src):
            found[name] = [" ".join(p.split()) for p in params.split(",")]
    return found


def c_kind(param):
    """pointer, int, long long or float: how ctypes must pass a C parameter."""
    if "*" in param:
        return "pointer"
    return {"int": "int", "float": "float", "long long": "long long"}[
        param.replace("const ", "").rsplit(" ", 1)[0]]


CTYPES_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float",
               ctypes.c_longlong: "long long"}


def test_every_c_launcher_has_its_ctypes_argument_types():
    """One launcher per source, named after it (``quant_int8``'s three are
    ``quant_*``), each bound in exactly one of ``cuda_attention``,
    ``cuda_bn`` and ``cuda_quant``'s ``_ARGTYPES``."""
    stems = sorted(os.path.splitext(os.path.basename(s))[0] for s in cb.sources())
    tables = (A._ARGTYPES, B._ARGTYPES, Q._ARGTYPES)
    assert sum(len(t) for t in tables) == len(ARGTYPES)
    want = sorted(n for s in stems for n in LAUNCHERS.get(s, [s]))
    assert sorted(c_launchers()) == sorted(ARGTYPES) == want


@pytest.mark.parametrize("name", sorted(ARGTYPES))
def test_c_launcher_parameters_match_the_ctypes_argument_types(name):
    """A parameter added, dropped or moved in a launcher would be passed
    silently by ctypes in the wrong slot: count and kinds must agree."""
    params = c_launchers()[name]
    assert [c_kind(p) for p in params] == [CTYPES_KIND[t] for t in ARGTYPES[name]]


# -- cuda_bn's wrappers against a stand-in library -------------------------


class StubLauncher:
    """Plays a C launcher: records each call's arguments, returns ``err``."""

    def __init__(self, err=0):
        self.argtypes = self.restype = None
        self.calls, self.err = [], err

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class StubLibrary:
    def __init__(self, err=0):
        self.bn_stats, self.bn_normalize = StubLauncher(err), StubLauncher(err)
        self.cuda_error_string = lambda code: b"stub error"


@pytest.fixture
def stub_lib(monkeypatch):
    """cuda_bn's wrappers on CPU tensors, with the library, the SM count and
    the stream stood in for: what the wrappers hand each launcher."""
    lib = StubLibrary()
    monkeypatch.setattr(cb, "library", lambda stem: lib)
    monkeypatch.setattr(B._tc, "sm_count", lambda device: 132)
    monkeypatch.setattr(B, "_stream", lambda device: 1234)
    monkeypatch.setattr(B, "_COUNTERS", {})
    return lib


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1),
                                        (torch.float16, 2)])
def test_cuda_bn_stats_hands_its_launcher_the_plan_in_order(stub_lib, dtype, code):
    x2 = torch.zeros(3136, 512, dtype=dtype)
    s, sq, n = B.stats(x2)
    (call,) = stub_lib.bn_stats.calls
    assert stub_lib.bn_stats.argtypes == B._ARGTYPES["bn_stats"]
    assert stub_lib.bn_stats.restype is ctypes.c_int
    gc, n_c, n_m, rows = B.stats_plan(3136, 512, x2.element_size(), 132)
    assert call[:2] == (code, x2.data_ptr())
    ws_ptr, counters_ptr, out_ptr = call[2:5]
    assert counters_ptr == B._COUNTERS[None].data_ptr()
    assert out_ptr == s.data_ptr() and sq.data_ptr() == out_ptr + 512 * 4
    assert n.data_ptr() == out_ptr + 2 * 512 * 4
    assert ws_ptr not in (out_ptr, counters_ptr, x2.data_ptr())
    assert call[5:] == (3136, 512, gc, n_c, n_m, rows, 1234)
    assert s.shape == sq.shape == (512,) and n.shape == ()
    assert s.dtype == sq.dtype == n.dtype == torch.float32
    assert len(call) == len(B._ARGTYPES["bn_stats"])


def test_cuda_bn_normalize_hands_its_launcher_the_plan_in_order(stub_lib):
    x2 = torch.zeros(100003, 96, dtype=torch.bfloat16)
    scale, shift = torch.ones(96), torch.zeros(96)
    y = B.normalize(x2, scale, shift)
    (call,) = stub_lib.bn_normalize.calls
    assert y.shape == x2.shape and y.dtype == x2.dtype and y.is_contiguous()
    assert call == (1, x2.data_ptr(), y.data_ptr(), scale.data_ptr(),
                    shift.data_ptr(), 100003, 96,
                    *B.normalize_plan(100003, 96, 2), 1234)
    assert len(call) == len(B._ARGTYPES["bn_normalize"])
    B.normalize(x2[:0], scale, shift)  # M = 0 launches nothing
    assert len(stub_lib.bn_normalize.calls) == 1


def test_cuda_bn_raises_when_its_launcher_returns_an_error(monkeypatch, stub_lib):
    lib = StubLibrary(err=7)
    monkeypatch.setattr(cb, "library", lambda stem: lib)
    x2 = torch.zeros(64, 6)
    with pytest.raises(RuntimeError, match="bn_stats: CUDA error 7: stub error"):
        B.stats(x2)
    with pytest.raises(RuntimeError, match="bn_normalize: CUDA error 7: stub error"):
        B.normalize(x2, torch.ones(6), torch.zeros(6))


# -- bn_stats's arrival counters under graph capture ---------------------------


@pytest.mark.parametrize("n_sm", [1, 66, 78, 114, 132, 144])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_stats_counters_cover_every_plan_below_the_group_cap(n_sm, itemsize):
    """The counters allocated at first use (``counter_capacity``) cover
    the column blocks of every (M, C) plan up to 512 · capacity channel
    groups, so a captured graph never needs them to grow; past that C the
    plan asks for more."""
    cap = B.counter_capacity(n_sm)
    vec = 16 // itemsize
    top = 512 * cap * vec
    rs = np.random.RandomState(n_sm)
    cs = sorted(set([1, 3, 64, 2048, top - 1, top] + list(rs.randint(1, top, 200))))
    for c in cs:
        for m in (1, 4096, 10 ** 6):
            assert B.stats_plan(m, int(c), itemsize, n_sm)[1] <= cap, (m, c)
    assert B.stats_plan(64, top + vec, itemsize, n_sm)[1] == cap + 1


def test_stats_counters_are_never_replaced_after_a_capture(monkeypatch):
    monkeypatch.setattr(B, "_COUNTERS", {})
    monkeypatch.setattr(B, "_CAPTURED", set())
    dev = torch.device("cpu")
    with pytest.raises(RuntimeError, match="before capturing"):
        B._counters(dev, 8, 132, capturing=True)  # a first call under capture
    buf = B._counters(dev, 8, 132)
    assert buf.numel() == B.counter_capacity(132) and int(buf.abs().sum()) == 0
    assert B._counters(dev, 100, 132, capturing=True) is buf  # recorded
    with pytest.raises(RuntimeError, match="captured CUDA graph"):
        B._counters(dev, buf.numel() + 1, 132)
    assert B._COUNTERS[None] is buf
    # before any capture a larger plan still grows the buffer
    monkeypatch.setattr(B, "_CAPTURED", set())
    assert B._counters(dev, buf.numel() + 1, 132).numel() == buf.numel() + 1
