"""Tests that launch the port's kernels (the BN kernels, CUDA forward and
Triton backward, and the CUDA flash-attention kernels; nvcc builds every
CUDA library at the first launch of one), and tests of device staging and
the native library on the card's machine: they need an NVIDIA card (the
kernels also Triton and nvcc), carry the ``gpu`` marker, and skip without
one. The file imports no JAX, so on a machine with a card it runs alone,
without the suite's JAX conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q -p no:cacheprovider

Each kernel is held against its plain PyTorch version on the same CUDA
tensors. Tolerances: per-channel sums 1e-5 of the largest sum (f32 sums
in another order); elementwise f32 outputs rtol 1e-5 / atol 1e-5; bf16
outputs one bf16 unit in the last place (rtol 2^-7). Attention, the repo's
on-card gate (``benchmarks/tpu_validation.py``): float32 kernels against a
float64 plain run, outputs atol 2e-4 and gradients 5e-4; bf16 kernels
against the plain version on the same bf16 inputs, 2^-5 of each row's RMS
plus one ulp (P and dS are rounded to bf16 for their products; see
``within_bf16_tol``).
"""

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import nn
from tpu_syncbn_torch.ops import batch_norm as bn_ops
from tpu_syncbn_torch.ops import cuda_attention as A
from tpu_syncbn_torch.ops import triton_bn as T

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_triton():
    """The BN kernels: Triton (backward) and nvcc (forward) on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the BN kernels have no CPU mode)")
    pytest.importorskip("triton")
    try:
        from tpu_syncbn_torch.ops import _cuda_build
        _cuda_build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


def close_sums(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-6


def close_elem(got, want, dtype):
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=rtol, atol=1e-5)


def inputs(m, c, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(m, c, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
    dy = torch.randn(m, c, device="cuda", generator=g).to(dtype)
    w = torch.rand(c, device="cuda", generator=g) + 0.5
    b = torch.randn(c, device="cuda", generator=g)
    return x, dy, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", [(100003, 96), (3136, 2048), (7, 3)])
def test_kernels_match_plain_versions_on_the_card(cuda_triton, dtype, m, c):
    x, dy, w, b = inputs(m, c, dtype)
    T.reset_launch_counts()
    s, sq, n = T.bn_stats(x)
    mean = s / n
    var = (sq / n - mean * mean).clamp_min(0)
    invstd = torch.rsqrt(var + 1e-5)
    y = T.bn_normalize(x, mean, var, w, b, 1e-5)
    sdy, sdyx = T.bn_backward_reduce(dy, x, mean, invstd)
    dx = T.bn_backward_elemt(dy, x, mean, invstd, w, sdy, sdyx, n)
    torch.cuda.synchronize()
    assert T.launch_counts() == dict.fromkeys(T.LAUNCHES, 1)
    ps, psq = T.stats_plain(x)
    close_sums(s, ps)
    close_sums(sq, psq)
    scale, shift = bn_ops.fold_scale_shift(mean, var, w, b, 1e-5)
    close_elem(y, T.normalize_plain(x, scale, shift), dtype)
    psdy, psdyx = T.backward_reduce_plain(dy, x, mean, invstd)
    close_sums(sdy, psdy)
    close_sums(sdyx, psdyx)
    close_elem(dx, T.backward_elemt_plain(dy, x, mean, invstd, w, sdy, sdyx, n),
               dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_batch_norm_kernels_match_the_plain_path(cuda_triton, dtype):
    """FusedBatchNorm forward and gradients with the kernels ("auto") and
    with the plain versions ("off") on the same CUDA tensors, through an
    NCHW channels_last activation as the ResNet hands it over."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x0 = torch.randn(8, 64, 28, 28, device="cuda", generator=g).to(dtype)
    x0 = x0.contiguous(memory_format=torch.channels_last)
    coeff = torch.randn(x0.shape, device="cuda", generator=g).to(dtype)
    out = {}
    for mode in ("auto", "off"):
        bn = nn.BatchNorm2d(64, channel_axis=1, device="cuda")
        x = x0.clone().requires_grad_()
        T.reset_launch_counts()
        with bn_ops.kernel_mode(mode):
            y = bn(x)
            (y * coeff).sum().backward()
        torch.cuda.synchronize()
        launched = set(T.launch_counts().values())
        assert launched == ({1} if mode == "auto" else {0})
        out[mode] = (y, x.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean, bn.running_var)
    for i, (a, b) in enumerate(zip(out["auto"], out["off"])):
        if i in (0, 1):
            close_elem(a, b, dtype)
        else:
            close_sums(a, b)


def test_wrappers_raise_instead_of_falling_back_on_the_card(cuda_triton):
    x = torch.randn(4, 6, 5, 3, device="cuda")
    with pytest.raises(ValueError, match="dense channel-last"):
        T.bn_stats(x.permute(0, 2, 3, 1))
    with pytest.raises(TypeError, match="float32/bfloat16/float16"):
        T.bn_stats(x.double())
    with pytest.raises(ValueError, match="contiguous on"):
        T.bn_backward_reduce(x, x, torch.zeros(3), torch.ones(3, device="cuda"))


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_batch_norm_train_raises_on_a_layout_the_kernels_cannot_read(
        cuda_triton, mode):
    """An NCHW-contiguous CUDA activation normalized over channel_axis=1 has
    no dense channel-last view: the kernel path raises instead of running
    the plain ops on the card."""
    x = torch.randn(4, 8, 5, 6, device="cuda")
    T.reset_launch_counts()
    with bn_ops.kernel_mode(mode):
        with pytest.raises(ValueError, match="dense channel-last"):
            bn_ops.batch_norm_train(x, None, None, None, None, None,
                                    channel_axis=1)
        with pytest.raises(ValueError, match="dense channel-last"):
            nn.BatchNorm2d(8, channel_axis=1, device="cuda")(x)
    assert T.launch_counts() == dict.fromkeys(T.LAUNCHES, 0)


def flat_stats(out):
    return torch.cat([t.reshape(-1) for t in out])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_stats_repeats_bit_for_bit_and_inside_a_cuda_graph(cuda_triton, dtype):
    """One launch, no atomics on the sums, a grid fixed by the shape: two
    calls and three replays of a captured call (the arrival counters are
    back at zero after each) give the same bits."""
    x, _, _, _ = inputs(50176, 256, dtype, seed=3)
    first = flat_stats(T.bn_stats(x))
    assert torch.equal(flat_stats(T.bn_stats(x)), first)
    ps, psq = T.stats_plain(x)
    close_sums(first[:256], ps)
    close_sums(first[256:512], psq)
    assert float(first[512]) == 50176
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        T.bn_stats(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = T.bn_stats(x)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(flat_stats(captured), first)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 6, 100, 96])
def test_bn_forward_kernels_take_unaligned_views_and_odd_widths(
        cuda_triton, c, dtype, aligned):
    """Rows of C * itemsize bytes off 16-byte boundaries, and a view that
    starts one element into its buffer ([1:] of a flat tensor), take the
    scalar paths, chosen inside the launchers: never a copy, never a
    refusal, and the plain versions' numbers."""
    m = 1000
    g = torch.Generator(device="cuda").manual_seed(c)
    flat = (torch.randn(m * c + 1, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
    x = flat[:m * c].view(m, c) if aligned else flat[1:].view(m, c)
    assert (x.data_ptr() % 16 == 0) == aligned
    w = torch.rand(c, device="cuda", generator=g) + 0.5
    b = torch.randn(c, device="cuda", generator=g)
    T.reset_launch_counts()
    s, sq, n = T.bn_stats(x)
    mean = s / n
    var = (sq / n - mean * mean).clamp_min(0)
    y = T.bn_normalize(x, mean, var, w, b, 1e-5)
    torch.cuda.synchronize()
    assert T.launch_counts()["bn_stats"] == T.launch_counts()["bn_normalize"] == 1
    ps, psq = T.stats_plain(x)
    close_sums(s, ps)
    close_sums(sq, psq)
    assert float(n) == m
    scale, shift = bn_ops.fold_scale_shift(mean, var, w, b, 1e-5)
    close_elem(y, T.normalize_plain(x, scale, shift), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_forward_kernels_at_m_zero(cuda_triton, dtype):
    """M = 0: stats launches and writes zero sums and n = 0; normalize
    launches nothing and returns the empty view's shape."""
    x = torch.empty(0, 64, device="cuda", dtype=dtype)
    T.reset_launch_counts()
    s, sq, n = T.bn_stats(x)
    y = T.bn_normalize(x, torch.zeros(64, device="cuda"), torch.ones(64, device="cuda"),
                       None, None, 1e-5)
    torch.cuda.synchronize()
    assert T.launch_counts()["bn_stats"] == 1 and T.launch_counts()["bn_normalize"] == 0
    assert not bool(s.any()) and not bool(sq.any()) and float(n) == 0
    assert y.shape == (0, 64) and y.dtype == dtype


@pytest.fixture
def cuda_nvcc():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    try:
        from tpu_syncbn_torch.ops import _cuda_build
        _cuda_build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


def attn_inputs(b, l, h, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, l, h, d, device="cuda", generator=g).to(dtype)
            for _ in range(4)]


def max_err(got, want):
    return float((got.detach().double() - want.detach().double()).abs().max())


def within_bf16_tol(got, want):
    """|got - want| at most 2^-5 of the RMS of want's row, one ulp (2^-7)
    of the element and 2^-12 of the tensor's RMS: the kernels round P and
    dS to bf16 before products the plain version makes in f32, and with
    random inputs an element's terms do not cancel, so its row's RMS is
    their scale."""
    got, want = got.detach().double(), want.detach().double()
    tol = (2 ** -5 * want.pow(2).mean(-1, keepdim=True).sqrt()
           + 2 ** -7 * want.abs() + 2 ** -12 * want.pow(2).mean().sqrt())
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 100, 3, 8), (1, 200, 2, 64),
                                   (1, 130, 2, 128), (2, 64, 1, 32),
                                   (1, 77, 2, 24), (1, 150, 1, 72),
                                   (2, 1, 2, 16)])
def test_flash_kernels_match_plain_versions(cuda_nvcc, shape, dtype, causal):
    q, k, v, do = attn_inputs(*shape, dtype)
    scale = 0.7 / shape[-1] ** 0.5
    ref = (lambda x: x.double()) if dtype == torch.float32 else (lambda x: x)
    A.reset_launch_counts()
    o, lse = A.flash_fwd(q, k, v, causal=causal, scale=scale)
    delta = A.row_delta(do, o)
    dk, dv = A.flash_bwd_dkdv(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dq = A.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert A.launch_counts() == dict.fromkeys(A.LAUNCHES, 1)
    rq, rk, rv, rdo = map(ref, (q, k, v, do))
    po, plse = A.flash_fwd_plain(rq, rk, rv, causal=causal, scale=scale)
    assert max_err(lse, plse) <= 1e-4
    args = (rq, rk, rv, rdo, ref(lse), ref(delta))
    pdk, pdv = A.flash_bwd_dkdv_plain(*args, causal=causal, scale=scale)
    pdq = A.flash_bwd_dq_plain(*args, causal=causal, scale=scale)
    if dtype == torch.float32:  # against float64
        assert max_err(o, po) <= 2e-4
        for got, want in ((dq, pdq), (dk, pdk), (dv, pdv)):
            assert max_err(got, want) <= 5e-4
    else:
        for got, want in ((o, po), (dq, pdq), (dk, pdk), (dv, pdv)):
            assert within_bf16_tol(got, want)


def test_flash_kernels_read_qkv_views_in_place(cuda_nvcc):
    """q, k, v as views into one fused QKV product (row stride 3*H*D) give
    bit for bit what contiguous copies give: the strides are honoured."""
    b, l, h, d = 2, 150, 4, 64
    qkv = torch.randn(b, l, 3 * h * d, device="cuda").to(torch.bfloat16)
    q, k, v = (x.reshape(b, l, h, d) for x in qkv.split(h * d, -1))
    assert not q.is_contiguous()
    o1, lse1 = A.flash_fwd(q, k, v, causal=True, scale=d ** -0.5)
    o2, lse2 = A.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, scale=d ** -0.5)
    do = torch.randn_like(o1)
    delta = A.row_delta(do, o1)
    views, copies = (q, k, v), (q.contiguous(), k.contiguous(), v.contiguous())
    g1 = A.flash_bwd_dkdv(*views, do, lse1, delta, causal=True, scale=0.125)
    g2 = A.flash_bwd_dkdv(*copies, do, lse1, delta, causal=True, scale=0.125)
    dq1 = A.flash_bwd_dq(*views, do, lse1, delta, causal=True, scale=0.125)
    dq2 = A.flash_bwd_dq(*copies, do, lse1, delta, causal=True, scale=0.125)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    assert all(torch.equal(a, b_) for a, b_ in zip(g1, g2))
    assert torch.equal(dq1, dq2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("poisoned", [0, 1])
def test_flash_kernels_keep_batches_apart(cuda_nvcc, dtype, poisoned):
    """q, k, v as views into one fused QKV tensor at a ragged L, B = 2: with
    one batch's rows (and its dO) set to NaN, the other batch's o, lse, dk,
    dv and dq are bit for bit what they were. A tile that runs past L must
    read zeros, never the neighbouring batch's rows: even a masked read of
    a NaN would reach the output through 0 * NaN."""
    b, l, h, d = 2, 1000, 4, 64
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=g).to(dtype)
    do = torch.randn(b, l, h, d, device="cuda", generator=g).to(dtype)

    def run(qkv, do):
        q, k, v = (x.view(b, l, h, d) for x in qkv.split(h * d, -1))
        o, lse = A.flash_fwd(q, k, v, causal=False, scale=d ** -0.5)
        delta = A.row_delta(do, o)
        dk, dv = A.flash_bwd_dkdv(q, k, v, do, lse, delta, causal=False,
                                  scale=d ** -0.5)
        dq = A.flash_bwd_dq(q, k, v, do, lse, delta, causal=False,
                            scale=d ** -0.5)
        torch.cuda.synchronize()
        return o, lse.view(b, h, l), dk, dv, dq

    clean = run(qkv, do)
    qkv, do = qkv.clone(), do.clone()
    qkv[poisoned] = float("nan")
    do[poisoned] = float("nan")
    dirty = run(qkv, do)
    kept = 1 - poisoned
    for x, y in zip(clean, dirty):
        assert bool(torch.isfinite(x[kept]).all())
        assert torch.equal(x[kept], y[kept])
    # the poison reached the kernels (its lse stays finite: the running
    # max skips NaN and keeps NEG_BIG)
    assert not bool(torch.isfinite(dirty[0][poisoned]).all())


@pytest.mark.parametrize("d", [8, 72, 128])
def test_flash_bwd_dq_repeats_bit_for_bit(cuda_nvcc, d):
    """dQ is its own kernel, each block writing its own rows with no atomics:
    two calls give the same bits. Causal at a ragged L = 1000, with head
    dims that TMA pads to 64 (8) or 128 (72, 128) with zeros; the result
    agrees with the plain version."""
    q, k, v, do = attn_inputs(1, 1000, 2, d, torch.bfloat16, seed=d)
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = A.flash_fwd(q, k, v, **kw)
    delta = A.row_delta(do, o)
    dq1 = A.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dq2 = A.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2)
    assert bool(torch.isfinite(dq1).all())
    assert within_bf16_tol(dq1, A.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw))


@pytest.mark.parametrize("backward", ["pallas", "xla"])
def test_flash_attention_gradients_kernels_vs_plain(cuda_nvcc, backward):
    q0, k0, v0, w = attn_inputs(2, 96, 2, 32, torch.float32, seed=3)
    out = {}
    for mode in ("auto", "off"):
        q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
        A.reset_launch_counts()
        with bn_ops.kernel_mode(mode):
            o = A.flash_attention(q, k, v, causal=True, backward=backward)
            (o * w).sum().backward()
        torch.cuda.synchronize()
        counts = A.launch_counts()
        if mode == "off":
            assert counts == dict.fromkeys(A.LAUNCHES, 0)
        else:
            bwd = 1 if backward == "pallas" else 0
            assert counts == {"flash_fwd": 1, "flash_bwd_dkdv": bwd,
                              "flash_bwd_dq": bwd}
        out[mode] = (o, q.grad, k.grad, v.grad)
    for a, b_ in zip(out["auto"], out["off"]):
        assert max_err(a, b_) <= 5e-4


def test_flash_backward_copies_only_an_unreadable_do(cuda_nvcc):
    """The dO of ``o.sum()`` is an expanded scalar (every stride 0), which
    the kernels cannot read: the backward copies it and matches the plain
    version. A readable dO goes to the kernels as it is."""
    q0, k0, v0, _ = attn_inputs(1, 96, 2, 32, torch.float32, seed=5)
    grads = {}
    for mode in ("auto", "off"):
        q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
        with bn_ops.kernel_mode(mode):
            A.flash_attention(q, k, v, causal=True, backward="pallas").sum().backward()
        grads[mode] = (q.grad, k.grad, v.grad)
    for a, b_ in zip(grads["auto"], grads["off"]):
        assert max_err(a, b_) <= 5e-4
    do = torch.randn(1, 96, 2, 64, device="cuda")[..., :32]
    assert not do.is_contiguous() and A._readable(do)
    assert not A._readable(do[..., 1:])  # 4 bytes past a 16-byte boundary


def test_flash_wrappers_raise_instead_of_falling_back_on_the_card(cuda_nvcc):
    q = torch.randn(1, 32, 2, 136, device="cuda")
    with pytest.raises(ValueError, match="head dim 136"):
        A.flash_fwd(q, q, q, causal=True, scale=1.0)
    q = torch.randn(1, 32, 2, 16, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.flash_fwd(q, q, q, causal=True, scale=1.0)
    q = torch.randn(1, 32, 2, 17, device="cuda")[..., :16]
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.flash_fwd(q, q, q, causal=True, scale=1.0)


# -- device staging and the native library on the card's machine -----------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (device staging copies to the card)")


# 50 batches prefetched onto the card while the compute stream is kept
# busy: before each batch is read, a long matmul is queued on the compute
# stream, so the host runs far ahead of the device and the staging copies
# of later batches would land in a freed block that a queued read still
# has to read, if the prefetcher did not record its tensors on the
# consumer's stream. Prints the number of batches that came out unequal.
PREFETCH_RACE = r"""
import numpy as np, torch
from tpu_syncbn_torch import data
torch.backends.cuda.matmul.allow_tf32 = False
n, shape = 50, (512, 1024)
host = [(np.random.RandomState(i).rand(*shape).astype(np.float32),
         np.arange(8, dtype=np.int32) + i) for i in range(n)]
a = torch.randn(4096, 4096, device="cuda")
reads = []
for x, y in data.device_prefetch(iter(host), size=2, device="cuda"):
    for _ in range(3):
        a = torch.tanh(a @ a * 1e-3)  # ~10 ms of queued compute
    reads.append((x.clone(), y.clone()))
    del x, y
torch.cuda.synchronize()
bad = sum(not (torch.equal(x.cpu(), torch.from_numpy(hx))
               and torch.equal(y.cpu(), torch.from_numpy(hy)))
          for (x, y), (hx, hy) in zip(reads, host))
print("unequal", bad, "of", len(reads), data.__file__)
"""


def run_race(root):
    """Run PREFETCH_RACE on the package under ``root`` (also the working
    directory, which comes first on ``sys.path``)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(root))
    r = subprocess.run([sys.executable, "-c", PREFETCH_RACE], env=env, cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    _, bad, _, total, path = r.stdout.split()
    assert int(total) == 50
    assert path.startswith(os.path.join(str(root), "tpu_syncbn_torch")), path
    return int(bad)


def test_side_stream_prefetch_is_exact_under_a_busy_compute_stream(cuda_card):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert run_race(root) == 0


def test_prefetch_without_record_stream_fails_on_a_copy(cuda_card, tmp_path):
    """The same run on a copy of the package outside the checkout whose
    prefetcher does not record its tensors on the consumer's stream: some
    batch is overwritten by a later copy before the step reads it."""
    import os
    import shutil

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(root, "tpu_syncbn_torch"),
                    tmp_path / "tpu_syncbn_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    loader = tmp_path / "tpu_syncbn_torch" / "data" / "loader.py"
    src = loader.read_text()
    line = "            _map_arrays(lambda t_: t_.record_stream(consumer), batch)\n"
    assert src.count(line) == 1
    loader.write_text(src.replace(line, ""))
    bad = run_race(str(tmp_path))
    print(f"without record_stream: {bad} of 50 batches unequal")
    assert bad > 0


def test_device_prefetch_stacks_on_the_card(cuda_card):
    from tpu_syncbn_torch import data

    host = [np.full((2, 3), i, np.float32) for i in range(5)]
    chunks = list(data.device_prefetch(iter(host), device="cuda", scan_steps=2))
    assert [tuple(c.shape) for c in chunks] == [(2, 2, 3), (2, 2, 3), (1, 2, 3)]
    assert all(c.is_cuda for c in chunks)
    assert torch.equal(torch.cat([c.cpu() for c in chunks]),
                       torch.from_numpy(np.stack(host)))


def test_native_library_loads_on_the_card_machine(cuda_card):
    from tpu_syncbn_torch.runtime import native

    assert native.available(), native.load_error()
    got = native.permutation(7, 1000)
    assert np.array_equal(got, np.random.RandomState(7).permutation(1000))
