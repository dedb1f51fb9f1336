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

import time

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_bn_launches_the_normalize_kernel(cuda_triton, dtype):
    """Eval-mode BN of a channels_last CUDA activation launches the
    hand-written ``bn_normalize`` once and nothing else, and matches the
    plain chain (``batch_norm_elemt``) within one bf16 ulp of f32 work;
    with a gradient asked for, its dx, dγ, dβ match the plain chain's; an
    NCHW-contiguous activation raises instead of running the plain ops."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 64, 14, 14, device="cuda", generator=g).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    bn = nn.BatchNorm2d(64, channel_axis=1, device="cuda")
    with torch.no_grad():
        bn.running_mean.normal_(generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
        bn.weight.normal_(generator=g)
        bn.bias.normal_(generator=g)
    bn.eval()
    args = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    T.reset_launch_counts()
    with torch.no_grad():
        y = bn(x)
    assert T.launch_counts() == {**dict.fromkeys(T.LAUNCHES, 0), "bn_normalize": 1}
    with torch.no_grad():
        want = bn_ops.batch_norm_elemt(x, *args[:4], args[4], channel_axis=1)
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    close_elem(y, want, dtype)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(dtype)
    grads = []
    for fn in (bn, lambda t: bn_ops.batch_norm_elemt(t, *args[:4], args[4], channel_axis=1)):
        xg = x.detach().clone().requires_grad_(True)
        bn.zero_grad(set_to_none=True)
        (fn(xg).float() * dy.float()).sum().backward()
        grads.append((xg.grad, bn.weight.grad, bn.bias.grad))
    for got, ref in zip(*grads):
        close_elem(got, ref, dtype if got.dtype == dtype else torch.float32)
    with torch.no_grad(), pytest.raises(ValueError, match="dense channel-last"):
        bn(x.contiguous())


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


# -- the trainer's remat and divergence guard on the card -------------------


def _card_trainer(**kw):
    """A SyncBN ResNet-18 (width 8, 20 BN layers) on the card with SGD
    momentum and a cosine schedule the trainer owns."""
    import math

    from tpu_syncbn_torch import models, parallel

    model = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=10, small_input=True, width=8, device="cuda",
        generator=torch.Generator().manual_seed(0)))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: 0.5 * (1 + math.cos(math.pi * min(s, 10) / 10)))
    dp = parallel.DataParallel(
        model, opt, lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1]),
        device="cuda", lr_scheduler=sched, **kw)
    return model, dp


def _card_batch(seed, nan_image=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(16, 16, 16, 3, device="cuda", generator=g)
    if nan_image is not None:
        x[nan_image] = float("nan")
    return x, torch.randint(0, 10, (16,), device="cuda", generator=g)


def test_remat_launches_the_forward_kernels_twice_and_moves_stats_once(cuda_triton):
    model, dp = _card_trainer(remat=True)
    bn = next(m for m in model.modules() if isinstance(m, nn.BatchNorm))
    T.reset_launch_counts()
    dp.train_step(_card_batch(0))
    torch.cuda.synchronize()
    assert T.launch_counts() == {"bn_stats": 40, "bn_normalize": 40,
                                 "bn_backward_reduce": 20, "bn_backward_elemt": 20}
    assert int(bn.num_batches_tracked) == 1


def test_guard_skip_is_bitwise_exact_on_the_card(cuda_triton):
    """A NaN image: parameters, momentum buffers, BN buffers and the
    schedule come out of the skipped step bit for bit as they went in."""
    _, dp = _card_trainer(divergence_guard="skip_step")
    dp.train_step(_card_batch(0))
    before = dp.state_dict()
    out = dp.train_step(_card_batch(1, nan_image=3))
    after = dp.state_dict()
    assert float(out.metrics["nonfinite"]) == 1.0
    for part in ("params", "rest"):
        assert all(torch.equal(before[part][k], after[part][k]) for k in before[part])
    opt_b, opt_a = before["opt_state"]["optimizer"], after["opt_state"]["optimizer"]
    assert len(opt_b["state"]) == 62  # every parameter's momentum buffer
    assert all(torch.equal(opt_b["state"][i]["momentum_buffer"],
                           opt_a["state"][i]["momentum_buffer"]) for i in opt_b["state"])
    assert before["opt_state"]["lr_scheduler"] == after["opt_state"]["lr_scheduler"]
    assert dp.guard_state == {"lr_scale": 1.0, "nonfinite_count": 1}


@pytest.mark.parametrize("arch", ["dcgan", "sngan"])
def test_gan_iteration_launches_fourteen_forward_and_ten_backward(cuda_triton, arch):
    """One GANTrainer iteration at the DCGAN widths (G's 4 BN layers, D's
    2), f32: the forward pair 14 times (G 4 + 4, D 2 + 2 + 2), the
    backward pair 10 times (D 2 + 2 in the D step, D 2 + G 4 in the G
    step); num_batches_tracked +2 in G and +3 in D."""
    from tpu_syncbn_torch import models, parallel

    G = nn.convert_sync_batchnorm(models.DCGANGenerator(device="cuda"))
    D = nn.convert_sync_batchnorm(
        (models.DCGANDiscriminator if arch == "dcgan" else models.SNGANDiscriminator)(
            device="cuda"))
    tr = parallel.GANTrainer(
        G, D, torch.optim.Adam(G.parameters(), lr=2e-4, betas=(0.5, 0.999)),
        torch.optim.Adam(D.parameters(), lr=2e-4, betas=(0.5, 0.999)),
        loss="bce" if arch == "dcgan" else "hinge", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    real = torch.rand(64, 32, 32, 3, device="cuda", generator=g) * 2 - 1
    z = torch.randn(2, 64, 128, device="cuda", generator=g)
    T.reset_launch_counts()
    out = tr.train_step(real, z[0], z[1])
    torch.cuda.synchronize()
    assert T.launch_counts() == {"bn_stats": 14, "bn_normalize": 14,
                                 "bn_backward_reduce": 10, "bn_backward_elemt": 10}
    assert {int(m.num_batches_tracked) for m in G.modules()
            if isinstance(m, nn.BatchNorm)} == {2}
    assert {int(m.num_batches_tracked) for m in D.modules()
            if isinstance(m, nn.BatchNorm)} == {3}
    assert np.isfinite(float(out.d_loss)) and np.isfinite(float(out.g_loss))


def test_retinanet_step_launches_each_bn_kernel_53_times(cuda_triton):
    """One DataParallel step of RetinaNet-R50-FPN at per-GPU batch 2 and
    256², f32: each BN kernel 53 times (the backbone's layers, once each
    way), a finite loss."""
    from tpu_syncbn_torch import data, models, parallel

    model = nn.convert_sync_batchnorm(models.retinanet_r50_fpn(
        num_classes=80, image_size=(256, 256), device="cuda"))
    dp = parallel.DataParallel(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                               lambda m, b: m.loss(*b), device="cuda")
    ds = data.SyntheticDetectionDataset(length=2, image_size=(256, 256),
                                        num_classes=80, max_boxes=32)
    batch = tuple(np.stack(parts) for parts in zip(ds[0], ds[1]))
    T.reset_launch_counts()
    out = dp.train_step(batch)
    torch.cuda.synchronize()
    assert T.launch_counts() == dict.fromkeys(T.LAUNCHES, 53)
    assert np.isfinite(float(out.loss))


# -- K steps as one CUDA graph (parallel.scan_driver) --------------------------


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, so an eager run repeats itself
    and a replay can be held against it bit for bit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


def _body_run_eagerly(dp, chunk):
    """The K-step body of ``dp`` (a fresh program, captured and then not
    replayed) run eagerly from ``dp``'s state on ``chunk``: the plain
    version of ``train_steps_batches``."""
    from tpu_syncbn_torch.parallel import scan_driver
    from tpu_syncbn_torch.parallel.trainer import _schedule_lrs

    k = scan_driver.scan_length(chunk)
    prog = dp._build_program(k, True, chunk)
    prog.chunk.opt.fill(_schedule_lrs(dp.optimizer, dp.lr_scheduler, k))
    prog.chunk.lr_scale.fill_(dp.guard_state["lr_scale"])
    prog.chunk.count.fill_(dp.guard_state["nonfinite_count"])
    return prog.loop(chunk)


def _same_training_state(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    same = all(torch.equal(sa[p][k], sb[p][k]) for p in ("params", "rest") for k in sa[p])
    oa, ob = sa["opt_state"]["optimizer"]["state"], sb["opt_state"]["optimizer"]["state"]
    return same and all(torch.equal(oa[i][k].cpu(), ob[i][k].cpu())
                        for i in oa for k in oa[i])


def test_train_steps_batches_replays_the_body_bit_for_bit(cuda_triton, deterministic_cudnn):
    """K = 3 steps under ``skip_step`` with a NaN image in step 2: one
    graph replay, equal bit for bit to the same body run eagerly from the
    same weights; the graph recorded 20 BN layers x 3 launches of each
    kernel (and 2 warm-up steps went through the wrappers), and a second
    chunk launches nothing through them."""
    from tpu_syncbn_torch.parallel import scan_driver

    batches = [_card_batch(i, nan_image=3 if i == 1 else None) for i in range(3)]
    chunk = scan_driver.stack_batches(batches)
    _, dp = _card_trainer(divergence_guard="skip_step")
    T.reset_launch_counts()
    out = dp.train_steps_batches(chunk)
    assert T.launch_counts() == dict.fromkeys(T.LAUNCHES, 20 * (scan_driver.WARMUP_STEPS + 3))
    prog = next(iter(dp.program_caches[0].values()))
    assert prog.graph is not None and prog.pool_bytes > 0
    assert out.metrics["nonfinite"].tolist() == [0.0, 1.0, 0.0]
    assert dp.guard_state == {"lr_scale": 1.0, "nonfinite_count": 1}
    assert dp.lr_scheduler.last_epoch == 2  # the skipped step took no lr
    _, ref = _card_trainer(divergence_guard="skip_step")
    want = _body_run_eagerly(ref, chunk)
    torch.testing.assert_close(out.loss, want["loss"], rtol=0, atol=0, equal_nan=True)
    assert _same_training_state(dp, ref)
    counts = T.launch_counts()
    dp.train_steps_batches(chunk)
    assert T.launch_counts() == counts


def test_a_loaded_state_rebuilds_the_graph(cuda_triton, deterministic_cudnn):
    """``load_state_dict`` replaces the optimizer's tensors: the program
    captured before reads stale and refuses to replay, the cache is
    emptied, and the next chunk (a new capture) equals the body run
    eagerly from the loaded state."""
    from tpu_syncbn_torch.parallel import scan_driver

    chunk = scan_driver.stack_batches([_card_batch(i) for i in range(2)])
    _, dp = _card_trainer()
    dp.train_steps_batches(chunk)
    held = next(iter(dp.program_caches[0].values()))
    saved = dp.state_dict()
    dp.train_steps_batches(chunk)
    dp.load_state_dict(saved)
    assert held.stale() and len(dp.program_caches[0]) == 0
    with pytest.raises(RuntimeError, match="replaced"):
        held(chunk)
    out = dp.train_steps_batches(chunk)
    _, ref = _card_trainer()
    ref.load_state_dict(saved)
    want = _body_run_eagerly(ref, chunk)
    assert torch.equal(out.loss, want["loss"])
    assert _same_training_state(dp, ref)


def test_bn_stats_counters_are_not_replaced_under_a_captured_graph(cuda_triton):
    """After a graph recorded ``bn_stats``, a shape needing more arrival
    counters than were allocated raises instead of replacing the buffer
    the graph writes; the graph still replays right."""
    from tpu_syncbn_torch.ops import cuda_bn

    x, _, _, _ = inputs(4096, 256, torch.bfloat16, seed=5)
    first = flat_stats(T.bn_stats(x))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = T.bn_stats(x)
    cap = cuda_bn.counter_capacity(torch.cuda.get_device_properties(0).multi_processor_count)
    wide = torch.zeros(1, 512 * cap * 8 + 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(RuntimeError, match="captured CUDA graph"):
        T.bn_stats(wide)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(flat_stats(captured), first)


def test_gan_train_steps_replays_the_iterations_bit_for_bit(cuda_triton, deterministic_cudnn):
    """Two DCGAN iterations (narrow widths, Adam made capturable) as one
    graph: 14 / 10 BN launches an iteration recorded, num_batches_tracked
    +4 in G and +6 in D, and the same losses and weights as the two
    iterations run eagerly through the same body."""
    from tpu_syncbn_torch import models, parallel
    from tpu_syncbn_torch.parallel import scan_driver

    def build():
        G = nn.convert_sync_batchnorm(models.DCGANGenerator(
            latent_dim=8, width=16, device="cuda", generator=torch.Generator().manual_seed(0)))
        D = nn.convert_sync_batchnorm(models.DCGANDiscriminator(
            width=8, device="cuda", generator=torch.Generator().manual_seed(1)))
        return parallel.GANTrainer(
            G, D, torch.optim.Adam(G.parameters(), lr=2e-4, betas=(0.5, 0.999)),
            torch.optim.Adam(D.parameters(), lr=2e-4, betas=(0.5, 0.999)), device="cuda")

    g = torch.Generator(device="cuda").manual_seed(0)
    real = torch.rand(2, 16, 32, 32, 3, device="cuda", generator=g) * 2 - 1
    z_d, z_g = torch.randn(2, 2, 16, 8, device="cuda", generator=g)
    tr = build()
    T.reset_launch_counts()
    out = tr.train_steps(real, z_d, z_g)
    per = scan_driver.WARMUP_STEPS + 2
    assert T.launch_counts() == {"bn_stats": 14 * per, "bn_normalize": 14 * per,
                                 "bn_backward_reduce": 10 * per,
                                 "bn_backward_elemt": 10 * per}
    assert all(grp["capturable"] for o in (tr.g_optimizer, tr.d_optimizer)
               for grp in o.param_groups)
    assert {int(m.num_batches_tracked) for m in tr.generator.modules()
            if isinstance(m, nn.BatchNorm)} == {4}
    assert {int(m.num_batches_tracked) for m in tr.discriminator.modules()
            if isinstance(m, nn.BatchNorm)} == {6}
    ref = build()
    prog = ref._build_program(2, (real, z_d, z_g))
    for opt in (ref.g_optimizer, ref.d_optimizer):
        prog.opts[id(opt)].fill([[grp["lr"] for grp in opt.param_groups]] * 2)
    want = prog.loop((real, z_d, z_g))
    assert torch.equal(out.d_loss, want["d_loss"]) and torch.equal(out.g_loss, want["g_loss"])
    sa, sb = tr.state_dict(), ref.state_dict()
    for key in ("g_params", "d_params", "g_rest", "d_rest"):
        assert all(torch.equal(sa[key][k], sb[key][k]) for k in sa[key]), key


# -- the int8 wire's kernels (csrc/quant_int8.cu) ----------------------------


@pytest.mark.parametrize("n", [25_557_032, 100_003], ids=["resnet50", "ragged"])
@pytest.mark.parametrize("qmax", [127, 63, 1])
def test_quant_kernels_are_their_plain_versions_bit_for_bit(cuda_nvcc, n, qmax):
    """minmax, encode (with and without a residual) and decode against the
    plain versions on the same CUDA tensors: every output equal, a
    constant chunk at scale 1, one launch each."""
    from tpu_syncbn_torch.ops import quant_int8 as Q

    g_ = torch.Generator(device="cuda").manual_seed(n % 97)
    g = torch.randn(n, device="cuda", generator=g_) * 1e-2
    e = torch.randn(n, device="cuda", generator=g_) * 1e-4
    g[256:512], e[256:512] = 0.5, 0.0
    for ee in (e, None):
        Q.reset_launch_counts()
        r = Q.minmax(g, ee, chunk=256)
        assert torch.equal(r, Q.minmax_plain(g, ee, 256))
        got = Q.encode(g, ee, r, qmax, chunk=256, want_residual=ee is not None)
        want = Q.encode_plain(g, ee, r, qmax, 256, ee is not None)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
        q, scale, zp, _ = got
        assert float(scale[1]) == 1.0 and not bool(q[256:512].any())
        world = 127 // qmax
        for mean in (False, True):
            assert torch.equal(Q.decode(q, scale, zp, world=world, n=n, chunk=256, mean=mean),
                               Q.decode_plain(q, scale, zp, world, n, mean))
        assert Q.launch_counts() == {"quant_minmax": 1, "quant_encode": 1, "quant_decode": 2}


def test_quant_encode_writes_the_residual_in_place(cuda_nvcc):
    """residual_out may be the incoming residual itself (the trainer's
    buffer): each element is read before it is written."""
    from tpu_syncbn_torch.ops import quant_int8 as Q

    g_ = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn(70_001, device="cuda", generator=g_)
    e = torch.randn(70_001, device="cuda", generator=g_) * 1e-2
    r = Q.minmax(g, e, chunk=256)
    _, _, _, want = Q.encode_plain(g, e, r, 127, 256, True)
    buf = e.clone()
    _, _, _, got = Q.encode(g, buf, r, 127, chunk=256, want_residual=True, residual_out=buf)
    assert got is buf and torch.equal(buf, want)


def test_quant_wrappers_raise_instead_of_falling_back_on_the_card(cuda_nvcc):
    from tpu_syncbn_torch.ops import quant_int8 as Q

    g = torch.ones(300, device="cuda")
    with pytest.raises(ValueError, match="1-D"):
        Q.minmax(g.view(3, 100), chunk=256)
    with pytest.raises(ValueError, match="qmax"):
        Q.encode(g, None, Q.minmax(g, chunk=256), 0, chunk=256)
    with bn_ops.kernel_mode("on"), pytest.raises(RuntimeError, match="needs CUDA"):
        Q.minmax(torch.ones(300), chunk=256)


def test_int8_ef_chunk_replays_the_body_bit_for_bit(cuda_triton, deterministic_cudnn):
    """K = 3 int8 steps with error feedback as one graph replay, equal bit
    for bit to the same body run eagerly from the same state, the residual
    included; the graph recorded one minmax, encode and decode a step."""
    from tpu_syncbn_torch.ops import quant_int8 as Q
    from tpu_syncbn_torch.parallel import scan_driver

    chunk = scan_driver.stack_batches([_card_batch(i) for i in range(3)])
    _, dp = _card_trainer(compress="int8")
    Q.reset_launch_counts()
    out = dp.train_steps_batches(chunk)
    assert Q.launch_counts() == dict.fromkeys(Q.LAUNCHES, scan_driver.WARMUP_STEPS + 3)
    _, ref = _card_trainer(compress="int8")
    want = _body_run_eagerly(ref, chunk)
    torch.testing.assert_close(out.loss, want["loss"], rtol=0, atol=0)
    assert _same_training_state(dp, ref)
    assert torch.equal(dp._residual, ref._residual) and bool(dp._residual.abs().max() > 0)


# -- ZeRO (parallel/zero.py) and the int8 kernels' tiled shape ------------------


@pytest.mark.parametrize("n,chunk,qmax", [(25_557_032, 25_557_032, 127),
                                          (25_557_032, 6_389_258, 31),
                                          (100_003, 40_000, 63)],
                         ids=["zero-world1", "zero-world4", "ragged"])
def test_quant_kernels_at_the_zero_scatter_chunks_bit_for_bit(cuda_nvcc, n, chunk, qmax):
    """Chunks above WARP_CHUNK_MAX take the tiled launch shape: minmax (two
    launches), encode and decode bit-identical to the plain versions, with
    and without a residual; one count a wrapper call."""
    from tpu_syncbn_torch.ops import quant_int8 as Q

    assert chunk > Q.WARP_CHUNK_MAX
    g_ = torch.Generator(device="cuda").manual_seed(chunk % 97)
    g = torch.randn(n, device="cuda", generator=g_) * 1e-2
    e = torch.randn(n, device="cuda", generator=g_) * 1e-4
    for ee in (e, None):
        Q.reset_launch_counts()
        r = Q.minmax(g, ee, chunk=chunk)
        assert torch.equal(r, Q.minmax_plain(g, ee, chunk))
        got = Q.encode(g, ee, r, qmax, chunk=chunk, want_residual=ee is not None)
        want = Q.encode_plain(g, ee, r, qmax, chunk, ee is not None)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
        q, scale, zp, _ = got
        for mean in (False, True):
            assert torch.equal(Q.decode(q, scale, zp, world=127 // qmax, n=n, chunk=chunk,
                                        mean=mean),
                               Q.decode_plain(q, scale, zp, 127 // qmax, n, mean))
        assert Q.launch_counts() == {"quant_minmax": 1, "quant_encode": 1, "quant_decode": 2}


def test_zero_chunk_replays_the_body_bit_for_bit(cuda_triton, deterministic_cudnn):
    """``zero=True`` on the card: K = 3 steps under ``skip_step`` with a NaN
    image in step 2 as one graph replay, equal bit for bit to the body run
    eagerly (shards, optimizer state and module parameters); the module
    equals the shards after the gather."""
    from tpu_syncbn_torch.parallel import scan_driver

    batches = [_card_batch(i, nan_image=3 if i == 1 else None) for i in range(3)]
    chunk = scan_driver.stack_batches(batches)
    _, dp = _card_trainer(divergence_guard="skip_step", zero=True)
    out = dp.train_steps_batches(chunk)
    assert out.metrics["nonfinite"].tolist() == [0.0, 1.0, 0.0]
    _, ref = _card_trainer(divergence_guard="skip_step", zero=True)
    want = _body_run_eagerly(ref, chunk)
    torch.testing.assert_close(out.loss, want["loss"], rtol=0, atol=0, equal_nan=True)
    assert _same_training_state(dp, ref)
    assert torch.equal(dp._shards["float32"], ref._shards["float32"])
    full = dp._flat.flatten(dict(dp._trainable))["float32"]
    assert torch.equal(full, dp._shards["float32"])


# -- the on-device monitors and the numerics publisher (obs) ---------------------


def test_captured_chunk_with_monitors_replays_the_body_bit_for_bit(
        cuda_triton, deterministic_cudnn):
    """``monitors="full"``: K = 3 steps as one graph replay against the same
    body run eagerly from the same weights, every monitor (stacked to (3,))
    bit for bit; every monitor a CUDA tensor; a second replay allocates
    nothing."""
    from tpu_syncbn_torch.parallel import scan_driver

    chunk = scan_driver.stack_batches([_card_batch(i) for i in range(3)])
    _, dp = _card_trainer(monitors="full")
    out = dp.train_steps_batches(chunk)
    _, ref = _card_trainer(monitors="full")
    want = _body_run_eagerly(ref, chunk)
    mon = {k[1]: v for k, v in want.items() if isinstance(k, tuple) and k[0] == "mon"}
    assert set(mon) == set(out.monitors) and "bn_var_min.stem_bn" in mon
    for k, v in out.monitors.items():
        assert v.is_cuda and v.shape == (3,)
        assert torch.equal(v, mon[k]), k
    assert float(out.monitors["bn_layers"][0]) == 20
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    prog = next(iter(dp.program_caches[0].values()))
    prog.graph.replay()
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before


def test_numerics_publisher_waits_on_the_event_not_the_host(cuda_card):
    """A monitor computed behind ~0.5 s of queued device work: ``publish``
    returns at once with the entry still queued (its event pending, no
    synchronize), the next ``publish`` after the work lands drains it, and
    ``flush`` drains a pending one by synchronizing on its event. The
    value, and the multiply the test runs later, are computed before the
    queued work: a kernel's first launch in a process waits for all
    queued work (CUDA loads kernels lazily), so the test's own first
    launches must not sit behind its sleep when it runs alone."""
    from tpu_syncbn_torch.obs import numerics, telemetry

    telemetry.set_enabled(True)
    telemetry.REGISTRY.reset()
    try:
        pub = numerics.NumericsPublisher()
        value = torch.ones((), device="cuda") * 2.0
        value * 0.25
        torch.cuda.synchronize()
        torch.cuda._sleep(int(1e9))  # ~0.5 s of device time on the stream
        t0 = time.perf_counter()
        assert pub.publish(1, {"bn_mean_skew": value, "grad_norm": value}) == 0
        assert time.perf_counter() - t0 < 0.1
        torch.cuda.synchronize()
        assert pub.publish(2, None) == 1 and pub.last == {"bn_mean_skew": 2.0}
        torch.cuda._sleep(int(1e9))
        assert pub.publish(3, {"clip_fraction": value * 0.25}) == 0
        assert pub.flush() == 1
        snap = telemetry.snapshot()
        assert snap["counters"]["numerics.samples"] == 2
        assert snap["counters"]["numerics.clip_saturated"] == 1
    finally:
        telemetry.set_enabled(None)


def test_sharded_grad_norm_matches_replicated_on_the_card(cuda_triton):
    """``zero=True``: the norm of the gradient shards (one scalar all-reduce
    over the shard group, identity at world 1) equals the replicated
    trainer's over the full gradients."""
    _, plain = _card_trainer()
    _, zero = _card_trainer(zero=True)
    batch = _card_batch(7)
    a, b = plain.train_step(batch).monitors, zero.train_step(batch).monitors
    assert set(a) == set(b)
    torch.testing.assert_close(b["grad_norm"], a["grad_norm"], rtol=1e-4, atol=0)
    assert float(b["grad_nonfinite"]) == 0


def test_dispatch_wire_tally_counts_each_replay(cuda_card):
    """A captured K = 3 program whose body tallies one collective call a
    step (a stand-in for NCCL's, which one card cannot run): the capture
    records the inventory, the first dispatch adds the warm-up's steps and
    one replay's, and every later replay adds the inventory, K steps' worth."""
    from tpu_syncbn_torch.obs import telemetry
    from tpu_syncbn_torch.parallel import collectives as C
    from tpu_syncbn_torch.parallel import scan_driver

    telemetry.set_enabled(True)
    telemetry.REGISTRY.reset()
    try:
        t = torch.zeros(1024, device="cuda")

        def body(k, batch):
            C._tally("psum", [t])
            t.add_(batch)
            return {"s": t.sum()}

        prog = scan_driver.build_scan_steps(body, n_steps=3, stacked=False,
                                            device="cuda", state=lambda: [t])
        wire = C.DispatchWireTally()
        x = torch.ones(1024, device="cuda")
        prog(x)
        assert prog.wire_bytes == 3 * 4096
        assert wire.after_dispatch(3) == (scan_driver.WARMUP_STEPS + 3) * 4096
        for _ in range(2):
            prog(x)
            assert wire.after_dispatch(3) == 3 * 4096
        torch.cuda.synchronize()
        assert float(t[0]) == 9.0  # three replays of three steps
    finally:
        telemetry.set_enabled(None)


# -- the flight recorder and the memory sampler on the card (ROADMAP A.11b) --


def test_memwatch_reads_the_caching_allocator(cuda_card):
    """The sampler's card reading: bytes in use and peak are
    ``memory_allocated`` / ``max_memory_allocated``, the limit the card's
    memory, the census the allocator's live blocks."""
    from tpu_syncbn_torch.obs import memwatch

    x = torch.empty(1 << 20, device="cuda")
    torch.cuda.synchronize()
    (d,) = memwatch.device_readings()[:1]
    assert d["bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert d["peak_bytes"] == torch.cuda.max_memory_allocated(0)
    assert d["limit_bytes"] == torch.cuda.get_device_properties(0).total_memory
    host = memwatch.host_readings()
    stats = torch.cuda.memory_stats(0)
    assert host["arrays_bytes"] == stats["active_bytes.all.current"] >= x.numel() * 4
    assert host["arrays_count"] == stats["active.all.current"] >= 1
    r = memwatch.MemorySampler(pressure_threshold=None).sample()
    assert r["source"] == "device" and r["bytes_in_use"] == torch.cuda.memory_allocated(0)


def test_memwatch_thread_samples_beside_a_global_mode_capture(cuda_card):
    """A graph captured in the default (global) capture mode while the
    sampler's thread reads at 1 ms: an unsafe CUDA runtime call from that
    thread would invalidate the capture; it succeeds and replays right."""
    import threading

    from tpu_syncbn_torch.obs import memwatch

    capturing, during = threading.Event(), [0]

    def reader():
        if capturing.is_set():
            during[0] += 1
        return memwatch.device_readings()

    x = torch.zeros(1 << 16, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            (x * 2).add_(1)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with memwatch.MemorySampler(interval_s=0.001, device_reader=reader,
                                pressure_threshold=None).start():
        time.sleep(0.01)
        with torch.cuda.graph(g):
            capturing.set()
            y = x
            for _ in range(200):
                y = y * 1.0001 + 1
            time.sleep(0.05)  # the sampler's thread runs inside the capture
            capturing.clear()
    g.replay()
    torch.cuda.synchronize()
    assert during[0] > 0
    want = torch.zeros(1 << 16, device="cuda")
    for _ in range(200):
        want = want * 1.0001 + 1
    torch.testing.assert_close(y, want)


def test_a_dump_while_the_step_is_running_reads_pending(cuda_card, tmp_path):
    """A step's scalars computed behind ~0.5 s of queued device work:
    ``record_step`` and a trigger return at once, with no synchronize, the
    entry reading ``"pending"``; once the work lands the ring holds the
    step's own values."""
    from tpu_syncbn_torch.obs import flightrec, incident

    real_sync = torch.cuda.synchronize
    # a first page-locked block of the size the record takes, returned to
    # the host allocator (a process's first one may wait for the device)
    warm = flightrec.FlightRecorder(incident_dir=str(tmp_path))
    warm.record_step(0, metrics={"a": torch.ones((), device="cuda")} | {
        f"k{i}": torch.ones((), device="cuda") for i in range(2)})
    torch.cuda.synchronize()
    del warm
    rec = flightrec.FlightRecorder(incident_dir=str(tmp_path))
    torch.cuda._sleep(int(1e9))
    loss = torch.ones((), device="cuda") * 0.25
    norm = torch.full((), float("inf"), device="cuda")
    count = torch.full((), 3, dtype=torch.int32, device="cuda")  # another dtype
    done = torch.cuda.Event()
    done.record()

    def forbidden(*a, **kw):
        raise AssertionError("a synchronize in the recorder")

    torch.cuda.synchronize = forbidden
    try:
        t0 = time.perf_counter()
        rec.record_step(1, metrics={"loss": loss, "lr": 0.1, "n": count},
                        monitors={"grad_norm": norm})
        path = rec.trigger("manual", force=True)
        elapsed = time.perf_counter() - t0
    finally:
        torch.cuda.synchronize = real_sync
    assert not done.query() and elapsed < 0.25
    entry = incident.load_bundle(path)["rings"]["steps"][0]
    assert entry["metrics"] == {"lr": 0.1, "loss": "pending", "n": "pending"}
    assert entry["monitors"] == {"grad_norm": "pending"}
    loss.fill_(9.0)  # a later write to the same tensor, stream-ordered after the copy
    torch.cuda.synchronize()
    entry = rec.rings_snapshot()["steps"][0]
    assert entry["metrics"] == {"lr": 0.1, "loss": 0.25, "n": 3.0}
    assert entry["monitors"] == {"grad_norm": "inf"}


def test_publisher_and_recorder_take_no_page_locked_block_on_a_step(cuda_card, tmp_path,
                                                                   monkeypatch):
    """Both take their page-locked rows when built; ``publish`` and
    ``record_step`` then allocate none (a process's first page-locked
    allocation waits for the device), for more steps than either ring
    holds."""
    from tpu_syncbn_torch.obs import flightrec, numerics, telemetry

    telemetry.set_enabled(True)
    try:
        pub = numerics.NumericsPublisher(max_pending=4)
        rec = flightrec.FlightRecorder(incident_dir=str(tmp_path), step_capacity=3)
        real_empty = torch.empty

        def no_pinned(*a, **kw):
            assert not kw.get("pin_memory"), "a page-locked allocation on a step"
            return real_empty(*a, **kw)

        monkeypatch.setattr(torch, "empty", no_pinned)
        for step in range(12):
            v = torch.full((), float(step), device="cuda")
            pub.publish(step, {"bn_mean_skew": v, "bn_var_skew": v * 2})
            rec.record_step(step, metrics={"loss": v}, monitors={"grad_norm": v + 1})
        monkeypatch.setattr(torch, "empty", real_empty)
        pub.flush()
        assert pub.published == 12 and pub.last == {"bn_mean_skew": 11.0, "bn_var_skew": 22.0}
        torch.cuda.synchronize()
        steps = rec.rings_snapshot()["steps"]
        assert [e["step"] for e in steps] == [9, 10, 11]
        assert [e["metrics"]["loss"] for e in steps] == [9.0, 10.0, 11.0]
        assert [e["monitors"]["grad_norm"] for e in steps] == [10.0, 11.0, 12.0]
    finally:
        telemetry.set_enabled(None)


def test_metrics_scrape_while_a_captured_chunk_runs_does_not_wait(cuda_triton):
    """A ``/metrics`` scrape (and ``/readyz``, ``/statusz``) while a
    captured chunk queued behind ~0.5 s of device sleep is still running:
    each answers 200 at once, with no synchronize, the chunk still
    pending."""
    import json as _json
    import urllib.request

    from tpu_syncbn_torch.obs import server as obs_server, telemetry
    from tpu_syncbn_torch.parallel import scan_driver

    _, dp = _card_trainer()
    chunk = scan_driver.stack_batches([_card_batch(i) for i in range(3)])
    dp.train_steps_batches(chunk)  # captures the program
    torch.cuda.synchronize()
    telemetry.set_enabled(True)
    real_sync = torch.cuda.synchronize

    def forbidden(*a, **kw):
        raise AssertionError("a synchronize in the monitoring server")

    srv = obs_server.MonitoringServer(port=0, host="127.0.0.1")
    try:
        torch.cuda._sleep(int(1e9))
        dp.train_steps_batches(chunk)  # a replay, queued behind the sleep
        done = torch.cuda.Event()
        done.record()
        torch.cuda.synchronize = forbidden
        t0 = time.perf_counter()
        for route in ("metrics", "readyz", "statusz"):
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/{route}",
                                        timeout=10) as resp:
                assert resp.status == 200, route
                body = resp.read()
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize = real_sync
        assert not done.query() and elapsed < 0.25, elapsed
        assert body.startswith(b"tpu_syncbn statusz")
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                    timeout=10) as resp:
            assert _json.loads(resp.read())["ok"] is True
    finally:
        torch.cuda.synchronize = real_sync
        srv.close()
        telemetry.set_enabled(None)
        torch.cuda.synchronize()


def test_cuda_profilez_without_a_servicing_loop_answers_503_in_bound(cuda_card, tmp_path,
                                                                    monkeypatch):
    """CUDA is initialized, so the handler thread hands the capture to the
    main thread; nothing services the slot, so the request answers 503
    naming the main-thread rule once its duration plus the grace has
    passed, and the slot is clear again."""
    import json as _json
    import urllib.error
    import urllib.request

    from tpu_syncbn_torch.obs import profiling, server as obs_server

    torch.zeros(1, device="cuda").add_(1)
    monkeypatch.setenv("TPU_SYNCBN_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(profiling, "HANDOFF_GRACE_S", 0.5)
    with obs_server.MonitoringServer(port=0, host="127.0.0.1") as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/profilez?duration_s=0.2", data=b"",
            method="POST")
        t0 = time.perf_counter()
        try:
            urllib.request.urlopen(req, timeout=10)
            status, doc = 200, None
        except urllib.error.HTTPError as e:
            status, doc = e.code, _json.loads(e.read())
        elapsed = time.perf_counter() - t0
    assert status == 503 and "main thread" in doc["error"]
    assert 0.7 <= elapsed < 3.0, elapsed
    assert profiling._slot is None and not profiling._capture_lock.locked()


def test_first_publish_and_record_behind_queued_work_return_at_once(cuda_card, tmp_path):
    """Run alone in a fresh process too (``chip_smoke.py`` does): a
    publisher and a recorder built before ~0.5 s of device work is queued,
    handed a step's scalars computed before it (as a step's own kernels
    compute its monitors), return at once with their entries pending —
    neither takes a page-locked block nor launches a kernel for the first
    time on a call (CUDA loads a kernel at its first launch, and the load
    waits for all queued work) — and read the step's own values once the
    work lands."""
    from tpu_syncbn_torch.obs import flightrec, numerics, telemetry

    telemetry.set_enabled(True)
    telemetry.REGISTRY.reset()
    try:
        value = torch.full((), 2.0, device="cuda")
        loss = torch.full((), 1.0, device="cuda")
        count = torch.full((), 3, dtype=torch.int32, device="cuda")
        pub = numerics.NumericsPublisher()
        rec = flightrec.FlightRecorder(incident_dir=str(tmp_path))
        torch.cuda.synchronize()
        torch.cuda._sleep(int(1e9))  # ~0.5 s of device time on the stream
        done = torch.cuda.Event()
        done.record()
        t0 = time.perf_counter()
        first = pub.publish(1, {"bn_mean_skew": value, "clip_fraction": value})
        rec.record_step(1, metrics={"loss": loss, "n": count}, monitors={"grad_norm": value})
        pending = rec.rings_snapshot()["steps"][0]
        elapsed = time.perf_counter() - t0
        assert first == 0 and not done.query() and elapsed < 0.1, elapsed
        assert pending["metrics"] == {"loss": flightrec.PENDING, "n": flightrec.PENDING}
        torch.cuda.synchronize()
        assert pub.publish(2, None) == 1
        assert pub.last == {"bn_mean_skew": 2.0, "clip_fraction": 2.0}
        entry = rec.rings_snapshot()["steps"][0]
        assert entry["metrics"] == {"loss": 1.0, "n": 3.0}
        assert entry["monitors"] == {"grad_norm": 2.0}
    finally:
        telemetry.set_enabled(None)


# -- serving on the card (ROADMAP A.12a) --------------------------------------


def test_engine_replay_is_its_eager_forward_bit_for_bit(cuda_triton, deterministic_cudnn):
    """Each bucket's captured graph returns what the engine's own module
    computes eagerly at the same padded size, bit for bit; the captures
    launched ``bn_normalize`` once a BN layer (20) beside the eager
    warm-up, no other BN kernel, and the replays none through the
    wrappers; the trainer's module stays in training mode."""
    from tpu_syncbn_torch import serve

    model, dp = _card_trainer()
    dp.train_step(_card_batch(0))
    eng = serve.InferenceEngine.from_trainer(dp, buckets=(4, 16))
    assert model.training and not eng.model.training
    x = _card_batch(1)[0].cpu().numpy()
    T.reset_launch_counts()
    eng.warm(x[:1])
    torch.cuda.synchronize()
    # each bucket: one eager warm-up forward and one captured forward
    assert T.launch_counts() == {**dict.fromkeys(T.LAUNCHES, 0), "bn_normalize": 2 * 2 * 20}
    for n in (3, 4, 11, 16):
        got = eng.predict(x[:n])
        b = eng.bucket_for(n)
        padded = np.concatenate([x[:n], np.zeros((b - n,) + x.shape[1:], x.dtype)])
        with torch.no_grad():
            want = eng.model(torch.from_numpy(padded).cuda()).float().cpu().numpy()[:n]
        assert got.shape == (n, 10) and np.array_equal(got, want), n
    assert T.launch_counts()["bn_normalize"] == 2 * 2 * 20 + 4 * 20  # the 4 eager refs
    assert eng.stats()["programs_compiled"] == 2


def test_engine_dict_batches_in_any_key_order_feed_each_key(cuda_triton):
    """A dict batch whose keys arrive in another insertion order replays
    the same graph, and each key's rows land in that key's static buffer
    (both leaves have one shape and dtype, so a swap would go unseen by
    the copy)."""
    from tpu_syncbn_torch import serve

    model, dp = _card_trainer()
    eng = serve.InferenceEngine.from_trainer(
        dp, buckets=(4,), apply_fn=lambda m, t: m(t["a"]).float() - 2 * t["b"][:, 0, 0, :1])
    a = _card_batch(1)[0][:3].cpu().numpy()
    b = _card_batch(2)[0][:3].cpu().numpy()
    first = eng.predict({"a": a, "b": b})
    again = eng.predict({"b": b, "a": a})
    assert np.array_equal(first, again)
    swapped = eng.predict({"a": b, "b": a})
    assert not np.array_equal(first, swapped)
    with torch.no_grad():
        want = (eng.model(torch.from_numpy(a).cuda()).float()
                - 2 * torch.from_numpy(b).cuda()[:, 0, 0, :1]).cpu().numpy()
    np.testing.assert_allclose(first, want, rtol=2e-2, atol=2e-2)
    assert eng.stats()["programs_compiled"] == 1


def test_dataparallel_body_contract_on_the_card_at_world_one(cuda_triton):
    """The audit's recorder (``DataParallel.lowered_train_step``) around the
    step body a K-step program captures, on the card at world 1: no
    collective, no host read, every parameter, buffer and momentum buffer
    written in place and the batch not, the 20 BN layers through the
    kernels; the trainer's state, ``.grad`` and step count as they were."""
    model, dp = _card_trainer()
    batch = _card_batch(3)
    dp.train_step(_card_batch(4))  # momentum buffers exist
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moms = [st["momentum_buffer"].clone() for st in dp.optimizer.state.values()]
    grads = [p.grad for p in model.parameters()]
    T.reset_launch_counts()
    lowered = dp.lowered_train_step(batch)
    torch.cuda.synchronize()
    c = lowered.contract(name="dataparallel.train_step")
    assert c.world == 1 and c.collectives == {} and c.host_callbacks == {}
    n_params = len(list(model.parameters()))
    assert c.donated_aliased == {"params": n_params, "rest": 3 * 20, "opt_state": n_params}
    assert T.launch_counts() == dict.fromkeys(T.launch_counts(), 20)
    assert lowered.cost_analysis()["flops"] > 0
    assert "aten.convolution" in lowered.as_text()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(st["momentum_buffer"], m)
               for st, m in zip(dp.optimizer.state.values(), moms))
    assert all(p.grad is g for p, g in zip(model.parameters(), grads))


def test_layer_three_on_a_cuda_body(cuda_triton):
    """The audit's layer 3 on the card at world 1: the trainer's step body
    recorded with the caching allocator's reading has no implicit reshard
    and a recorded peak at most the allocator's; and a storage freed
    mid-body leaves the live sum (two 4 MiB temporaries, the first dropped
    before the second is made: the input and one of them at the peak, as
    the allocator reads it too)."""
    from tpu_syncbn_torch.audit.contracts import extract_contract
    from tpu_syncbn_torch.mesh_axes import DATA_AXIS
    from tpu_syncbn_torch.parallel.layout import P

    model, dp = _card_trainer()
    dp.train_step(_card_batch(4))
    flow = dp.lowered_train_step(_card_batch(3), sharding=True, memory=True).flow()
    assert flow.mesh_axes == {DATA_AXIS: 1} and flow.implicit_reshards == 0
    assert 0 < flow.peak_bytes_per_device <= flow.xla_peak_bytes

    x = torch.zeros(1 << 20, device="cuda")

    def body(t):
        a = t + 1
        del a
        return t * 2

    s = extract_contract(body, (x,), name="t", world=1, arg_labels=("x",),
                         mesh_axes={DATA_AXIS: 1}, in_specs=(P(),), memory=True).sharding
    assert s.peak_bytes_per_device == 2 * (4 << 20)
    assert s.peak_bytes_per_device <= s.xla_peak_bytes


def test_recorder_keeps_the_seam_calls_of_the_cuda_backward_thread(cuda_triton):
    """A seam call in a CUDA tensor's backward runs on the autograd engine's
    device thread, which inherits the recorder's dispatch mode: the
    recorder keeps it. A call from a thread of its own is dropped."""
    import threading

    from tpu_syncbn_torch.audit import contracts
    from tpu_syncbn_torch.parallel import collectives

    threads = []

    class Tallied(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            threads.append(threading.get_ident())
            collectives._tally("psum", [g])
            return g * 2

    x = torch.ones(4, device="cuda", requires_grad=True)
    tallies = collectives._snapshot_tallies()
    try:
        with contracts.Recorder() as rec:
            Tallied.apply(x).sum().backward()
            side = threading.Thread(target=collectives._tally, args=("pmax", [x.detach()]))
            side.start()
            side.join()
    finally:
        collectives._restore_tallies(tallies)
    assert threads and threads[0] != threading.get_ident()
    assert [s[:2] for s in rec.seam] == [("psum", 16)]
