"""Tests that launch the Triton BN kernels: they need an NVIDIA card with
Triton, carry the ``gpu`` marker, and skip without one. The file imports
no JAX, so on a machine with a card it runs alone, without the suite's
JAX conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q -p no:cacheprovider

Each kernel is held against its plain PyTorch version on the same CUDA
tensors. Tolerances: per-channel sums 1e-5 of the largest sum (f32 sums
in another order); elementwise f32 outputs rtol 1e-5 / atol 1e-5; bf16
outputs one bf16 unit in the last place (rtol 2^-7).
"""

import pytest
import torch

from tpu_syncbn_torch import nn
from tpu_syncbn_torch.ops import batch_norm as bn_ops
from tpu_syncbn_torch.ops import triton_bn as T

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_triton():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Triton kernels have no CPU mode)")
    pytest.importorskip("triton")


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
