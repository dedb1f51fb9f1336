"""ResNet family — the counterpart of ``tpu_syncbn.models.resnet``.

Public layout as in the JAX package: NHWC images in. Inside, activations
are NCHW-shaped tensors in ``torch.channels_last`` memory, so convolutions
run in cuDNN's preferred layout and every BatchNorm sees a dense
channel-last view (its fused kernels read it with no copy). The NHWC input
becomes such a tensor by ``permute(0, 3, 1, 2)``, also with no copy.

``dtype`` is the compute dtype of convolutions and the classifier (e.g.
``torch.bfloat16``); parameters stay float32, as ``nnx.Conv(dtype=...,
param_dtype=float32)`` keeps them, and BatchNorm accumulates in float32
and returns its input's dtype.

Padding is JAX's ``"SAME"``: for a stride-2 window it pads more on the
high side (the 7×7/2 stem at 224² pads (2, 3); a 3×3/2 conv or max-pool
pads (0, 1)). torch's symmetric ``padding=k//2`` gives the same output
size but other numbers, so the pads are computed from the input size and
applied with ``F.pad`` (−inf for the max-pool) before a ``padding=0`` op.

``small_input=True`` selects the CIFAR stem (3×3/1 conv, no max-pool).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from tpu_syncbn_torch.nn.normalization import BatchNorm2d
from tpu_syncbn_torch.runtime.distributed import resolve_device


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of JAX's ``"SAME"`` along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x.contiguous(memory_format=torch.channels_last)


def _trunc_normal_fan_out_(w: torch.Tensor, generator: torch.Generator):
    """He fan-out init of an OIHW kernel: truncated normal at ±2σ with the
    variance of ``variance_scaling(2.0, "fan_out", "truncated_normal")``."""
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    # std of a unit normal truncated to [-2, 2]
    std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class Conv2d(nn.Module):
    """Bias-free conv with JAX ``"SAME"`` padding; f32 weight (OIHW, held
    channels_last), computed in ``dtype``."""

    def __init__(self, cin, cout, kernel, stride, *, dtype=None, device,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.dtype = dtype
        w = torch.empty(cout, cin, kernel, kernel, dtype=torch.float32)
        _trunc_normal_fan_out_(w, generator)
        self.weight = nn.Parameter(
            w.to(device).contiguous(memory_format=torch.channels_last))

    def forward(self, x):
        w = self.weight if self.dtype is None else self.weight.to(self.dtype)
        return F.conv2d(_pad_same(x, self.kernel, self.stride), w,
                        stride=self.stride)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride, norm, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = Conv2d(cin, planes, 3, stride, **kw)
        self.bn1 = norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, **kw)
        self.bn2 = norm(planes)
        if stride != 1 or cin != planes * self.expansion:
            self.down_conv = Conv2d(cin, planes * self.expansion, 1, stride, **kw)
            self.down_bn = norm(planes * self.expansion)
        else:
            self.down_conv = None
            self.down_bn = None

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.down_conv is not None:
            identity = self.down_bn(self.down_conv(x))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride, norm, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = Conv2d(cin, planes, 1, 1, **kw)
        self.bn1 = norm(planes)
        # stride on the 3x3 (ResNet v1.5, as torchvision and the JAX model)
        self.conv2 = Conv2d(planes, planes, 3, stride, **kw)
        self.bn2 = norm(planes)
        self.conv3 = Conv2d(planes, planes * self.expansion, 1, 1, **kw)
        self.bn3 = norm(planes * self.expansion)
        if stride != 1 or cin != planes * self.expansion:
            self.down_conv = Conv2d(cin, planes * self.expansion, 1, stride, **kw)
            self.down_bn = norm(planes * self.expansion)
        else:
            self.down_conv = None
            self.down_bn = None

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.down_conv is not None:
            identity = self.down_bn(self.down_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Feature extractor + classifier head; NHWC images in, logits out.

    ``norm`` is any ``Callable[[int], nn.Module]`` (default: a
    channel-axis-1 :class:`BatchNorm2d` on ``device``); after
    ``convert_sync_batchnorm`` every instance is a SyncBatchNorm.
    Parameters are drawn from ``generator`` (default: seeded with 0) on the
    CPU, then moved to ``device``."""

    def __init__(
        self,
        block: type,
        layers: tuple[int, ...],
        *,
        num_classes: int = 1000,
        small_input: bool = False,
        norm: Callable[[int], nn.Module] | None = None,
        width: int = 64,
        dtype: torch.dtype | None = None,
        device: str | torch.device | None = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if norm is None:
            def norm(c):
                return BatchNorm2d(c, channel_axis=1, device=dev)
        self.small_input = small_input
        self.dtype = dtype
        kw = dict(dtype=dtype, device=dev, generator=generator)
        if small_input:
            self.stem_conv = Conv2d(3, width, 3, 1, **kw)
        else:
            self.stem_conv = Conv2d(3, width, 7, 2, **kw)
        self.stem_bn = norm(width)
        cin = width
        stages = []
        for i, n_blocks in enumerate(layers):
            planes = width * (2 ** i)
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(cin, planes, stride if b == 0 else 1,
                                    norm, **kw))
                cin = planes * block.expansion
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.fc = nn.Linear(cin, num_classes, dtype=torch.float32)
        with torch.no_grad():
            self.fc.weight.normal_(0.0, 0.01, generator=generator)
            self.fc.bias.zero_()
        self.fc.to(dev)
        self.feature_dim = cin

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Per-stage feature maps (C2..C5), NCHW-shaped, channels_last."""
        x = x.permute(0, 3, 1, 2)  # NHWC -> channels_last NCHW, no copy
        x = x.contiguous(memory_format=torch.channels_last)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        if not self.small_input:
            x = F.max_pool2d(_pad_same(x, 3, 2, value=float("-inf")), 3, 2)
        feats = []
        for stage in self.stages:
            for blk in stage:
                x = blk(x)
            feats.append(x)
        return feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)[-1]
        x = x.mean(dim=(2, 3))  # global average pool
        if self.dtype is None:
            return self.fc(x)
        return F.linear(x, self.fc.weight.to(self.dtype),
                        self.fc.bias.to(self.dtype))


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), **kw)


RESNETS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}
