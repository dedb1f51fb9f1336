"""DCGAN / SNGAN — the counterpart of ``tpu_syncbn.models.gan``: the GAN
capability config (BASELINE.json config 5, "DCGAN / SNGAN CIFAR-10 with
SyncBN in G and D"; GANs are the second workload the reference's recipe
names as needing SyncBN).

Architectures as in the JAX package (32×32): a generator of stride-2
transposed convs with BN + ReLU and a tanh output; a discriminator of
stride-2 convs with BN (SNGAN: spectral-norm convs) + LeakyReLU. The
BatchNorm layers are the port's own, so ``convert_sync_batchnorm`` makes
both networks sync their statistics across replicas.

Public layout NHWC, as in the JAX package; inside, activations are
NCHW-shaped tensors in ``torch.channels_last`` memory, as
``models/resnet.py`` holds them, so every BN layer reads a dense
channel-last view with its fused kernels. Parameters are float32, drawn
from an explicit ``torch.Generator`` with the DCGAN init N(0, 0.02) for
every kernel, biases zero.

Two mappings from the JAX layers are not the obvious ones:

* ``nnx.ConvTranspose(..., padding="SAME")`` does not flip its kernel
  (``lax.conv_transpose`` with ``transpose_kernel=False``). It equals
  ``F.conv_transpose2d`` with the HWIO kernel permuted to (in, out, kh,
  kw) and flipped on both spatial axes, and padding ``k − 1 − pad_lo``
  where ``pad_lo`` is lax's low "SAME" padding of the dilated input
  (:func:`conv_transpose_padding`; 4×4 stride 2 gives padding 1, an 8×8
  output from a 4×4 input). :class:`ConvTranspose` stores the torch
  layout; ``models.weights`` flips the JAX kernel into it.
* :class:`SNConv`'s power iteration runs on the HWIO kernel reshaped to
  (kh·kw·cin, cout), which in OIHW is ``w.permute(2, 3, 1, 0)``; the norm
  adds 1e-12 (``torch.nn.utils.spectral_norm`` takes ``max(‖·‖, eps)``
  and keeps its own ``u``, so it agrees only within a tolerance).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_syncbn_torch.models.resnet import Conv2d, _pad_same
from tpu_syncbn_torch.nn.normalization import BatchNorm2d
from tpu_syncbn_torch.runtime.distributed import resolve_device

INIT_STD = 0.02  # DCGAN init


def _normal_init(w: torch.Tensor, generator: torch.Generator) -> None:
    with torch.no_grad():
        w.normal_(0.0, INIT_STD, generator=generator)


def _cl(x: torch.Tensor) -> torch.Tensor:
    """``x`` in channels_last memory (no copy when it already is)."""
    return x.contiguous(memory_format=torch.channels_last)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as a channels_last NCHW one."""
    return _cl(x.permute(0, 3, 1, 2))


def _linear(cin: int, cout: int, device, generator) -> nn.Linear:
    """``nnx.Linear`` with the DCGAN init: weight N(0, 0.02), bias zero."""
    fc = nn.Linear(cin, cout)
    with torch.no_grad():
        fc.weight.normal_(0.0, INIT_STD, generator=generator)
        fc.bias.zero_()
    return fc.to(device)


def _conv(cin, cout, kernel, stride, device, generator) -> Conv2d:
    """``nnx.Conv(padding="SAME")`` with a bias and the DCGAN init."""
    return Conv2d(cin, cout, kernel, stride, device=device, generator=generator,
                  bias=True, init=_normal_init)


def conv_transpose_padding(kernel: int, stride: int) -> tuple[int, int]:
    """``(padding, output_padding)`` of ``F.conv_transpose2d`` that
    reproduces ``lax.conv_transpose(..., padding="SAME")`` along one axis:
    lax pads the stride-dilated input by ``(lo, hi)``, with ``lo = k − 1``
    when ``s > k − 1`` and ``ceil((k + s − 2) / 2)`` otherwise; torch pads
    it by ``(k − 1 − p, k − 1 − p + output_padding)``."""
    total = kernel + stride - 2
    lo = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    hi = total - lo
    pad, out_pad = kernel - 1 - lo, hi - lo
    if pad < 0 or not 0 <= out_pad < max(stride, 1):
        raise ValueError(f"no conv_transpose2d padding reproduces SAME for "
                         f"kernel {kernel}, stride {stride}")
    return pad, out_pad


class ConvTranspose(nn.Module):
    """``nnx.ConvTranspose(cin, cout, (k, k), strides=(s, s),
    padding="SAME")``: output side = input side × s. The weight is held in
    ``F.conv_transpose2d``'s (in, out, kh, kw) layout, already flipped from
    the JAX kernel (module docstring)."""

    def __init__(self, cin, cout, kernel, stride, *, device, generator):
        super().__init__()
        self.stride = stride
        self.padding, self.output_padding = conv_transpose_padding(kernel, stride)
        w = torch.empty(cin, cout, kernel, kernel)
        _normal_init(w, generator)
        self.weight = nn.Parameter(_cl(w.to(device)))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        return _cl(F.conv_transpose2d(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding))


class SNConv(nn.Module):
    """Conv with spectral normalization (SNGAN): one power-iteration step
    per training forward. ``u`` is a buffer with
    ``torch.nn.utils.spectral_norm``'s semantics: it moves in train mode
    (every forward, under ``torch.no_grad()`` too) and is frozen in eval
    mode. ``u`` and ``v`` carry no gradient; ``σ = vᵀ W u'`` keeps the
    gradient path through W."""

    def __init__(self, cin, cout, kernel, stride, *, device, generator):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, stride, device, generator)
        u = torch.randn(cout, generator=generator) / math.sqrt(cout)
        self.register_buffer("u", u.to(device))

    def forward(self, x):
        w = self.conv.weight
        cout = w.shape[0]
        w2 = w.permute(2, 3, 1, 0).reshape(-1, cout)  # HWIO's (kh·kw·cin, cout)
        with torch.no_grad():
            w2_sg = w2.detach()
            v = w2_sg @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u_new = w2_sg.T @ v
            u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
            if self.training:
                self.u.copy_(u_new)
        sigma = v @ w2 @ u_new
        return F.conv2d(_pad_same(x, self.conv.kernel, self.conv.stride),
                        w / sigma, self.conv.bias, stride=self.conv.stride)


class DCGANGenerator(nn.Module):
    """latent (B, Z) → image (B, 32, 32, 3) in [-1, 1]."""

    def __init__(self, *, latent_dim: int = 128, width: int = 256,
                 device: str | torch.device | None = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.latent_dim = latent_dim
        self.width = width
        self.fc = _linear(latent_dim, 4 * 4 * width, dev, g)
        self.bn0 = BatchNorm2d(width, channel_axis=1, device=dev)
        self.deconvs = nn.ModuleList([
            ConvTranspose(width, width // 2, 4, 2, device=dev, generator=g),
            ConvTranspose(width // 2, width // 4, 4, 2, device=dev, generator=g),
            ConvTranspose(width // 4, width // 4, 4, 2, device=dev, generator=g),
        ])
        self.bns = nn.ModuleList([
            BatchNorm2d(width // 2, channel_axis=1, device=dev),
            BatchNorm2d(width // 4, channel_axis=1, device=dev),
            BatchNorm2d(width // 4, channel_axis=1, device=dev),
        ])
        self.out = _conv(width // 4, 3, 3, 1, dev, g)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _nchw(self.fc(z).reshape(z.shape[0], 4, 4, self.width))
        x = F.relu(self.bn0(x))
        for deconv, bn in zip(self.deconvs, self.bns):
            x = F.relu(bn(deconv(x)))
        return torch.tanh(self.out(x)).permute(0, 2, 3, 1)  # NHWC


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in the JAX model's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _Discriminator(nn.Module):
    """image (B, 32, 32, 3) → logit (B,), through ``_trunk`` (three
    stride-2 convs to (B, 4·width, 4, 4)) and one linear layer."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(_flatten_nhwc(self._trunk(x)))[:, 0]

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Spatially pooled penultimate activations, (B, 4·width): a fixed
        feature space for ``utils.fid.frechet_distance``."""
        return self._trunk(x).mean(dim=(2, 3))


class DCGANDiscriminator(_Discriminator):
    """BN on all but the first conv (DCGAN recipe), LeakyReLU(0.2)."""

    def __init__(self, *, width: int = 64,
                 device: str | torch.device | None = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.conv1 = _conv(3, width, 4, 2, dev, g)
        self.conv2 = _conv(width, width * 2, 4, 2, dev, g)
        self.bn2 = BatchNorm2d(width * 2, channel_axis=1, device=dev)
        self.conv3 = _conv(width * 2, width * 4, 4, 2, dev, g)
        self.bn3 = BatchNorm2d(width * 4, channel_axis=1, device=dev)
        self.fc = _linear(width * 4 * 4 * 4, 1, dev, g)

    def _trunk(self, x):
        x = F.leaky_relu(self.conv1(_nchw(x)), 0.2)
        x = F.leaky_relu(self.bn2(self.conv2(x)), 0.2)
        return F.leaky_relu(self.bn3(self.conv3(x)), 0.2)


class SNGANDiscriminator(_Discriminator):
    """Spectral-norm discriminator (SNGAN), LeakyReLU(0.1). BN is optional
    (SNGAN usually drops it in D); ``use_bn=True`` (the default, as in the
    JAX package) keeps SyncBN in D too, the capability config's "SyncBN in
    G and D"."""

    def __init__(self, *, width: int = 64, use_bn: bool = True,
                 device: str | torch.device | None = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        kw = dict(device=dev, generator=g)
        self.conv1 = SNConv(3, width, 4, 2, **kw)
        self.conv2 = SNConv(width, width * 2, 4, 2, **kw)
        self.bn2 = BatchNorm2d(width * 2, channel_axis=1, device=dev) if use_bn else None
        self.conv3 = SNConv(width * 2, width * 4, 4, 2, **kw)
        self.bn3 = BatchNorm2d(width * 4, channel_axis=1, device=dev) if use_bn else None
        self.fc = _linear(width * 4 * 4 * 4, 1, dev, g)

    def _trunk(self, x):
        x = F.leaky_relu(self.conv1(_nchw(x)), 0.1)
        x = self.conv2(x)
        if self.bn2 is not None:
            x = self.bn2(x)
        x = F.leaky_relu(x, 0.1)
        x = self.conv3(x)
        if self.bn3 is not None:
            x = self.bn3(x)
        return F.leaky_relu(x, 0.1)


# -- losses -------------------------------------------------------------------


def bce_gan_losses(real_logits, fake_logits):
    """DCGAN losses: D maximizes log D(x) + log(1 − D(G(z))); G maximizes
    log D(G(z)) (non-saturating). ``optax.sigmoid_binary_cross_entropy``
    is ``F.binary_cross_entropy_with_logits``."""
    bce = F.binary_cross_entropy_with_logits
    d_loss = (bce(real_logits, torch.ones_like(real_logits))
              + bce(fake_logits, torch.zeros_like(fake_logits)))
    g_loss = bce(fake_logits, torch.ones_like(fake_logits))
    return d_loss, g_loss


def hinge_gan_losses(real_logits, fake_logits):
    """SNGAN hinge losses."""
    d_loss = F.relu(1.0 - real_logits).mean() + F.relu(1.0 + fake_logits).mean()
    g_loss = -fake_logits.mean()
    return d_loss, g_loss
