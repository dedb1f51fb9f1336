"""The port's GAN networks (``tpu_syncbn_torch.models.gan``) against
``tpu_syncbn.models.gan``: same weights (moved over by
``load_jax_params``), same numpy inputs, float32 on the CPU. The JAX
BatchNorm runs with its Pallas kernels forced on (interpret mode).

* the ``nnx.ConvTranspose`` mapping alone: flipped kernel, ``padding``
  from lax's "SAME" (and a plain HWIO → OIHW transpose must disagree);
* ``SNConv``: forward, ``u`` after a train-mode and an eval-mode forward,
  and the gradient through σ, against JAX, and against
  ``torch.nn.utils.parametrizations.spectral_norm`` within a tolerance;
* the generator, both discriminators (train mode: outputs and running
  statistics), ``features`` and both losses.

Tolerances: single ops (one transposed conv, the losses, ``u``) rtol
1e-5 / atol 1e-6; networks, and SNConv's output and gradients (sums of a
convolution over values up to ~50), rtol 2e-4 / atol 1e-5, as the JAX
package's conv-net parity tests (f32 sums in another order); against
torch's ``spectral_norm``, which puts eps as ``max(‖·‖, 1e-12)`` where
JAX adds 1e-12 and normalizes W as (cout, cin·kh·kw), rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from test_torch_resnet import flat_state
from tpu_syncbn.models import gan as jgan
from tpu_syncbn.ops import batch_norm as jbn
from tpu_syncbn_torch import models, nn
from tpu_syncbn_torch.models import gan
from tpu_syncbn_torch.models.weights import _port_name

OP = dict(rtol=1e-5, atol=1e-6)
NET = dict(rtol=2e-4, atol=1e-5)


def port_value(model, key, value):
    """The port's tensor for a JAX state key, and the JAX value in the
    port's layout."""
    name, arr = _port_name(key, value, model)
    live = dict(model.named_parameters())
    live.update(dict(model.named_buffers()))
    return live[name].detach().numpy(), arr


def assert_state_matches(model, jstate, tol=NET):
    for key, want in jstate.items():
        got, arr = port_value(model, key, want)
        np.testing.assert_allclose(got, arr, err_msg=key, **tol)


class _Holder(torch.nn.Module):
    def __init__(self, mod):
        super().__init__()
        self.deconv = mod


@pytest.mark.parametrize("kernel,stride,side", [(4, 2, 4), (4, 2, 5), (2, 2, 4),
                                                (3, 1, 5), (5, 3, 4)])
def test_conv_transpose_mapping(kernel, stride, side):
    jct = nnx.ConvTranspose(3, 5, (kernel, kernel), strides=(stride, stride),
                            padding="SAME", rngs=nnx.Rngs(3))
    x = np.random.RandomState(0).randn(2, side, side, 3).astype(np.float32)
    want = np.asarray(jct(jnp.asarray(x)))
    assert want.shape == (2, side * stride, side * stride, 5)
    port = _Holder(gan.ConvTranspose(3, 5, kernel, stride, device="cpu",
                                     generator=torch.Generator().manual_seed(0)))
    k, b = np.asarray(jct.kernel[...]), np.asarray(jct.bias[...])
    models.load_jax_params(port, {"deconv.kernel": k, "deconv.bias": b})
    got = port.deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **OP)
    # the same-shaped wrong mapping (no flip) disagrees: the shape check of
    # a converter cannot catch it, this value check does
    wrong = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
    p, op = gan.conv_transpose_padding(kernel, stride)
    bad = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), wrong,
                             torch.from_numpy(b), stride=stride, padding=p,
                             output_padding=op).permute(0, 2, 3, 1)
    assert np.abs(bad.numpy() - want).max() > 1e-2


def test_conv_transpose_refuses_a_same_padding_torch_cannot_express():
    # 3x3 stride 2: lax pads the dilated input (2, 1); conv_transpose2d's
    # padding is at least as large on the high side
    with pytest.raises(ValueError, match="kernel 3, stride 2"):
        gan.conv_transpose_padding(3, 2)


def _sn_pair(seed=0):
    jsn = jgan.SNConv(3, 6, (4, 4), (2, 2), nnx.Rngs(seed))
    port = gan.SNConv(3, 6, 4, 2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    models.load_jax_params(port, flat_state(jsn))
    return jsn, port


def test_snconv_forward_u_and_gradient_match_jax():
    jsn, port = _sn_pair()
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    r = rs.randn(2, 4, 4, 6).astype(np.float32)
    u0 = port.u.clone()

    # eval: u frozen on both sides
    jsn.eval()
    port.eval()
    y_eval = np.asarray(jsn(jnp.asarray(x)))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), y_eval, **NET)
    assert torch.equal(port.u, u0)

    # train: u moves on both sides, and the gradient reaches the kernel
    # through sigma
    jsn.train()
    port.train()

    def jloss(m):
        return (m(jnp.asarray(x)) * jnp.asarray(r)).sum()

    jl, jgrads = nnx.value_and_grad(jloss)(jsn)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    yt = port(xt).permute(0, 2, 3, 1)
    (yt * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(float((yt * torch.from_numpy(r)).sum().detach()),
                               float(jl), rtol=1e-5)
    assert not torch.equal(port.u, u0)
    np.testing.assert_allclose(port.u.numpy(), np.asarray(jsn.u[...]), **OP)
    jk = np.asarray(jgrads.conv.kernel[...])
    np.testing.assert_allclose(port.conv.weight.grad.permute(2, 3, 1, 0).numpy(), jk,
                               **NET)
    np.testing.assert_allclose(port.conv.bias.grad.numpy(),
                               np.asarray(jgrads.conv.bias[...]), **NET)


def test_snconv_matches_torch_spectral_norm_within_a_tolerance():
    """torch's parametrization of the same (reshaped) weight, started from
    the same ``u``: same σ and new ``u``, same output and gradient, within
    eps placement."""
    _, port = _sn_pair()
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(2, 3, 8, 8).astype(np.float32))
    ref = torch.nn.Conv2d(3, 6, 4, stride=2, padding=1)
    with torch.no_grad():
        ref.weight.copy_(port.conv.weight)
        ref.bias.copy_(port.conv.bias)
    # torch normalizes W as (cout, cin·kh·kw), its u on the cout side as
    # ours, but its iteration runs u from v and then v from u, and σ takes
    # the new v where ours keeps the old one: so start torch's (u, v) where
    # our one iteration from u ends, and let it iterate no further
    ref = torch.nn.utils.parametrizations.spectral_norm(ref)
    sn = ref.parametrizations.weight[0]
    sn.n_power_iterations = 0
    with torch.no_grad():
        w = port.conv.weight.reshape(6, -1)
        v = F.normalize(w.T @ port.u, dim=0)
        sn._v.copy_(v)
        sn._u.copy_(F.normalize(w @ v, dim=0))
    port.train()
    ref.train()
    y_port = port(x)
    y_ref = ref(x)
    torch.testing.assert_close(y_port, y_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(port.u, sn._u, rtol=1e-4, atol=1e-6)
    y_port.square().sum().backward()
    y_ref.square().sum().backward()
    torch.testing.assert_close(port.conv.weight.grad,
                               ref.parametrizations.weight.original.grad,
                               rtol=1e-4, atol=1e-5)


def _net_pairs(which):
    if which == "generator":
        j = jgan.DCGANGenerator(latent_dim=8, width=16, rngs=nnx.Rngs(0))
        p = gan.DCGANGenerator(latent_dim=8, width=16, device="cpu")
    elif which == "dcgan_d":
        j = jgan.DCGANDiscriminator(width=8, rngs=nnx.Rngs(1))
        p = gan.DCGANDiscriminator(width=8, device="cpu")
    else:
        j = jgan.SNGANDiscriminator(width=8, rngs=nnx.Rngs(1))
        p = gan.SNGANDiscriminator(width=8, device="cpu")
    p = nn.convert_sync_batchnorm(p)
    models.load_jax_params(p, flat_state(j))
    return j, p


@pytest.mark.parametrize("which", ["generator", "dcgan_d", "sngan_d"])
def test_networks_match_jax_in_train_mode(which):
    rs = np.random.RandomState(4)
    x = (rs.randn(6, 8) if which == "generator" else rs.randn(6, 32, 32, 3)).astype(np.float32)
    with jbn.pallas_mode("on"):
        j, p = _net_pairs(which)
        j.train()
        want = np.asarray(j(jnp.asarray(x)))
        jstate = flat_state(j)
    p.train()
    got = p(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert got.shape == ((6, 32, 32, 3) if which == "generator" else (6,))
    np.testing.assert_allclose(got, want, **NET)
    assert_state_matches(p, jstate)  # running stats (and u) moved alike


@pytest.mark.parametrize("which", ["dcgan_d", "sngan_d"])
def test_features_match_jax_in_eval_mode(which):
    x = np.random.RandomState(5).randn(4, 32, 32, 3).astype(np.float32)
    j, p = _net_pairs(which)
    j.eval()
    p.eval()
    want = np.asarray(j.features(jnp.asarray(x)))
    got = p.features(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (4, 32)
    np.testing.assert_allclose(got, want, **NET)


def test_generator_layout_and_range():
    g = gan.DCGANGenerator(device="cpu")
    assert [m.num_features for m in g.modules() if isinstance(m, nn.BatchNorm)] \
        == [256, 128, 64, 64]
    y = g(torch.randn(3, 128))
    assert y.shape == (3, 32, 32, 3) and float(y.abs().max()) <= 1.0
    d = gan.SNGANDiscriminator(device="cpu")
    assert [m.num_features for m in d.modules() if isinstance(m, nn.BatchNorm)] == [128, 256]
    assert gan.SNGANDiscriminator(use_bn=False, device="cpu").bn2 is None


@pytest.mark.parametrize("name", ["bce", "hinge"])
def test_losses_match_jax(name):
    rs = np.random.RandomState(6)
    real, fake = (rs.randn(16).astype(np.float32) * 3 for _ in range(2))
    jfn = {"bce": jgan.bce_gan_losses, "hinge": jgan.hinge_gan_losses}[name]
    tfn = {"bce": gan.bce_gan_losses, "hinge": gan.hinge_gan_losses}[name]
    want = [float(v) for v in jfn(jnp.asarray(real), jnp.asarray(fake))]
    got = [float(v) for v in tfn(torch.from_numpy(real), torch.from_numpy(fake))]
    np.testing.assert_allclose(got, want, **OP)


def test_transposed_kernel_loads_flipped_and_anchors_are_checked():
    """The converter asks the target module's kind: a generator's deconv
    kernel is flipped, a conv's is not; a missing partner raises."""
    j, p = _net_pairs("generator")
    k = np.asarray(j.deconvs[0].kernel[...])
    np.testing.assert_array_equal(
        p.deconvs[0].weight.detach().numpy(), k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    np.testing.assert_array_equal(
        p.out.weight.detach().numpy(), np.asarray(j.out.kernel[...]).transpose(3, 2, 0, 1))
    state = flat_state(j)
    state.pop("bns.0.running_var")
    with pytest.raises(KeyError, match="bns.0.running_var"):
        models.load_jax_params(p, state)
    assert jax.device_count() == 8  # the suite's CPU mesh
