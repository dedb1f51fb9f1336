"""The port's ResNet against tpu_syncbn.models.resnet: same weights (moved
over by load_jax_params), same numpy images, forward in train and eval
mode, float32 on the CPU.

The ImageNet stem (7x7/2 conv, 3x3/2 max-pool) runs on an even-sized
input, where JAX's "SAME" padding is asymmetric ((2, 3) and (0, 1)): a
port that padded symmetrically would disagree here.

Tolerance: rtol 2e-4, atol 1e-5, as the JAX package's own conv-net parity
tests use (tests/test_pallas_bn.py): two convolution implementations sum
in different orders, and a dozen layers carry that rounding forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tpu_syncbn import compat
from tpu_syncbn import models as jmodels
from tpu_syncbn_torch import models as tmodels
from tpu_syncbn_torch.models.resnet import same_pads

TOL = dict(rtol=2e-4, atol=1e-5)


def flat_state(model) -> dict:
    """The JAX model's state as ``{"stem_conv.kernel": ndarray, ...}``."""
    out = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = np.asarray(v)

    walk(compat.nnx_to_pure_dict(nnx.state(model)), "")
    return out


def build_pair(kind, small_input):
    kw = dict(num_classes=10, small_input=small_input, width=8)
    if kind == "bottleneck":
        jm = jmodels.ResNet(jmodels.Bottleneck, (1, 1, 1, 1), rngs=nnx.Rngs(0), **kw)
        tm = tmodels.ResNet(tmodels.Bottleneck, (1, 1, 1, 1), device="cpu", **kw)
    else:
        jm = jmodels.resnet18(rngs=nnx.Rngs(0), **kw)
        tm = tmodels.resnet18(device="cpu", **kw)
    tmodels.load_jax_params(tm, flat_state(jm))
    return jm, tm


def bn_buffers(tm) -> dict:
    return {k: v.numpy() for k, v in tm.named_buffers()}


@pytest.mark.parametrize("small_input,side", [(False, 32), (True, 16)],
                         ids=["imagenet_stem", "cifar_stem"])
@pytest.mark.parametrize("kind", ["bottleneck", "basic"])
def test_forward_matches_jax_in_train_and_eval(kind, small_input, side):
    jm, tm = build_pair(kind, small_input)
    x = np.random.RandomState(0).randn(4, side, side, 3).astype(np.float32)

    # train mode: batch statistics, running buffers updated by both
    jm.train()
    tm.train()
    jy = jm(jnp.asarray(x))
    ty = tm(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    want = flat_state(jm)
    for name, got in bn_buffers(tm).items():
        np.testing.assert_allclose(got, want[name], err_msg=name, **TOL)

    # eval mode: the running statistics both just wrote
    jm.eval()
    tm.eval()
    x2 = np.random.RandomState(1).randn(3, side, side, 3).astype(np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(x2)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(x2))), **TOL)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (7, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (15, 3, 2, (1, 1)),
])
def test_same_pads_are_jax_same(size, kernel, stride, want):
    """The pads JAX's "SAME" applies, checked against lax's own rule."""
    assert same_pads(size, kernel, stride) == want
    lax_pads = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tuple(lax_pads[0]) == want


def test_load_jax_params_layouts_and_mismatches():
    jm, tm = build_pair("basic", True)
    state = flat_state(jm)
    # HWIO -> OIHW for convs, (in, out) -> (out, in) for the classifier
    np.testing.assert_array_equal(
        tm.stem_conv.weight.detach().numpy(),
        state["stem_conv.kernel"].transpose(3, 2, 0, 1))
    assert tm.stem_conv.weight.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(tm.fc.weight.detach().numpy(),
                                  state["fc.kernel"].T)
    with pytest.raises(KeyError, match="no JAX value"):
        tmodels.load_jax_params(tm, {k: v for k, v in state.items()
                                     if k != "fc.bias"})
    with pytest.raises(KeyError, match="has no"):
        tmodels.load_jax_params(tm, dict(state, **{"extra.kernel": np.zeros((2, 2))}))
    with pytest.raises(ValueError, match="does not match"):
        tmodels.load_jax_params(tm, dict(state, **{"fc.bias": np.zeros(3)}))


def test_activations_stay_channels_last_for_the_bn_kernels():
    """Every BN input is NCHW-shaped in channels_last memory, so its
    channel-last view is dense and the fused kernels read it with no copy."""
    _, tm = build_pair("bottleneck", False)
    seen = []
    for mod in tm.modules():
        if isinstance(mod, tmodels.resnet.BatchNorm2d):
            mod.register_forward_pre_hook(lambda m, a: seen.append(
                a[0].is_contiguous(memory_format=torch.channels_last)))
    tm(torch.zeros(2, 32, 32, 3))
    assert len(seen) == 17 and all(seen)  # stem + 4 x (3 + down)


def test_bf16_compute_keeps_f32_params_and_bn_output_dtype():
    tm = tmodels.resnet18(num_classes=10, small_input=True, width=8,
                          dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    out = tm(torch.from_numpy(
        np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32)))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 10)
    assert torch.isfinite(out.float()).all()
