"""tpu_syncbn_torch.ops.batch_norm against tpu_syncbn.ops.batch_norm on the
same numpy inputs (CPU, JAX as its own tests run it).

Tolerances: f32 results rtol 1e-5 (same formulas, sums taken in another
order); an atol of 1e-5 covers values near zero. bf16 outputs may differ by
one bf16 unit in the last place (2^-7 relative) where the f32 value before
rounding differs in its last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_syncbn.ops import batch_norm as jbn
from tpu_syncbn_torch.ops import batch_norm as tbn

C = 6
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_OUT = dict(rtol=2 ** -7, atol=1e-5)


def rand(seed, shape, scale=1.5, shift=0.2):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def pair(a, dtype="float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.array(a)).to(td)


def npf(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(npf(got), npf(want), **(tol or F32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channel_axis", [-1, 1])
def test_batch_norm_stats(dtype, channel_axis):
    shape = (4, 5, 3, C) if channel_axis == -1 else (4, C, 5, 3)
    jx, tx = pair(rand(0, shape), dtype)
    for got, want in zip(tbn.batch_norm_stats(tx, channel_axis=channel_axis),
                         jbn.batch_norm_stats(jx, channel_axis=channel_axis)):
        close(got, want)


@pytest.mark.parametrize("mask_kind", ["none", "partial", "empty"])
def test_sync_moments(mask_kind):
    x = rand(1, (4, 5, 3, C))
    if mask_kind == "none":
        jm = tm = None
    else:
        m = (np.random.RandomState(2).rand(4, 5, 3, 1) > 0.4).astype(np.float32)
        if mask_kind == "empty":  # an empty shard: every element masked out
            m = np.zeros_like(m)
        jm, tm = jnp.asarray(m), torch.from_numpy(m)
    want = jbn.sync_moments(jnp.asarray(x), mask=jm)
    got = tbn.sync_moments(torch.from_numpy(x), mask=tm)
    for g, w in zip(got, want):
        close(g, w)
    if mask_kind == "empty":
        assert float(got[2].sum()) == 0.0
        assert np.all(npf(got[0]) == 0) and np.all(npf(got[1]) == 0)


@pytest.mark.parametrize("affine", ["both", "weight", "bias", "none"])
def test_fold_scale_shift(affine):
    rs = np.random.RandomState(3)
    mean = rs.randn(C).astype(np.float32)
    var = rs.uniform(0.5, 2, C).astype(np.float32)
    w = rs.uniform(0.5, 1.5, C).astype(np.float32) if affine in ("both", "weight") else None
    b = rs.randn(C).astype(np.float32) if affine in ("both", "bias") else None
    want = jbn.fold_scale_shift(*(None if a is None else jnp.asarray(a)
                                  for a in (mean, var, w, b)), 1e-5)
    got = tbn.fold_scale_shift(*(None if a is None else torch.from_numpy(a)
                                 for a in (mean, var, w, b)), 1e-5)
    for g, wv in zip(got, want):
        close(g, wv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channel_axis", [-1, 1])
def test_batch_norm_elemt(dtype, channel_axis):
    shape = (4, 5, 3, C) if channel_axis == -1 else (4, C, 5, 3)
    jx, tx = pair(rand(4, shape), dtype)
    rs = np.random.RandomState(5)
    mean, var = rs.randn(C).astype(np.float32), rs.uniform(0.5, 2, C).astype(np.float32)
    w, b = rs.uniform(0.5, 1.5, C).astype(np.float32), rs.randn(C).astype(np.float32)
    want = jbn.batch_norm_elemt(jx, *map(jnp.asarray, (mean, var, w, b)), 1e-5,
                                channel_axis=channel_axis)
    got = tbn.batch_norm_elemt(tx, *map(torch.from_numpy, (mean, var, w, b)),
                               1e-5, channel_axis=channel_axis)
    assert got.dtype == DTYPES[dtype][1]
    close(got, want, **(F32 if dtype == "float32" else BF16_OUT))


@pytest.mark.parametrize("momentum", [0.1, None])
@pytest.mark.parametrize("count", [1.0, 60.0, 0.0])
def test_update_running_stats(momentum, count):
    rs = np.random.RandomState(6)
    rm, rv = rs.randn(C).astype(np.float32), rs.uniform(0.5, 2, C).astype(np.float32)
    bm, bv = rs.randn(C).astype(np.float32), rs.uniform(0.5, 2, C).astype(np.float32)
    want = jbn.update_running_stats(
        jnp.asarray(rm), jnp.asarray(rv), jnp.asarray(3, jnp.int32),
        jnp.asarray(bm), jnp.asarray(bv), jnp.float32(count), momentum)
    got = tbn.update_running_stats(
        torch.from_numpy(rm), torch.from_numpy(rv), torch.tensor(3),
        torch.from_numpy(bm), torch.from_numpy(bv), torch.tensor(count),
        momentum)
    close(got[0], want[0])
    close(got[1], want[1])
    assert int(got[2]) == int(want[2]) == 4


def _train_pair(x, dtype, affine, momentum, mask=None):
    rs = np.random.RandomState(7)
    c = x.shape[-1]
    w = rs.uniform(0.5, 1.5, c).astype(np.float32) if affine else None
    b = rs.randn(c).astype(np.float32) if affine else None
    rm, rv = np.zeros(c, np.float32), np.ones(c, np.float32)
    jx, tx = pair(x, dtype)
    jy, jstats = jbn.batch_norm_train(
        jx, jnp.asarray(rm), jnp.asarray(rv), jnp.asarray(0, jnp.int32),
        None if w is None else jnp.asarray(w), None if b is None else jnp.asarray(b),
        momentum=momentum, mask=None if mask is None else jnp.asarray(mask))
    ty, tstats = tbn.batch_norm_train(
        tx, torch.from_numpy(rm), torch.from_numpy(rv), torch.tensor(0),
        None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b),
        momentum=momentum, mask=None if mask is None else torch.from_numpy(mask))
    return (jy, jstats), (ty, tstats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("momentum", [0.1, None])
def test_batch_norm_train(dtype, affine, momentum):
    (jy, js), (ty, ts) = _train_pair(rand(8, (4, 5, 3, C)), dtype, affine, momentum)
    assert ty.dtype == DTYPES[dtype][1]
    close(ty, jy, **(F32 if dtype == "float32" else BF16_OUT))
    close(ts[0], js[0])
    close(ts[1], js[1])
    assert int(ts[2]) == int(js[2]) == 1


def test_batch_norm_train_single_element_keeps_biased_var():
    """n = 1: the unbiased correction would divide by zero; the biased
    value (0) goes into the running var instead."""
    (jy, js), (ty, ts) = _train_pair(rand(9, (1, C)), "float32", True, 0.1)
    close(ty, jy)
    close(ts[1], js[1])
    np.testing.assert_allclose(npf(ts[1]), 0.9 * np.ones(C), rtol=1e-6)


def test_batch_norm_train_with_mask():
    m = (np.random.RandomState(10).rand(4, 5, 3, 1) > 0.3).astype(np.float32)
    (jy, js), (ty, ts) = _train_pair(rand(11, (4, 5, 3, C)), "float32", True,
                                     0.1, mask=m)
    close(ty, jy)
    close(ts[0], js[0])
    close(ts[1], js[1])


def test_batch_norm_train_without_running_stats():
    x = rand(12, (4, 5, 3, C))
    jy, jstats = jbn.batch_norm_train(jnp.asarray(x), None, None, None, None, None)
    ty, tstats = tbn.batch_norm_train(torch.from_numpy(x), None, None, None, None, None)
    assert tstats == (None, None, None) and jstats == (None, None, None)
    close(ty, jy)


@pytest.mark.parametrize("mask", [False, True])
def test_batch_norm_train_gradients(mask):
    """Gradients of a weighted sum of y w.r.t. (x, γ, β): the port's
    (fused-kernel plain path, or differentiable plain ops with a mask)
    against jax.grad of the JAX op. Gradients involve a cancellation
    (dy − mean terms), so atol 1e-5 on O(1) values."""
    rs = np.random.RandomState(13)
    x = rand(14, (4, 5, 3, C))
    coeff = rs.randn(4, 5, 3, C).astype(np.float32)
    w = rs.uniform(0.5, 1.5, C).astype(np.float32)
    b = rs.randn(C).astype(np.float32)
    m = (rs.rand(4, 5, 3, 1) > 0.3).astype(np.float32) if mask else None

    def jloss(xx, ww, bb):
        y, _ = jbn.batch_norm_train(xx, None, None, None, ww, bb,
                                    mask=None if m is None else jnp.asarray(m))
        return jnp.sum(y * jnp.asarray(coeff))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    ty, _ = tbn.batch_norm_train(tx, None, None, None, tw, tb,
                                 mask=None if m is None else torch.from_numpy(m))
    (ty * torch.from_numpy(coeff)).sum().backward()
    for g, want in zip((tx.grad, tw.grad, tb.grad), jg):
        close(g, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("channel_axis", [-1, 1])
def test_batch_norm_inference(channel_axis):
    shape = (4, 5, 3, C) if channel_axis == -1 else (4, C, 5, 3)
    x = rand(15, shape)
    rs = np.random.RandomState(16)
    rm, rv = rs.randn(C).astype(np.float32), rs.uniform(0.5, 2, C).astype(np.float32)
    w, b = rs.uniform(0.5, 1.5, C).astype(np.float32), rs.randn(C).astype(np.float32)
    want = jbn.batch_norm_inference(jnp.asarray(x), *map(jnp.asarray, (rm, rv, w, b)),
                                    channel_axis=channel_axis)
    got = tbn.batch_norm_inference(torch.from_numpy(x), *map(torch.from_numpy, (rm, rv, w, b)),
                                   channel_axis=channel_axis)
    close(got, want)


def test_kernel_mode_switch():
    assert tbn.get_kernel_mode() == "auto"
    with tbn.kernel_mode("off"):
        assert tbn.get_kernel_mode() == "off"
    assert tbn.get_kernel_mode() == "auto"
    with pytest.raises(ValueError, match="kernel mode"):
        tbn.set_kernel_mode("fast")
    x = torch.from_numpy(rand(17, (4, 5, 3, C)))
    with tbn.kernel_mode("on"):  # "on" refuses to run the plain version
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            tbn.batch_norm_train(x, None, None, None, None, None)
    with tbn.kernel_mode("off"):
        y_off, _ = tbn.batch_norm_train(x, None, None, None, None, None)
    y_auto, _ = tbn.batch_norm_train(x, None, None, None, None, None)
    assert torch.equal(y_off, y_auto)  # on the CPU both run the plain version


@pytest.mark.parametrize("layout", ["nhwc", "nchw_contiguous", "strided"])
def test_kernel_mode_on_refuses_cpu_tensors_of_any_layout(layout):
    """Under "on" a CPU tensor raises whatever its memory layout: a view the
    kernels could not read must not slip onto the plain ops instead. Under
    "auto" the same input runs the plain ops and matches JAX."""
    x = rand(18, (4, C, 5, 6))
    if layout == "nhwc":
        xt, xj, axis = torch.from_numpy(x).permute(0, 2, 3, 1).contiguous(), \
            x.transpose(0, 2, 3, 1), -1
    elif layout == "nchw_contiguous":
        xt, xj, axis = torch.from_numpy(x), x, 1
    else:  # every other column of an NHWC tensor: channel-last, not dense
        xt = torch.from_numpy(x).permute(0, 2, 3, 1)[:, :, ::2]
        xj, axis = x.transpose(0, 2, 3, 1)[:, :, ::2], -1
    with tbn.kernel_mode("on"):
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            tbn.batch_norm_train(xt, None, None, None, None, None,
                                 channel_axis=axis)
    ty, _ = tbn.batch_norm_train(xt, None, None, None, None, None,
                                 channel_axis=axis)
    jy, _ = jbn.batch_norm_train(jnp.asarray(np.ascontiguousarray(xj)), None,
                                 None, None, None, None, channel_axis=axis)
    close(ty, jy)
