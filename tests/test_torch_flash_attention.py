"""The port's attention op (``tpu_syncbn_torch.ops.cuda_attention``) against
the JAX package's Pallas flash attention, on the same inputs made with a
numpy seed. The JAX kernels run as their own tests run them on the CPU (in
interpret mode); the port runs the kernels' plain PyTorch versions, which
the card-only tests and ``chip_smoke.py`` hold the CUDA kernels against.

Tolerances: float32 forward 1e-5 (the same f32 arithmetic summed in
another order); float32 gradients 5e-5 (sums of up to L products of
order-one terms); bfloat16 outputs one bf16 unit in the last place at
their magnitude (2^-6 below 4: both sides compute in f32 and round once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_syncbn.ops import pallas_attention as pa
from tpu_syncbn.parallel import sequence as jseq
from tpu_syncbn_torch.ops import cuda_attention as A
from tpu_syncbn_torch.ops import kernel_mode
from tpu_syncbn_torch.parallel import sequence as tseq

B, H, D = 2, 3, 16
BF16_TOL = 2.0 ** -6


def make(l, n=4, seed=0, b=B, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(n)]


def to2d(x):
    """JAX's (B, L, H, D) -> (B*H, L, D)."""
    b, l, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, l, d)


def from_port(x):
    """The port's (B, L, H, D) tensor as JAX's (B*H, L, D) numpy array."""
    b, l, h, d = x.shape
    return x.detach().float().permute(0, 2, 1, 3).reshape(b * h, l, d).numpy()


def tt(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def jt(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [32, 100, 200])  # 100, 200: ragged final tiles
def test_plain_forward_matches_the_pallas_forward(l, causal, dtype):
    q, k, v = make(l, 3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    o_j, lse_j = pa._flash_fwd_2d(*(to2d(x).astype(jd) for x in (q, k, v)),
                                  causal=causal, scale=0.3, block_q=64,
                                  block_k=64)
    o_t, lse_t = A.flash_fwd_plain(*(tt(x, td) for x in (q, k, v)),
                                   causal=causal, scale=0.3)
    assert o_t.dtype == td and o_t.shape == (B, l, H, D)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (B * H, l)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    assert err(from_port(o_t), np.asarray(o_j, np.float32)) <= tol
    assert err(lse_t.numpy(), lse_j) <= 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_the_jax_function(causal):
    q, k, v = make(100, 3, seed=1)
    want = pa.flash_attention(jt(q), jt(k), jt(v), causal=causal)
    got = A.flash_attention(tt(q), tt(k), tt(v), causal=causal)
    assert got.shape == (B, 100, H, D)
    assert err(got.numpy(), want) <= 1e-5
    # and both equal the dense single-device attention of either package
    dense = tseq._single_device_attention(tt(q), tt(k), tt(v), causal=causal,
                                          scale=None)
    jdense = jseq._single_device_attention(jt(q), jt(k), jt(v), causal=causal,
                                           scale=None)
    assert err(dense.numpy(), jdense) <= 1e-5
    assert err(got.numpy(), dense.numpy()) <= 1e-5


@pytest.mark.parametrize("backward,block_k", [("xla", 128), ("xla", 48),
                                              ("pallas", 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_vjp(causal, backward, block_k):
    """FlashAttention's gradients against ``jax.vjp`` of the JAX function
    with the same backward; block_k = 48 does not divide L = 100."""
    q, k, v, w = make(100, 4, seed=2)

    def f(q_, k_, v_):
        return pa.flash_attention(q_, k_, v_, causal=causal, scale=0.4,
                                  block_q=64, block_k=block_k,
                                  backward=backward)

    o_j, vjp = jax.vjp(f, jt(q), jt(k), jt(v))
    grads_j = vjp(jt(w))
    qt, kt, vt = (tt(x).requires_grad_() for x in (q, k, v))
    o_t = A.flash_attention(qt, kt, vt, causal=causal, scale=0.4, block_q=64,
                            block_k=block_k, backward=backward)
    (o_t * tt(w)).sum().backward()
    assert err(o_t.detach().numpy(), o_j) <= 1e-5
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        assert err(got.numpy(), want) <= 5e-5


def _plain_vs_pallas_backward(causal, dtype, l):
    q, k, v, do = make(l, 4, seed=3, b=1, h=4, d=32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    q2, k2, v2, do2 = (to2d(x).astype(jd) for x in (q, k, v, do))
    o2, lse2 = pa._flash_fwd_2d(q2, k2, v2, causal=causal, scale=0.2,
                                block_q=64, block_k=64)
    dq_j, dk_j, dv_j = pa._flash_bwd_2d_pallas(
        (q2, k2, v2, o2, lse2), do2, causal=causal, scale=0.2, block_q=64,
        block_k=64)
    qt, kt, vt, dot = (tt(x, td) for x in (q, k, v, do))
    o_t, lse_t = A.flash_fwd_plain(qt, kt, vt, causal=causal, scale=0.2)
    delta = A.row_delta(dot, o_t)
    dk, dv = A.flash_bwd_dkdv_plain(qt, kt, vt, dot, lse_t, delta,
                                    causal=causal, scale=0.2)
    dq = A.flash_bwd_dq_plain(qt, kt, vt, dot, lse_t, delta, causal=causal,
                              scale=0.2)
    tol = 5e-5 if dtype == "float32" else BF16_TOL
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == td
        assert err(from_port(got), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_the_pallas_backward(causal, dtype):
    """flash_bwd_dkdv_plain and flash_bwd_dq_plain against
    ``_flash_bwd_2d_pallas`` (both kernels) on the same residuals; L = 200
    is ragged against the CUDA kernels' 128-row blocks and 32- or 64-row
    tiles (the last block's second warpgroup holds 8 live rows)."""
    _plain_vs_pallas_backward(causal, dtype, 200)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_the_pallas_backward_past_a_warpgroup(causal, dtype):
    """The same at L = 300 = 2 * 128 + 44: the second warpgroup of the
    CUDA dQ kernel's last 128-row block holds no live row."""
    _plain_vs_pallas_backward(causal, dtype, 300)


def test_scan_backward_honours_block_k_like_jax():
    """flash_bwd_scan (backward="xla") equals JAX's _flash_bwd_2d at every
    block_k, including ones that leave a ragged last block."""
    l = 100
    q, k, v, do = make(l, 4, seed=4)
    q2, k2, v2, do2 = (to2d(x) for x in (q, k, v, do))
    o2, lse2 = pa._flash_fwd_2d(q2, k2, v2, causal=True, scale=0.25,
                                block_q=128, block_k=128)
    qt, kt, vt, dot = (tt(x) for x in (q, k, v, do))
    o_t, lse_t = A.flash_fwd_plain(qt, kt, vt, causal=True, scale=0.25)
    for block_k in (16, 48, 128):
        want = pa._flash_bwd_2d((q2, k2, v2, o2, lse2), do2, causal=True,
                                scale=0.25, block_k=block_k)
        got = A.flash_bwd_scan(qt, kt, vt, o_t, lse_t, dot, causal=True,
                               scale=0.25, block_k=block_k)
        for g, w in zip(got, want):
            assert err(from_port(g), w) <= 5e-5


def test_argument_errors_match_the_jax_function():
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match=r"expected \(B, L, H, D\)"):
        A.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="backward must be 'xla' or 'pallas'"):
        A.flash_attention(q, q, q, backward="cuda")
    with pytest.raises(ValueError, match="identical"):
        A.flash_attention(q, q[:, :4], q)
    # the JAX function raises for the same three
    jq = jnp.zeros((1, 8, 2, 8))
    for args, kw in (((jq[0],) * 3, {}), ((jq,) * 3, {"backward": "cuda"}),
                     ((jq, jq[:, :4], jq), {})):
        with pytest.raises(ValueError):
            pa.flash_attention(*args, **kw)


def test_cpu_tensors_run_the_plain_versions_and_refuse_mode_on():
    q, k, v = (tt(x) for x in make(32, 3))
    A.reset_launch_counts()
    o_auto = A.flash_attention(q, k, v, causal=True)
    with kernel_mode("off"):
        o_off = A.flash_attention(q, k, v, causal=True)
    assert torch.equal(o_auto, o_off)
    assert A.launch_counts() == dict.fromkeys(A.LAUNCHES, 0)
    with kernel_mode("on"), pytest.raises(RuntimeError, match="needs CUDA"):
        A.flash_attention(q, k, v, causal=True)


def test_plain_versions_compute_in_float64_for_a_float64_reference():
    q, k, v, do = (tt(x, torch.float64) for x in make(64, 4, seed=5))
    o, lse = A.flash_fwd_plain(q, k, v, causal=True, scale=0.25)
    assert o.dtype == lse.dtype == torch.float64
    delta = A.row_delta(do, o)
    dk, dv = A.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, causal=True,
                                    scale=0.25)
    dq = A.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=True, scale=0.25)
    # the same gradients as autograd through the dense attention in float64
    qd, kd, vd = (x.clone().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd * 0.25, kd)
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), -torch.inf)
    ref = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vd)
    (ref * do).sum().backward()
    assert float((o - ref.detach()).abs().max()) < 1e-12
    for got, want in ((dq, qd.grad), (dk, kd.grad), (dv, vd.grad)):
        assert float((got - want).abs().max()) < 1e-12
