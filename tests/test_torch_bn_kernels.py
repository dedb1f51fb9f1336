"""The BN kernels' plain versions (what every wrapper runs on a CPU tensor)
against tpu_syncbn.ops.pallas_bn, whose Pallas kernels run in interpret
mode on the CPU as the JAX package's own tests run them; FusedBatchNorm's
forward and gradients against jax.vjp of pallas_bn.fused_batch_norm.

Tolerances: per-channel sums rtol 1e-5 of the largest sum (f32, summed in
another order; a sum near zero by cancellation carries the rounding of its
terms); elementwise f32 outputs rtol 1e-5, atol 1e-5; bf16 outputs one
bf16 unit in the last place (rtol 2^-7).

The kernels themselves launch only on a card: tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_syncbn.ops import pallas_bn
from tpu_syncbn_torch.ops import cuda_bn as B
from tpu_syncbn_torch.ops import triton_bn as T

# (M as N·H·W shape, C): M = 60 and 300 are multiples of no row block
# (Pallas' 256/128/64, the port's 64), C = 2048 is ResNet-50's widest layer
SHAPES = [((1, 60, 1, 6), "m60_c6"), ((8, 16, 16, 6), "m2048_c6"),
          ((300, 2048), "m300_c2048")]
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rand(seed, shape, scale=1.5, shift=0.2):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def pair(a, dtype):
    jd, td = DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.array(a)).to(td)


def npf(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def close_sums(got, want):
    g, w = npf(got), npf(want)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-6)


def close_elem(got, want, dtype):
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(npf(got), npf(want), **tol)


def stats_inputs(shape, seed):
    c = shape[-1]
    rs = np.random.RandomState(seed)
    return (rs.randn(c).astype(np.float32), rs.uniform(0.5, 2, c).astype(np.float32),
            rs.uniform(0.5, 1.5, c).astype(np.float32), rs.randn(c).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,_id", SHAPES, ids=[s[1] for s in SHAPES])
def test_bn_stats_plain_matches_pallas(shape, _id, dtype):
    jx, tx = pair(rand(0, shape), dtype)
    s_j, sq_j, n_j = pallas_bn.bn_stats(jx)
    s_t, sq_t, n_t = T.bn_stats(tx)
    close_sums(s_t, s_j)
    close_sums(sq_t, sq_j)
    assert float(n_t) == float(n_j) == np.prod(shape[:-1])
    assert s_t.dtype == sq_t.dtype == n_t.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,_id", SHAPES, ids=[s[1] for s in SHAPES])
@pytest.mark.parametrize("affine", [True, False])
def test_bn_normalize_plain_matches_pallas(shape, _id, dtype, affine):
    jx, tx = pair(rand(1, shape), dtype)
    mean, var, w, b = stats_inputs(shape, 2)
    w, b = (w, b) if affine else (None, None)
    y_j = pallas_bn.bn_normalize(jx, jnp.asarray(mean), jnp.asarray(var),
                                 None if w is None else jnp.asarray(w),
                                 None if b is None else jnp.asarray(b), 1e-5)
    y_t = T.bn_normalize(tx, torch.from_numpy(mean), torch.from_numpy(var),
                         None if w is None else torch.from_numpy(w),
                         None if b is None else torch.from_numpy(b), 1e-5)
    assert y_t.dtype == DT[dtype][1] and y_t.shape == tx.shape
    close_elem(y_t, y_j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,_id", SHAPES, ids=[s[1] for s in SHAPES])
def test_bn_backward_reduce_plain_matches_pallas(shape, _id, dtype):
    x, dy = rand(3, shape), rand(4, shape, 1.0, 0.0)
    jx, tx = pair(x, dtype)
    jdy, tdy = pair(dy, dtype)
    mean, var, _, _ = stats_inputs(shape, 5)
    invstd = (1.0 / np.sqrt(var + 1e-5)).astype(np.float32)
    sdy_j, sdyx_j = pallas_bn.bn_backward_reduce(jdy, jx, jnp.asarray(mean), jnp.asarray(invstd))
    sdy_t, sdyx_t = T.bn_backward_reduce(tdy, tx, torch.from_numpy(mean), torch.from_numpy(invstd))
    close_sums(sdy_t, sdy_j)
    close_sums(sdyx_t, sdyx_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_weight", [True, False])
def test_bn_backward_elemt_plain_matches_formula(dtype, with_weight):
    """The dx pass (XLA-fused in the JAX custom VJP, so no standalone JAX
    function) against a float64 numpy evaluation of its formula."""
    shape = (300, 2048)
    x, dy = rand(6, shape), rand(7, shape, 1.0, 0.0)
    _, tx = pair(x, dtype)
    _, tdy = pair(dy, dtype)
    mean, var, w, _ = stats_inputs(shape, 8)
    w = w if with_weight else None
    invstd = (1.0 / np.sqrt(var + 1e-5)).astype(np.float32)
    rs = np.random.RandomState(9)
    sdy, sdyx = rs.randn(2, shape[-1]).astype(np.float32) * 10
    n = np.float32(shape[0])
    dx = T.bn_backward_elemt(tdy, tx, *map(torch.from_numpy, (mean, invstd)),
                             None if w is None else torch.from_numpy(w),
                             torch.from_numpy(sdy), torch.from_numpy(sdyx),
                             torch.tensor(n))
    xd, dyd = npf(tx).astype(np.float64), npf(tdy).astype(np.float64)
    xhat = (xd - mean) * invstd
    ref = (dyd - sdy / n - xhat * sdyx / n) * invstd * (1.0 if w is None else w)
    assert dx.dtype == DT[dtype][1]
    close_elem(dx, ref, dtype)


def _fused_case(seed, shape, affine=True):
    x = rand(seed, shape)
    rs = np.random.RandomState(seed + 1)
    c = shape[-1]
    w = rs.uniform(0.5, 1.5, c).astype(np.float32) if affine else None
    b = rs.randn(c).astype(np.float32) if affine else None
    coeff = rs.randn(*shape).astype(np.float32)
    return x, w, b, coeff


@pytest.mark.parametrize("shape", [(4, 5, 3, 6), (300, 2048)], ids=["nhwc", "wide"])
def test_fused_batch_norm_forward_and_grads_match_pallas_vjp(shape):
    x, w, b, coeff = _fused_case(10, shape)

    def jf(xx, ww, bb):
        y, *stats = pallas_bn.fused_batch_norm(xx, ww, bb, 1e-5, None)
        return y, stats

    # the stats ride as aux: the JAX VJP refuses a cotangent for them
    jy, vjp, (jmean, jvar, jcount) = jax.vjp(
        jf, *map(jnp.asarray, (x, w, b)), has_aux=True)
    jgx, jgw, jgb = vjp(jnp.asarray(coeff))

    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    ty, tmean, tvar, tcount = T.fused_batch_norm(tx, tw, tb, 1e-5)
    assert not (tmean.requires_grad or tvar.requires_grad or tcount.requires_grad)
    ty.backward(torch.from_numpy(coeff))
    close_elem(ty, jy, "float32")
    close_elem(tmean, jmean, "float32")
    close_elem(tvar, jvar, "float32")
    assert float(tcount) == float(jcount)
    # dx carries a cancellation (dy − mean terms): atol 1e-5 on O(1) values
    close_elem(tx.grad, jgx, "float32")
    close_sums(tw.grad, jgw)
    close_sums(tb.grad, jgb)


def test_fused_batch_norm_no_affine_and_bias_only():
    x, _, b, coeff = _fused_case(12, (4, 5, 3, 6))
    for w_, b_ in ((None, None), (None, b)):
        def jloss(xx, bb):
            y, *_ = pallas_bn.fused_batch_norm(xx, None, bb, 1e-5, None)
            return jnp.sum(y * jnp.asarray(coeff))

        jb = None if b_ is None else jnp.asarray(b_)
        if jb is None:
            jgx = jax.grad(lambda xx: jloss(xx, None))(jnp.asarray(x))
        else:
            jgx, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jb)
        tx = torch.from_numpy(x).requires_grad_()
        tb = None if b_ is None else torch.from_numpy(b_).requires_grad_()
        y, *_ = T.fused_batch_norm(tx, None, tb, 1e-5)
        (y * torch.from_numpy(coeff)).sum().backward()
        close_elem(tx.grad, jgx, "float32")
        if tb is not None:
            close_sums(tb.grad, jgb)


def test_gradient_into_stats_raises():
    """mean/var/count feed the running-stat update only: asking autograd
    for a gradient through them must raise, as the JAX VJP does."""
    x = torch.from_numpy(rand(14, (4, 8))).requires_grad_()
    w, b = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    y, mean, var, count = T.fused_batch_norm(x, w, b, 1e-5)
    for stat in (mean, var, count):
        with pytest.raises(RuntimeError, match="does not require grad"):
            torch.autograd.grad(stat.sum(), x)
    (gx,) = torch.autograd.grad(y.sum(), x)  # through y alone still works
    assert torch.isfinite(gx).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.from_numpy(rand(15, (4, 5, 3, 6)))
    with pytest.raises(ValueError, match="dense channel-last"):
        T.bn_stats(x.permute(0, 3, 1, 2))  # NCHW strides: no silent copy
    with pytest.raises(TypeError, match="float32/bfloat16/float16"):
        T.bn_stats(x.double())
    mean = torch.zeros(6)
    with pytest.raises(ValueError, match="float32 \\(6,\\)"):
        T.bn_backward_reduce(x, x, mean[:5], torch.ones(6))
    with pytest.raises(ValueError, match="does not match"):
        T.bn_backward_reduce(x[:2], x, mean, torch.ones(6))


def test_launch_counts_move_only_on_kernel_launches():
    T.reset_launch_counts()
    x = torch.from_numpy(rand(16, (4, 6)))
    T.bn_stats(x)  # CPU tensor: plain version, no launch
    assert T.launch_counts() == dict.fromkeys(T.LAUNCHES, 0)


@pytest.mark.parametrize("m,c", [(802816, 64), (200704, 256), (3136, 2048),
                                 (100003, 96), (0, 64), (7, 3)])
def test_reduction_plan_fills_the_card_and_covers_every_row(m, c):
    """The reduction grid for an H100 (132 SMs): at least 2 x 132 programs
    at both ends of ResNet-50's shapes, whole 64-row tiles per program, no
    empty program, and every row covered exactly once."""
    block_c, n_m, n_c, rows_per_prog = T.reduction_plan(m, c, 132)
    assert block_c >= 16 and block_c & (block_c - 1) == 0
    assert n_c * block_c >= c > (n_c - 1) * block_c
    assert rows_per_prog % 64 == 0 and n_m >= 1
    assert n_m * rows_per_prog >= m and (n_m - 1) * rows_per_prog < max(m, 1)
    if m * c >= 3136 * 512:
        assert n_m * n_c >= 2 * 132



# ResNet-50's 12 BN shapes at batch 64, 224² (M = N·H·W, C), and the edges
RESNET50_BN_SHAPES = [(802816, 64), (200704, 64), (200704, 256), (200704, 128),
                      (50176, 128), (50176, 512), (50176, 256), (12544, 256),
                      (12544, 1024), (12544, 512), (3136, 512), (3136, 2048)]
PLAN_SHAPES = RESNET50_BN_SHAPES + [(0, 64), (7, 3), (100003, 96), (64, 6),
                                    (1000, 100), (5, 65536)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("m,c", PLAN_SHAPES)
def test_stats_plan_covers_every_row_and_channel_once_and_fills_the_card(
        m, c, itemsize):
    """The one-launch stats grid for an H100 (132 SMs): column blocks of a
    power of two of 16-byte channel groups that cover C, row blocks of
    contiguous rows that cover M exactly once, at most one block per SM
    (one wave), and at ResNet-50's shapes as many SMs busy as whole
    columns of row blocks allow."""
    gc, n_c, n_m, rows = B.stats_plan(m, c, itemsize, 132)
    vec = 16 // itemsize
    assert 1 <= gc <= 256 and gc & (gc - 1) == 0
    lanes = B._STATS_THREADS // gc
    assert rows >= 1
    assert n_c * gc * vec >= c > (n_c - 1) * gc * vec
    assert 1 <= n_m <= 65535
    assert n_m * rows >= m and (n_m - 1) * rows < max(m, 1)
    blocks = B._STATS_BLOCKS_PER_SM * 132
    assert n_m * n_c <= blocks
    if m:  # each row once: row block r // rows, row lane (r % rows) % lanes
        r = np.arange(m)
        owner = (r // rows) * lanes + (r % rows) % lanes
        counts = np.bincount(owner, minlength=n_m * lanes)
        assert counts.sum() == m and (counts <= -(-rows // lanes)).all()
        assert (r // rows).max() == n_m - 1
    if (m, c) in RESNET50_BN_SHAPES:  # no further row block fits the wave
        assert n_m * n_c > blocks - n_c and n_m * n_c >= 0.9 * 132


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("m,c", PLAN_SHAPES)
def test_normalize_plan_keeps_each_thread_on_one_channel_group(m, c, itemsize):
    """The normalize grid: a block spans a power of two of 16-byte channel
    groups (all of a row's, or the whole block) and whole row lanes, so a
    thread keeps one group for its 4 rows; every (row, group) pair is
    visited exactly once; at ResNet-50's shapes a block moves 8 KB of
    bf16 and the grid holds several blocks per SM."""
    gcols, n_rb, n_cb = B.normalize_plan(m, c, itemsize)
    threads = B._NORM_THREADS
    groups = -(-c // (16 // itemsize))
    assert threads == 128 and gcols & (gcols - 1) == 0 and threads % gcols == 0
    assert gcols >= min(groups, threads) and n_cb <= 65535
    lanes, unroll = threads // gcols, B._NORM_UNROLL
    assert n_rb * lanes * unroll >= m > (n_rb - 1) * lanes * unroll or m == 0
    assert n_cb * gcols >= groups > (n_cb - 1) * gcols
    if 0 < m * groups <= 2 ** 22:  # thread t of block (bx, by), its j-th row
        bx, by, t, j = np.meshgrid(np.arange(n_rb), np.arange(n_cb),
                                   np.arange(threads), np.arange(unroll), indexing="ij")
        g = by * gcols + t % gcols
        r = bx * lanes * unroll + t // gcols + j * lanes
        keep = (g < groups) & (r < m)
        visits = np.zeros((m, groups), dtype=np.int64)
        np.add.at(visits, (r[keep], g[keep]), 1)
        assert (visits == 1).all()
    if (m, c) in RESNET50_BN_SHAPES and itemsize == 2:
        assert threads * unroll * 16 == 8192 and n_rb * n_cb >= 2 * 132
