"""The port's sequence parallelism (``tpu_syncbn_torch.parallel.sequence``)
and the collectives it rides on (``ppermute``, ``all_to_all``,
``ring_all_reduce``) against the JAX package's functions, from the same
numpy inputs made from a seed.

The port runs in spawned gloo CPU worlds of 2 and 4 processes, one spawn a
world carrying every case; the JAX references run in this process under
``shard_map`` on a mesh of as many of the 8 CPU devices (Ulysses with
``local_impl="flash"`` through Pallas interpret mode, with the VMA checker
off, as ``tests/test_sequence_parallel.py`` runs it). Shapes: B 2, global
L 64, H 4, D 16, float32 and bfloat16; each case checks the output and the
gradients of ``sum(w * out)`` with respect to q, k and v. World 1 (no
group) runs in this process against JAX's mesh of one.

Tolerances:
* float32 — outputs 2e-5 and gradients 5e-5, absolute, the bounds
  ``tests/test_sequence_parallel.py`` holds the JAX functions to against
  the dense oracle (f32 sums of up to L products in another order);
* bfloat16 — both sides compute in f32 and round to bf16, each within
  u = 2^-8 of its value's magnitude per rounding, so they differ by at most
  ``2 · r · u · max|ref|`` for ``r`` roundings: r = 1 for outputs and for
  gradients cast once (Ulysses; q's gradient, which the ring sums in f32),
  r = 2n for the ring's k and v gradients, which the backward sums across
  the n hops in bf16 (a cast and an add a hop);
* the collectives move bytes: ``ppermute``, ``all_to_all`` and their
  backward are bit for bit; ``ring_all_reduce`` is bit for bit JAX's ring
  (the same adds in the same order) and within n f32 roundings of ``psum``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch.parallel import collectives as C
from tpu_syncbn_torch.parallel import sequence as S

WORLDS = (2, 4)
B, L, H, D = 2, 64, 4, 16
JOIN_TIMEOUT_S = 240
F32_OUT, F32_GRAD = 2e-5, 5e-5
BF16_U = 2.0 ** -8
DTYPES = ("float32", "bfloat16")

#: shard-level cases: (port function, keyword arguments); the JAX function
#: has the same name and arguments
LOCAL = {
    "ring.causal": ("ring_attention", dict(causal=True)),
    "ring.full": ("ring_attention", dict(causal=False)),
    "zigzag": ("ring_attention_zigzag", {}),
    "ulysses.causal": ("ulysses_attention", dict(causal=True)),
    "ulysses.full": ("ulysses_attention", dict(causal=False)),
    "ulysses.flash.causal": ("ulysses_attention", dict(causal=True, local_impl="flash")),
    "ulysses.flash.full": ("ulysses_attention", dict(causal=False, local_impl="flash")),
    "ulysses.flash.pallas.causal": ("ulysses_attention", dict(
        causal=True, local_impl="flash", local_backward="pallas")),
    "ulysses.flash.pallas.full": ("ulysses_attention", dict(
        causal=False, local_impl="flash", local_backward="pallas")),
}
#: sharded_self_attention's cases: global tensors on every rank
WRAPPED = {
    "ring": dict(impl="ring", causal=True),
    "ring_zigzag": dict(impl="ring_zigzag", causal=True, scale=0.3),
    "ulysses": dict(impl="ulysses", causal=False),
    "ulysses.flash.pallas": dict(impl="ulysses", causal=True, local_impl="flash",
                                 local_backward="pallas"),
}
#: all_to_all's (split_axis, concat_axis, tiled) cases on a (n, 2n, 2n) block
A2A = [(0, 1, True), (1, 0, True), (2, 2, True), (1, 2, True), (0, 1, False),
       (0, 2, False)]


def make_inputs(world: int) -> dict:
    rng = np.random.default_rng(40 + world)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=g(B, L, H, D), k=g(B, L, H, D), v=g(B, L, H, D), w=g(B, L, H, D),
                a2a=g(world, world, 2 * world, 2 * world),
                a2a_w=g(world, world, 2 * world, 2 * world),
                perm=g(world, 5, 3), perm_w=g(world, 5, 3),
                rar=g(world, 13), rar2=g(world, 3, 5))


def _np(t):
    return t.detach().float().numpy()


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        return f"{type(e).__name__}: {e}"
    return ""


def _blocks(x: np.ndarray, world: int, rank: int) -> np.ndarray:
    size = x.shape[1] // world
    return x[:, rank * size:(rank + 1) * size]


def _leaf(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()


def _attend_case(fn, args, w) -> list:
    out = fn(*args)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [_np(out)] + [_np(a.grad) for a in args]


def compute(rank: int, world: int, group, inp: dict) -> dict:
    """Every port computation of this file on this rank."""
    out = {}
    zz = {k: S.zigzag_shard(torch.from_numpy(inp[k]), world).numpy() for k in "qkvw"}
    for dtype in DTYPES:
        for name, (fn, kw) in LOCAL.items():
            src = zz if fn == "ring_attention_zigzag" else inp
            args = [_leaf(_blocks(src[k], world, rank), dtype) for k in "qkv"]
            got = _attend_case(lambda *a: getattr(S, fn)(*a, group, **kw), args,
                               _blocks(src["w"], world, rank))
            for part, x in zip(("out", "dq", "dk", "dv"), got):
                out[f"local.{name}.{dtype}.{part}"] = x
        for name, kw in WRAPPED.items():
            args = [_leaf(inp[k], dtype) for k in "qkv"]
            got = _attend_case(lambda *a: S.sharded_self_attention(group, *a, **kw), args,
                               inp["w"])
            for part, x in zip(("out", "dq", "dk", "dv"), got):
                out[f"wrapped.{name}.{dtype}.{part}"] = x

    for split, concat, tiled in A2A:
        x = torch.from_numpy(inp["a2a"][rank]).requires_grad_()
        y = C.all_to_all(x, group, split_axis=split, concat_axis=concat, tiled=tiled)
        (y * torch.from_numpy(inp["a2a_w"][rank]).reshape(y.shape)).sum().backward()
        out[f"a2a.{split}.{concat}.{tiled}"] = _np(y)
        out[f"a2a.{split}.{concat}.{tiled}.grad"] = _np(x.grad)
    bits = torch.from_numpy(inp["a2a"][rank]).to(torch.bfloat16)
    out["a2a.bf16"] = C.all_to_all(bits, group, split_axis=0, concat_axis=1).view(
        torch.int16).numpy()

    perm = [(i, i + 1) for i in range(world - 1)]  # rank 0 receives nothing
    x = torch.from_numpy(inp["perm"][rank]).requires_grad_()
    y = C.ppermute(x, perm, group)
    (y * torch.from_numpy(inp["perm_w"][rank])).sum().backward()
    out["ppermute"], out["ppermute.grad"] = _np(y), _np(x.grad)
    bits = torch.from_numpy(inp["perm"][rank]).to(torch.bfloat16)
    out["ppermute.bf16"] = C.ppermute(bits, [(i, (i + 1) % world) for i in range(world)],
                                      group).view(torch.int16).numpy()

    for key in ("rar", "rar2"):
        out[key] = C.ring_all_reduce(torch.from_numpy(inp[key][rank]), group).numpy()

    C.reset_tallies()
    C.ppermute(torch.ones(4), [(0, 1)], group)
    C.all_to_all(torch.ones(world, 2), group)
    C.ring_all_reduce(torch.ones(world * 3), group)
    out["tallies"] = np.array(json.dumps(C.tallies()))

    odd = torch.zeros(1, 3, 3, 4)
    out["err.heads"] = np.array(_error(lambda: S.ulysses_attention(
        torch.zeros(1, 8, 3, 4), torch.zeros(1, 8, 3, 4), torch.zeros(1, 8, 3, 4), group)))
    out["err.zigzag_odd"] = np.array(_error(lambda: S.ring_attention_zigzag(
        odd, odd, odd, group)))
    out["err.a2a"] = np.array(_error(lambda: C.all_to_all(
        torch.zeros(world + 1, 2), group)))
    out["err.a2a_untiled"] = np.array(_error(lambda: C.all_to_all(
        torch.zeros(2 * world, 2), group, tiled=False)))
    out["err.wrapped_length"] = np.array(_error(lambda: S.sharded_self_attention(
        group, *(torch.zeros(1, world + 1, 4, 4),) * 3)))
    return out


def _replica(rank, world, rdv, out_dir, inp):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                             rank=rank)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **compute(rank, world, tdist.group.WORLD, inp))
    finally:
        tdist.destroy_process_group()


def spawn(world: int, d, inp) -> list:
    """This file's replica in ``world`` spawned processes; each rank's npz
    as a dict."""
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_replica, args=(r, world, str(d / "rdv"), str(d), inp))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    assert not alive, f"world-{world} replicas still running after {JOIN_TIMEOUT_S}s"
    assert [p.exitcode for p in procs] == [0] * world
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


_RESULTS: dict = {}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def res(request, tmp_path_factory):
    """``(world, inputs, per-rank results)``, one spawn a world for the
    module."""
    w = request.param
    if w not in _RESULTS:
        inp = make_inputs(w)
        _RESULTS[w] = (w, inp, spawn(w, tmp_path_factory.mktemp(f"seq{w}"), inp))
    return _RESULTS[w]


# -- the JAX side ---------------------------------------------------------------


def _mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


def _jax_grads(f, q, k, v, w, dtype):
    """``f``'s output and the gradients of ``sum(w * f(q, k, v))``, as f32
    numpy."""
    import jax
    import jax.numpy as jnp

    args = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]

    def loss(*a):
        return jnp.sum(f(*a).astype(jnp.float32) * w)

    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def jax_local(name, world, inp, dtype):
    """The JAX shard-level function of case ``name`` under shard_map, on
    the global arrays (zigzag ones in the zigzag layout)."""
    import functools

    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map
    from tpu_syncbn.parallel import sequence as J

    fn, kw = LOCAL[name]
    src = inp
    if fn == "ring_attention_zigzag":
        src = {k: np.asarray(J.zigzag_shard(inp[k], world)) for k in "qkvw"}
    spec = P(None, "seq", None, None)
    f = shard_map(functools.partial(getattr(J, fn), axis_name="seq", **kw),
                  mesh=_mesh(world), in_specs=(spec,) * 3, out_specs=spec,
                  check_vma="local_impl" not in kw)
    return _jax_grads(f, *(src[k] for k in "qkvw"), dtype)


def jax_wrapped(name, world, inp, dtype):
    from tpu_syncbn.parallel import sequence as J

    mesh = _mesh(world)
    f = lambda q, k, v: J.sharded_self_attention(mesh, q, k, v, **WRAPPED[name])  # noqa: E731
    return _jax_grads(f, *(inp[k] for k in "qkvw"), dtype)


def _tol(dtype, part, ref, hops=0):
    """The module docstring's bound for one output."""
    if dtype == "float32":
        return F32_OUT if part == "out" else F32_GRAD
    rounds = 2 * hops if (hops and part in ("dk", "dv")) else 1
    return 2 * rounds * BF16_U * float(np.abs(ref).max())


def _check(got: list, want: list, dtype, hops, what):
    for part, g, wnt in zip(("out", "dq", "dk", "dv"), got, want):
        tol = _tol(dtype, part, wnt, hops)
        err = float(np.abs(g - wnt).max())
        assert err <= tol, f"{what} {part}: |err| {err:.3e} > {tol:.3e}"


def _hops(name: str, world: int) -> int:
    return world if name.startswith(("ring", "zigzag")) else 0


# -- attention across ranks -----------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(LOCAL))
def test_shard_level_attention_matches_jax(res, name, dtype):
    world, inp, ranks = res
    want = jax_local(name, world, inp, dtype)
    fn = LOCAL[name][0]
    for r, got in enumerate(ranks):
        sl = [got[f"local.{name}.{dtype}.{p}"] for p in ("out", "dq", "dk", "dv")]
        size = L // world
        _check(sl, [x[:, r * size:(r + 1) * size] for x in want], dtype,
               _hops(fn.replace("_attention", ""), world), f"rank {r} {name} {dtype}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(WRAPPED))
def test_sharded_self_attention_matches_jax(res, name, dtype):
    """Every rank returns the whole output and the whole gradients."""
    world, inp, ranks = res
    want = jax_wrapped(name, world, inp, dtype)
    for r, got in enumerate(ranks):
        _check([got[f"wrapped.{name}.{dtype}.{p}"] for p in ("out", "dq", "dk", "dv")],
               want, dtype, _hops(name, world), f"rank {r} {name} {dtype}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["ring", "ring_zigzag", "ulysses", "ulysses.flash.pallas"])
def test_world_one_is_jaxs_world_one(name, dtype):
    """No group: every function is JAX's on a mesh of one (the dense
    attention; Ulysses' local attention)."""
    inp = make_inputs(1)
    want = jax_wrapped(name, 1, inp, dtype)
    args = [_leaf(inp[k], dtype) for k in "qkv"]
    got = _attend_case(lambda *a: S.sharded_self_attention(None, *a, **WRAPPED[name]),
                       args, inp["w"])
    _check(got, want, dtype, 0, f"{name} {dtype}")


def test_world_one_shard_functions_are_the_dense_attention():
    inp = make_inputs(1)
    q, k, v = (torch.from_numpy(inp[x]) for x in "qkv")
    dense = S._single_device_attention(q, k, v, causal=True, scale=None)
    for got in (S.ring_attention(q, k, v, None, causal=True),
                S.ring_attention_zigzag(q, k, v, C.ALONE),
                S.ulysses_attention(q, k, v, C.ALONE, causal=True)):
        assert torch.equal(got, dense)


# -- the collectives ------------------------------------------------------------


def _jax_per_rank(fn, world, *arrays):
    """``fn`` on each device's row of every array under shard_map; the
    output stacked over devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map

    def body(*xs):
        return fn(*[x[0] for x in xs])[None]

    f = shard_map(body, mesh=_mesh(world), in_specs=tuple(P("seq") for _ in arrays),
                  out_specs=P("seq"))
    return np.asarray(jax.jit(f)(*[jnp.asarray(a) for a in arrays]))


def _jax_vjp_per_rank(fn, world, x, w):
    """The gradient of ``sum(w * fn(x))`` under shard_map, per device; each
    device's row of ``w`` is reshaped to its output's shape."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map

    f = shard_map(lambda a: fn(a[0])[None], mesh=_mesh(world), in_specs=P("seq"),
                  out_specs=P("seq"))
    shape = jax.eval_shape(f, jnp.asarray(x)).shape
    g = jax.jit(jax.grad(lambda a: jnp.sum(f(a) * w.reshape(shape))))(jnp.asarray(x))
    return np.asarray(g)


@pytest.mark.parametrize("split,concat,tiled", A2A)
def test_all_to_all_and_its_backward_match_jax(res, split, concat, tiled):
    """The backward against JAX's VJP; untiled, against the transpose JAX's
    rule means, the untiled all-to-all of the cotangent with the axes
    swapped (this JAX's untiled VJP rejects its own cotangent's shape)."""
    from jax import lax

    world, inp, ranks = res
    fn = lambda a: lax.all_to_all(a, "seq", split, concat, tiled=tiled)  # noqa: E731
    want = _jax_per_rank(fn, world, inp["a2a"])
    if tiled:
        grad = _jax_vjp_per_rank(fn, world, inp["a2a"], inp["a2a_w"])
    else:
        grad = _jax_per_rank(lambda a: lax.all_to_all(a, "seq", concat, split, tiled=False),
                             world, inp["a2a_w"].reshape(want.shape))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"a2a.{split}.{concat}.{tiled}"], want[r])
        np.testing.assert_array_equal(got[f"a2a.{split}.{concat}.{tiled}.grad"], grad[r])


def test_ppermute_and_its_backward_match_jax(res):
    """A chain with a hole: rank 0 receives zeros, and the last rank's
    cotangent goes nowhere (its gradient is zero), as JAX transposes it."""
    from jax import lax

    world, inp, ranks = res
    perm = [(i, i + 1) for i in range(world - 1)]
    fn = lambda a: lax.ppermute(a, "seq", perm)  # noqa: E731
    want = _jax_per_rank(fn, world, inp["perm"])
    grad = _jax_vjp_per_rank(fn, world, inp["perm"], inp["perm_w"])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ppermute"], want[r])
        np.testing.assert_array_equal(got["ppermute.grad"], grad[r])
    assert not ranks[0]["ppermute"].any() and not ranks[-1]["ppermute.grad"].any()


def test_bf16_moves_bit_for_bit(res):
    world, inp, ranks = res
    bits = torch.from_numpy(inp["perm"]).to(torch.bfloat16).view(torch.int16).numpy()
    a2a = torch.from_numpy(inp["a2a"]).to(torch.bfloat16).view(torch.int16).numpy()
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ppermute.bf16"], bits[(r - 1) % world])
        # chunk r of every rank's axis 0, concatenated along axis 1
        np.testing.assert_array_equal(got["a2a.bf16"],
                                      np.concatenate(list(a2a[:, r:r + 1]), axis=1))


@pytest.mark.parametrize("key", ["rar", "rar2"])
def test_ring_all_reduce_is_jaxs_ring_and_the_sum(res, key):
    """13 and 15 elements: zero padding up to a multiple of the world."""
    from tpu_syncbn.parallel import collectives as J

    world, inp, ranks = res
    want = _jax_per_rank(lambda a: J.ring_all_reduce(a, "seq"), world, inp[key])
    total = inp[key].astype(np.float64).sum(0)
    tol = world * 2.0 ** -24 * np.abs(inp[key]).sum(0)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], want[r])
        assert (np.abs(got[key] - total) <= tol).all()


def test_collectives_tally_every_call(res):
    world, _, ranks = res
    got = json.loads(str(ranks[0]["tallies"]))
    # one ppermute, one all-to-all, the ring's 2(n - 1) hops of n/n = 3 floats
    assert got["ppermute"] == {"calls": 1 + 2 * (world - 1),
                               "bytes": 16 + 2 * (world - 1) * 12}
    assert got["all_to_all"] == {"calls": 1, "bytes": world * 2 * 4}


def test_argument_errors_across_ranks(res):
    world, _, ranks = res
    got = ranks[0]
    assert f"heads (3) must be divisible by axis size ({world})" in str(got["err.heads"])
    assert "zigzag local length must be even" in str(got["err.zigzag_odd"])
    assert "not divisible by the group size" in str(got["err.a2a"])
    assert "must equal the group size" in str(got["err.a2a_untiled"])
    assert "must divide by the group size" in str(got["err.wrapped_length"])


def test_world_one_collectives():
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(C.all_to_all(x, None, split_axis=0, concat_axis=1), x)
    assert torch.equal(C.ppermute(x, [(0, 0)], None), x)
    assert not C.ppermute(x, [], None).any()
    assert C.ring_all_reduce(x, None) is x
    assert C.axis_size(None) == 1 and C.axis_index(C.ALONE) == 0
    assert torch.equal(C.broadcast(x, None), x)


# -- argument checks (JAX's) -----------------------------------------------------


def _zeros():
    return (torch.zeros(1, 8, 2, 4),) * 3


@pytest.mark.parametrize("kw,match", [
    (dict(impl="ring_zigzag", causal=False), "causal load-balanced"),
    (dict(impl="ring", local_impl="flash"), "local_impl applies to impl='ulysses'"),
    (dict(impl="ring", local_backward="pallas"), "local_backward applies to impl='ulysses'"),
    (dict(impl="ring_zigzag", causal=True, local_impl="flash"), "local_impl applies"),
    (dict(impl="nope"), "impl must be one of"),
    (dict(impl="ulysses", local_backward="pallas"), "local_backward applies to local_impl"),
    (dict(impl="ulysses", local_impl="cudnn"), "local_impl must be None or 'flash'"),
])
def test_sharded_self_attention_argument_errors(kw, match):
    """The JAX wrapper's checks raise the same ValueError here."""
    import jax.numpy as jnp

    from tpu_syncbn.parallel import sequence as J

    with pytest.raises(ValueError, match=match):
        S.sharded_self_attention(None, *_zeros(), **kw)
    with pytest.raises(ValueError, match=match):
        J.sharded_self_attention(_mesh(2), *(jnp.zeros((1, 8, 2, 4)),) * 3, **kw)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_zigzag_helpers_match_jax(n):
    from tpu_syncbn.parallel import sequence as J

    x = np.random.default_rng(n).standard_normal((2, 24, 3)).astype(np.float32)
    assert S.zigzag_chunk_permutation(n) == J.zigzag_chunk_permutation(n)
    got = S.zigzag_shard(torch.from_numpy(x), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.zigzag_shard(x, n)))
    np.testing.assert_array_equal(S.zigzag_unshard(got, n).numpy(), x)
    with pytest.raises(ValueError, match="must divide by 2\\*n_shards"):
        S.zigzag_shard(torch.zeros(1, 2 * n + 1), n)
