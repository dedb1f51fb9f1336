"""The port's tensor and expert parallelism (``tpu_syncbn_torch.parallel.
tensor`` and ``.expert``) against the JAX package's functions under
``shard_map``, from the same numpy inputs made from a seed.

The port runs in spawned gloo CPU worlds of 2 and 4 processes, one spawn a
world carrying every case; the JAX references run in this process on a
mesh of as many of the 8 CPU devices (``tests/test_tensor_parallel.py``'s
and ``tests/test_expert_parallel.py``'s shapes and specs). World 1 (no
group) runs in this process against JAX's mesh of one. Each case checks
the output and every gradient: JAX differentiates the array-level
function, so a replicated input's gradient (TP's ``x``, EP's router) is
the full gradient, which the port's *f* (``collectives.copy_to_group``)
gives on every rank; a sharded weight's gradient is compared on the
rank's own block.

Tolerances are the JAX tests': TP forward 2e-5 (3e-5 for attention) and
gradients 5e-5, absolute, attention's gradients included (JAX tests only
its forward); EP forward 1e-5 (aux rtol 1e-5) and gradients 2e-5. The
JAX HLO check of one all-reduce a TP block becomes a tally check: one
``psum`` in each block's forward, one in its backward (*f*'s).
"""

import functools
import json
import os
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch.parallel import collectives as C
from tpu_syncbn_torch.parallel import expert as E
from tpu_syncbn_torch.parallel import tensor as TP

WORLDS = (2, 4)
JOIN_TIMEOUT_S = 240
B, L, D, H = 2, 6, 16, 32  # TP: tests/test_tensor_parallel.py
N_HEADS, DH = 8, 4
T, DE, HE = 16, 8, 32  # EP: tokens a rank, model dim, hidden dim
TP_OUT, TP_ATTN_OUT, TP_GRAD = 2e-5, 3e-5, 5e-5
EP_OUT, EP_AUX_RTOL, EP_GRAD = 1e-5, 1e-5, 2e-5
TP_CASES = ("mlp", "attn.full", "attn.causal")
EP_PER_RANK = (1, 2)
EP_CASES = [f"ep{k}" for k in EP_PER_RANK] + ["ep.drop"]


def make_inputs(world: int) -> dict:
    r = np.random.default_rng(50 + world)
    g = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    inp = dict(
        x=g(B, L, D), w1=g(D, H, scale=0.1), b1=g(H, scale=0.1), w2=g(H, D, scale=0.1),
        b2=g(D, scale=0.1), xa=g(B, L, D), wq=g(D, N_HEADS * DH, scale=0.2),
        wk=g(D, N_HEADS * DH, scale=0.2), wv=g(D, N_HEADS * DH, scale=0.2),
        wo=g(N_HEADS * DH, D, scale=0.2), xe=g(world * T, DE), we=g(world * T, DE))
    for k in EP_PER_RANK:
        e = world * k
        inp[f"router{k}"] = g(DE, e)
        inp[f"w_in{k}"] = g(e, DE, HE, scale=0.1)
        inp[f"w_out{k}"] = g(e, HE, DE, scale=0.1)
    # every token the same: all pick one expert, which keeps its capacity of them
    inp["xe.drop"] = np.tile(g(1, DE), (world * T, 1))
    return inp


def _np(t):
    return t.detach().float().numpy()


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        return f"{type(e).__name__}: {e}"
    return ""


def _leaf(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()


def _tp_args(name, inp, rank, world):
    """The case's (port function, leaves): the rank's shards of JAX's
    arrays in JAX's layouts."""
    col = functools.partial(TP.shard_columns, rank=rank, world=world)
    row = functools.partial(TP.shard_rows, rank=rank, world=world)
    if name == "mlp":
        return TP.tp_mlp, [_leaf(inp["x"]), _leaf(col(inp["w1"])), _leaf(col(inp["b1"])),
                           _leaf(row(inp["w2"])), _leaf(inp["b2"])], {}
    kw = dict(n_local_heads=N_HEADS // world, causal=name.endswith("causal"))
    return TP.tp_attention, [_leaf(inp["xa"])] + [_leaf(col(inp[k])) for k in ("wq", "wk", "wv")] \
        + [_leaf(row(inp["wo"]))], kw


def _ep_args(name, inp, rank, world):
    k = 1 if name == "ep.drop" else int(name[2:])
    x = inp["xe.drop" if name == "ep.drop" else "xe"]
    rows = slice(rank * T, (rank + 1) * T)
    kw = dict(capacity_factor=2 / T if name == "ep.drop" else 1.25)
    return [_leaf(x[rows]), _leaf(inp[f"router{k}"]),
            _leaf(TP.shard_rows(inp[f"w_in{k}"], rank, world)),
            _leaf(TP.shard_rows(inp[f"w_out{k}"], rank, world))], kw, inp["we"][rows]


def compute(rank: int, world: int, group, inp: dict) -> dict:
    """Every port computation of this file on this rank (group None: the
    world of one)."""
    out = {}
    for name in TP_CASES:
        fn, args, kw = _tp_args(name, inp, rank, world)
        C.reset_tallies()
        y = fn(*args, group=group, **kw)
        fwd = C.tallies()
        C.reset_tallies()
        (y ** 2).sum().backward()
        bwd = C.tallies()
        out[f"{name}.out"] = _np(y)
        for i, a in enumerate(args):
            out[f"{name}.g{i}"] = _np(a.grad)
        out[f"{name}.tallies"] = np.array(json.dumps([fwd, bwd]))
    for name in EP_CASES:
        args, kw, w = _ep_args(name, inp, rank, world)
        y, aux = E.expert_parallel_moe(*args, group, **kw)
        ((y * torch.from_numpy(w)).sum() + aux).backward()
        out[f"{name}.out"], out[f"{name}.aux"] = _np(y), _np(aux)
        for i, a in enumerate(args):
            out[f"{name}.g{i}"] = _np(a.grad)
    # errors: a head split that does not divide the shard; a router for
    # more experts than the ranks hold
    w6 = torch.zeros(D, 6)
    out["err.heads"] = np.array(_error(lambda: TP.tp_attention(
        torch.zeros(1, 4, D), w6, w6, w6, w6.T, group, n_local_heads=4)))
    out["err.experts"] = np.array(_error(lambda: E.expert_parallel_moe(
        torch.zeros(T, DE), torch.zeros(DE, 2 * world), torch.zeros(1, DE, HE),
        torch.zeros(1, HE, DE), group)))
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


def _shared_dir(tmp_path_factory, name: str, make):
    """The directory ``make(d)`` filled, made once per test run whatever the
    number of xdist workers: the first worker to take the lock runs it and
    marks it done; the others wait on the lock, then read its files."""
    import fcntl

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, which its workers share
    d = root / name
    d.mkdir(exist_ok=True)
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (d / "done").exists():
                make(d)
                (d / "done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return d


def spawn(world: int, tmp_path_factory, inp) -> list:
    """This file's replica in ``world`` spawned processes (one spawn a world
    for the whole run, :func:`_shared_dir`); each rank's npz as a dict."""

    def run(out):
        rdv = tempfile.mkdtemp(dir=out)  # a fresh rendezvous each attempt
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=_replica, args=(r, world, os.path.join(rdv, "rdv"),
                                                    str(out), inp))
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

    d = _shared_dir(tmp_path_factory, f"tpep{world}", run)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


_RESULTS: dict = {}


@pytest.fixture(scope="module", params=(1,) + WORLDS, ids=lambda w: f"world{w}")
def res(request, tmp_path_factory):
    """``(world, inputs, per-rank results)``: world 1 in this process, one
    spawn for each other world."""
    w = request.param
    if w not in _RESULTS:
        inp = make_inputs(w)
        ranks = [compute(0, 1, None, inp)] if w == 1 else \
            spawn(w, tmp_path_factory, inp)
        _RESULTS[w] = (w, inp, ranks)
    return _RESULTS[w]


# -- the JAX side ---------------------------------------------------------------


def _mesh(n, axis):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def jax_tp(name, world, inp):
    """The JAX block under shard_map: output and the gradients of
    ``sum(y ** 2)`` with respect to every argument (full arrays)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map
    from tpu_syncbn.parallel import tensor as J

    ax = J.MODEL_AXIS
    if name == "mlp":
        fn, specs = J.tp_mlp, (P(), P(None, ax), P(ax), P(ax, None), P())
        args = [inp[k] for k in ("x", "w1", "b1", "w2", "b2")]
    else:
        fn = functools.partial(J.tp_attention, n_local_heads=N_HEADS // world,
                               causal=name.endswith("causal"))
        specs = (P(), P(None, ax), P(None, ax), P(None, ax), P(ax, None))
        args = [inp[k] for k in ("xa", "wq", "wk", "wv", "wo")]
    f = shard_map(fn, mesh=_mesh(world, ax), in_specs=specs, out_specs=P())
    args = [jnp.asarray(a) for a in args]
    y = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                             argnums=tuple(range(len(args)))))(*args)
    return np.asarray(y), [np.asarray(g) for g in grads]


def jax_ep(name, world, inp):
    """The JAX expert-parallel MoE under shard_map (``test_expert_parallel.
    py``'s specs): y, aux and the gradients of ``sum(w * y) + aux``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map
    from tpu_syncbn.parallel import expert as J

    k = 1 if name == "ep.drop" else int(name[2:])
    cf = 2 / T if name == "ep.drop" else 1.25
    ax = J.EXPERT_AXIS
    f = shard_map(functools.partial(J.expert_parallel_moe, capacity_factor=cf),
                  mesh=_mesh(world, ax),
                  in_specs=(P(ax, None), P(None, None), P(ax, None, None),
                            P(ax, None, None)),
                  out_specs=(P(ax, None), P()))
    args = [jnp.asarray(inp[key]) for key in ("xe.drop" if name == "ep.drop" else "xe",
                                               f"router{k}", f"w_in{k}", f"w_out{k}")]
    w = jnp.asarray(inp["we"])
    y, aux = jax.jit(f)(*args)

    def loss(*a):
        yy, aa = f(*a)
        return jnp.sum(w * yy) + aa

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


def _jax_error(fn) -> str:
    import jax  # noqa: F401 — the JAX functions raise at trace time

    return _error(fn)


# -- tensor parallelism ---------------------------------------------------------

#: each TP argument's layout: replicated, column-sharded, row-sharded
TP_LAYOUT = {"mlp": ("rep", "col", "col", "row", "rep"),
             "attn": ("rep", "col", "col", "col", "row")}


def _rank_block(x, how, rank, world):
    if how == "col":
        return TP.shard_columns(x, rank, world)
    if how == "row":
        return TP.shard_rows(x, rank, world)
    return x


@pytest.mark.parametrize("name", TP_CASES)
def test_tensor_parallel_matches_jax(res, name):
    world, inp, ranks = res
    want_y, want_g = jax_tp(name, world, inp)
    out_tol = TP_OUT if name == "mlp" else TP_ATTN_OUT
    layout = TP_LAYOUT[name.split(".")[0]]
    for r, got in enumerate(ranks):
        err = float(np.abs(got[f"{name}.out"] - want_y).max())
        assert err <= out_tol, f"rank {r} {name} out: {err:.3e}"
        for i, (how, g) in enumerate(zip(layout, want_g)):
            err = float(np.abs(got[f"{name}.g{i}"] - _rank_block(g, how, r, world)).max())
            assert err <= TP_GRAD, f"rank {r} {name} grad {i} ({how}): {err:.3e}"


@pytest.mark.parametrize("name", TP_CASES)
def test_one_all_reduce_a_block_by_the_tallies(res, name):
    """Megatron's contract: the forward's one all-reduce is the row half's
    psum (*g*); the backward's one is *f*'s on the replicated input. At
    world 1 nothing is issued."""
    world, _, ranks = res
    for got in ranks:
        fwd, bwd = json.loads(str(got[f"{name}.tallies"]))
        if world == 1:
            assert fwd == {} and bwd == {}
            continue
        assert set(fwd) == {"psum"} and fwd["psum"]["calls"] == 1, fwd
        assert set(bwd) == {"psum"} and bwd["psum"]["calls"] == 1, bwd
        assert fwd["psum"]["bytes"] == B * L * D * 4 == bwd["psum"]["bytes"]


def test_bad_head_split_raises_jaxs_error(res):
    import functools as ft

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map
    from tpu_syncbn.parallel import tensor as J

    world, _, ranks = res
    ax = J.MODEL_AXIS
    f = shard_map(ft.partial(J.tp_attention, n_local_heads=4), mesh=_mesh(1, ax),
                  in_specs=(P(),) + (P(None, ax),) * 3 + (P(ax, None),), out_specs=P())
    w6 = jnp.zeros((D, 6))
    want = _jax_error(lambda: jax.jit(f)(jnp.zeros((1, 4, D)), w6, w6, w6, w6.T))
    assert "divisible" in want
    for got in ranks:
        assert str(got["err.heads"]) == want


# -- expert parallelism ---------------------------------------------------------

#: each EP argument's layout: x token-sharded, router replicated, experts
#: sharded by rows
EP_LAYOUT = ("tok", "rep", "row", "row")


@pytest.mark.parametrize("name", EP_CASES)
def test_expert_parallel_matches_jax(res, name):
    world, inp, ranks = res
    want_y, want_aux, want_g = jax_ep(name, world, inp)
    for r, got in enumerate(ranks):
        rows = slice(r * T, (r + 1) * T)
        err = float(np.abs(got[f"{name}.out"] - want_y[rows]).max())
        assert err <= EP_OUT, f"rank {r} {name} y: {err:.3e}"
        np.testing.assert_allclose(float(got[f"{name}.aux"]), want_aux, rtol=EP_AUX_RTOL)
        for i, (how, g) in enumerate(zip(EP_LAYOUT, want_g)):
            g = g[rows] if how == "tok" else _rank_block(g, how, r, world)
            err = float(np.abs(got[f"{name}.g{i}"] - g).max())
            assert err <= EP_GRAD, f"rank {r} {name} grad {i} ({how}): {err:.3e}"


def test_capacity_drops_overflow_tokens(res):
    """Identical tokens all pick one expert; a capacity of 2 slots a source
    keeps 2 of each rank's tokens and zeroes the rest, as JAX does."""
    world, inp, ranks = res
    want_y, _, _ = jax_ep("ep.drop", world, inp)
    c = E._capacity(T, world, 2 / T)
    for got in ranks:
        nonzero = int(np.any(np.abs(got["ep.drop.out"]) > 0, axis=-1).sum())
        assert 1 <= nonzero <= c
    assert int(np.any(np.abs(want_y) > 0, axis=-1).sum()) == c * world


def test_dense_moe_matches_jax_in_process():
    from tpu_syncbn.parallel import expert as J

    inp = make_inputs(2)
    for cf in (1.25, 2 / T):
        args = [inp[k] for k in ("xe", "router2", "w_in2", "w_out2")]
        y, aux = E.dense_moe(*map(torch.from_numpy, args), capacity_factor=cf)
        wy, waux = J.dense_moe(*args, capacity_factor=cf)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=EP_OUT)
        np.testing.assert_allclose(float(aux), float(waux), rtol=EP_AUX_RTOL)
        assert E._capacity(2 * T, 4, cf) == J._capacity(2 * T, 4, cf)


def test_switch_route_takes_the_first_maximum_as_jax():
    """Ties in the router: two experts with equal logits for every token;
    both packages route to the first."""
    from tpu_syncbn.parallel import expert as J

    x = np.ones((6, 2), np.float32)
    router = np.array([[1.0, 1.0, -1.0], [0.5, 0.5, 0.0]], np.float32)
    got = E.switch_route(torch.from_numpy(x), torch.from_numpy(router), 4)
    want = J.switch_route(x, router, 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # dispatch
    assert got[0][:, 0].sum() == 4  # the first expert, 4 slots, 2 tokens dropped
    for g, w in zip(got[1:], want[1:]):  # combine and aux: f32 softmax roundings
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=EP_AUX_RTOL)


def test_world_mismatch_raises_jaxs_error(res):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map
    from tpu_syncbn.parallel import expert as J

    world, _, ranks = res
    ax = J.EXPERT_AXIS
    f = shard_map(J.expert_parallel_moe, mesh=_mesh(world, ax),
                  in_specs=(P(ax, None), P(None, None), P(ax, None, None), P(ax, None, None)),
                  out_specs=(P(ax, None), P()))
    want = _jax_error(lambda: jax.jit(f)(
        jnp.zeros((world * T, DE)), jnp.zeros((DE, 2 * world)),
        jnp.zeros((world, DE, HE)), jnp.zeros((world, HE, DE))))
    assert "experts" in want
    for got in ranks:
        assert str(got["err.experts"]) == want
