"""The port's compressed collectives against the JAX package's, case for
case of tests/test_compressed_collectives.py, at world 1 (no process
group, in this process) and at worlds 2 and 4 (spawned gloo processes,
under a join deadline), each against the JAX functions under shard_map on
a mesh of as many CPU devices, from the same numpy inputs.

Tolerances:
* the int8 grid — ``q``, ``scale`` and ``zp`` — bit for bit: divisions,
  subtractions and round-half-even, which both packages round alike;
* dequantized sums, means and residuals within 2 f32 roundings of their
  chunk's magnitude ``scale·127 + world·|zp|`` (XLA's CPU backend may
  contract ``scale·Σq + world·zp`` into one FMA, where torch rounds twice);
* bf16 exactly on bf16-representable inputs, and elsewhere within one
  bf16 rounding per addend (sums at world 4 depend on the order: gloo's
  ring against XLA's);
* the JAX test's own bounds against a float64 oracle where it has them.

The JAX test's HLO checks ("s8 on the wire", "only collective-permutes")
become checks of the port's per-call tallies: the ops issued and their
bytes at the wire dtype.
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

WORLDS = (1, 2, 4)
JOIN_TIMEOUT_S = 180
EPS32 = 2.0 ** -24
BF16_U = 2.0 ** -8
MODES = ("none", "bf16", "int8")
D, EF_CHUNK, EF_STEPS, EF_LR = 6, 4, 12, 0.4


def make_inputs(world: int) -> dict:
    rs = np.random.RandomState(100 + world)
    big = rs.randn(world, 1000).astype(np.float32)
    big[:, 256:512] = 3.0  # one constant chunk: half = 0, so scale = 1
    return dict(
        a=rs.randn(world, 300).astype(np.float32),
        b=rs.randn(world, 7).astype(np.float32),
        big=big,
        rep=rs.randint(-8, 9, size=(world, 64)).astype(np.float32),
        cs=rs.randn(world, D).astype(np.float32),
        own=rs.randn(world, 40).astype(np.float32),
        rs=rs.randn(world, world * 16).astype(np.float32),
        data=rs.randn(world, 16, 5).astype(np.float32),
        g=rs.randn(world, 32).astype(np.float32),
    )


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        return f"{type(e).__name__}: {e}"
    return ""


def compute(rank: int, world: int, group, inp: dict) -> dict:
    """Every port computation of this file, on this rank's rows."""
    T = {k: torch.from_numpy(v[rank]) for k, v in inp.items()}
    out = {}
    q, scale, zp, qmax, _ = C._int8_qparams(T["big"], group, world, 256)
    out.update({"qparams.q": q.numpy(), "qparams.scale": scale.numpy(),
                "qparams.zp": zp.numpy(), "qparams.qmax": np.array(qmax)})
    tree = [T["a"], T["b"]]
    for mode in MODES:
        got = C.compressed_pmean(tree, group, mode=mode)
        out[f"pmean.{mode}"] = np.concatenate([_np(t) for t in got])
        got = C.compressed_psum(tuple(tree), group, mode=mode)
        assert isinstance(got, tuple)
        out[f"psum.{mode}"] = np.concatenate([_np(t) for t in got])
    out["rep.bf16"] = _np(C.compressed_pmean({"a": T["rep"]}, group, mode="bf16")["a"])
    for mode in ("bf16", "int8"):
        m, e = C.ef_compressed_pmean(tree, C.init_error_feedback(tree), group, mode=mode)
        out[f"ef.{mode}.mean"] = np.concatenate([_np(t) for t in m])
        out[f"ef.{mode}.res"] = np.concatenate([_np(t) for t in e])
    m, r = C.ef_compressed_pmean(torch.ones(4), torch.full((4,), 7.0), group, mode="none")
    out["ef.none"] = np.stack([_np(m), _np(r)])

    # the toy quadratic of the JAX test, under error feedback
    w, e = torch.zeros(D), torch.zeros(D)
    for _ in range(EF_STEPS):
        m, e = C.ef_compressed_pmean(w - T["cs"], e, group, mode="int8", chunk_size=EF_CHUNK)
        w = w - EF_LR * m
    out["ef_run"] = _np(w)

    g, zero = T["own"], torch.zeros(40)
    m, e = C.ef_compressed_pmean(g, zero, group, mode="int8", chunk_size=8)
    m2, e2 = C.ef_compressed_pmean(g - e, torch.zeros(40), group, mode="int8", chunk_size=8)
    out["own"] = np.stack([_np(m), _np(m2), _np(e), _np(e2)])

    for mode in MODES:
        C.reset_tallies()
        got = C.shuffle_sharded_psum([T["a"], T["b"]], group, mode=mode)
        out[f"shuffle.{mode}"] = np.concatenate([_np(t) for t in got])
        out[f"shuffle.{mode}.tallies"] = np.array(json.dumps(C.tallies()))
        sh, res = C.compressed_reduce_scatter(T["rs"], group, mode=mode, want_residual=True)
        out[f"rs.{mode}.shard"], out[f"rs.{mode}.res"] = _np(sh), _np(res)
    for mode in ("bf16", "int8"):
        x = T["data"]
        mean, var, count = C.reduce_moments(
            x.sum(0), (x * x).sum(0), torch.tensor(float(x.shape[0])), group, mode=mode)
        out[f"moments.{mode}"] = np.stack([_np(mean), _np(var), _np(count.expand(5))])
    got = C.compressed_psum({"g": T["g"], "n": torch.ones((), dtype=torch.int32)},
                            group, mode="int8")
    out["mixed.g"], out["mixed.n"] = _np(got["g"]), got["n"].numpy()
    out["mixed.n.dtype"] = np.array(str(got["n"].dtype))

    # the wire: ops, bytes and the compressed accounting
    C.reset_tallies()
    C.compressed_pmean(torch.ones(512), group, mode="int8")
    out["wire.int8"] = np.array(json.dumps([C.tallies(), C.compression_tallies()]))
    C.reset_tallies()
    C.compressed_pmean([torch.ones(300), torch.ones(7)], group, mode="bf16")
    out["wire.bf16"] = np.array(json.dumps([C.tallies(), C.compression_tallies()]))
    C.reset_tallies()
    C.compressed_psum({"f": torch.ones(4), "h": torch.ones(8, dtype=torch.bfloat16),
                       "i": torch.ones(2, dtype=torch.int32)}, group, mode="none")
    out["wire.mixed"] = np.array(C.bytes_total())
    C.reset_tallies()
    C.psum_in_groups(torch.ones(16, dtype=torch.bfloat16), group, min(2, world))
    out["wire.groups"] = np.array(C.bytes_total())
    C.reset_tallies()

    out["err.num_shards"] = np.array(_error(
        lambda: C.shuffle_sharded_psum(T["a"], group, num_shards=0)))
    out["err.unshardable"] = np.array(_error(
        lambda: C.compressed_reduce_scatter(torch.ones(13 if world > 1 else 0), group,
                                            mode="int8")))
    out["err.group_scoped"] = np.array(_error(lambda: C.reduce_moments(
        T["a"][:4], T["a"][:4], torch.tensor(1.0), group, group_size=world, mode="int8")))
    return out


def _replica(rank, world, rdv, out_dir, inp):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                             rank=rank)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **compute(rank, world, tdist.group.WORLD, inp))
    finally:
        C.clear_group_cache()
        tdist.destroy_process_group()


def spawn(world: int, d, inp, target=None) -> list:
    """``target(rank, world, rdv, out_dir, inp)`` (this file's replica by
    default) in ``world`` spawned processes; each rank's npz as a dict."""
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=target or _replica,
                         args=(r, world, str(d / "rdv"), str(d), inp))
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
    """``(world, inputs, per-rank results)``: world 1 in this process,
    worlds 2 and 4 over gloo (one spawn each for the module)."""
    w = request.param
    if w not in _RESULTS:
        inp = make_inputs(w)
        if w == 1:
            C.reset_tallies()
            ranks = [compute(0, 1, None, inp)]
        else:
            ranks = spawn(w, tmp_path_factory.mktemp(f"world{w}"), inp)
        _RESULTS[w] = (w, inp, ranks)
    return _RESULTS[w]


def jax_per_rank(fn, world, *arrays):
    """``fn`` under shard_map on a ``world``-device CPU mesh, one row of
    each array a device; every output leaf stacked over devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))

    def body(*xs):
        return jax.tree_util.tree_map(lambda v: v[None], fn(*[x[0] for x in xs]))

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=tuple(P("data") for _ in arrays),
                          out_specs=P("data")))
    return jax.tree_util.tree_map(np.asarray, f(*[jnp.asarray(a) for a in arrays]))


def world_grid(rows: np.ndarray, world: int, chunk: int = 256):
    """The shared grid of the fused per-rank payloads ``rows`` (world, n),
    in numpy f32 as the JAX arithmetic computes it: per element of the
    padded payload, its chunk's scale and zero point."""
    pad = (-rows.shape[1]) % chunk
    blocks = np.pad(rows, ((0, 0), (0, pad))).reshape(world, -1, chunk)
    gmin = blocks.min(axis=2).min(axis=0)
    gmax = blocks.max(axis=2).max(axis=0)
    zp = ((gmax + gmin) * np.float32(0.5)).astype(np.float32)
    half = ((gmax - gmin) * np.float32(0.5)).astype(np.float32)
    scale = np.where(half > 0, half / np.float32(127 // world), 1).astype(np.float32)
    n = rows.shape[1]
    return np.repeat(scale, chunk)[:n], np.repeat(zp, chunk)[:n]


def dequant_tol(rows, world, chunk=256, mean=False):
    """2 f32 roundings of each element's chunk magnitude."""
    scale, zp = world_grid(rows, world, chunk)
    mag = scale * 127 + world * np.abs(zp)
    return 2 * EPS32 * (mag / world if mean else mag) + 1e-30


# -- compressed_psum / compressed_pmean ---------------------------------------


def test_mode_validation():
    from tpu_syncbn.parallel import collectives as J

    for mod in (C, J):
        with pytest.raises(ValueError, match="compression mode"):
            mod.check_compress_mode("fp8")
        assert mod.check_compress_mode("none") == "none"
    assert C.COMPRESS_MODES == J.COMPRESS_MODES
    assert C.DEFAULT_CHUNK_ELEMS == J.DEFAULT_CHUNK_ELEMS == 256


def test_int8_grid_matches_jax_bit_for_bit(res):
    """q, scale and zp of a ragged payload (1000 = 3 chunks and 232) with a
    constant chunk (scale 1), on the world's shared range."""
    from tpu_syncbn.parallel import collectives as J

    w, inp, ranks = res

    def jq(x):
        q, scale, zp, qmax = J._int8_qparams(J._chunk_pad(x, 256).reshape(-1, 256), "data", w)
        return q.reshape(-1), scale[:, 0], zp[:, 0]

    q, scale, zp = jax_per_rank(jq, w, inp["big"])
    for r, got in enumerate(ranks):
        assert got["qparams.qmax"] == 127 // w
        np.testing.assert_array_equal(got["qparams.q"], q[r])
        np.testing.assert_array_equal(got["qparams.scale"], scale[r])
        np.testing.assert_array_equal(got["qparams.zp"], zp[r])
    assert scale[0][1] == 1.0 and (q[0][256:512] == 0).all()


@pytest.mark.parametrize("mode", MODES)
def test_compressed_pmean_and_psum_match_jax(res, mode):
    from tpu_syncbn.parallel import collectives as J

    w, inp, ranks = res
    fused = np.concatenate([inp["a"], inp["b"]], axis=1)
    want = {}
    for op in ("pmean", "psum"):
        fn = getattr(J, f"compressed_{op}")
        got = jax_per_rank(lambda a, b, fn=fn: fn((a, b), "data", mode=mode), w,
                           inp["a"], inp["b"])
        want[op] = np.concatenate(got, axis=1)
    for r, got in enumerate(ranks):
        for op in ("pmean", "psum"):
            if mode == "none":
                np.testing.assert_allclose(got[f"{op}.none"], want[op][r], rtol=1e-6)
            elif mode == "int8":
                tol = dequant_tol(fused, w, mean=op == "pmean")
                assert (np.abs(got[f"{op}.int8"] - want[op][r]) <= tol).all(), op
            else:  # one bf16 rounding per addend
                tol = BF16_U * np.abs(fused).sum(0) * 2 / (w if op == "pmean" else 1)
                assert (np.abs(got[f"{op}.bf16"] - want[op][r]) <= tol).all(), op


def test_compressed_pmean_none_is_exact(res):
    w, inp, ranks = res
    ref = np.concatenate([inp["a"], inp["b"]], axis=1).mean(0)
    for got in ranks:
        np.testing.assert_allclose(got["pmean.none"], ref, rtol=1e-6)


def test_compressed_pmean_bf16_exact_parity_on_representable_inputs(res):
    """Integer inputs whose partial sums stay bf16-representable reduce
    exactly — bit-equal to the f32 mean."""
    w, inp, ranks = res
    ref = inp["rep"].mean(0)
    for got in ranks:
        assert (got["rep.bf16"] == ref).all()


def test_compressed_pmean_int8_within_quantization_bound(res):
    """The mean's per-element error is bounded by the chunk quantization
    step (half-range / qmax)."""
    w, inp, ranks = res
    ref = np.concatenate([inp["a"], inp["b"]], axis=1).mean(0)
    qmax = 127 // w
    for got in ranks:
        for sl, k in ((slice(0, 300), "a"), (slice(300, 307), "b")):
            step = (inp[k].max() - inp[k].min()) / 2 / qmax
            assert np.abs(got["pmean.int8"][sl] - ref[sl]).max() <= step


def test_int8_puts_int8_on_the_wire(res):
    """The payload-sized all-reduce moves int8 (512 bytes for 512
    elements); the only f32 one is the (-min, max) range of 2 chunks
    (16 bytes). World 1 issues no collective but counts the wire."""
    w, _, ranks = res
    for got in ranks:
        tallies, comp = json.loads(str(got["wire.int8"]))
        if w == 1:
            assert tallies == {}
        else:
            assert tallies == {"psum": {"calls": 1, "bytes": 512},
                               "pmax": {"calls": 1, "bytes": 16}}
        assert comp["compressed_bytes"] == 512 + 8 * 2
        assert comp["saved_bytes"] == 512 * 4 - 528
        assert comp["compression_ratio"] == pytest.approx(2048 / 528)


def test_bf16_wire_is_two_bytes_an_element(res):
    w, _, ranks = res
    for got in ranks:
        tallies, comp = json.loads(str(got["wire.bf16"]))
        assert comp == {"compressed_bytes": 307 * 2, "saved_bytes": 307 * 2,
                        "compression_ratio": 2.0}
        if w > 1:
            assert tallies == {"psum": {"calls": 1, "bytes": 307 * 2}}


def test_compressed_psum_mixed_tree_keeps_nonfloat_exact(res):
    w, inp, ranks = res
    for got in ranks:
        assert got["mixed.n"] == w and str(got["mixed.n.dtype"]) == "torch.int32"
        # each replica's code is within half a step of its value
        step = (inp["g"].max() - inp["g"].min()) / 2 / (127 // w)
        assert np.abs(got["mixed.g"] - inp["g"].sum(0)).max() <= w * step / 2 + 1e-5


# -- error feedback ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_ef_compressed_pmean_matches_jax(res, mode):
    """Mean and new residual from a zero residual, against JAX's."""
    from tpu_syncbn.parallel import collectives as J

    import jax.numpy as jnp

    w, inp, ranks = res
    mean, resid = jax_per_rank(
        lambda a, b: J.ef_compressed_pmean((a, b), (jnp.zeros(300), jnp.zeros(7)), "data",
                                           mode=mode), w, inp["a"], inp["b"])
    mean, resid = np.concatenate(mean, axis=1), np.concatenate(resid, axis=1)
    fused = np.concatenate([inp["a"], inp["b"]], axis=1)
    for r, got in enumerate(ranks):
        if mode == "int8":
            np.testing.assert_array_less(np.abs(got["ef.int8.mean"] - mean[r]),
                                         dequant_tol(fused, w, mean=True))
            np.testing.assert_array_less(np.abs(got["ef.int8.res"] - resid[r]),
                                         dequant_tol(fused, w))
        else:  # the cast is elementwise: the residual exactly, the mean per addend
            np.testing.assert_array_equal(got["ef.bf16.res"], resid[r])
            tol = BF16_U * np.abs(fused).sum(0) * 2 / w
            assert (np.abs(got["ef.bf16.mean"] - mean[r]) <= tol).all()


def test_ef_int8_matches_analytic_reference(res):
    """12 compressed steps on the toy quadratic match the numpy
    error-feedback reference step for step, and converge to the optimum."""
    from test_compressed_collectives import _np_int8_ef_reference

    w, inp, ranks = res
    ref, _ = _np_int8_ef_reference(inp["cs"].astype(np.float64), EF_STEPS, EF_LR,
                                   EF_CHUNK, w)
    for got in ranks:
        np.testing.assert_allclose(got["ef_run"], ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["ef_run"], inp["cs"].mean(0), atol=0.05)


def test_ef_residual_is_own_compression_error(res):
    """The residual is p − C(p): re-compressing g − residual reproduces the
    same mean."""
    _, _, ranks = res
    for got in ranks:
        m, m2, e, e2 = got["own"]
        assert np.abs(e).max() > 0, "quantization error must be captured"
        np.testing.assert_allclose(m, m2, atol=1e-6)
        assert np.abs(e2).max() <= np.abs(e).max() + 1e-6


def test_ef_mode_none_passes_residual_through(res):
    _, _, ranks = res
    for got in ranks:
        np.testing.assert_allclose(got["ef.none"][0], 1.0)
        np.testing.assert_allclose(got["ef.none"][1], 7.0)


# -- shuffle-sharded variant --------------------------------------------------


@pytest.mark.parametrize("mode,tol", [("none", 1e-5), ("bf16", 0.15), ("int8", 1.0)])
def test_shuffle_sharded_psum_matches_psum(res, mode, tol):
    w, inp, ranks = res
    ref = np.concatenate([inp["a"], inp["b"]], axis=1).sum(0)
    for got in ranks:
        np.testing.assert_allclose(got[f"shuffle.{mode}"], ref, atol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_shuffle_sharded_psum_matches_jax(res, mode):
    from tpu_syncbn.parallel import collectives as J

    w, inp, ranks = res
    want = np.concatenate(jax_per_rank(
        lambda a, b: J.shuffle_sharded_psum((a, b), "data", mode=mode), w,
        inp["a"], inp["b"]), axis=1)
    fused = np.concatenate([inp["a"], inp["b"]], axis=1)
    for r, got in enumerate(ranks):
        if mode == "int8":
            assert (np.abs(got["shuffle.int8"] - want[r]) <= dequant_tol(fused, w)).all()
        elif mode == "bf16":
            # each stage rounds: one bf16 rounding per addend and stage
            tol = BF16_U * np.abs(fused).sum(0) * 2 * max(1, len(C._prime_factors(w)))
            assert (np.abs(got["shuffle.bf16"] - want[r]) <= tol).all()
        else:
            np.testing.assert_allclose(got["shuffle.none"], want[r], rtol=1e-6, atol=1e-6)


def test_shuffle_sharded_is_point_to_point_only(res):
    """mode='none' moves every byte by ppermute (the DS-Sync schedule),
    never an all-reduce or all-gather: w − 1 sends a shard over the
    prime-factor stages, none at world 1."""
    w, _, ranks = res
    for got in ranks:
        tallies = json.loads(str(got["shuffle.none.tallies"]))
        if w == 1:
            assert tallies == {}
            continue
        assert set(tallies) == {"ppermute"}
        shard_bytes = -(-307 // w) * 4
        sends = sum(f - 1 for f in C._prime_factors(w)) * w
        assert tallies["ppermute"] == {"calls": sends, "bytes": sends * shard_bytes}


def test_shuffle_sharded_num_shards_and_world1(res):
    """num_shards < 1 raises where there is a world to shard over; at world
    1 the tree comes back as it is (the JAX function returns first)."""
    w, inp, ranks = res
    for got in ranks:
        if w == 1:
            assert str(got["err.num_shards"]) == ""
        else:
            assert "num_shards" in str(got["err.num_shards"])
    t = [torch.ones(3)]
    assert C.shuffle_sharded_psum(t, None, num_shards=0) is t


# -- compressed reduce-scatter ------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_compressed_reduce_scatter_modes(res, mode):
    """The JAX test's bounds against the exact sum, and JAX's shard and
    residual (int8 within the dequantize tolerance; none exact; the bf16
    residual exactly)."""
    from tpu_syncbn.parallel import collectives as J

    w, inp, ranks = res
    x = inp["rs"]
    full = x.sum(0)
    span = float(x.max() - x.min())
    tol = {"none": 1e-5, "bf16": 0.05 * span, "int8": span / 2 / 15}[mode]
    shard, resid = jax_per_rank(
        lambda v: J.compressed_reduce_scatter(v, "data", mode=mode, want_residual=True),
        w, x)
    got_full = np.concatenate([r[f"rs.{mode}.shard"] for r in ranks])
    np.testing.assert_allclose(got_full, full, atol=max(tol * w, 1e-4))
    n = x.shape[1] // w
    for r, got in enumerate(ranks):
        if mode == "none":
            assert np.abs(got["rs.none.res"]).max() == 0.0
            np.testing.assert_allclose(got["rs.none.shard"], shard[r], rtol=1e-6, atol=1e-6)
        elif mode == "bf16":
            np.testing.assert_array_equal(got["rs.bf16.res"], resid[r])
        else:
            scale, zp = world_grid(x, w, n)
            mag = scale * 127 + w * np.abs(zp)
            np.testing.assert_array_less(np.abs(got["rs.int8.res"] - resid[r]),
                                         2 * EPS32 * mag + 1e-30)
            sl = slice(r * n, (r + 1) * n)
            np.testing.assert_array_less(np.abs(got["rs.int8.shard"] - shard[r]),
                                         2 * EPS32 * mag[sl] + 1e-30)


def test_compressed_reduce_scatter_rejects_unshardable(res):
    """13 elements do not divide over 2 or 4 replicas; any size divides
    over one."""
    w, _, ranks = res
    for got in ranks:
        if w > 1:
            assert "must divide" in str(got["err.unshardable"])
    shard, _ = C.compressed_reduce_scatter(torch.ones(13), None, mode="int8")
    assert shard.shape == (13,)


def test_int8_refuses_worlds_past_127():
    """127 // world would be zero: world sums would wrap int8."""
    with pytest.raises(ValueError, match="up to 127"):
        C._int8_qparams(torch.ones(4), None, 128, 4)


# -- reduce_moments stats modes ----------------------------------------------


@pytest.mark.parametrize("mode,tol", [("bf16", 0.05), ("int8", 0.5)])
def test_reduce_moments_compressed_keeps_count_exact(res, mode, tol):
    w, inp, ranks = res
    flat = inp["data"].reshape(-1, 5)
    for got in ranks:
        mean, var, count = got[f"moments.{mode}"]
        np.testing.assert_allclose(mean, flat.mean(0), atol=tol)
        np.testing.assert_array_equal(count, np.full(5, 16.0 * w))


def test_reduce_moments_matches_jax(res):
    """int8 within f32 rounding; bf16 within one bf16 rounding of each
    replica's partial sums (the world-4 sum's order differs)."""
    from tpu_syncbn.parallel import collectives as J

    import jax.numpy as jnp

    w, inp, ranks = res
    x = inp["data"]
    n = x.shape[0] * x.shape[1]
    tol_mean = 2 * w * BF16_U * np.abs(x.sum(1)).sum(0) / n
    tol_var = 2 * w * BF16_U * (x * x).sum(1).sum(0) / n + 2 * np.abs(x.mean((0, 1))) * tol_mean
    for mode in ("bf16", "int8"):
        want = jax_per_rank(lambda v, m=mode: jnp.stack(J.reduce_moments(
            v.sum(0), (v * v).sum(0), jnp.float32(v.shape[0]), "data", mode=m)[:2]), w, x)
        for r, got in enumerate(ranks):
            mean, var = got[f"moments.{mode}"][:2]
            if mode == "int8":
                np.testing.assert_allclose(mean, want[r][0], rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(var, want[r][1], rtol=1e-5, atol=1e-6)
            else:
                assert (np.abs(mean - want[r][0]) <= tol_mean).all()
                assert (np.abs(var - want[r][1]) <= tol_var).all()


def test_reduce_moments_rejects_group_scoped_compression(res):
    _, _, ranks = res
    for got in ranks:
        assert "group_size" in str(got["err.group_scoped"])


# -- wire-dtype byte tallies ------------------------------------------------


def test_tally_mixed_dtype_tree_counts_wire_itemsize(res):
    """Each leaf tallies at its transmitted itemsize: 4·4 + 8·2 + 2·4 = 40
    bytes (nothing is sent at world 1)."""
    w, _, ranks = res
    for got in ranks:
        assert int(got["wire.mixed"]) == (40 if w > 1 else 0)


def test_tally_psum_in_groups_counts_fused_f32_payload(res):
    """A bf16 tensor through psum_in_groups travels as f32: 16 elements,
    64 bytes (groups of 2; at world 1 the one-rank group sends nothing)."""
    w, _, ranks = res
    for got in ranks:
        assert int(got["wire.groups"]) == (64 if w > 1 else 0)


def test_tally_compressed_metrics():
    """compressed_bytes counts the lossy wire payload; the ratio reads
    logical / wire; reset_tallies clears them."""
    C.reset_tallies()
    C.compressed_pmean(torch.ones(256), None, mode="int8")
    t = C.compression_tallies()
    assert t["compressed_bytes"] >= 256 and t["compression_ratio"] >= 3.0
    C.reset_tallies()
    assert C.compression_tallies() == {"compressed_bytes": 0, "saved_bytes": 0,
                                       "compression_ratio": None}


def test_resnet50_payload_ratio_is_3_879():
    """The gradient payload of ResNet-50 (25,557,032 f32) in chunks of 256:
    99,833 chunks, 25,557,248 int8 + 8 bytes of range a chunk on the wire."""
    n = 25_557_032
    chunks = -(-n // 256)
    wire = chunks * 256 + 8 * chunks
    assert (chunks, chunks * 256, wire) == (99_833, 25_557_248, 26_355_912)
    assert round(n * 4 / wire, 3) == 3.879


def test_trees_keep_their_kind():
    a, b = torch.ones(3), torch.zeros(2)
    assert isinstance(C.compressed_psum((a, b), None, mode="int8"), tuple)
    assert set(C.compressed_pmean({"x": a, "y": b}, None, mode="bf16")) == {"x", "y"}
    out = C.compressed_psum(a, None, mode="int8")
    assert isinstance(out, torch.Tensor) and torch.equal(out, a)
    with pytest.raises(TypeError, match="tensor"):
        C.compressed_psum(3.0, None, mode="int8")


# -- the encode's residual bound (ops.quant_int8.encode_residual_bound) ------


def _adversarial_chunks(qmax: int) -> list:
    """Payload chunks of 256 f32 that stress the encode's roundings: codes
    on the rounding boundaries (and one ulp either side), a large |zp|
    beside a narrow range, a constant chunk, f32's extremes that gradients
    still reach, and plain noise."""
    rs = np.random.RandomState(7 + qmax)
    f32 = np.float32
    out = []
    for amp in (1.0, 3.0e-3, 7.7e5):
        # (j + 1/2) steps from a zero midpoint: each code sits on a tie
        scale = f32(f32(amp) * f32(1.0 / qmax))
        j = np.arange(-qmax, qmax, dtype=np.float64)
        ties = ((j + 0.5) * float(scale)).astype(f32)
        ring = np.concatenate([ties, np.nextafter(ties, f32(np.inf)),
                               np.nextafter(ties, f32(-np.inf)), [f32(-amp), f32(amp)]])
        out.append(np.resize(ring, 256).astype(f32))
    for base, width in ((1.0e4, 1.0e-2), (-3.0e6, 1.0), (6.5e7, 40.0), (2.5e-3, 1e-9)):
        out.append((f32(base) + (rs.rand(256) * width).astype(f32)).astype(f32))
    out.append(np.full(256, 3.7, f32))
    for amp in (1.0e37, 1.0e-30, 3.0e-39):  # near f32's max, tiny, subnormal
        out.append((rs.randn(256) * amp).astype(f32))
    out.append(rs.randn(256).astype(f32))
    return out


def _encoded(qmax: int):
    from tpu_syncbn_torch.ops import quant_int8 as Q

    chunks = _adversarial_chunks(qmax)
    g = torch.from_numpy(np.concatenate(chunks))
    # a residual carried in from the last step, ~a step of each chunk wide
    e = torch.from_numpy(np.concatenate([
        (np.random.RandomState(len(c)).randn(256) * 1e-3 * (np.abs(c).max() or 1.0) / qmax)
        .astype(np.float32) for c in chunks]))
    ranges = Q.minmax_plain(g, e, 256)
    q, scale, zp, res = Q.encode_plain(g, e, ranges, qmax, 256, True)
    p = g + e
    assert torch.isfinite(p).all() and torch.isfinite(scale).all()
    return Q, p, q, scale, zp, res


@pytest.mark.parametrize("qmax", (127, 63, 1))
def test_encode_residual_within_its_derived_bound(qmax):
    """Every residual of the plain encode lies inside the bound derived from
    its f32 arithmetic, on chunks built to push each rounding; the bound is
    scale/2 plus a few roundings, not a wider slack."""
    Q, p, q, scale, zp, res = _encoded(qmax)
    bound = Q.encode_residual_bound(p, scale, zp, q, 256)
    over = res.double().abs() - bound
    assert float(over.max()) <= 0, int(over.argmax())
    half = scale.double().repeat_interleave(256) / 2
    slack = (bound - half) / (half + 1e-300)
    # where |zp| is at most 1000 half-steps the slack stays under
    # u (1 + 8 qmax + 2000) of scale/2, a few thousand roundings
    narrow = zp.double().abs().repeat_interleave(256) <= 1e3 * half
    assert float(slack[narrow].max()) < 2.0 ** -12


@pytest.mark.parametrize("qmax", (127, 63, 1))
def test_encode_residual_bound_catches_planted_faults(qmax):
    """The same bound catches an off-by-one code, and a residual formed with
    a scale k ulps off, k taken from the derivation: at a code ±qmax the
    residual moves by k ulp(scale) qmax, which must exceed twice the
    chunk's bound."""
    Q, p, q, scale, zp, _ = _encoded(qmax)
    n_chunks = scale.numel()
    blocks = p.view(n_chunks, 256)
    qf = q.view(n_chunks, 256).to(torch.float32)

    def residual(sc, codes):
        return (blocks - (sc[:, None] * codes + zp[:, None])).reshape(-1)

    bound = Q.encode_residual_bound(p, scale, zp, q, 256)
    # an off-by-one code on every element
    bad = residual(scale, qf + 1.0).double().abs() > bound
    assert bad.view(n_chunks, 256).any(dim=1).all()
    # a scale k ulps off, chunk by chunk with each chunk's own k
    at_edge = qf.abs() == qmax
    ulp = torch.from_numpy(np.spacing(scale.numpy())).double()
    b_edge = torch.where(at_edge, bound.view(n_chunks, 256), 0.0).amax(dim=1)
    k = torch.floor(2 * b_edge / (ulp * qmax)) + 1
    wrong = (scale.double() + k * ulp).to(torch.float32)
    live = at_edge.any(dim=1) & (wrong != scale)
    bad = (residual(wrong, qf).double().abs() > bound).view(n_chunks, 256)
    assert int(live.sum()) >= n_chunks - 1  # all but the constant chunk
    assert bad.any(dim=1)[live].all()
