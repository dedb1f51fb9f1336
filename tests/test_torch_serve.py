"""The port's serving subsystem (``tpu_syncbn_torch.serve``) against the
JAX package's (``tpu_syncbn.serve``): JAX's tests/test_serve.py case for
case, plus the port's own contracts.

* The engine on the CPU (a program is the eager eval forward) against
  the JAX ``InferenceEngine`` on a 1-device CPU mesh, from the same
  state: the JAX test's ``Net`` trained by the JAX ``DataParallel`` and
  carried into the port with ``models.load_jax_params``, and a narrow
  ResNet-18 (width 8, 32² NHWC images) trained by the port's
  ``DataParallel`` and carried into the JAX model — outputs through
  padding, below, at and between buckets and chunked through the largest
  one at rtol 2e-4 / atol 1e-5 (the trainers' tolerances); bucket
  rounding, ``stats()`` and the program cache's hits, misses and
  evictions equal JAX's; the ``serve.*`` metric names equal JAX's on the
  same request script.
* ``swap_params`` / ``rollback`` (the next forward uses the new weights,
  no new program, rollback bit for bit), ``VersionSkewError`` touching
  nothing, two threads on one bucket, the FSDP refusal.
* Eval-mode BN routing: a CPU tensor takes ``batch_norm_elemt`` bit for
  bit; the kernel wrapper's eval normalize is differentiable.
* The batcher with the duck-typed stub engine, as in JAX.

Each JAX engine is built once a module (fixtures); every wait is bounded.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import models, nn, parallel, serve
from tpu_syncbn_torch.obs import telemetry, tracing
from tpu_syncbn_torch.parallel import scan_driver
from tpu_syncbn_torch.runtime import resilience

TOL = dict(rtol=2e-4, atol=1e-5)
WAIT_S = 10


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Both packages start and end with telemetry at its default, an
    empty registry and no tracer."""
    from tpu_syncbn.obs import telemetry as jtel, tracing as jtr

    def reset():
        for tel, tr in ((telemetry, tracing), (jtel, jtr)):
            tel.set_enabled(None)
            tel.REGISTRY.reset()
            tr.uninstall()

    reset()
    yield
    reset()


# -- the nets ------------------------------------------------------------------


class Net(torch.nn.Module):
    """JAX's tests/test_serve.py ``Net``: Linear(4, 6) then BatchNorm1d(6)."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 6)
        self.bn = nn.BatchNorm1d(6, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def _sq_loss(m, b):
    return (m(b) ** 2).mean()


def _x(n, seed=9):
    return np.random.RandomState(seed).randn(n, 4).astype(np.float32)


def _jax_trained_net():
    """JAX's ``_trained_dp()`` on a 1-device mesh: (trainer, flat state)."""
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime

    class JNet(nnx.Module):
        def __init__(self, rngs):
            self.fc = nnx.Linear(4, 6, rngs=rngs)
            self.bn = jnn.BatchNorm1d(6)

        def __call__(self, x):
            return self.bn(self.fc(x))

    model = jnn.convert_sync_batchnorm(JNet(nnx.Rngs(0)))
    dp = jparallel.DataParallel(model, optax.sgd(0.05), _sq_loss,
                                mesh=jruntime.data_parallel_mesh(1))
    for s in range(3):
        dp.train_step(jnp.asarray(np.random.RandomState(s).randn(16, 4).astype(np.float32)))
    return dp, flat_state(dp.sync_to_model())


@pytest.fixture(scope="module")
def jax_net():
    """The JAX trainer and its trained state, once a module."""
    return _jax_trained_net()


@pytest.fixture(scope="module")
def jax_engine(jax_net):
    """The JAX engine at buckets (8, 16), warmed, once a module."""
    from tpu_syncbn import serve as jserve

    eng = jserve.InferenceEngine.from_trainer(jax_net[0], buckets=(8, 16))
    eng.warm(_x(1))
    return eng


def _port_dp(state=None, *, zero=False, opt=None):
    model = nn.convert_sync_batchnorm(Net())
    if state is not None:
        models.load_jax_params(model, state)
    opt = opt(model.parameters()) if opt is not None \
        else torch.optim.SGD(model.parameters(), lr=0.05)
    return parallel.DataParallel(model, opt, _sq_loss, device="cpu", zero=zero)


def _trained_dp(*, zero=False, steps=3, opt=None):
    """The port's counterpart of JAX's ``_trained_dp``."""
    torch.manual_seed(0)
    dp = _port_dp(zero=zero, opt=opt)
    for s in range(steps):
        dp.train_step(np.random.RandomState(s).randn(16, 4).astype(np.float32))
    return dp


def _local_eval(model, x, bucket=None):
    """The module's eval forward on ``x`` (zero-padded to ``bucket`` rows
    and sliced back when given: the same matmul shapes as the engine's)."""
    if bucket is not None:
        pad = np.zeros((bucket - len(x),) + x.shape[1:], x.dtype)
        return _local_eval(model, np.concatenate([x, pad]))[:len(x)]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(torch.from_numpy(x)).numpy()
    finally:
        model.train(was)


# ------------------------------------------------------------------ engine


class TestInferenceEngine:
    def test_predict_matches_jax_and_local_eval_through_padding(self, jax_net, jax_engine):
        """Pad-to-bucket + slice is invisible: the output equals JAX's
        engine on the same trained state and the plain local eval
        forward on the same running stats, below, at and between
        buckets."""
        dp = _port_dp(jax_net[1])
        eng = serve.InferenceEngine.from_trainer(dp, buckets=(8, 16))
        for n in (1, 5, 8, 11, 16):
            x = _x(n, seed=n)
            out = eng.predict(x)
            want = jax_engine.predict(x)
            assert out.shape == want.shape == (n, 6)
            np.testing.assert_allclose(out, want, **TOL)
            np.testing.assert_allclose(out, _local_eval(dp.model, x), rtol=1e-5, atol=1e-6)

    def test_engine_is_eval_mode_and_never_mutates_stats(self):
        """The engine serves its own eval-mode copy: the trainer's module
        stays in training mode, its running stats and count untouched."""
        dp = _trained_dp()
        eng = serve.InferenceEngine.from_trainer(dp, buckets=(8,))
        assert not eng.model.training and not eng.model.bn.training
        assert dp.model.training and dp.model.bn.training
        assert eng.model.bn.running_mean.data_ptr() != dp.model.bn.running_mean.data_ptr()
        before = dp.model.bn.running_mean.clone()
        nbt = int(dp.model.bn.num_batches_tracked)
        out1 = eng.predict(_x(8))
        out2 = eng.predict(_x(8))
        np.testing.assert_array_equal(out1, out2)
        assert torch.equal(dp.model.bn.running_mean, before)
        assert int(dp.model.bn.num_batches_tracked) == nbt
        assert int(eng.model.bn.num_batches_tracked) == nbt
        dp.train_step(_x(16, seed=3))  # the trainer trains on; the copy does not move
        assert int(eng.model.bn.num_batches_tracked) == nbt
        np.testing.assert_array_equal(eng.predict(_x(8)), out1)

    def test_bucket_sizes_normalize_like_jax(self, jax_net):
        from tpu_syncbn import serve as jserve

        dp = _trained_dp()
        eng = serve.InferenceEngine.from_trainer(dp, buckets=(3, 8, 8, 13))
        jeng = jserve.InferenceEngine.from_trainer(jax_net[0], buckets=(3, 8, 8, 13))
        assert eng.buckets == jeng.buckets == (3, 8, 13)  # deduped, sorted; world 1
        assert eng.world == 1
        for n in (1, 3, 4, 9, 13):
            assert eng.bucket_for(n) == jeng.bucket_for(n)
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            eng.bucket_for(14)
        with pytest.raises(ValueError, match="bucket"):
            serve.InferenceEngine.from_trainer(dp, buckets=())
        with pytest.raises(ValueError, match="usable bucket"):
            serve.InferenceEngine.from_trainer(dp, buckets=(0, -2))

    def test_oversize_batch_chunks_through_max_bucket(self, jax_net):
        from tpu_syncbn import serve as jserve

        dp = _port_dp(jax_net[1])
        eng = serve.InferenceEngine.from_trainer(dp, buckets=(8,))
        jeng = jserve.InferenceEngine.from_trainer(jax_net[0], buckets=(8,))
        x = _x(21)  # 8 + 8 + 5
        out = eng.predict(x)
        np.testing.assert_allclose(out, jeng.predict(x), **TOL)
        np.testing.assert_allclose(out, _local_eval(dp.model, x), rtol=1e-5, atol=1e-6)
        assert eng.stats()["program_cache"]["hits"] == 2

    def test_program_retention_is_lru_bounded_as_jax(self, jax_net):
        """Pathological shape traffic cannot grow the program set beyond
        ``scan_driver.MAX_CACHED_PROGRAMS``; an evicted bucket is rebuilt
        (not an error). The cache's accounting equals JAX's on the same
        traffic (its byte sizes aside: JAX's come from XLA's memory
        analysis, a CPU program here has none)."""
        from tpu_syncbn import serve as jserve

        buckets = tuple(8 * (i + 1) for i in range(6))
        eng = serve.InferenceEngine.from_trainer(_trained_dp(), buckets=buckets)
        jeng = jserve.InferenceEngine.from_trainer(jax_net[0], buckets=buckets)
        for e in (eng, jeng):
            for b in buckets:
                e.predict(_x(b))
            e.predict(_x(8))
        stats, jstats = eng.stats(), jeng.stats()
        assert stats["programs_compiled"] == 7
        assert stats["programs_live"] <= scan_driver.MAX_CACHED_PROGRAMS
        ours = {k: v for k, v in stats["program_cache"].items() if k != "bytes_live"}
        theirs = {k: v for k, v in jstats["program_cache"].items() if k != "bytes_live"}
        assert ours == theirs
        assert {k: v for k, v in stats.items() if k != "program_cache"} == \
            {k: v for k, v in jstats.items() if k != "program_cache"}
        assert eng.predict(_x(8)).shape == (8, 6)

    def test_warm_builds_all_buckets_ahead_of_traffic(self):
        eng = serve.InferenceEngine.from_trainer(_trained_dp(), buckets=(8, 16))
        eng.warm(_x(1))
        assert eng.stats()["programs_compiled"] == 2
        eng.predict(_x(5))
        eng.predict(_x(12))
        assert eng.stats()["programs_compiled"] == 2  # traffic = cache hits
        assert eng.stats()["program_cache"]["hits"] == 2
        assert eng.health() == {"buckets": [8, 16], "programs_live": 2,
                                "programs_compiled": 2, "version": 0}

    def test_from_zero_trainer_serves_like_the_replicated_one(self):
        """JAX's test_from_zero_trainer_unshards_params: an engine built
        from a ``zero=True`` trainer serves bit-identically to one built
        from the replicated trainer with the same training history (the
        port's module holds the full parameters between steps)."""
        outs = {}
        for zero in (False, True):
            dp = _trained_dp(zero=zero, opt=lambda p: torch.optim.Adam(p, lr=1e-2))
            eng = serve.InferenceEngine.from_trainer(dp, buckets=(8,))
            outs[zero] = eng.predict(_x(6))
        np.testing.assert_array_equal(outs[False], outs[True])

    def test_mismatched_leading_axes_rejected(self):
        eng = serve.InferenceEngine.from_trainer(_trained_dp(), buckets=(8,))
        with pytest.raises(ValueError, match="leading"):
            eng.predict({"a": _x(4), "b": _x(5)})
        with pytest.raises(ValueError, match="leading"):
            eng.predict(np.float32(1.0))


def _resnet_pair():
    """A narrow ResNet-18 (width 8, CIFAR stem) trained two SGD steps by
    the port's ``DataParallel`` on 32² NHWC images, and the JAX model
    holding the same state (kernels transposed back to HWIO / (in, out))."""
    import jax.numpy as jnp
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import compat
    from tpu_syncbn import models as jmodels
    from tpu_syncbn import nn as jnn
    from tpu_syncbn_torch.models.weights import _port_name

    kw = dict(num_classes=10, small_input=True, width=8)
    tm = nn.convert_sync_batchnorm(models.resnet18(device="cpu", **kw))
    jm = jnn.convert_sync_batchnorm(jmodels.resnet18(rngs=nnx.Rngs(0), **kw))
    models.load_jax_params(tm, flat_state(jm))

    def ce(m, b):
        x, y = b
        return torch.nn.functional.cross_entropy(m(x), y.long())

    dp = parallel.DataParallel(tm, torch.optim.SGD(tm.parameters(), lr=0.1, momentum=0.9),
                               ce, device="cpu")
    rs = np.random.RandomState(4)
    for _ in range(2):
        dp.train_step((rs.randn(8, 32, 32, 3).astype(np.float32),
                       rs.randint(0, 10, 8).astype(np.int64)))
    port = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}

    def back(key, value):
        t = port[_port_name(key, value, tm)[0]].detach()
        if key.endswith(".kernel"):
            t = t.permute(2, 3, 1, 0) if t.ndim == 4 else t.T
        return jnp.asarray(t.numpy().astype(np.asarray(value).dtype))

    def walk(d, prefix):
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict) else back(f"{prefix}{k}", v)
                for k, v in d.items()}

    state = nnx.state(jm)
    compat.nnx_replace_by_pure_dict(state, walk(compat.nnx_to_pure_dict(state), ""))
    nnx.update(jm, state)
    return dp, jm


def test_narrow_resnet_matches_jax_through_padding_and_chunking():
    """The engine on a narrow ResNet (20 BN layers) against JAX's engine on
    the same trained state: sizes below, at and between the buckets
    (4, 8), and chunked through 8."""
    from tpu_syncbn import runtime as jruntime
    from tpu_syncbn import serve as jserve

    dp, jm = _resnet_pair()
    eng = serve.InferenceEngine.from_trainer(dp, buckets=(4, 8))
    jeng = jserve.InferenceEngine(jm, mesh=jruntime.data_parallel_mesh(1), buckets=(4, 8))
    rs = np.random.RandomState(5)
    for n in (1, 3, 4, 6, 8, 11):
        x = rs.randn(n, 32, 32, 3).astype(np.float32)
        out = eng.predict(x)
        want = np.asarray(jeng.predict(x))
        assert out.shape == want.shape == (n, 10)
        np.testing.assert_allclose(out, want, **TOL)
    assert eng.stats()["programs_compiled"] == jeng.stats()["programs_compiled"] == 2


# ----------------------------------------------------- weights and threads


def _perturbed(eng, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {n: p + 0.1 * torch.randn(p.shape, generator=g)
            for n, p in eng.param_template().items()}


def test_swap_params_and_rollback_round_trip():
    """A swap copies into the tensors the programs read: the next call is
    the new weights' forward with no new program; rollback restores the
    old outputs bit for bit; versions and the retained copy follow."""
    dp = _trained_dp()
    eng = serve.InferenceEngine.from_trainer(dp, buckets=(8,))
    x = _x(5)
    old = eng.predict(x)
    new = _perturbed(eng)
    rest = {n: b.clone() + 0.5 for n, b in eng.model.named_buffers()
            if b.dtype == torch.float32}
    rest.update({n: b.clone() for n, b in eng.model.named_buffers()
                 if b.dtype != torch.float32})
    nbytes = eng.params_nbytes()
    assert eng.swap_params(new, rest, version=3) == 0
    assert (eng.version, eng.previous_version) == (3, 0)
    assert eng.params_nbytes() == 2 * nbytes  # live + retained
    ref = Net()
    ref.load_state_dict({**{k: v for k, v in new.items()}, **rest})
    np.testing.assert_array_equal(eng.predict(x), _local_eval(ref, x, 8))
    assert eng.stats()["programs_compiled"] == 1
    assert eng.rollback() == 0
    assert (eng.version, eng.previous_version) == (0, 3)
    np.testing.assert_array_equal(eng.predict(x), old)
    assert eng.stats()["programs_compiled"] == 1
    # numpy arrays swap in too; params alone keep the buffers
    eng.swap_params({n: v.numpy() for n, v in new.items()}, version=4)
    ref.load_state_dict({**new, **{n: b for n, b in eng.model.named_buffers()}})
    np.testing.assert_array_equal(eng.predict(x), _local_eval(ref, x, 8))


def test_rollback_without_a_previous_version_raises():
    eng = serve.InferenceEngine.from_trainer(_trained_dp(), buckets=(8,))
    with pytest.raises(RuntimeError, match="no previous"):
        eng.rollback()


@pytest.mark.parametrize("skew", ["shape", "dtype", "missing", "extra", "rest"])
def test_skewed_swap_raises_and_changes_nothing(skew):
    eng = serve.InferenceEngine.from_trainer(_trained_dp(), buckets=(8,))
    x = _x(5)
    before = eng.predict(x)
    params, rest = _perturbed(eng), None
    if skew == "shape":
        params["fc.weight"] = torch.zeros(6, 5)
    elif skew == "dtype":
        params["fc.bias"] = params["fc.bias"].double()
    elif skew == "missing":
        params.pop("bn.bias")
    elif skew == "extra":
        params["fc.extra"] = torch.zeros(1)
    else:
        rest = {"bn.running_mean": torch.zeros(6)}
    with pytest.raises(serve.VersionSkewError):
        eng.swap_params(params, rest, version=7)
    assert (eng.version, eng.previous_version) == (0, None)
    np.testing.assert_array_equal(eng.predict(x), before)


def test_two_threads_predict_on_one_bucket_get_their_own_rows():
    """A bucket's buffers exist once: each caller holds them from its
    copy-in to its copy-out, so concurrent callers of one bucket each get
    their own rows."""
    dp = _trained_dp()
    eng = serve.InferenceEngine.from_trainer(dp, buckets=(8,))
    eng.warm(_x(1))
    xs = [_x(3 + (i % 5), seed=100 + i) for i in range(16)]
    want = [_local_eval(dp.model, x) for x in xs]
    got: dict = {}
    errors: list = []

    def worker(k):
        try:
            for i in range(k, len(xs), 2):
                got[i] = eng.predict(xs[i])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i], w, rtol=1e-5, atol=1e-6)
    assert eng.stats()["programs_compiled"] == 1


def test_dict_batches_and_outputs():
    """A batch tree (a dict of arrays) pads and slices leaf by leaf; a
    dict output comes back as a dict."""
    dp = _trained_dp()
    eng = serve.InferenceEngine.from_trainer(
        dp, buckets=(4,), apply_fn=lambda m, b: {"y": m(b["x"]), "z": b["x"] * 2})
    x = _x(6)
    out = eng.predict({"x": x})
    assert set(out) == {"y", "z"} and out["y"].shape == (6, 6)
    np.testing.assert_allclose(out["y"], _local_eval(dp.model, x), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["z"], x * 2)


def test_dict_key_order_shares_one_program_and_feeds_each_key():
    """Dicts walk their keys sorted, as JAX's tree_util does: a batch whose
    dict differs only in insertion order reuses the same program, and each
    key's rows still reach that key (two leaves of one shape and dtype)."""
    from tpu_syncbn_torch.serve.engine import tree_leaves

    a, b = _x(3, seed=1), _x(3, seed=2)
    assert tree_leaves({"b": b, "a": a})[0] is a
    dp = _trained_dp()
    eng = serve.InferenceEngine.from_trainer(
        dp, buckets=(4,), apply_fn=lambda m, t: m(t["a"]) - 2 * t["b"][:, :1])
    want = _local_eval(dp.model, a) - 2 * b[:, :1]
    for batch in ({"a": a, "b": b}, {"b": b, "a": a}):
        np.testing.assert_allclose(eng.predict(batch), want, rtol=1e-5, atol=1e-6)
    assert eng.stats()["programs_compiled"] == 1


def test_entry_points_default_to_the_card():
    """The engine runs where it is asked: with no device on a machine
    without a card it raises (never falls back to the CPU), a model on
    another device is refused, and an FSDP layout names A.12c (the
    engine's sharded store)."""
    from tpu_syncbn_torch.parallel.layout import SpecLayout

    model = nn.convert_sync_batchnorm(Net())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.InferenceEngine(model)
    with pytest.raises(NotImplementedError, match="A.12c"):
        serve.InferenceEngine(model, device="cpu",
                              layout=SpecLayout.fsdp(data=1, fsdp=1, device="cpu"))
    eng = serve.InferenceEngine(model, device="cpu",
                                layout=SpecLayout.zero(device="cpu"), buckets=(2,))
    assert eng.predict(_x(2)).shape == (2, 6)


# ------------------------------------------------------- eval-mode BN


def test_eval_bn_on_cpu_tensors_keeps_batch_norm_elemt_bit_for_bit():
    from tpu_syncbn_torch.ops import batch_norm as bn_ops

    g = torch.Generator().manual_seed(0)
    for dtype, shape, axis in ((torch.float32, (4, 6, 5, 5), 1), (torch.bfloat16, (7, 6), -1),
                               (torch.float64, (3, 6), -1)):
        x = torch.randn(shape, generator=g).to(dtype)
        m, v = torch.randn(6, generator=g), torch.rand(6, generator=g) + 0.5
        w, b = torch.randn(6, generator=g), torch.randn(6, generator=g)
        got = bn_ops.batch_norm_inference(x, m, v, w, b, eps=1e-5, channel_axis=axis)
        want = bn_ops.batch_norm_elemt(x, m, v, w, b, 1e-5, channel_axis=axis)
        assert got.dtype == dtype and torch.equal(got, want)


def test_kernel_normalize_is_differentiable_like_the_plain_chain():
    """``triton_bn.bn_normalize`` with a gradient asked for (eval BN in a
    graph that trains) gives the plain chain's dx, dγ, dβ."""
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.ops import triton_bn as T

    g = torch.Generator().manual_seed(1)
    x0 = torch.randn(10, 6, generator=g)
    m, v = torch.randn(6, generator=g), torch.rand(6, generator=g) + 0.5
    dy = torch.randn(10, 6, generator=g)
    grads = []
    for fn in (lambda x, w, b: T.bn_normalize(x, m, v, w, b, 1e-5),
               lambda x, w, b: bn_ops.batch_norm_elemt(x, m, v, w, b, 1e-5)):
        x = x0.clone().requires_grad_(True)
        w = torch.ones(6, requires_grad=True)
        b = torch.zeros(6, requires_grad=True)
        (fn(x, w, b) * dy).sum().backward()
        grads.append((x.grad, w.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- batcher


class StubEngine:
    """Duck-typed engine for pure queueing-logic tests: bucket = fixed
    size, predict doubles the payload after an optional delay."""

    def __init__(self, bucket=4, delay=0.0):
        self.max_bucket = bucket
        self._delay = delay
        self.calls: list[int] = []

    def bucket_for(self, n):
        if n > self.max_bucket:
            raise ValueError(f"batch of {n} exceeds bucket {self.max_bucket}")
        return self.max_bucket

    def predict(self, b):
        self.calls.append(int(np.shape(b)[0]))
        if self._delay:
            time.sleep(self._delay)
        return np.asarray(b) * 2.0


def _item(v, n=1):
    return np.full((n, 1), v, np.float32)


class TestDynamicBatcher:
    def test_requests_coalesce_and_each_gets_its_slice(self):
        eng = StubEngine(bucket=4)
        with serve.DynamicBatcher(eng, max_batch=4, max_wait_ms=100,
                                  max_queue=32) as bat:
            futs = [bat.submit(_item(i)) for i in range(8)]
            res = [f.result(timeout=WAIT_S) for f in futs]
        for i, r in enumerate(res):
            assert float(r[0, 0]) == 2.0 * i
        assert bat.counters.count("requests") == 8
        assert bat.counters.count("items") == 8
        assert bat.counters.count("batches") <= 4

    def test_max_wait_dispatches_a_lonely_request(self):
        eng = StubEngine(bucket=8)
        with serve.DynamicBatcher(eng, max_batch=8, max_wait_ms=10,
                                  max_queue=8) as bat:
            t0 = time.perf_counter()
            out = bat.submit(_item(3.0)).result(timeout=WAIT_S)
            dt = time.perf_counter() - t0
        assert float(out[0, 0]) == 6.0
        assert dt < 5.0
        assert bat.fill_ratio == pytest.approx(1 / 8)

    def test_multi_item_requests_and_batch_boundary_carry(self):
        eng = StubEngine(bucket=4)
        with serve.DynamicBatcher(eng, max_batch=4, max_wait_ms=50,
                                  max_queue=32) as bat:
            futs = [bat.submit(_item(float(i), n=3)) for i in range(4)]
            res = [f.result(timeout=WAIT_S) for f in futs]
        for i, r in enumerate(res):
            assert r.shape == (3, 1)
            np.testing.assert_array_equal(r, np.full((3, 1), 2.0 * i))
        assert all(c <= 4 for c in eng.calls)

    def test_queue_full_rejects_with_backpressure(self):
        eng = StubEngine(bucket=4, delay=0.2)
        bat = serve.DynamicBatcher(eng, max_batch=4, max_wait_ms=1, max_queue=2)
        try:
            futs = [bat.submit(_item(0))]
            rejected = 0
            for _ in range(30):
                try:
                    futs.append(bat.submit(_item(1)))
                except serve.RejectedError:
                    rejected += 1
            assert rejected > 0
            assert bat.counters.count("rejected") == rejected
            for f in futs:  # everything admitted is still answered
                f.result(timeout=30)
        finally:
            bat.close()

    def test_oversize_request_rejected_up_front(self):
        bat = serve.DynamicBatcher(StubEngine(bucket=4), max_batch=4, max_queue=4)
        try:
            with pytest.raises(serve.RejectedError, match="max_batch"):
                bat.submit(_item(0, n=5))
        finally:
            bat.close()

    def test_max_batch_cannot_exceed_engine_bucket(self):
        with pytest.raises(ValueError, match="largest"):
            serve.DynamicBatcher(StubEngine(bucket=4), max_batch=8)

    def test_coalesce_error_fails_the_batch_not_the_batcher(self):
        eng = StubEngine(bucket=4, delay=0.1)
        with serve.DynamicBatcher(eng, max_batch=2, max_wait_ms=200,
                                  max_queue=8) as bat:
            blocker = bat.submit(_item(0, n=2))  # holds the worker busy
            fa = bat.submit(np.zeros((1, 2), np.float32))
            fb = bat.submit(np.zeros((1, 3), np.float32))  # ragged pair
            blocker.result(timeout=WAIT_S)
            with pytest.raises(ValueError):
                fa.result(timeout=WAIT_S)
            with pytest.raises(ValueError):
                fb.result(timeout=WAIT_S)
            assert bat.counters.count("errors") == 1
            f = bat.submit(_item(3))
            assert float(f.result(timeout=WAIT_S)[0, 0]) == 6.0

    def test_cancelled_request_is_skipped_not_fatal(self):
        eng = StubEngine(bucket=2, delay=0.1)
        with serve.DynamicBatcher(eng, max_batch=2, max_wait_ms=200,
                                  max_queue=8) as bat:
            blocker = bat.submit(_item(0, n=2))
            f1 = bat.submit(_item(1))
            f2 = bat.submit(_item(2))
            assert f1.cancel()  # still queued behind the blocker
            blocker.result(timeout=WAIT_S)
            assert float(f2.result(timeout=WAIT_S)[0, 0]) == 4.0
        assert bat.drained

    def test_submit_rejects_cross_leaf_leading_axis_mismatch(self):
        bat = serve.DynamicBatcher(StubEngine(bucket=4), max_batch=4, max_queue=4)
        try:
            with pytest.raises(ValueError, match="disagree"):
                bat.submit({"a": _item(0, n=2), "b": _item(0, n=3)})
        finally:
            bat.close()

    def test_engine_error_fails_the_batch_not_the_batcher(self):
        class Exploding(StubEngine):
            def predict(self, b):
                raise RuntimeError("boom")

        with serve.DynamicBatcher(Exploding(bucket=4), max_batch=4, max_wait_ms=5,
                                  max_queue=8) as bat:
            f = bat.submit(_item(1))
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=WAIT_S)
            assert bat.counters.count("errors") == 1
            f2 = bat.submit(_item(2))
            with pytest.raises(RuntimeError, match="boom"):
                f2.result(timeout=WAIT_S)

    def test_close_drain_answers_everything(self):
        eng = StubEngine(bucket=2, delay=0.02)
        bat = serve.DynamicBatcher(eng, max_batch=2, max_wait_ms=500, max_queue=32)
        futs = [bat.submit(_item(i)) for i in range(10)]
        bat.close(drain=True)
        for i, f in enumerate(futs):
            assert float(f.result(timeout=1)[0, 0]) == 2.0 * i
        assert bat.drained

    def test_close_without_drain_fails_pending(self):
        eng = StubEngine(bucket=1, delay=0.2)
        bat = serve.DynamicBatcher(eng, max_batch=1, max_wait_ms=1, max_queue=32)
        futs = [bat.submit(_item(i)) for i in range(5)]
        time.sleep(0.05)  # let the first batch enter the engine
        bat.close(drain=False)
        outcomes = []
        for f in futs:
            try:
                f.result(timeout=5)
                outcomes.append("answered")
            except serve.RejectedError:
                outcomes.append("rejected")
        assert "rejected" in outcomes
        with pytest.raises(serve.RejectedError):
            bat.submit(_item(0))

    def test_preemption_guard_triggers_graceful_drain(self):
        eng = StubEngine(bucket=4, delay=0.02)
        with resilience.PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
            bat = serve.DynamicBatcher(eng, max_batch=4, max_wait_ms=200,
                                       max_queue=32, guard=g)
            futs = [bat.submit(_item(i)) for i in range(6)]
            os.kill(os.getpid(), signal.SIGUSR1)
            assert g.preempted
            for i, f in enumerate(futs):
                assert float(f.result(timeout=WAIT_S)[0, 0]) == 2.0 * i
            with pytest.raises(serve.RejectedError, match="draining"):
                bat.submit(_item(0))
            bat.close()
            assert bat.drained


# --------------------------------------------------------------- telemetry


def _serve_names(snap) -> dict:
    return {kind: sorted(k for k in snap[kind] if k.startswith("serve."))
            for kind in ("counters", "gauges", "histograms")}


class TestServeObservability:
    def test_latency_fill_queue_depth_and_spans(self):
        telemetry.set_enabled(True)
        tracer = tracing.install()
        eng = serve.InferenceEngine.from_trainer(_trained_dp(), buckets=(8,))
        eng.warm(_x(1))
        with serve.DynamicBatcher(eng, max_batch=8, max_wait_ms=20, max_queue=64) as bat:
            futs = [bat.submit(_x(1, seed=i)) for i in range(16)]
            for f in futs:
                f.result(timeout=60)
        snap = telemetry.validate_snapshot(telemetry.snapshot())
        assert snap["histograms"]["serve.latency_s"]["count"] == 16
        assert snap["histograms"]["serve.batch_fill_ratio"]["count"] >= 1
        assert snap["histograms"]["serve.infer_s"]["count"] >= 1
        assert snap["counters"]["serve.requests"] == 16
        assert snap["counters"]["serve.compiles"] == 1
        assert "serve.queue_depth" in snap["gauges"]
        names = {e["name"] for e in tracer.events}
        assert {"serve.batch", "serve.infer"} <= names
        batch_ev = next(e for e in tracer.events if e["name"] == "serve.batch")
        assert batch_ev["args"]["bucket"] == 8

    def test_counters_count_without_telemetry_gate(self):
        telemetry.set_enabled(False)
        with serve.DynamicBatcher(StubEngine(bucket=4), max_batch=4,
                                  max_wait_ms=20, max_queue=16) as bat:
            futs = [bat.submit(_item(i)) for i in range(4)]
            for f in futs:
                f.result(timeout=WAIT_S)
        assert bat.counters.count("requests") == 4
        assert bat.fill_ratio == 1.0
        assert len(telemetry.REGISTRY) == 0  # nothing leaked into export

    def test_serve_metric_names_equal_jax(self, jax_net):
        """The same request script (a labeled engine, a tenant batcher,
        16 single requests, one oversize rejection) through both packages
        produces the same ``serve.*`` counter, gauge and histogram names,
        and the same request counts."""
        from tpu_syncbn import serve as jserve
        from tpu_syncbn.obs import telemetry as jtel

        snaps = []
        for srv, tel, dp in ((serve, telemetry, _port_dp(jax_net[1])),
                             (jserve, jtel, jax_net[0])):
            tel.set_enabled(True)
            eng = srv.InferenceEngine.from_trainer(dp, buckets=(8,), model_label="m")
            eng.warm(_x(1))
            with srv.DynamicBatcher(eng, max_batch=8, max_wait_ms=20, max_queue=64,
                                    tenant="t", health_name="serve_names") as bat:
                for f in [bat.submit(_x(1, seed=i)) for i in range(16)]:
                    f.result(timeout=60)
                with pytest.raises(srv.RejectedError):
                    bat.submit(_x(9))
            snaps.append(tel.snapshot())
        ours, theirs = snaps
        assert _serve_names(ours) == _serve_names(theirs)
        for k in ("serve.requests", 'serve.requests{tenant="t"}', "serve.compiles",
                  'serve.compiles{model="m"}'):
            assert ours["counters"][k] == theirs["counters"][k], k
