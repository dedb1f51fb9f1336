"""The on-device step monitors of the port's trainers against the JAX
trainers' (``StepOutput.monitors``, ``GANStepOutput.monitors``), from the
same weights (``models.load_jax_params``) on the same numpy-seeded
batches:

* ``DataParallel`` for a small SyncBN net (Linear 8 → 8, BatchNorm1d) and
  a narrow ResNet-18 (width 8, 20 BN layers, 8×8 images), with
  ``monitors=True`` and ``"full"``, on every path: plain, ``accum_steps=2``,
  ``zero=True``, ``compress="int8"`` with error feedback, and a K = 2
  ``train_steps_batches`` chunk (monitors stacked to (K,)); at world 1
  against JAX's mesh of 1, and at world 2 over gloo against JAX's mesh of
  2; on the small net at world 1 also ``remat``, ``compress="bf16"`` and
  int8 without error feedback;
* ``GANTrainer`` (DCGAN, narrow) against JAX's, at world 1 (both modes and
  a K = 2 ``train_steps`` chunk) and at world 2;
* JAX's ``TestOnDeviceMonitors`` and ``TestStateHealthUnit`` cases
  (tests/test_obs.py) against the port.

The key sets must be equal — per-layer keys included: the port names its
submodules like the JAX models, and ``_layer_key`` turns a buffer's
dotted name and a JAX key path into the same suffix. Counts
(``grad_nonfinite``, ``state_nonfinite``, ``bn_layers``,
``bn_skew_layers``) match exactly, every other value to rtol 2e-4 /
atol 1e-5, the trainers' tolerances; the replica dispersions also get
their formula's cancellation (``disp_bound``). The int8 paths run one step: the
port fuses the gradients in ``named_parameters()`` order and JAX in tree
order, so once the payload spans more than one 256-element chunk the two
grids differ (tests/test_torch_compressed_training.py); the small net's
88 gradients are one chunk, so there every monitor is compared, while on
the ResNet the wire-dependent ones (``grad_norm``, ``clip_fraction``,
``overflow_headroom``, ``ef_residual_ratio``) are held to their ranges.
The spawned replicas import this module, so JAX is imported inside the
functions that use it.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch import models, nn, parallel

NET = dict(rtol=2e-4, atol=1e-5)
BATCH, WORLD, JOIN_TIMEOUT_S = 16, 2, 240
COUNTS = {"grad_nonfinite", "state_nonfinite", "bn_layers", "bn_skew_layers",
          "d_grad_nonfinite", "g_grad_nonfinite"}
#: path -> (trainer kwargs, steps, K of one train_steps_batches chunk)
PATHS = {
    "plain": ({}, 2, None),
    "accum2": ({"accum_steps": 2}, 2, None),
    "zero": ({"zero": True}, 2, None),
    "int8_ef": ({"compress": "int8", "error_feedback": True}, 1, None),
    "chunk2": ({}, 0, 2),
}
#: further paths, held on the small net at world 1
PATHS.update({
    "remat": ({"remat": True}, 2, None),
    "bf16": ({"compress": "bf16"}, 1, None),
    "int8_no_ef": ({"compress": "int8", "error_feedback": False}, 1, None),
})
MAIN_PATHS = ("plain", "accum2", "zero", "int8_ef", "chunk2")
WIRE = {"grad_norm", "clip_fraction", "overflow_headroom", "ef_residual_ratio"}
DISP_ROUNDINGS = 8  # f32 roundings a dispersion's cancellation amplifies (disp_bound)


# -- the nets and data ----------------------------------------------------------


class SmallNet(torch.nn.Module):
    """JAX's tests/test_obs.py ``_Net``: Linear(8, 8) then BatchNorm1d(8)."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(8, 8)
        self.bn = nn.BatchNorm1d(8, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def _sq_loss(m, b):
    return (m(b) ** 2).mean()


def _ce(m, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(m(x), y.long())


def batches(net, n, seed=11):
    rs = np.random.RandomState(seed)
    if net == "small":
        return [rs.randn(BATCH, 8).astype(np.float32) for _ in range(n)]
    return [(rs.randn(BATCH, 8, 8, 3).astype(np.float32),
             rs.randint(0, 10, BATCH).astype(np.int32)) for _ in range(n)]


def _rows(batch, rank, world):
    n = BATCH // world
    if isinstance(batch, tuple):
        return tuple(a[rank * n:(rank + 1) * n] for a in batch)
    return batch[rank * n:(rank + 1) * n]


def _stack(bs):
    if isinstance(bs[0], tuple):
        return tuple(np.stack(a) for a in zip(*bs))
    return np.stack(bs)


def _host(monitors) -> dict:
    return {k: np.asarray(v, dtype=np.float64) for k, v in monitors.items()}


# -- the two sides --------------------------------------------------------------


def jax_monitors(net, path, mode, world, data):
    """(initial flat state, per-call monitors as numpy) of the JAX trainer."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import models as jmodels
    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime

    if net == "small":
        class JNet(nnx.Module):
            def __init__(self, rngs):
                self.fc = nnx.Linear(8, 8, rngs=rngs)
                self.bn = jnn.BatchNorm1d(8)

            def __call__(self, x):
                return self.bn(self.fc(x))

        model = jnn.convert_sync_batchnorm(JNet(nnx.Rngs(0)))

        def loss_fn(m, b):
            return (m(b) ** 2).mean()
        opt = optax.sgd(0.1)
    else:
        model = jnn.convert_sync_batchnorm(jmodels.resnet18(
            num_classes=10, small_input=True, width=8, rngs=nnx.Rngs(0)))

        def loss_fn(m, b):
            x, y = b
            return optax.softmax_cross_entropy_with_integer_labels(m(x), y).mean()
        opt = optax.sgd(0.1, momentum=0.9)
    init = flat_state(model)
    kw, steps, k = PATHS[path]
    dp = jparallel.DataParallel(model, opt, loss_fn, mesh=jruntime.data_parallel_mesh(world),
                                donate=False, monitors=mode, **kw)
    put = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    if k is None:
        outs = [dp.train_step(put(b)).monitors for b in data[:steps]]
    else:
        outs = [dp.train_steps_batches(put(_stack(data[:k]))).monitors]
    return init, [_host(jax.device_get(m)) for m in outs]


def port_monitors(net, path, mode, init, data, rank=0, world=1):
    """Per-call monitors (numpy) of the port's trainer on this rank's rows."""
    if net == "small":
        model, loss = nn.convert_sync_batchnorm(SmallNet()), _sq_loss
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
    else:
        model, loss = nn.convert_sync_batchnorm(models.resnet18(
            num_classes=10, small_input=True, width=8, device="cpu")), _ce
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    models.load_jax_params(model, init)
    kw, steps, k = PATHS[path]
    dp = parallel.DataParallel(model, opt, loss, device="cpu", monitors=mode, **kw)
    if k is None:
        outs = [dp.train_step(_rows(b, rank, world)).monitors for b in data[:steps]]
    else:
        chunk = _stack([_rows(b, rank, world) for b in data[:k]])
        outs = [dp.train_steps_batches(chunk).monitors]
    for m in outs:
        assert all(isinstance(v, torch.Tensor) for v in m.values())
    return [_host(m) for m in outs]


def disp_bound(want):
    """The tolerance of a dispersion sqrt(E[x²] − mean²)/|mean|: the
    trainers' rtol/atol, plus the formula's cancellation. E[x²] − mean²
    cancels to (disp·mean)², so a few f32 roundings of x² (and the last
    bits in which the two sides' local norms differ; XLA also contracts
    the product into an FMA, the port does not) move the dispersion by
    about DISP_ROUNDINGS · 2^-24 / disp — up to 2^-11.5 for a lone
    replica, whose true dispersion is 0."""
    w = np.abs(np.asarray(want))
    return NET["atol"] + NET["rtol"] * w + DISP_ROUNDINGS * 2 ** -24 / np.maximum(w, 2 ** -12)


def assert_monitors_match(got: dict, want: dict, skip=()):
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))
    for key, w in want.items():
        if key in skip:
            continue
        if key in COUNTS:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        elif key.endswith("replica_grad_norm_disp"):
            assert np.all(np.abs(got[key] - w) <= disp_bound(w)), (key, got[key], w)
        else:
            np.testing.assert_allclose(got[key], w, err_msg=key, **NET)


def check_path(net, path, got, want):
    """Every call's monitors equal JAX's; the multi-chunk int8 wire's
    monitors in their ranges instead (module docstring)."""
    skip = WIRE if (net == "resnet" and path == "int8_ef") else ()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_monitors_match(g, w, skip)
        if skip:
            assert 0.0 <= float(g["clip_fraction"]) <= 1.0
            assert 0.0 <= float(g["overflow_headroom"]) <= 1.0
            assert 0.0 < float(g["ef_residual_ratio"]) < 1.0
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-2)
    if PATHS[path][2] is not None:
        assert all(v.shape == (PATHS[path][2],) for v in got[0].values())


# -- world 1 --------------------------------------------------------------------

CASES = ([("small", p, m) for p in PATHS for m in (True, "full")]
         + [("resnet", p, "full") for p in MAIN_PATHS] + [("resnet", "plain", True)])


@pytest.mark.parametrize("net,path,mode", CASES)
def test_monitors_match_jax_at_world1(net, path, mode):
    data = batches(net, 2)
    init, want = jax_monitors(net, path, mode, 1, data)
    got = port_monitors(net, path, mode, init, data)
    check_path(net, path, got, want)
    keys = set(got[0])
    assert {"bn_mean_skew", "bn_var_skew", "bn_skew_layers", "replica_grad_norm",
            "replica_grad_norm_disp"} <= keys
    assert any(k.startswith("bn_var_min.") for k in keys) == (mode == "full")
    if path.startswith("int8"):
        assert {"clip_fraction", "overflow_headroom"} <= keys
        assert ("ef_residual_ratio" in keys) == (path == "int8_ef")


# -- world 2 over gloo ----------------------------------------------------------


def _replica(rank, rdv, out_dir, net, cases, init, data):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    try:
        out = {}
        for path, mode in cases:
            for i, m in enumerate(port_monitors(net, path, mode, init[(path, mode)],
                                                data, rank, WORLD)):
                out.update({f"{path}|{mode}|{i}|{k}": v for k, v in m.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tdist.destroy_process_group()


def spawn_world2(target, d, *args):
    """Run ``target(rank, rdv, d, *args)`` in two spawned gloo processes
    under a deadline; returns each rank's npz as a dict."""
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(d / "rdv"), str(d)) + args)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    assert not alive, f"replicas still running after {JOIN_TIMEOUT_S}s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _unpack(flat: dict, path, mode) -> list:
    out: dict = {}
    for key, v in flat.items():
        p, m, i, k = key.split("|", 3)
        if (p, m) == (path, str(mode)):
            out.setdefault(int(i), {})[k] = v
    return [out[i] for i in sorted(out)]


@pytest.mark.parametrize("net", ["small", "resnet"])
def test_monitors_match_jax_at_world2_over_gloo(tmp_path, net):
    """Every path at world 2 (``"full"``; ``True`` on the plain path):
    the replica monitors from ONE all-reduce, the sharded gradient norm
    under ``zero``, the skew of each replica's moments against the synced
    ones; both ranks return the same monitors."""
    cases = [(p, "full") for p in MAIN_PATHS] + [("plain", True)]
    data = batches(net, 2, seed=23)
    init, want = {}, {}
    for path, mode in cases:
        init[(path, mode)], want[(path, mode)] = jax_monitors(net, path, mode, WORLD, data)
    ranks = spawn_world2(_replica, tmp_path, net, cases, init, data)
    for path, mode in cases:
        got = [_unpack(r, path, mode) for r in ranks]
        check_path(net, path, got[0], want[(path, mode)])
        for a, b in zip(got[0], got[1]):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path} {k}")
        skew = got[0][0]["bn_mean_skew"]
        assert np.all(skew > 0)  # two replicas' moments differ from the synced


# -- GANTrainer -----------------------------------------------------------------


def jax_gan_monitors(mode, world, data, k=None):
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from test_torch_gan_trainer import ARCHS, EPS, LATENT, LR
    from test_torch_resnet import flat_state
    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime
    from tpu_syncbn.models import gan as jgan

    G = jgan.DCGANGenerator(latent_dim=LATENT, width=16, rngs=nnx.Rngs(0))
    D = jgan.DCGANDiscriminator(width=8, rngs=nnx.Rngs(1))
    jnn.convert_sync_batchnorm(G)
    jnn.convert_sync_batchnorm(D)
    init = (flat_state(G), flat_state(D))
    adam = optax.adam(LR, b1=0.5, b2=0.999, eps=EPS)
    tr = jparallel.GANTrainer(G, D, adam, adam, loss=ARCHS["dcgan"],
                              mesh=jruntime.data_parallel_mesh(world), donate=False,
                              monitors=mode)
    if k is None:
        outs = [tr.train_step(*(jax.device_put(jnp.asarray(a), tr.batch_sharding)
                                for a in batch)).monitors for batch in data]
    else:
        outs = [tr.train_steps(*(jnp.asarray(np.stack(a)) for a in zip(*data[:k]))).monitors]
    return init, [_host(jax.device_get(m)) for m in outs]


def port_gan_monitors(mode, init, data, rank=0, world=1, k=None):
    from test_torch_gan_trainer import port_trainer

    tr = port_trainer("dcgan", init)
    tr.monitors = mode
    n = len(data[0][0]) // world
    rows = [tuple(a[rank * n:(rank + 1) * n] for a in b) for b in data]
    if k is None:
        outs = [tr.train_step(*b).monitors for b in rows]
    else:
        outs = [tr.train_steps(*(np.stack(a) for a in zip(*rows[:k]))).monitors]
    return [_host(m) for m in outs]


def gan_data():
    from test_torch_gan_trainer import host_data

    return host_data(n_iters=2, seed=4)


@pytest.mark.parametrize("mode,k", [(True, None), ("full", None), (True, 2)])
def test_gan_monitors_match_jax_at_world1(mode, k):
    data = gan_data()
    init, want = jax_gan_monitors(mode, 1, data, k)
    got = port_gan_monitors(mode, init, data, k=k)
    for g, w in zip(got, want):
        assert_monitors_match(g, w)
        assert {"d_grad_norm", "g_grad_norm", "d_replica_grad_norm_disp",
                "g_replica_grad_norm_disp", "bn_mean_skew", "bn_layers"} <= set(g)
    if mode == "full":
        assert any(k_.startswith("bn_var_min.0.") for k_ in got[0])
        assert any(k_.startswith("bn_var_min.1.") for k_ in got[0])


def _gan_replica(rank, rdv, out_dir, init, data):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    try:
        out = {}
        for i, m in enumerate(port_gan_monitors("full", init, data, rank, WORLD)):
            out.update({f"{i}|{k}": v for k, v in m.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tdist.destroy_process_group()


def test_gan_monitors_match_jax_at_world2_over_gloo(tmp_path):
    data = gan_data()
    init, want = jax_gan_monitors("full", WORLD, data)
    for r in spawn_world2(_gan_replica, tmp_path, init, data):
        got: dict = {}
        for key, v in r.items():
            i, k = key.split("|", 1)
            got.setdefault(int(i), {})[k] = v
        for i, w in enumerate(want):
            assert_monitors_match(got[i], w)


# -- JAX's TestOnDeviceMonitors and TestStateHealthUnit (tests/test_obs.py) ------


def _dp(**kw):
    torch.manual_seed(0)
    model = nn.convert_sync_batchnorm(SmallNet())
    return parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                 _sq_loss, device="cpu", **kw)


class TestOnDeviceMonitors:
    def test_monitor_keys_and_values(self):
        out = _dp().train_step(torch.ones(16, 8))
        mon = {k: float(v) for k, v in out.monitors.items()}
        assert {"grad_norm", "grad_nonfinite", "state_nonfinite",
                "bn_mean_max_abs", "bn_var_max", "bn_var_min",
                "bn_layers"} <= set(mon)
        assert mon["grad_norm"] >= 0 and np.isfinite(mon["grad_norm"])
        assert mon["grad_nonfinite"] == 0
        assert mon["state_nonfinite"] == 0
        assert mon["bn_layers"] == 1
        assert mon["bn_var_max"] >= mon["bn_var_min"] > 0

    def test_full_mode_emits_per_layer_keys(self):
        out = _dp(monitors="full").train_step(torch.ones(16, 8))
        assert any(k.startswith("bn_var_min.") for k in out.monitors)

    def test_monitors_off_is_empty(self):
        assert _dp(monitors=False).train_step(torch.ones(16, 8)).monitors == {}
        out = _dp(monitors=False).train_steps_batches(torch.ones(2, 16, 8))
        assert out.monitors == {}

    def test_zero_mode_grad_norm_matches_replicated(self):
        x = torch.linspace(-1, 1, 16 * 8).reshape(16, 8)
        plain = _dp().train_step(x)
        zero = _dp(zero=True).train_step(x)
        np.testing.assert_allclose(float(zero.monitors["grad_norm"]),
                                   float(plain.monitors["grad_norm"]), rtol=1e-4)

    @pytest.mark.parametrize("policy", ["skip_step", "halve_lr", "restore_last_good"])
    def test_nonfinite_batch_is_counted(self, policy):
        dp = _dp(divergence_guard=policy)
        out = dp.train_step(torch.full((16, 8), float("nan")))
        assert float(out.monitors["grad_nonfinite"]) > 0
        assert float(out.metrics["nonfinite"]) == 1.0
        chunk = dp.train_steps_batches(torch.stack([torch.ones(16, 8),
                                                    torch.full((16, 8), float("nan"))]))
        assert chunk.monitors["grad_nonfinite"].tolist()[0] == 0
        assert chunk.monitors["grad_nonfinite"].tolist()[1] > 0
        assert chunk.metrics["nonfinite"].tolist() == [0.0, 1.0]

    def test_invalid_monitors_value_rejected(self):
        with pytest.raises(ValueError, match="monitors"):
            _dp(monitors="everything")

    def test_gan_trainer_rejects_bad_monitors_value(self):
        with pytest.raises(ValueError, match="monitors"):
            parallel.GANTrainer(SmallNet(), SmallNet(), torch.optim.SGD([torch.zeros(1)], 0.1),
                                torch.optim.SGD([torch.zeros(1)], 0.1),
                                monitors="everything", device="cpu")


class TestStateHealthUnit:
    def test_classifies_running_stats_by_path(self):
        from tpu_syncbn_torch.obs import stepstats

        state = [("bn.running_mean", torch.tensor([0.5, -2.0])),
                 ("bn.running_var", torch.tensor([0.1, 4.0])),
                 ("bn.num_batches_tracked", torch.tensor(3)),
                 ("other", torch.tensor([float("inf")]))]
        h = {k: float(v) for k, v in stepstats.state_health(state).items()}
        assert h["bn_mean_max_abs"] == 2.0
        assert h["bn_var_max"] == 4.0 and h["bn_var_min"] == pytest.approx(0.1)
        assert h["bn_layers"] == 1
        assert h["state_nonfinite"] == 1  # the inf in "other"

    def test_no_bn_state_reports_vacuous_defaults(self):
        from tpu_syncbn_torch.obs import stepstats

        h = {k: float(v) for k, v in stepstats.state_health([("w", torch.ones(3))]).items()}
        assert h["bn_layers"] == 0
        assert h["bn_var_max"] == 0 and h["bn_mean_max_abs"] == 0

    def test_matches_the_jax_function_per_layer(self):
        """The same buffers through both ``state_health(per_layer=True)``:
        the same keys (the JAX key path and the dotted name give one
        suffix) and values."""
        from tpu_syncbn.obs import stepstats as jstepstats
        from tpu_syncbn_torch.obs import stepstats

        rs = np.random.RandomState(2)
        tree = {"layers": [{"bn": {"running_mean": rs.randn(4).astype(np.float32),
                                   "running_var": rs.rand(4).astype(np.float32)}}
                           for _ in range(3)]}
        flat = [(f"layers.{i}.bn.{k}", torch.from_numpy(v))
                for i, layer in enumerate(tree["layers"]) for k, v in layer["bn"].items()]
        want = {k: float(v) for k, v in jstepstats.state_health(tree, per_layer=True).items()}
        got = {k: float(v) for k, v in stepstats.state_health(flat, per_layer=True).items()}
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-6), k
