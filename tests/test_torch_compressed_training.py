"""Compressed gradient all-reduce in the port's trainers, against the JAX
package's (tests/test_compressed_training.py, case for case but ZeRO's,
which waits for ROADMAP A.10):

* ``DataParallel(compress="bf16")`` and ``grad_compression="bf16"``
  against the JAX trainer at worlds 1 and 2 (gloo) from the same weights
  and batches: the wire is elementwise, so the trajectories match at the
  trainer tolerances;
* int8 with error feedback: the port fuses its gradients in
  ``named_parameters()`` order where JAX fuses its leaves in
  ``jax.tree_util`` order, so their chunks hold other elements; the
  trainer's reduced gradient and new residual are held against JAX's
  ``ef_compressed_pmean`` applied to the port's own fused payload, and the
  trajectories against fp32 within JAX's own 0.05;
* the residual's life: checkpoints, ``reset_compression_residual``,
  ``restore_last_good``, a guarded skip, the K-step chunk, ``set_compress``
  and ``load_jax_trainer_state``;
* ``GANTrainer(compress=)``; SyncBN's ``stats_compress`` (bf16 forward and
  gradients against JAX at world 2; int8's backward raising in both
  packages).

Tolerances: losses rtol 1e-5, parameters and buffers rtol 2e-4 / atol
1e-5 (the trainer tests'); the int8 reduction within 2 f32 roundings of
each chunk's magnitude (test_torch_compression.py says why).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from test_torch_compression import EPS32, jax_per_rank, spawn
from tpu_syncbn_torch import models, nn, parallel
from tpu_syncbn_torch.parallel import collectives as C

FEATURES, CLASSES, GLOBAL_BATCH = 8, 4, 16
NET = dict(rtol=2e-4, atol=1e-5)
LR = 0.05


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(FEATURES, 16)
        self.bn = nn.BatchNorm1d(16, device="cpu")
        self.fc2 = torch.nn.Linear(16, CLASSES)

    def forward(self, x):
        return self.fc2(torch.relu(self.bn(self.fc1(x))))


def ce(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y.long())


def host_batch(seed=0, nan=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(GLOBAL_BATCH, FEATURES).astype(np.float32)
    if nan:
        x[0, 0] = np.nan
    return x, rs.randint(0, CLASSES, GLOBAL_BATCH).astype(np.int32)


def rows(batch, rank=0, world=1):
    n = GLOBAL_BATCH // world
    return tuple(torch.from_numpy(t[rank * n:(rank + 1) * n]) for t in batch)


def make_dp(seed=0, init=None, stats_compress="none", **kw):
    torch.manual_seed(seed)
    model = nn.convert_sync_batchnorm(Net(), stats_compress=stats_compress)
    if init is not None:
        models.load_jax_params(model, init)
    return parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=LR), ce,
                                 device="cpu", **kw)


def residual(dp) -> np.ndarray:
    assert dp._ef, "trainer has no error-feedback state"
    return dp._residual.detach().clone().numpy()


def state(dp) -> dict:
    return {k: v.detach().numpy().copy() for k, v in dp.model.state_dict().items()}


# -- the JAX side -------------------------------------------------------------


def jax_net():
    import optax  # noqa: F401
    from flax import nnx

    from tpu_syncbn import nn as tnn

    class JNet(nnx.Module):
        def __init__(self, rngs):
            self.fc1 = nnx.Linear(FEATURES, 16, rngs=rngs)
            self.bn = tnn.BatchNorm1d(16)
            self.fc2 = nnx.Linear(16, CLASSES, rngs=rngs)

        def __call__(self, x):
            return self.fc2(nnx.relu(self.bn(self.fc1(x))))

    return tnn.convert_sync_batchnorm(JNet(nnx.Rngs(0)))


def jax_ce(m, batch):
    import optax

    x, y = batch
    return optax.softmax_cross_entropy_with_integer_labels(m(x), y).mean()


def jax_dp(world, **kw):
    import optax

    from test_torch_resnet import flat_state
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime

    model = jax_net()
    init = flat_state(model)
    dp = jparallel.DataParallel(model, optax.sgd(LR), jax_ce,
                                mesh=jruntime.data_parallel_mesh(world), donate=False, **kw)
    return init, dp


def jax_trajectory(world, batches, **kw):
    import jax.numpy as jnp

    from test_torch_resnet import flat_state

    init, dp = jax_dp(world, **kw)
    losses = [float(dp.train_step(tuple(map(jnp.asarray, b))).loss) for b in batches]
    return init, losses, flat_state(dp.sync_to_model())


def assert_state_matches(got: dict, jstate: dict, tol=NET):
    assert len(got) == len(jstate)
    for key, want in jstate.items():
        name, want = models.weights._port_name(key, want)
        np.testing.assert_allclose(got[name], want, err_msg=key, **tol)


BF16_KW = {"compress": {"compress": "bf16"}, "legacy": {"grad_compression": "bf16"}}
BATCHES = [host_batch(s) for s in range(3)]


def port_trajectory(init, batches, rank=0, world=1, **kw):
    dp = make_dp(init=init, **kw)
    losses = [float(dp.train_step(rows(b, rank, world)).loss) for b in batches]
    return losses, state(dp)


# -- world 2 over gloo ---------------------------------------------------------


def _world2_compute(rank, world, group, inp):
    out = {}
    for name, kw in BF16_KW.items():
        out[f"bf16.{name}.losses"], st = port_trajectory(inp["init"], BATCHES, rank, world, **kw)
        out.update({f"bf16.{name}.{k}": v for k, v in st.items()})
    out.update({f"ef.{k}": v for k, v in record_ef(inp["init"], rank, world).items()})
    out.update({f"stats.{k}": v for k, v in stats_bf16(inp, rank, world).items()})
    out["stats.int8.error"] = np.array(int8_stats_backward_error(inp, rank, world))
    return out


def _replica(rank, world, rdv, out_dir, inp):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                             rank=rank)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **_world2_compute(rank, world, tdist.group.WORLD, inp))
    finally:
        C.clear_group_cache()
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from test_torch_resnet import flat_state

    inp = dict(init=flat_state(jax_net()), **stats_inputs())
    return inp, spawn(2, tmp_path_factory.mktemp("world2"), inp, _replica)


# -- bf16 against the JAX trainer -------------------------------------------


@pytest.mark.parametrize("name", sorted(BF16_KW))
def test_bf16_world1_matches_jax_mesh1(name):
    init, jlosses, jstate = jax_trajectory(1, BATCHES, **BF16_KW[name])
    losses, st = port_trajectory(init, BATCHES, **BF16_KW[name])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert_state_matches(st, jstate)


@pytest.mark.parametrize("name", sorted(BF16_KW))
def test_bf16_world2_over_gloo_matches_jax_mesh2(world2, name):
    _, ranks = world2
    _, jlosses, jstate = jax_trajectory(2, BATCHES, **BF16_KW[name])
    for r in ranks:
        np.testing.assert_allclose(r[f"bf16.{name}.losses"], jlosses, rtol=1e-5)
        got = {k[len(f"bf16.{name}."):]: v for k, v in r.items()
               if k.startswith(f"bf16.{name}.") and not k.endswith("losses")}
        assert_state_matches(got, jstate)


@pytest.mark.parametrize("kw,lossy", [
    ({}, False), ({"compress": "int8"}, True), ({"compress": "bf16"}, True),
    ({"grad_compression": "bf16"}, False)], ids=["none", "int8", "bf16", "legacy"])
def test_lossy_modes_report_loss_in_bf16(kw, lossy):
    """Under a lossy mode the loss rides bf16 at world 1 too (the JAX
    trainer's bf16 pmean on a mesh of one); eval_step and the other modes
    report it exactly (this batch's f32 loss is not a bf16 value)."""
    batch = rows(host_batch())
    dp = make_dp(**kw)
    with torch.no_grad():
        exact = float(ce(dp.model, batch))
    assert float(torch.tensor(exact).to(torch.bfloat16)) != exact
    loss = float(dp.train_step(batch).loss)
    assert loss == (float(torch.tensor(exact).to(torch.bfloat16)) if lossy else exact)
    assert float(dp.eval_step(batch).loss) == float(ce(dp.model.eval(), batch))


# -- int8 with error feedback ------------------------------------------------


def record_ef(init, rank=0, world=1, steps=2) -> dict:
    """Two int8 EF steps; around the second one's reduction: the fused
    local gradients, the residual before and after, the reduced
    gradients."""
    dp = make_dp(init=init, compress="int8")
    seen = {}
    real = dp._reduce_grads_

    def spy(grads):
        seen["g"] = C._fuse_f32(grads).clone()
        seen["e"] = dp._residual.clone()
        real(grads)
        seen["mean"] = C._fuse_f32(grads).clone()
        seen["e_new"] = dp._residual.clone()

    dp._reduce_grads_ = spy
    for s in range(steps):
        dp.train_step(rows(host_batch(10 + s), rank, world))
    return {k: v.numpy() for k, v in seen.items()}


def _assert_ef_matches_jax(recs):
    """The trainer's reduction against JAX's ef_compressed_pmean on the
    port's fused payloads, one row a replica."""
    from test_torch_compression import world_grid
    from tpu_syncbn.parallel import collectives as J

    world = len(recs)
    g = np.stack([r["g"] for r in recs])
    e = np.stack([r["e"] for r in recs])
    mean, e_new = jax_per_rank(lambda a, b: J.ef_compressed_pmean(a, b, "data", mode="int8"),
                               world, g, e)
    scale, zp = world_grid(g + e, world)
    mag = scale * 127 + world * np.abs(zp)
    assert np.abs(e).max() > 0, "the second step starts from a residual"
    for r, rec in enumerate(recs):
        np.testing.assert_array_less(np.abs(rec["mean"] - mean[r]), 2 * EPS32 * mag / world
                                     + 1e-30)
        np.testing.assert_array_less(np.abs(rec["e_new"] - e_new[r]), 2 * EPS32 * mag + 1e-30)


def test_int8_ef_reduction_world1_is_jaxs_function_on_the_port_payload():
    from test_torch_resnet import flat_state

    _assert_ef_matches_jax([record_ef(flat_state(jax_net()))])


def test_int8_ef_reduction_world2_is_jaxs_function_on_the_port_payload(world2):
    _, ranks = world2
    _assert_ef_matches_jax([{k[3:]: v for k, v in r.items() if k.startswith("ef.")}
                            for r in ranks])


@pytest.mark.parametrize("kw", [
    {"compress": "bf16"},
    {"compress": "int8"},
    {"compress": "int8", "error_feedback": False},
    {"compress": "bf16", "error_feedback": True},
], ids=["bf16", "int8", "int8-noef", "bf16-ef"])
def test_compressed_training_tracks_fp32(kw):
    """A short compressed run stays close to the fp32 trajectory and the
    loss decreases (JAX's own bound, 0.05)."""
    ref, dp = make_dp(), make_dp(**kw)
    batch = rows(host_batch())
    ref_losses = [float(ref.train_step(batch).loss) for _ in range(8)]
    losses = [float(dp.train_step(batch).loss) for _ in range(8)]
    assert losses[-1] < losses[0], losses
    assert abs(losses[-1] - ref_losses[-1]) < 0.05, (losses, ref_losses)


def test_compress_validation_and_legacy_exclusion():
    with pytest.raises(ValueError, match="compression mode"):
        make_dp(compress="fp8")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_dp(compress="bf16", grad_compression="bf16")
    with pytest.raises(ValueError, match="error_feedback"):
        make_dp(error_feedback=True)  # no lossy mode: nothing to feed back
    with pytest.raises(ValueError, match="grad_compression must be"):
        make_dp(grad_compression="int8")
    # bf16 defaults EF off, int8 defaults EF on
    assert not make_dp(compress="bf16")._ef
    assert make_dp(compress="int8")._ef
    assert make_dp(compress="int8").compress == "int8"


# -- the residual's life -----------------------------------------------------


def test_residual_roundtrips_through_checkpoint(tmp_path):
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    dp = make_dp(compress="int8")
    batch = rows(host_batch())
    for _ in range(3):
        dp.train_step(batch)
    res = residual(dp)
    assert np.abs(res).max() > 0, "residual never captured"
    sd = dp.state_dict()
    assert set(sd["opt_state"]["residual"]) == {n for n, _ in dp.model.named_parameters()}
    ckpt.save_checkpoint(str(tmp_path), 3, sd)

    dp2 = make_dp(compress="int8", seed=1)
    loaded, step = ckpt.load_checkpoint(str(tmp_path), dp2.state_dict())
    assert step == 3
    dp2.load_state_dict(loaded)
    np.testing.assert_array_equal(residual(dp2), res)
    # and training continues identically from the restored state
    np.testing.assert_allclose(float(dp.train_step(batch).loss),
                               float(dp2.train_step(batch).loss), rtol=1e-6)
    np.testing.assert_array_equal(residual(dp2), residual(dp))
    with pytest.raises(ValueError, match="error_feedback"):
        make_dp().load_state_dict(sd)  # an fp32 trainer has no residual


def test_reset_compression_residual():
    dp = make_dp(compress="int8")
    buf = dp._residual
    dp.train_step(rows(host_batch()))
    assert np.abs(residual(dp)).max() > 0
    assert dp.reset_compression_residual()
    assert np.abs(residual(dp)).max() == 0 and dp._residual is buf  # in place
    # fp32 (and bf16 without EF) trainers: nothing to reset
    assert not make_dp().reset_compression_residual()
    assert not make_dp(compress="bf16").reset_compression_residual()


def test_restore_last_good_zeroes_residual(tmp_path):
    """ResilientLoop's divergence rollback does not replay the unwound
    trajectory's compression error; an ordinary resume keeps it."""
    from tpu_syncbn_torch.runtime.resilience import ResilientLoop

    dp = make_dp(compress="int8", divergence_guard="restore_last_good")
    batch = rows(host_batch())
    loop = ResilientLoop(dp, str(tmp_path), ckpt_every=100)
    dp.train_step(batch)
    loop.step = 1
    loop.save()  # a durable checkpoint WITH a nonzero residual
    dp.train_step(batch)
    assert np.abs(residual(dp)).max() > 0
    loop._restore_last_good()
    assert np.abs(residual(dp)).max() == 0, "restore_last_good must zero the residual"
    dp2 = make_dp(compress="int8", divergence_guard="restore_last_good")
    assert parallel.resume_latest(dp2, str(tmp_path)) == 1
    assert np.abs(residual(dp2)).max() > 0


def test_guard_skip_keeps_residual():
    """A non-finite step is an exact skip: parameters and the residual
    stay bit for bit."""
    dp = make_dp(compress="int8", divergence_guard="skip_step")
    dp.train_step(rows(host_batch()))
    before, res_before = state(dp), residual(dp)
    out = dp.train_step(rows(host_batch(nan=True)))
    assert float(out.metrics["nonfinite"]) == 1.0
    for k, v in state(dp).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    np.testing.assert_array_equal(residual(dp), res_before)


@pytest.mark.parametrize("poison", [None, 1], ids=["finite", "nan-mid-chunk"])
def test_train_steps_batches_parity_int8_ef(poison):
    """K = 3 steps as one program equal 3 train_step calls (on the CPU the
    same body runs K times): losses, parameters and the residual, which
    the chunk's guard select keeps across a NaN step."""
    kw = dict(compress="int8", divergence_guard="skip_step" if poison else None)
    batches = [host_batch(s, nan=s == poison) for s in range(3)]
    seq, fused = make_dp(**kw), make_dp(**kw)
    losses = [float(seq.train_step(rows(b)).loss) for b in batches]
    stacked = tuple(np.stack(t) for t in zip(*batches))
    out = fused.train_steps_batches(stacked)
    np.testing.assert_allclose(out.loss.numpy(), losses, rtol=1e-5)
    for k, v in state(fused).items():
        np.testing.assert_allclose(v, state(seq)[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(residual(fused), residual(seq), rtol=1e-5, atol=1e-7)


def test_set_compress_parks_and_recalls_caches():
    dp = make_dp(compress="int8")
    stacked = tuple(np.stack(t) for t in zip(*[host_batch(s) for s in range(2)]))
    dp.train_steps_batches(stacked)
    int8_cache = dp._train_steps_cache
    assert len(int8_cache) == 1 and np.abs(residual(dp)).max() > 0
    assert not dp.set_compress("int8")
    assert dp.set_compress("bf16")
    assert np.abs(residual(dp)).max() == 0, "a switch zeroes the residual"
    assert dp.program_caches == (dp._train_steps_cache, int8_cache)
    assert len(dp._train_steps_cache) == 0
    dp.train_steps_batches(stacked)
    bf16_cache = dp._train_steps_cache
    assert dp.set_compress("int8") and dp._train_steps_cache is int8_cache
    assert dp.program_caches == (int8_cache, bf16_cache)
    assert dp.set_compress("none") and dp.compress == "none"
    before = residual(dp)
    dp.train_step(rows(host_batch()))  # exact wire: the residual passes through
    np.testing.assert_array_equal(residual(dp), before)
    with pytest.raises(ValueError, match="compression mode"):
        dp.set_compress("fp4")
    with pytest.raises(ValueError, match="legacy"):
        make_dp(grad_compression="bf16").set_compress("int8")
    # a load empties every cache, parked ones too
    dp.load_state_dict(dp.state_dict())
    assert all(len(c) == 0 for c in dp.program_caches)


def test_load_jax_trainer_state_carries_the_residual():
    """The JAX residual (leading world axis) into the port: rank 1's row,
    each leaf by the port's name and layout."""
    import jax
    import jax.numpy as jnp

    from tpu_syncbn.utils import checkpoint as jckpt

    init, jdp = jax_dp(2, compress="int8")
    for s in range(2):
        jdp.train_step(tuple(map(jnp.asarray, host_batch(s))))
    jstate = jax.device_get(jckpt._purify(jdp.state_dict()))
    jres = models.weights._flatten(jstate["opt_state"][1])
    assert all(np.asarray(v).shape[0] == 2 for v in jres.values())
    dp = make_dp(init=init, compress="int8")
    models.load_jax_trainer_state(dp, jstate, rank=1)
    views = dp._residual_views()
    for key, value in jres.items():
        name, row = models.weights._port_name(key, np.asarray(value)[1])
        np.testing.assert_array_equal(views[name].numpy(), row, err_msg=key)
    assert np.abs(residual(dp)).max() > 0
    from test_torch_resnet import flat_state

    assert_state_matches(state(dp), flat_state(jdp.sync_to_model()),
                         tol=dict(rtol=0, atol=0))


# -- GAN and stats_compress wiring ----------------------------------------


class G(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, FEATURES)
        self.bn = nn.BatchNorm1d(FEATURES, device="cpu")

    def forward(self, z):
        return self.bn(self.fc(z))


class D(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(FEATURES, 1)
        self.bn = nn.BatchNorm1d(1, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def gan(compress):
    torch.manual_seed(0)
    g, d = nn.convert_sync_batchnorm(G()), nn.convert_sync_batchnorm(D())
    return parallel.GANTrainer(g, d, torch.optim.Adam(g.parameters(), 1e-4),
                               torch.optim.Adam(d.parameters(), 1e-4),
                               compress=compress, device="cpu")


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_gan_compress_modes(mode):
    """The wire of both networks' gradients: finite losses, and one D
    gradient reduced exactly as compressed_pmean of the local one (world
    1: the rounding alone), in one iteration and in a K-step program."""
    with pytest.raises(ValueError, match="compression mode"):
        gan("fp4")
    rs = np.random.RandomState(0)
    real = rs.randn(GLOBAL_BATCH, FEATURES).astype(np.float32)
    z = rs.randn(GLOBAL_BATCH, 4).astype(np.float32)
    tr = gan(mode)
    seen = []
    real_avg = tr._average_grads_

    def spy(model):
        local = [p.grad.clone() for p in model.parameters()]
        real_avg(model)
        seen.append((local, [p.grad.clone() for p in model.parameters()]))

    tr._average_grads_ = spy
    out = tr.train_step(real, z, z)
    assert np.isfinite(float(out.d_loss)) and np.isfinite(float(out.g_loss))
    local, got = seen[0]
    want = C.compressed_pmean(local, None, mode=mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(local, got))
    out = tr.train_steps(*(np.stack([t, t]) for t in (real, z, z)))
    assert np.isfinite(out.d_loss.numpy()).all()


def stats_inputs():
    rs = np.random.RandomState(4)
    return dict(  # small integers: every partial sum is bf16-representable
        sx=rs.randint(-3, 4, (GLOBAL_BATCH, 4)).astype(np.float32),
        sc=rs.randn(GLOBAL_BATCH, 4).astype(np.float32),
        sw=rs.uniform(0.5, 1.5, 4).astype(np.float32),
        sb=rs.randn(4).astype(np.float32))


def _bn(inp, mode):
    bn = nn.SyncBatchNorm(4, stats_compress=mode, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["sw"]))
        bn.bias.copy_(torch.from_numpy(inp["sb"]))
    return bn


def stats_bf16(inp, rank=0, world=1) -> dict:
    """y, dx, and the world-summed dγ, dβ of sum(y · coeff) through a
    SyncBatchNorm with bf16 statistics; its running statistics."""
    bn = _bn(inp, "bf16")
    n = GLOBAL_BATCH // world
    sl = slice(rank * n, (rank + 1) * n)
    x = torch.from_numpy(inp["sx"][sl]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(inp["sc"][sl])).sum().backward()
    group = tdist.group.WORLD if world > 1 else None
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": C.psum(bn.weight.grad, group).numpy(),
            "db": C.psum(bn.bias.grad, group).numpy(),
            "rm": bn.running_mean.numpy(), "rv": bn.running_var.numpy()}


def int8_stats_backward_error(inp, rank=0, world=1) -> str:
    bn = _bn(inp, "int8")
    n = GLOBAL_BATCH // world
    x = torch.from_numpy(inp["sx"][rank * n:(rank + 1) * n]).requires_grad_()
    try:
        bn(x).sum().backward()
    except NotImplementedError as e:
        return str(e)
    return ""


def jax_stats_bn(inp, world, mode, grad=True):
    """The JAX SyncBatchNorm(stats_compress=mode) under shard_map on a mesh
    of ``world``: y and running statistics, and with ``grad`` the
    gradients of the summed sum(y · coeff)."""
    import jax
    import jax.numpy as jnp
    from flax import nnx
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn import compat
    from tpu_syncbn import nn as jnn

    m = jnn.SyncBatchNorm(4, stats_compress=mode)
    m.weight[...] = jnp.asarray(inp["sw"])
    m.bias[...] = jnp.asarray(inp["sb"])
    graphdef, params, rest = nnx.split(m, nnx.Param, ...)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))

    def body(params, xs, cs):
        mm = compat.nnx_merge(graphdef, params, rest, copy=True)
        y = mm(xs)
        return (y, (y * cs).sum()[None], mm.running_mean[...][None],
                mm.running_var[...][None])

    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P(), P("data"), P("data")),
                                 out_specs=(P("data"),) * 4))
    x, c = jnp.asarray(inp["sx"]), jnp.asarray(inp["sc"])
    y, _, rm, rv = f(params, x, c)
    out = dict(y=np.asarray(y), rm=np.asarray(rm), rv=np.asarray(rv))
    if grad:
        gp, gx = jax.grad(lambda p, xx: f(p, xx, c)[1].sum(), argnums=(0, 1))(params, x)
        out.update(dx=np.asarray(gx), dw=np.asarray(gp["weight"][...]),
                   db=np.asarray(gp["bias"][...]))
    return out


F32 = dict(rtol=1e-5, atol=1e-5)


def _assert_stats_match(ranks, want):
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), want["y"], **F32)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]), want["dx"], **F32)
    for rank, r in enumerate(ranks):
        for k in ("dw", "db"):
            np.testing.assert_allclose(r[k], want[k], err_msg=k, **F32)
        for k in ("rm", "rv"):
            np.testing.assert_allclose(r[k], want[k][rank], err_msg=k, **F32)


def test_stats_compress_bf16_world1_matches_jax_mesh1():
    """At world 1 the statistics still round through bf16 (the JAX
    SyncBatchNorm on a mesh of one), and so does their cotangent."""
    _assert_stats_match([stats_bf16(stats_inputs())], jax_stats_bn(stats_inputs(), 1, "bf16"))


def test_stats_compress_bf16_world2_matches_jax_mesh2(world2):
    inp, ranks = world2
    got = [{k[6:]: v for k, v in r.items() if k.startswith("stats.") and "int8" not in k}
           for r in ranks]
    _assert_stats_match(got, jax_stats_bn(inp, 2, "bf16"))


def test_stats_compress_bf16_gradient_differs_from_exact():
    """The bf16 cotangent is not the exact one (on these inputs the
    forward is exact: every partial sum is representable)."""
    inp = stats_inputs()
    got, exact = stats_bf16(inp), jax_stats_bn(inp, 1, "none")
    np.testing.assert_allclose(got["y"], exact["y"], **F32)
    assert not np.allclose(got["dx"], exact["dx"], rtol=1e-6, atol=0)


def test_stats_compress_int8_backward_raises_in_both_packages(world2):
    inp, ranks = world2
    assert "no gradient" in int8_stats_backward_error(inp)
    for r in ranks:
        assert "no gradient" in str(r["stats.int8.error"])
    with pytest.raises(NotImplementedError, match="pmax"):
        jax_stats_bn(inp, 2, "int8")
    # the forward alone works in both and agrees (world 1 / a mesh of one)
    want = jax_stats_bn(inp, 1, "int8", grad=False)
    bn = _bn(inp, "int8")
    with torch.no_grad():
        y = bn(torch.from_numpy(inp["sx"]))
    np.testing.assert_allclose(y.numpy(), want["y"], **F32)
    np.testing.assert_allclose(bn.running_var.numpy(), want["rv"][0], **F32)


def test_stats_compress_opt_in():
    with pytest.raises(ValueError, match="plain BatchNorm"):
        nn.BatchNorm1d(FEATURES, stats_compress="bf16", device="cpu")
    with pytest.raises(ValueError, match="compression mode"):
        nn.convert_sync_batchnorm(Net(), stats_compress="fp8")
    with pytest.raises(ValueError, match="group_size"):
        bn = nn.SyncBatchNorm(4, group_size=1, stats_compress="bf16", device="cpu")
        bn(torch.zeros(2, 4))
    model = nn.convert_sync_batchnorm(Net(), stats_compress="bf16")
    assert model.bn.stats_compress == "bf16" and "stats_compress='bf16'" in repr(model.bn)
    dp = parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=LR), ce,
                               device="cpu")
    batch = rows(host_batch())
    losses = [float(dp.train_step(batch).loss) for _ in range(4)]
    assert losses[-1] < losses[0]
    # compressed stats stay replica-identical (summed), so the 'auto'
    # buffer broadcast skip still applies
    assert not dp._per_step_broadcast
    nn.convert_sync_batchnorm(model)  # re-scoped in place: exact statistics again
    assert model.bn.stats_compress == "none"
