"""Composed DP×FSDP in the port against the JAX package's
(tests/test_layout_parity.py, case for case but the serving engine's,
which waits for ROADMAP A.12): ``DataParallel(layout=SpecLayout.fsdp(
data=2, fsdp=2))`` — the batch sharded over both axes, the flat
parameter and optimizer shards over ``fsdp``, the gradients
reduce-scattered over ``fsdp`` then summed over ``data`` — is the same
training program as replicated DP and as the 1-D ``zero=True`` preset,
and the JAX trainer's on a 2×2 mesh of CPU devices. One gloo world of 4
holds every case:

* trajectories against replicated and against zero (SGD with momentum,
  losses rtol 1e-5, parameters and SyncBN running statistics atol 1e-5:
  the JAX test's ``trees_close``), against JAX's at the trainer
  tolerances (rtol 2e-4 / atol 1e-5, losses rtol 1e-5); AdamW at loss
  level (rtol 1e-4, as the JAX test);
* the sharded state's sizes; int8 converging; the per-replica EF
  residual and its round trip; a K-step chunk against stepwise; the guard
  skipping a poisoned step; a checkpoint round trip; another shard world
  rejected;
* ``GANTrainer(layout=SpecLayout({"data": 2, "fsdp": 2},
  param_shard_axis=None))`` against ``group=``'s world-4 training and
  against JAX's (the GAN tests' tolerances);
* ``load_jax_trainer_state`` from a JAX ``SpecLayout.fsdp`` state, with
  and without an int8 residual.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from test_torch_compression import spawn
from test_torch_gan_trainer import ITERS, LATENT, LR as GAN_LR, EPS as GAN_EPS, host_data
from tpu_syncbn_torch import models, nn, parallel
from tpu_syncbn_torch.models import gan
from tpu_syncbn_torch.parallel import collectives as C
from tpu_syncbn_torch.parallel.layout import SpecLayout

WORLD, BATCH = 4, 16
NET = dict(rtol=2e-4, atol=1e-5)


def make_batch(n=BATCH, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 4).astype(np.float32), rng.randn(n, 2).astype(np.float32)


class TinyNet(torch.nn.Module):
    """The JAX test's net with 2 outputs: 74 parameters, so the flat
    padding differs between shard worlds 2 (74) and 4 (76)."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 8)
        self.bn = nn.BatchNorm1d(8, device="cpu")
        self.out = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.out(torch.relu(self.bn(self.fc(x))))


def mse(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def fsdp():
    return SpecLayout.fsdp(data=2, fsdp=2, device="cpu")


def make_dp(init, opt="sgdm", **kw):
    m = nn.convert_sync_batchnorm(TinyNet())
    models.load_jax_params(m, init)
    o = {"sgdm": lambda: torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
         "adamw": lambda: torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-2)}[opt]
    return parallel.DataParallel(m, o(), mse, device="cpu", **kw)


def mine(batch, rank):
    n = BATCH // WORLD
    return tuple(torch.from_numpy(t[rank * n:(rank + 1) * n]) for t in batch)


def state_of(dp) -> dict:
    return {k: v.detach().numpy().copy() for k, v in dp.model.state_dict().items()
            if v.is_floating_point()}


# -- the JAX side -------------------------------------------------------------------


def jax_net():
    import jax
    from flax import nnx

    from tpu_syncbn import nn as tnn

    class JNet(nnx.Module):
        def __init__(self, rngs):
            self.fc = nnx.Linear(4, 8, rngs=rngs)
            self.bn = tnn.BatchNorm1d(8)
            self.out = nnx.Linear(8, 2, rngs=rngs)

        def __call__(self, x):
            return self.out(jax.nn.relu(self.bn(self.fc(x))))

    return tnn.convert_sync_batchnorm(JNet(nnx.Rngs(0)))


def jax_dp(**kw):
    import jax
    import optax

    from tpu_syncbn import parallel as jparallel

    def jmse(m, batch):
        x, y = batch
        return ((m(x) - y) ** 2).mean()

    return jparallel.DataParallel(
        jax_net(), optax.sgd(0.1, momentum=0.9), jmse, donate=False,
        layout=jparallel.SpecLayout.fsdp(data=2, fsdp=2, devices=jax.devices()[:WORLD]), **kw)


def jax_step(dp, batch):
    import jax.numpy as jnp

    return float(dp.train_step(tuple(jnp.asarray(t) for t in batch)).loss)


def jax_states(n_steps=2, seed=20, **kw):
    """A JAX fsdp trainer's checkpoint after ``n_steps`` and its next
    step's loss and state."""
    import jax

    from test_torch_resnet import flat_state
    from tpu_syncbn.utils import checkpoint as jckpt

    dp = jax_dp(**kw)
    for s in range(n_steps):
        jax_step(dp, make_batch(seed=seed + s))
    state = jax.device_get(jckpt._purify(dp.state_dict()))
    nxt = jax_step(dp, make_batch(seed=seed + n_steps))
    return state, nxt, flat_state(dp.sync_to_model())


# -- the world of 4 -------------------------------------------------------------------


def _world(rank, world, rdv, out_dir, inp):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world, rank=rank)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_compute(rank, inp))
    finally:
        C.clear_group_cache()
        tdist.destroy_process_group()


def _run(out, tag, dp, bs, rank):
    out[f"{tag}.losses"] = np.array([float(dp.train_step(mine(b, rank)).loss) for b in bs])
    for k, v in state_of(dp).items():
        out[f"{tag}.s.{k}"] = v


def _compute(rank, inp):
    init = inp["init"]
    bs = [make_batch(seed=s) for s in range(3)]
    out = {}
    for tag, kw in (("dp", {}), ("zero", {"zero": True}), ("fsdp", {"layout": fsdp()})):
        _run(out, tag, make_dp(init, **kw), bs, rank)
    for tag, kw in (("adamw.dp", {}), ("adamw.fsdp", {"layout": fsdp()})):
        _run(out, tag, make_dp(init, "adamw", **kw), [make_batch(seed=s) for s in range(4)], rank)

    dp = make_dp(init, opt="adamw", layout=fsdp())
    st = dp.optimizer.state
    dp.train_step(mine(bs[0], rank))
    shard = dp._shards["float32"]
    out["sharded"] = np.array([dp.zero, dp.world, dp._shard_world, shard.numel(),
                               st[shard]["exp_avg"].numel(), dp._flat.padded["float32"]])

    dp = make_dp(init, layout=fsdp(), compress="int8")
    out["int8.losses"] = np.array([float(dp.train_step(mine(make_batch(seed=s), rank)).loss)
                                   for s in range(10)])
    out["int8.residual"] = dp._residual["float32"].numpy().copy()
    state = dp.state_dict()
    dp2 = make_dp(init, layout=fsdp(), compress="int8")
    dp2.load_state_dict(state)
    b = mine(make_batch(seed=5), rank)
    out["int8.resume"] = np.array([float(dp2.train_step(b).loss), float(dp.train_step(b).loss)])

    a, s_ = make_dp(init, layout=fsdp()), make_dp(init, layout=fsdp())
    out["scan.losses"] = a.train_steps(mine(bs[0], rank), 4).loss.numpy()
    out["step.losses"] = np.array([float(s_.train_step(mine(bs[0], rank)).loss)
                                   for _ in range(4)])
    out["scan.maxdiff"] = np.array(max(float(np.abs(state_of(a)[k] - v).max())
                                       for k, v in state_of(s_).items()))

    g = make_dp(init, layout=fsdp(), divergence_guard="skip_step")
    g.train_step(mine(bs[0], rank))
    before = state_of(g)
    x, y = mine(bs[1], rank)
    if rank == 0:
        x = x.clone()
        x[0, 0] = float("nan")
    out["guard.nonfinite"] = np.array(float(g.train_step((x, y)).metrics["nonfinite"]))
    out["guard.same"] = np.array(all(np.array_equal(state_of(g)[k], v)
                                     for k, v in before.items()))
    out["guard.next"] = np.array(float(g.train_step(mine(bs[0], rank)).loss))

    ck = make_dp(init, layout=fsdp())
    tail_bs = [make_batch(seed=s) for s in range(4)]
    for b in tail_bs[:2]:
        ck.train_step(mine(b, rank))
    state = ck.state_dict()
    out["ckpt.ref"] = np.array([float(ck.train_step(mine(b, rank)).loss) for b in tail_bs[2:]])
    ck2 = make_dp(init, layout=fsdp())
    ck2.load_state_dict(state)
    out["ckpt.tail"] = np.array([float(ck2.train_step(mine(b, rank)).loss) for b in tail_bs[2:]])
    try:
        make_dp(init, zero=True).load_state_dict(state)
        out["ckpt.reject"] = np.array("")
    except ValueError as e:
        out["ckpt.reject"] = np.array(str(e))

    # a JAX fsdp checkpoint carried into the port's fsdp trainer
    for tag in ("jax", "jax_int8"):
        kw = {"compress": "int8"} if tag == "jax_int8" else {}
        dp = make_dp(init, layout=fsdp(), **kw)
        models.load_jax_trainer_state(dp, inp[f"{tag}.state"])
        if tag == "jax_int8":
            out[f"{tag}.residual"] = dp._residual["float32"].numpy().copy()
            out[f"{tag}.residual0"] = inp["jax_int8.res_port"][rank]
        out[f"{tag}.next"] = np.array(float(dp.train_step(mine(make_batch(seed=22), rank)).loss))
        if tag == "jax":
            for k, v in state_of(dp).items():
                out[f"{tag}.s.{k}"] = v

    # GANTrainer: a composed replicated layout against group= (the world)
    gdata = host_data(ITERS)
    for tag, kw in (("gan.layout", {"layout": SpecLayout(
            {"data": 2, "fsdp": 2}, param_shard_axis=None, device="cpu")}),
                    ("gan.group", {"group": tdist.group.WORLD})):
        G = nn.convert_sync_batchnorm(gan.DCGANGenerator(latent_dim=LATENT, width=16,
                                                         device="cpu"))
        D = nn.convert_sync_batchnorm(gan.DCGANDiscriminator(width=8, device="cpu"))
        models.load_jax_params(G, inp["gan.init"][0])
        models.load_jax_params(D, inp["gan.init"][1])
        tr = parallel.GANTrainer(
            G, D, torch.optim.Adam(G.parameters(), lr=GAN_LR, betas=(0.5, 0.999), eps=GAN_EPS),
            torch.optim.Adam(D.parameters(), lr=GAN_LR, betas=(0.5, 0.999), eps=GAN_EPS),
            device="cpu", **kw)
        n = gdata[0][0].shape[0] // WORLD
        outs = []
        for b in gdata:
            o = tr.train_step(*(torch.from_numpy(a[rank * n:(rank + 1) * n]) for a in b))
            outs.append([float(o.d_loss), float(o.g_loss)])
        out[f"{tag}.outs"] = np.array(outs)
        for net, m in (("g", G), ("d", D)):
            for k, v in list(m.named_parameters()) + list(m.named_buffers()):
                if v.is_floating_point():
                    out[f"{tag}.s.{net}.{k}"] = v.detach().numpy().copy()
    return out


def _jax_gan(data):
    """JAX's GANTrainer under the same composed replicated layout on 4
    CPU devices: initial weights and per-iteration (d_loss, g_loss)."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn.models import gan as jgan
    from tpu_syncbn.ops import batch_norm as jbn

    with jbn.pallas_mode("off"):
        G = jnn.convert_sync_batchnorm(jgan.DCGANGenerator(latent_dim=LATENT, width=16,
                                                           rngs=nnx.Rngs(0)))
        D = jnn.convert_sync_batchnorm(jgan.DCGANDiscriminator(width=8, rngs=nnx.Rngs(1)))
        init = (flat_state(G), flat_state(D))
        adam = optax.adam(GAN_LR, b1=0.5, b2=0.999, eps=GAN_EPS)
        lay = jparallel.SpecLayout({"data": 2, "fsdp": 2}, param_shard_axis=None,
                                   devices=jax.devices()[:WORLD])
        tr = jparallel.GANTrainer(G, D, adam, adam, layout=lay, donate=False, monitors=False)
        outs = []
        for b in data:
            o = tr.train_step(*(jax.device_put(jnp.asarray(a), tr.batch_sharding) for a in b))
            outs.append([float(o.d_loss), float(o.g_loss)])
        return init, np.asarray(outs)


_RES: dict = {}


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    if not _RES:
        from test_torch_resnet import flat_state

        init = flat_state(jax_net())
        jst, jnext, jafter = jax_states()
        ist, inext, _ = jax_states(compress="int8")
        # the JAX residual rows in the port's layout, for each rank
        from tpu_syncbn_torch.models import weights as W

        port = TinyNet()
        rows = ist["opt_state"][1]
        res_port = []
        for r in range(WORLD):
            by = W._by_port_name({k: np.asarray(v)[r] for k, v in rows.items()},
                                 ist["params"], port)
            res_port.append(np.concatenate([np.ascontiguousarray(by[n]).reshape(-1)
                                            for n, _ in port.named_parameters()]))
        gan_data = host_data(ITERS)
        gan_init, gan_outs = _jax_gan(gan_data)
        inp = {"init": init, "jax.state": jst, "jax_int8.state": ist,
               "jax_int8.res_port": np.stack(res_port), "gan.init": gan_init}
        ranks = spawn(WORLD, tmp_path_factory.mktemp("fsdp4"), inp, target=_world)
        _RES.update(ranks=ranks, init=init, jnext=jnext, jafter=jafter, inext=inext,
                    gan_outs=gan_outs)
    return _RES


def _state(r, tag):
    return {k[len(tag) + 3:]: v for k, v in r.items() if k.startswith(f"{tag}.s.")}


def _trees_close(a, b, atol=1e-5):
    assert set(a) == set(b) and a
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


def test_composed_fsdp_matches_replicated_trajectory_sgdm(res):
    for r in res["ranks"]:
        np.testing.assert_allclose(r["fsdp.losses"], r["dp.losses"], rtol=1e-5)
        # parameters and SyncBN running statistics: the composed batch
        # group is every replica, the 1-D group's scope
        _trees_close(_state(r, "fsdp"), _state(r, "dp"))


def test_composed_fsdp_matches_zero_trajectory_sgdm(res):
    for r in res["ranks"]:
        np.testing.assert_allclose(r["fsdp.losses"], r["zero.losses"], rtol=1e-5)
        _trees_close(_state(r, "fsdp"), _state(r, "zero"))


def test_composed_fsdp_matches_the_jax_fsdp_trainer(res):
    import jax

    from test_torch_resnet import flat_state

    dp = jax_dp()
    losses = [jax_step(dp, make_batch(seed=s)) for s in range(3)]
    want = flat_state(dp.sync_to_model())
    r = res["ranks"][0]
    np.testing.assert_allclose(r["fsdp.losses"], losses, rtol=1e-5)
    got = _state(r, "fsdp")
    for key, value in want.items():
        name, arr = models.weights._port_name(key, value)
        if name in got:
            np.testing.assert_allclose(got[name], arr, err_msg=key, **NET)
    assert jax.device_count() >= WORLD


def test_composed_fsdp_adamw_loss_level_parity(res):
    for r in res["ranks"]:
        np.testing.assert_allclose(r["adamw.fsdp.losses"], r["adamw.dp.losses"], rtol=1e-4)


def test_composed_state_is_actually_sharded(res):
    for r in res["ranks"]:
        z, world, shard_world, numel, moment, padded = (int(v) for v in r["sharded"])
        assert z == 1 and world == WORLD and shard_world == 2
        # each rank holds 1/F of the flat vector, not 1/world
        assert numel * 2 == padded == moment * 2 == 74


def test_composed_int8_compression_converges(res):
    for r in res["ranks"]:
        losses = r["int8.losses"]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_composed_ef_residual_keeps_per_replica_storage(res):
    ranks = res["ranks"]
    for r in ranks:
        assert r["int8.residual"].shape == (74,)
        resumed, cont = r["int8.resume"]
        np.testing.assert_allclose(resumed, cont, rtol=1e-6)
    # every replica's own (the two fsdp shards of one data row differ too)
    assert not np.array_equal(ranks[0]["int8.residual"], ranks[1]["int8.residual"])
    assert not np.array_equal(ranks[0]["int8.residual"], ranks[2]["int8.residual"])


def test_composed_fused_scan_matches_stepwise(res):
    for r in res["ranks"]:
        np.testing.assert_allclose(r["scan.losses"][-1], r["step.losses"][-1], rtol=1e-6)
        assert float(r["scan.maxdiff"]) <= 1e-6


def test_composed_divergence_guard_skips_poisoned_step(res):
    for r in res["ranks"]:
        assert float(r["guard.nonfinite"]) == 1.0 and bool(r["guard.same"])
        assert np.isfinite(r["guard.next"])


def test_composed_checkpoint_round_trip_resumes_exactly(res):
    for r in res["ranks"]:
        np.testing.assert_allclose(r["ckpt.tail"], r["ckpt.ref"], rtol=1e-6)


def test_composed_checkpoint_rejects_other_shard_world(res):
    for r in res["ranks"]:
        assert "world size" in str(r["ckpt.reject"])


def test_load_jax_fsdp_trainer_state(res):
    for r in res["ranks"]:
        np.testing.assert_allclose(r["jax.next"], res["jnext"], rtol=1e-5)
        got = _state(r, "jax")
        for key, value in res["jafter"].items():
            name, arr = models.weights._port_name(key, value)
            if name in got:
                np.testing.assert_allclose(got[name], arr, err_msg=key, **NET)
        # the int8 residual: each rank carries its own row, in the port's layout
        np.testing.assert_array_equal(r["jax_int8.residual"][:74], r["jax_int8.residual0"])
        # under int8 both trainers round the reported loss to bf16
        np.testing.assert_allclose(r["jax_int8.next"], res["inext"], rtol=2 ** -7)


def test_gan_trainer_with_a_composed_layout_equals_group_training(res):
    for r in res["ranks"]:
        np.testing.assert_allclose(r["gan.layout.outs"], r["gan.group.outs"], rtol=1e-5)
        lay, grp = _state(r, "gan.layout"), _state(r, "gan.group")
        assert set(lay) == set(grp)
        for k in grp:
            np.testing.assert_allclose(lay[k], grp[k], err_msg=k, **NET)
    np.testing.assert_allclose(res["ranks"][0]["gan.layout.outs"], res["gan_outs"], rtol=1e-5)
