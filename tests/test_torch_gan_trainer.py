"""The port's ``GANTrainer`` against ``tpu_syncbn.parallel.GANTrainer``:
three iterations (one D update and one G update each) from the same
weights on the same numpy batches and latents, for bce with the DCGAN
discriminator and hinge with the SNGAN one, at narrow widths (latent 8, G
width 16, D width 8, batch 8 at 32×32), with the example's
``Adam(2e-4, b1=0.5)`` but ``eps=1e-3``: a conv bias that feeds a
training-mode BN layer (the deconvs' in G, conv2's and conv3's in D) has
a gradient that is zero in exact arithmetic and ~1e-9 of rounding in
f32, and Adam's default eps of 1e-8 turns that rounding into updates of
up to ±lr whose sign neither side computes right; an eps of 1e-3 keeps
them at ~1e-10 and leaves every other update Adam's (the moments, the
bias correction and the count all still act):

* world 1 against JAX's mesh of 1, its Pallas BN forced on (interpret
  mode on the CPU);
* world 1 with the whole batch against JAX's mesh of 8: full-world SyncBN
  over 8 shards equals one replica with the whole batch;
* world 2 over gloo against JAX's mesh of 2 (each rank its half of the
  batch and of both latent batches);
* the ordering of the statistics: ``num_batches_tracked`` +2 a
  iteration in G's BN layers and +3 in D's;
* ``state_dict`` / ``load_state_dict`` round trip;
* ``load_jax_gan_trainer_state``: the JAX trainer's state after three
  iterations carried into a fresh port trainer, whose fourth iteration
  matches JAX's fourth (Adam's moments and count included).

Tolerances: losses and the D(real) / D(fake) metrics rtol 1e-5;
parameters and buffers rtol 2e-4 / atol 1e-5 (f32 sums in another
order), as tests/test_torch_trainer.py. The spawned replicas import this
module, so JAX is imported inside the functions that use it.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch import models, nn, parallel
from tpu_syncbn_torch.models import gan

ITERS, BATCH, LATENT, LR, EPS = 3, 8, 8, 2e-4, 1e-3
NET = dict(rtol=2e-4, atol=1e-5)
WORLD2 = 2
JOIN_TIMEOUT_S = 120
ARCHS = {"dcgan": "bce", "sngan": "hinge"}


def host_data(n_iters=ITERS + 1, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32),
             rs.randn(BATCH, LATENT).astype(np.float32),
             rs.randn(BATCH, LATENT).astype(np.float32)) for _ in range(n_iters)]


def jax_run(arch, mesh_n, pallas, data, capture_after=None):
    """(initial G and D states, per-iteration (d_loss, g_loss, d_real,
    d_fake), final G and D states, the trainer's state_dict after
    ``capture_after`` iterations)."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime
    from tpu_syncbn.models import gan as jgan
    from tpu_syncbn.ops import batch_norm as jbn
    from tpu_syncbn.utils import checkpoint as jckpt

    with jbn.pallas_mode(pallas):
        G = jgan.DCGANGenerator(latent_dim=LATENT, width=16, rngs=nnx.Rngs(0))
        Dcls = jgan.DCGANDiscriminator if arch == "dcgan" else jgan.SNGANDiscriminator
        D = Dcls(width=8, rngs=nnx.Rngs(1))
        jnn.convert_sync_batchnorm(G)
        jnn.convert_sync_batchnorm(D)
        init = (flat_state(G), flat_state(D))
        adam = optax.adam(LR, b1=0.5, b2=0.999, eps=EPS)
        tr = jparallel.GANTrainer(G, D, adam, adam, loss=ARCHS[arch],
                                  mesh=jruntime.data_parallel_mesh(mesh_n),
                                  donate=False, monitors=False)
        outs, captured = [], None
        for i, batch in enumerate(data):
            o = tr.train_step(*(jax.device_put(jnp.asarray(a), tr.batch_sharding)
                                for a in batch))
            outs.append([float(o.d_loss), float(o.g_loss),
                         float(o.metrics["d_real"]), float(o.metrics["d_fake"])])
            if capture_after == i + 1:
                captured = jax.device_get(jckpt._purify(tr.state_dict()))
        G2, D2 = tr.sync_to_models()
        return init, np.asarray(outs), (flat_state(G2), flat_state(D2)), captured


def port_trainer(arch, init=None):
    G = nn.convert_sync_batchnorm(gan.DCGANGenerator(
        latent_dim=LATENT, width=16, device="cpu"))
    Dcls = gan.DCGANDiscriminator if arch == "dcgan" else gan.SNGANDiscriminator
    D = nn.convert_sync_batchnorm(Dcls(width=8, device="cpu"))
    if init is not None:
        models.load_jax_params(G, init[0])
        models.load_jax_params(D, init[1])
    return parallel.GANTrainer(
        G, D, torch.optim.Adam(G.parameters(), lr=LR, betas=(0.5, 0.999), eps=EPS),
        torch.optim.Adam(D.parameters(), lr=LR, betas=(0.5, 0.999), eps=EPS),
        loss=ARCHS[arch], device="cpu")


def port_run(tr, data, rank=0, world=1):
    n = BATCH // world
    outs = []
    for batch in data:
        o = tr.train_step(*(a[rank * n:(rank + 1) * n] for a in batch))
        outs.append([float(o.d_loss), float(o.g_loss),
                     float(o.metrics["d_real"]), float(o.metrics["d_fake"])])
    return np.asarray(outs)


def port_state(tr) -> dict:
    """``{"g.<name>": array, "d.<name>": array}`` of every parameter and
    buffer."""
    out = {}
    for net, m in (("g", tr.generator), ("d", tr.discriminator)):
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            out[f"{net}.{name}"] = t.detach().numpy().copy()
    return out


def assert_matches_jax(state: dict, jstates, tr):
    """Every JAX parameter and buffer against the port's ``state``."""
    from tpu_syncbn_torch.models.weights import _port_name

    n = 0
    for net, model, jstate in (("g", tr.generator, jstates[0]),
                               ("d", tr.discriminator, jstates[1])):
        for key, want in jstate.items():
            name, arr = _port_name(key, want, model)
            np.testing.assert_allclose(state[f"{net}.{name}"], arr,
                                       err_msg=f"{net}.{key}", **NET)
            n += 1
    assert n == len(state)


@pytest.mark.parametrize("case", ["mesh1", "mesh8"])
@pytest.mark.parametrize("arch", ["dcgan", "sngan"])
def test_iterations_match_jax_gan_trainer(arch, case):
    data = host_data()
    mesh_n, pallas = (1, "on") if case == "mesh1" else (8, "off")
    capture = ITERS if case == "mesh1" else None
    init, jouts, jfinal, captured = jax_run(arch, mesh_n, pallas, data[:ITERS + 1]
                                            if capture else data[:ITERS], capture)
    tr = port_trainer(arch, init)
    outs = port_run(tr, data[:ITERS])
    np.testing.assert_allclose(outs, jouts[:ITERS], rtol=1e-5)
    assert len(set(np.round(outs[:, 0], 5))) == ITERS  # the nets moved
    if capture:
        # the JAX state after ITERS iterations, carried into a fresh port
        # trainer: its next iteration is JAX's next
        from tpu_syncbn_torch.models.weights import _flatten

        assert_matches_jax(port_state(tr), [
            {**_flatten(captured[f"{n}_params"]), **_flatten(captured[f"{n}_rest"])}
            for n in "gd"], tr)
        fresh = port_trainer(arch)
        models.load_jax_gan_trainer_state(fresh, captured)
        assert fresh.step_count == ITERS
        step = fresh.d_optimizer.state[fresh.discriminator.fc.weight]["step"]
        assert float(step) == ITERS
        nxt = port_run(fresh, data[ITERS:])
        np.testing.assert_allclose(nxt, jouts[ITERS:], rtol=1e-5)
        assert_matches_jax(port_state(fresh), jfinal, fresh)
    else:
        assert_matches_jax(port_state(tr), jfinal, tr)


def _world2_replica(rank, rdv, out_dir, arch, init, data):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD2, rank=rank)
    try:
        tr = port_trainer(arch, init)
        assert tr.world == WORLD2
        outs = port_run(tr, data, rank, WORLD2)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), __outs=outs,
                 **port_state(tr))
    finally:
        tdist.destroy_process_group()


def _spawn_world2(target, d, *args):
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(d / "rdv"), str(d)) + args)
             for r in range(WORLD2)]
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
    assert [p.exitcode for p in procs] == [0] * WORLD2
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD2)]


@pytest.mark.parametrize("arch", ["dcgan", "sngan"])
def test_world2_over_gloo_matches_jax_mesh2(arch, tmp_path):
    data = host_data(ITERS)
    init, jouts, jfinal, _ = jax_run(arch, 2, "off", data)
    ranks = _spawn_world2(_world2_replica, tmp_path, arch, init, data)
    tr = port_trainer(arch)  # names and layouts only
    for r in ranks:
        np.testing.assert_allclose(r.pop("__outs"), jouts, rtol=1e-5)
        assert_matches_jax(r, jfinal, tr)
    for k in ranks[0]:  # the buffers came from rank 0; params agree anyway
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def _nbt(model) -> list[int]:
    return [int(m.num_batches_tracked) for m in model.modules()
            if isinstance(m, nn.BatchNorm)]


@pytest.mark.parametrize("arch", ["dcgan", "sngan"])
def test_statistics_move_two_and_three_times_an_iteration(arch, tmp_path):
    """G's BN layers: its no-grad train-mode forward in the D step and its
    forward in the G step; D's: real, fake, and the G step's forward. The
    SN buffers move at each of D's three forwards, so eval mode must
    leave them be. With a flight recorder installed each iteration lands
    in its step ring (the losses as ``port_run`` read them)."""
    from tpu_syncbn_torch.obs import flightrec

    tr = port_trainer(arch)
    data = host_data(2)
    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path)))
    try:
        outs = port_run(tr, data)
    finally:
        flightrec.uninstall()
        rec.close()
    ring = rec.rings_snapshot()["steps"]
    assert [e["step"] for e in ring] == [1, 2]
    assert [[e["metrics"][k] for k in ("d_loss", "g_loss", "d_real", "d_fake")]
            for e in ring] == outs.tolist()
    assert _nbt(tr.generator) == [4] * 4
    assert _nbt(tr.discriminator) == [6] * 2
    if arch == "sngan":
        u = tr.discriminator.conv1.u.clone()
        tr.discriminator.eval()
        with torch.no_grad():
            tr.discriminator(torch.from_numpy(data[0][0]))
        assert torch.equal(tr.discriminator.conv1.u, u)
    # no gradient of the G step lands on D's parameters
    assert all(p.grad is not None for p in tr.generator.parameters())
    d_grads = {n: p.grad.clone() for n, p in tr.discriminator.named_parameters()}
    tr.g_optimizer.zero_grad()
    fake = tr.generator(torch.from_numpy(data[0][1]))
    tr.loss_pair(torch.zeros(BATCH), tr.discriminator(fake))[1].backward(
        inputs=list(tr.generator.parameters()))
    assert all(torch.equal(p.grad, d_grads[n])
               for n, p in tr.discriminator.named_parameters())


def test_state_dict_round_trip_repeats_an_iteration_bit_for_bit():
    tr = port_trainer("sngan")
    data = host_data(2)
    port_run(tr, data[:1])
    saved = tr.state_dict()
    first = port_run(tr, data[1:])
    after = port_state(tr)
    assert saved["step_count"] == 1 and tr.step_count == 2
    tr.load_state_dict(saved)
    assert tr.step_count == 1
    again = port_run(tr, data[1:])
    np.testing.assert_array_equal(again, first)
    for k, v in port_state(tr).items():
        np.testing.assert_array_equal(v, after[k], err_msg=k)
    bad = dict(saved, g_rest={k: v for k, v in saved["g_rest"].items()
                              if not k.startswith("bn0.")})
    with pytest.raises(ValueError, match="g_rest mismatch"):
        tr.load_state_dict(bad)


def test_trainer_refuses_what_is_not_ported():
    G = gan.DCGANGenerator(latent_dim=LATENT, width=16, device="cpu")
    D = gan.DCGANDiscriminator(width=8, device="cpu")
    opt = torch.optim.Adam(G.parameters())
    with pytest.raises(ValueError, match="monitors"):
        parallel.GANTrainer(G, D, opt, opt, monitors="everything", device="cpu")
    with pytest.raises(ValueError, match="compression mode"):
        parallel.GANTrainer(G, D, opt, opt, compress="fp8", device="cpu")
    assert parallel.GANTrainer(G, D, opt, opt, compress="bf16", device="cpu").compress == "bf16"
    with pytest.raises(ValueError, match="loss must be one of"):
        parallel.GANTrainer(G, D, opt, opt, loss="wgan", device="cpu")
    out = parallel.GANTrainer(G, D, opt, opt, device="cpu").generate(
        np.zeros((3, LATENT), np.float32))
    assert out.shape == (3, 32, 32, 3) and G.training


def test_loading_a_state_does_not_alias_it():
    """The optimizer state handed to ``load_state_dict`` stays as it was
    after later iterations (torch's own load keeps the given tensors), so
    one saved state restores twice to the same iteration."""
    tr = port_trainer("dcgan")
    data = host_data(2)
    port_run(tr, data[:1])
    saved = tr.state_dict()
    moments = saved["d_opt_state"]["state"][0]["exp_avg"].clone()
    runs = []
    for _ in range(2):
        tr.load_state_dict(saved)
        runs.append(port_run(tr, data[1:]))
    assert torch.equal(saved["d_opt_state"]["state"][0]["exp_avg"], moments)
    np.testing.assert_array_equal(runs[0], runs[1])
