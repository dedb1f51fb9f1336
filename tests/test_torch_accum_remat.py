"""``accum_steps`` and ``remat`` of the port's DataParallel against the
JAX trainer's (``tpu_syncbn.parallel.trainer``: the no_sync scan over
microbatches with one gradient reduction, and ``jax.checkpoint`` around
the whole loss), from the same weights on the same numpy batches.

* accum: 3 SGD-momentum steps of a SyncBN ResNet-18 (width 8) at
  ``accum_steps=2``, at matched worlds — JAX on a mesh of 1 (its Pallas BN
  forced on, interpret mode on the CPU) against the port at world 1, and
  JAX on a mesh of 2 against the port at world 2 over gloo. A
  microbatch's members depend on each replica's shard, so world 1 cannot
  stand in for world 2. Loss at each step, then every parameter and BN
  buffer.
* ``NoStatCNN`` (tests/test_trainer.py:102): without BN statistics,
  accum 4 on one batch equals accum 1.
* remat: the port with and without remat, and against JAX with
  ``remat=True`` (tests/test_trainer.py:266); the running statistics move
  once a step, ``momentum=None``'s cumulative average included.

Tolerances: losses rtol 1e-5; parameters and buffers rtol 2e-4 / atol
1e-5, as tests/test_torch_trainer.py (f32 sums in another order); remat
against no remat, the JAX test's rtol 1e-5 / atol 1e-7 (the same
computation twice). The spawned replicas import this module, so JAX is
imported inside the tests.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch import data, models, nn, parallel

NET = dict(rtol=2e-4, atol=1e-5)
STEPS, BATCH, LR, ACCUM = 3, 16, 0.1, 2
WORLD = 2
JOIN_TIMEOUT_S = 120


def host_batches(seed=3):
    ds = data.SyntheticImageDataset(length=BATCH * STEPS, shape=(8, 8, 3),
                                    num_classes=10, seed=seed)
    sampler = data.DistributedSampler(len(ds), num_replicas=1, rank=0,
                                      shuffle=True, seed=5)
    return list(data.DataLoader(ds, batch_size=BATCH, sampler=sampler,
                                num_workers=0, drop_last=True))


def _ce(m, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(m(x), y.long())


def port_resnet(init):
    model = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=10, small_input=True, width=8, device="cpu"))
    models.load_jax_params(model, init)
    return model


def port_trajectory(init, batches, rank=0, world=1, **kw):
    """Losses and final state of the port on this rank's rows of each
    global batch."""
    model = port_resnet(init)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    dp = parallel.DataParallel(model, opt, _ce, device="cpu", **kw)
    n = BATCH // world
    losses = [float(dp.train_step((x[rank * n:(rank + 1) * n],
                                   y[rank * n:(rank + 1) * n])).loss)
              for x, y in batches]
    return losses, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def jax_trajectory(n_devices, pallas, batches, **kw):
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import models as jmodels
    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime
    from tpu_syncbn.ops import batch_norm as jbn

    def loss_fn(m, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(m(x), y).mean()

    with jbn.pallas_mode(pallas):
        model = jnn.convert_sync_batchnorm(jmodels.resnet18(
            num_classes=10, small_input=True, width=8, rngs=nnx.Rngs(0)))
        init = flat_state(model)
        dp = jparallel.DataParallel(model, optax.sgd(LR, momentum=0.9), loss_fn,
                                    mesh=jruntime.data_parallel_mesh(n_devices),
                                    donate=False, **kw)
        losses = [float(dp.train_step(tuple(map(jnp.asarray, b))).loss)
                  for b in batches]
    return init, losses, flat_state(dp.sync_to_model())


def assert_state_matches(got, jstate, tol=NET):
    assert len(got) == len(jstate)
    for key, want in jstate.items():
        name = key[:-len(".kernel")] + ".weight" if key.endswith(".kernel") else key
        g = got[name]
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif key == "fc.kernel":
            g = g.T
        np.testing.assert_allclose(g, want, err_msg=key, **tol)


# -- accum_steps --------------------------------------------------------------


def test_accum_world1_matches_jax_mesh1():
    batches = host_batches()
    init, jlosses, jstate = jax_trajectory(1, "on", batches, accum_steps=ACCUM)
    losses, state = port_trajectory(init, batches, accum_steps=ACCUM)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert len(set(np.round(losses, 4))) == STEPS  # the model moved
    assert int(state["stem_bn.num_batches_tracked"]) == ACCUM * STEPS
    assert_state_matches(state, jstate)


def _accum_replica(rank, rdv, out_dir, init, batches):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    try:
        losses, state = port_trajectory(init, batches, rank, WORLD,
                                        accum_steps=ACCUM)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 losses=np.asarray(losses), **state)
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


def test_accum_world2_over_gloo_matches_jax_mesh2(tmp_path):
    batches = host_batches()
    init, jlosses, jstate = jax_trajectory(2, "off", batches, accum_steps=ACCUM)
    ranks = spawn_world2(_accum_replica, tmp_path, init, batches)
    for r in ranks:
        np.testing.assert_allclose(r.pop("losses"), jlosses, rtol=1e-5)
        assert int(r["stem_bn.num_batches_tracked"]) == ACCUM * STEPS
        assert_state_matches(r, jstate)


class NoStatCNN(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.fc = torch.nn.Linear(8, 10)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, x):
        h = torch.relu(self.conv(x.permute(0, 3, 1, 2)))
        return self.fc(h.mean(dim=(2, 3)))


def test_accum_matches_single_step_without_bn_state():
    """no_sync parity (tests/test_trainer.py:102): accum 4 on one batch
    equals accum 1 where no BN statistic couples the microbatches."""
    rs = np.random.RandomState(7)
    batch = (torch.from_numpy(rs.randn(32, 8, 8, 3).astype(np.float32)),
             torch.from_numpy(rs.randint(0, 10, 32)))
    outs = {}
    for accum in (1, 4):
        m = NoStatCNN(3)
        dp = parallel.DataParallel(m, torch.optim.SGD(m.parameters(), lr=0.05), _ce,
                                   device="cpu", accum_steps=accum)
        loss = float(dp.train_step(batch).loss)
        outs[accum] = (loss, {k: v.detach().clone() for k, v in m.state_dict().items()})
    assert outs[1][0] == pytest.approx(outs[4][0], rel=1e-5)
    for k, v in outs[1][1].items():
        np.testing.assert_allclose(outs[4][1][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_accum_validation():
    m = NoStatCNN(0)
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        parallel.DataParallel(m, opt, _ce, device="cpu", accum_steps=0)
    dp = parallel.DataParallel(m, opt, _ce, device="cpu", accum_steps=3)
    batch = (torch.zeros(8, 8, 8, 3), torch.zeros(8, dtype=torch.long))
    with pytest.raises(ValueError, match="per-replica batch size 8 is not "
                                         "divisible by accum_steps=3"):
        dp.train_step(batch)


# -- remat --------------------------------------------------------------------


def test_remat_matches_the_plain_step_and_jax_remat():
    batches = host_batches(seed=21)
    init, jlosses, jstate = jax_trajectory(1, "off", batches, remat=True)
    plain_losses, plain = port_trajectory(init, batches)
    losses, state = port_trajectory(init, batches, remat=True)
    np.testing.assert_allclose(losses, plain_losses, rtol=1e-6)
    for k, v in plain.items():
        np.testing.assert_allclose(state[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    # the running statistics moved once a step, not twice
    assert int(state["stem_bn.num_batches_tracked"]) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert_state_matches(state, jstate)


def test_remat_moves_running_stats_once_a_step():
    model = port_resnet(jax_trajectory_init())
    dp = parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=LR),
                               _ce, device="cpu", remat=True)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.endswith("running_mean")}
    dp.train_step(host_batches()[0])
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm)]
    assert len(bns) == 20
    assert all(int(m.num_batches_tracked) == 1 for m in bns)
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items()
               if k in before)


def jax_trajectory_init():
    """Seed-0 JAX weights of the width-8 ResNet-18, as numpy."""
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import models as jmodels
    from tpu_syncbn import nn as jnn

    return flat_state(jnn.convert_sync_batchnorm(jmodels.resnet18(
        num_classes=10, small_input=True, width=8, rngs=nnx.Rngs(0))))


class CumulativeNet(torch.nn.Module):
    """Linear -> SyncBatchNorm(momentum=None) -> Linear."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        self.fc1 = torch.nn.Linear(5, 6)
        self.bn = nn.SyncBatchNorm(6, momentum=None, device="cpu")
        self.fc2 = torch.nn.Linear(6, 3)
        with torch.no_grad():
            for p in (self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias):
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x):
        return self.fc2(torch.relu(self.bn(self.fc1(x))))


def test_remat_keeps_the_cumulative_average_of_momentum_none():
    """momentum=None averages every batch's statistics with factor
    1/num_batches_tracked: a recomputation that moved the buffers again
    would weigh the batches wrongly and count each twice."""
    rs = np.random.RandomState(4)
    batches = [(torch.from_numpy(rs.randn(12, 5).astype(np.float32) * 2 + i),
                torch.from_numpy(rs.randint(0, 3, 12))) for i in range(3)]
    states = {}
    for remat in (False, True):
        m = CumulativeNet()
        dp = parallel.DataParallel(m, torch.optim.SGD(m.parameters(), lr=0.05), _ce,
                                   device="cpu", remat=remat)
        means = []
        for b in batches:
            with torch.no_grad():
                means.append(m.fc1(b[0]).mean(0))
            dp.train_step(b)
        states[remat] = {k: v.clone() for k, v in m.bn.state_dict().items()}
        assert int(m.bn.num_batches_tracked) == 3
        # the cumulative average of the three batch means
        np.testing.assert_allclose(m.bn.running_mean.numpy(),
                                   torch.stack(means).mean(0).numpy(),
                                   rtol=1e-5, atol=1e-6)
    for k, v in states[False].items():
        assert torch.equal(states[True][k], v), k
