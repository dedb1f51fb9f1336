"""The divergence guard of the port's DataParallel against the JAX
trainer's (tests/test_faults.py:252-281 ``TestNaNGradient``), from the same
weights on the same numpy batches.

* ``skip_step`` (and ``restore_last_good``, which skips alike on the
  device): a NaN batch never reaches the parameters, the optimizer state
  or the BN buffers, and the whole SGD-momentum trajectory equals JAX's;
  with Adam (moments and step count), the next finite step equals that of
  a trainer that never saw the NaN batch, bit for bit. (The trajectories
  against JAX use SGD: the TinyNet's Linear bias feeds a BatchNorm, so its
  gradient is rounding noise, which Adam's normalized update turns into
  steps of ±lr that differ between any two implementations.)
* ``halve_lr``: two non-finite steps give ``lr_scale`` 0.25 and
  ``nonfinite_count`` 2, and the scaled later updates equal JAX's.
* A policy outside the four raises.
* The consensus at world 2 over gloo: NaN in rank 1's shard only, and both
  ranks skip — held against JAX on a mesh of 2 with the same poisoned
  shard; and a finite loss whose gradients are NaN on rank 1 only (the
  local flags' MIN, which the loss cannot show), where both ranks skip too.

Tolerances: losses rtol 1e-5 (NaN where JAX has NaN); parameters and
buffers rtol 2e-4 / atol 1e-5, as tests/test_torch_trainer.py.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from test_torch_accum_remat import (
    BATCH,
    WORLD,
    assert_state_matches,
    host_batches,
    jax_trajectory,
    port_resnet,
    spawn_world2,
)
from tpu_syncbn_torch import nn, parallel

NET = dict(rtol=2e-4, atol=1e-5)


class TinyNet(torch.nn.Module):
    """The JAX fault tests' TinyNet: Linear(4, 4) then BatchNorm1d(4)."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 4)
        self.bn = nn.BatchNorm1d(4, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def mse(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def make_batch(seed=0, nan=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(16, 4).astype(np.float32)
    if nan:
        x[:] = np.nan  # faults.poison_nan: every float leaf of the input
    return x, rs.randn(16, 4).astype(np.float32)


LR = 0.05


def jax_tiny(policy, batches):
    """The JAX TinyNet trainer (SGD 0.05, momentum 0.9) over ``batches``:
    initial weights, losses, nonfinite flags, final state and guard
    state."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime

    class JTiny(nnx.Module):
        def __init__(self, rngs):
            self.fc = nnx.Linear(4, 4, rngs=rngs)
            self.bn = jnn.BatchNorm1d(4)

        def __call__(self, x):
            return self.bn(self.fc(x))

    def loss_fn(m, batch):
        x, y = batch
        return ((m(x) - y) ** 2).mean()

    model = jnn.convert_sync_batchnorm(JTiny(nnx.Rngs(0)))
    init = flat_state(model)
    dp = jparallel.DataParallel(model, optax.sgd(LR, momentum=0.9), loss_fn,
                                mesh=jruntime.data_parallel_mesh(1), donate=False,
                                divergence_guard=policy)
    losses, flags = [], []
    for b in batches:
        out = dp.train_step(tuple(map(jnp.asarray, b)))
        losses.append(float(out.loss))
        flags.append(float(out.metrics["nonfinite"]))
    guard = jax.device_get(dp.opt_state[1]) if policy else None
    return init, losses, flags, flat_state(dp.sync_to_model()), guard


def port_tiny(init, policy, adam=False):
    from tpu_syncbn_torch import models

    model = nn.convert_sync_batchnorm(TinyNet())
    models.load_jax_params(model, init)
    opt = (torch.optim.Adam(model.parameters(), lr=1e-2) if adam
           else torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9))
    return model, parallel.DataParallel(model, opt, mse, device="cpu",
                                        divergence_guard=policy)


def snapshot(dp):
    return dp.state_dict()


def assert_same_state(a, b):
    for part in ("params", "rest"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), k
    sa, sb = a["opt_state"]["optimizer"]["state"], b["opt_state"]["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


@pytest.mark.parametrize("policy", ["skip_step", "restore_last_good"])
def test_skip_never_pollutes_and_matches_jax(policy):
    batches = [make_batch(0), make_batch(1, nan=True), make_batch(0), make_batch(2)]
    init, jlosses, jflags, jstate, jguard = jax_tiny(policy, batches)
    model, dp = port_tiny(init, policy)
    losses, flags = [], []
    for i, b in enumerate(batches):
        before = snapshot(dp)
        out = dp.train_step(b)
        losses.append(float(out.loss))
        flags.append(float(out.metrics["nonfinite"]))
        if i == 1:  # the skipped step: nothing moved, bit for bit
            assert_same_state(before, snapshot(dp))
            assert float(out.metrics["lr_scale"]) == 1.0
    assert flags == jflags == [0.0, 1.0, 0.0, 0.0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert np.isnan(losses[1])
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for key, want in jstate.items():
        name = key.replace(".kernel", ".weight")
        g = got[name].T if key.endswith(".kernel") else got[name]
        np.testing.assert_allclose(g, want, err_msg=key, **NET)
    assert dp.guard_state == {"lr_scale": 1.0, "nonfinite_count": 1}
    assert int(jguard["nonfinite_count"]) == 1


@pytest.mark.parametrize("policy", ["skip_step", "restore_last_good"])
def test_skip_keeps_adam_state_and_the_next_step_matches_a_control(policy):
    """Adam's moments and step count roll back too: the next finite step
    equals, bit for bit, that of a trainer that never saw the NaN batch."""
    init = jax_tiny(None, [])[0]
    _, control = port_tiny(init, policy, adam=True)
    control.train_step(make_batch(0))
    _, dp = port_tiny(init, policy, adam=True)
    dp.train_step(make_batch(0))
    before = snapshot(dp)
    dp.train_step(make_batch(1, nan=True))
    assert_same_state(before, snapshot(dp))
    assert_same_state(snapshot(dp), snapshot(control))
    a, b = dp.train_step(make_batch(0)), control.train_step(make_batch(0))
    assert float(a.loss) == float(b.loss)
    assert_same_state(snapshot(dp), snapshot(control))


def test_halve_lr_decays_the_scale_per_event_and_matches_jax():
    batches = [make_batch(0), make_batch(1, nan=True), make_batch(2, nan=True),
               make_batch(3)]
    init, jlosses, jflags, jstate, jguard = jax_tiny("halve_lr", batches)
    model, dp = port_tiny(init, "halve_lr")
    outs = [dp.train_step(b) for b in batches]
    assert [float(o.metrics["lr_scale"]) for o in outs] == [1.0, 1.0, 0.5, 0.25]
    assert dp.guard_state == {"lr_scale": 0.25, "nonfinite_count": 2}
    assert float(jguard["lr_scale"]) == 0.25 and int(jguard["nonfinite_count"]) == 2
    assert np.isfinite(float(outs[-1].loss))
    np.testing.assert_allclose([float(o.loss) for o in outs], jlosses, rtol=1e-5)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for key, want in jstate.items():
        name = key.replace(".kernel", ".weight")
        g = got[name].T if key.endswith(".kernel") else got[name]
        np.testing.assert_allclose(g, want, err_msg=key, **NET)
    # the optimizer's lr is put back after each scaled step
    assert dp.optimizer.param_groups[0]["lr"] == LR


def test_bad_policy_raises():
    m = TinyNet()
    with pytest.raises(ValueError, match="divergence_guard must be None"):
        parallel.DataParallel(m, torch.optim.SGD(m.parameters(), lr=0.1), mse,
                              device="cpu", divergence_guard="ignore")


class NaNGradNet(torch.nn.Module):
    """A linear map whose loss adds sqrt(0·out) for the rows flagged by a
    zero first feature: the loss stays finite, the gradient is NaN
    (d sqrt(z)/dz at 0 is inf, times d(0·out)/d out = 0)."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 1)
        with torch.no_grad():
            self.lin.weight.copy_(torch.tensor([[0.5, -0.3, 0.2, 0.1]]))
            self.lin.bias.fill_(0.1)

    def forward(self, x):
        return self.lin(x)[:, 0]


def nan_grad_loss(m, batch):
    x, y = batch
    out = m(x)
    flag = x[:, 0] == 0
    z = torch.where(flag, out * 0.0, torch.ones_like(out))
    return ((out - y) ** 2).mean() + torch.where(flag, torch.sqrt(z), 0.0).sum()


def nan_grad_batch():
    rs = np.random.RandomState(5)
    x = rs.randn(8, 4).astype(np.float32) + 3.0
    x[6, 0] = 0.0  # a row of the second replica's shard
    return torch.from_numpy(x), torch.from_numpy(rs.randn(8).astype(np.float32))


def nan_grad_step(rank=0, world=1):
    m = NaNGradNet()
    dp = parallel.DataParallel(m, torch.optim.SGD(m.parameters(), lr=0.1), nan_grad_loss,
                               device="cpu", divergence_guard="skip_step")
    x, y = nan_grad_batch()
    n = x.shape[0] // world
    before = [p.detach().clone() for p in m.parameters()]
    out = dp.train_step((x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]))
    unchanged = all(torch.equal(a, p) for a, p in zip(before, m.parameters()))
    return float(out.loss), float(out.metrics["nonfinite"]), unchanged


def test_nan_gradients_under_a_finite_loss_skip_the_step():
    loss, nonfinite, unchanged = nan_grad_step()
    assert np.isfinite(loss) and nonfinite == 1.0 and unchanged


# -- the consensus at world 2 -------------------------------------------------


def _poisoned(batches):
    """The second of three batches with NaN in image 1 of rank 1's shard."""
    out = [(x.copy(), y) for x, y in batches]
    out[1][0][BATCH // WORLD + 1] = np.nan
    return out


def _guard_replica(rank, rdv, out_dir, init, batches):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    try:
        model = port_resnet(init)
        dp = parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1,
                                                          momentum=0.9),
                                   lambda m, b: torch.nn.functional.cross_entropy(
                                       m(b[0]), b[1].long()),
                                   device="cpu", divergence_guard="skip_step")
        n = BATCH // WORLD
        losses, flags = [], []
        for x, y in batches:
            out = dp.train_step((x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]))
            losses.append(float(out.loss))
            flags.append(float(out.metrics["nonfinite"]))
        state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
        grad_loss, grad_flag, unchanged = nan_grad_step(rank, WORLD)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), losses=np.asarray(losses),
                 flags=np.asarray(flags),
                 nan_grad=np.asarray([grad_loss, grad_flag, float(unchanged)]), **state)
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    batches = _poisoned(host_batches())
    init, jlosses, jstate = jax_trajectory(2, "off", batches, divergence_guard="skip_step")
    ranks = spawn_world2(_guard_replica, tmp_path_factory.mktemp("guard"), init, batches)
    return jlosses, jstate, ranks


def test_nan_in_one_shard_skips_on_every_rank_as_jax(world2):
    jlosses, jstate, ranks = world2
    assert np.isnan(jlosses[1]) and np.isfinite(jlosses[2])
    for r in ranks:
        assert list(r["flags"]) == [0.0, 1.0, 0.0]
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        state = {k: v for k, v in r.items() if k not in ("losses", "flags", "nan_grad")}
        assert int(state["stem_bn.num_batches_tracked"]) == 2  # the skip restored it
        assert_state_matches(state, jstate)


def test_nan_gradients_on_one_rank_skip_on_both(world2):
    """Rank 0's loss and gradients are finite, rank 1's gradients are not:
    the MIN of the local flags skips the step everywhere."""
    _, _, ranks = world2
    for r in ranks:
        loss, flag, unchanged = r["nan_grad"]
        assert np.isfinite(loss) and flag == 1.0 and unchanged == 1.0
