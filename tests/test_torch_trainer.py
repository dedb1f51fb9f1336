"""Three SGD-momentum steps of the port's DataParallel (world 1) against the
JAX DataParallel on the same weights and batches: loss at every step, then
every parameter and BN buffer.

Batches come through the port's DistributedSampler + SyntheticImageDataset
+ DataLoader (index- and bit-exact with the JAX ones, tests/
test_torch_data.py) and feed both trainers as the same numpy arrays.

Cases:
* ``mesh1``: JAX on ``data_parallel_mesh(1)`` with its Pallas BN kernels
  forced on (interpret mode on the CPU, as tests/test_pallas_bn.py runs
  the trainer);
* ``mesh8``: JAX on the default 8-device mesh with the same global batch —
  full-world SyncBN over 8 shards equals one replica with the whole batch.

``optax.sgd(lr, momentum=0.9)`` is ``torch.optim.SGD(lr, momentum=0.9)``:
both keep ``v = μ·v + g`` and step ``p -= lr·v``.

Tolerance: rtol 2e-4 / atol 1e-5, as the JAX package's conv-net parity
tests use (tests/test_pallas_bn.py); losses rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from test_torch_resnet import flat_state
from tpu_syncbn import models as jmodels
from tpu_syncbn import nn as jnn
from tpu_syncbn import parallel as jparallel
from tpu_syncbn import runtime as jruntime
from tpu_syncbn.ops import batch_norm as jbn
from tpu_syncbn_torch import data, models, nn, parallel

NET = dict(rtol=2e-4, atol=1e-5)
STEPS = 3
BATCH = 16
LR = 0.1


def batches():
    ds = data.SyntheticImageDataset(length=BATCH * STEPS, shape=(8, 8, 3),
                                    num_classes=10, seed=3)
    sampler = data.DistributedSampler(len(ds), num_replicas=1, rank=0,
                                      shuffle=True, seed=5)
    loader = data.DataLoader(ds, batch_size=BATCH, sampler=sampler,
                             num_workers=2, drop_last=True)
    return list(loader)


def jax_trajectory(mesh, pallas, host_batches):
    def loss_fn(m, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(m(x), y).mean()

    with jbn.pallas_mode(pallas):
        model = jnn.convert_sync_batchnorm(jmodels.resnet18(
            num_classes=10, small_input=True, width=8, rngs=nnx.Rngs(0)))
        init = flat_state(model)
        dp = jparallel.DataParallel(model, optax.sgd(LR, momentum=0.9),
                                    loss_fn, mesh=mesh, donate=False)
        losses = [float(dp.train_step(tuple(map(jnp.asarray, b))).loss)
                  for b in host_batches]
    return init, losses, flat_state(dp.sync_to_model())


def torch_trajectory(init, host_batches):
    model = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=10, small_input=True, width=8, device="cpu"))
    models.load_jax_params(model, init)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9,
                          dampening=0, nesterov=False)

    def loss_fn(m, batch):
        x, y = batch
        return torch.nn.functional.cross_entropy(m(x), y.long())

    dp = parallel.DataParallel(model, opt, loss_fn, device="cpu")
    assert dp.world == 1 and not dp._per_step_broadcast
    losses = [float(dp.train_step(b).loss) for b in host_batches]
    return losses, model


@pytest.mark.parametrize("case", ["mesh1", "mesh8"])
def test_three_steps_match_jax_dataparallel(case):
    if case == "mesh1":
        mesh, pallas = jruntime.data_parallel_mesh(1), "on"
    else:
        mesh, pallas = jruntime.data_parallel_mesh(), "off"
        assert mesh.devices.size == 8
    host = batches()
    assert len(host) == STEPS and host[0][0].shape == (BATCH, 8, 8, 3)
    init, jlosses, jstate = jax_trajectory(mesh, pallas, host)
    tlosses, tmodel = torch_trajectory(init, host)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert len(set(np.round(tlosses, 4))) == STEPS  # the model moved
    got = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    for key, want in jstate.items():
        name = key[:-len(".kernel")] + ".weight" if key.endswith(".kernel") else key
        g = got[name]
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif key == "fc.kernel":
            g = g.T
        np.testing.assert_allclose(g, want, err_msg=key, **NET)
    assert len(jstate) == len(got)


def test_eval_step_uses_running_stats_and_restores_the_mode():
    model = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=10, small_input=True, width=8, device="cpu"))
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    dp = parallel.DataParallel(
        model, opt, lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1].long()),
        device="cpu")
    b = batches()[0]
    dp.train_step(b)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = dp.eval_step(b)
    assert model.training and np.isfinite(float(out.loss))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_trainer_checks_its_arguments_and_picks_the_buffer_broadcast():
    model = models.resnet18(num_classes=10, small_input=True, width=8, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    with pytest.raises(ValueError, match="broadcast_buffers"):
        parallel.DataParallel(model, opt, None, device="cpu",
                              broadcast_buffers="sometimes")
    # a plain-BN model keeps DDP's per-step buffer broadcast; a fully
    # converted one skips it (its stats are identical by construction)
    assert parallel.DataParallel(model, opt, None, device="cpu")._per_step_broadcast
    conv = nn.convert_sync_batchnorm(model)
    assert not parallel.DataParallel(conv, opt, None, device="cpu")._per_step_broadcast
    conv.fc.to("meta")
    with pytest.raises(ValueError, match="lives on meta"):
        parallel.DataParallel(conv, opt, None, device="cpu")
