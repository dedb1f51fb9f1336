"""Training state carried across: a JAX trainer's state into the port, and
the ported ImageNet example resumed from its own checkpoints.

* carry: the JAX DataParallel trains the ImageNet example's optimizer
  chain (``add_decayed_weights(1e-4)`` then ``sgd(cosine_decay_schedule,
  momentum=0.9, nesterov=True)``, examples/imagenet_resnet50.py:140-147)
  with ``divergence_guard="halve_lr"`` for two finite steps and one NaN
  step; ``models.load_jax_trainer_state`` carries its ``state_dict()`` (as
  the JAX checkpoint stores it) into the port's trainer built by
  ``imagenet_resnet50.make_optimizer``; both then take the next step on
  the same batch. This holds the momentum (optax ``trace`` → SGD
  ``momentum_buffer``), the schedule (``count`` → the scheduler's step)
  and the guard's ``lr_scale`` against the reference. Tolerances: loss
  rtol 1e-5, parameters, buffers and momentum rtol 2e-4 / atol 1e-5, as
  tests/test_torch_trainer.py.
* example: ``imagenet_resnet50.main`` on the CPU with ``--ckpt-dir``
  (async, accum 2, guard) for one epoch, then ``--resume`` to two: the
  run starts at epoch 1 with the scheduler at the saved step and the
  learning rate of this run's schedule there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import nnx

from test_torch_accum_remat import assert_state_matches, host_batches
from test_torch_resnet import flat_state
from tpu_syncbn import models as jmodels
from tpu_syncbn import nn as jnn
from tpu_syncbn import parallel as jparallel
from tpu_syncbn import runtime as jruntime
from tpu_syncbn.utils import checkpoint as jckpt
from tpu_syncbn_torch import imagenet_resnet50 as example
from tpu_syncbn_torch import models, nn, parallel

NET = dict(rtol=2e-4, atol=1e-5)
LR, DECAY = 0.1, 6


def _jax_loss(m, batch):
    x, y = batch
    logits = m(x).astype(jnp.float32)
    loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
    return loss, {"top1": (logits.argmax(-1) == y).mean()}


def test_jax_trainer_state_carries_into_the_port_and_continues_alike():
    batches = host_batches(seed=8)  # 3 batches of 16 at 8x8
    poisoned = (batches[2][0].copy(), batches[2][1])
    poisoned[0][3] = np.nan
    model = jnn.convert_sync_batchnorm(jmodels.resnet18(
        num_classes=10, small_input=True, width=8, rngs=nnx.Rngs(0)))
    opt = optax.chain(
        optax.add_decayed_weights(1e-4),
        optax.sgd(optax.cosine_decay_schedule(LR, DECAY), momentum=0.9, nesterov=True),
    )
    jdp = jparallel.DataParallel(model, opt, _jax_loss,
                                 mesh=jruntime.data_parallel_mesh(1), donate=False,
                                 divergence_guard="halve_lr")
    for b in (batches[0], batches[1], poisoned):
        jdp.train_step(tuple(map(jnp.asarray, b)))
    state = jax.device_get(jckpt._purify(jdp.state_dict()))
    assert float(state["opt_state"][1]["lr_scale"]) == 0.5

    tmodel = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=10, small_input=True, width=8, device="cpu"))
    topt, sched = example.make_optimizer(tmodel, LR, DECAY)
    dp = parallel.DataParallel(tmodel, topt, example._loss_fn, device="cpu",
                               divergence_guard="halve_lr", lr_scheduler=sched)
    models.load_jax_trainer_state(dp, state)
    assert sched.last_epoch == 2  # two updates taken, the NaN step skipped
    assert dp.guard_state == {"lr_scale": 0.5, "nonfinite_count": 1}
    assert topt.param_groups[0]["lr"] == LR * example.cosine_decay(2, DECAY)
    assert len(topt.state) == len(list(tmodel.parameters()))

    nxt = batches[0]
    jloss = float(jdp.train_step(tuple(map(jnp.asarray, nxt))).loss)
    out = dp.train_step(nxt)
    np.testing.assert_allclose(float(out.loss), jloss, rtol=1e-5)
    assert float(out.metrics["lr_scale"]) == 0.5
    got = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    assert_state_matches(got, flat_state(jdp.sync_to_model()))
    # the momentum after the continued step, against optax's trace
    trace = next(n for n in jax.tree_util.tree_leaves(
        jckpt._purify(jdp.opt_state), is_leaf=lambda x: hasattr(x, "trace"))
        if hasattr(n, "trace")).trace
    flat = models.weights._flatten(jax.device_get(trace))
    params = dict(tmodel.named_parameters())
    for key, value in flat.items():
        name, arr = models.weights._port_name(key, value)
        np.testing.assert_allclose(
            topt.state[params[name]]["momentum_buffer"].numpy(), arr,
            err_msg=key, **NET)


def test_example_resumes_at_the_saved_epoch_with_its_schedule(tmp_path, monkeypatch):
    seen = {}
    load, step = parallel.DataParallel.load_state_dict, parallel.DataParallel.train_step

    def load_state_dict(self, state):
        load(self, state)
        seen["sched_step"] = self.lr_scheduler.last_epoch

    def train_step(self, batch):
        seen.setdefault("first_lr", self.optimizer.param_groups[0]["lr"])
        return step(self, batch)

    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--async-ckpt",
            "--accum-steps", "2", "--divergence-guard", "skip_step",
            "--image-size", "32", "--batch-size", "8", "--dataset-size", "16",
            "--num-classes", "10"]
    first = example.main(["--epochs", "1"] + argv)
    assert first["start_epoch"] == 0 and first["steps"] == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_1.manifest.json", "ckpt_1.pt"]

    monkeypatch.setattr(parallel.DataParallel, "load_state_dict", load_state_dict)
    monkeypatch.setattr(parallel.DataParallel, "train_step", train_step)
    second = example.main(["--epochs", "2", "--resume"] + argv)
    assert second["start_epoch"] == 1
    assert second["steps"] == 4 and len(second["step_s"]) == 2
    assert seen["sched_step"] == 2  # the scheduler's step came back
    # this run's schedule (4 steps long) at step 2, not the saving run's
    assert math.isclose(seen["first_lr"], 0.1 * example.cosine_decay(2, 4))
    assert np.isfinite(second["loss"])
