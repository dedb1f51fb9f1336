"""The port's RetinaNet (``tpu_syncbn_torch.models.retinanet``) against
``tpu_syncbn.models.retinanet`` at the ``--arch small`` size (BasicBlock
(1, 1, 1, 1) backbone of width 16, FPN 32, 5 classes, 64² images): same
weights (moved over by ``load_jax_params``, which checks the anchors
equal), same numpy images and padded ground truth from
``SyntheticDetectionDataset``, float32 on the CPU.

* forward in train mode (logits, deltas, running statistics);
* the loss, its two terms and the gradient of every parameter;
* ``decode``: ``torch.topk`` and ``jax.lax.top_k`` may order equal scores
  differently, so the test first requires the JAX top-k scores to hold no
  ties, then compares scores, classes, masks and decoded boxes in order;
* 3 Adam steps of ``DataParallel`` with ``loss_fn = lambda m, b:
  m.loss(*b)``: world 1 against JAX's mesh of 1 (Pallas BN forced on,
  interpret mode) and, with the whole batch, against JAX's mesh of 8.
  The gradients agree to ~1e-5 of each tensor's norm, but Adam at the
  example's lr 1e-3 and eps 1e-8 does not carry that into 3 steps: an
  element whose gradient is a sum cancelling to near zero (a filter of a
  mostly dead ReLU channel) has a relative rounding error of percents,
  and Adam's normalization turns it into an update error of up to lr
  (2.5e-5 after one step in head.box_tower.2, either side equally
  right); and at lr 1e-3 the loss falls 66 → 18 → 7.9 in 3 steps, which
  carries a 1e-5 gradient difference into 1 % of a BN bias's update. So
  the steps take lr 1e-4 and eps 1e-3: such an element moves by about
  its gradient times lr/eps, and every element with a gradient above 1e-3
  still takes Adam's normalized step (moments, bias correction, count);
* the example under the port's launcher at ``--simulate-chips 2``.

Tolerances: networks rtol 2e-4 / atol 1e-5, as the JAX package's conv-net
parity tests (f32 sums in another order); losses rtol 1e-5; gradients
rtol 2e-4 with atol 1e-5 of the tensor's largest magnitude where that
exceeds 1 (the stem's reach ~50, so an element near zero carries the
rounding of its large neighbours); decoded boxes, whose deltas pass
through exp, rtol 2e-4 / atol 1e-4 pixels.
"""

import os
import subprocess
import sys

import jax
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
from tpu_syncbn.models.resnet import BasicBlock as JBasicBlock
from tpu_syncbn.models.resnet import ResNet as JResNet
from tpu_syncbn.ops import batch_norm as jbn
from tpu_syncbn_torch import data, models, nn, parallel, retinanet_train
from tpu_syncbn_torch.models.weights import _port_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = dict(rtol=2e-4, atol=1e-5)
SIZE, CLASSES, MAX_BOXES, LR, EPS, STEPS = 64, 5, 4, 1e-4, 1e-3, 3


def jax_small():
    backbone = JResNet(JBasicBlock, (1, 1, 1, 1), num_classes=1, width=16,
                       rngs=nnx.Rngs(0))
    return jnn.convert_sync_batchnorm(jmodels.RetinaNet(
        num_classes=CLASSES, image_size=(SIZE, SIZE), fpn_channels=32,
        backbone=backbone, rngs=nnx.Rngs(0)))


def port_small(init):
    model = nn.convert_sync_batchnorm(
        retinanet_train.build_model("small", CLASSES, (SIZE, SIZE), "cpu"))
    models.load_jax_params(model, init)
    return model


def batch(n, seed=0):
    ds = data.SyntheticDetectionDataset(length=n, image_size=(SIZE, SIZE),
                                        num_classes=CLASSES, max_boxes=MAX_BOXES,
                                        seed=seed, box_frac=(0.4, 0.7))
    return tuple(np.stack(parts) for parts in zip(*(ds[i] for i in range(n))))


def assert_state(model, jstate):
    live = dict(model.named_parameters())
    live.update(dict(model.named_buffers()))
    assert len(live) == len(jstate)
    for key, want in jstate.items():
        name, arr = _port_name(key, want, model)
        np.testing.assert_allclose(live[name].detach().numpy(), arr, err_msg=key, **NET)


def test_forward_loss_and_gradients_match_jax():
    b = batch(4)
    with jbn.pallas_mode("on"):
        jm = jax_small()
        init = flat_state(jm)
        jm.train()

        def jloss(m):
            return m.loss(*map(jnp.asarray, b))

        (jl, jaux), jgrads = nnx.jit(nnx.value_and_grad(jloss, has_aux=True))(jm)
        jstate = flat_state(jm)  # the running stats after one forward
    pm = port_small(init)
    pm.train()
    loss, aux = pm.loss(*map(torch.from_numpy, b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("cls_loss", "box_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    assert_state(pm, jstate)
    jg = {}
    for key, g in flat_state_grads(jgrads).items():
        name, arr = _port_name(key, g, pm)
        jg[name] = arr
    n = 0
    for name, p in pm.named_parameters():
        if name.startswith("backbone.fc."):
            assert p.grad is None and not jg[name].any()  # unused head
            continue
        scale = float(np.abs(jg[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), jg[name], err_msg=name,
                                   rtol=NET["rtol"], atol=NET["atol"] * max(scale, 1.0))
        n += 1
    assert n > 60

    # the forward alone: per-anchor logits and deltas, and the anchors
    with jbn.pallas_mode("on"):
        jm.eval()
        jc, jb = nnx.jit(lambda m, x: m(x))(jm, jnp.asarray(b[0]))
    pm.eval()
    with torch.no_grad():
        pc, pb = pm(torch.from_numpy(b[0]))
    assert pc.shape == (4, 774, CLASSES) and pb.shape == (4, 774, 4)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **NET)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **NET)


def flat_state_grads(grads) -> dict:
    out = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = np.asarray(v)

    from tpu_syncbn import compat

    walk(compat.nnx_to_pure_dict(grads), "")
    return out


def test_decode_matches_jax_without_ties():
    b = batch(2, seed=1)
    jm = jax_small()
    init = flat_state(jm)
    jm.eval()
    jboxes, jscores, jclasses, jkeep = jm.decode(jnp.asarray(b[0]), top_k=20)
    jscores = np.asarray(jscores)
    assert all(len(set(row)) == len(row) for row in jscores)  # no ties
    pm = port_small(init)
    pm.eval()
    boxes, scores, classes, keep = pm.decode(torch.from_numpy(b[0]), top_k=20)
    assert boxes.shape == (2, 20, 4) and scores.shape == classes.shape == (2, 20)
    np.testing.assert_allclose(scores.numpy(), jscores, **NET)
    np.testing.assert_array_equal(classes.numpy(), np.asarray(jclasses))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=2e-4, atol=1e-4)


def jax_steps(mesh_n, pallas, batches):
    with jbn.pallas_mode(pallas):
        model = jax_small()
        init = flat_state(model)
        dp = jparallel.DataParallel(model, optax.adam(LR, eps=EPS),
                                    lambda m, b_: m.loss(*b_),
                                    mesh=jruntime.data_parallel_mesh(mesh_n),
                                    donate=False)
        losses = [float(dp.train_step(tuple(jax.device_put(jnp.asarray(a),
                                                           dp.batch_sharding)
                                            for a in b_)).loss)
                  for b_ in batches]
    return init, losses, flat_state(dp.sync_to_model())


@pytest.mark.parametrize("case", ["mesh1", "mesh8"])
def test_three_adam_steps_match_jax_dataparallel(case):
    mesh_n, pallas = (1, "on") if case == "mesh1" else (8, "off")
    batches = [batch(8, seed=10 + i) for i in range(STEPS)]
    init, jlosses, jstate = jax_steps(mesh_n, pallas, batches)
    model = port_small(init)
    dp = parallel.DataParallel(model, torch.optim.Adam(model.parameters(), lr=LR, eps=EPS),
                               lambda m, b_: m.loss(*b_), device="cpu")
    losses = [float(dp.train_step(b_).loss) for b_ in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert len(set(np.round(losses, 4))) == STEPS
    assert_state(model, jstate)


def test_anchors_are_checked_not_loaded():
    init = flat_state(jax_small())
    model = port_small(init)
    assert torch.equal(model.anchors, models.detection.retinanet_anchors((SIZE, SIZE)))
    bad = dict(init, anchors=init["anchors"] + 1.0)
    with pytest.raises(ValueError, match="anchors"):
        models.load_jax_params(model, bad)
    n_bn = sum(isinstance(m, nn.BatchNorm) for m in model.modules())
    assert n_bn == 12 and all(isinstance(m, nn.SyncBatchNorm) for m in model.modules()
                              if isinstance(m, nn.BatchNorm))


def test_full_width_model_has_53_bn_layers_only_in_the_backbone():
    model = models.retinanet_r50_fpn(device="cpu")
    bns = [n for n, m in model.named_modules() if isinstance(m, nn.BatchNorm)]
    assert len(bns) == 53 and all(n.startswith("backbone.") for n in bns)
    assert tuple(model.anchors.shape) == (49104, 4)  # 512²: 9 anchors a cell
    assert model.head.cls_out.weight.shape[0] == 9 * 80
    np.testing.assert_allclose(float(model.head.cls_out.bias[0]), -np.log(99), rtol=1e-6)


def test_example_under_the_launcher_at_two_processes():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_syncbn_torch.launch", "--simulate-chips", "2",
         "tpu_syncbn_torch/retinanet_train.py", "--", "--device", "cpu",
         "--arch", "small", "--image-size", "64", "--num-classes", "5",
         "--iters", "2", "--eval-images", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "done: 2 iters; eval on 2 images: mAP@[.5:.95]" in r.stdout
