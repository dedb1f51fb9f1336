"""The real-image slice as a whole, against the JAX package on one JPEG
tree the test writes with PIL:

* the ImageNet train and eval pipelines of the port's
  ``tpu_syncbn_torch.imagenet_resnet50`` and of ``examples/
  imagenet_resnet50.py`` (imported by path) give equal batches through
  the two DataLoaders: process workers reseeded per worker, thread
  workers, one process; through ``staged_iter`` and without it;
* three DataParallel steps of a narrow ResNet at 32² (the ImageNet
  stem: 7x7 stride-2 convolution and max pool), batch 16, with the port's
  SGD (Nesterov, weight decay, per-step cosine schedule) against the JAX
  example's optax chain, from the same weights on the same batches:
  losses rtol 1e-5, parameters and BN buffers rtol 2e-4 / atol 1e-5 (the
  conv-net tolerances and batch of tests/test_torch_trainer.py). The net
  is a ResNet-18: a width-8 ResNet-50 at 32² is chaotic at
  initialization (its last stage normalizes 1x1 maps over the batch), so
  reversing a batch of 8's order moves JAX's own second-step loss by
  about 1 %, and no tolerance there tells rounding from a fault;
* the example's ``main`` on the CPU runs to its done line.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import nnx
from PIL import Image

from test_torch_loader import deadline, jax_reseed_worker, reseed_worker, same_batches
from test_torch_resnet import flat_state
from tpu_syncbn import data as jdata
from tpu_syncbn import models as jmodels
from tpu_syncbn import nn as jnn
from tpu_syncbn import parallel as jparallel
from tpu_syncbn import runtime as jruntime
from tpu_syncbn_torch import data as tdata
from tpu_syncbn_torch import imagenet_resnet50 as example
from tpu_syncbn_torch import models, nn, parallel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "imagenet_resnet50.py")
NET = dict(rtol=2e-4, atol=1e-5)
SIZE = 32


def jax_example():
    spec = importlib.util.spec_from_file_location("jax_imagenet_resnet50", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_jpeg_tree(root, n_train=10, n_val=4, seed=0):
    """root/{train,val}/{n01,n02}/*.jpg: smooth colour fields plus noise,
    sizes 40-70 x 36-64, quality 90."""
    rs = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in ("n01", "n02"):
            d = os.path.join(root, split, c)
            os.makedirs(d)
            for i in range(n):
                h, w = rs.randint(36, 65), rs.randint(40, 71)
                field = Image.fromarray(rs.randint(0, 256, (4, 5, 3), dtype=np.uint8))
                px = np.asarray(field.resize((w, h), Image.BILINEAR), np.int16)
                px = np.clip(px + rs.randint(-8, 9, px.shape), 0, 255).astype(np.uint8)
                Image.fromarray(px).save(os.path.join(d, f"{i:03d}.JPEG"), quality=90)
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_jpeg_tree(tmp_path_factory.mktemp("imagenet"))


def pipelines(tree):
    j, t = jax_example().make_imagefolder_datasets(tree, SIZE), \
        example.make_imagefolder_datasets(tree, SIZE)
    for a, b in zip(j, t):
        assert a.samples == b.samples and a.class_to_idx == b.class_to_idx
    return j, t


def test_process_workers_give_the_jax_batches_with_and_without_staging(tree):
    with deadline(240):
        (jtrain, _), (ttrain, _) = pipelines(tree)
        kw = dict(batch_size=4, num_workers=2, worker_type="process", drop_last=True)
        js, ts = (mod.DistributedSampler(20, 1, 0, shuffle=True, seed=0)
                  for mod in (jdata, tdata))
        jl = jdata.DataLoader(jtrain, sampler=js, worker_init_fn=jax_reseed_worker, **kw)
        tl = tdata.DataLoader(ttrain, sampler=ts, worker_init_fn=reseed_worker, **kw)
        try:
            for epoch, staged in ((0, False), (1, True)):
                js.set_epoch(epoch)
                ts.set_epoch(epoch)
                jb = list(jdata.staged_iter(iter(jl)) if staged else jl)
                tb = list(tdata.staged_iter(iter(tl)) if staged else tl)
                assert len(tb) == 5 and tb[0][0].shape == (4, SIZE, SIZE, 3)
                same_batches(tb, jb)
        finally:
            jl.close()
            tl.close()


@pytest.mark.parametrize("split,workers", [("val", 3), ("train", 0)])
@pytest.mark.parametrize("staged", [False, True])
def test_thread_and_single_process_loaders_give_the_jax_batches(tree, split,
                                                                 workers, staged):
    """Threads draw in scheduling order, so they run the deterministic eval
    pipeline; one process runs the train pipeline, seeded alike."""
    (jtrain, jval), (ttrain, tval) = pipelines(tree)
    jd, td = (jtrain, ttrain) if split == "train" else (jval, tval)
    if split == "train":
        jd.transform.reseed(7)
        td.transform.reseed(7)
    jl = jdata.DataLoader(jd, 3, num_workers=workers,
                          sampler=jdata.DistributedSampler(len(jd), 2, 1, seed=3))
    tl = tdata.DataLoader(td, 3, num_workers=workers,
                          sampler=tdata.DistributedSampler(len(td), 2, 1, seed=3))
    jb = list(jdata.staged_iter(iter(jl)) if staged else jl)
    tb = list(tdata.staged_iter(iter(tl)) if staged else tl)
    assert len(tb) == (2 if split == "val" else 4)
    same_batches(tb, jb)


def test_cosine_schedule_is_optax_cosine_decay():
    for decay in (1, 4, 37):
        schedule = optax.cosine_decay_schedule(1.0, decay)
        for t in range(decay + 3):
            assert example.cosine_decay(t, decay) == pytest.approx(
                float(schedule(t)), rel=1e-6, abs=1e-7)


def test_three_steps_match_the_jax_example_optimizer(tree):
    # the JAX example's optimizer, as written there (examples/
    # imagenet_resnet50.py:140-147), rebuilt below with the test's lr
    with open(EXAMPLE) as f:
        src = f.read()
    for text in ("optax.cosine_decay_schedule(", "optax.add_decayed_weights(1e-4)",
                 "optax.sgd(schedule, momentum=0.9, nesterov=True)"):
        assert text in src
    lr, decay_steps, steps, batch = 0.1, 4, 3, 16
    _, (ttrain, _) = pipelines(tree)
    ttrain.transform.reseed(11)
    sampler = tdata.DistributedSampler(20, 1, 0, seed=5)
    loader = tdata.DataLoader(ttrain, batch, drop_last=True, sampler=sampler)
    host = []
    for epoch in range(steps):  # 20 images: one batch of 16 an epoch
        sampler.set_epoch(epoch)
        host += list(loader)
    assert len(host) == steps and host[0][0].shape == (batch, SIZE, SIZE, 3)

    jex = jax_example()
    model = jnn.convert_sync_batchnorm(jmodels.resnet18(
        num_classes=2, width=8, rngs=nnx.Rngs(0)))
    init = flat_state(model)
    opt = optax.chain(
        optax.add_decayed_weights(1e-4),
        optax.sgd(optax.cosine_decay_schedule(lr, decay_steps), momentum=0.9,
                  nesterov=True),
    )

    def jloss(m, b):
        x, y = b
        logits = m(x).astype(jnp.float32)
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return loss, {"top1": (logits.argmax(-1) == y).mean()}

    jdp = jparallel.DataParallel(model, opt, jloss, mesh=jruntime.data_parallel_mesh(),
                                 donate=False)
    jlosses = [float(jdp.train_step(tuple(map(jnp.asarray, b))).loss) for b in host]
    jstate = flat_state(jdp.sync_to_model())
    assert jex.IMAGENET_MEAN == example.IMAGENET_MEAN

    tmodel = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=2, width=8, device="cpu"))
    models.load_jax_params(tmodel, init)
    topt, sched = example.make_optimizer(tmodel, lr, decay_steps)
    dp = parallel.DataParallel(tmodel, topt, example._loss_fn, device="cpu")
    tlosses = []
    for b in host:
        tlosses.append(float(dp.train_step(b).loss))
        sched.step()
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert len(set(np.round(tlosses, 4))) == steps  # the model moved
    got = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    assert len(jstate) == len(got)
    for key, want in jstate.items():
        name = key[:-len(".kernel")] + ".weight" if key.endswith(".kernel") else key
        g = got[name]
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif key == "fc.kernel":
            g = g.T
        np.testing.assert_allclose(g, want, err_msg=key, **NET)


def test_example_main_runs_on_the_cpu(tree, tmp_path):
    log = tmp_path / "metrics.jsonl"
    out = example.main(["--device", "cpu", "--data-root", tree, "--epochs", "1",
                        "--image-size", str(SIZE), "--batch-size", "4",
                        "--eval-every", "1", "--metrics-log", str(log)])
    assert out["steps"] == 5 and np.isfinite(out["loss"])
    assert 0.0 <= out["final_top1"] <= 1.0
    assert len(out["step_s"]) == len(out["data_wait_s"]) == 5
    assert log.read_text().count("\n") == 2  # val_top1, final_val_top1
