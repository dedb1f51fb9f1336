"""BatchNorm / SyncBatchNorm modules of the port: parity with tpu_syncbn.nn
on the same numpy inputs, convert_sync_batchnorm, and the golden invariant
over gloo — 2 replicas of batch B compute what 1 replica of batch 2B does
(outputs, running statistics, gradients), for SyncBatchNorm alone and for
DataParallel's gradient averaging.

Tolerances: module parity against JAX rtol 1e-5 / atol 1e-5 (f32, the same
formulas summed in another order); the world-2 invariant the same, since
the two runs differ only in how the batch sums are split; the ResNet-18
trajectories rtol 2e-4 / atol 1e-5, as the JAX package's conv-net parity
tests use (tests/test_pallas_bn.py).

The spawned replicas import this module, so JAX is imported inside the
tests that compare against it, not at the top: a replica needs torch only.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch import models, nn, parallel

F32 = dict(rtol=1e-5, atol=1e-5)
NET = dict(rtol=2e-4, atol=1e-5)
C = 6
B = 4  # per-replica batch; the single replica sees 2B
WORLD = 2
JOIN_TIMEOUT_S = 60


def rand(seed, shape, scale=1.5, shift=0.2):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def npf(t):
    return t.detach().to(torch.float32).numpy()


# -- parity with the JAX modules -------------------------------------------


def _jax_bn(cls_name, momentum, affine, w, b):
    from tpu_syncbn import nn as jnn

    m = getattr(jnn, cls_name)(C, momentum=momentum, affine=affine)
    if affine:
        m.weight.value = w
        m.bias.value = b
    return m


@pytest.mark.parametrize("cls_name", ["BatchNorm2d", "SyncBatchNorm"])
@pytest.mark.parametrize("momentum", [0.1, None])
@pytest.mark.parametrize("affine", [True, False])
def test_module_matches_jax_in_train_and_eval(cls_name, momentum, affine):
    """Two training steps (batch statistics, running buffers) then eval
    (running statistics). SyncBatchNorm outside any replica group is
    plain BN in both packages."""
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    w = rs.uniform(0.5, 1.5, C).astype(np.float32)
    b = rs.randn(C).astype(np.float32)
    jm = _jax_bn(cls_name, momentum, affine, jnp.asarray(w), jnp.asarray(b))
    tm = getattr(nn, cls_name)(C, momentum=momentum, affine=affine, device="cpu")
    if affine:
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(w))
            tm.bias.copy_(torch.from_numpy(b))
    for seed in (1, 2):
        x = rand(seed, (4, 5, 3, C))
        np.testing.assert_allclose(npf(tm(torch.from_numpy(x))),
                                   np.asarray(jm(jnp.asarray(x))), **F32)
    np.testing.assert_allclose(npf(tm.running_mean), np.asarray(jm.running_mean.value), **F32)
    np.testing.assert_allclose(npf(tm.running_var), np.asarray(jm.running_var.value), **F32)
    assert int(tm.num_batches_tracked) == int(jm.num_batches_tracked.value) == 2
    jm.eval()
    tm.eval()
    x = rand(3, (2, 5, 3, C))
    np.testing.assert_allclose(npf(tm(torch.from_numpy(x))),
                               np.asarray(jm(jnp.asarray(x))), **F32)
    assert int(tm.num_batches_tracked) == 2  # eval leaves the buffers alone


def test_convert_sync_batchnorm_shares_state_keeps_mode_and_matches_jax():
    import jax.numpy as jnp
    from flax import nnx

    from tpu_syncbn import models as jmodels
    from tpu_syncbn import nn as jnn
    from tpu_syncbn_torch.models import load_jax_params
    from test_torch_resnet import flat_state

    kw = dict(num_classes=10, small_input=True, width=8)
    jm = jnn.convert_sync_batchnorm(jmodels.resnet18(rngs=nnx.Rngs(0), **kw))
    tm = models.resnet18(device="cpu", **kw)
    load_jax_params(tm, flat_state(jm))
    before = {k: v for k, v in tm.state_dict(keep_vars=True).items()}
    opt = torch.optim.SGD(tm.parameters(), lr=0.1)  # built before conversion
    tm.eval()
    conv = nn.convert_sync_batchnorm(tm)
    bns = [m for m in conv.modules() if isinstance(m, nn.BatchNorm)]
    assert len(bns) == 20 and all(type(m) is nn.SyncBatchNorm for m in bns)
    assert not conv.training and not any(m.training for m in bns)
    after = conv.state_dict(keep_vars=True)
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)  # shared, not copied
    assert opt.param_groups[0]["params"][0] is conv.stem_conv.weight

    x = rand(4, (4, 16, 16, 3))
    for train in (True, False):
        jm.train() if train else jm.eval()
        conv.train(train)
        np.testing.assert_allclose(npf(conv(torch.from_numpy(x))),
                                   np.asarray(jm(jnp.asarray(x))), **NET)


def test_plain_batchnorm_refuses_a_process_group():
    with pytest.raises(ValueError, match="does not sync"):
        nn.BatchNorm2d(C, process_group=object(), device="cpu")
    nn.SyncBatchNorm(C, process_group=None, device="cpu")  # accepted


def test_world1_and_eval_issue_no_collective(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a collective was issued")

    monkeypatch.setattr(tdist, "all_reduce", refuse)
    monkeypatch.setattr(tdist, "broadcast", refuse)
    bn = nn.SyncBatchNorm(C, device="cpu")
    x = torch.from_numpy(rand(5, (4, 5, 3, C))).requires_grad_()
    bn(x).sum().backward()  # world 1: plain BN, forward and backward
    bn.eval()
    bn(x)


# -- the golden invariant at world 2 over gloo ------------------------------


def _dp_loss(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y.long())


def _dp_run(images, labels, rank, world):
    """Two DataParallel steps of a SyncBN ResNet-18 (width 8) on this
    replica's slice of each global batch."""
    model = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=10, small_input=True, width=8, device="cpu"))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    dp = parallel.DataParallel(model, opt, _dp_loss, device="cpu")
    n = images.shape[1] // world
    losses = []
    for x, y in zip(images, labels):
        sl = slice(rank * n, (rank + 1) * n)
        losses.append(float(dp.train_step((x[sl], y[sl])).loss))
    out = {f"dp.{k}": npf(v) for k, v in model.state_dict().items()}
    out["dp_losses"] = np.asarray(losses)
    return out


def _bn_run(xa, xb, coeff, w, b, rank, world, sum_grads):
    """SyncBatchNorm: a training forward on ``xa`` (running stats), then
    forward + backward on ``xb``. γ/β gradients are local sums; the
    trainer's all-reduce (``sum_grads``) aggregates them, as DDP does."""
    n = xa.shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)
    bn = nn.SyncBatchNorm(C, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    bn(torch.from_numpy(xa[sl]))
    x = torch.from_numpy(xb[sl]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(coeff[sl])).sum().backward()
    gw, gb = sum_grads(bn.weight.grad), sum_grads(bn.bias.grad)
    return {"y": npf(y), "dx": npf(x.grad), "dw": npf(gw), "db": npf(gb),
            "running_mean": npf(bn.running_mean),
            "running_var": npf(bn.running_var),
            "nbt": np.asarray(int(bn.num_batches_tracked))}


def _world2_inputs():
    rs = np.random.RandomState(11)
    return dict(
        xa=rand(12, (WORLD * B, 5, 3, C)), xb=rand(13, (WORLD * B, 5, 3, C)),
        coeff=rs.randn(WORLD * B, 5, 3, C).astype(np.float32),
        w=rs.uniform(0.5, 1.5, C).astype(np.float32),
        b=rs.randn(C).astype(np.float32),
        images=rs.randn(2, WORLD * B, 8, 8, 3).astype(np.float32),
        labels=rs.randint(0, 10, (2, WORLD * B)).astype(np.int32),
    )


def _replica(rank, rdv, out_dir, inputs):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    try:
        def sum_grads(g):
            g = g.clone()
            tdist.all_reduce(g)
            return g

        out = _bn_run(inputs["xa"], inputs["xb"], inputs["coeff"],
                      inputs["w"], inputs["b"], rank, WORLD, sum_grads)
        out.update(_dp_run(inputs["images"], inputs["labels"], rank, WORLD))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Run both invariants' world-2 side once: two spawned gloo replicas,
    a file:// rendezvous, and a hard deadline so the suite cannot hang."""
    d = tmp_path_factory.mktemp("world2")
    inputs = _world2_inputs()
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_replica, args=(r, str(d / "rdv"), str(d), inputs))
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
    assert not alive, f"world-2 replicas still running after {JOIN_TIMEOUT_S}s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return inputs, ranks


def test_syncbn_two_replicas_equal_one_replica_of_the_whole_batch(world2):
    inputs, ranks = world2
    want = _bn_run(inputs["xa"], inputs["xb"], inputs["coeff"], inputs["w"],
                   inputs["b"], 0, 1, lambda g: g)
    for key in ("y", "dx"):  # per-row outputs: each replica holds its rows
        np.testing.assert_allclose(np.concatenate([r[key] for r in ranks]),
                                   want[key], err_msg=key, **F32)
    for r in ranks:  # per-channel state: identical on every replica
        for key in ("dw", "db", "running_mean", "running_var", "nbt"):
            np.testing.assert_allclose(r[key], want[key], err_msg=key, **F32)


def test_dataparallel_two_replicas_equal_one_replica_of_the_whole_batch(world2):
    inputs, ranks = world2
    want = _dp_run(inputs["images"], inputs["labels"], 0, 1)
    dp_keys = [k for k in want if k.startswith("dp")]
    assert len(dp_keys) > 100
    for r in ranks:
        for key in dp_keys:
            np.testing.assert_allclose(r[key], want[key], err_msg=key, **NET)


# -- torch's own BatchNorm as a second oracle -------------------------------


def torch_bn_oracle(inputs):
    """What ``_bn_run`` computes, by ``torch.nn.BatchNorm2d`` on the whole
    batch (NCHW views of the NHWC arrays): the port's world-N SyncBN must
    match it as it matches the JAX package."""
    bn = torch.nn.BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["w"]))
        bn.bias.copy_(torch.from_numpy(inputs["b"]))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    bn(nchw(inputs["xa"]))
    x = nchw(inputs["xb"]).detach().requires_grad_()
    y = bn(x)
    (y * nchw(inputs["coeff"])).sum().backward()
    nhwc = lambda t: npf(t.permute(0, 2, 3, 1))  # noqa: E731
    return {"y": nhwc(y), "dx": nhwc(x.grad), "dw": npf(bn.weight.grad),
            "db": npf(bn.bias.grad), "running_mean": npf(bn.running_mean),
            "running_var": npf(bn.running_var),
            "nbt": np.asarray(int(bn.num_batches_tracked))}


def check_against_torch_bn(inputs, ranks):
    want = torch_bn_oracle(inputs)
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([r[key] for r in ranks]),
                                   want[key], err_msg=key, **F32)
    for r in ranks:
        for key in ("dw", "db", "running_mean", "running_var", "nbt"):
            np.testing.assert_allclose(r[key], want[key], err_msg=key, **F32)


def test_syncbn_two_replicas_equal_torch_batchnorm2d_of_the_whole_batch(world2):
    check_against_torch_bn(*world2)
