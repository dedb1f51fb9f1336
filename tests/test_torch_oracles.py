"""Second oracles for the port's BatchNorm, independent of the JAX package:

* ``torch.nn.functional.batch_norm`` against ``ops.batch_norm_train`` and
  ``ops.batch_norm_inference`` at world 1 (outputs, running statistics
  and gradients; channel-last and NCHW layouts);
* at world 8 over gloo, ``SyncBatchNorm`` against ``torch.nn.BatchNorm2d``
  on the whole batch (world 2: tests/test_torch_syncbn.py);
* the golden invariant at world 8: 8 replicas of one row each compute what
  one replica of all 8 rows does, for SyncBatchNorm alone and for
  DataParallel training of a SyncBN ResNet-18 (world 2:
  tests/test_torch_syncbn.py, whose helpers and inputs this reuses).

One world-8 spawn, shared by the module. Tolerances as
tests/test_torch_syncbn.py: f32 rtol 1e-5 / atol 1e-5; the ResNet
trajectories rtol 2e-4 / atol 1e-5.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp
import torch.nn.functional as F

from test_torch_syncbn import (
    F32,
    NET,
    _bn_run,
    _dp_run,
    _world2_inputs,
    check_against_torch_bn,
)
from tpu_syncbn_torch.ops import batch_norm as bn_ops

WORLD = 8
JOIN_TIMEOUT_S = 150


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("affine", [True, False])
def test_batch_norm_train_and_inference_match_f_batch_norm(layout, affine):
    rs = np.random.RandomState(3)
    c = 5
    x_nchw = torch.from_numpy((rs.randn(6, c, 4, 3) * 2 + 0.5).astype(np.float32))
    coeff = torch.from_numpy(rs.randn(6, c, 4, 3).astype(np.float32))
    w = torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(np.float32)) if affine else None
    b = torch.from_numpy(rs.randn(c).astype(np.float32)) if affine else None
    rm0 = torch.from_numpy(rs.randn(c).astype(np.float32))
    rv0 = torch.from_numpy(rs.uniform(0.5, 2, c).astype(np.float32))
    to = (lambda t: t.permute(0, 2, 3, 1)) if layout == "nhwc" else (lambda t: t)
    axis = -1 if layout == "nhwc" else 1

    def grads(x, y, *params):
        ps = [p for p in params if p is not None]
        return torch.autograd.grad((y * to(coeff)).sum(), [x, *ps])

    # training: F.batch_norm updates its buffers in place
    rm, rv = rm0.clone(), rv0.clone()
    xr = x_nchw.clone().requires_grad_()
    wr = w.clone().requires_grad_() if affine else None
    br = b.clone().requires_grad_() if affine else None
    y_ref = F.batch_norm(xr, rm, rv, wr, br, training=True, momentum=0.1, eps=1e-5)
    g_ref = grads(xr, to(y_ref), wr, br)

    xp = to(x_nchw.clone()).detach().requires_grad_()
    wp = w.clone().requires_grad_() if affine else None
    bp = b.clone().requires_grad_() if affine else None
    y, (nrm, nrv, nbt) = bn_ops.batch_norm_train(
        xp, rm0.clone(), rv0.clone(), torch.zeros((), dtype=torch.long), wp, bp,
        momentum=0.1, eps=1e-5, channel_axis=axis)
    g = grads(xp, y, wp, bp)
    np.testing.assert_allclose(y.detach().numpy(), to(y_ref).detach().numpy(), **F32)
    np.testing.assert_allclose(nrm.numpy(), rm.numpy(), **F32)
    np.testing.assert_allclose(nrv.numpy(), rv.numpy(), **F32)
    assert int(nbt) == 1
    np.testing.assert_allclose(g[0].numpy(), to(g_ref[0]).numpy(), **F32)
    for a, r in zip(g[1:], g_ref[1:]):
        np.testing.assert_allclose(a.numpy(), r.numpy(), **F32)

    # inference: the running statistics, no update
    y_inf = bn_ops.batch_norm_inference(to(x_nchw), rm0, rv0, w, b, eps=1e-5,
                                        channel_axis=axis)
    y_inf_ref = F.batch_norm(x_nchw, rm0.clone(), rv0.clone(), w, b, training=False,
                             eps=1e-5)
    np.testing.assert_allclose(y_inf.numpy(), to(y_inf_ref).numpy(), **F32)


def _replica(rank, rdv, out_dir, inputs):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    try:
        def sum_grads(g):
            g = g.clone()
            tdist.all_reduce(g)
            return g

        out = _bn_run(inputs["xa"], inputs["xb"], inputs["coeff"], inputs["w"],
                      inputs["b"], rank, WORLD, sum_grads)
        out.update(_dp_run(inputs["images"], inputs["labels"], rank, WORLD))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """Eight spawned gloo replicas, a file:// rendezvous and a hard
    deadline, so the suite cannot hang."""
    d = tmp_path_factory.mktemp("world8")
    inputs = _world2_inputs()
    assert inputs["xa"].shape[0] == WORLD  # one row a replica
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
    assert not alive, f"world-8 replicas still running after {JOIN_TIMEOUT_S}s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return inputs, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def test_syncbn_eight_replicas_equal_torch_batchnorm2d_of_the_whole_batch(world8):
    check_against_torch_bn(*world8)


def test_syncbn_eight_replicas_equal_one_replica_of_the_whole_batch(world8):
    inputs, ranks = world8
    want = _bn_run(inputs["xa"], inputs["xb"], inputs["coeff"], inputs["w"],
                   inputs["b"], 0, 1, lambda g: g)
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([r[key] for r in ranks]),
                                   want[key], err_msg=key, **F32)
    for r in ranks:
        for key in ("dw", "db", "running_mean", "running_var", "nbt"):
            np.testing.assert_allclose(r[key], want[key], err_msg=key, **F32)


def test_dataparallel_eight_replicas_equal_one_replica_of_the_whole_batch(world8):
    inputs, ranks = world8
    want = _dp_run(inputs["images"], inputs["labels"], 0, 1)
    dp_keys = [k for k in want if k.startswith("dp")]
    assert len(dp_keys) > 100
    for r in ranks:
        for key in dp_keys:
            np.testing.assert_allclose(r[key], want[key], err_msg=key, **NET)
