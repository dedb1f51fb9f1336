"""The port's runtime and collectives: torchrun-environment initialization
at world 1 (no process group) and at world 2 over gloo on localhost, rank
identity, barrier, psum/pmean, reduce_moments with uneven and empty
shards and the masked sync_moments, against the JAX package's functions
on the whole batch.

Tolerance: f32 rtol 1e-5 / atol 1e-6 (sums split across replicas add in
another order)."""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch import runtime
from tpu_syncbn_torch.ops import batch_norm as bn_ops
from tpu_syncbn_torch.parallel import collectives

WORLD = 2
JOIN_TIMEOUT_S = 60
F32 = dict(rtol=1e-5, atol=1e-6)
# rank 0 holds 5 rows, rank 1 none: an uneven split with an empty shard
ROWS = {0: slice(0, 5), 1: slice(5, 5)}


def data():
    return (np.random.RandomState(0).randn(5, 4) * 2 + 1).astype(np.float32)


def masked_data():
    """(x, mask) of the whole batch: 2 replicas x (3, 2, 4), channel-last;
    replica 1's mask is all zero (an empty shard)."""
    rs = np.random.RandomState(1)
    x = rs.randn(6, 2, 4).astype(np.float32)
    mask = (rs.rand(6, 2, 1) > 0.3).astype(np.float32)
    mask[3:] = 0.0
    return x, mask


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _replica(rank, port, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    dev = runtime.initialize("cpu")
    try:
        out = {
            "device": np.array(str(dev)),
            "ident": np.array([runtime.process_index(), runtime.process_count(),
                               int(runtime.is_master())]),
        }
        runtime.barrier()
        t = torch.tensor([float(rank + 1), 10.0])
        out["psum"] = collectives.psum(t, tdist.group.WORLD).numpy()
        out["pmean"] = collectives.pmean(t, tdist.group.WORLD).numpy()
        out["untouched"] = t.numpy()
        x = torch.from_numpy(data()[ROWS[rank]])
        s, sq = x.sum(0), (x * x).sum(0)
        n = torch.tensor(float(x.shape[0]))
        mean, var, count = collectives.reduce_moments(s, sq, n, tdist.group.WORLD)
        out.update(mean=mean.numpy(), var=var.numpy(), count=count.numpy())
        xm, mask = (torch.from_numpy(a[3 * rank:3 * rank + 3]) for a in masked_data())
        m_mean, m_var, m_count = bn_ops.sync_moments(
            xm, process_group=tdist.group.WORLD, mask=mask)
        out.update(m_mean=m_mean.numpy(), m_var=m_var.numpy(),
                   m_count=m_count.numpy())
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        runtime.shutdown()


def test_world2_initialize_identity_and_collectives(tmp_path):
    ctx = tmp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_replica, args=(r, port, str(tmp_path)))
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

    from tpu_syncbn.ops.batch_norm import sync_moments
    from tpu_syncbn.parallel.collectives import moments_from_stats

    x = data()
    jmean, jvar = moments_from_stats(x.sum(0), (x * x).sum(0), np.float32(5))
    xm, mask = masked_data()
    jm_mean, jm_var, jm_count = sync_moments(xm, mask=mask)
    for rank in range(WORLD):
        r = np.load(tmp_path / f"rank{rank}.npz")
        assert str(r["device"]) == "cpu"
        assert r["ident"].tolist() == [rank, WORLD, int(rank == 0)]
        np.testing.assert_array_equal(r["psum"], [3.0, 20.0])
        np.testing.assert_array_equal(r["pmean"], [1.5, 10.0])
        np.testing.assert_array_equal(r["untouched"], [rank + 1.0, 10.0])
        assert float(r["count"]) == 5.0
        np.testing.assert_allclose(r["mean"], np.asarray(jmean), **F32)
        np.testing.assert_allclose(r["var"], np.asarray(jvar), **F32)
        # masked moments across replicas, one replica's shard empty
        np.testing.assert_allclose(r["m_mean"], np.asarray(jm_mean), **F32)
        np.testing.assert_allclose(r["m_var"], np.asarray(jm_var), **F32)
        np.testing.assert_array_equal(r["m_count"], np.asarray(jm_count))


def _sync_replica(rank, port, out_dir):
    """Each rank builds its model from its own seed; after
    ``sync_module_states(model)`` (default group) every rank holds rank
    0's parameters and buffers."""
    from tpu_syncbn_torch import models, nn, parallel

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    runtime.initialize("cpu")
    try:
        model = nn.convert_sync_batchnorm(models.resnet18(
            num_classes=3, width=4, device="cpu",
            generator=torch.Generator().manual_seed(rank)))
        with torch.no_grad():
            for b in model.buffers():
                b.fill_(rank + 1)
        parallel.sync_module_states(model)
        np.savez(os.path.join(out_dir, f"sync{rank}.npz"),
                 **{k: v.numpy() for k, v in model.state_dict().items()})
    finally:
        runtime.shutdown()


def test_sync_module_states_at_world_1_and_2(tmp_path, monkeypatch):
    from tpu_syncbn_torch import models, parallel

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    runtime.initialize("cpu")  # world 1: no group, nothing moves
    model = models.resnet18(num_classes=3, width=4, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    parallel.sync_module_states(model)
    parallel.sync_module_states(model, 0, group=None)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())

    ctx = tmp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_sync_replica, args=(r, port, str(tmp_path)))
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
    r0, r1 = (np.load(tmp_path / f"sync{r}.npz") for r in range(WORLD))
    own0 = models.resnet18(num_classes=3, width=4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert sorted(r0.files) == sorted(r1.files)
    for k in r0.files:
        np.testing.assert_array_equal(r1[k], r0[k])
    # rank 0's own weights, and rank 0's buffers (all 1), won
    np.testing.assert_array_equal(r1["fc.weight"], own0.fc.weight.detach().numpy())
    assert (r1["stem_bn.running_mean"] == 1).all()


def test_world1_initialize_makes_no_process_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert runtime.initialize("cpu") == torch.device("cpu")
    assert not runtime.is_initialized()
    assert (runtime.process_index(), runtime.process_count()) == (0, 1)
    assert runtime.is_master()
    runtime.barrier()  # no-op at world 1
    t = torch.arange(3.0)
    assert collectives.psum(t, None) is t and collectives.pmean(t, None) is t
    with pytest.raises(ValueError, match="unsupported device"):
        runtime.resolve_device("mps")


def test_moments_from_stats_matches_jax_including_empty_and_cancelling():
    from tpu_syncbn.parallel.collectives import moments_from_stats as jmoments

    s = np.array([3.0, 0.0, 1e4], np.float32)
    sq = np.array([5.0, 0.0, 1e8], np.float32)  # last: sq/n and mean² cancel
    for n in (np.float32(0), np.float32(1), np.float32(2)):
        jm, jv = jmoments(s, sq, n)
        tm, tv = collectives.moments_from_stats(
            torch.from_numpy(s), torch.from_numpy(sq), torch.tensor(n))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **F32)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)
        assert (tv >= 0).all()


def test_master_print_and_logger_on_rank0(capsys):
    runtime.master_print("hello", 1)
    assert capsys.readouterr().out == "hello 1\n"
    log = runtime.get_logger("tpu_syncbn_torch.test")
    assert log is runtime.get_logger("tpu_syncbn_torch.test")
    assert log.isEnabledFor(20)
