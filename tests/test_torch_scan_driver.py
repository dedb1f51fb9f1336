"""The fused K-step driver (``tpu_syncbn_torch.parallel.scan_driver``) and
the trainers' K-step entry points against ``tpu_syncbn``'s
(tests/test_scan_driver.py), from the same weights on the same numpy
batches. On the CPU the K-step body runs K times eagerly — the very body a
CUDA graph records on the card — so these tests pin the captured
arithmetic; capture and replay are held on the card by chip_smoke.py's
``[scan]`` phase and the ``gpu`` tests.

* ``ProgramCache`` / ``cached_program``: LRU with hit, miss and eviction
  accounting, the byte budget, a stored ``None`` rebuilt, the plain-dict
  FIFO branch.
* ``_ChunkOptimizer``: the ``_foreach`` SGD update against
  ``torch.optim.SGD.step`` (momentum, dampening with its undamped first
  step, Nesterov, weight decay, maximize) at one ulp; Adam exactly.
* ``DataParallel.train_steps_batches`` at K = 3 against JAX's at world 1
  and at world 2 (gloo against the 2-device mesh); a NaN in the middle of
  a chunk under ``skip_step`` and ``halve_lr``; a schedule that moves the
  lr every step (with a skipped step holding it); a shorter last chunk;
  ``train_steps`` on one batch; the chunk left unmodified.
* ``GANTrainer.train_steps`` against JAX's (losses at JAX's own
  scan-against-steps tolerance, rtol 1e-5 / atol 1e-6), and bit for bit
  against the port's own K iterations.
* Against the port's own eager loop: K ``train_step`` calls (accum 2,
  remat, the guard).

Tolerances: losses rtol 1e-5; parameters and buffers rtol 2e-4 / atol
1e-5, as tests/test_torch_trainer.py, also for the port's chunk against
its own steps (the chunk's SGD multiplies by the lr tensor before adding,
where torch adds with a Python ``alpha``: one rounding a step, which
three steps of BN at initialization grow to ~3e-6); the GAN's Adam chunk
against its own iterations exactly (on the CPU Adam takes the tensor lr
as its own float).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from test_torch_accum_remat import (
    BATCH,
    LR,
    NET,
    WORLD,
    _ce,
    assert_state_matches,
    host_batches,
    port_resnet,
    spawn_world2,
)
from tpu_syncbn_torch import nn, parallel
from tpu_syncbn_torch.parallel import scan_driver
from tpu_syncbn_torch.parallel.trainer import _ChunkOptimizer

# -- ProgramCache / cached_program ---------------------------------------------


def test_program_cache_is_lru_with_accounting():
    cache = scan_driver.ProgramCache(name="t", max_entries=2)
    built = []

    def build(key):
        built.append(key)
        return f"prog-{key}"

    get = lambda k: scan_driver.cached_program(cache, k, lambda: build(k))  # noqa: E731
    assert get("a") == "prog-a" and get("b") == "prog-b"
    assert get("a") == "prog-a"  # a hit moves "a" to the back
    get("c")  # evicts the least recently used: "b", not "a"
    assert list(cache) == ["a", "c"] and built == ["a", "b", "c"]
    assert cache.stats() == {"live": 2, "hits": 1, "misses": 3, "evictions": 1,
                             "bytes_live": 0, "max_bytes": None}
    with pytest.raises(ValueError, match="max_entries"):
        scan_driver.ProgramCache(max_entries=0)
    with pytest.raises(ValueError, match="max_bytes"):
        scan_driver.ProgramCache(max_bytes=0)


def test_program_cache_byte_budget_and_set_max_bytes():
    cache = scan_driver.ProgramCache(max_entries=8, max_bytes=100)
    for k, size in (("a", 40), ("b", 40), ("c", 40)):
        scan_driver.cached_program(cache, k, lambda k=k: k, size_of=lambda _, s=size: s)
    assert list(cache) == ["b", "c"] and cache.bytes_live == 80
    # an oversized program still runs; everything older goes
    scan_driver.cached_program(cache, "big", lambda: "big", size_of=lambda _: 500)
    assert list(cache) == ["big"] and cache.evictions == 3
    # a raising or None size hook leaves the entry unsized (the budget
    # then squeezes "big" out)
    scan_driver.cached_program(cache, "x", lambda: "x", size_of=lambda _: 1 / 0)
    scan_driver.cached_program(cache, "y", lambda: "y", size_of=lambda _: None)
    assert list(cache) == ["x", "y"] and cache.bytes_live == 0
    assert cache.set_max_bytes(None) == cache.bytes_live
    cache.clear()
    assert cache.bytes_live == 0 and not cache._sizes
    with pytest.raises(ValueError, match="max_bytes"):
        cache.set_max_bytes(0)


def test_live_cache_bytes_sums_every_live_cache():
    before = scan_driver.live_cache_bytes()
    a = scan_driver.ProgramCache()
    scan_driver.cached_program(a, 1, lambda: 1, size_of=lambda _: 1000)
    assert scan_driver.live_cache_bytes() == before + 1000
    del a
    import gc

    gc.collect()
    assert scan_driver.live_cache_bytes() == before


@pytest.mark.parametrize("kind", ["program_cache", "dict"])
def test_a_stored_none_is_rebuilt(kind):
    cache = scan_driver.ProgramCache() if kind == "program_cache" else {}
    dict.__setitem__(cache, "k", None)
    assert scan_driver.cached_program(cache, "k", lambda: "fresh") == "fresh"
    assert scan_driver.cached_program(cache, "k", lambda: "again") == "fresh"


def test_plain_dict_cache_is_fifo_at_the_bound():
    cache: dict = {}
    for k in range(scan_driver.MAX_CACHED_PROGRAMS + 1):
        scan_driver.cached_program(cache, k, lambda k=k: k)
    scan_driver.cached_program(cache, 1, lambda: "rebuilt")  # a hit: no refresh
    assert list(cache) == list(range(1, scan_driver.MAX_CACHED_PROGRAMS + 1))


def test_stack_batches_and_scan_length():
    bs = [{"x": np.full((2, 3), i, np.float32), "y": (np.arange(2) + i,)} for i in range(3)]
    st = scan_driver.stack_batches(bs)
    assert st["x"].shape == (3, 2, 3) and st["y"][0].shape == (3, 2)
    assert scan_driver.scan_length(st) == 3
    bs[0]["x"][:] = 7  # a copy: the sources may be recycled
    assert float(st["x"][0, 0, 0]) == 0.0
    ts = scan_driver.stack_batches([(torch.ones(2), torch.zeros(2, dtype=torch.int64))] * 4)
    assert ts[0].shape == (4, 2) and ts[1].dtype == torch.int64
    with pytest.raises(ValueError):
        scan_driver.stack_batches([])
    with pytest.raises(ValueError):
        scan_driver.scan_length({"n": 3})


@pytest.mark.parametrize("stacked", [True, False])
def test_build_scan_steps_runs_the_body_k_times_on_the_cpu(stacked):
    w = torch.zeros(())
    seen = []

    def body(k, batch):
        seen.append((k, batch.clone()))
        w.add_(batch.sum())
        return {"w": w.clone(), "k": torch.tensor(float(k))}

    batch = torch.arange(6.0).view(3, 2) if stacked else torch.ones(2)
    keep = batch.clone()
    prog = scan_driver.build_scan_steps(body, n_steps=3, stacked=stacked,
                                        device="cpu", state=lambda: [w])
    out = prog(batch)
    assert prog.prepare(batch) is prog and prog.graph is None  # no capture here
    assert torch.equal(out["k"], torch.tensor([0.0, 1.0, 2.0]))
    want = torch.cumsum(batch.sum(1) if stacked else torch.full((3,), 2.0), 0)
    assert torch.equal(out["w"], want)
    assert [k for k, _ in seen] == [0, 1, 2]
    if stacked:
        assert all(torch.equal(b, batch[k]) for k, b in seen)
    assert torch.equal(batch, keep) and not prog.stale()
    with pytest.raises(ValueError, match="n_steps"):
        scan_driver.build_scan_steps(body, n_steps=0, stacked=True, device="cpu",
                                     state=lambda: [])


# -- the chunk optimizer against torch.optim -----------------------------------


def _one_rounding(got, want, *terms) -> bool:
    """|got - want| within one float32 rounding of the operands the two
    round differently (2^-23 of their magnitude, elementwise)."""
    bound = 2.0 ** -23 * sum(t.abs() for t in terms)
    return bool(((got - want).abs() <= bound).all())


SGD_CASES = [
    dict(momentum=0.0),
    dict(momentum=0.9),
    dict(momentum=0.9, nesterov=True, weight_decay=1e-4),
    dict(momentum=0.9, dampening=0.3),
    dict(momentum=0.5, dampening=0.1, weight_decay=1e-2, maximize=True),
]


@pytest.mark.parametrize("cfg", SGD_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_chunk_sgd_matches_torch_sgd_step_within_one_rounding(cfg):
    """Three updates from the same parameters and gradients: the
    ``_foreach`` update with a tensor lr against ``torch.optim.SGD.step``.
    The chunk rounds ``lr · d`` before adding it, where torch adds it with
    an ``alpha`` (and the damped buffer update alike), so each result is
    within one rounding of torch's (exactly equal where that rounding
    makes no difference); the first step is torch's undamped one."""
    rs = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    ref = [torch.nn.Parameter(torch.from_numpy(rs.randn(*s).astype(np.float32)))
           for s in shapes]
    ours = [torch.nn.Parameter(p.detach().clone()) for p in ref]
    lr = 0.05
    opt_ref = torch.optim.SGD(ref, lr=lr, **cfg)
    opt = torch.optim.SGD(ours, lr=lr, **cfg)
    chunk = _ChunkOptimizer(opt, 3, torch.device("cpu"), None)
    exact = 0
    for step in range(3):
        grads = [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in shapes]
        before = [p.detach().clone() for p in ref]
        for p, q, g in zip(ref, ours, grads):
            p.grad, q.grad = g.clone(), g.clone()
            q.data.copy_(p.data)  # each update from the same parameters
        opt_ref.step()
        chunk.step(torch.tensor([lr], dtype=torch.float32))
        for p, q, b, g in zip(ref, ours, before, grads):
            assert _one_rounding(q.data, p.data, b, p.data), (step, cfg)
            exact += int(torch.equal(q.data, p.data))
            if cfg["momentum"]:
                b_ref = opt_ref.state[p]["momentum_buffer"]
                b_ours = opt.state[q]["momentum_buffer"]
                assert _one_rounding(b_ours, b_ref, g, b_ref), (step, cfg)
                if step == 0:  # the first step: the buffer is the gradient
                    want = -g if cfg.get("maximize") else g
                    if not cfg.get("weight_decay"):
                        assert torch.equal(b_ours, want)
                b_ours.copy_(b_ref)
    assert exact >= 1  # most elements agree bit for bit


@pytest.mark.parametrize("amsgrad", [False, True])
def test_chunk_adam_matches_torch_adam_step(amsgrad):
    rs = np.random.RandomState(1)
    ref = [torch.nn.Parameter(torch.from_numpy(rs.randn(4, 3).astype(np.float32)))]
    ours = [torch.nn.Parameter(ref[0].detach().clone())]
    opt_ref = torch.optim.AdamW(ref, lr=1e-2, amsgrad=amsgrad)
    opt = torch.optim.AdamW(ours, lr=1e-2, amsgrad=amsgrad)
    chunk = _ChunkOptimizer(opt, 3, torch.device("cpu"), None)
    for _ in range(3):
        g = torch.from_numpy(rs.randn(4, 3).astype(np.float32))
        ref[0].grad, ours[0].grad = g.clone(), g.clone()
        opt_ref.step()
        chunk.step(torch.tensor([1e-2], dtype=torch.float32))
    assert torch.equal(ref[0].data, ours[0].data)
    assert opt.param_groups[0]["lr"] == 1e-2  # the float lr is put back
    for k, v in opt_ref.state[ref[0]].items():
        assert torch.equal(v, opt.state[ours[0]][k]), k


def test_other_optimizers_and_plateau_schedules_raise():
    m = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="RMSprop"):
        _ChunkOptimizer(torch.optim.RMSprop(m.parameters()), 2, torch.device("cpu"), None)
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    dp = parallel.DataParallel(m, opt, lambda mod, b: mod(b).sum(), device="cpu",
                               lr_scheduler=torch.optim.lr_scheduler.ReduceLROnPlateau(opt))
    with pytest.raises(ValueError, match="ReduceLROnPlateau"):
        dp.train_steps(torch.ones(3, 2), 2)
    with pytest.raises(ValueError, match="n_steps"):
        dp.train_steps(torch.ones(3, 2), 0)


def test_cuda_tensors_under_a_gloo_group_raise(monkeypatch):
    """On the card at world > 1 only NCCL's collectives can run inside a
    graph: a gloo group raises, naming the backend, instead of looping
    eagerly (both trainers call this check before building a program)."""
    from tpu_syncbn_torch.parallel.trainer import _check_capturable

    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(tdist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(RuntimeError, match="gloo"):
        _check_capturable(cuda, 2, None)
    _check_capturable(cuda, 1, None)  # world 1 holds no collective
    _check_capturable(torch.device("cpu"), 2, None)  # the CPU loops eagerly
    monkeypatch.setattr(tdist, "get_backend", lambda group=None: "nccl")
    _check_capturable(cuda, 2, None)


# -- against the port's own eager loop -----------------------------------------


def _sched_trainer(init, **kw):
    model = port_resnet(init)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9, nesterov=True,
                          weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda e: 0.8 ** e)
    return model, parallel.DataParallel(model, opt, _ce, device="cpu",
                                        lr_scheduler=sched, **kw)


def _resnet_init():
    import test_torch_accum_remat as acc

    return acc.jax_trajectory(1, "off", [])[0]


@pytest.fixture(scope="module")
def resnet_init():
    return _resnet_init()


def _tensor_batches(batches):
    return [tuple(torch.from_numpy(np.asarray(a)) for a in b) for b in batches]


@pytest.mark.parametrize("kw", [dict(accum_steps=2), dict(remat=True),
                                dict(divergence_guard="halve_lr")],
                         ids=["accum2", "remat", "halve_lr"])
def test_chunk_equals_k_train_steps(resnet_init, kw):
    batches = _tensor_batches(host_batches())
    if "divergence_guard" in kw:
        batches[1] = (torch.full_like(batches[1][0], float("nan")), batches[1][1])
    m1, d1 = _sched_trainer(resnet_init, **kw)
    outs = [d1.train_step(b) for b in batches]
    m2, d2 = _sched_trainer(resnet_init, **kw)
    out = d2.train_steps_batches(scan_driver.stack_batches(batches))
    np.testing.assert_allclose(out.loss.numpy(), [float(o.loss) for o in outs],
                               rtol=1e-5)
    for k in outs[0].metrics:
        np.testing.assert_array_equal(out.metrics[k].numpy(),
                                      [float(o.metrics[k]) for o in outs])
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), err_msg=k, **NET)
    assert d1.lr_scheduler.last_epoch == d2.lr_scheduler.last_epoch
    assert d1.guard_state == d2.guard_state
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        b1 = d1.optimizer.state[p1]["momentum_buffer"]
        np.testing.assert_allclose(d2.optimizer.state[p2]["momentum_buffer"].numpy(),
                                   b1.numpy(), **NET)


# -- against JAX -----------------------------------------------------------------


def _jax_stage(dp, batches):
    import jax

    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *batches)
    return jax.device_put(stacked, dp.scan_batch_sharding)


def jax_resnet_chunks(n_devices, chunks, repeat=None):
    """JAX's ResNet-18 (width 8) DataParallel over ``chunks`` (lists of
    global batches) with ``train_steps_batches`` (or ``train_steps(batch,
    repeat)``): initial weights, losses, final state, cache keys."""
    import optax
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import models as jmodels
    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime

    def loss_fn(m, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(m(x), y).mean()

    model = jnn.convert_sync_batchnorm(jmodels.resnet18(
        num_classes=10, small_input=True, width=8, rngs=nnx.Rngs(0)))
    init = flat_state(model)
    dp = jparallel.DataParallel(model, optax.sgd(LR, momentum=0.9), loss_fn,
                                mesh=jruntime.data_parallel_mesh(n_devices), donate=False)
    losses = []
    for c in chunks:
        if repeat:
            import jax.numpy as jnp

            out = dp.train_steps(tuple(map(jnp.asarray, c[0])), repeat)
        else:
            out = dp.train_steps_batches(_jax_stage(dp, c))
        losses += [float(v) for v in np.asarray(out.loss)]
    return init, losses, flat_state(dp.sync_to_model()), list(dp._train_steps_cache)


def port_resnet_chunks(init, chunks, rank=0, world=1, repeat=None):
    model = port_resnet(init)
    dp = parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=LR,
                                                      momentum=0.9), _ce, device="cpu")
    n = BATCH // world
    losses = []
    for c in chunks:
        shards = [tuple(np.asarray(a)[rank * n:(rank + 1) * n] for a in b) for b in c]
        if repeat:
            out = dp.train_steps(shards[0], repeat)
        else:
            out = dp.train_steps_batches(scan_driver.stack_batches(shards))
        losses += out.loss.tolist()
    state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return losses, state, dp


def test_train_steps_batches_world1_matches_jax():
    batches = host_batches()
    init, jlosses, jstate, _ = jax_resnet_chunks(1, [batches])
    losses, state, dp = port_resnet_chunks(init, [batches])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert len(set(np.round(losses, 4))) == 3  # the model moved
    assert int(state["stem_bn.num_batches_tracked"]) == 3
    assert_state_matches(state, jstate)
    (key,) = dp.program_caches[0]
    assert key[:2] == (3, True)


def test_train_steps_on_one_batch_matches_jax():
    batches = host_batches()[:1]
    init, jlosses, jstate, jkeys = jax_resnet_chunks(1, [batches], repeat=3)
    losses, state, dp = port_resnet_chunks(init, [batches], repeat=3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert_state_matches(state, jstate)
    assert jkeys == [3] and [k[:2] for k in dp.program_caches[0]] == [(3, False)]


def test_shorter_last_chunk_builds_its_own_program_and_matches_jax():
    batches = host_batches()
    chunks = [batches[:2], batches[2:]]
    init, jlosses, jstate, jkeys = jax_resnet_chunks(1, chunks)
    losses, state, dp = port_resnet_chunks(init, chunks)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert_state_matches(state, jstate)
    assert sorted(jkeys) == [(1, True), (2, True)]
    assert sorted(k[:2] for k in dp.program_caches[0]) == [(1, True), (2, True)]


def _chunk_replica(rank, rdv, out_dir, init, batches):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    try:
        losses, state, _ = port_resnet_chunks(init, [batches], rank, WORLD)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 losses=np.asarray(losses), **state)
    finally:
        tdist.destroy_process_group()


def test_train_steps_batches_world2_over_gloo_matches_jax_mesh2(tmp_path):
    """gloo on the CPU runs the eager K-step loop: the collectives inside
    each step are the ones a graph would hold under NCCL."""
    batches = host_batches()
    init, jlosses, jstate, _ = jax_resnet_chunks(2, [batches])
    ranks = spawn_world2(_chunk_replica, tmp_path, init, batches)
    for r in ranks:
        np.testing.assert_allclose(r.pop("losses"), jlosses, rtol=1e-5)
        assert_state_matches(r, jstate)


def test_the_chunk_is_left_unmodified_and_can_run_again(resnet_init):
    batches = _tensor_batches(host_batches())
    chunk = scan_driver.stack_batches(batches)
    keep = tuple(t.clone() for t in chunk)
    _, dp = _sched_trainer(resnet_init)
    dp.train_steps_batches(chunk)
    out = dp.train_steps_batches(chunk)
    assert all(torch.equal(a, b) for a, b in zip(chunk, keep))
    assert bool(torch.isfinite(out.loss).all())
    assert dp.program_caches[0].stats()["hits"] == 1


# -- the guard and the schedule inside a chunk, against JAX -----------------------


TINY_LR = 0.05


class TinyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 4)
        self.bn = nn.BatchNorm1d(4, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def _mse(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def tiny_batches(n, nan_at=None):
    rs = np.random.RandomState(3)
    out = []
    for i in range(n):
        x = rs.randn(16, 4).astype(np.float32)
        if i == nan_at:
            x[:] = np.nan
        out.append((x, rs.randn(16, 4).astype(np.float32)))
    return out


def jax_tiny_chunk(policy, batches, schedule=None):
    """JAX's TinyNet trainer (SGD 0.05 or ``schedule``, momentum 0.9),
    one ``train_steps_batches`` over ``batches``."""
    import jax
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
    lr = TINY_LR if schedule is None else (lambda c: TINY_LR * 0.8 ** c)
    dp = jparallel.DataParallel(model, optax.sgd(lr, momentum=0.9), loss_fn,
                                mesh=jruntime.data_parallel_mesh(1), donate=False,
                                divergence_guard=policy)
    out = dp.train_steps_batches(_jax_stage(dp, batches))
    guard = jax.device_get(dp.opt_state[1]) if policy else None
    return (init, np.asarray(out.loss), jax.device_get(out.metrics),
            flat_state(dp.sync_to_model()), guard)


def port_tiny_chunk(init, policy, batches, schedule=False):
    from tpu_syncbn_torch import models

    model = nn.convert_sync_batchnorm(TinyNet())
    models.load_jax_params(model, init)
    opt = torch.optim.SGD(model.parameters(), lr=TINY_LR, momentum=0.9)
    sched = (torch.optim.lr_scheduler.LambdaLR(opt, lambda e: 0.8 ** e)
             if schedule else None)
    dp = parallel.DataParallel(model, opt, _mse, device="cpu", divergence_guard=policy,
                               lr_scheduler=sched)
    out = dp.train_steps_batches(scan_driver.stack_batches(batches))
    return model, dp, out


def _assert_tiny_matches(model, jstate):
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for key, want in jstate.items():
        name = key.replace(".kernel", ".weight")
        g = got[name].T if key.endswith(".kernel") else got[name]
        np.testing.assert_allclose(g, want, err_msg=key, **NET)


@pytest.mark.parametrize("policy", ["skip_step", "halve_lr"])
def test_nan_in_the_middle_of_a_chunk_matches_jax(policy):
    batches = tiny_batches(3, nan_at=1)
    init, jlosses, jmetrics, jstate, jguard = jax_tiny_chunk(policy, batches)
    model, dp, out = port_tiny_chunk(init, policy, batches)
    np.testing.assert_array_equal(out.metrics["nonfinite"].numpy(), [0.0, 1.0, 0.0])
    np.testing.assert_array_equal(out.metrics["nonfinite"].numpy(), jmetrics["nonfinite"])
    np.testing.assert_array_equal(out.metrics["lr_scale"].numpy(), jmetrics["lr_scale"])
    np.testing.assert_allclose(out.loss.numpy(), jlosses, rtol=1e-5)
    assert np.isnan(out.loss[1])
    _assert_tiny_matches(model, jstate)
    assert dp.guard_state["nonfinite_count"] == int(jguard["nonfinite_count"]) == 1
    assert dp.guard_state["lr_scale"] == float(jguard["lr_scale"])
    assert dp.guard_state["lr_scale"] == (0.5 if policy == "halve_lr" else 1.0)
    assert int(model.bn.num_batches_tracked) == 2  # the skip restored it


@pytest.mark.parametrize("nan_at", [None, 2])
def test_a_schedule_moving_every_step_inside_the_chunk_matches_jax(nan_at):
    """lr = 0.05 · 0.8^count at every step of one chunk of 4: optax's
    schedule in JAX, ``LambdaLR`` here. A skipped step holds the count
    (JAX rolls it back with the optimizer state; the port steps the
    scheduler only for the steps taken)."""
    batches = tiny_batches(4, nan_at=nan_at)
    policy = "skip_step" if nan_at is not None else None
    init, jlosses, _, jstate, _ = jax_tiny_chunk(policy, batches, schedule=True)
    model, dp, out = port_tiny_chunk(init, policy, batches, schedule=True)
    np.testing.assert_allclose(out.loss.numpy(), jlosses, rtol=1e-5)
    _assert_tiny_matches(model, jstate)
    taken = 4 if nan_at is None else 3
    assert dp.lr_scheduler.last_epoch == taken
    assert dp.optimizer.param_groups[0]["lr"] == pytest.approx(TINY_LR * 0.8 ** taken)


# -- GANTrainer.train_steps against JAX ------------------------------------------


@pytest.mark.parametrize("arch", ["dcgan", "sngan"])
def test_gan_train_steps_matches_jax(arch):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import test_torch_gan_trainer as tg

    data = tg.host_data(tg.ITERS)
    init, jouts, jfinal, _ = tg.jax_run(arch, 1, "off", [])
    # JAX's fused K-iteration program on the same weights
    import optax
    from flax import nnx

    from tpu_syncbn import nn as jnn
    from tpu_syncbn import parallel as jparallel
    from tpu_syncbn import runtime as jruntime
    from tpu_syncbn.models import gan as jgan

    G = jgan.DCGANGenerator(latent_dim=tg.LATENT, width=16, rngs=nnx.Rngs(0))
    Dcls = jgan.DCGANDiscriminator if arch == "dcgan" else jgan.SNGANDiscriminator
    D = Dcls(width=8, rngs=nnx.Rngs(1))
    jnn.convert_sync_batchnorm(G)
    jnn.convert_sync_batchnorm(D)
    adam = optax.adam(tg.LR, b1=0.5, b2=0.999, eps=tg.EPS)
    jtr = jparallel.GANTrainer(G, D, adam, adam, loss=tg.ARCHS[arch],
                               mesh=jruntime.data_parallel_mesh(1), donate=False,
                               monitors=False)
    sh = NamedSharding(jtr.mesh, scan_driver_spec(P(jtr.axis_name)))
    stacked = [np.stack(a) for a in zip(*data)]
    jo = jtr.train_steps(*(jax.device_put(a, sh) for a in stacked))
    G2, D2 = jtr.sync_to_models()
    from test_torch_resnet import flat_state

    jfinal = (flat_state(G2), flat_state(D2))

    tr = tg.port_trainer(arch, init)
    o = tr.train_steps(*stacked)
    # JAX's scanned program against its own steps is held at rtol 1e-5 /
    # atol 1e-6 (tests/test_scan_driver.py): the losses here too
    scan_tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o.d_loss.numpy(), np.asarray(jo.d_loss), **scan_tol)
    np.testing.assert_allclose(o.g_loss.numpy(), np.asarray(jo.g_loss), **scan_tol)
    for k in ("d_real", "d_fake"):
        np.testing.assert_allclose(o.metrics[k].numpy(), np.asarray(jo.metrics[k]),
                                   **scan_tol)
    tg.assert_matches_jax(tg.port_state(tr), jfinal, tr)
    assert tr.step_count == tg.ITERS
    assert tg._nbt(tr.generator) == [2 * tg.ITERS] * 4
    assert tg._nbt(tr.discriminator) == [3 * tg.ITERS] * 2
    # and exactly the port's own K train_step calls
    seq = tg.port_trainer(arch, init)
    outs = tg.port_run(seq, data)
    np.testing.assert_array_equal(o.d_loss.numpy(), outs[:, 0])
    for (k, a), b in zip(tg.port_state(seq).items(), tg.port_state(tr).values()):
        np.testing.assert_array_equal(b, a, err_msg=k)


def scan_driver_spec(spec):
    from tpu_syncbn.parallel import scan_driver as jscan

    return jscan.stack_batch_spec(spec)
