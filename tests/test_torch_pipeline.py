"""The port's pipeline parallelism (``tpu_syncbn_torch.parallel.pipeline``)
against the JAX package's, from the same numpy inputs made from a seed.

The port runs in spawned gloo CPU worlds of 2 and 4 processes, one spawn a
world carrying every case; the JAX references run in this process on a
mesh of as many of the 8 CPU devices. The stages are the JAX tests'
``tanh(x @ w + b)`` over 8 features.

* ``pipeline_apply`` / ``pipeline_parallel``: the last stage's rows against
  the N stages run in sequence (JAX), forward at M = 1, 3, 8 and the
  gradients of ``sum(y ** 2)`` at M = 6 (``tests/test_pipeline_parallel.
  py``: 2e-5 and 5e-5, absolute); a stage that turns an all-zero input
  into NaN (the JAX tests' adversarial feed) leaves the output finite.
* ``PipelineTrainer`` at (data, pipe) = (1, 4) and (2, 2) in the world of
  4 and (1, 2) in the world of 2, GPipe and 1F1B, M = 4 and 8, against
  JAX's ``PipelineTrainer`` with ``optax.sgd`` on a mesh of the same shape
  over 2 steps: losses within rtol 1e-5, each step's gradients, read as
  ``(p_before − p_after) / lr`` as the JAX tests read them, within atol
  2e-5 / rtol 1e-4 (``tests/test_pipeline_trainer.py``); GPipe against
  1F1B over 3 Adam steps; ``train_steps_batches`` against the step loop;
  the guard skipping a poisoned slice mid-chunk; the NaN-feed stage on
  both schedules; the constructor's errors and ``set_microbatches``; and
  the tallies: exactly two ``ppermute``s a tick, ``2·T`` a step at every M.
"""

import json
import os
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch.parallel import collectives as C
from tpu_syncbn_torch.parallel import pipeline as pp
from tpu_syncbn_torch.parallel import pipeline_schedule as ps

WORLDS = (2, 4)
JOIN_TIMEOUT_S = 240
FEAT, MB = 8, 4
LR = 0.1
#: (data, pipe) meshes each world trains on
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
SCHEDULES = ("gpipe", "1f1b")
MS = (4, 8)
STEPS = 2
APPLY_MS = (1, 3, 8)
FWD_TOL, GRAD_TOL = 2e-5, 5e-5  # pipeline_apply (tests/test_pipeline_parallel.py)
LOSS_RTOL, TR_ATOL, TR_RTOL = 1e-5, 2e-5, 1e-4  # the trainer (test_pipeline_trainer.py)


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def nan_on_garbage_stage(p, x):
    """NaN on an all-zero input (the garbage an idle JAX slot computes on);
    real microbatches are standard-normal, never all-zero."""
    y = stage_fn(p, x)
    return y + torch.where(x.abs().sum() == 0, float("nan"), 0.0)


def loss_fn(y, t):
    return ((y - t) ** 2).mean()


STAGES = {"tanh": stage_fn, "nan": nan_on_garbage_stage}


class GlobalNormSGD(torch.optim.SGD):
    """SGD on gradients scaled to unit global norm: a global view across
    parameters, which a per-stage update cannot reproduce."""

    @torch.no_grad()
    def step(self, closure=None):
        ps_ = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in ps_))
        for p in ps_:
            p.grad.div_(norm)
        return super().step(closure)


def make_params(n_stages, seed=0):
    r = np.random.default_rng(seed)
    return {"w": (r.standard_normal((n_stages, FEAT, FEAT)) * 0.5).astype(np.float32),
            "b": (r.standard_normal((n_stages, FEAT)) * 0.1).astype(np.float32)}


def make_batch(m, gmb, seed=1):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, gmb, FEAT)).astype(np.float32),
            r.standard_normal((m, gmb, FEAT)).astype(np.float32))


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        return f"{type(e).__name__}: {e}"
    return ""


def _trainer_key(data, pipe, sched, m, stage="tanh"):
    return f"tr.{data}x{pipe}.{sched}.m{m}.{stage}"


def _local(batch, data_index, per_replica):
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a[:, data_index * per_replica:(data_index + 1) * per_replica])) for a in batch)


def _trainer(layout, pipe, sched, m, *, stage="tanh", opt=None, **kw):
    opt = opt or (lambda params: torch.optim.SGD(params, lr=LR))
    return pp.PipelineTrainer(STAGES[stage], loss_fn, make_params(pipe), opt,
                              num_microbatches=m, schedule=sched, layout=layout, **kw)


def _train_cases(out, layout, data, pipe, rank):
    """The JAX-parity runs: 2 SGD steps a (schedule, M), the NaN-feed
    stage, and one step's tallies at each M."""
    di = rank // pipe
    for sched in SCHEDULES:
        for m in MS:
            for stage in ("tanh", "nan") if m == MS[0] else ("tanh",):
                tr = _trainer(layout, pipe, sched, m, stage=stage)
                key = _trainer_key(data, pipe, sched, m, stage)
                rows = [tr.params]
                losses, tallies = [], []
                for k in range(STEPS):
                    C.reset_tallies()
                    out_ = tr.train_step(_local(make_batch(m, 2 * data, seed=1 + k), di, 2))
                    tallies.append(C.tallies())
                    losses.append(float(out_.loss))
                    rows.append(tr.params)
                out[f"{key}.loss"] = np.array(losses)
                for k, row in enumerate(rows):
                    for n, v in row.items():
                        out[f"{key}.p{k}.{n}"] = v.numpy()
                out[f"{key}.tallies"] = np.array(json.dumps(tallies))


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


def _schedules_agree(out, layout, rank):
    """GPipe against 1F1B: 3 Adam steps at M = 8 on the (2, 2) mesh."""
    trs = {s: _trainer(layout, 2, s, 8, opt=_adam) for s in SCHEDULES}
    for k in range(3):
        batch = _local(make_batch(8, 4, seed=10 + k), rank // 2, 2)
        for s, tr in trs.items():
            out[f"agree.{s}.loss{k}"] = np.array(float(tr.train_step(batch).loss))
    for s, tr in trs.items():
        for n, v in tr.params.items():
            out[f"agree.{s}.{n}"] = v.numpy()


def _chunks(out, layout, rank):
    """``train_steps_batches`` against the step loop (K = 3, M = 6, Adam),
    and the guard skipping a NaN slice mid-chunk against a clean twin."""
    k, di = 3, rank // 2
    batches = [_local(make_batch(6, 4, seed=20 + i), di, 2) for i in range(k)]
    loop = _trainer(layout, 2, "1f1b", 6, opt=_adam)
    out["chunk.loop.loss"] = np.array([float(loop.train_step(b).loss) for b in batches])
    fused = _trainer(layout, 2, "1f1b", 6, opt=_adam)
    res = fused.train_steps_batches(tuple(torch.stack(x) for x in zip(*batches)))
    out["chunk.fused.loss"] = res.loss.numpy()
    for name, tr in (("loop", loop), ("fused", fused)):
        for n, v in tr.params.items():
            out[f"chunk.{name}.{n}"] = v.numpy()

    batches = [_local(make_batch(4, 4, seed=30 + i), di, 2) for i in range(k)]
    poisoned = [batches[0], (torch.full_like(batches[1][0], float("nan")), batches[1][1]),
                batches[2]]
    guarded = _trainer(layout, 2, "1f1b", 4, opt=_adam, divergence_guard="skip_step")
    res = guarded.train_steps_batches(tuple(torch.stack(x) for x in zip(*poisoned)))
    out["guard.nonfinite"] = res.metrics["nonfinite"].numpy()
    out["guard.count"] = np.array(guarded.guard_state["nonfinite_count"])
    clean = _trainer(layout, 2, "1f1b", 4, opt=_adam, divergence_guard="skip_step")
    eager = [clean.train_step(b).metrics["nonfinite"].item() for b in (batches[0], batches[2])]
    out["guard.eager_nonfinite"] = np.array(eager)
    # the eager step skips a poisoned batch too
    twin = _trainer(layout, 2, "1f1b", 4, opt=_adam, divergence_guard="skip_step")
    out["guard.eager_skip"] = np.array(
        [twin.train_step(b).metrics["nonfinite"].item() for b in poisoned])
    for name, tr in (("guarded", guarded), ("clean", clean), ("twin", twin)):
        for n, v in tr.params.items():
            out[f"guard.{name}.{n}"] = v.numpy()


def _errors(out, layouts, world):
    """The constructor's checks, set_microbatches, split_microbatches and
    pipeline_mesh (every rank, every message)."""
    from tpu_syncbn_torch.parallel.layout import SpecLayout

    l14, l22 = layouts[(1, 4)], layouts[(2, 2)]
    p4 = make_params(4)
    sgd = lambda params: torch.optim.SGD(params, lr=LR)  # noqa: E731

    def build(params=p4, opt=sgd, **kw):
        kw.setdefault("layout", l14)
        return pp.PipelineTrainer(stage_fn, loss_fn, params, opt, num_microbatches=4, **kw)

    bad_sched = ps.Schedule("bad", 4, 4, np.zeros((4, 4), np.int32),
                            np.zeros((4, 4), np.int32))
    fsdp = SpecLayout({"fsdp": 2, "pipe": 2}, device="cpu")
    out["err.guard"] = np.array(_error(lambda: build(divergence_guard="halve_lr")))
    out["err.stages"] = np.array(_error(lambda: build(params=dict(p4, b=p4["b"][:2]))))
    out["err.pipe"] = np.array(_error(lambda: build(layout=l22)))
    out["err.schedule"] = np.array(_error(lambda: build(schedule=bad_sched)))
    out["err.optimizer"] = np.array(_error(lambda: build(
        opt=lambda params: GlobalNormSGD(params, lr=LR))))
    out["err.fsdp"] = np.array(_error(lambda: build(layout=fsdp)))
    out["err.both"] = np.array(_error(lambda: build(mesh=l22.mesh)))
    out["err.missing_axis"] = np.array(_error(lambda: build(
        layout=SpecLayout({"pipe": world}, device="cpu"))))
    tr = build()
    x, t = make_batch(6, 2)
    out["err.microbatches"] = np.array(_error(lambda: tr.train_step(
        (torch.from_numpy(x), torch.from_numpy(t)))))
    named = tr.set_microbatches(8)
    out["set.named"] = np.array([named, tr.num_microbatches, tr.schedule.ticks])
    pinned = build(schedule=ps.one_f1b_schedule(4, 4))
    out["set.pinned"] = np.array([pinned.set_microbatches(8), pinned.num_microbatches])
    out["err.split"] = np.array(_error(lambda: pp.split_microbatches(torch.zeros(12, FEAT), 5)))
    out["split.shape"] = np.array(pp.split_microbatches(torch.zeros(12, FEAT), 4).shape)
    out["err.mesh"] = np.array(_error(lambda: pp.pipeline_mesh(3, device="cpu")))
    mesh = pp.pipeline_mesh(2, device="cpu")
    out["mesh.axes"] = np.array(json.dumps(mesh.axis_sizes))
    out["mesh.stage"] = np.array(C.axis_index(mesh.group("pipe")))


def _apply_cases(out, group, world, rank):
    """pipeline_parallel's row: forward at each M; the gradients at M = 6;
    the NaN-feed stage. ``group`` spans the world: N = world stages."""
    stacked = make_params(world)
    f = pp.pipeline_parallel(stage_fn, group)
    for m in APPLY_MS:
        x = np.random.default_rng(1).standard_normal((m, MB, FEAT)).astype(np.float32)
        out[f"apply.m{m}"] = f({k: torch.from_numpy(v) for k, v in stacked.items()},
                               torch.from_numpy(x)).numpy()
    stacked = make_params(world, seed=2)
    x = np.random.default_rng(3).standard_normal((6, MB, FEAT)).astype(np.float32)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in stacked.items()}
    xt = torch.from_numpy(x).requires_grad_()
    C.reset_tallies()
    row = f(leaves, xt)
    # this rank's cotangent of sum(last_stage_output ** 2): 2 y on the last
    # stage, zeros elsewhere
    row.backward(2 * row.detach() if rank == world - 1 else torch.zeros_like(row))
    out["apply.grad.row"] = row.detach().numpy()
    out["apply.grad.x"] = xt.grad.numpy()
    for k, v in leaves.items():
        out[f"apply.grad.{k}"] = v.grad.numpy()
    out["apply.grad.tallies"] = np.array(json.dumps(C.tallies()))
    x = np.random.default_rng(7).standard_normal((6, MB, FEAT)).astype(np.float32)
    nan = pp.pipeline_parallel(nan_on_garbage_stage, group)
    out["apply.nan"] = nan({k: torch.from_numpy(v) for k, v in make_params(world).items()},
                           torch.from_numpy(x)).numpy()


def compute(rank: int, world: int, inp: dict) -> dict:
    from tpu_syncbn_torch.parallel.layout import SpecLayout

    out = {}
    _apply_cases(out, tdist.group.WORLD, world, rank)
    layouts = {(d, p): SpecLayout({"data": d, "pipe": p}, param_shard_axis=None,
                                  device="cpu") for d, p in MESHES[world]}
    for (d, p), layout in layouts.items():
        _train_cases(out, layout, d, p, rank)
    from tpu_syncbn_torch import bench

    out["bench"] = np.array(json.dumps(bench.measure_pipeline_bubbles(
        tdist.group.WORLD, torch.device("cpu"))))
    if world == 4:
        _schedules_agree(out, layouts[(2, 2)], rank)
        _chunks(out, layouts[(2, 2)], rank)
        _errors(out, layouts, world)
    return out


def _replica(rank, world, rdv, out_dir, inp):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                             rank=rank)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **compute(rank, world, inp))
    finally:
        tdist.destroy_process_group()


def _shared_dir(tmp_path_factory, name: str, make):
    """The directory ``make(d)`` filled, made once per test run whatever the
    number of xdist workers: the first worker to take the lock runs it and
    marks it done; the others wait on the lock, then read its files."""
    import fcntl

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, which its workers share
    d = root / name
    d.mkdir(exist_ok=True)
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (d / "done").exists():
                make(d)
                (d / "done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return d


def spawn(world: int, tmp_path_factory) -> list:
    """This file's replica in ``world`` spawned processes (one spawn a world
    for the whole run, :func:`_shared_dir`); each rank's npz as a dict."""

    def run(out):
        rdv = tempfile.mkdtemp(dir=out)  # a fresh rendezvous each attempt
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=_replica, args=(r, world, os.path.join(rdv, "rdv"),
                                                    str(out), {}))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5)
        assert not alive, f"world-{world} replicas still running after {JOIN_TIMEOUT_S}s"
        assert [p.exitcode for p in procs] == [0] * world

    d = _shared_dir(tmp_path_factory, f"pipe{world}", run)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


_RESULTS: dict = {}


def _spawned(world: int, tmp_path_factory) -> list:
    """The world's per-rank results: one spawn a world for the module."""
    if world not in _RESULTS:
        _RESULTS[world] = spawn(world, tmp_path_factory)
    return _RESULTS[world]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def res(request, tmp_path_factory):
    """``(world, per-rank results)``."""
    return request.param, _spawned(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawned(4, tmp_path_factory)


# -- the JAX side ---------------------------------------------------------------


def _jax_stage(p, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_loss(y, t):
    import jax.numpy as jnp

    return jnp.mean((y - t) ** 2)


def _jax_nan_stage(p, x):
    import jax.numpy as jnp

    y = _jax_stage(p, x)
    return y + jnp.where(jnp.sum(jnp.abs(x)) == 0, jnp.nan, 0.0)


def jax_sequential(stacked, x):
    """Every microbatch through the N stages in sequence."""
    import jax

    n = stacked["w"].shape[0]

    def run_one(h):
        for s in range(n):
            h = _jax_stage({k: v[s] for k, v in stacked.items()}, h)
        return h

    return jax.vmap(run_one)(x)


_JAX_TRAINED: dict = {}


def jax_trained(data, pipe, sched, m, stage="tanh"):
    """JAX's PipelineTrainer with optax.sgd on a (data, pipe) mesh: the
    losses and the stacked parameters before and after each step."""
    key = (data, pipe, sched, m, stage)
    if key in _JAX_TRAINED:
        return _JAX_TRAINED[key]
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from tpu_syncbn.mesh_axes import DATA_AXIS, PIPE_AXIS
    from tpu_syncbn.parallel import pipeline as J

    mesh = Mesh(np.array(jax.devices()[:data * pipe]).reshape(data, pipe),
                (DATA_AXIS, PIPE_AXIS))
    params = {k: jnp.asarray(v) for k, v in make_params(pipe).items()}
    tr = J.PipelineTrainer(_jax_nan_stage if stage == "nan" else _jax_stage, _jax_loss,
                           params, optax.sgd(LR), num_microbatches=m, schedule=sched,
                           mesh=mesh)
    rows, losses = [jax.tree_util.tree_map(np.asarray, params)], []
    for k in range(STEPS):
        x, t = make_batch(m, 2 * data, seed=1 + k)
        losses.append(float(tr.train_step((jnp.asarray(x), jnp.asarray(t))).loss))
        rows.append(jax.tree_util.tree_map(np.asarray, tr.params))
    _JAX_TRAINED[key] = (losses, rows)
    return _JAX_TRAINED[key]


# -- pipeline_apply / pipeline_parallel --------------------------------------------


@pytest.mark.parametrize("m", APPLY_MS)
def test_pipeline_parallel_forward_matches_sequential(res, m):
    world, ranks = res
    x = np.random.default_rng(1).standard_normal((m, MB, FEAT)).astype(np.float32)
    want = np.asarray(jax_sequential(make_params(world), x))
    rows = np.concatenate([got[f"apply.m{m}"] for got in ranks])
    assert rows.shape == (world, m, MB, FEAT)
    err = float(np.abs(pp.last_stage_output(rows) - want).max())
    assert err <= FWD_TOL, err
    assert not rows[:-1].any()  # only the last stage banks rows


def test_pipeline_parallel_gradients_match_sequential(res):
    """The stacked parameters' gradient lands on each stage's own row; the
    replicated microbatches' gradient is the full gradient on every rank.
    Backward issues the forward's ppermutes' transposes and one psum (the
    microbatches' *f*)."""
    import jax
    import jax.numpy as jnp

    world, ranks = res
    m = 6
    stacked = {k: jnp.asarray(v) for k, v in make_params(world, seed=2).items()}
    x = jnp.asarray(np.random.default_rng(3).standard_normal((m, MB, FEAT)).astype(np.float32))
    g_p, g_x = jax.grad(lambda p, xx: jnp.sum(jax_sequential(p, xx) ** 2),
                        argnums=(0, 1))(stacked, x)
    for r, got in enumerate(ranks):
        assert float(np.abs(got["apply.grad.x"] - np.asarray(g_x)).max()) <= GRAD_TOL
        for k, g in g_p.items():
            mine = got[f"apply.grad.{k}"]
            assert float(np.abs(mine[r] - np.asarray(g)[r]).max()) <= GRAD_TOL, (r, k)
            assert not np.delete(mine, r, axis=0).any(), (r, k)
        t = json.loads(str(got["apply.grad.tallies"]))
        ticks = m + world - 1
        assert t["ppermute"]["calls"] == 2 * ticks, t  # forward and its transpose
        assert t["psum"]["calls"] == 1, t


def test_pipeline_parallel_nan_feed_cannot_corrupt(res):
    world, ranks = res
    x = np.random.default_rng(7).standard_normal((6, MB, FEAT)).astype(np.float32)
    got = ranks[-1]["apply.nan"][0]
    assert np.isfinite(got).all()
    err = float(np.abs(got - np.asarray(jax_sequential(make_params(world), x))).max())
    assert err <= FWD_TOL, err


# -- PipelineTrainer against JAX's ------------------------------------------------


def _trainer_params(ranks, key, k, pipe):
    """The stacked tree after step k, from the ranks' rows (stage = rank %
    pipe; data replicas must agree bit for bit)."""
    out = {}
    for n in ("w", "b"):
        rows = [ranks[r][f"{key}.p{k}.{n}"] for r in range(len(ranks))]
        for r, row in enumerate(rows):
            np.testing.assert_array_equal(row, rows[r % pipe])
        out[n] = np.concatenate(rows[:pipe])
    return out


TRAINER_CASES = [(d, p, s, m) for w in WORLDS for d, p in MESHES[w]
                 for s in SCHEDULES for m in MS]


@pytest.mark.parametrize("data,pipe,sched,m", TRAINER_CASES,
                         ids=lambda v: str(v))
def test_trainer_matches_jax(tmp_path_factory, data, pipe, sched, m):
    _check_against_jax(_spawned(data * pipe, tmp_path_factory), data, pipe, sched, m, "tanh")


def _check_against_jax(ranks, data, pipe, sched, m, stage):
    want_loss, want_rows = jax_trained(data, pipe, sched, m, stage)
    key = _trainer_key(data, pipe, sched, m, stage)
    for got in ranks:
        assert np.isfinite(got[f"{key}.loss"]).all()
        np.testing.assert_allclose(got[f"{key}.loss"], want_loss, rtol=LOSS_RTOL)
    for k in range(STEPS):
        before = _trainer_params(ranks, key, k, pipe)
        after = _trainer_params(ranks, key, k + 1, pipe)
        for n in ("w", "b"):
            got_g = (before[n] - after[n]) / LR
            want_g = (want_rows[k][n] - want_rows[k + 1][n]) / LR
            np.testing.assert_allclose(got_g, want_g, atol=TR_ATOL, rtol=TR_RTOL,
                                       err_msg=f"{key} step {k} d{n}")


@pytest.mark.parametrize("sched", SCHEDULES)
def test_trainer_nan_feed_cannot_corrupt(world4, sched):
    """The stage turns an all-zero input into NaN; an idle slot computes
    nothing, so training stays finite and equals JAX's (whose masks discard
    the garbage it computes)."""
    _check_against_jax(world4, 1, 4, sched, MS[0], "nan")
    _check_against_jax(world4, 2, 2, sched, MS[0], "nan")


@pytest.mark.parametrize("data,pipe", [(1, 4), (2, 2), (1, 2)])
def test_two_ppermutes_a_tick(tmp_path_factory, data, pipe):
    """Each rank issues exactly 2·T ppermutes a step (T the schedule's
    ticks) at every M, one psum of the loss over pipe, and a pmean a
    parameter (and one of the loss) over data when the data axis has more
    than one replica."""
    ranks = _spawned(data * pipe, tmp_path_factory)
    for sched in SCHEDULES:
        for m in MS:
            ticks = ps.get_schedule(sched, m, pipe).ticks
            for got in ranks:
                for t in json.loads(str(got[f"{_trainer_key(data, pipe, sched, m)}.tallies"])):
                    assert t["ppermute"]["calls"] == 2 * ticks, (sched, m, t)
                    assert t["psum"]["calls"] == 1
                    assert t.get("pmean", {}).get("calls", 0) == (3 if data > 1 else 0)
                    assert set(t) <= {"ppermute", "psum", "pmean"}


def test_gpipe_and_1f1b_agree_over_three_adam_steps(world4):
    for got in world4:
        for k in range(3):
            np.testing.assert_allclose(got[f"agree.gpipe.loss{k}"],
                                       got[f"agree.1f1b.loss{k}"], rtol=1e-5)
        for n in ("w", "b"):
            np.testing.assert_allclose(got[f"agree.gpipe.{n}"], got[f"agree.1f1b.{n}"],
                                       rtol=1e-5, atol=1e-6)


def test_train_steps_batches_equals_the_step_loop(world4):
    for got in world4:
        assert got["chunk.fused.loss"].shape == (3,)
        np.testing.assert_allclose(got["chunk.fused.loss"], got["chunk.loop.loss"], rtol=1e-5)
        for n in ("w", "b"):
            np.testing.assert_allclose(got[f"chunk.fused.{n}"], got[f"chunk.loop.{n}"],
                                       rtol=2e-4, atol=1e-6)


def test_guard_skips_a_poisoned_slice_mid_chunk(world4):
    """A NaN slice inside a K = 3 chunk is skipped on every rank (world
    consensus), its neighbours land, the count persists, and the skipped
    step is a no-op: a clean twin that never saw it lands on the same
    parameters. The eager step skips it too."""
    for got in world4:
        assert list(got["guard.nonfinite"]) == [0.0, 1.0, 0.0]
        assert int(got["guard.count"]) == 1
        assert list(got["guard.eager_nonfinite"]) == [0.0, 0.0]
        assert list(got["guard.eager_skip"]) == [0.0, 1.0, 0.0]
        for n in ("w", "b"):
            assert np.isfinite(got[f"guard.guarded.{n}"]).all()
            np.testing.assert_allclose(got[f"guard.guarded.{n}"], got[f"guard.clean.{n}"],
                                       rtol=2e-4, atol=1e-6)
            np.testing.assert_array_equal(got[f"guard.twin.{n}"], got[f"guard.clean.{n}"])


ERRORS = {
    "err.guard": "divergence_guard",
    "err.stages": "same leading stage axis",
    "err.pipe": "pipe.*axis has 2",
    "err.schedule": "twice",
    "err.optimizer": "elementwise",
    "err.fsdp": "fsdp×pipe",
    "err.both": "pass either layout= or mesh=",
    "err.missing_axis": "missing the 'data' axis",
    "err.microbatches": "6 microbatches",
    "err.split": "not divisible",
    "err.mesh": "4 devices do not split into pipelines of 3 stages",
}


@pytest.mark.parametrize("key", list(ERRORS))
def test_constructor_and_helpers_raise(world4, key):
    import re

    for got in world4:
        msg = str(got[key])
        assert msg.startswith("ValueError: ") and re.search(ERRORS[key], msg), msg


def test_set_microbatches_split_and_mesh(world4):
    for r, got in enumerate(world4):
        named, m, ticks = got["set.named"]
        assert named and m == 8 and ticks == ps.one_f1b_schedule(8, 4).ticks
        assert list(got["set.pinned"]) == [False, 4]
        assert tuple(got["split.shape"]) == (4, 3, FEAT)
        assert json.loads(str(got["mesh.axes"])) == {"data": 2, "pipe": 2}
        assert int(got["mesh.stage"]) == r % 2  # pipe innermost


BENCH_KEYS = {"n_stages", "data_world", "microbatches", "dense_step_s",
              "canonical_gpipe_bubble", "schedules", "fused", "collective_calls"}
BENCH_SCHEDULE_KEYS = {"ticks", "bubble_frac_predicted", "bubble_frac_measured", "step_s"}


def test_bench_pipeline_block(res):
    """The bench's ``pipeline`` sub-block at world > 1 (bench.py's keys):
    predicted bubble ``1 − M/T`` from the tables, 2·T ppermutes a step, a
    fused K = 2 chunk on the CPU."""
    world, ranks = res
    for got in ranks:
        blk = json.loads(str(got["bench"]))
        assert set(blk) == BENCH_KEYS
        n = 4 if world % 4 == 0 else 2
        m = 2 * n
        assert (blk["n_stages"], blk["data_world"], blk["microbatches"]) == (n, world // n, m)
        assert blk["canonical_gpipe_bubble"] == round(ps.canonical_gpipe_bubble(m, n), 4)
        assert blk["dense_step_s"] > 0
        for name in ("gpipe", "1f1b"):
            sch = blk["schedules"][name]
            ticks = ps.get_schedule(name, m, n).ticks
            assert set(sch) == BENCH_SCHEDULE_KEYS and sch["ticks"] == ticks
            assert sch["bubble_frac_predicted"] == round(1 - m / ticks, 4)
            assert 0.0 <= sch["bubble_frac_measured"] < 1.0 and sch["step_s"] > 0
            assert blk["collective_calls"][name]["ppermute"] == 2 * ticks
        assert blk["collective_calls"]["_dense_timing"]["ppermute"] == 2 * m
        assert blk["fused"]["k"] == 2 and blk["fused"]["chunk_s"] > 0
