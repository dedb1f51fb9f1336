"""ZeRO in the port (``parallel/zero.py``, ``parallel/redistribute.py``,
``DataParallel(zero=True)``) against the JAX package's
(tests/test_zero.py, case for case) and against the port's own
replicated trainer:

* ``FlatLayout``: mixed dtypes and a channels-last tensor round-trip, the
  vectors equal to the JAX ``FlatLayout``'s on the same tree; a wrong tree
  is refused;
* ``check_elementwise`` accepts SGD with momentum, Adam and AdamW, and
  refuses a global-norm clip, several param groups and LBFGS;
* the trainer at world 1 in this process and at gloo worlds 2 and 4 (one
  spawn each, several checks inside): ``zero`` against replicated (SGD
  with momentum and AdamW, 3 steps), against the JAX
  ``DataParallel(zero=True)`` on a mesh of the same size, with
  ``accum_steps``, the bf16 and int8 wires, the sharded state's sizes and
  the step's tallies (reduce-scatter and all-gather once a dtype, no
  gradient all-reduce: the JAX HLO check), the state dict's round trip and
  both load rejections, ``eval_step``, a K-step chunk, the guard, and
  ``build_redistribute`` against ``unshard_params``;
* ``load_jax_trainer_state`` from a JAX ``zero=True`` state.

Tolerances: losses rtol 1e-5 and parameters atol 1e-5 between the port's
zero and replicated trainers (the JAX test's); against JAX the trainer
tests' rtol 2e-4 / atol 1e-5 (losses rtol 1e-5).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from test_torch_compression import spawn
from tpu_syncbn_torch import models, nn, parallel
from tpu_syncbn_torch.parallel import collectives as C
from tpu_syncbn_torch.parallel.layout import SpecLayout
from tpu_syncbn_torch.parallel.redistribute import build_redistribute, portable_redistribute
from tpu_syncbn_torch.parallel.zero import FlatLayout, check_elementwise, unshard_params

NET = dict(rtol=2e-4, atol=1e-5)
GLOBAL_BATCH, STEPS, LR = 16, 3, 0.1


# -- the model: ResNet-18 at width 8 on 8x8 images (channels-last convs) -----


def batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((GLOBAL_BATCH, 8, 8, 3)).astype(np.float32),
             rng.integers(0, 10, (GLOBAL_BATCH,)).astype(np.int64)) for _ in range(n)]


def shard(batch, rank, world):
    n = GLOBAL_BATCH // world
    return tuple(torch.from_numpy(t[rank * n:(rank + 1) * n]) for t in batch)


def ce(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y.long())


def port_model(init):
    model = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=10, small_input=True, width=8, device="cpu"))
    models.load_jax_params(model, init)
    return model


OPTS = {
    "sgdm": lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-2),
    "adam": lambda ps: torch.optim.Adam(ps, lr=1e-3),
    "sgd": lambda ps: torch.optim.SGD(ps, lr=LR),
}


def make_dp(init, opt="sgdm", **kw):
    model = port_model(init)
    return parallel.DataParallel(model, OPTS[opt](model.parameters()), ce, device="cpu", **kw)


def params_of(dp) -> dict:
    return {n: p.detach().numpy().copy() for n, p in dp.model.named_parameters()}


def buffers_of(dp) -> dict:
    return {n: b.detach().numpy().copy() for n, b in dp.model.named_buffers()
            if b.is_floating_point()}


def jax_init():
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import models as jmodels
    from tpu_syncbn import nn as jnn

    jm = jnn.convert_sync_batchnorm(jmodels.resnet18(
        num_classes=10, small_input=True, width=8, rngs=nnx.Rngs(0)))
    return jm, flat_state(jm)


def jax_zero_run(world, bs, opt="sgdm", **kw):
    """A JAX ``DataParallel(zero=True)`` on a ``world``-device mesh from
    the shared initial weights: losses, final state, the trainer."""
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    import jax
    from test_torch_resnet import flat_state
    from tpu_syncbn import parallel as jparallel

    jm, _ = jax_init()

    def jce(m, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(m(x), y).mean()

    o = {"sgdm": optax.sgd(LR, momentum=0.9)}[opt]
    dp = jparallel.DataParallel(jm, o, jce, mesh=Mesh(np.array(jax.devices()[:world]), ("data",)),
                                zero=True, donate=False, **kw)
    losses = [float(dp.train_step((jnp.asarray(x), jnp.asarray(y.astype(np.int32)))).loss)
              for x, y in bs]
    return losses, flat_state(dp.sync_to_model()), dp


# -- FlatLayout, check_elementwise ------------------------------------------


def _tree():
    rs = np.random.RandomState(0)
    c = torch.from_numpy(rs.randn(2, 3, 4, 5).astype(np.float32))
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": torch.ones(5, dtype=torch.bfloat16),
        "c": c.contiguous(memory_format=torch.channels_last),
        "d": torch.arange(4, dtype=torch.bfloat16),
    }


def test_flat_layout_round_trips_mixed_dtypes_and_channels_last_like_jax():
    import jax.numpy as jnp

    from tpu_syncbn.parallel.zero import FlatLayout as JFlat

    tree = _tree()
    assert not tree["c"].is_contiguous()
    lay = FlatLayout(tree, world=4)
    vecs = lay.flatten(tree)
    assert list(vecs) == ["float32", "bfloat16"]
    assert all(v.numel() % 4 == 0 for v in vecs.values())
    back = lay.unflatten(vecs)
    for k, t in tree.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape
        assert torch.equal(back[k].float(), t.float())
    host = lay.unflatten_host(vecs)
    assert all(torch.equal(host[k].float(), t.float()) for k, t in tree.items())
    # a channels-last parameter takes its logical order, by copy
    p = torch.zeros_like(tree["c"])
    p.copy_(back["c"])
    assert torch.equal(p, tree["c"]) and p.is_contiguous(memory_format=torch.channels_last)

    jtree = {k: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32) for k, t in tree.items()}
    jl = JFlat(jtree, world=4)
    assert lay.padded == jl.padded and lay.shard_sizes == jl.shard_sizes
    for dt, v in jl.flatten(jtree).items():
        np.testing.assert_array_equal(vecs[dt].float().numpy(), np.asarray(v, np.float32))


def test_flat_layout_rejects_a_wrong_tree():
    lay = FlatLayout({"a": torch.zeros(2)}, world=2)
    with pytest.raises(ValueError, match="leaves"):
        lay.flatten({"a": torch.zeros(2), "b": torch.zeros(2)})


@pytest.mark.parametrize("opt", ["sgdm", "adam", "adamw"])
def test_check_elementwise_accepts_elementwise_optimizers(opt):
    check_elementwise(OPTS[opt]([torch.nn.Parameter(torch.zeros(3))]))


class ClipAdam(torch.optim.Adam):
    """Adam after a clip of every gradient to a global norm of 1: a view
    across the whole parameter vector (optax.clip_by_global_norm)."""

    @torch.no_grad()
    def step(self, closure=None):
        ps = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
        for p in ps:
            p.grad.mul_(1.0 / torch.clamp(norm, min=1.0))
        return super().step(closure)


def test_check_elementwise_rejects_global_views_groups_and_closures():
    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="elementwise"):
        check_elementwise(ClipAdam([w], lr=1e-3))
    with pytest.raises(ValueError, match="one param group"):
        check_elementwise(torch.optim.SGD(
            [{"params": [w]}, {"params": [torch.nn.Parameter(torch.zeros(2))],
                               "weight_decay": 1e-3}], lr=0.1))
    with pytest.raises(ValueError, match="LBFGS"):
        check_elementwise(torch.optim.LBFGS([w]))


def test_zero_trainer_rejects_a_global_view_optimizer_and_accepts_it_replicated():
    _, init = jax_init()
    model = port_model(init)
    opt = ClipAdam(model.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="elementwise"):
        parallel.DataParallel(model, opt, ce, device="cpu", zero=True)
    parallel.DataParallel(model, opt, ce, device="cpu")


# -- world 1, in this process -------------------------------------------------


@pytest.fixture(scope="module")
def init():
    return jax_init()[1]


def test_zero_at_world_1_is_the_replicated_trajectory(init):
    bs = batches()
    out = {}
    for z in (False, True):
        dp = make_dp(init, zero=z)
        out[z] = ([float(dp.train_step(shard(b, 0, 1)).loss) for b in bs], params_of(dp),
                  buffers_of(dp))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for part in (1, 2):
        for k, v in out[False][part].items():
            np.testing.assert_allclose(out[True][part][k], v, atol=1e-5, err_msg=k)


def test_zero_rebinds_the_optimizer_to_the_shards_and_keeps_its_scheduler(init):
    model = port_model(init)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    dp = parallel.DataParallel(model, opt, ce, device="cpu", zero=True, lr_scheduler=sched)
    assert dp.layout == SpecLayout.zero(device="cpu") and dp.zero
    assert opt.param_groups[0]["params"] == list(dp._shards.values())
    n = sum(p.numel() for p in model.parameters())
    assert dp._flat.padded == {"float32": n}
    dp.train_step(shard(batches(1)[0], 0, 1))
    st = opt.state[dp._shards["float32"]]
    assert st["exp_avg"].shape == (n,) and st["exp_avg_sq"].shape == (n,)
    assert opt.param_groups[0]["lr"] == 5e-4


def test_zero_state_dict_round_trip_and_load_rejections_at_world_1(init):
    bs = batches(2)
    dp = make_dp(init, "adam", zero=True)
    dp.train_step(shard(bs[0], 0, 1))
    state = dp.state_dict()
    assert state["opt_state"]["flat"] == {"padded": dp._flat.padded}
    cont = float(dp.train_step(shard(bs[1], 0, 1)).loss)
    dp2 = make_dp(init, "adam", zero=True)
    dp2.load_state_dict(state)
    assert float(dp2.train_step(shard(bs[1], 0, 1)).loss) == cont
    rep = make_dp(init, "adam")
    with pytest.raises(ValueError, match="zero"):
        rep.load_state_dict(state)
    with pytest.raises(ValueError, match="zero"):
        make_dp(init, "adam", zero=True).load_state_dict(rep.state_dict())


def test_zero_checkpoints_resume_through_resume_latest(init, tmp_path):
    """A certified checkpoint of a zero trainer (full padded optimizer
    vectors) resumes through ``resume_latest`` unchanged."""
    from tpu_syncbn_torch import utils
    from tpu_syncbn_torch.parallel import resume_latest

    bs = batches(2)
    dp = make_dp(init, "adam", zero=True)
    dp.train_step(shard(bs[0], 0, 1))
    utils.save_checkpoint(str(tmp_path), 1, dp.state_dict())
    cont = float(dp.train_step(shard(bs[1], 0, 1)).loss)
    dp2 = make_dp(init, "adam", zero=True)
    assert resume_latest(dp2, str(tmp_path)) == 1
    assert float(dp2.train_step(shard(bs[1], 0, 1)).loss) == cont
    assert torch.equal(dp2._shards["float32"], dp._shards["float32"])


def test_zero_eval_step_and_module_read_back(init):
    b = shard(batches(1)[0], 0, 1)
    dp = make_dp(init, zero=True)
    dp.train_step(b)
    ev = dp.eval_step(b)
    dp.model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(float(ce(dp.model, b)), float(ev.loss), rtol=1e-6)
    full = unshard_params(dp._flat, dp._shards, dp._shard_group)
    assert all(torch.equal(full[n], p.detach()) for n, p in dp.model.named_parameters())


def test_zero_chunk_equals_stepwise_and_the_guard_skips(init):
    bs = [shard(b, 0, 1) for b in batches()]
    a, b = make_dp(init, zero=True), make_dp(init, zero=True)
    out = a.train_steps_batches(tuple(torch.stack(t) for t in zip(*bs)))
    want = [float(b.train_step(x).loss) for x in bs]
    np.testing.assert_allclose(out.loss.numpy(), want, rtol=1e-6)
    for k, v in params_of(b).items():
        np.testing.assert_allclose(params_of(a)[k], v, atol=1e-6, err_msg=k)
    g = make_dp(init, zero=True, divergence_guard="skip_step")
    g.train_step(bs[0])
    before, shards = params_of(g), g._shards["float32"].detach().clone()
    x, y = bs[1]
    x = x.clone()
    x[0, 0, 0, 0] = float("nan")
    assert float(g.train_step((x, y)).metrics["nonfinite"]) == 1.0
    assert all(np.array_equal(params_of(g)[k], v) for k, v in before.items())
    assert torch.equal(g._shards["float32"], shards)


def test_zero_chunk_with_a_poisoned_step_equals_the_guarded_steps(init):
    """A K-step chunk under ``skip_step`` with a NaN in its second step:
    the device-side select over shards, optimizer state and module
    parameters gives the stepwise guarded trajectory."""
    bs = [shard(b, 0, 1) for b in batches()]
    x = bs[1][0].clone()
    x[0, 0, 0, 0] = float("nan")
    bs[1] = (x, bs[1][1])
    a = make_dp(init, "adam", zero=True, divergence_guard="skip_step")
    b = make_dp(init, "adam", zero=True, divergence_guard="skip_step")
    out = a.train_steps_batches(tuple(torch.stack(t) for t in zip(*bs)))
    assert out.metrics["nonfinite"].tolist() == [0.0, 1.0, 0.0]
    for xb in bs:
        b.train_step(xb)
    assert a.guard_state == b.guard_state == {"lr_scale": 1.0, "nonfinite_count": 1}
    for k, v in params_of(b).items():
        np.testing.assert_allclose(params_of(a)[k], v, atol=1e-6, err_msg=k)
    sa = a.optimizer.state[a._shards["float32"]]
    sb = b.optimizer.state[b._shards["float32"]]
    np.testing.assert_allclose(sa["exp_avg"].numpy(), sb["exp_avg"].numpy(), atol=1e-7)
    assert float(sa["step"]) == float(sb["step"]) == 2.0


def test_redistribute_at_world_1_equals_unshard_params(init):
    dp = make_dp(init, zero=True)
    dp.train_step(shard(batches(1)[0], 0, 1))
    fn = build_redistribute(dp._flat, dp.layout)
    got = fn(dp._shards)
    want = unshard_params(dp._flat, dp._shards)
    assert list(got) == list(want)
    assert all(torch.equal(got[n], want[n]) for n in want)
    again = portable_redistribute(dp._flat, dp._shards, dp.layout)
    assert all(torch.equal(again[n], want[n]) for n in want)


def test_load_jax_zero_trainer_state_at_world_1(init):
    """A JAX ``zero=True`` trainer on a mesh of 4 (flat vectors in
    jax.tree_util order, HWIO kernels, padded to 4) carried into a port
    zero trainer at world 1: the next step equals JAX's."""
    import jax
    import jax.numpy as jnp

    from tpu_syncbn.utils import checkpoint as jckpt

    bs = batches(3, seed=4)
    _, _, jdp = jax_zero_run(4, bs[:2])
    state = jax.device_get(jckpt._purify(jdp.state_dict()))
    assert set(state["opt_state"][0].trace) == {"float32"}
    dp = make_dp(init, zero=True)
    models.load_jax_trainer_state(dp, state)
    x, y = bs[2]
    jl = float(jdp.train_step((jnp.asarray(x), jnp.asarray(y.astype(np.int32)))).loss)
    np.testing.assert_allclose(float(dp.train_step(shard(bs[2], 0, 1)).loss), jl, rtol=1e-5)
    from test_torch_resnet import flat_state

    want = flat_state(jdp.sync_to_model())
    got = dp.model.state_dict()
    for key, value in want.items():
        name, arr = models.weights._port_name(key, value, dp.model)
        np.testing.assert_allclose(got[name].float().numpy(), arr, err_msg=key, **NET)


# -- worlds 2 and 4 over gloo -------------------------------------------------


def _world(rank, world, rdv, out_dir, inp):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world, rank=rank)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_compute(rank, world, inp))
    finally:
        C.clear_group_cache()
        tdist.destroy_process_group()


def _trajectory(out, tag, dp, bs, rank, world):
    out[f"{tag}.losses"] = np.array([float(dp.train_step(shard(b, rank, world)).loss)
                                     for b in bs])
    for k, v in params_of(dp).items():
        out[f"{tag}.p.{k}"] = v
    for k, v in buffers_of(dp).items():
        out[f"{tag}.b.{k}"] = v


def _compute(rank, world, inp):
    init, bs = inp["init"], inp["batches"]
    out = {}
    for opt in ("sgdm", "adamw"):
        for z in (False, True):
            _trajectory(out, f"{opt}.{'zero' if z else 'rep'}", make_dp(init, opt, zero=z),
                        bs, rank, world)
    for z in (False, True):
        _trajectory(out, f"accum.{'zero' if z else 'rep'}",
                    make_dp(init, zero=z, accum_steps=2), bs[:2], rank, world)
    _trajectory(out, "bf16.zero", make_dp(init, zero=True, grad_compression="bf16"),
                bs[:2], rank, world)
    _trajectory(out, "bf16.rep", make_dp(init, grad_compression="bf16"), bs[:2], rank, world)
    dp = make_dp(init, zero=True, compress="int8")
    _trajectory(out, "int8.zero", dp, bs, rank, world)
    out["int8.residual"] = dp._residual["float32"].numpy().copy()

    # the sharded state and the step's collectives
    dp = make_dp(init, "adam", zero=True)
    C.reset_tallies()
    dp.train_step(shard(bs[0], rank, world))
    out["tallies"] = np.array(json.dumps(C.tallies()))
    st = dp.optimizer.state[dp._shards["float32"]]
    out["adam.numel"] = np.array([st["exp_avg"].numel(), st["exp_avg_sq"].numel(),
                                  dp._flat.padded["float32"], dp._shard_world])

    # the state dict: JAX's format (full padded vectors), round trip, rejections
    b1 = shard(bs[1], rank, world)
    state = dp.state_dict()
    out["state.exp_avg"] = state["opt_state"]["optimizer"]["state"][0]["exp_avg"].numpy()
    cont = float(dp.train_step(b1).loss)
    dp2 = make_dp(init, "adam", zero=True)
    dp2.load_state_dict(state)
    out["resume"] = np.array([cont, float(dp2.train_step(b1).loss)])
    errs = []
    for other in (lambda: make_dp(init, "adam"), ):
        try:
            other().load_state_dict(state)
        except ValueError as e:
            errs.append(str(e))
    out["reject.mode"] = np.array(errs[0] if errs else "")

    # eval, redistribution, a chunk, the guard
    ev = dp.eval_step(b1)
    out["eval"] = np.array(float(ev.loss))
    full = unshard_params(dp._flat, dp._shards, dp._shard_group)
    red = build_redistribute(dp._flat, dp.layout)(dp._shards)
    out["redistribute.same"] = np.array(
        all(torch.equal(red[n], full[n]) for n in full)
        and all(torch.equal(full[n], p.detach()) for n, p in dp.model.named_parameters()))
    a, b = make_dp(init, zero=True), make_dp(init, zero=True)
    mine = [shard(x, rank, world) for x in bs]
    out["chunk.losses"] = a.train_steps_batches(tuple(torch.stack(t) for t in zip(*mine))).loss.numpy()
    out["step.losses"] = np.array([float(b.train_step(x).loss) for x in mine])
    out["chunk.maxdiff"] = np.array(max(float(np.abs(params_of(a)[k] - v).max())
                                        for k, v in params_of(b).items()))
    g = make_dp(init, zero=True, divergence_guard="skip_step")
    g.train_step(mine[0])
    before = params_of(g)
    x, y = mine[1]
    x = x.clone()
    if rank == world - 1:  # a NaN on one replica: the world skips
        x[0, 0, 0, 0] = float("nan")
    out["guard.nonfinite"] = np.array(float(g.train_step((x, y)).metrics["nonfinite"]))
    out["guard.same"] = np.array(all(np.array_equal(params_of(g)[k], v)
                                     for k, v in before.items()))
    return out


_RESULTS: dict = {}


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"world{w}")
def res(request, tmp_path_factory):
    w = request.param
    if w not in _RESULTS:
        _, init = jax_init()
        bs = batches()
        ranks = spawn(w, tmp_path_factory.mktemp(f"zero{w}"), {"init": init, "batches": bs},
                      target=_world)
        _RESULTS[w] = (w, init, bs, ranks)
    return _RESULTS[w]


def _params(r, tag):
    return {k[len(tag) + 3:]: v for k, v in r.items() if k.startswith(f"{tag}.p.")}


def _close(a: dict, b: dict, **tol):
    assert set(a) == set(b) and a
    for k in b:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


@pytest.mark.parametrize("opt", ["sgdm", "adamw"])
def test_zero_matches_replicated_trajectory(res, opt):
    _, _, _, ranks = res
    for r in ranks:
        np.testing.assert_allclose(r[f"{opt}.zero.losses"], r[f"{opt}.rep.losses"], rtol=1e-5)
        _close(_params(r, f"{opt}.zero"), _params(r, f"{opt}.rep"), atol=1e-5)
    # every rank holds the same parameters
    _close(_params(ranks[-1], f"{opt}.zero"), _params(ranks[0], f"{opt}.zero"), atol=0)


def test_zero_matches_the_jax_zero_trainer(res):
    w, _, bs, ranks = res
    losses, state, _ = jax_zero_run(w, bs)
    np.testing.assert_allclose(ranks[0]["sgdm.zero.losses"], losses, rtol=1e-5)
    got = {**_params(ranks[0], "sgdm.zero"),
           **{k[len("sgdm.zero.b."):]: v for k, v in ranks[0].items()
              if k.startswith("sgdm.zero.b.")}}
    for key, value in state.items():
        name, arr = models.weights._port_name(key, value)
        if name in got:
            np.testing.assert_allclose(got[name], arr, err_msg=key, **NET)


def test_zero_composes_with_accum_and_compression(res):
    _, _, _, ranks = res
    for r in ranks:
        np.testing.assert_allclose(r["accum.zero.losses"], r["accum.rep.losses"], rtol=1e-5)
        _close(_params(r, "accum.zero"), _params(r, "accum.rep"), atol=1e-5)
        # bf16 reduce-scatter against the bf16 all-reduce: one rounding apart
        np.testing.assert_allclose(r["bf16.zero.losses"], r["bf16.rep.losses"], rtol=1e-3)
        assert np.all(np.isfinite(r["int8.zero.losses"]))
        np.testing.assert_allclose(r["int8.zero.losses"], r["sgdm.zero.losses"], rtol=5e-2)
    # the error-feedback residual is each replica's own
    assert not np.array_equal(ranks[0]["int8.residual"], ranks[1]["int8.residual"])
    assert ranks[0]["int8.residual"].shape == (int(ranks[0]["adam.numel"][2]),)


def test_zero_state_is_sharded_and_the_step_scatters_and_gathers(res):
    w, _, _, ranks = res
    for r in ranks:
        m, v, padded, shard_world = (int(x) for x in r["adam.numel"])
        assert shard_world == w and m == v == padded // w
        t = json.loads(str(r["tallies"]))
        assert t["reduce_scatter"]["calls"] == 1 and t["all_gather"]["calls"] == 1
        assert t["reduce_scatter"]["bytes"] == 4 * padded
        # no gradient all-reduce: the psums are SyncBN's moments (2 a layer)
        assert "psum_flat" not in t and t["psum"]["bytes"] < padded
        assert r["state.exp_avg"].shape == (padded,)  # gathered: JAX's format
    np.testing.assert_array_equal(ranks[0]["state.exp_avg"], ranks[-1]["state.exp_avg"])


def test_zero_state_dict_round_trip_resumes_exactly(res):
    _, _, _, ranks = res
    for r in ranks:
        cont, resumed = r["resume"]
        assert cont == resumed
        assert "zero" in str(r["reject.mode"])


def test_zero_eval_chunk_guard_and_redistribution(res):
    _, _, _, ranks = res
    for r in ranks:
        assert np.isfinite(r["eval"])
        assert bool(r["redistribute.same"])
        np.testing.assert_allclose(r["chunk.losses"], r["step.losses"], rtol=1e-6)
        assert float(r["chunk.maxdiff"]) <= 1e-6
        assert float(r["guard.nonfinite"]) == 1.0 and bool(r["guard.same"])
    np.testing.assert_allclose(ranks[0]["eval"], ranks[-1]["eval"], rtol=1e-6)
