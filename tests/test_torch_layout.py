"""``SpecLayout`` in the port against the JAX package's
(tests/test_layout.py, case for case): presets and derived axes,
construction errors, wildcard rules, placements, legality, ``describe``,
``repr``, equality — every string equal to JAX's letter for letter on the
same axis sizes (JAX on as many of its CPU devices). At world 1 in this
process (no process group: no mesh, every group ``None``) and at a gloo
world of 4 (one spawn, several checks inside): the mesh's groups, the
composed batch group, an explicit rank order, an adopted mesh, and the
trainers' use of a layout (SyncBN rewired to the composed group, the
refusals of what does not compose).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from test_torch_compression import spawn
from tpu_syncbn_torch import nn, parallel
from tpu_syncbn_torch.mesh_axes import DATA_AXIS, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS
from tpu_syncbn_torch.parallel import collectives as C
from tpu_syncbn_torch.parallel.layout import P, SpecLayout

DERIVED = ("axis_sizes", "param_shard_axis", "data_axes", "batch_entry", "stat_axes",
           "grad_reduce_axes", "grad_scatter_axis", "grad_cross_axes", "replica_world",
           "shard_world", "world")

# (name, axis sizes, param_shard_axis, rules): the same layouts on both sides
LAYOUTS_W1 = [
    ("data_parallel", {DATA_AXIS: 1}, None, ()),
    ("zero", {DATA_AXIS: 1}, DATA_AXIS, ()),
    ("fsdp", {DATA_AXIS: 1, FSDP_AXIS: 1}, FSDP_AXIS, ()),
    ("tensor_parallel", {DATA_AXIS: 1, MODEL_AXIS: 1}, None,
     (("*/qkv/kernel", (None, MODEL_AXIS)), ("*/kernel", (MODEL_AXIS, None)))),
    ("fsdp_model", {DATA_AXIS: 1, FSDP_AXIS: 1, MODEL_AXIS: 1}, FSDP_AXIS, ()),
    ("fsdp_pipe", {DATA_AXIS: 1, FSDP_AXIS: 1, PIPE_AXIS: 1}, FSDP_AXIS, ()),
]
LAYOUTS_W4 = [
    ("data_parallel", {DATA_AXIS: 4}, None, ()),
    ("zero", {DATA_AXIS: 4}, DATA_AXIS, ()),
    ("fsdp", {DATA_AXIS: 2, FSDP_AXIS: 2}, FSDP_AXIS, ()),
    ("tensor_parallel", {DATA_AXIS: 2, MODEL_AXIS: 2}, None,
     (("*/kernel", (None, MODEL_AXIS)),)),
    ("fsdp_model", {DATA_AXIS: 1, FSDP_AXIS: 2, MODEL_AXIS: 2}, FSDP_AXIS, ()),
    ("composed_model", {DATA_AXIS: 1, FSDP_AXIS: 2, MODEL_AXIS: 2}, None, ()),
]


def port_layout(sizes, shard, rules, **kw):
    return SpecLayout(dict(sizes), param_shard_axis=shard,
                      rules=[(p, P(*spec)) for p, spec in rules], device="cpu", **kw)


def jax_layout(sizes, shard, rules):
    import jax
    from jax.sharding import PartitionSpec as JP

    from tpu_syncbn.parallel import SpecLayout as JLayout

    n = int(np.prod(list(sizes.values())))
    return JLayout(dict(sizes), param_shard_axis=shard,
                   rules=[(p, JP(*spec)) for p, spec in rules], devices=jax.devices()[:n])


def summary(lay) -> dict:
    """Every derived attribute, the reasons of each knob, describe and
    repr — as JSON-able values, so both packages' compare equal."""
    out = {k: getattr(lay, k) for k in DERIVED}
    out = json.loads(json.dumps(out))  # tuples -> lists
    out["reasons"] = {f"{c}/{g}": lay.reject_reasons(compress=c, group_size=g)
                      for c in ("none", "int8") for g in (None, 2)}
    out["describe"] = json.loads(json.dumps(lay.describe()))
    out["repr"] = repr(lay)
    out["batch_spec"] = str(lay.batch_spec)
    return out


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        return f"{type(e).__name__}: {e}"
    return ""


# -- world 1, in this process ---------------------------------------------------


@pytest.mark.parametrize("case", LAYOUTS_W1, ids=lambda c: c[0])
def test_layout_at_world_1_matches_jax(case):
    _, sizes, shard, rules = case
    assert summary(port_layout(sizes, shard, rules)) == summary(jax_layout(sizes, shard, rules))


def test_presets_at_world_1():
    assert SpecLayout.data_parallel(device="cpu") == port_layout({DATA_AXIS: 1}, None, ())
    assert SpecLayout.zero(device="cpu").param_shard_axis == DATA_AXIS
    lay = SpecLayout.fsdp(data=1, fsdp=1, device="cpu")
    assert lay.batch_entry == (DATA_AXIS, FSDP_AXIS) and lay.grad_cross_axes == (DATA_AXIS,)
    tp = SpecLayout.tensor_parallel(model=1, rules=(("*/kernel", P(None, MODEL_AXIS)),),
                                    device="cpu")
    assert tp.spec_for("block/kernel") == P(None, MODEL_AXIS) and tp.batch_entry == DATA_AXIS


def test_world_1_has_no_mesh_and_every_group_is_none():
    lay = SpecLayout.fsdp(data=1, fsdp=1, device="cpu")
    assert lay.mesh is None and lay.ranks == (0,)
    assert lay.group(FSDP_AXIS) is None and lay.group((DATA_AXIS, FSDP_AXIS)) is None
    assert lay.batch_group() is None
    with pytest.raises(ValueError, match="not in mesh"):
        lay.group(MODEL_AXIS)


CONSTRUCTION = {
    "unknown_axis": ({"replica": 1}, "auto", ()),
    "rule_names_missing_axis": ({DATA_AXIS: 1}, None, (("*", (None, MODEL_AXIS)),)),
    "shard_axis_not_batch_like": ({DATA_AXIS: 1, MODEL_AXIS: 1}, MODEL_AXIS, ()),
    "shard_axis_missing": ({DATA_AXIS: 1}, FSDP_AXIS, ()),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTION))
def test_construction_errors_are_jax_s(name):
    sizes, shard, rules = CONSTRUCTION[name]
    got = _error(lambda: port_layout(sizes, shard, rules))
    assert got and got == _error(lambda: jax_layout(sizes, shard, rules))


def test_rules_first_match_wins_like_jax():
    rules = (("*/qkv/kernel", (None, MODEL_AXIS)), ("*/kernel", (MODEL_AXIS, None)))
    lay, jl = port_layout({DATA_AXIS: 1, MODEL_AXIS: 1}, None, rules), \
        jax_layout({DATA_AXIS: 1, MODEL_AXIS: 1}, None, rules)
    for name in ("attn/qkv/kernel", "mlp/kernel", "mlp/bias", "kernel"):
        assert tuple(lay.spec_for(name)) == tuple(jl.spec_for(name)), name
    assert lay.spec_for("mlp/bias") == P()


def test_param_specs_walk_a_module_and_a_tree():
    lay = port_layout({DATA_AXIS: 1, MODEL_AXIS: 1}, None, (("fc1/*", (MODEL_AXIS,)),))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = torch.nn.Linear(2, 2)
            self.fc2 = torch.nn.Linear(2, 2)

    specs = lay.param_specs(Net())
    assert specs == {"fc1.weight": P(MODEL_AXIS), "fc1.bias": P(MODEL_AXIS),
                     "fc2.weight": P(), "fc2.bias": P()}
    tree = {"fc1": {"x": torch.zeros(2)}, "fc2": {"x": torch.zeros(2)}}
    assert lay.param_specs(tree) == {"fc1": {"x": P(MODEL_AXIS)}, "fc2": {"x": P()}}
    sh = lay.param_shardings(tree)
    assert [type(p).__name__ for p in sh["fc1"]["x"]] == ["Replicate", "Shard"]


def test_placements_come_from_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    lay = SpecLayout.fsdp(data=1, fsdp=1, device="cpu")
    assert lay.sharding(P(FSDP_AXIS)) == [Replicate(), Shard(0)]
    assert lay.sharding(P(None, (DATA_AXIS, FSDP_AXIS))) == [Shard(1), Shard(1)]
    assert lay.replicated == [Replicate(), Replicate()]
    assert lay.batch_sharding == [Shard(0), Shard(0)]
    assert repr(lay.batch_spec) == "PartitionSpec(('data', 'fsdp'),)"


def test_check_raises_with_every_reason_like_jax():
    lay = port_layout({DATA_AXIS: 1, FSDP_AXIS: 1, MODEL_AXIS: 1}, FSDP_AXIS, ())
    jl = jax_layout({DATA_AXIS: 1, FSDP_AXIS: 1, MODEL_AXIS: 1}, FSDP_AXIS, ())
    got = _error(lambda: lay.check(group_size=2))
    assert "grouped BN" in got and "fsdp×tensor" in got
    assert got == _error(lambda: jl.check(group_size=2))


def test_equality_and_hash_follow_mesh_and_rules():
    a, b = SpecLayout.fsdp(data=1, fsdp=1, device="cpu"), SpecLayout.fsdp(data=1, fsdp=1,
                                                                           device="cpu")
    c = SpecLayout.zero(device="cpu")
    assert a == b and hash(a) == hash(b) and a != c
    assert SpecLayout.data_parallel(device="cpu") != c


# -- the trainers' use of a layout, world 1 ---------------------------------------


class TinyNet(torch.nn.Module):
    def __init__(self, group_size=None):
        super().__init__()
        self.fc = torch.nn.Linear(4, 8)
        self.bn = nn.SyncBatchNorm(8, group_size=group_size, device="cpu")
        self.out = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.out(torch.relu(self.bn(self.fc(x))))


def mse(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def _dp(**kw):
    m = TinyNet()
    return parallel.DataParallel(m, torch.optim.SGD(m.parameters(), lr=0.1), mse,
                                 device="cpu", **kw)


def test_the_trainer_resolves_its_layout_as_jax_does():
    assert _dp().layout == SpecLayout.data_parallel(device="cpu")
    assert _dp(zero=True).layout == SpecLayout.zero(device="cpu")
    fsdp = SpecLayout.fsdp(data=1, fsdp=1, device="cpu")
    dp = _dp(layout=fsdp)
    assert dp.layout is fsdp and dp.zero and dp.world == 1
    assert _dp(process_group=C.ALONE).layout is None
    with pytest.raises(ValueError, match="zero=True needs a param-sharding layout"):
        _dp(zero=True, layout=SpecLayout.data_parallel(device="cpu"))
    with pytest.raises(ValueError, match="pass either layout= or mesh="):
        _dp(layout=fsdp, mesh=object())
    with pytest.raises(ValueError, match="process_group= is the 1-D"):
        _dp(layout=fsdp, process_group=C.ALONE)
    with pytest.raises(NotImplementedError, match="ROADMAP 10d"):
        _dp(layout=SpecLayout.tensor_parallel(model=1, rules=(("*", P()),), device="cpu"))


def test_gan_trainer_takes_a_replicated_layout_and_refuses_a_sharded_one():
    from tpu_syncbn_torch import models

    def nets():
        return (nn.convert_sync_batchnorm(models.DCGANGenerator(latent_dim=8, width=16,
                                                                device="cpu")),
                nn.convert_sync_batchnorm(models.DCGANDiscriminator(width=8, device="cpu")))

    g, d = nets()
    lay = SpecLayout({DATA_AXIS: 1, FSDP_AXIS: 1}, param_shard_axis=None, device="cpu")
    tr = parallel.GANTrainer(g, d, torch.optim.Adam(g.parameters()),
                             torch.optim.Adam(d.parameters()), layout=lay, device="cpu")
    assert tr.layout is lay and tr.group is None and tr.world == 1
    g, d = nets()
    for bad, msg in ((SpecLayout.fsdp(data=1, fsdp=1, device="cpu"),
                      "GANTrainer keeps params replicated — use a layout without a param "
                      "shard axis"),):
        with pytest.raises(ValueError, match=msg):
            parallel.GANTrainer(g, d, torch.optim.Adam(g.parameters()),
                                torch.optim.Adam(d.parameters()), layout=bad, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        parallel.GANTrainer(g, d, torch.optim.Adam(g.parameters()),
                            torch.optim.Adam(d.parameters()), layout=lay, group=C.ALONE,
                            device="cpu")


def test_jax_gan_trainer_refuses_the_same_sharded_layout():
    """The refusal's message is the JAX GANTrainer's."""
    import jax
    import optax
    from flax import nnx

    from tpu_syncbn import models as jmodels
    from tpu_syncbn import parallel as jparallel

    g = jmodels.DCGANGenerator(latent_dim=8, width=16, rngs=nnx.Rngs(0))
    d = jmodels.DCGANDiscriminator(width=8, rngs=nnx.Rngs(1))
    bad = jparallel.SpecLayout.fsdp(data=1, fsdp=1, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="GANTrainer keeps params replicated — use a "
                                         "layout without a param shard axis"):
        jparallel.GANTrainer(g, d, optax.adam(1e-3), optax.adam(1e-3), layout=bad)


# -- world 4 over gloo ---------------------------------------------------------------


def _ranks(group) -> list:
    return sorted(tdist.get_process_group_ranks(group)) if group is not None else []


def _world(rank, world, rdv, out_dir, inp):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world, rank=rank)
    try:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(_compute(rank), f)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), ok=np.array(1))
    finally:
        C.clear_group_cache()
        tdist.destroy_process_group()


def _compute(rank) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    out = {"summary": {name: summary(port_layout(sizes, shard, rules))
                       for name, sizes, shard, rules in LAYOUTS_W4}}
    lay = SpecLayout.fsdp(data=2, fsdp=2, device="cpu")
    out["fsdp.groups"] = {"fsdp": _ranks(lay.group(FSDP_AXIS)),
                          "data": _ranks(lay.group(DATA_AXIS)),
                          "batch_is_world": lay.batch_group() is tdist.group.WORLD}
    perm = SpecLayout.fsdp(data=2, fsdp=2, devices=[3, 2, 1, 0], device="cpu")
    out["perm.groups"] = {"fsdp": _ranks(perm.group(FSDP_AXIS)),
                          "data": _ranks(perm.group(DATA_AXIS)), "ranks": list(perm.ranks)}
    comp = port_layout({DATA_AXIS: 1, FSDP_AXIS: 2, MODEL_AXIS: 2}, None, ())
    batch = comp.batch_group()
    out["composed.batch"] = _ranks(batch)
    out["composed.cached"] = comp.batch_group() is batch
    out["composed.sum"] = float(C.psum(torch.tensor(float(rank)), batch))
    adopted = SpecLayout.from_mesh(lay.mesh, device="cpu")
    out["adopted"] = [adopted.param_shard_axis, adopted.axis_sizes, adopted == lay]
    bad = DeviceMesh("cpu", torch.arange(4).view(2, 2), mesh_dim_names=(FSDP_AXIS, DATA_AXIS))
    out["adopted.bad"] = _error(lambda: SpecLayout(mesh=bad, device="cpu"))
    # the trainers: SyncBN rewired to the composed group; a group-scoped
    # SyncBN refused; GANTrainer's groups
    m = TinyNet()
    dp = parallel.DataParallel(m, torch.optim.SGD(m.parameters(), lr=0.1), mse,
                               device="cpu", layout=comp)
    out["rewired"] = [m.bn.process_group is batch, dp.group is batch, dp.world]
    m = TinyNet(group_size=2)
    out["group_scoped"] = _error(lambda: parallel.DataParallel(
        m, torch.optim.SGD(m.parameters(), lr=0.1), mse, device="cpu",
        layout=SpecLayout.fsdp(data=2, fsdp=2, device="cpu")))
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("layout4")
    spawn(4, d, {}, target=_world)
    return [json.load(open(d / f"rank{r}.json")) for r in range(4)]


@pytest.mark.parametrize("case", LAYOUTS_W4, ids=lambda c: c[0])
def test_layout_at_world_4_matches_jax(world4, case):
    name, sizes, shard, rules = case
    want = json.loads(json.dumps(summary(jax_layout(sizes, shard, rules))))
    for r in world4:
        assert r["summary"][name] == want


def test_mesh_groups_at_world_4(world4):
    for rank, r in enumerate(world4):
        g = r["fsdp.groups"]
        # mesh (data, fsdp) = [[0, 1], [2, 3]]: fsdp rows, data columns
        assert g["fsdp"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert g["data"] == [rank % 2, rank % 2 + 2]
        assert g["batch_is_world"]
        p = r["perm.groups"]
        assert p["ranks"] == [3, 2, 1, 0]
        assert p["fsdp"] == ([2, 3] if rank >= 2 else [0, 1])


def test_composed_batch_group_spans_the_batch_axes(world4):
    for rank, r in enumerate(world4):
        # (data 1, fsdp 2, model 2) = [[[0, 1], [2, 3]]]: the batch group of
        # a rank is the ranks of its model coordinate
        assert r["composed.batch"] == [rank % 2, rank % 2 + 2]
        assert r["composed.cached"]
        assert r["composed.sum"] == float(rank % 2 + rank % 2 + 2)


def test_adopted_mesh_and_its_canonical_order(world4):
    import jax

    from tpu_syncbn.parallel import SpecLayout as JLayout

    good = JLayout.fsdp(data=2, fsdp=2, devices=jax.devices()[:4]).mesh
    bad = jax.sharding.Mesh(np.array(good.devices).reshape(2, 2), (FSDP_AXIS, DATA_AXIS))
    want = _error(lambda: JLayout(mesh=bad))
    for r in world4:
        assert r["adopted"] == [FSDP_AXIS, {DATA_AXIS: 2, FSDP_AXIS: 2}, True]
        assert r["adopted.bad"] == want and "canonical order" in want


def test_trainer_rewires_syncbn_to_the_composed_group(world4):
    for r in world4:
        assert r["rewired"] == [True, True, 2]
        assert "group-scoped SyncBN cannot ride a composed layout" in r["group_scoped"]


def test_the_training_script_takes_a_layout_at_world_2_under_the_launcher():
    """The README's world-2 launcher line with a layout: ``train.py
    --fsdp 2`` over gloo, two processes, the update sharded over both."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_syncbn_torch.launch", "--simulate-chips", "2",
         "tpu_syncbn_torch/train.py", "--", "--device", "cpu", "--epochs", "1",
         "--dataset-size", "16", "--batch-size", "8", "--fsdp", "2"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SpecLayout(data=1,fsdp=2, shard=fsdp)" in r.stdout + r.stderr
    assert "done: 2 steps, final loss" in r.stdout
