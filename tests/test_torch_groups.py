"""Replica subgroups and the rest of the collectives of the port, at world 4
over gloo, against the JAX package's functions on a 4-device CPU mesh from
the same numpy inputs:

* ``normalize_group_spec`` and ``_validate_partition`` (no process group:
  same accepted values, same exception type for each invalid class);
* ``psum_in_groups`` for contiguous (``g=2``), explicit equal
  (``((0, 3), (1, 2))``) and explicit unequal (``((0,), (1, 2, 3))``)
  groups; ``pmax``, ``pmin``, ``all_gather`` (tiled and not) and
  ``reduce_scatter``;
* ``SyncBatchNorm(group_size=...)`` forward, backward and running
  statistics against the JAX ``SyncBatchNorm(group_size=...)`` under
  ``shard_map``;
* ``convert_sync_batchnorm(group_size=2)``: every layer of a ResNet-18
  holds the same cached group, built once;
* the per-call tallies of one grouped SyncBN forward and backward.

One world-4 spawn, shared by the module; its replicas import this module,
so JAX is imported inside the tests only.

Tolerances: integer-valued sums, max and min, gathers and the scatter are
exact (``assert_array_equal``); the BN outputs, gradients and running
statistics rtol 1e-5 / atol 1e-5 (f32, the same formulas summed in
another order).
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch import models, nn, parallel
from tpu_syncbn_torch.ops import batch_norm as bn_ops
from tpu_syncbn_torch.parallel import collectives

WORLD = 4
B, C = 2, 4  # rows per replica, channels
JOIN_TIMEOUT_S = 120
F32 = dict(rtol=1e-5, atol=1e-5)
SPECS = {"g2": 2, "equal": ((0, 3), (1, 2)), "unequal": ((0,), (1, 2, 3))}


def _inputs():
    rs = np.random.RandomState(7)
    return dict(
        vals=rs.randint(-50, 50, (WORLD, 2, 3)).astype(np.float32),
        scatter=rs.randint(-50, 50, (WORLD, 8, 3)).astype(np.float32),
        x=(rs.randn(WORLD * B, 3, 3, C) * 1.5 + 0.3).astype(np.float32),
        coeff=rs.randn(WORLD * B, 3, 3, C).astype(np.float32),
        w=rs.uniform(0.5, 1.5, C).astype(np.float32),
        b=rs.randn(C).astype(np.float32),
        mask=(rs.rand(WORLD * B, 3, 3, 1) > 0.3).astype(np.float32),
        c_mean=rs.randn(C).astype(np.float32),
        c_var=rs.randn(C).astype(np.float32),
    )


def _npf(t):
    return t.detach().to(torch.float32).numpy()


def _replica(rank, rdv, out_dir, inputs):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    world = tdist.group.WORLD
    try:
        out = {}
        v = torch.from_numpy(inputs["vals"][rank])
        for name, spec in SPECS.items():
            out[f"psum_in_groups.{name}"] = _npf(
                collectives.psum_in_groups(v, world, spec))
        out["psum_in_groups.bf16"] = _npf(collectives.psum_in_groups(
            v.to(torch.bfloat16), world, 2))
        out["pmax"] = _npf(collectives.pmax(v, world))
        out["pmin"] = _npf(collectives.pmin(v, world))
        for axis in (0, 1):
            for tiled in (False, True):
                out[f"all_gather.{axis}.{tiled}"] = _npf(
                    collectives.all_gather(v, world, axis=axis, tiled=tiled))
        out["reduce_scatter"] = _npf(collectives.reduce_scatter(
            torch.from_numpy(inputs["scatter"][rank]), world))

        # one cached set of groups for a whole converted model
        collectives.clear_group_cache()
        builds = []
        real_build = collectives._build_groups
        collectives._build_groups = lambda g, p: builds.append(g) or real_build(g, p)
        model = nn.convert_sync_batchnorm(models.resnet18(
            num_classes=10, small_input=True, width=8, device="cpu"), group_size=2)
        groups = {id(m.scope_group()) for m in model.modules()
                  if isinstance(m, nn.SyncBatchNorm)}
        collectives._build_groups = real_build
        sub = collectives.group_for(2, world)
        out["convert"] = np.array([len(groups), len(builds),
                                   int(groups == {id(sub)}),
                                   tdist.get_world_size(sub)])
        # the trainer keeps the per-step buffer broadcast for a
        # group-scoped model, and skips it for a whole-world one
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        whole = nn.convert_sync_batchnorm(models.resnet18(
            num_classes=10, small_input=True, width=8, device="cpu"))
        out["broadcast"] = np.array([
            int(parallel.DataParallel(m, opt, None, device="cpu")._per_step_broadcast)
            for m in (model, whole)])

        # meshes: the one-dim data mesh reuses the default group
        from tpu_syncbn_torch import runtime

        dp = runtime.data_parallel_mesh(device="cpu")
        mesh = runtime.make_mesh({"data": 2, "model": -1}, device="cpu")
        out["mesh"] = np.array([int(dp.get_group("data") is world),
                                *mesh.mesh.shape,
                                tdist.get_world_size(mesh.get_group("data")),
                                tdist.get_world_size(mesh.get_group("model"))])

        sl = slice(rank * B, (rank + 1) * B)
        for name, spec in SPECS.items():
            bn = nn.SyncBatchNorm(C, group_size=spec, device="cpu")
            with torch.no_grad():
                bn.weight.copy_(torch.from_numpy(inputs["w"]))
                bn.bias.copy_(torch.from_numpy(inputs["b"]))
            x = torch.from_numpy(inputs["x"][sl]).requires_grad_()
            collectives.reset_tallies()
            y = bn(x)
            (y * torch.from_numpy(inputs["coeff"][sl])).sum().backward()
            out[f"tallies.{name}"] = np.array(json.dumps(collectives.tallies()))
            out[f"bytes_total.{name}"] = np.array(collectives.bytes_total())
            # the functional op with the spec computes what the module does
            y_fn, _ = bn_ops.batch_norm_train(
                torch.from_numpy(inputs["x"][sl]), None, None, None,
                torch.from_numpy(inputs["w"]), torch.from_numpy(inputs["b"]),
                process_group=world, group_size=spec)
            out[f"bn.{name}.y_fn"] = _npf(y_fn)
            # masked moments: the plain differentiable path, whose gradient
            # all-reduce must run on the same subgroup
            xm = torch.from_numpy(inputs["x"][sl]).requires_grad_()
            mean, var, cnt = bn_ops.sync_moments(
                xm, process_group=world, group_size=spec,
                mask=torch.from_numpy(inputs["mask"][sl]))
            ((mean * torch.from_numpy(inputs["c_mean"])).sum()
             + (var * torch.from_numpy(inputs["c_var"])).sum()).backward()
            out.update({f"moments.{name}.mean": _npf(mean),
                        f"moments.{name}.var": _npf(var),
                        f"moments.{name}.count": _npf(cnt),
                        f"moments.{name}.dx": _npf(xm.grad)})
            # γ/β gradients are local sums; the world sum is what the
            # trainer's all-reduce (and JAX's grad of replicated
            # parameters) adds up
            out.update({
                f"bn.{name}.y": _npf(y), f"bn.{name}.dx": _npf(x.grad),
                f"bn.{name}.dw": _npf(collectives.psum(bn.weight.grad, world)),
                f"bn.{name}.db": _npf(collectives.psum(bn.bias.grad, world)),
                f"bn.{name}.rm": _npf(bn.running_mean),
                f"bn.{name}.rv": _npf(bn.running_var),
            })
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        collectives.clear_group_cache()
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Four spawned gloo replicas, a file:// rendezvous and a hard
    deadline, so the suite cannot hang."""
    d = tmp_path_factory.mktemp("world4")
    inputs = _inputs()
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
    assert not alive, f"world-4 replicas still running after {JOIN_TIMEOUT_S}s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return inputs, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def _jax_per_rank(fn, x):
    """``fn`` under shard_map on the 4-device mesh, one (1, ...) block of
    ``x`` a device; returns the per-device results stacked."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map

    f = shard_map(lambda a: fn(a[0])[None], mesh=_mesh(), in_specs=(P("data"),),
                  out_specs=P("data"))
    return np.asarray(f(jnp.asarray(x)))


# -- spec normalization and validation, no process group ------------------


SPEC_CASES = {
    "none": None, "int": 4, "np_int": np.int64(2), "lists": [[0, 1], (2, np.int64(3))],
    "equal": ((0, 3), (1, 2)), "unequal": ((0,), (1, 2, 3)),
    "bool": True, "float_scalar": 2.5, "float_rank": ((0, 1.0), (2, 3)),
    "frac_rank": [[0, 1.9], [2, 3]], "string": "nonsense",
    "empty_group": ((0, 1, 2, 3), ()), "missing_rank": ((0, 1), (2,)),
    "duplicated_rank": ((0, 1), (1, 2, 3)), "zero": 0, "not_dividing": 3,
}


def _outcome(mod, spec, world=WORLD):
    """What ``mod`` makes of ``spec`` at ``world`` ranks: the normalized
    spec and the checked partition, or the exception type raised."""
    try:
        norm = mod.normalize_group_spec(spec)
        if norm is None or isinstance(norm, int):
            return norm
        return norm, mod._validate_partition(world, norm)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e)


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_group_spec_normalization_and_validation_match_jax(case):
    from tpu_syncbn.parallel import collectives as jc

    spec = SPEC_CASES[case]
    got, want = _outcome(collectives, spec), _outcome(jc, spec)
    assert got == want
    assert type(got) is type(want)


@pytest.mark.parametrize("case", sorted(k for k, v in SPEC_CASES.items()
                                         if v is not None))
def test_partition_accepts_and_rejects_what_psum_in_groups_does(case):
    """``partition`` (the groups a spec builds) raises where the JAX
    ``psum_in_groups`` raises on a 4-device axis, with the same type."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn.compat import shard_map
    from tpu_syncbn.parallel import collectives as jc

    spec = SPEC_CASES[case]
    f = shard_map(lambda a: jc.psum_in_groups(a, "data", spec), mesh=_mesh(),
                  in_specs=(P("data"),), out_specs=P("data"))
    try:
        f(jnp.ones((WORLD, 1)))
        want = None
    except Exception as e:  # noqa: BLE001
        want = type(e)
    try:
        collectives.partition(spec, WORLD)
        got = None
    except Exception as e:  # noqa: BLE001
        got = type(e)
    assert got is want


def test_group_for_without_a_process_group_is_local():
    """At world 1 (no process group) a spec valid for one rank means local
    statistics; one that is not raises, as at a 1-device axis."""
    t = torch.arange(3.0)
    for spec in (1, ((0,),), None):
        assert collectives.group_for(spec, None) is None
        assert collectives.psum_in_groups(t, None, spec) is t
    with pytest.raises(ValueError, match="must divide"):
        collectives.group_for(2, None)
    with pytest.raises(ValueError, match="partition"):
        collectives.group_for(((0,), (1,)), None)


# -- world 4 over gloo against the JAX functions ---------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_psum_in_groups_matches_jax(world4, name):
    from tpu_syncbn.parallel import collectives as jc

    inputs, ranks = world4
    want = _jax_per_rank(lambda a: jc.psum_in_groups(a, "data", SPECS[name]),
                         inputs["vals"])
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][f"psum_in_groups.{name}"], want[r])


def test_psum_in_groups_sums_bf16_in_f32(world4):
    """bf16 is summed in f32 and returned in bf16 (the JAX payload is
    fused to f32): exact here, as the inputs and sums are small integers."""
    from tpu_syncbn.parallel import collectives as jc

    import jax.numpy as jnp

    inputs, ranks = world4
    want = _jax_per_rank(lambda a: jc.psum_in_groups(a.astype(jnp.bfloat16),
                                                     "data", 2).astype(jnp.float32),
                         inputs["vals"])
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["psum_in_groups.bf16"], want[r])


@pytest.mark.parametrize("op", ["pmax", "pmin"])
def test_pmax_pmin_match_jax(world4, op):
    from tpu_syncbn.parallel import collectives as jc

    inputs, ranks = world4
    want = _jax_per_rank(lambda a: getattr(jc, op)(a, "data"), inputs["vals"])
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][op], want[r])


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_all_gather_matches_jax(world4, axis, tiled):
    from tpu_syncbn.parallel import collectives as jc

    inputs, ranks = world4
    want = _jax_per_rank(lambda a: jc.all_gather(a, "data", axis=axis, tiled=tiled),
                         inputs["vals"])
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][f"all_gather.{axis}.{tiled}"], want[r])


def test_reduce_scatter_matches_jax(world4):
    from tpu_syncbn.parallel import collectives as jc

    inputs, ranks = world4
    want = _jax_per_rank(lambda a: jc.reduce_scatter(a, "data"), inputs["scatter"])
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["reduce_scatter"], want[r])
        assert ranks[r]["reduce_scatter"].shape == (8 // WORLD, 3)


def _jax_grouped_bn(inputs, spec):
    """The JAX ``SyncBatchNorm(group_size=spec)`` under shard_map: y and
    each device's running statistics after one training step, and the
    gradients of sum(y · coeff) with respect to x, γ and β."""
    import jax
    import jax.numpy as jnp
    from flax import nnx
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn import compat
    from tpu_syncbn import nn as jnn

    m = jnn.SyncBatchNorm(C, group_size=spec)
    m.weight[...] = jnp.asarray(inputs["w"])
    m.bias[...] = jnp.asarray(inputs["b"])
    graphdef, params, rest = nnx.split(m, nnx.Param, ...)

    def body(params, xs, cs):
        mm = compat.nnx_merge(graphdef, params, rest, copy=True)
        y = mm(xs)
        return (y, (y * cs).sum()[None], mm.running_mean[...][None],
                mm.running_var[...][None])

    f = jax.jit(compat.shard_map(body, mesh=_mesh(),
                                 in_specs=(P(), P("data"), P("data")),
                                 out_specs=(P("data"),) * 4))
    x, coeff = jnp.asarray(inputs["x"]), jnp.asarray(inputs["coeff"])
    y, _, rm, rv = f(params, x, coeff)
    gp, gx = jax.grad(lambda p, xx: f(p, xx, coeff)[1].sum(), argnums=(0, 1))(params, x)
    return dict(y=np.asarray(y), dx=np.asarray(gx), dw=np.asarray(gp["weight"][...]),
                db=np.asarray(gp["bias"][...]), rm=np.asarray(rm), rv=np.asarray(rv))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_grouped_syncbn_matches_jax(world4, name):
    inputs, ranks = world4
    want = _jax_grouped_bn(inputs, SPECS[name])
    for key in ("y", "dx"):  # per-row outputs: each replica holds its rows
        got = np.concatenate([r[f"bn.{name}.{key}"] for r in ranks])
        np.testing.assert_allclose(got, want[key], err_msg=key, **F32)
    for rank, r in enumerate(ranks):
        for key in ("dw", "db"):
            np.testing.assert_allclose(r[f"bn.{name}.{key}"], want[key],
                                       err_msg=key, **F32)
        for key in ("rm", "rv"):  # per subgroup
            np.testing.assert_allclose(r[f"bn.{name}.{key}"], want[key][rank],
                                       err_msg=key, **F32)


def _jax_grouped_moments(inputs, spec):
    """The JAX ``sync_moments(axis_name, group_size=spec, mask)`` under
    shard_map: each device's (mean, var, count), and the gradient with
    respect to x of the sum over devices of mean·c_mean + var·c_var."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_syncbn import compat
    from tpu_syncbn.ops import batch_norm as jbn

    cm, cv = jnp.asarray(inputs["c_mean"]), jnp.asarray(inputs["c_var"])

    def body(xs, ms):
        mean, var, cnt = jbn.sync_moments(xs, axis_name="data", group_size=spec,
                                          mask=ms)
        return (mean[None], var[None], cnt[None],
                ((mean * cm).sum() + (var * cv).sum())[None])

    f = jax.jit(compat.shard_map(body, mesh=_mesh(),
                                 in_specs=(P("data"), P("data")),
                                 out_specs=(P("data"),) * 4))
    x, mask = jnp.asarray(inputs["x"]), jnp.asarray(inputs["mask"])
    mean, var, cnt, _ = f(x, mask)
    dx = jax.grad(lambda xx: f(xx, mask)[3].sum())(x)
    return dict(mean=np.asarray(mean), var=np.asarray(var), count=np.asarray(cnt),
                dx=np.asarray(dx))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_grouped_masked_moments_and_their_gradient_match_jax(world4, name):
    """``sync_moments(group_size=...)`` with a mask (the plain
    differentiable path): moments per subgroup, and a gradient whose
    all-reduce runs on the same subgroup."""
    inputs, ranks = world4
    want = _jax_grouped_moments(inputs, SPECS[name])
    for rank, r in enumerate(ranks):
        for key in ("mean", "var", "count"):
            np.testing.assert_allclose(r[f"moments.{name}.{key}"], want[key][rank],
                                       err_msg=key, **F32)
    np.testing.assert_allclose(np.concatenate([r[f"moments.{name}.dx"] for r in ranks]),
                               want["dx"], **F32)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_batch_norm_train_with_a_spec_is_the_modules_computation(world4, name):
    _, ranks = world4
    for r in ranks:
        np.testing.assert_array_equal(r[f"bn.{name}.y_fn"], r[f"bn.{name}.y"])


def test_grouped_syncbn_is_one_bn_per_group(world4):
    """The oracle's oracle: each group of the unequal partition normalizes
    its own rows, not the world's (so the groups are really apart)."""
    inputs, ranks = world4
    y = np.concatenate([r["bn.unequal.y"] for r in ranks])
    x = inputs["x"]
    for grp in SPECS["unequal"]:
        rows = np.concatenate([np.arange(g * B, (g + 1) * B) for g in grp])
        xs = x[rows].reshape(-1, C).astype(np.float64)
        ref = (xs - xs.mean(0)) / np.sqrt(xs.var(0) + 1e-5) * inputs["w"] + inputs["b"]
        np.testing.assert_allclose(y[rows].reshape(-1, C), ref, **F32)


def test_convert_sync_batchnorm_builds_one_cached_set_of_groups(world4):
    _, ranks = world4
    for r in ranks:
        n_ids, n_builds, is_cached, size = r["convert"].tolist()
        assert (n_ids, n_builds, is_cached, size) == (1, 1, 1, 2)


def test_trainer_keeps_the_buffer_broadcast_for_group_scoped_syncbn(world4):
    """As the JAX trainer does: subgroup statistics differ between
    subgroups, so rank 0's buffers are broadcast after each step; a
    whole-world SyncBN's are identical by construction."""
    _, ranks = world4
    for r in ranks:
        assert r["broadcast"].tolist() == [1, 0]


def test_modules_take_a_spec_and_refuse_what_they_cannot_honour():
    from tpu_syncbn import nn as jnn

    x = torch.zeros(2, 3, 3, C)
    with pytest.raises(ValueError, match="does not sync"):
        nn.BatchNorm2d(C, group_size=2, device="cpu")
    with pytest.raises(ValueError, match="SyncBatchNorm"):
        jnn.BatchNorm2d(C, group_size=2)  # the JAX module refuses it too
    with pytest.raises(ValueError, match="does not sync"):
        nn.BatchNorm2d(C, stats_compress="bf16", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        nn.SyncBatchNorm(C, process_group=object(), group_size=2, device="cpu")
    with pytest.raises(ValueError, match="stats_compress"):
        nn.SyncBatchNorm(C, stats_compress="int8", device="cpu")
    m = nn.SyncBatchNorm(C, group_size=[[0, 3], [1, 2]], device="cpu")
    assert m.group_size == ((0, 3), (1, 2))
    assert "group_size=((0, 3), (1, 2))" in repr(m)
    assert "group_size" not in repr(nn.SyncBatchNorm(C, device="cpu"))

    model = models.resnet18(num_classes=10, small_input=True, width=8, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        nn.convert_sync_batchnorm(model, process_group=object(), group_size=2)
    with pytest.raises(ValueError, match="stats_compress"):
        nn.convert_sync_batchnorm(model, stats_compress="bf16")
    conv = nn.convert_sync_batchnorm(model, group_size=np.int64(2))
    bns = [b for b in conv.modules() if isinstance(b, nn.SyncBatchNorm)]
    assert len(bns) == 20 and all(type(b.group_size) is int and b.group_size == 2
                                  for b in bns)
    nn.convert_sync_batchnorm(conv)  # re-scoped in place to the whole world
    assert all(b.group_size is None for b in bns)

    with pytest.raises(ValueError, match="stats_compress"):
        bn_ops.batch_norm_train(x, None, None, None, None, None, stats_compress="bf16")
    with pytest.raises(ValueError, match="stats_compress"):
        bn_ops.sync_moments(x, stats_compress="int8")


def test_meshes_over_the_process_group(world4):
    """``data_parallel_mesh``'s 'data' group is the default group (what the
    trainer and SyncBatchNorm sync over); ``make_mesh`` resolves -1."""
    _, ranks = world4
    for r in ranks:
        assert r["mesh"].tolist() == [1, 2, 2, 2, 2]


def test_tallies_of_one_grouped_syncbn_step(world4):
    """Forward: one all-reduce of (Σx, Σx², n), 2C + 1 floats; backward:
    one of (Σdy, Σdy·x̂), 2C floats. Rank 0 is alone in the unequal
    partition, so it issues none."""
    _, ranks = world4
    step = {"psum": {"calls": 2, "bytes": 4 * (2 * C + 1) + 4 * 2 * C}}
    for rank, r in enumerate(ranks):
        for name in SPECS:
            want = {} if (name, rank) == ("unequal", 0) else step
            assert json.loads(str(r[f"tallies.{name}"])) == want, (name, rank)
            assert int(r[f"bytes_total.{name}"]) == sum(
                t["bytes"] for t in want.values())
