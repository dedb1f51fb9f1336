"""The port's audit, layer 3 (``tpu_syncbn_torch.audit.sharding_audit``):
placement and per-device peak memory over the recorded step bodies,
mirroring the JAX package's ``tests/test_sharding_audit.py`` class for
class. The placement pass propagates as ``DESIGN.md`` §8 says; each
detector (accidental replication, implicit resharding, the memory budget)
is proven live by a planted case; the golden comparison pins every field;
and each registered program is held against its JAX golden's ``sharding``
block (``TestJaxParity``).

Cases that need collectives read the world-8 spawn the layer-1 suite
shares (``torch_audit_world``: one spawn for the run); the rest run here
at world 1, on a declared mesh whose axes need no collective to show.
"""

import copy
import json
import os

import pytest
import torch

from tpu_syncbn_torch.audit import program_audit, sharding_audit
from tpu_syncbn_torch.audit.contracts import (
    XLA_PEAK_RTOL,
    ProgramContract,
    Recorder,
    compare_contracts,
    compare_sharding,
    extract_contract,
    load_contract,
)
from tpu_syncbn_torch.mesh_axes import DATA_AXIS, FSDP_AXIS
from tpu_syncbn_torch.parallel.layout import P

import torch_audit_world

pytestmark = pytest.mark.audit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = program_audit.default_golden_dir()
JAX_GOLDEN_DIR = os.path.join(ROOT, "tests", "contracts")

#: A two-replica mesh declared at world 1: a value that varies over it
#: needs no collective to show.
MESH2 = {DATA_AXIS: 2}

#: Where a label's spec strings differ from JAX's golden, and why.
IN_SPEC_EXCEPTIONS = {
    # ROADMAP C.7: under a sharding layout the port keeps the module's full
    # parameters (P()) between steps beside the flat shards
    ("dataparallel.zero_guard.train_step", "params"): "C.7",
    ("layout.dp_fsdp.train_step", "params"): "C.7",
    ("layout.dp_fsdp_int8.train_step", "params"): "C.7",
    # JAX's guard count rides in opt_state (tpu_syncbn/parallel/pipeline.py:
    # 416-417); the port's is the chunk's scalar beside the optimizer's state
    ("pipeline.train_1f1b", "opt_state"): "guard count outside opt_state",
}


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return torch_audit_world.world8_blobs(tmp_path_factory)


@pytest.fixture(scope="module")
def live(world8) -> dict:
    """The registry's contracts as the pinned world reports them."""
    return program_audit.merge_ranks(copy.deepcopy(world8))["contracts"]


@pytest.fixture(scope="module")
def cases(world8) -> dict:
    """Rank 0's hand-built layer-3 cases."""
    return world8[0]["sharding_cases"]


def _flow(fn, args, specs, *, labels=None, declared=(), mesh=MESH2, **kw):
    labels = labels or [f"a{i}" for i in range(len(args))]
    c = extract_contract(fn, args, name="t", world=1, arg_labels=labels,
                         declared_donated=declared, mesh_axes=mesh, in_specs=specs, **kw)
    return c.sharding


# ---------------------------------------------------------------------------
# TestPropagation


class TestPropagation:
    def test_psum_ends_replicated_reduce_scatter_does_not(self, cases):
        assert cases["psum"]["out_specs"] == ["P()"]
        assert cases["psum"]["collectives_explained"] == 1
        assert cases["all_gather"]["out_specs"] == ["P()"]
        # a replicated operand reduce-scattered is this rank's block
        assert cases["reduce_scatter"]["out_specs"] == ["P('data')"]
        assert cases["ppermute"]["out_specs"] == ["P('data')"]
        for k in ("psum", "all_gather", "reduce_scatter", "ppermute"):
            assert cases[k]["implicit_reshards"] == 0, k
            assert cases[k]["collectives_explained"] == 1, k

    def test_a_group_the_layout_does_not_name_fails_extraction(self, cases):
        rule, msg = cases["unnamed_group"]["error"]
        assert rule == "contract.extraction"
        assert "process group" in msg

    def test_a_labels_bytes_are_counted_at_its_spec(self):
        x = torch.zeros(16, 4)
        s = _flow(lambda t: t[0], (x,), (P(DATA_AXIS),))
        assert s.in_specs == {"a0": ["P('data')"]}
        # the returned row is a view: the storage is counted once
        assert s.peak_bytes_per_device == 16 * 4 * 4
        assert s.out_specs == ["P('data')"]

    def test_a_view_keeps_its_base_placement(self):
        x, y = torch.zeros(8, 4), torch.zeros(8, 4)
        flow = sharding_audit.analyze_program(lambda a, b: (a[1:], b.t()), (x, y),
                                              mesh_axes=MESH2, in_specs=(P(None, DATA_AXIS), P()))
        assert flow.out_spec_strs() == ["P()", "P(None, 'data')"]
        rec = Recorder({"x": x}, mesh_axes=MESH2, in_specs={"x": P(DATA_AXIS)})
        with rec:
            view, copy_ = x[2:], x[2:] * 1
        assert rec.placement.placement_of(view) == rec.placement.placement_of(x) \
            == sharding_audit.LocalLayout(frozenset())
        assert rec.placement.placement_of(copy_) == rec.placement.placement_of(x)
        assert rec.placement.placement_of(torch.ones(2)) == sharding_audit.LocalLayout(
            frozenset(MESH2))

    def test_an_in_place_write_moves_the_placement(self):
        buf, x = torch.zeros(4), torch.ones(4)
        moved = _flow(lambda b, v: b.copy_(v), (buf, x), (P(), P(DATA_AXIS)),
                      labels=("state", "x"), declared=("state",))
        assert moved.out_specs == ["P('data')"]
        assert moved.implicit_reshards == 1
        assert "state P() leaf float32[4]" in moved.reshard_detail[0]
        kept = _flow(lambda b, v: b.add_(1.0), (buf, x), (P(), P(DATA_AXIS)),
                     labels=("state", "x"), declared=("state",))
        assert kept.out_specs == ["P()"] and kept.implicit_reshards == 0

    def test_foreach_ops_place_element_by_element(self):
        a, b = torch.zeros(3), torch.zeros(3)
        ga, gb = torch.ones(3), torch.ones(3)
        s = _flow(lambda x, y, u, v: torch._foreach_add_([x, y], [u, v]), (a, b, ga, gb),
                  (P(), P(DATA_AXIS), P(), P(DATA_AXIS)), labels=("a", "b", "ga", "gb"),
                  declared=("a", "b"))
        # b was declared varying, and only b's element is varying
        assert s.implicit_reshards == 0
        assert s.out_specs == ["P('data')", "P()"]

    def test_random_ops_are_varying_factories_replicated(self):
        x = torch.zeros(4)
        s = _flow(lambda t: (torch.randn(4), torch.zeros(4), torch.arange(4)), (x,), (P(),))
        assert s.out_specs == ["P('data')", "P()"]

    def test_axes_of_one_device_are_replicated(self):
        buf, x = torch.zeros(4), torch.ones(4)
        s = _flow(lambda b, v: b.copy_(v * 2), (buf, x), (P(), P(DATA_AXIS)),
                  labels=("state", "x"), declared=("state",), mesh={DATA_AXIS: 1})
        assert s.implicit_reshards == 0 and s.out_specs == ["P()"]
        assert s.max_replicated_bytes == 0  # one device: the detector is off

    def test_broadcast_spec_and_strings_equal_jaxs(self):
        import numpy as np
        from jax.sharding import PartitionSpec as JP

        from tpu_syncbn.audit import sharding_audit as jax_sa

        arg = {"a": torch.zeros(2), "b": (torch.zeros(2), torch.zeros(2))}
        jarg = {"a": np.zeros(2), "b": (np.zeros(2), np.zeros(2))}
        assert sharding_audit.broadcast_spec(P(DATA_AXIS), arg) == [P(DATA_AXIS)] * 3
        mixed = sharding_audit.broadcast_spec({"a": P(), "b": P(DATA_AXIS)}, arg)
        jmixed = jax_sa.broadcast_spec({"a": JP(), "b": JP(DATA_AXIS)}, jarg)
        assert [sharding_audit.spec_leaf_str(s) for s in mixed] \
            == [jax_sa.spec_leaf_str(s) for s in jmixed] == ["P()", "P('data')", "P('data')"]
        with pytest.raises(ValueError, match="keys"):
            sharding_audit.broadcast_spec({"a": P()}, arg)
        for entries in [(), (DATA_AXIS, None), (None, DATA_AXIS), ((DATA_AXIS, FSDP_AXIS),),
                        (None, DATA_AXIS, None, None)]:
            assert sharding_audit.spec_leaf_str(P(*entries)) \
                == jax_sa.spec_leaf_str(JP(*entries))
            assert sharding_audit.spec_to_dims(P(*entries), 4) \
                == jax_sa.spec_to_dims(JP(*entries), 4)
        assert sharding_audit.spec_leaf_str(P(None, DATA_AXIS)) == "P(None, 'data')"
        assert sharding_audit.spec_leaf_str(P((DATA_AXIS, FSDP_AXIS))) \
            == "P(('data', 'fsdp'))"

    def test_outputs_merge_over_ranks(self):
        # the pipeline's last stage returns its outputs, the others zeros:
        # varying over the axis on one rank is varying
        ranks = [[[[], "P()"]]] * 7 + [[[["pipe"], "P('pipe')"]]]
        assert sharding_audit.merge_out_leaves(ranks) == ["P('pipe')"]
        assert sharding_audit.merge_out_leaves([[[[], "P()"]]] * 2) == ["P()"]

    def test_layout_names_only_the_groups_it_holds(self):
        from tpu_syncbn_torch.parallel.layout import SpecLayout

        lay = SpecLayout.data_parallel(device="cpu")
        assert lay.group_axes(None) == ()
        assert lay.group_axes(object()) is None
        assert sharding_audit.group_axes(None, MESH2) == frozenset()
        assert sharding_audit.group_axes(object(), MESH2) is None


# ---------------------------------------------------------------------------
# TestPlantedReplication


class TestPlantedReplication:
    """Detector (a): a storage the body makes, replicated on every device,
    at or above the threshold."""

    @staticmethod
    def _body(n):
        def body(x):
            table = torch.ones(n, 256)  # built at full size on every device
            return (table.sum(0) * x).sum()

        return body

    def test_full_size_constant_is_caught(self):
        x = torch.ones(256)
        s = _flow(self._body(1024), (x,), (P(DATA_AXIS),))  # 1 MiB of f32
        assert s.replicated_intermediates == 1
        assert s.max_replicated_bytes == 1024 * 256 * 4
        assert "ones: float32[1024, 256] (1048576 B/device)" in s.replication_detail[0]
        c = ProgramContract("planted", 1, {}, {}, [], {}, {}, {}, sharding=s)
        vs = program_audit.check_sharding({"planted": c})
        assert [v.rule for v in vs] == ["sharding.replication"]
        assert "fully replicated" in vs[0].message

    def test_same_body_below_threshold_is_quiet(self):
        x = torch.ones(256)
        s = _flow(self._body(255), (x,), (P(DATA_AXIS),))
        assert s.replicated_intermediates == 0
        assert s.max_replicated_bytes == 255 * 256 * 4  # pinned below the bar
        c = ProgramContract("quiet", 1, {}, {}, [], {}, {}, {}, sharding=s)
        assert program_audit.check_sharding({"quiet": c}) == []


# ---------------------------------------------------------------------------
# TestPlantedReshard


class TestPlantedReshard:
    """Detector (b): a placement change no declared collective explains."""

    def test_an_update_from_an_unreduced_gradient_is_caught(self, cases):
        bad, good = cases["unreduced_grad"], cases["reduced_grad"]
        assert bad["implicit_reshards"] == 1
        assert "params P() leaf float32[4, 2]" in bad["reshard_detail"][0]
        assert "['data']" in bad["reshard_detail"][0]
        assert good["implicit_reshards"] == 0 and good["reshard_detail"] == []
        assert good["collectives_explained"] == 1

    def test_plain_bn_stats_are_caught_syncbn_stats_are_not(self, cases):
        plain, sync = cases["plain_bn"], cases["sync_bn"]
        # running mean and running variance, written from this rank's batch
        assert plain["implicit_reshards"] == 2
        assert all("rest P() leaf float32[4]" in d for d in plain["reshard_detail"])
        assert sync["implicit_reshards"] == 0 and sync["collectives_explained"] >= 1

    def test_check_sharding_reports_each_reshard(self, cases):
        from tpu_syncbn_torch.audit.contracts import ShardingContract

        s = ShardingContract.from_json("planted", cases["unreduced_grad"])
        c = ProgramContract("planted", 8, {}, {}, [], {}, {}, {}, sharding=s)
        vs = program_audit.check_sharding({"planted": c})
        assert [v.rule for v in vs] == ["sharding.implicit_reshard"]

    def test_a_varying_output_declared_replicated_is_caught(self):
        x = torch.ones(4)
        s = _flow(lambda t: t * 2, (x,), (P(DATA_AXIS),), out_specs=P())
        assert s.implicit_reshards == 1 and s.out_specs == ["P()"]
        assert "declared P() but varying over ['data']" in s.reshard_detail[0]
        ok = _flow(lambda t: t * 2, (x,), (P(DATA_AXIS),), out_specs=P(DATA_AXIS))
        assert ok.implicit_reshards == 0


# ---------------------------------------------------------------------------
# TestPlantedMemoryBound


class TestPlantedMemoryBound:
    """Detector (c): the per-device peak-memory contract."""

    def test_inflated_peak_breaches_the_budget(self):
        x = torch.zeros(16, 4)
        s = _flow(lambda t: t * 2, (x,), (P(DATA_AXIS),))
        assert s.peak_bytes_per_device == 2 * 16 * 4 * 4
        c = ProgramContract("planted.mem", 1, {}, {}, [], {}, {}, {}, sharding=s)
        assert program_audit.check_sharding({"planted.mem": c}, mem_budget=1 << 20) == []
        vs = program_audit.check_sharding({"planted.mem": c}, mem_budget=256)
        assert [v.rule for v in vs] == ["sharding.mem_budget"]
        assert "exceeds" in vs[0].message
        # the budget reads the larger of the two readings
        s.xla_peak_bytes = 1 << 21
        assert program_audit.check_sharding({"planted.mem": c}, mem_budget=1 << 20)

    def test_inflated_golden_peak_is_a_golden_mismatch(self, live):
        c = copy.deepcopy(live["dataparallel.train_step"])
        golden = copy.deepcopy(c)
        c.sharding.peak_bytes_per_device *= 10
        assert any("sharding.peak_bytes_per_device" in d for d in compare_contracts(c, golden))

    def test_mem_budget_flag_fails_a_tiny_budget(self, world8, monkeypatch, capsys):
        from tpu_syncbn_torch.audit.__main__ import main

        pinned = {**program_audit.merge_ranks(copy.deepcopy(world8)), "seconds": 0.0}
        monkeypatch.setattr(program_audit, "pinned_world_contracts", lambda **kw: pinned)
        assert main(["--no-lint", "--strict", "--mem-budget", "1k"]) == 1
        out = capsys.readouterr().out
        assert "[sharding.mem_budget]" in out and "exceeds the --mem-budget contract of 1024 B" in out
        assert main(["--no-lint", "--strict", "--mem-budget=2g"]) == 0

    @pytest.mark.parametrize("text,want", [("1048576", 1 << 20), ("512k", 512 << 10),
                                           ("64m", 64 << 20), ("2g", 2 << 30)])
    def test_mem_budget_takes_jaxs_forms(self, text, want):
        from tpu_syncbn_torch.audit.__main__ import _parse_bytes

        assert _parse_bytes(text) == want

    def test_an_unparsable_budget_is_a_usage_error(self, capsys):
        from tpu_syncbn_torch.audit.__main__ import main

        assert main(["--no-lint", "--mem-budget", "lots"]) == 2
        assert "cannot parse" in capsys.readouterr().err

    def test_shardings_takes_the_allocator_reading(self, world8, monkeypatch):
        from tpu_syncbn_torch.audit.__main__ import main

        pinned = {**program_audit.merge_ranks(copy.deepcopy(world8)), "seconds": 0.0}
        calls = []

        def record(**kw):
            calls.append(kw)
            return pinned

        monkeypatch.setattr(program_audit, "pinned_world_contracts", record)
        assert main(["--no-lint", "--strict", "--shardings"]) == 0
        assert calls == [{"memory": True}]


# ---------------------------------------------------------------------------
# TestShardingGoldens


class TestShardingGoldens:
    def test_every_registered_program_has_a_block(self, live):
        assert set(live) == set(program_audit.PROGRAM_BUILDERS)
        for name, c in live.items():
            assert c.sharding is not None and c.sharding.mesh_axes, name
            golden = load_contract(program_audit.golden_path(GOLDEN_DIR, name))
            assert golden.sharding is not None, name
            assert compare_contracts(c, golden) == [], name

    def test_sharding_json_round_trip(self, live):
        for c in live.values():
            again = ProgramContract.from_json(json.loads(json.dumps(c.to_json())))
            assert compare_contracts(c, again) == []
            assert again.sharding == c.sharding

    def test_sharding_schema_bump_refuses_stale_golden(self, live):
        blob = live["tensor.tp_mlp"].to_json()
        blob["sharding"]["schema"] = 2
        with pytest.raises(ValueError, match="re-pin"):
            ProgramContract.from_json(blob)

    @pytest.mark.parametrize("field,mutate", [
        ("mesh_axes", lambda s: s.mesh_axes.update(hijack=2)),
        ("in_specs", lambda s: s.in_specs["batch"].append("P()")),
        ("out_specs", lambda s: s.out_specs.append("P('model')")),
        ("collectives_explained", lambda s: setattr(s, "collectives_explained", 2)),
        ("implicit_reshards", lambda s: setattr(s, "implicit_reshards", 1)),
        ("reshard_detail", lambda s: s.reshard_detail.append("planted")),
        ("replicated_intermediates", lambda s: setattr(s, "replicated_intermediates", 3)),
        ("replication_detail", lambda s: s.replication_detail.append("planted")),
        ("max_replicated_bytes", lambda s: setattr(s, "max_replicated_bytes", 1)),
        ("peak_bytes_per_device", lambda s: setattr(s, "peak_bytes_per_device", 1)),
        ("replication_threshold", lambda s: setattr(s, "replication_threshold", 1)),
    ])
    def test_each_sharding_field_mutation_is_caught(self, live, field, mutate):
        base = live["serve.eval_bucket8"]
        c = copy.deepcopy(base)
        mutate(c.sharding)
        assert any(f"sharding.{field}" in d for d in compare_contracts(c, base))

    def test_missing_sharding_block_is_a_violation_both_ways(self, live):
        c = live["dataparallel.train_step"]
        stripped = copy.deepcopy(c)
        stripped.sharding = None
        assert any("golden pins none" in d for d in compare_contracts(c, stripped))
        assert any("registry regression" in d for d in compare_contracts(stripped, c))

    def test_xla_peak_compares_at_ten_percent(self, live):
        s = copy.deepcopy(live["dataparallel.train_step"].sharding)
        g = copy.deepcopy(s)
        assert XLA_PEAK_RTOL == 0.10
        s.xla_peak_bytes, g.xla_peak_bytes = 10_000, 10_500
        assert compare_sharding(s, g, "t") == []
        g.xla_peak_bytes = 20_000
        assert any("xla_peak_bytes" in d for d in compare_sharding(s, g, "t"))
        g.xla_peak_bytes = None  # no reading: skipped
        assert compare_sharding(s, g, "t") == []

    def test_a_repin_that_would_erase_a_reading_is_a_reviewable_diff(
            self, world8, tmp_path, monkeypatch, capsys):
        from tpu_syncbn_torch.audit.__main__ import main

        pinned = {**program_audit.merge_ranks(copy.deepcopy(world8)), "seconds": 0.0}
        monkeypatch.setattr(program_audit, "pinned_world_contracts", lambda **kw: pinned)
        program_audit.write_goldens(pinned["contracts"], str(tmp_path))
        path = program_audit.golden_path(str(tmp_path), "tensor.tp_mlp")
        blob = json.load(open(path))
        blob["sharding"]["xla_peak_bytes"] = 2784
        with open(path, "w") as f:
            json.dump(blob, f)
        assert main(["--write-goldens", "--golden-dir", str(tmp_path)]) == 1
        out = capsys.readouterr().out
        assert "would erase the memory cross-check" in out
        assert json.load(open(path))["sharding"]["xla_peak_bytes"] == 2784


# ---------------------------------------------------------------------------
# contract.fsdp_peak_memory and ROADMAP C.7


class TestFsdpPeakMemory:
    PAIR = ("layout.dp_fsdp.train_step", "layout.dp.train_step")

    def test_c7_is_the_one_pinned_pair_at_jaxs_bound(self, live):
        assert program_audit.PEAK_ITEMS == {self.PAIR: "C.7"}
        assert program_audit.FSDP_PEAK_RATIO == 0.6
        fs, dp = (live[n].sharding.peak_bytes_per_device for n in self.PAIR)
        assert fs > 0.6 * dp  # the divergence C.7 records
        assert not [v for v in program_audit.check_invariants(live)
                    if v.rule == "contract.fsdp_peak_memory"]

    def test_the_rule_names_c7_outside_the_map(self, live, monkeypatch):
        monkeypatch.setattr(program_audit, "PEAK_ITEMS", {})
        vs = [v for v in program_audit.check_invariants(live)
              if v.rule == "contract.fsdp_peak_memory"]
        assert len(vs) == 1 and "C.7" in vs[0].message and "≤ 0.6×" in vs[0].message

    def test_a_repaired_ratio_asks_to_unpin_c7(self, live):
        repaired = copy.deepcopy(live)
        dp = repaired[self.PAIR[1]].sharding.peak_bytes_per_device
        repaired[self.PAIR[0]].sharding.peak_bytes_per_device = int(0.5 * dp)
        vs = [v for v in program_audit.check_invariants(repaired)
              if v.rule == "contract.fsdp_peak_memory"]
        assert len(vs) == 1 and "C.7 is repaired" in vs[0].message

    def test_goldens_pin_both_peaks(self, live):
        for name in self.PAIR:
            golden = load_contract(program_audit.golden_path(GOLDEN_DIR, name))
            assert golden.sharding.peak_bytes_per_device \
                == live[name].sharding.peak_bytes_per_device


# ---------------------------------------------------------------------------
# the allocator's reading and the trainer's lowering


class TestAllocatorReading:
    def test_the_cpu_reading_is_at_least_the_recorded_peak(self):
        x = torch.randn(256, 64)

        def body(t):
            a = t * 2
            b = a + 1
            del a
            return b.relu().sum()

        s = _flow(body, (x,), (P(DATA_AXIS),), memory=True)
        assert s.peak_bytes_per_device == 3 * 256 * 64 * 4
        assert s.peak_bytes_per_device <= s.xla_peak_bytes
        assert s.xla_peak_bytes <= 1.25 * s.peak_bytes_per_device

    def test_lowered_train_step_runs_layer_three_on_the_trainer(self):
        from tpu_syncbn_torch import parallel

        model = program_audit._tiny_model()
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        dp = parallel.DataParallel(model, opt, program_audit._mse, device="cpu")
        batch = torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
        dp.train_step(batch)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        lowered = dp.lowered_train_step(batch, sharding=True, memory=True)
        flow = lowered.flow()
        assert flow.mesh_axes == {DATA_AXIS: 1}
        assert flow.implicit_reshards == 0 and flow.out_specs == ["P()"]
        assert flow.in_specs["batch"] == ["P('data')"]
        assert 0 < flow.peak_bytes_per_device <= flow.xla_peak_bytes
        assert lowered.contract().sharding.peak_bytes_per_device == flow.peak_bytes_per_device
        assert dp.lowered_train_step(batch).flow() is None
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# TestJaxParity: each registered program's sharding block against JAX's


@pytest.mark.parametrize("name", sorted(program_audit.PROGRAM_BUILDERS))
def test_sharding_block_against_its_jax_golden(name, live):
    port = live[name].sharding
    jax_s = load_contract(os.path.join(JAX_GOLDEN_DIR, f"{name}.json")).sharding
    assert port.mesh_axes == jax_s.mesh_axes
    assert port.replication_threshold == jax_s.replication_threshold
    assert set(port.in_specs) == set(jax_s.in_specs)
    for label, strs in port.in_specs.items():
        if (name, label) in IN_SPEC_EXCEPTIONS:
            # one side has the replicated leaves the other does not hold
            assert set(strs) ^ set(jax_s.in_specs[label]) == {"P()"}, (label, strs)
        else:
            assert strs == jax_s.in_specs[label], (label, strs, jax_s.in_specs[label])
    assert set(port.out_specs) == set(jax_s.out_specs)
    assert port.implicit_reshards == jax_s.implicit_reshards == 0
    assert port.replicated_intermediates == jax_s.replicated_intermediates == 0
    print(f"{name}: peak_bytes_per_device port {port.peak_bytes_per_device} JAX "
          f"{jax_s.peak_bytes_per_device}; max_replicated_bytes port "
          f"{port.max_replicated_bytes} JAX {jax_s.max_replicated_bytes}")
