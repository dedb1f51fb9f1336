"""The port's audit, layer 1 (``tpu_syncbn_torch.audit``) against the JAX
package's: ``tests/test_audit_contracts.py`` case for case where layer 1
covers it, the contract cache's cases of ``tests/test_planner.py``, and
one parity case a registered program against its JAX golden.

The registry runs once for the whole run in a spawned gloo world of
``program_audit.PINNED_WORLD`` (8) CPU processes (``torch_audit_world``:
one spawn whatever the number of xdist workers and of files that read
it); each rank also records the hand-built world-8 extraction cases. Every other case reads that world's
JSON or runs in this process at world 1.

Parity with JAX (``TestJaxParity``, a case a program): the collective
kinds are equal (the port's ``broadcast`` of the GAN's buffers stands for
JAX's masked ``psum``), the bytes a step by kind are equal under the exact
relations of ``tpu_syncbn_torch/audit/DESIGN.md`` §3 (executed against
program-text counts for the pipeline and the ring, the JAX goldens'
``psum(1, axis)`` scope probes, torch's int64 ``num_batches_tracked``),
host reads are 0 on both sides but for ROADMAP C.6's pinned CPU Adam
reads, and the flops of the matmul-only programs equal JAX's
``weighted_cost_summary`` of the live JAX program.
"""

import copy
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from tpu_syncbn_torch.audit import contract_cache, program_audit, srclint
from tpu_syncbn_torch.audit.contracts import (
    ExtractionError,
    ProgramContract,
    compare_contracts,
    extract_contract,
)
from tpu_syncbn_torch.obs import telemetry

import torch_audit_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = program_audit.default_golden_dir()
JAX_GOLDEN_DIR = os.path.join(ROOT, "tests", "contracts")

#: JAX's registry programs the port does not register, and why.
NOT_REGISTERED = {"layout.serve.eval_fsdp": "the engine refuses sharded layouts (A.12c)"}


# ---------------------------------------------------------------------------
# the world-8 spawn, shared by the whole run (torch_audit_world.py)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """Each rank's JSON of the pinned world: the registry's contracts and
    costs, its extraction errors, the hand-built world-8 cases."""
    return torch_audit_world.world8_blobs(tmp_path_factory)


@pytest.fixture(scope="module")
def pinned(world8) -> dict:
    """What ``program_audit.pinned_world_contracts`` returns, from the
    shared world (``program_audit.merge_ranks``: flops the largest of any
    rank, layer 3's per-rank fields combined over the ranks)."""
    return {**program_audit.merge_ranks(copy.deepcopy(world8)), "seconds": 0.0}


@pytest.fixture(scope="module")
def live(pinned) -> dict:
    """The registry's live contracts (rank 0's, every rank agreeing)."""
    return pinned["contracts"]


# ---------------------------------------------------------------------------
# TestGoldens


class TestGoldens:
    def test_every_program_has_a_pinned_golden(self, live, pinned):
        assert pinned["errors"] == []
        violations, unpinned = program_audit.check_goldens(live, GOLDEN_DIR)
        assert unpinned == []
        assert violations == [], [v.format() for v in violations]

    def test_invariants_hold(self, live):
        vs = program_audit.check_invariants(live)
        assert vs == [], [v.format() for v in vs]

    def test_golden_files_match_registry(self):
        pinned = {f[:-len(".json")] for f in os.listdir(GOLDEN_DIR) if f.endswith(".json")}
        assert pinned == set(program_audit.PROGRAM_BUILDERS)
        jax = {f[:-len(".json")] for f in os.listdir(JAX_GOLDEN_DIR) if f.endswith(".json")}
        assert jax - pinned == set(NOT_REGISTERED) and pinned <= jax

    def test_contract_json_round_trip(self, live):
        for c in live.values():
            again = ProgramContract.from_json(json.loads(json.dumps(c.to_json())))
            assert compare_contracts(c, again) == []

    def test_schema_bump_refuses_stale_golden(self, live):
        blob = next(iter(live.values())).to_json()
        blob["schema"] = -1
        with pytest.raises(ValueError, match="re-pin"):
            ProgramContract.from_json(blob)


# ---------------------------------------------------------------------------
# TestProgramContracts


class TestProgramContracts:
    """The paper's claims, checked per program."""

    def test_train_step_reduces_bn_stats_and_updates_everything_in_place(self, live):
        c = live["dataparallel.train_step"]
        assert set(c.collectives) == {"psum"}
        assert c.collective_bytes["psum"] > 0
        assert set(c.donated_declared) == {"params", "rest", "opt_state"}
        assert c.donated_aliased == {"params": 4, "rest": 3, "opt_state": 4}
        assert "batch" not in c.donated_aliased
        assert c.host_callbacks == {}

    def test_zero_guard_adds_exactly_the_sharding_collectives(self, live):
        plain = live["dataparallel.train_step"]
        zero = live["dataparallel.zero_guard.train_step"]
        assert zero.collectives.get("all_gather", 0) >= 1
        assert zero.collectives.get("reduce_scatter", 0) >= 1
        assert zero.collectives.get("pmin", 0) == 1
        assert set(zero.collectives) == {"psum", "all_gather", "reduce_scatter", "pmin"}
        assert set(plain.collectives) == {"psum"}

    def test_scan_contract_is_k_invariant(self, live):
        k1 = live["dataparallel.scan_k1.train_steps"]
        k4 = live["dataparallel.scan_k4.train_steps"]
        assert k1.collectives == k4.collectives
        assert k1.collective_bytes == k4.collective_bytes
        assert k1.collectives == live["dataparallel.train_step"].collectives

    def test_gan_step_covers_both_networks(self, live):
        c = live["gan.train_step"]
        # the buffers' replica-0 broadcast: JAX's masked psum
        assert set(c.collectives) == {"psum", "broadcast"}
        assert c.collectives["psum"] > live["dataparallel.train_step"].collectives["psum"]
        assert c.collectives["broadcast"] == 6  # G's and D's three buffers
        assert set(c.donated_declared) == {"g_params", "g_rest", "d_params", "d_rest",
                                           "g_opt_state", "d_opt_state"}
        for label in c.donated_declared:
            assert c.donated_aliased.get(label, 0) > 0

    def test_serve_eval_is_collective_free_and_writes_nothing(self, live):
        c = live["serve.eval_bucket8"]
        assert c.collectives == {}
        assert sum(c.donated_aliased.values()) == 0
        assert c.host_callbacks == {}

    def test_pipeline_programs_ride_the_ring(self, live):
        """The forward is psum-free with one ppermute a tick (M + N − 1 =
        11); the training step two a tick (2·T), schedule-invariant but for
        the 1f1b program's armed guard."""
        from tpu_syncbn_torch.parallel import pipeline_schedule as ps

        gp = live["pipeline.gpipe"]
        assert "psum" not in gp.collectives
        assert gp.collectives["ppermute"] == 4 + program_audit.PINNED_WORLD - 1
        tg, tf = live["pipeline.train_gpipe"], live["pipeline.train_1f1b"]
        for c, sched in ((tg, "gpipe"), (tf, "1f1b")):
            assert c.collectives["ppermute"] == 2 * ps.get_schedule(sched, 4, 4).ticks
            assert "all_gather" not in c.collectives
            assert "all_to_all" not in c.collectives
            for label in ("params", "opt_state"):
                assert c.donated_aliased.get(label, 0) > 0
        assert "pmin" not in tg.collectives
        assert tf.collectives["pmin"] == 1
        assert tf.collective_bytes["pmin"] == 4

        def but_ring(c):
            return {k: v for k, v in c.collectives.items() if k not in ("pmin", "ppermute")}

        assert but_ring(tf) == but_ring(tg)


# ---------------------------------------------------------------------------
# TestPlantedMutations


def _rules(contracts) -> set:
    return {v.rule for v in program_audit.check_invariants(contracts)}


class TestPlantedMutations:
    """The golden check and the invariants fail when a program changes."""

    def test_extra_collective_is_caught(self, live):
        for name, c in live.items():
            mutated = copy.deepcopy(c)
            mutated.collectives["psum"] = mutated.collectives.get("psum", 0) + 1
            diffs = compare_contracts(mutated, c)
            assert any("collectives[psum]" in d for d in diffs), (name, diffs)

    def test_lost_in_place_leaf_is_caught(self, live):
        c = live["dataparallel.train_step"]
        mutated = copy.deepcopy(c)
        mutated.donated_aliased.pop("params")
        diffs = compare_contracts(mutated, c)
        assert any("donated_aliased[params]" in d for d in diffs), diffs

    def test_lost_in_place_leaf_also_trips_the_invariant(self, live):
        mutated = copy.deepcopy(live["dataparallel.train_step"])
        mutated.donated_aliased["opt_state"] = 0
        vs = program_audit.check_invariants({mutated.name: mutated})
        assert [v.rule for v in vs] == ["contract.donation_lost"]

    def test_new_host_read_trips_the_invariant(self, live):
        mutated = copy.deepcopy(live["dataparallel.train_step"])
        mutated.host_callbacks["_local_scalar_dense"] = 1
        vs = program_audit.check_invariants({mutated.name: mutated})
        assert [v.rule for v in vs] == ["contract.host_callback"]

    def test_serve_collective_trips_the_invariant(self, live):
        mutated = copy.deepcopy(live["serve.eval_bucket8"])
        mutated.collectives["psum"] = 1
        assert "contract.serve_collectives" in _rules({mutated.name: mutated})

    def test_scan_k_variance_trips_the_invariant(self, live):
        k4 = copy.deepcopy(live["dataparallel.scan_k4.train_steps"])
        k4.collectives["psum"] += 1
        assert "contract.scan_variance" in _rules({
            "dataparallel.scan_k1.train_steps": live["dataparallel.scan_k1.train_steps"],
            "dataparallel.scan_k4.train_steps": k4})

    def test_pipeline_mask_regression_trips_the_invariant(self, live):
        mutated = copy.deepcopy(live["pipeline.gpipe"])
        mutated.collectives["psum"] = 1
        assert "contract.pipeline_ring" in _rules({mutated.name: mutated})

    def test_pipeline_train_gather_trips_the_invariant(self, live):
        mutated = copy.deepcopy(live["pipeline.train_1f1b"])
        mutated.collectives["all_gather"] = 1
        assert "contract.pipeline_ring" in _rules({mutated.name: mutated})

    def test_pipeline_train_extra_ring_trips_the_invariant(self, live):
        mutated = copy.deepcopy(live["pipeline.train_gpipe"])
        mutated.collectives["ppermute"] += 1  # a third exchange in one tick
        assert "contract.pipeline_ring" in _rules({mutated.name: mutated})

    def test_a_rank_that_disagrees_is_named_with_the_field(self, world8):
        per_rank = [copy.deepcopy(b["contracts"]) for b in world8]
        per_rank[3]["tensor.tp_mlp"]["collective_bytes"]["psum"] += 4
        diffs = program_audit.rank_diffs(per_rank)
        assert [d[:2] for d in diffs] == [("tensor.tp_mlp", "contract.rank_divergence")]
        assert "rank 3 collective_bytes" in diffs[0][2]

    def test_world_mismatch_refuses_comparison(self, live):
        c = live["dataparallel.train_step"]
        mutated = copy.deepcopy(c)
        mutated.world = 2
        diffs = compare_contracts(mutated, c)
        assert len(diffs) == 1 and "world" in diffs[0]


# ---------------------------------------------------------------------------
# TestExtraction


class TestExtraction:
    """The recorder on hand-built bodies: it detects what it claims to."""

    def test_collective_and_bytes_detection(self, world8):
        for blob in world8:
            c = blob["extraction"]["psum"]
            assert c["collectives"] == {"psum": 1}
            assert c["collective_bytes"] == {"psum": 16}  # four f32 a replica
            rule, msg = blob["extraction"]["outside_seam"]
            assert rule == "contract.extraction" and "allreduce_" in msg

    def test_another_threads_collectives_are_not_the_bodys(self, world8):
        for blob in world8:
            assert blob["extraction"]["foreign_thread"] == blob["extraction"]["psum"]

    def test_another_threads_seam_calls_are_dropped_at_world_one(self):
        from tpu_syncbn_torch.parallel import collectives

        def body(x):
            t = threading.Thread(target=collectives._tally, args=("ppermute", [x]))
            t.start()
            t.join()
            return x * 2

        tallies = collectives._snapshot_tallies()
        try:
            rec = []
            c = extract_contract(body, (torch.ones(4),), name="t", world=1,
                                 arg_labels=("x",), recording=rec)
        finally:
            collectives._restore_tallies(tallies)
        assert rec[0].seam == [] and c.collectives == {}

    def test_host_read_detection(self):
        def body(x):
            return x.sum().item() + bool(x.any())

        c = extract_contract(body, (torch.ones(4),), name="t", world=1, arg_labels=("x",))
        assert c.host_callbacks == {"_local_scalar_dense": 2}
        p = torch.nn.Parameter(torch.ones(3))
        p.grad = torch.ones(3)
        opt = torch.optim.Adam([p], lr=0.1)
        c = extract_contract(lambda w: opt.step(), ([p],), name="t", world=1,
                             arg_labels=("params",), declared_donated=("params",))
        assert set(c.host_callbacks) == {"_local_scalar_dense@optimizer.step"}
        assert c.donated_aliased == {"params": 1}

    def test_upcast_detection_counts_widening_only(self):
        def body(x):
            wide = x.to(torch.float32)  # widening: counted
            return wide.to(torch.bfloat16)  # narrowing: not

        c = extract_contract(body, (torch.ones(4, dtype=torch.bfloat16),), name="t",
                             world=1, arg_labels=("x",))
        assert c.upcasts == {"bfloat16->float32": 1}

    def test_k_step_chunk_is_normalised_to_one_step(self):
        w = torch.zeros(4)

        def steps(k):
            def run(state, xs):
                for x in xs[:k]:
                    state[0].add_(x.float().sum())
            return run

        xs = torch.ones(3, 4, dtype=torch.bfloat16)
        one = extract_contract(steps(1), ([w], xs), name="t", world=1,
                               arg_labels=("state", "xs"), declared_donated=("state",))
        three = extract_contract(steps(3), ([w], xs), name="t", world=1,
                                 arg_labels=("state", "xs"), declared_donated=("state",),
                                 steps=3)
        assert compare_contracts(three, one) == []
        assert one.upcasts == {"bfloat16->float32": 1}
        assert torch.equal(w, torch.zeros(4))  # restored
        with pytest.raises(ExtractionError) as e:
            extract_contract(steps(2), ([w], xs), name="t", world=1,
                             arg_labels=("state", "xs"), steps=3)
        assert e.value.rule == "contract.scan_variance"

    def test_a_body_that_raises_is_undone(self):
        w = torch.zeros(4)

        def body(ws):
            ws[0].add_(1.0)
            raise ValueError("planted")

        with pytest.raises(ValueError, match="planted"):
            extract_contract(body, ([w],), name="t", world=1, arg_labels=("state",))
        assert torch.equal(w, torch.zeros(4))

    def test_replaced_leaf_shows_zero_in_place_leaves(self):
        holder = {"w": torch.zeros(4)}
        kw = dict(world=1, arg_labels=("state",), declared_donated=("state",))

        def in_place(ws):
            holder["w"].add_(1.0)

        def replaced(ws):
            holder["w"] = holder["w"] + 1.0

        ok = extract_contract(in_place, ([holder["w"]],), name="i", **kw)
        lost = extract_contract(replaced, ([holder["w"]],), name="u", **kw)
        assert ok.donated_aliased == {"state": 1}
        assert lost.donated_aliased == {}
        assert [v.rule for v in program_audit.check_invariants({"u": lost})] == \
            ["contract.donation_lost"]

    def test_lowered_train_step_records_and_leaves_the_trainer(self):
        from tpu_syncbn_torch import parallel

        spec_model = program_audit._tiny_model()
        opt = torch.optim.SGD(spec_model.parameters(), lr=0.1, momentum=0.9)
        dp = parallel.DataParallel(spec_model, opt, program_audit._mse, device="cpu")
        batch = torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
        dp.train_step(batch)
        before = {k: v.clone() for k, v in spec_model.state_dict().items()}
        moms = [st["momentum_buffer"].clone() for st in opt.state.values()]
        rng = torch.get_rng_state()
        lowered = dp.lowered_train_step(batch)
        c = lowered.contract()
        assert c.name == "dataparallel.train_step" and c.world == 1
        assert c.collectives == {} and c.host_callbacks == {}
        assert c.donated_aliased == {"params": 4, "rest": 3, "opt_state": 4}
        # the 8x8 matmul forward and its weight gradient: 2·16·8·8 each
        assert lowered.cost_analysis()["flops"] == 2 * 2 * 16 * 8 * 8
        assert "aten.mm" in lowered.as_text() or "aten.addmm" in lowered.as_text()
        for k, v in spec_model.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert all(torch.equal(st["momentum_buffer"], m)
                   for st, m in zip(opt.state.values(), moms))
        assert torch.equal(torch.get_rng_state(), rng)

    def test_lowered_train_step_that_raises_leaves_the_trainer(self):
        """A body that fails after its forward moved the BN statistics in
        place: the trainer's state is put back all the same."""
        from tpu_syncbn_torch import parallel

        spec_model = program_audit._tiny_model()
        fail = []

        def loss_fn(model, batch):
            loss = program_audit._mse(model, batch)
            if fail:
                raise ValueError("planted")
            return loss

        opt = torch.optim.SGD(spec_model.parameters(), lr=0.1, momentum=0.9)
        dp = parallel.DataParallel(spec_model, opt, loss_fn, device="cpu")
        batch = torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
        dp.train_step(batch)
        before = {k: v.clone() for k, v in spec_model.state_dict().items()}
        moms = [st["momentum_buffer"].clone() for st in opt.state.values()]
        fail.append(True)
        with pytest.raises(ValueError, match="planted"):
            dp.lowered_train_step(batch + 1.0)
        for k, v in spec_model.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert all(torch.equal(st["momentum_buffer"], m)
                   for st, m in zip(opt.state.values(), moms))


# ---------------------------------------------------------------------------
# TestAuditCLI


class TestAuditCLI:
    def test_strict_json_exits_zero_with_valid_schema(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_syncbn_torch.audit", "--strict", "--json"],
            capture_output=True, text=True, cwd=ROOT, timeout=600, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        report = json.loads(proc.stdout)
        assert set(report) == {"schema", "ok", "strict", "files_linted", "programs_checked",
                               "violations", "unpinned", "rule_counts"}
        assert report["schema"] == 1
        assert report["ok"] is True and report["strict"] is True
        assert report["violations"] == [] and report["unpinned"] == []
        assert report["programs_checked"] == len(program_audit.PROGRAM_BUILDERS)
        assert report["files_linted"] == len(srclint.package_files())

    @pytest.mark.parametrize("argv", [["plan"]])
    def test_a_later_layers_flag_is_a_usage_error(self, argv, capsys):
        from tpu_syncbn_torch.audit.__main__ import LATER_FLAGS, main

        assert main(argv) == 2
        err = capsys.readouterr().err
        assert LATER_FLAGS[argv[0].split("=")[0]] in err and "ROADMAP A.14" in err

    def test_write_goldens_prints_the_diff_and_refuses_without_force(
            self, pinned, tmp_path, monkeypatch, capsys):
        from tpu_syncbn_torch.audit.__main__ import main

        monkeypatch.setattr(program_audit, "pinned_world_contracts", lambda: pinned)
        program_audit.write_goldens(pinned["contracts"], str(tmp_path))
        path = program_audit.golden_path(str(tmp_path), "tensor.tp_mlp")
        blob = json.load(open(path))
        blob["collectives"]["psum"] = 2
        with open(path, "w") as f:
            json.dump(blob, f)
        env = dict(os.environ)
        assert main(["--write-goldens", "--golden-dir", str(tmp_path)]) == 1
        out = capsys.readouterr().out
        assert "tensor.tp_mlp: collectives[psum] = 1, golden pins 2" in out
        assert "refusing to overwrite 1 mismatching golden" in out
        assert json.load(open(path))["collectives"]["psum"] == 2
        assert main(["--write-goldens", "--force", "--golden-dir", str(tmp_path)]) == 0
        assert json.load(open(path))["collectives"]["psum"] == 1
        assert main(["--strict", "--golden-dir", str(tmp_path)]) == 0
        assert dict(os.environ) == env  # the caller's environment as it was


# ---------------------------------------------------------------------------
# TestTelemetryWiring


class TestTelemetryWiring:
    def _run(self, live):
        from tpu_syncbn_torch.audit import run_audit

        telemetry.set_enabled(True)
        telemetry.REGISTRY.reset()
        try:
            result = run_audit(lint=False, live=live, golden_dir=GOLDEN_DIR)
            return result, telemetry.snapshot()["counters"]
        finally:
            telemetry.set_enabled(None)
            telemetry.REGISTRY.reset()

    def test_audit_counters_land_in_registry(self, pinned):
        planted = copy.deepcopy(pinned)
        c = planted["contracts"]["serve.eval_bucket8"]
        c.collectives["psum"] = 1
        c.collective_bytes["psum"] = 4
        result, counters = self._run(planted)
        assert counters["audit.runs"] == 1
        assert counters["audit.programs_checked"] == result.programs_checked == 23
        assert counters["audit.violations"] == len(result.violations) > 0
        for rule, n in result.rule_counts.items():
            assert counters[f"audit.rule.{rule}"] == n
        assert set(result.rule_counts) == {"contract.serve_collectives",
                                           "contract.golden_mismatch"}

    def test_clean_run_reports_zero_violations_counter(self, pinned):
        result, counters = self._run(pinned)
        assert result.ok
        assert counters["audit.violations"] == 0


# ---------------------------------------------------------------------------
# the contract cache (tests/test_planner.py's cases)


class TestContractCache:
    def test_same_fingerprint_hits_different_layout_misses(self):
        def f(x):
            return x * 2 + 1

        args = (torch.ones(4, 4),)
        before = contract_cache.stats()
        a = contract_cache.cached_cost(f, args, name="t.cachetest", world=1)
        b = contract_cache.cached_cost(f, args, name="t.cachetest", world=1)
        assert a is b
        mid = contract_cache.stats()
        assert mid["hits"] == before["hits"] + 1
        assert mid["misses"] == before["misses"] + 1
        contract_cache.cached_cost(f, args, name="t.cachetest", world=2)
        assert contract_cache.stats()["misses"] == mid["misses"] + 1

    def test_hits_and_misses_counted_in_planner_family(self):
        def f(x):
            return x + 1

        telemetry.set_enabled(True)
        telemetry.REGISTRY.reset()
        try:
            args = (torch.ones(2),)
            contract_cache.cached_cost(f, args, name="t.counted", world=1)
            contract_cache.cached_cost(f, args, name="t.counted", world=1)
            counters = telemetry.snapshot()["counters"]
        finally:
            telemetry.set_enabled(None)
            telemetry.REGISTRY.reset()
        assert counters.get("planner.contract_cache_misses", 0) >= 1
        assert counters.get("planner.contract_cache_hits", 0) >= 1

    def test_audit_registry_rebuild_is_all_hits(self):
        names = ["dataparallel.train_step", "tensor.tp_mlp"]
        program_audit.build_contracts(names)
        before = contract_cache.stats()
        program_audit.build_contracts(names)
        after = contract_cache.stats()
        assert after["misses"] == before["misses"]
        assert after["hits"] > before["hits"]


# ---------------------------------------------------------------------------
# TestJaxParity: one case a program against its JAX golden


#: JAX goldens' ``compat.axis_size`` scope probes: ``psum(1, axis)``, 4 bytes
#: each, one a SyncBN forward that the jax they were pinned on traced
#: (``tpu_syncbn/compat.py:75``, called at ``tpu_syncbn/nn/normalization.py:46``).
JAX_SCOPE_PROBES = {"dataparallel.train_step": 1, "dataparallel.zero_guard.train_step": 1,
                    "dataparallel.scan_k1.train_steps": 1,
                    "dataparallel.scan_k4.train_steps": 1, "gan.train_step": 4}

#: Programs of matmuls alone: their flops equal JAX's weighted_cost_summary.
MATMUL_ONLY = ("tensor.tp_mlp", "expert.switch_moe",
               *(f"{fam}.compressed_{m}.train_step" for fam in ("dataparallel", "autopilot")
                 for m in ("fp32", "bf16", "int8")),
               *(f"layout.{k}.train_step" for k in ("dp", "dp_fsdp", "dp_fsdp_int8")))


def _jax_relation(name: str, kinds: dict, nbytes: dict) -> tuple[dict, dict]:
    """The port's (kinds, bytes a step) as the JAX golden writes them
    (``DESIGN.md`` §3): every relation exact."""
    from tpu_syncbn_torch.parallel import pipeline_schedule as ps

    kinds, nbytes = dict(kinds), dict(nbytes)
    world = program_audit.PINNED_WORLD
    if "broadcast" in kinds:  # the GAN's buffers: JAX's masked psum
        kinds["psum"] = kinds.get("psum", 0) + kinds.pop("broadcast")
        # three buffers a network, num_batches_tracked int64 here, int32 in JAX
        nbytes["psum"] = nbytes.get("psum", 0) + nbytes.pop("broadcast") - 4 * 2
    if name in JAX_SCOPE_PROBES:
        nbytes["psum"] += 4 * JAX_SCOPE_PROBES[name]
    if name == "pipeline.gpipe":  # executed: one a tick; text: one
        ticks = 4 + world - 1
        assert kinds["ppermute"] == ticks and nbytes["ppermute"] % ticks == 0
        kinds["ppermute"], nbytes["ppermute"] = 1, nbytes["ppermute"] // ticks
    if name.startswith("pipeline.train_"):  # executed: two a tick; text: two
        ticks = ps.get_schedule(name.split("_")[-1], 4, 4).ticks
        assert kinds["ppermute"] == 2 * ticks and nbytes["ppermute"] % ticks == 0
        kinds["ppermute"], nbytes["ppermute"] = 2, nbytes["ppermute"] // ticks
    if name == "sequence.ring_attention":  # N − 1 hops of (K, V); text: K and V
        hops = world - 1
        assert kinds["ppermute"] == hops and nbytes["ppermute"] % hops == 0
        kinds["ppermute"], nbytes["ppermute"] = 2, nbytes["ppermute"] // hops
    return kinds, nbytes


class TestJaxParity:
    @pytest.mark.parametrize("name", sorted(program_audit.PROGRAM_BUILDERS))
    def test_program_against_its_jax_golden(self, name, live, pinned):
        with open(os.path.join(JAX_GOLDEN_DIR, f"{name}.json")) as f:
            blob = json.load(f)
        jax_c = ProgramContract.from_json(blob)
        c = live[name]
        assert c.world == jax_c.world == program_audit.PINNED_WORLD
        kinds, nbytes = _jax_relation(name, c.collectives, c.collective_bytes)
        assert set(kinds) == set(jax_c.collectives)
        assert nbytes == jax_c.collective_bytes
        assert jax_c.host_callbacks == {}
        item = program_audit.HOST_READ_ITEMS.get(name)
        if item is None:
            assert c.host_callbacks == {}
        else:  # ROADMAP C.6: torch's CPU Adam reads its two bias corrections'
            # step counts on the host, for each parameter tensor it updates
            assert item == "C.6"
            assert c.host_callbacks == {"_local_scalar_dense@optimizer.step":
                                        2 * ADAM_TENSORS[name]}
        port_flops = pinned["costs"][name]["flops"]
        if name in MATMUL_ONLY:
            assert port_flops == _jax_flops(name)
        else:
            try:
                jax_flops = _jax_flops(name)
            except Exception as e:  # printed side by side only
                jax_flops = f"not traced ({type(e).__name__})"
            print(f"{name}: flops a rank, port {port_flops} (executed), JAX {jax_flops}")


#: Adam's parameter tensors on a rank in the C.6 programs: 1 flat shard
#: under a sharding layout, the MLP's 4 tensors replicated, the GAN's 4 + 4.
ADAM_TENSORS = {"dataparallel.zero_guard.train_step": 1, "layout.dp.train_step": 4,
                "layout.dp_fsdp.train_step": 1, "layout.dp_fsdp_int8.train_step": 1,
                "gan.train_step": 8}


def _jax_flops(name: str) -> int:
    """JAX's ``weighted_cost_summary`` flops of its live registry program."""
    import jax

    from tpu_syncbn.audit import contracts as jax_contracts
    from tpu_syncbn.audit import jaxpr_audit

    spec = jaxpr_audit.PROGRAM_BUILDERS[name]()
    return jax_contracts.weighted_cost_summary(
        jax.make_jaxpr(spec.fn)(*spec.example_args))["flops"]
