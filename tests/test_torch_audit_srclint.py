"""The port's source lint (``tpu_syncbn_torch.audit.srclint``): every rule
fires on its planted fixture under ``tests/torch_audit_fixtures/`` and on
nothing else, near misses stay clean, suppression works, the port's own
package lints clean, each rule ported as is finds what the JAX package's
rule finds on the same sources (but for the cases ``DESIGN.md`` §7
names), the CLI's lint flags, the fixes the sweep made, and the metric
vocabulary held against what the port's producers register.

The fixtures are lint inputs only: they are never imported.
"""

import ast
import json
import os
import shutil
import subprocess
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tpu_syncbn_torch.audit import program_audit, srclint
from tpu_syncbn_torch.audit.srclint import RULES, Violation, lint_file, lint_source

pytestmark = pytest.mark.audit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "torch_audit_fixtures")
JAX_FIXTURE_DIR = os.path.join(ROOT, "tests", "audit_fixtures")

#: rule id -> (fixture file, minimum firing count). A rule without a
#: fixture that makes it fire is dead weight.
RULE_FIXTURES = {
    "raw_api_bypass": ("bad_raw_api_bypass.py", 11),
    "host_sync_in_step": ("bad_host_sync_in_step.py", 8),
    "unlocked_shared_state": ("bad_unlocked_shared_state.py", 5),
    "telemetry_name_schema": ("bad_telemetry_name_schema.py", 8),
    "unbounded_label_value": ("bad_unbounded_label_value.py", 5),
    "unpaired_trace_span": ("bad_unpaired_trace_span.py", 3),
    "wallclock_duration": ("bad_wallclock_duration.py", 3),
    "unbounded_blocking": ("bad_unbounded_blocking.py", 5),
    "hardcoded_mesh_axis": ("bad_hardcoded_mesh_axis.py", 7),
    "private_mesh_plumbing": ("bad_private_mesh_plumbing.py", 5),
    "lossy_default_mode": ("bad_lossy_default_mode.py", 4),
}

#: The JAX rules ported as is (``DESIGN.md`` §7): the same id, message
#: semantics and findings on shared sources.
PORTED_AS_IS = ("unlocked_shared_state", "telemetry_name_schema",
                "unbounded_label_value", "unpaired_trace_span",
                "wallclock_duration", "unbounded_blocking",
                "hardcoded_mesh_axis", "lossy_default_mode")


def _fixture(name: str) -> str:
    return os.path.join(FIXTURE_DIR, name)


def _lines_with(path: str, marker: str) -> set[int]:
    with open(path) as f:
        return {i + 1 for i, line in enumerate(f) if marker in line}


@pytest.fixture(scope="module")
def package_findings():
    """The port's package linted once for the module."""
    return srclint.lint_package()


# ---------------------------------------------------------------------------


class TestEveryRuleFires:
    def test_fixture_map_covers_every_rule(self):
        assert set(RULE_FIXTURES) == set(RULES)

    @pytest.mark.parametrize("rule", sorted(RULE_FIXTURES))
    def test_rule_fires_on_its_fixture(self, rule):
        fname, min_hits = RULE_FIXTURES[rule]
        violations = lint_file(_fixture(fname))
        hits = [v for v in violations if v.rule == rule]
        assert len(hits) >= min_hits, [v.format() for v in violations]
        # single-purpose: no OTHER rule fires on it
        assert {v.rule for v in violations} == {rule}
        # every planted line fires, and only planted lines do
        assert {v.line for v in hits} == _lines_with(_fixture(fname), "# bad")
        for v in hits:
            assert v.line >= 1 and v.path.endswith(fname)

    def test_clean_fixture_has_no_findings(self):
        violations = lint_file(_fixture("clean.py"))
        assert violations == [], [v.format() for v in violations]


class TestPackageClean:
    def test_the_port_lints_clean(self, package_findings):
        assert package_findings == [], [v.format() for v in package_findings]

    def test_package_files_are_every_port_module(self):
        files = srclint.package_files()
        pkg = os.path.join(ROOT, "tpu_syncbn_torch")
        want = sorted(os.path.join(d, f) for d, dirs, fs in os.walk(pkg)
                      if "__pycache__" not in d and "_build" not in d
                      for f in fs if f.endswith(".py"))
        assert files == want and len(files) >= 87
        names = {os.path.relpath(f, pkg) for f in files}
        assert {"audit/srclint.py", "parallel/collectives.py", "serve/engine.py",
                "bench.py"} <= names

    def test_the_lint_imports_only_the_standard_library(self):
        with open(srclint.__file__) as f:
            tree = ast.parse(f.read())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                mods.add((node.module or "").split(".")[0])
        assert mods == {"__future__", "ast", "dataclasses", "os", "re", "typing"}


class TestSuppression:
    SRC = (
        "import torch.distributed as tdist\n"
        "def f(t):\n"
        "    tdist.all_reduce(t)  {comment}\n"
    )

    def test_bare_ok_suppresses(self):
        assert lint_source(self.SRC.format(comment="# audit: ok"), "x.py") == []

    def test_rule_scoped_ok_suppresses_that_rule(self):
        src = self.SRC.format(comment="# audit: ok[raw_api_bypass]")
        assert lint_source(src, "x.py") == []

    def test_wrong_rule_id_does_not_suppress(self):
        src = self.SRC.format(comment="# audit: ok[host_sync_in_step]")
        assert [v.rule for v in lint_source(src, "x.py")] == ["raw_api_bypass"]

    def test_fixture_suppression_line_not_reported(self):
        path = _fixture("bad_raw_api_bypass.py")
        suppressed = _lines_with(path, "audit: ok")
        assert suppressed
        assert not {v.line for v in lint_file(path)} & suppressed

    def test_every_suppression_in_the_port_gives_a_reason(self):
        """Each ``# audit: ok`` in the package is rule-scoped and has a
        comment in the three lines above it."""
        for path in srclint.package_files():
            with open(path) as f:
                lines = f.read().splitlines()
            for i, line in enumerate(lines):
                if "# audit: ok" not in line or path == srclint.__file__:
                    continue
                assert "# audit: ok[" in line, f"{path}:{i + 1}"
                above = [ln.strip() for ln in lines[max(0, i - 3):i]]
                assert any(ln.startswith("#") for ln in above), f"{path}:{i + 1}"


class TestRuleEdges:
    """Near-miss semantics pinned a rule."""

    # -- host_sync_in_step ---------------------------------------------------

    def test_tolist_after_the_replay_is_clean_inside_a_body_fires(self):
        after = (
            "import torch\n"
            "class T:\n"
            "    def _run_scanned(self, batch):\n"
            "        out = self.prog(batch)\n"
            "        return out, torch.stack([self.c.taken]).tolist()\n"
        )
        assert lint_source(after, "x.py") == []
        inside = after.replace("_run_scanned", "_chunk_step")
        assert [v.rule for v in lint_source(inside, "x.py")] == ["host_sync_in_step"]

    @pytest.mark.parametrize("call,fires", [
        ("F.one_hot(y)", True),
        ("torch.nn.functional.one_hot(y)", True),
        ("F.one_hot(y, num_classes=8)", False),
        ("F.one_hot(y, 8)", False),
        ("y.repeat_interleave(r)", True),
        ("torch.repeat_interleave(y, r)", True),
        ("torch.repeat_interleave(r)", True),
        ("y.repeat_interleave(r, output_size=16)", False),
        ("y.repeat_interleave(2)", False),
        ("torch.where(y)", True),
        ("torch.where(y > 0, y, 0.0)", False),
        ("torch.nonzero(y)", True),
        ("y.nonzero()", True),
        ("torch.unique(y)", True),
        ("y.masked_select(y > 0)", True),
        ("torch.argwhere(y)", True),
        ("y.to('cuda', non_blocking=True)", False),
        ("torch.cuda.synchronize()", True),
        ("torch.cuda.current_stream().synchronize()", True),
        ("y.cpu()", True),
        ("y.numpy()", True),
        ("y.item()", True),
        ("y.tolist()", True),
    ])
    def test_host_sync_forms_in_a_body(self, call, fires):
        src = ("import torch\nimport torch.nn.functional as F\n"
               f"def _forward(y, r):\n    return {call}\n")
        vs = lint_source(src, "x.py")
        assert [v.rule for v in vs] == (["host_sync_in_step"] if fires else [])

    SYNC_FORM_SNIPPETS = {
        ".item()": "y.item()", ".tolist()": "y.tolist()", ".cpu()": "y.cpu()",
        ".numpy()": "y.numpy()", "torch.cuda.synchronize": "torch.cuda.synchronize()",
        "stream.synchronize()": "torch.cuda.current_stream().synchronize()",
        "event.synchronize()": "torch.cuda.Event().synchronize()",
        "torch.nonzero": "torch.nonzero(y)", ".nonzero()": "y.nonzero()",
        "torch.unique": "torch.unique(y)", ".unique()": "y.unique()",
        "torch.masked_select": "torch.masked_select(y, y > 0)",
        ".masked_select()": "y.masked_select(y > 0)", "torch.argwhere": "torch.argwhere(y)",
        ".argwhere()": "y.argwhere()", "torch.where(condition)": "torch.where(y)",
        "one_hot without num_classes": "F.one_hot(y)",
        "repeat_interleave without output_size": "y.repeat_interleave(r)",
    }

    def test_every_form_the_card_gate_runs_is_flagged(self):
        """``chip_smoke.py`` ``[audit]`` gate (b) runs each of
        ``HOST_SYNC_FORMS`` on the card; each is a form the rule flags."""
        assert tuple(self.SYNC_FORM_SNIPPETS) == srclint.HOST_SYNC_FORMS
        assert srclint.NOT_OBSERVABLE < set(srclint.HOST_SYNC_FORMS)
        for form, call in self.SYNC_FORM_SNIPPETS.items():
            src = ("import torch\nimport torch.nn.functional as F\n"
                   f"def _chunk_step(y, r):\n    return {call}\n")
            assert [v.line for v in lint_source(src, "x.py")] == [4], form

    def test_nested_def_in_a_body_reported_once(self):
        src = (
            "class T:\n"
            "    def _program_body(self):\n"
            "        def step(k, batch):\n"
            "            def inner(x):\n"
            "                return x.item()\n"
            "            return inner(batch)\n"
            "        return build_scan_steps(step, n_steps=1)\n"
        )
        vs = lint_source(src, "x.py")
        assert len(vs) == 1 and vs[0].rule == "host_sync_in_step"

    def test_partial_and_self_method_entries_are_bodies(self):
        src = (
            "import functools\n"
            "class T:\n"
            "    def step(self, chunk, k, b):\n"
            "        return b.item()\n"
            "    def build(self, c):\n"
            "        return build_scan_steps(functools.partial(self.step, c))\n"
            "def free(k, b):\n"
            "    return b.cpu()\n"
            "def build2():\n"
            "    return build_scan_steps(lambda k, b: b.tolist(), n_steps=2), \\\n"
            "        build_scan_steps(step_fn=free)\n"
        )
        assert [v.line for v in lint_source(src, "x.py")] == [4, 8, 10]

    def test_capture_setup_is_clean_the_captured_block_is_not(self):
        src = (
            "import torch\n"
            "def _capture(self, x, graph):\n"
            "    torch.cuda.synchronize()\n"
            "    with torch.cuda.graph(graph):\n"
            "        y = x.sum()\n"
            "        y.item()\n"
            "    torch.cuda.synchronize()\n"
            "def prepare(x, graph):\n"
            "    with torch.cuda.graph(graph, capture_error_mode='thread_local'):\n"
            "        x.tolist()\n"
            "    return x.item()\n"
        )
        assert [v.line for v in lint_source(src, "x.py")] == [6, 10]

    def test_the_bodies_the_card_captures_are_step_bodies(self):
        """The CPU half of ``chip_smoke.py`` ``[audit]`` gate (c): the
        trainer's ``_chunk_step`` and the engine's ``_forward`` — and the
        GAN's and the pipeline's bodies — are among the defs the rule
        classifies, by file and first line."""
        from tpu_syncbn_torch.parallel import gan_trainer, pipeline, trainer
        from tpu_syncbn_torch.serve import engine

        for fn in (trainer.DataParallel._chunk_step, engine.InferenceEngine._forward,
                   gan_trainer.GANTrainer._iteration, pipeline.PipelineTrainer._chunk_step):
            code = fn.__code__
            with open(code.co_filename) as f:
                tree = ast.parse(f.read())
            firsts = {f.lineno for f in srclint.step_body_functions(tree)}
            assert code.co_firstlineno in firsts, fn.__qualname__

    # -- raw_api_bypass ------------------------------------------------------

    def test_the_port_wrapper_is_clean_a_raw_barrier_is_not(self):
        src = ("from tpu_syncbn_torch.runtime import distributed as dist\n"
               "import torch.distributed as tdist\n"
               "def f():\n    dist.barrier('x')\n    tdist.barrier()\n")
        vs = lint_source(src, "tpu_syncbn_torch/utils/metrics.py")
        assert [(v.rule, v.line) for v in vs] == [("raw_api_bypass", 5)]
        assert "parallel.collectives" in vs[0].message

    @pytest.mark.parametrize("path,api,allowed", [
        ("tpu_syncbn_torch/runtime/distributed.py", "barrier()", True),
        ("tpu_syncbn_torch/runtime/distributed.py", "broadcast(t, src=0)", False),
        ("tpu_syncbn_torch/utils/checkpoint.py", "broadcast(t, src=0)", True),
        ("tpu_syncbn_torch/utils/checkpoint.py", "barrier()", False),
        ("tpu_syncbn_torch/parallel/collectives.py", "all_to_all_single(t, t)", True),
        ("tpu_syncbn_torch/parallel/trainer.py", "all_reduce(t)", False),
    ])
    def test_the_control_plane_allowlist_is_by_file_and_api(self, path, api, allowed):
        src = f"import torch.distributed as tdist\ndef f(t):\n    tdist.{api}\n"
        assert (lint_source(src, path) == []) == allowed

    def test_the_raw_profiler_lives_in_obs_profiling_alone(self):
        src = ("import torch\nfrom torch.profiler import profile, record_function\n"
               "def f():\n    with record_function('x'):\n        return profile()\n")
        assert lint_source(src, "tpu_syncbn_torch/obs/profiling.py") == []
        vs = lint_source(src, "tpu_syncbn_torch/obs/server.py")
        assert [v.line for v in vs] == [2] and "obs.profiling" in vs[0].message
        label = "import torch\ndef f():\n    return torch.profiler.record_function('x')\n"
        assert lint_source(label, "tpu_syncbn_torch/obs/tracing.py") == []

    # -- unlocked_shared_state / unbounded_blocking refinements ----------------

    def test_a_helper_called_only_under_the_lock_is_clean(self):
        src = (
            "import threading\n"
            "class R:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self.reads = {}\n"
            "    def _read(self, k):\n"
            "        self.reads[k] = 1\n"
            "    def on_op(self, k):\n"
            "        with self._lock:\n"
            "            self._read(k)\n"
        )
        assert lint_source(src, "x.py") == []
        escaped = src + "    def hook(self):\n        return self._read\n"
        assert [v.line for v in lint_source(escaped, "x.py")] == [7]

    def test_a_module_accessor_is_not_a_queue(self):
        src = (
            "import threading\n"
            "from tpu_syncbn_torch.obs import memwatch\n"
            "def f(q):\n"
            "    threading.Thread(target=print).start()\n"
            "    return memwatch.get(), q.get()\n"
        )
        vs = lint_source(src, "x.py")
        assert [(v.rule, v.col) for v in vs] == [("unbounded_blocking", 27)]

    # -- the layout rules ----------------------------------------------------

    def test_mesh_axis_literals_are_allowed_in_the_constants_module(self):
        src = "DATA_AXIS = 'data'\nMODEL_AXIS = 'model'\n"
        assert lint_source(src, "tpu_syncbn_torch/mesh_axes.py") == []
        assert len(lint_source(src, "tpu_syncbn_torch/parallel/other.py")) == 2
        # the JAX package's constants module is not the port's
        assert len(lint_source(src, "tpu_syncbn/mesh_axes.py")) == 2

    def test_mesh_constructors_are_allowed_in_the_layout_layer(self):
        src = ("import torch.distributed as tdist\n"
               "def f(r):\n    return tdist.new_subgroups_by_enumeration(r)\n")
        for path in ("tpu_syncbn_torch/parallel/layout.py",
                     "tpu_syncbn_torch/parallel/collectives.py",
                     "tpu_syncbn_torch/runtime/distributed.py"):
            assert lint_source(src, path) == []
        assert len(lint_source(src, "tpu_syncbn_torch/parallel/tensor.py")) == 1

    def test_syntax_error_reports_parse_error(self):
        assert [v.rule for v in lint_source("def broken(:\n", "x.py")] == ["parse_error"]

    def test_rule_subset_selection(self):
        assert lint_file(_fixture("bad_raw_api_bypass.py"),
                         rules=["telemetry_name_schema"]) == []


class TestViolationObject:
    def test_format_and_json_round_trip(self):
        v = Violation(rule="raw_api_bypass", message="m", path="p.py", line=3, col=7)
        assert v.format() == "p.py:3: [raw_api_bypass] m"
        assert v.to_json() == {"rule": "raw_api_bypass", "message": "m",
                               "path": "p.py", "line": 3, "col": 7}

    def test_lineless_violation_formats_without_position(self):
        v = Violation(rule="contract.golden_mismatch", message="m",
                      path="<recording>", line=0)
        assert v.format() == "<recording>: [contract.golden_mismatch] m"

    def test_one_finding_type_for_both_layers(self):
        from tpu_syncbn_torch import audit

        assert program_audit.Violation is srclint.Violation is audit.Violation


# ---------------------------------------------------------------------------


class TestJaxParity:
    """Each rule ported as is finds the JAX rule's ``(rule, line)`` set on
    the same sources; the differences are exactly the cases ``DESIGN.md``
    §7 names."""

    @staticmethod
    def _pairs(lint, src, path, rule):
        return {(v.rule, v.line) for v in lint(src, path, rules=[rule])}

    @pytest.mark.parametrize("rule", PORTED_AS_IS)
    def test_jax_fixtures(self, rule):
        from tpu_syncbn.audit import srclint as jax_srclint

        for name in (f"bad_{rule}.py", "clean.py"):
            path = os.path.join(JAX_FIXTURE_DIR, name)
            with open(path) as f:
                src = f.read()
            assert self._pairs(lint_source, src, path, rule) == \
                self._pairs(jax_srclint.lint_source, src, path, rule), name

    @pytest.mark.parametrize("rule", PORTED_AS_IS)
    def test_port_fixtures(self, rule):
        """On the port's fixtures the two differ only where §7 says."""
        from tpu_syncbn.audit import srclint as jax_srclint

        named = {
            # JAX's rule is lexical: a helper every caller locks is flagged
            "unlocked_shared_state": ("# ok: every caller holds the lock", "jax"),
            # JAX's reads every bare .get() as a queue's
            "unbounded_blocking": ("# ok: a module's accessor", "jax"),
            # the port's positions: init_device_mesh/DeviceMesh's
            # mesh_dim_names=, mesh[...], SpecLayout.group, param_shard_axis=
            "hardcoded_mesh_axis": ("# audit: ok[private_mesh_plumbing]|mesh[\"fsdp\"]"
                                    "|layout.group(|param_shard_axis=", "port"),
        }
        for name in (f"bad_{rule}.py", "clean.py"):
            path = _fixture(name)
            with open(path) as f:
                src = f.read()
            port = self._pairs(lint_source, src, path, rule)
            jax = self._pairs(jax_srclint.lint_source, src, path, rule)
            want_jax_only, want_port_only = set(), set()
            if rule in named:
                markers, side = named[rule]
                lines = set()
                for m in markers.split("|"):
                    lines |= _lines_with(path, m)
                (want_jax_only if side == "jax" else want_port_only).update(
                    (rule, n) for n in lines)
                assert lines or name == "clean.py"
            assert jax - port == want_jax_only, name
            assert port - jax == want_port_only, name

    def test_the_port_files_of_the_sweep(self, package_findings):
        """JAX's ported-as-is rules over the port's files that held the
        sites they flagged before the sweep find the sites §7 names and
        nothing else the port's rules do not find."""
        from tpu_syncbn.audit import srclint as jax_srclint

        swept = ("audit/contracts.py", "bench.py", "obs/memwatch.py", "mesh_axes.py",
                 "serve/engine.py", "utils/checkpoint.py")
        jax = []
        for rel in swept:
            path = os.path.join(srclint.PKG_ROOT, rel)
            with open(path) as f:
                jax += jax_srclint.lint_source(f.read(), path, rules=list(PORTED_AS_IS))
        port = {(v.rule, v.path, v.line) for v in package_findings
                if v.rule in PORTED_AS_IS}
        extra = sorted((v.rule, os.path.relpath(v.path, ROOT), v.message.split(":")[0])
                       for v in jax if (v.rule, v.path, v.line) not in port)
        rules = [(r, p) for r, p, _ in extra]
        # the recorder's helpers called under its lock (_host_read, _on_wire)
        assert rules.count(("unlocked_shared_state",
                            "tpu_syncbn_torch/audit/contracts.py")) == 3
        # the installed-instance accessors, bound by import
        assert sorted(m for r, p, m in extra if r == "unbounded_blocking") == [
            "flightrec.get", "flightrec.get", "memwatch.get"]
        # the constants module under the port's path
        assert rules.count(("hardcoded_mesh_axis", "tpu_syncbn_torch/mesh_axes.py")) == 3
        assert len(extra) == 9, extra


# ---------------------------------------------------------------------------


class TestCLI:
    def _main(self, argv, capsys):
        from tpu_syncbn_torch.audit.__main__ import main

        rc = main(argv)
        out = capsys.readouterr()
        return rc, out.out, out.err

    def test_no_contracts_strict_over_the_package_exits_zero(self, capsys):
        rc, out, _ = self._main(["--no-contracts", "--strict", "--json"], capsys)
        report = json.loads(out)
        assert rc == 0 and report["ok"] is True
        assert report["files_linted"] == len(srclint.package_files())
        assert report["programs_checked"] == 0 and report["violations"] == []

    def test_the_fixtures_exit_one_every_rule_firing(self, capsys):
        rc, out, _ = self._main(["--root", FIXTURE_DIR, "--no-contracts", "--json"], capsys)
        report = json.loads(out)
        assert rc == 1
        assert set(report["rule_counts"]) == set(RULES)
        assert all(not v["path"].endswith("clean.py") for v in report["violations"])

    def test_rules_subset_and_text_report(self, capsys):
        rc, out, _ = self._main(["--root", FIXTURE_DIR, "--no-contracts",
                                 "--rules", "lossy_default_mode"], capsys)
        assert rc == 1
        assert out.count("[lossy_default_mode]") == 4
        assert out.splitlines()[-1] == ("audit: 13 files linted, 0 programs checked, "
                                        "4 violation(s)")

    def test_an_unknown_rule_is_a_usage_error(self, capsys):
        rc, _, err = self._main(["--rules", "no_such_rule"], capsys)
        assert rc == 2 and "unknown rule(s): no_such_rule" in err

    @pytest.mark.parametrize("argv,item", [(["plan"], "A.14c")])
    def test_later_layers_still_exit_two(self, argv, item, capsys):
        rc, _, err = self._main(argv, capsys)
        assert rc == 2 and f"ROADMAP {item}" in err

    def test_changed_only_skips_contracts_for_a_lint_only_change(self, monkeypatch, capsys):
        from tpu_syncbn_torch.audit import __main__ as cli

        pkg = srclint.PKG_ROOT
        changed = [os.path.join(pkg, "obs", "flightrec.py"), os.path.join(pkg, "bench.py")]
        monkeypatch.setattr(cli, "_changed_files", lambda ref, root: list(changed))
        rc, out, err = self._main(["--changed-only", "HEAD", "--json"], capsys)
        report = json.loads(out)
        assert rc == 0 and report["files_linted"] == 2
        assert report["programs_checked"] == 0
        assert "skipping the contract layer" in err
        assert cli._touches_programs([os.path.join(pkg, "parallel", "trainer.py")], pkg)
        assert cli._touches_programs([os.path.join(pkg, "mesh_axes.py")], pkg)
        assert not cli._touches_programs(changed, pkg)

    def test_changed_only_falls_back_loudly_when_git_fails(self, monkeypatch, capsys):
        from tpu_syncbn_torch.audit import __main__ as cli

        monkeypatch.setattr(cli, "_changed_files", lambda ref, root: None)
        rc, out, err = self._main(["--changed-only", "nope", "--root", FIXTURE_DIR,
                                   "--no-contracts", "--json"], capsys)
        assert rc == 1 and "falling back to the full sweep" in err
        assert json.loads(out)["files_linted"] == len(srclint.package_files(FIXTURE_DIR))

    @pytest.mark.skipif(shutil.which("git") is None, reason="needs git")
    def test_changed_only_against_head_in_a_git_repository(self, tmp_path, capsys):
        """A package in a temporary repository: one file committed then
        edited, one untracked with a planted finding, one unchanged."""
        pkg = tmp_path / "pkg"
        pkg.mkdir()
        (pkg / "kept.py").write_text("X = 1\n")
        (pkg / "edited.py").write_text("Y = 1\n")
        script = (
            "git init -q && git -c user.email=a@b -c user.name=a add -A && "
            "git -c user.email=a@b -c user.name=a commit -qm seed && "
            "echo 'Y = 2' > pkg/edited.py && "
            "printf 'def f(mode=\"int8\"):\\n    return mode\\n' > pkg/new.py"
        )
        subprocess.run(["sh", "-c", script], cwd=tmp_path, check=True, timeout=60,
                       capture_output=True)
        rc, out, _ = self._main(["--changed-only", "HEAD", "--root", str(pkg),
                                 "--no-contracts", "--json"], capsys)
        report = json.loads(out)
        assert rc == 1 and report["files_linted"] == 2
        assert [(os.path.basename(v["path"]), v["rule"]) for v in report["violations"]] \
            == [("new.py", "lossy_default_mode")]


# ---------------------------------------------------------------------------


class TestSweepFixes:
    def test_bench_joins_its_clients_within_a_deadline(self):
        from tpu_syncbn_torch import bench

        done = [threading.Thread(target=lambda: None) for _ in range(3)]
        for th in done:
            th.start()
        bench._join_clients(done, timeout_s=10.0)
        stop = threading.Event()
        wedged = threading.Thread(target=stop.wait, name="client-7", daemon=True)
        wedged.start()
        t0 = time.monotonic()
        try:
            with pytest.raises(RuntimeError, match="client-7"):
                bench._join_clients(done + [wedged], timeout_s=0.2)
            assert time.monotonic() - t0 < 5.0
        finally:
            stop.set()
            wedged.join(timeout=5.0)

    def test_recorder_optimizer_hooks_take_its_lock(self):
        """The global step hooks run on whichever thread steps an
        optimizer: they bump the recorder's counter under its lock."""
        from tpu_syncbn_torch.audit.contracts import Recorder

        p = torch.nn.Parameter(torch.ones(2))
        p.grad = torch.ones(2)
        opt = torch.optim.SGD([p], lr=0.1)
        with Recorder({}) as rec:
            rec._lock.acquire()
            th = threading.Thread(target=opt.step, daemon=True)
            try:
                th.start()
                th.join(timeout=0.3)
                assert th.is_alive()  # waiting for the lock the test holds
            finally:
                rec._lock.release()
            th.join(timeout=10.0)
            assert not th.is_alive()
            assert rec._in_optimizer == 0
        assert torch.allclose(p.detach(), torch.full((2,), 0.9))

    def test_recorder_publishes_written_whole(self):
        from tpu_syncbn_torch.audit.contracts import Recorder

        a, b = torch.zeros(3), torch.zeros(3)
        with Recorder({"a": [a], "b": [b]}) as rec:
            a.add_(1.0)
        assert rec.written == {"a": 1, "b": 0}


# ---------------------------------------------------------------------------


class TestVocabulary:
    """Every name the port's producers register has a first token in
    ``KNOWN_METRIC_PREFIXES`` and label keys in ``LABEL_KEYS`` — the
    runtime half of ``telemetry_name_schema``."""

    def _produce(self, tmp_path):
        from tpu_syncbn_torch import audit, serve
        from tpu_syncbn_torch.obs import (
            flightrec, memwatch, numerics, profiling, server, slo, stepstats,
            telemetry, timeseries, tracing,
        )
        from tpu_syncbn_torch.runtime.autopilot import Autopilot
        from tpu_syncbn_torch.serve.admission import CircuitBreaker
        from tpu_syncbn_torch.utils import checkpoint

        class _Engine:
            max_bucket = 4
            version = 0
            previous_version = None

            def bucket_for(self, n):
                return 4

            def predict(self, b):
                return np.asarray(b) * 2.0

            def swap_params(self, params, rest=None, *, version):
                old, self.version, self.previous_version = self.version, version, self.version
                return old

            def rollback(self):
                self.version, self.previous_version = self.previous_version, self.version
                return self.version

        class _Trainer:
            compress = "int8"
            program_caches = ()

            def set_compress(self, mode):
                self.compress = mode
                return True

        with serve.DynamicBatcher(_Engine(), max_batch=4, max_wait_ms=5,
                                  tenant="steady") as bat:
            bat.submit(np.ones((1, 1), np.float32)).result(timeout=30)
        CircuitBreaker(failure_threshold=1, key="tenant_b").record_failure()
        ctl = serve.SwapController(_Engine(), health_name="vocab_publication")
        try:
            ctl.swap({"w": 1.0}, version=1)
            ctl.rollback(reason="vocabulary drill")
            ctl._reject(version=2, source="vocab", reason="corrupt")
        finally:
            ctl.close()
        checkpoint.publish_version(str(tmp_path / "pub"), 1,
                                   {"w": np.zeros(2, np.float32)})
        agg = timeseries.WindowedAggregator()
        agg.tick(now=0.0)
        telemetry.observe("step.time_s", 0.01)
        with stepstats.timed_span("data_wait", "data.wait_s"):
            with tracing.span("step"):
                pass
        agg.tick(now=1.0)
        with server.MonitoringServer(port=0, host="127.0.0.1", aggregator=agg) as srv:
            for route in ("/metrics", "/healthz", "/statusz"):
                urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{route}",
                                       timeout=30).read()
        slo.SLOTracker(agg, [slo.AlertRule("vocab", "step.time_s p99 < 60")]
                       ).evaluate(now=1.0)
        numerics.NumericsPublisher(thresholds={"ef_residual_ratio": 0.1}).publish(1, {
            "bn_mean_skew": 0.2, "bn_var_skew": 0.1, "replica_grad_norm": 1.0,
            "replica_grad_norm_disp": 0.01, "clip_fraction": 0.9,
            "overflow_headroom": 0.4, "ef_residual_ratio": 0.2})
        host = {"rss_bytes": 1000, "peak_rss_bytes": 1100, "cache_bytes_live": 10,
                "arrays_bytes": 500, "arrays_count": 2, "arrays_truncated": False}
        memwatch.MemorySampler(
            device_reader=lambda: [{"id": 0, "bytes_in_use": 900, "peak_bytes": 950,
                                    "limit_bytes": 2000}],
            host_reader=lambda cap: dict(host), contract_bytes_per_device=1000).sample()
        memwatch.MemorySampler(device_reader=lambda: None, host_reader=lambda cap: dict(host),
                               contract_bytes_per_device=100).sample()
        profiling.note_compile("train", 0.01)
        ap_agg = timeseries.WindowedAggregator()
        ap_agg.tick(now=0.0)
        for _ in range(20):
            telemetry.observe("numerics.ef_residual_ratio", 0.9, buckets=(0.1, 0.5, 1.0))
        ap_agg.tick(now=5.0)
        ap = Autopilot(_Trainer(), aggregator=ap_agg, modes=("int8", "bf16"),
                       window_s=4.0, now=iter([10.0, 11.0, 20.0]).__next__)
        ap.on_chunk(step=1, recovering=True)
        ap.on_chunk(step=2)
        ap.on_chunk(step=3)
        audit.run_audit(contracts=False, lint_paths=[srclint.__file__])
        prev = flightrec.get()
        flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path / "inc")))
        try:
            flightrec.trigger("manual", force=True)
        finally:
            flightrec.uninstall()
            if prev is not None:
                flightrec.install(prev)
        return telemetry.snapshot()

    def test_produced_names_are_in_the_vocabulary(self, tmp_path):
        from tpu_syncbn_torch.obs import telemetry

        telemetry.set_enabled(True)
        telemetry.REGISTRY.reset()
        try:
            snap = self._produce(tmp_path)
        finally:
            telemetry.set_enabled(None)
            telemetry.REGISTRY.reset()
        names = sorted(set(snap["counters"]) | set(snap["gauges"]) | set(snap["histograms"]))
        assert len(names) >= 40
        assert any("{" in n for n in names)  # labeled families were produced
        firsts = set()
        unknown_prefix, unknown_keys = [], []
        for name in names:
            base, labels = telemetry.split_labels(name)
            firsts.add(base.split(".", 1)[0])
            if base.split(".", 1)[0] not in srclint.KNOWN_METRIC_PREFIXES:
                unknown_prefix.append(name)
            if labels and set(labels) - srclint.LABEL_KEYS:
                unknown_keys.append(name)
        assert not unknown_prefix and not unknown_keys, (unknown_prefix, unknown_keys)
        # the producers reached these families
        assert {"audit", "autopilot", "checkpoint", "compile", "incident", "mem",
                "numerics", "obs", "serve", "slo", "step"} <= firsts

    def test_monitor_metric_pins_satisfy_the_allowance(self):
        from tpu_syncbn_torch.obs.server import MONITOR_METRICS

        assert len(MONITOR_METRICS) == 6
        src = "".join(f"telemetry.count({name!r})\n" for name in MONITOR_METRICS)
        assert lint_source(src, "x.py") == []

    def test_the_vocabulary_is_the_jax_packages(self):
        from tpu_syncbn.audit import srclint as jax_srclint

        assert srclint.KNOWN_METRIC_PREFIXES == jax_srclint.KNOWN_METRIC_PREFIXES
        assert srclint.LABEL_KEYS == jax_srclint.LABEL_KEYS
