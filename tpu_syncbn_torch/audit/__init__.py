"""Program-contract auditor for the port — the counterpart of
``tpu_syncbn.audit``, its three layers (``DESIGN.md`` beside this file
is the design note).

* :mod:`tpu_syncbn_torch.audit.contracts` — the extractor: a
  ``TorchDispatchMode`` recorder around one application of a step body
  (what a CUDA graph captures), read into a
  :class:`~tpu_syncbn_torch.audit.contracts.ProgramContract`
  (collectives and their bytes, state updated in place, host reads,
  widening conversions), JAX's field names and JSON shape.
* :mod:`tpu_syncbn_torch.audit.program_audit` — the registry of the
  port's programs under the JAX names, recorded on a gloo world of 8
  CPU processes, the cross-program invariants and the goldens under
  ``audit/goldens/``.
* :mod:`tpu_syncbn_torch.audit.contract_cache` — one recording per
  program fingerprint per process.

* :mod:`tpu_syncbn_torch.audit.srclint` — layer 2, the source lint:
  standard-library ``ast`` rules over the port's own files (host syncs
  in step bodies, raw collectives and the raw profiler, lock
  discipline, the telemetry schema, unbounded waits, mesh-axis
  literals, private process groups, lossy defaults; ``DESIGN.md`` §7).

* :mod:`tpu_syncbn_torch.audit.sharding_audit` — layer 3, placement and
  per-device peak memory over the same recording: where every value
  lives (the mesh axes it is replicated over), the collectives that
  explain each change, implicit reshards, accidental replication and the
  rank's peak live bytes, in each contract's ``sharding`` block
  (``DESIGN.md`` §8).

Run ``python -m tpu_syncbn_torch.audit [--strict] [--json] [--shardings]
[--mem-budget N] [--no-contracts | --no-lint] [--rules R1,R2]
[--root PATH] [--changed-only REF]`` or :func:`run_audit`; results feed
the ``audit.*`` telemetry counters.
"""

from __future__ import annotations

import dataclasses

from tpu_syncbn_torch.audit.contracts import (  # noqa: F401
    CONTRACT_SCHEMA,
    SHARDING_SCHEMA,
    ExtractionError,
    LoweredStep,
    ProgramContract,
    Recorder,
    ShardingContract,
    compare_contracts,
    compare_sharding,
    extract_contract,
    load_contract,
    save_contract,
    weighted_cost_summary,
)
from tpu_syncbn_torch.audit.srclint import (  # noqa: F401
    RULES,
    Violation,
    lint_file,
    lint_package,
    lint_source,
)

#: Bump when the CLI/JSON report shape changes incompatibly.
REPORT_SCHEMA = 1


@dataclasses.dataclass
class AuditResult:
    """Aggregate outcome of one audit run — both layers' violations plus
    the accounting the CLI, the tests and the ``audit.*`` counters key on."""

    violations: list[Violation]
    unpinned: list[str]
    files_linted: int
    programs_checked: int
    strict: bool

    @property
    def rule_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for v in self.violations:
            counts[v.rule] = counts.get(v.rule, 0) + 1
        return counts

    @property
    def ok(self) -> bool:
        if self.violations:
            return False
        return not (self.strict and self.unpinned)

    def to_json(self) -> dict:
        return {
            "schema": REPORT_SCHEMA,
            "ok": self.ok,
            "strict": self.strict,
            "files_linted": self.files_linted,
            "programs_checked": self.programs_checked,
            "violations": [v.to_json() for v in self.violations],
            "unpinned": list(self.unpinned),
            "rule_counts": dict(sorted(self.rule_counts.items())),
        }


def run_audit(*, strict: bool = False, lint: bool = True, contracts: bool = True,
              golden_dir: str | None = None, pkg_root: str | None = None,
              rules=None, lint_paths=None, live: dict | None = None,
              shardings: bool = False, mem_budget: int | None = None) -> AuditResult:
    """Run the audit layers and fold the outcome into the ``audit.*``
    telemetry counters. ``lint`` runs the source lint over ``pkg_root``
    (default: the port's package) or over the files of ``lint_paths``
    (the ``--changed-only`` mode), with the ``rules`` subset (default:
    all). ``contracts`` records the registry on the pinned world and
    holds it to the invariants and the goldens; ``live`` is a
    :func:`~tpu_syncbn_torch.audit.program_audit.pinned_world_contracts`
    result to check instead of recording anew. ``shardings`` takes the
    allocator's reading of each application (layer 3's ``xla_peak_bytes``);
    ``mem_budget`` (bytes) arms the per-device peak contract
    (``sharding.mem_budget``). ``contracts=False`` starts
    no process and imports no trainer. Touches no environment variable
    and no process group of the caller."""
    from tpu_syncbn_torch.audit import srclint
    from tpu_syncbn_torch.obs import telemetry

    violations: list[Violation] = []
    unpinned: list[str] = []
    files_linted = programs_checked = sharding_programs = sharding_violations = 0
    if lint:
        files = (list(lint_paths) if lint_paths is not None
                 else srclint.package_files(pkg_root))
        files_linted = len(files)
        for path in files:
            violations.extend(srclint.lint_file(path, rules=rules))
    if contracts:
        from tpu_syncbn_torch.audit import program_audit

        if live is None:
            live = program_audit.pinned_world_contracts(memory=shardings)
        recorded = live["contracts"]
        programs_checked = len(recorded)
        sharding_programs = sum(1 for c in recorded.values() if c.sharding is not None)
        violations += [Violation(rule=rule, message=msg, path="<recording>", line=0)
                       for _, rule, msg in live["errors"]]
        violations += program_audit.check_invariants(recorded)
        found = program_audit.check_sharding(recorded, mem_budget=mem_budget)
        sharding_violations = len(found)
        violations += found
        gdir = golden_dir or program_audit.default_golden_dir()
        golden_violations, unpinned = program_audit.check_goldens(recorded, gdir)
        violations += golden_violations
    result = AuditResult(violations=violations, unpinned=unpinned,
                         files_linted=files_linted,
                         programs_checked=programs_checked, strict=strict)
    telemetry.count("audit.runs")
    if files_linted:
        telemetry.count("audit.files_linted", files_linted)
    if programs_checked:
        telemetry.count("audit.programs_checked", programs_checked)
    if sharding_programs:
        telemetry.count("audit.sharding.programs", sharding_programs)
    if contracts:
        # counted at 0 too, but only when the layer ran
        telemetry.count("audit.sharding.violations", sharding_violations)
    telemetry.count("audit.violations", len(violations))
    for rule, n in result.rule_counts.items():
        telemetry.count(f"audit.rule.{rule}", n)
    return result


__all__ = [
    "REPORT_SCHEMA",
    "CONTRACT_SCHEMA",
    "SHARDING_SCHEMA",
    "AuditResult",
    "ExtractionError",
    "LoweredStep",
    "ProgramContract",
    "Recorder",
    "ShardingContract",
    "RULES",
    "Violation",
    "run_audit",
    "lint_file",
    "lint_package",
    "lint_source",
    "compare_contracts",
    "compare_sharding",
    "extract_contract",
    "load_contract",
    "save_contract",
    "weighted_cost_summary",
]
