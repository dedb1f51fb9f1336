"""Program-contract auditor for the port — the counterpart of
``tpu_syncbn.audit``, its first layer (``DESIGN.md`` beside this file
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

The JAX package's other two layers wait: the source lint (ROADMAP
A.14b-2) and the sharding flow with per-device peak memory (A.14b-3).
Run ``python -m tpu_syncbn_torch.audit [--strict] [--json]`` or
:func:`run_audit`; results feed the ``audit.*`` telemetry counters.
"""

from __future__ import annotations

import dataclasses

from tpu_syncbn_torch.audit.contracts import (  # noqa: F401
    CONTRACT_SCHEMA,
    ExtractionError,
    LoweredStep,
    ProgramContract,
    Recorder,
    compare_contracts,
    extract_contract,
    load_contract,
    save_contract,
    weighted_cost_summary,
)
from tpu_syncbn_torch.audit.program_audit import Violation  # noqa: F401

#: Bump when the CLI/JSON report shape changes incompatibly.
REPORT_SCHEMA = 1


@dataclasses.dataclass
class AuditResult:
    """Aggregate outcome of one audit run — the violations plus the
    accounting the CLI, the tests and the ``audit.*`` counters key on.
    ``files_linted`` stays 0 until the source lint is ported (A.14b-2)."""

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


def run_audit(*, strict: bool = False, golden_dir: str | None = None,
              live: dict | None = None) -> AuditResult:
    """Record the registry on the pinned world, hold it to the invariants
    and the goldens, and fold the outcome into the ``audit.*`` telemetry
    counters. ``live`` is a :func:`~tpu_syncbn_torch.audit.program_audit.pinned_world_contracts`
    result to check instead of recording anew. Touches no environment
    variable and no process group of the caller."""
    from tpu_syncbn_torch.audit import program_audit
    from tpu_syncbn_torch.obs import telemetry

    if live is None:
        live = program_audit.pinned_world_contracts()
    contracts = live["contracts"]
    violations = [Violation(rule=rule, message=msg, path="<recording>", line=0)
                  for _, rule, msg in live["errors"]]
    violations += program_audit.check_invariants(contracts)
    gdir = golden_dir or program_audit.default_golden_dir()
    golden_violations, unpinned = program_audit.check_goldens(contracts, gdir)
    violations += golden_violations
    result = AuditResult(violations=violations, unpinned=unpinned, files_linted=0,
                         programs_checked=len(contracts), strict=strict)
    telemetry.count("audit.runs")
    if result.programs_checked:
        telemetry.count("audit.programs_checked", result.programs_checked)
    telemetry.count("audit.violations", len(violations))
    for rule, n in result.rule_counts.items():
        telemetry.count(f"audit.rule.{rule}", n)
    return result


__all__ = [
    "REPORT_SCHEMA",
    "CONTRACT_SCHEMA",
    "AuditResult",
    "ExtractionError",
    "LoweredStep",
    "ProgramContract",
    "Recorder",
    "Violation",
    "run_audit",
    "compare_contracts",
    "extract_contract",
    "load_contract",
    "save_contract",
    "weighted_cost_summary",
]
