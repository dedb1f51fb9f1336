"""The CLI: ``python -m tpu_syncbn_torch.audit [--strict] [--json]
[--shardings] [--mem-budget N] [--no-contracts | --no-lint] [--rules R1,R2]
[--root PATH] [--changed-only GIT_REF] [--write-goldens [--force]]
[--golden-dir D]``.

Exit codes, as the JAX CLI's: 0 — clean; 1 — violations (or, under
``--strict``, a recorded program with no pinned golden; or
``--write-goldens`` refusing to overwrite a mismatching golden without
``--force``); 2 — usage error, including an unknown rule, an unparsable
``--mem-budget`` and the planner's ``plan``, not ported yet (its message
names the ROADMAP item that adds it).

``--shardings`` takes the allocator's reading of each recorded application
(layer 3's ``xla_peak_bytes``, ``DESIGN.md`` §8); ``--mem-budget N``
(``1048576``, ``512k``, ``64m``, ``2g``) fails every program whose
per-device peak exceeds N bytes (``sharding.mem_budget``).

The source lint (layer 2) reads the port's files and imports none of
them. The registry (layer 1) runs on the CPU, in
:data:`~tpu_syncbn_torch.audit.program_audit.PINNED_WORLD` spawned gloo
processes (goldens record the world they were pinned at), whatever card
the machine has: the JAX CLI forces its 8-device CPU mesh the same way.
The children get their settings as arguments, so this process's
environment and process group are left as they were.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: Flags of the JAX CLI that belong to layers the port has not ported yet,
#: and the ROADMAP item that adds each.
LATER_FLAGS = {
    "plan": "A.14c (the planner)",
}

#: Package subtrees whose change can change a registered program:
#: ``--changed-only`` runs the contract layer only when one of them
#: changed (the JAX CLI's ``_CONTRACT_SOURCES``, without ``compat.py``).
CONTRACT_SOURCES = ("parallel", "serve", "nn", "ops", "audit", "runtime",
                    "mesh_axes.py")


def _parse_bytes(text: str) -> int:
    """``1048576`` / ``512k`` / ``64m`` / ``2g`` → bytes (the JAX CLI's)."""
    text = text.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(text[-1:], 1)
    digits = text[:-1] if mult != 1 else text
    return int(digits) * mult


def _changed_files(ref: str, pkg_root: str) -> list[str] | None:
    """The package's ``.py`` files changed against ``ref``, untracked ones
    included (a new module is the likeliest home of a new finding). None
    when ``git`` fails: the caller falls back to the full sweep rather
    than lint nothing."""
    base = os.path.dirname(os.path.abspath(pkg_root))
    rels: list[str] = []
    for cmd in (["git", "diff", "--name-only", "--relative", ref, "--", "*.py"],
                ["git", "ls-files", "--others", "--exclude-standard", "--", "*.py"]):
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=30, cwd=base)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        rels.extend(proc.stdout.splitlines())
    root = os.path.abspath(pkg_root) + os.sep
    out = []
    for rel in dict.fromkeys(r.strip() for r in rels):
        path = os.path.join(base, rel)
        if path.endswith(".py") and os.path.exists(path) \
                and os.path.abspath(path).startswith(root):
            out.append(path)
    return out


def _touches_programs(paths, pkg_root: str) -> bool:
    for path in paths:
        rel = os.path.relpath(path, pkg_root).replace(os.sep, "/")
        if rel.split("/")[0] in CONTRACT_SOURCES:
            return True
    return False


def _later_flag(argv) -> str | None:
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in LATER_FLAGS:
            return flag
    return None


def _parse(argv):
    parser = argparse.ArgumentParser(
        prog="python -m tpu_syncbn_torch.audit",
        description="Audit of the port: the program contracts (layer 1: every "
        "registered step body recorded on a gloo world of 8 CPU processes, "
        "whatever card the machine has, held to the cross-program invariants "
        "and the goldens), the source lint (layer 2: ast rules over the "
        "port's files) and placement with per-device peak memory (layer 3, "
        "over the same recordings) (tpu_syncbn_torch/audit/DESIGN.md).",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="recorded programs with no pinned golden are failures, not warnings")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit one machine-readable JSON report on stdout")
    parser.add_argument(
        "--shardings", action="store_true",
        help="layer 3's cross-check: take the allocator's reading of each recorded "
        "application (xla_peak_bytes; the placement pass itself always runs with the "
        "contract layer)")
    parser.add_argument(
        "--mem-budget", default=None, metavar="BYTES",
        help="per-device peak-memory contract (k/m/g suffixes): a program whose peak "
        "exceeds it is a sharding.mem_budget violation")
    parser.add_argument(
        "--write-goldens", action="store_true",
        help="re-pin every program contract under the golden dir. Prints the "
        "per-contract old->new field diff; refuses to overwrite mismatching "
        "goldens without --force")
    parser.add_argument(
        "--force", action="store_true",
        help="with --write-goldens: overwrite goldens even when they mismatch "
        "(you have reviewed the printed diff)")
    parser.add_argument(
        "--golden-dir", default=None, metavar="DIR",
        help="golden-contract directory (default: tpu_syncbn_torch/audit/goldens/)")
    parser.add_argument(
        "--no-contracts", action="store_true",
        help="source lint only: records no program (no process, no trainer)")
    parser.add_argument(
        "--no-lint", action="store_true", help="contract layer only")
    parser.add_argument(
        "--rules", default=None, metavar="R1,R2",
        help="comma-separated lint rule subset (default: all)")
    parser.add_argument(
        "--root", default=None, metavar="PATH",
        help="lint this source tree instead of the port's package")
    parser.add_argument(
        "--changed-only", default=None, metavar="GIT_REF",
        help="lint only the package files changed against the git ref "
        "(untracked ones included), and record the programs only when a "
        "program-defining subtree changed")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    later = _later_flag(argv)
    if later is not None:
        print(f"{later}: not in the port's audit yet — ROADMAP {LATER_FLAGS[later]} "
              "adds it", file=sys.stderr)
        return 2
    try:
        args = _parse(argv)
    except SystemExit as e:
        return int(e.code or 0)
    mem_budget = None
    if args.mem_budget is not None:
        try:
            mem_budget = _parse_bytes(args.mem_budget)
        except ValueError:
            print(f"--mem-budget: cannot parse {args.mem_budget!r} "
                  "(want bytes, or k/m/g-suffixed)", file=sys.stderr)
            return 2
        if mem_budget < 1:
            print("--mem-budget must be positive", file=sys.stderr)
            return 2
    if args.force and not args.write_goldens:
        print("--force only applies to --write-goldens", file=sys.stderr)
        return 2

    from tpu_syncbn_torch import audit
    from tpu_syncbn_torch.audit import program_audit, srclint

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in srclint.RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(have: {', '.join(srclint.RULES)})", file=sys.stderr)
            return 2
    lint_paths = None
    contracts = not args.no_contracts
    if args.changed_only is not None:
        pkg_root = args.root or srclint.PKG_ROOT
        changed = _changed_files(args.changed_only, pkg_root)
        if changed is None:
            print(f"--changed-only: git diff vs {args.changed_only!r} failed; "
                  "falling back to the full sweep", file=sys.stderr)
        else:
            lint_paths = changed
            if contracts and not _touches_programs(changed, pkg_root):
                contracts = False
                print("--changed-only: no program-defining sources changed; "
                      "skipping the contract layer", file=sys.stderr)

    gdir = args.golden_dir or program_audit.default_golden_dir()
    record = {"memory": True} if args.shardings else {}
    if args.write_goldens:
        live = program_audit.pinned_world_contracts(**record)
        if live["errors"]:
            for name, rule, msg in live["errors"]:
                print(f"<recording>: [{rule}] {msg}")
            print("refusing to pin contracts that failed extraction")
            return 1
        diffs = program_audit.golden_diffs(live["contracts"], gdir)
        for name in sorted(diffs):
            print(f"re-pin {name}:")
            for line in diffs[name]:
                print(f"  {line}")
        mismatching = {n for n, lines in diffs.items()
                       if lines != ["<new golden — no previous pin>"]}
        if mismatching and not args.force:
            print(f"refusing to overwrite {len(mismatching)} mismatching golden(s) "
                  "without --force — review the old->new diff above first")
            return 1
        if not diffs:
            print("goldens already match the live contracts — nothing re-pinned")
            return 0
        for path in program_audit.write_goldens(live["contracts"], gdir):
            print(f"pinned {os.path.relpath(path)}")
        return 0

    live = program_audit.pinned_world_contracts(**record) if contracts else None
    result = audit.run_audit(strict=args.strict, lint=not args.no_lint,
                             contracts=contracts, golden_dir=gdir,
                             pkg_root=args.root, rules=rules,
                             lint_paths=lint_paths, live=live,
                             shardings=args.shardings, mem_budget=mem_budget)
    if args.as_json:
        print(json.dumps(result.to_json(), indent=1, sort_keys=False))
    else:
        for v in result.violations:
            print(v.format())
        for name in result.unpinned:
            tag = "FAIL" if args.strict else "warn"
            print(f"{tag}: program {name!r} has no pinned golden "
                  "(--write-goldens to pin)")
        recorded = (f" at world {program_audit.PINNED_WORLD} in {live['seconds']:.1f}s"
                    if live is not None else "")
        print(f"audit: {result.files_linted} files linted, "
              f"{result.programs_checked} programs checked{recorded}, "
              f"{len(result.violations)} violation(s)"
              + (f", {len(result.unpinned)} unpinned" if result.unpinned else ""))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
