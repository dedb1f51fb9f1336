"""The CLI: ``python -m tpu_syncbn_torch.audit [--strict] [--json]
[--write-goldens [--force]] [--golden-dir D]``.

Exit codes, as the JAX CLI's: 0 — clean; 1 — violations (or, under
``--strict``, a recorded program with no pinned golden; or
``--write-goldens`` refusing to overwrite a mismatching golden without
``--force``); 2 — usage error, including every flag of a layer not
ported yet (each message names the ROADMAP item that adds it).

The registry runs on the CPU, in :data:`~tpu_syncbn_torch.audit.program_audit.PINNED_WORLD`
spawned gloo processes (goldens record the world they were pinned at),
whatever card the machine has: the JAX CLI forces its 8-device CPU mesh
the same way. The children get their settings as arguments, so this
process's environment and process group are left as they were.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: Flags of the JAX CLI that belong to layers the port has not ported yet,
#: and the ROADMAP item that adds each.
LATER_FLAGS = {
    "--no-contracts": "A.14b-2 (the source lint)",
    "--no-lint": "A.14b-2 (the source lint)",
    "--rules": "A.14b-2 (the source lint)",
    "--rule": "A.14b-2 (the source lint)",
    "--root": "A.14b-2 (the source lint)",
    "--changed-only": "A.14b-2 (the source lint)",
    "--shardings": "A.14b-3 (placement and per-device peak memory)",
    "--mem-budget": "A.14b-3 (placement and per-device peak memory)",
    "plan": "A.14c (the planner)",
}


def _later_flag(argv) -> str | None:
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in LATER_FLAGS:
            return flag
    return None


def _parse(argv):
    parser = argparse.ArgumentParser(
        prog="python -m tpu_syncbn_torch.audit",
        description="Program-contract audit of the port (layer 1): records "
        "every registered step body on a gloo world of 8 CPU processes, "
        "whatever card the machine has, and holds it to the cross-program "
        "invariants and the goldens (tpu_syncbn_torch/audit/DESIGN.md).",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="recorded programs with no pinned golden are failures, not warnings")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit one machine-readable JSON report on stdout")
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
    if args.force and not args.write_goldens:
        print("--force only applies to --write-goldens", file=sys.stderr)
        return 2

    from tpu_syncbn_torch import audit
    from tpu_syncbn_torch.audit import program_audit

    gdir = args.golden_dir or program_audit.default_golden_dir()
    live = program_audit.pinned_world_contracts()
    if args.write_goldens:
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

    result = audit.run_audit(strict=args.strict, golden_dir=gdir, live=live)
    if args.as_json:
        print(json.dumps(result.to_json(), indent=1, sort_keys=False))
    else:
        for v in result.violations:
            print(v.format())
        for name in result.unpinned:
            tag = "FAIL" if args.strict else "warn"
            print(f"{tag}: program {name!r} has no pinned golden "
                  "(--write-goldens to pin)")
        print(f"audit: {result.programs_checked} programs checked at world "
              f"{program_audit.PINNED_WORLD} in {live['seconds']:.1f}s, "
              f"{len(result.violations)} violation(s)"
              + (f", {len(result.unpinned)} unpinned" if result.unpinned else ""))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
