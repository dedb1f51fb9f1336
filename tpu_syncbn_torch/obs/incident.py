"""Incident bundles: the schema-versioned dump of a flight recorder's
state, and the explained-step-time attribution report over one — the
counterpart of ``tpu_syncbn.obs.incident`` (the JAX package's ``__init__``
imports JAX, so the port keeps its own copy). The bundle schema
(:data:`BUNDLE_SCHEMA`, :data:`BUNDLE_KIND`) is the JAX module's, so each
package's :func:`validate_bundle` loads the other's bundles and
:func:`merge_bundles` merges them.

A bundle is ONE self-contained JSON file — everything a responder needs to
answer "what was this process doing when the anomaly hit" without shell
access to the host: the recent-span trace slice (loads directly in
Perfetto), the windowed registry ring, the step, memory and compile rings,
a full cumulative registry snapshot, the heartbeat and readiness state,
and the ``TPU_SYNCBN_*`` config/env. Multi-host: each host dumps its own
bundle; rank 0 merges them with :func:`merge_bundles`, which routes the
registry and windowed snapshots through the existing
:func:`tpu_syncbn_torch.obs.telemetry.merge_exports` path — no second
merge schema.

On top of a bundle, :func:`attribution` decomposes recent step wall time
into **data-wait / host-dispatch / compute / collective** shares by
joining the live timing histograms (``step.data_wait_s``,
``step.time_s``, ``step.chunk_time_s``) with the static per-program
contract the recorder was fed
(:meth:`~tpu_syncbn_torch.obs.flightrec.FlightRecorder.set_contract`:
``torch.utils.flop_counter`` flops and the collective bytes of
``collectives.tallies()``): the host-observable seams split the wall, and
the contract's compute-against-wire cost model, at the card's rates
(:data:`DEFAULT_FLOP_RATE`, :data:`DEFAULT_WIRE_RATE`), splits the
in-dispatch share. Shares sum to 1.0 by construction, so two reports diff
cleanly — ``python -m tpu_syncbn_torch.obs.incident diff a.json b.json``
names the component that moved.

Where the port differs from the JAX module: :func:`contract_fingerprint`
hashes the port's own goldens (``tpu_syncbn_torch/audit/goldens/``, where
JAX hashes ``tests/contracts/``), ``config.env`` records
``CUDA_VISIBLE_DEVICES`` where JAX records ``JAX_PLATFORMS``, and the
attribution rates are the H100's, not the JAX module's TPU-class ones.
``state.alerts`` is :func:`tpu_syncbn_torch.obs.slo.tracker_states`, the
alert state of every attached SLO tracker, as in JAX.

CLI::

    python -m tpu_syncbn_torch.obs.incident inspect <bundle.json> [--json]
    python -m tpu_syncbn_torch.obs.incident diff <a.json> <b.json> [--json]
    python -m tpu_syncbn_torch.obs.incident merge <out.json> <bundle.json>...
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from typing import Iterable

from tpu_syncbn_torch.obs import telemetry, tracing

#: Bump when the bundle JSON shape changes incompatibly (the JAX
#: module's number: both packages write and read the same schema). v2:
#: embedded registry and
#: windowed snapshots may carry labeled series (``family{k="v"}``
#: names) and slo_alert trigger details may bind label selectors in
#: their objective strings.
BUNDLE_SCHEMA = 2

#: Schemas :func:`validate_bundle` still loads. v1 bundles (pre-label)
#: differ only by what names *may* appear, so post-mortem diffs across
#: the upgrade window keep working.
ACCEPTED_SCHEMAS = frozenset({1, 2})
BUNDLE_KIND = "tpu_syncbn.incident"
MERGED_KIND = "tpu_syncbn.incident_merged"

#: The standard trigger matrix. Custom kinds are allowed (schema token
#: form). The port fires ``slo_alert`` (an SLO rule's transition to
#: firing; detail ``{"rule", "burn", "objective"}``, whose objective
#: string may bind a label selector, ``serve.latency_s{tenant="a"} p99 <
#: 0.25``), ``divergence_restore``, ``watchdog_stall``,
#: ``numerics_drift``, ``mem_pressure``, ``recompile_storm``,
#: ``manual``, from the serving batcher's circuit breaker
#: ``circuit_open``, and from weight publication (``serve.publish``'s
#: swaps, rejections and rollbacks) ``weight_swap``, and from the
#: autopilot (``runtime.autopilot``) ``autopilot`` for every actuation and
#: ``plan_change`` for its layout knob's (the planner's ranked plans that
#: would feed that knob are ROADMAP A.14c).
TRIGGER_KINDS = ("slo_alert", "divergence_restore", "watchdog_stall",
                 "circuit_open", "numerics_drift", "mem_pressure",
                 "recompile_storm", "weight_swap", "autopilot",
                 "plan_change", "manual")

_KIND_RE = re.compile(r"^[a-z0-9_]+$")

#: Attribution cost-model proxies: rates that turn the contract's static
#: flops and bytes-on-wire into *relative* compute and collective weights
#: for splitting the measured in-dispatch time. Only the ratio enters the
#: shares, and the model used is recorded in the report, so a diff across
#: hardware is never silent. Both are the card's own, for
#: ``NVIDIA H100 80GB HBM3, 700.00 W`` (H100 SXM5):
#: 989.4 TFLOP/s dense BF16 (NVIDIA H100 datasheet; the peak
#: ``tpu_syncbn_torch.bench`` computes MFU against) ...
DEFAULT_FLOP_RATE = 989.4e12
#: ... against 900 GB/s of NVLink (the same datasheet's fourth-generation
#: NVLink figure, both directions together).
DEFAULT_WIRE_RATE = 900e9

#: Histogram families whose sums count as in-dispatch step time /
#: data-wait time (the stepstats seams every loop records through).
_DISPATCH_HISTS = ("step.time_s", "step.chunk_time_s",
                   "scan.chunk_dispatch_s")
_DATA_WAIT_HISTS = ("step.data_wait_s",)


# ---------------------------------------------------------------------------
# building / writing


def contract_fingerprint(golden_dir: str | None = None) -> dict | None:
    """Identity of the pinned program contracts in force: sha256 over the
    golden contract JSONs in ``golden_dir`` — the "which programs was this
    build running" join key between an incident and an audit layer.

    With no ``golden_dir``, the port's audit goldens
    (``tpu_syncbn_torch/audit/goldens/``, found beside the package without
    importing the audit layer on the dump path). ``None`` when the
    directory holds no goldens — a bundle must never fail over its
    annotations."""
    import hashlib

    if golden_dir is None:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        golden_dir = os.path.join(pkg, "audit", "goldens")
    try:
        names = sorted(
            n for n in os.listdir(golden_dir) if n.endswith(".json")
        )
        if not names:
            return None
        h = hashlib.sha256()
        for n in names:
            h.update(n.encode())
            with open(os.path.join(golden_dir, n), "rb") as f:
                h.update(f.read())
        return {"programs": len(names), "sha256": h.hexdigest()[:16]}
    except Exception:
        return None


def build_bundle(
    recorder, kind: str, detail: dict, *, seq: int | None = None,
) -> dict:
    """Assemble the bundle dict for ``recorder`` (see module docstring
    for the shape). Called under the recorder's trigger lock — the
    readiness probe below may re-enter
    :func:`~tpu_syncbn_torch.obs.flightrec.trigger`, which the
    non-blocking lock drops rather than recurses. ``state.alerts`` holds
    every attached SLO tracker's alert state
    (:func:`~tpu_syncbn_torch.obs.slo.tracker_states`); ``config.env``
    holds the ``TPU_SYNCBN_*`` variables and ``CUDA_VISIBLE_DEVICES`` (the
    JAX bundle's ``JAX_PLATFORMS`` slot)."""
    from tpu_syncbn_torch.obs import server as obs_server, slo as obs_slo

    host = telemetry._host_index()
    stamp = time.strftime("%Y%m%dT%H%M%S")
    incident_id = f"{stamp}-h{host}-{seq or 0:03d}-{kind}"
    tracer = tracing.get()
    events = (tracer.recent_events(recorder.span_capacity)
              if tracer is not None else [])
    ready_ok, ready_checks = obs_server.evaluate_readiness()
    contract = recorder.contract()
    if "fingerprint" not in contract:
        contract["fingerprint"] = contract_fingerprint()
    env = {
        k: v for k, v in sorted(os.environ.items())
        if k.startswith("TPU_SYNCBN_") or k in ("CUDA_VISIBLE_DEVICES",)
    }
    return {
        "schema": BUNDLE_SCHEMA,
        "kind": BUNDLE_KIND,
        "incident_id": incident_id,
        "host": host,
        "wall_time": round(time.time(), 3),
        "trigger": {"kind": str(kind), "detail": detail},
        "config": {"env": env, "argv": list(sys.argv)},
        "contract": contract,
        "registry": recorder.registry.snapshot(),
        "windows": recorder.aggregator.windowed_snapshot(),
        "rings": recorder.rings_snapshot(),
        "trace": {"traceEvents": events, "displayTimeUnit": "ms"},
        "state": {
            "heartbeat_age_s": {
                n: round(a, 3)
                for n, a in sorted(obs_server.HEARTBEATS.ages().items())
            },
            "readiness": {"ok": ready_ok, "checks": ready_checks},
            "alerts": obs_slo.tracker_states(),
        },
    }


def write_bundle(bundle: dict, directory: str, *,
                 max_bundles: int = 16) -> str:
    """Atomically write ``bundle`` as ``incident_<id>.json`` under
    ``directory`` (tmp + rename — a reader never sees a torn file) and
    prune the oldest bundles beyond ``max_bundles``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(
        directory, f"incident_{bundle['incident_id']}.json"
    )
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=".incident_", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(bundle, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _prune(directory, max_bundles)
    return path


def _prune(directory: str, max_bundles: int) -> None:
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("incident_") and n.endswith(".json")]
        paths = sorted(
            (os.path.join(directory, n) for n in names),
            key=lambda p: os.path.getmtime(p),
        )
        excess = paths[:-max_bundles] if len(paths) > max_bundles else []
        for p in excess:
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
    except OSError:
        pass  # pruning is housekeeping, never a dump failure


# ---------------------------------------------------------------------------
# loading / validation / merge


def load_bundle(path: str) -> dict:
    with open(path) as f:
        return validate_bundle(json.load(f))


def validate_bundle(bundle) -> dict:
    """Schema gate for an incident bundle (the JAX module's, so it loads
    either package's bundles): raises ``ValueError`` on
    drift, returns the bundle on success. The embedded registry and
    windowed snapshots validate against the telemetry schema and the
    trace slice against the Chrome trace-event schema — a bundle is
    only valid if each tool it feeds can load its part."""
    if not isinstance(bundle, dict):
        raise ValueError(f"bundle must be a dict, got {type(bundle)}")
    if bundle.get("schema") not in ACCEPTED_SCHEMAS:
        raise ValueError(
            f"bundle schema {bundle.get('schema')!r} not in "
            f"{sorted(ACCEPTED_SCHEMAS)}"
        )
    if bundle.get("kind") != BUNDLE_KIND:
        raise ValueError(f"bundle kind {bundle.get('kind')!r}")
    if not isinstance(bundle.get("incident_id"), str) \
            or not bundle["incident_id"]:
        raise ValueError("bundle has no incident_id")
    if not isinstance(bundle.get("host"), int):
        raise ValueError("bundle has no integer host")
    if not isinstance(bundle.get("wall_time"), (int, float)):
        raise ValueError("bundle has no numeric wall_time")
    trig = bundle.get("trigger")
    if not isinstance(trig, dict) or not _KIND_RE.match(
            str(trig.get("kind", ""))):
        raise ValueError(f"bundle trigger unusable: {trig!r}")
    if not isinstance(trig.get("detail"), dict):
        raise ValueError("bundle trigger.detail must be a dict")
    telemetry.validate_snapshot(bundle.get("registry"))
    telemetry.validate_snapshot(bundle.get("windows"))
    trace = bundle.get("trace")
    if not isinstance(trace, dict):
        raise ValueError("bundle has no trace block")
    tracing.validate_trace(trace.get("traceEvents"))
    rings = bundle.get("rings")
    if not isinstance(rings, dict):
        raise ValueError("bundle has no rings block")
    for ring in ("steps", "serve"):
        if not isinstance(rings.get(ring), list):
            raise ValueError(f"bundle rings.{ring} must be a list")
    # the mem, compile and autopilot rings are optional within the
    # accepted schemas: bundles written before they existed must keep
    # loading — a post-mortem diff of a pre-upgrade bundle against a
    # post-upgrade one is exactly the upgrade-window use case
    for ring in ("mem", "compile", "autopilot"):
        if ring in rings and not isinstance(rings[ring], list):
            raise ValueError(f"bundle rings.{ring} must be a list")
    for e in rings["steps"]:
        if not isinstance(e, dict) or not isinstance(e.get("step"), int):
            raise ValueError(f"bundle step-ring entry unusable: {e!r}")
    for e in rings["serve"]:
        if not isinstance(e, dict) or not isinstance(e.get("kind"), str):
            raise ValueError(f"bundle serve-ring entry unusable: {e!r}")
    for e in rings.get("mem", ()):
        if not isinstance(e, dict):
            raise ValueError(f"bundle mem-ring entry unusable: {e!r}")
    for e in rings.get("compile", ()):
        if not isinstance(e, dict) or not isinstance(e.get("family"), str):
            raise ValueError(f"bundle compile-ring entry unusable: {e!r}")
    for e in rings.get("autopilot", ()):
        if not isinstance(e, dict) or not isinstance(e.get("knob"), str):
            raise ValueError(
                f"bundle autopilot-ring entry unusable: {e!r}"
            )
    state = bundle.get("state")
    if not isinstance(state, dict) \
            or not isinstance(state.get("heartbeat_age_s"), dict) \
            or not isinstance(state.get("readiness"), dict):
        raise ValueError("bundle state block unusable")
    if not isinstance(bundle.get("config"), dict):
        raise ValueError("bundle has no config block")
    return bundle


def merge_bundles(paths: Iterable[str], out_path: str | None = None) -> dict:
    """Rank-0 merge of per-host bundles: the registry and windowed
    snapshots go through :func:`telemetry.merge_exports` — counters and
    histogram vectors sum across hosts, exactly like the cumulative
    JSONL merge — and the per-host triggers/ids are listed side by
    side. Writes the merged summary to ``out_path`` when given."""
    bundles = [load_bundle(p) for p in paths]
    if not bundles:
        raise ValueError("merge_bundles needs at least one bundle")

    def _merge_section(section: str) -> dict:
        with tempfile.TemporaryDirectory(prefix="incident_merge_") as d:
            files = []
            for i, b in enumerate(bundles):
                snap = {k: v for k, v in b[section].items()
                        if k in ("schema", "counters", "gauges",
                                 "histograms")}
                files.append(telemetry.export_snapshot_jsonl(
                    snap, os.path.join(d, f"h{i}.jsonl"),
                    host=b["host"],
                ))
            return telemetry.merge_exports(files)

    merged = {
        "schema": BUNDLE_SCHEMA,
        "kind": MERGED_KIND,
        "hosts": sorted({b["host"] for b in bundles}),
        "incident_ids": [b["incident_id"] for b in bundles],
        "triggers": [b["trigger"] for b in bundles],
        "registry": _merge_section("registry"),
        "windows": _merge_section("windows"),
    }
    if out_path is not None:
        parent = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(parent, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(merged, f, indent=1)
    return merged


# ---------------------------------------------------------------------------
# explained-step-time attribution


def _hist_sum(snap: dict, names) -> float:
    return sum(
        float(snap.get("histograms", {}).get(n, {}).get("sum", 0.0))
        for n in names
    )


def _hist_count(snap: dict, names) -> int:
    return sum(
        int(snap.get("histograms", {}).get(n, {}).get("count", 0))
        for n in names
    )


def _collective_bytes(bundle: dict, snap: dict, reg: dict, steps: int
                      ) -> tuple[float, str]:
    """Total collective bytes over the attributed window, with
    provenance: the recorder's static contract (bytes-on-wire per step,
    from ``collectives.tallies()``) when fed, else the live per-dispatch
    tally (windowed delta preferred over the cumulative total), else
    the trace-time inventory scaled by step count."""
    contract = bundle.get("contract") or {}
    per_step = contract.get("collective_bytes_per_step")
    if isinstance(per_step, (int, float)) and per_step > 0:
        return float(per_step) * steps, "contract.bytes_per_step"
    sources = [(reg, "collectives.dispatched_bytes")]
    if snap is not reg:  # only a genuine windowed snapshot earns the tag
        sources.insert(
            0, (snap, "collectives.dispatched_bytes (windowed)")
        )
    for src, label in sources:
        live = src.get("counters", {}).get("collectives.dispatched_bytes")
        if isinstance(live, (int, float)) and live > 0:
            return float(live), label
    traced = sum(
        v for k, v in reg.get("counters", {}).items()
        if k.startswith("collectives.") and k.endswith(".bytes")
    )
    if traced > 0:
        # trace-time tallies are per compiled program, not per step —
        # a program traced once replays its collectives every execution
        return float(traced) * steps, "collectives.<op>.bytes x steps"
    return 0.0, "none"


def attribution(
    bundle: dict,
    *,
    flop_rate: float = DEFAULT_FLOP_RATE,
    wire_rate: float = DEFAULT_WIRE_RATE,
) -> dict | None:
    """Explained-step-time report over a bundle: shares of recent step
    wall time attributed to **data_wait** (blocked on the input
    iterator), **host_dispatch** (host work around and between step
    dispatches), **compute** and **collective** (the in-dispatch time,
    split by the static contract's compute-vs-wire cost model — see
    module docstring). Shares sum to 1.0 by construction. Prefers the
    windowed ring (the recent past) over the cumulative registry;
    ``None`` when neither holds a step sample."""
    win = bundle.get("windows") or {}
    reg = bundle.get("registry") or {}
    source = "windows" if _hist_count(win, _DISPATCH_HISTS) > 0 else "registry"
    snap = win if source == "windows" else reg
    steps = _hist_count(snap, _DISPATCH_HISTS)
    if steps <= 0:
        return None
    dispatch_s = _hist_sum(snap, _DISPATCH_HISTS)
    data_wait_s = _hist_sum(snap, _DATA_WAIT_HISTS)
    covered = float((snap.get("window") or {}).get("covered_s", 0.0))
    # the attributed wall: the covered window when it is consistent with
    # the seam sums, else the seams themselves (a registry source has no
    # window; a sparse ring can cover less than it observed)
    wall = max(covered, data_wait_s + dispatch_s)
    if wall <= 0:
        return None
    contract = bundle.get("contract") or {}
    flops_per_step = contract.get("flops_per_step")
    flops_total = (float(flops_per_step) * steps
                   if isinstance(flops_per_step, (int, float))
                   and flops_per_step > 0 else 0.0)
    bytes_total, bytes_source = _collective_bytes(bundle, snap, reg, steps)
    compute_est_s = flops_total / flop_rate
    collective_est_s = bytes_total / wire_rate
    est_total = compute_est_s + collective_est_s
    if flops_total > 0 and est_total > 0:
        coll_frac = collective_est_s / est_total
        split = "cost_model"
    else:
        # bytes without a flops estimate would claim ALL in-dispatch
        # time as collective — overstating is worse than declining.
        # The split stays unattributed (reported as compute) and
        # inputs.flops_per_step says why.
        coll_frac = 0.0
        split = "unattributed" if bytes_total > 0 else "no_collectives"
    collective_s = dispatch_s * coll_frac
    compute_s = dispatch_s - collective_s
    host_s = max(0.0, wall - dispatch_s - data_wait_s)
    seconds = {
        "data_wait": data_wait_s,
        "host_dispatch": host_s,
        "compute": compute_s,
        "collective": collective_s,
    }
    total = sum(seconds.values())
    shares = {k: round(v / total, 6) for k, v in seconds.items()}
    return {
        "schema": 1,
        "source": source,
        "split": split,
        "steps": steps,
        "wall_s": round(total, 6),
        "seconds": {k: round(v, 6) for k, v in seconds.items()},
        "shares": shares,
        "share_sum": round(sum(shares.values()), 6),
        "inputs": {
            "flops_per_step": flops_per_step,
            "collective_bytes": round(bytes_total, 1),
            "bytes_source": bytes_source,
            # per-op call counts from the static contract (when the
            # producer recorded them): names the collective FAMILY the
            # wire share belongs to — a pipeline step shows its two
            # ppermute rings here next to the psum families
            "collective_counts": contract.get("collective_counts"),
        },
        "model": {"flop_rate": flop_rate, "wire_rate": wire_rate},
    }


def diff_attribution(a: dict | None, b: dict | None) -> dict:
    """Per-share deltas between two attribution reports (``b - a``) —
    the "which component moved" answer for an incident vs a healthy
    baseline, or two bench rounds."""
    sa = (a or {}).get("shares", {})
    sb = (b or {}).get("shares", {})
    keys = sorted(set(sa) | set(sb))
    deltas = {k: round(sb.get(k, 0.0) - sa.get(k, 0.0), 6) for k in keys}
    moved = max(deltas, key=lambda k: abs(deltas[k])) if deltas else None
    return {"deltas": deltas, "moved_most": moved}


# ---------------------------------------------------------------------------
# CLI


def _fmt_attr(attr: dict | None) -> str:
    if attr is None:
        return "  (no step samples — attribution unavailable)\n"
    lines = [
        f"  steps={attr['steps']} wall={attr['wall_s']:.4f}s "
        f"(source={attr['source']}, share sum={attr['share_sum']:g})",
    ]
    for k, v in sorted(attr["shares"].items(),
                       key=lambda kv: -kv[1]):
        lines.append(f"    {k:<14} {v * 100:6.2f}%  "
                     f"({attr['seconds'][k]:.4f}s)")
    lines.append(f"  inputs: {attr['inputs']}")
    return "\n".join(lines) + "\n"


def _inspect(path: str, as_json: bool) -> int:
    bundle = load_bundle(path)
    attr = attribution(bundle)
    if as_json:
        print(json.dumps({
            "incident_id": bundle["incident_id"],
            "trigger": bundle["trigger"],
            "host": bundle["host"],
            "rings": {k: len(v) for k, v in bundle["rings"].items()},
            "trace_events": len(bundle["trace"]["traceEvents"]),
            "state": bundle["state"],
            "attribution": attr,
        }, indent=1))
        return 0
    print(f"incident {bundle['incident_id']} "
          f"(host {bundle['host']}, trigger "
          f"{bundle['trigger']['kind']!r})")
    print(f"  detail: {bundle['trigger']['detail']}")
    rings = bundle["rings"]
    print(f"  rings: {len(rings['steps'])} steps, "
          f"{len(rings['serve'])} serve decisions, "
          f"{len(bundle['trace']['traceEvents'])} trace events")
    hb = bundle["state"]["heartbeat_age_s"]
    print(f"  heartbeats: {hb if hb else '(none)'}")
    print(f"  readiness ok: {bundle['state']['readiness']['ok']}")
    print("explained step time:")
    print(_fmt_attr(attr), end="")
    return 0


def _diff(path_a: str, path_b: str, as_json: bool) -> int:
    a, b = load_bundle(path_a), load_bundle(path_b)
    attr_a, attr_b = attribution(a), attribution(b)
    d = diff_attribution(attr_a, attr_b)
    ca = a["registry"].get("counters", {})
    cb = b["registry"].get("counters", {})
    movers = sorted(
        ((k, cb.get(k, 0) - ca.get(k, 0)) for k in set(ca) | set(cb)),
        key=lambda kv: -abs(kv[1]),
    )
    movers = [(k, v) for k, v in movers if v != 0][:8]
    if as_json:
        print(json.dumps({
            "a": a["incident_id"], "b": b["incident_id"],
            "attribution": {"a": attr_a, "b": attr_b, **d},
            "counter_movers": dict(movers),
        }, indent=1))
        return 0
    print(f"{a['incident_id']}  ->  {b['incident_id']}")
    print("attribution deltas (b - a):")
    for k, v in sorted(d["deltas"].items(), key=lambda kv: -abs(kv[1])):
        tag = "  <-- moved most" if k == d["moved_most"] and v != 0 else ""
        print(f"  {k:<14} {v * 100:+7.2f}%{tag}")
    print("top counter movers:")
    for k, v in movers:
        print(f"  {k:<40} {v:+d}")
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m tpu_syncbn_torch.obs.incident",
        description="Inspect, diff, and merge flight-recorder incident "
        "bundles.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_ins = sub.add_parser("inspect", help="summary + explained-step-"
                           "time attribution for one bundle")
    p_ins.add_argument("bundle")
    p_ins.add_argument("--json", action="store_true")
    p_diff = sub.add_parser("diff", help="attribution + counter deltas "
                            "between two bundles")
    p_diff.add_argument("bundle_a")
    p_diff.add_argument("bundle_b")
    p_diff.add_argument("--json", action="store_true")
    p_merge = sub.add_parser("merge", help="rank-0 merge of per-host "
                             "bundles")
    p_merge.add_argument("out")
    p_merge.add_argument("bundles", nargs="+")
    args = parser.parse_args(argv)
    try:
        if args.cmd == "inspect":
            return _inspect(args.bundle, args.json)
        if args.cmd == "diff":
            return _diff(args.bundle_a, args.bundle_b, args.json)
        merged = merge_bundles(args.bundles, args.out)
        print(f"merged {len(args.bundles)} bundle(s) from hosts "
              f"{merged['hosts']} -> {args.out}")
        return 0
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
