"""The port's headline bench — the counterpart of ``bench.py``'s default
run: bf16 ResNet-50 converted to SyncBN, trained by ``DataParallel`` with
SGD(0.1, momentum 0.9), batch 64 a GPU at 224², 10 timed steps. Prints one
JSON line:

    {"metric": "resnet50_syncbn_dp_train_throughput", "value": img/s per GPU,
     "unit": "img/s/gpu", "backend", "bn_backend", "chips", "per_chip_batch",
     "image_side", "steps", "compile_warmup_s", "mfu", "flops_per_step",
     "flops_source", "peak_flops", "peak_source", "device_kind",
     "host_load_1m", "recovery": {...}, "scan": {...},
     "collectives": {...}, "monitor": {...}, "numerics": {...},
     "autopilot": {...}, "incident": {...}, "memory": {...}, "compile": {...},
     "audit": {...}, "layout": {...}, "serve": {...} or null, "telemetry": {...}}

Run on one GPU (or under ``python -m tpu_syncbn_torch.launch`` on several;
every rank times its own steps, the master prints):

    python -m tpu_syncbn_torch.bench
    python -m tpu_syncbn_torch.bench --scan 8     # also the fused 8-step path
    python -m tpu_syncbn_torch.bench --trace out.json   # and a Chrome trace
    python -m tpu_syncbn_torch.bench --serve      # and the serving sweep
    BENCH_PER_CHIP_BATCH=32 BENCH_STEPS=20 BENCH_IMAGE_SIDE=224 python -m tpu_syncbn_torch.bench

``--device cpu`` (tests) runs a small config (batch 8, 20 steps at 64²,
the same overrides) and prints the same keys with ``mfu: null``.

The timed window starts after two warm-up steps (they build the kernels:
``compile_warmup_s``) and ends in ``torch.cuda.synchronize()`` after the
last optimizer step, so it holds every update, not only the last loss.

FLOPs a step come from ``torch.utils.flop_counter.FlopCounterMode`` over
one training step (forward, backward and update): it counts convolution
and matrix-multiply work only, so BatchNorm, activations, the loss and
the optimizer add nothing to ``flops_per_step`` (``flops_source``
"torch-flop-counter"). The peak comes from :data:`PEAK_FLOPS`, keyed on
``torch.cuda.get_device_name()``; a card not in it gives ``mfu: null``.

``recovery`` (:func:`measure_recovery`) is what robustness costs on the
bench's training state: checkpoint round trips with and without the
manifest, the async save's loop-visible cost, and the resume after a
killed write. ``scan`` is the host-dispatch-gap fraction of the timed
loop: 1 − (time inside the dispatch calls, by ``time.perf_counter``
around each) / wall. With ``--scan K`` the same batch also runs through
``DataParallel.train_steps_batches`` on K-stacked copies (one CUDA graph
replay a chunk on the card), for ceil(steps / K) chunks (at least as
many steps as the per-step loop), and the block
gives that loop's fraction and img/s beside the per-step loop's
(``host_gap_frac_scan1``). Its ``pipeline`` sub-block
(:func:`measure_pipeline_bubbles`, null at world 1) is the pipeline
schedules' predicted and measured bubbles on a micro-model over every
process, and ``bubble_frac_predicted`` / ``bubble_frac_measured`` are
1F1B's.

``collectives`` (:func:`measure_collectives`) is the compressed wire on a
1 MiB-a-GPU f32 payload: per mode (``fp32``, ``bf16``, ``int8``,
``shuffle_sharded``) the bytes it puts on the wire, the time a call and
the compression ratio against fp32.

``incident`` (:func:`measure_incident`), ``memory`` (:func:`measure_memory`)
and ``compile`` (:func:`compile_block`) are the flight recorder, the memory
watermarks and the compile events measured on the run (``bench.py``'s
blocks of those names): a flight recorder and a memory sampler ride the
timed loop (one ``record_step`` a step, a sample before and after), then
a forced manual bundle gives its dump time, size and attribution; the
memory contract on the card is the audited per-device peak of the benched
step (the ``audit`` block's, ``contract_source: "sharding_audit"``, as
``bench.py``'s), the warm step's ``max_memory_allocated`` only when the
audit block could not run, and a planted drill fires one ``mem_pressure``
bundle on a scratch recorder; one bounded profiler capture runs through
``obs.profiling.serve_capture``.

``audit`` (:func:`measure_audit`) is ``bench.py``'s block of that name:
the source lint over the package and the audit's layer 3 over the benched
trainer's own step body (``DataParallel.lowered_train_step``: placement,
implicit reshards, replicated intermediates and the per-device peak), with
the allocator's reading of the same application beside the peak.
``layout`` (:func:`measure_layout`) is ``bench.py``'s too: the audit
registry's three ``layout.*`` programs (the same Adam MLP under plain DP,
DP×FSDP and DP×FSDP on the int8 wire) recorded on the pinned world of 8
gloo processes on the host's CPU, in one spawn: each one's world, peak and
wire bytes, and the two ratios.

``monitor`` (:func:`measure_monitor`) is the live-monitoring layer on the
run's own metrics: an ephemeral ``obs.server.MonitoringServer`` on port 0
sharing the loop's windowed aggregator, one ``/metrics`` scrape, the
probes, the windowed step rate and p99, and one SLO evaluation.
``numerics`` (:func:`measure_numerics`) is the numerics publisher that
rode the loop: the final monitors, its samples, its cost a publish and one
forced ``numerics_drift`` bundle. Both are ``bench.py``'s blocks of those
names, key for key, and ``numerics`` runs before the ``incident`` block's
forced dump, as there. ``autopilot`` (:func:`measure_autopilot`) is the
closed-loop controller's A/B under a planted int8 clip fault, with its
bundles; it runs between those two blocks, as ``bench.py``'s does.

``serve`` (:func:`measure_serve`, with ``--serve``; null without it) is
``bench.py``'s serve block on the bench's trained state: an
``InferenceEngine`` (one CUDA graph a bucket) behind ``DynamicBatcher``s,
closed-loop levels at 1 and 2 x ``max_batch`` clients, the open-loop
sweep past saturation, the weight-swap drill (``publish``,
:func:`measure_serve_publish`) and the two-tenant isolation drill.

``telemetry`` is the process registry's snapshot (``obs.telemetry``, schema
1, as ``bench.py``'s): the timed loop's ``step.time_s`` and
``step.data_wait_s`` histograms (each timed step runs under the
``obs.stepstats`` seams), the checkpoint timings of ``recovery``, the
collective tallies, the numerics histograms of the trainer's monitors
(published without a synchronize) and the probe's outcome. Telemetry is
switched on for the run. ``--trace PATH`` also installs a tracer and
writes the run's Chrome trace (``data_wait``, ``step``, ``scan_chunk`` and
``checkpoint_*`` spans) to PATH before the line is printed.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import sys
import tempfile
import time
import zlib

import torch
import torch.nn.functional as F

#: dense bf16 tensor-core peak by device name: (FLOP/s, source)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": (
        989.4e12, "NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s dense BF16"),
}


def bench_config(on_accel: bool) -> dict:
    """The workload, with ``BENCH_PER_CHIP_BATCH`` / ``BENCH_STEPS`` /
    ``BENCH_IMAGE_SIDE`` overrides (``bench.py``'s ``bench_config``)."""
    batch, steps, side = (64, 10, 224) if on_accel else (8, 20, 64)
    return {
        "per_chip_batch": int(os.environ.get("BENCH_PER_CHIP_BATCH", batch)),
        "steps": int(os.environ.get("BENCH_STEPS", steps)),
        "side": int(os.environ.get("BENCH_IMAGE_SIDE", side)),
    }


def _host_load() -> float | None:
    try:
        return round(os.getloadavg()[0], 2)
    except (AttributeError, OSError):
        return None


def _loss_fn(model, batch):
    x, y = batch
    return F.cross_entropy(model(x).float(), y.long())  # CE in f32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_recovery(dp, *, repeats: int = 3) -> dict:
    """The ``recovery`` block (``bench.py``'s ``measure_recovery``): on the
    bench's training state, best of ``repeats`` each,

    * ``ckpt_roundtrip_s`` — save + load through ``utils.checkpoint`` with
      the manifest and its verification (the shipped path);
    * ``ckpt_roundtrip_seed_s`` — the payload alone: the host snapshot, a
      plain ``torch.save`` to bytes, the atomic write, the read and
      ``torch.load``;
    * ``manifest_overhead_s`` / ``_frac`` — the verification's own cost,
      timed component by component (checksums at save and load, the tree
      hash, the manifest's write and read) against the seed round trip;
    * ``ckpt_async_enqueue_s`` / ``_flush_s`` — what the loop pays for an
      ``AsyncCheckpointer.save`` and the wait for its writes, and whether
      the async write certifies (``async_manifest_verified``);
    * ``resume_after_kill_s`` — load when the newest checkpoint was
      truncated mid-write: detection, fallback to the older verified step
      (``resumed_step_after_kill``) and restore; ``ckpt_bytes``."""
    from tpu_syncbn_torch.testing import faults
    from tpu_syncbn_torch.utils import checkpoint as ckpt

    d = tempfile.mkdtemp(prefix="bench_recovery_")
    try:
        state = dp.state_dict()
        template = dp.state_dict()

        def timed(fn):
            best = None
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            return best

        def shipped():
            ckpt.save_checkpoint(d, 1, state, keep=0)
            ckpt.load_checkpoint(d, template)

        seed_file = os.path.join(d, "seed.pt")

        def seed():
            ckpt._atomic_write(d, seed_file, ckpt._to_bytes(ckpt.snapshot_to_host(state)))
            with open(seed_file, "rb") as f:
                ckpt._from_bytes(f.read(), None)

        shipped_s = timed(shipped)
        seed_s = timed(seed)
        ckpt_bytes = os.path.getsize(ckpt._path(d, 1))

        async_dir = os.path.join(d, "async")
        ac = ckpt.AsyncCheckpointer(keep=0, max_pending=repeats + 1)
        async_step = [0]

        def async_enqueue():
            async_step[0] += 1
            ac.save(async_dir, async_step[0], state)

        async_enqueue_s = timed(async_enqueue)
        t0 = time.perf_counter()
        ac.flush()
        async_flush_s = time.perf_counter() - t0
        async_verified = ckpt.verify_checkpoint(async_dir, async_step[0])
        ac.close()

        host = ckpt.snapshot_to_host(state)
        data = ckpt._to_bytes(host)

        def verify_components():
            ckpt.payload_sum64(data)  # save side
            ckpt.payload_sum64(data)  # load side
            if len(data) <= ckpt._CRC32_MAX_BYTES:
                zlib.crc32(data)
                zlib.crc32(data)
            ckpt.tree_structure_hash(host)
            mpath = os.path.join(d, "probe.manifest.json")
            ckpt._atomic_write(d, mpath, b"{}" * 64)
            with open(mpath, "rb") as f:
                f.read()

        overhead_s = timed(verify_components)

        # an injected kill: the newest checkpoint truncated mid-write
        ckpt.save_checkpoint(d, 1, state, keep=0)
        ckpt.save_checkpoint(d, 2, state, keep=0)
        faults.truncate_file(ckpt._path(d, 2))
        t0 = time.perf_counter()
        _, resumed_step = ckpt.load_checkpoint(d, template)
        resume_s = time.perf_counter() - t0
        return {
            "ckpt_roundtrip_s": round(shipped_s, 4),
            "ckpt_roundtrip_seed_s": round(seed_s, 4),
            "manifest_overhead_s": round(overhead_s, 4),
            "manifest_overhead_frac": round(overhead_s / seed_s, 4) if seed_s > 0 else None,
            "ckpt_async_enqueue_s": round(async_enqueue_s, 4),
            "ckpt_async_flush_s": round(async_flush_s, 4),
            "async_manifest_verified": bool(async_verified),
            "resume_after_kill_s": round(resume_s, 4),
            "resumed_step_after_kill": resumed_step,
            "ckpt_bytes": ckpt_bytes,
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _timed_loop(device, n: int, dispatch) -> tuple[float, float]:
    """``(wall, in-dispatch)`` seconds of ``n`` calls of ``dispatch``, the
    wall closed by a synchronize after the last."""
    _sync(device)
    inside = 0.0
    t0 = time.perf_counter()
    for _ in range(n):
        a = time.perf_counter()
        dispatch()
        inside += time.perf_counter() - a
    _sync(device)
    return time.perf_counter() - t0, inside


#: How long the serving blocks wait for their client threads: each client
#: sends a few requests, and each request waits at most 600 s for its result.
CLIENT_JOIN_S = 900.0


def _join_clients(threads, timeout_s: float = CLIENT_JOIN_S) -> None:
    """Join a serving block's client threads within one shared deadline,
    and raise if one is still running (a wedged engine or batcher) rather
    than wait for it forever."""
    deadline = time.monotonic() + timeout_s
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    alive = [th.name for th in threads if th.is_alive()]
    if alive:
        raise RuntimeError(
            f"serve bench clients still running after {timeout_s:g} s: {alive}")


def _gap(wall: float, inside: float) -> tuple[float, float]:
    """``(host_gap_frac, dispatch_frac)`` of a timed loop."""
    frac = inside / wall
    return round(max(0.0, 1.0 - frac), 6), round(frac, 6)


def measure_collectives(device: torch.device, *, payload_mb: float = 1.0,
                        steps: int = 5) -> dict:
    """The ``collectives`` block (``bench.py``'s ``measure_collectives``):
    one flat f32 payload of ``payload_mb`` MiB a GPU through
    ``compressed_pmean`` at ``"none"`` (``fp32``), ``"bf16"`` and
    ``"int8"``, and through ``shuffle_sharded_psum`` (exact), over the
    default group:

    * ``wire_bytes`` — what a call puts on the wire a replica: the f32
      payload for ``fp32`` (an all-reduce's input, at any world size), the
      compressed accounting (``collectives.compression_tallies``) for the
      lossy modes, the ppermute tallies for ``shuffle_sharded`` (0 at world
      1, where it issues none);
    * ``ms`` — a call's time (mean of ``steps``, closed by a synchronize),
      quantize and dequantize kernels included; ``gbytes_per_s`` — wire
      bytes over it; ``compression_ratio`` — fp32's wire over the mode's.

    ``golden_ratio`` is each lossy mode's compression ratio as the audit's
    pinned contracts give it (``bench.py``'s): the lossy-eligible wire bytes
    of the ``dataparallel.compressed_fp32`` golden over the mode's
    (``program_audit.lossy_collective_bytes``), null when a golden cannot
    be read."""
    from tpu_syncbn_torch.parallel import collectives as coll
    from tpu_syncbn_torch.parallel.trainer import _default_group

    t_start = time.perf_counter()
    group = _default_group()
    world = coll.world_size(group)
    n = max(1024, int(payload_mb * (1 << 20) / 4))
    x = torch.ones(n, dtype=torch.float32, device=device)
    calls = {
        "fp32": lambda: coll.compressed_pmean(x, group, mode="none"),
        "bf16": lambda: coll.compressed_pmean(x, group, mode="bf16"),
        "int8": lambda: coll.compressed_pmean(x, group, mode="int8"),
        "shuffle_sharded": lambda: coll.shuffle_sharded_psum(x, group),
    }
    modes, fp32_bytes = {}, None
    for mode, fn in calls.items():
        fn()  # warm: builds the kernels
        _sync(device)
        coll.reset_tallies()
        fn()
        if mode == "fp32":
            wire = n * 4
        elif mode == "shuffle_sharded":
            wire = coll.tallies().get("ppermute", {}).get("bytes", 0)
        else:
            wire = coll.compression_tallies()["compressed_bytes"]
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        _sync(device)
        dt = (time.perf_counter() - t0) / steps
        if mode == "fp32":
            fp32_bytes = wire
        modes[mode] = {
            "wire_bytes": wire,
            "ms": round(dt * 1e3, 3),
            "gbytes_per_s": round(wire / max(dt, 1e-9) / 1e9, 3) if wire else None,
            "compression_ratio": (round(fp32_bytes / wire, 3)
                                  if wire and fp32_bytes else None),
        }
    coll.reset_tallies()
    return {
        "payload_mb_per_chip": payload_mb,
        "world": world,
        "modes": modes,
        "golden_ratio": golden_ratios(),
        "measure_s": round(time.perf_counter() - t_start, 3),
    }


def measure_incident(recorder, last_out, *, steps: int, wall_s: float,
                     flops_per_step: float | None, tallies: dict) -> dict:
    """The ``incident`` block (``bench.py``'s ``measure_incident``): the
    recorder rode the timed loop (one ``record_step`` a step), so its rings
    hold the loop's steps and its aggregator the loop's window. The block
    feeds it the step's contract — ``flops_per_step`` from
    ``torch.utils.flop_counter`` and the collective bytes and calls of one
    step from ``collectives.tallies()`` — forces the manual trigger and
    reports:

    * ``dump_s`` / ``bundle_bytes`` — the dump's latency and size;
    * ``ring_steps`` / ``ring_seconds`` — how far back the step ring reaches;
    * ``record_step_cost_s`` / ``record_overhead_frac`` — one ``record_step``
      call, micro-measured on the loop's last step output ``last_out`` (on
      the card: a stacked device copy to page-locked memory), against the
      timed loop's average step;
    * ``attribution`` — the explained-step-time report over the bundle, at
      the card's rates (``obs.incident``)."""
    from tpu_syncbn_torch.obs import incident as incident_mod

    bytes_per_step = sum(v["bytes"] for v in tallies.values()) or None
    counts = {op: v["calls"] for op, v in sorted(tallies.items())} or None
    recorder.set_contract(
        name="resnet50_syncbn_dp.train_step", flops_per_step=flops_per_step,
        collective_bytes_per_step=bytes_per_step, collective_counts=counts,
        fingerprint=incident_mod.contract_fingerprint())
    coverage = recorder.ring_coverage()
    bundle_dir = tempfile.mkdtemp(prefix="bench_incident_")
    prev_dir = recorder.incident_dir
    recorder.incident_dir = bundle_dir
    try:
        t0 = time.perf_counter()
        path = recorder.trigger("manual", {"source": "bench"}, force=True)
        dump_s = time.perf_counter() - t0
        if path is None:
            raise RuntimeError("forced manual trigger produced no bundle")
        bundle_bytes = os.path.getsize(path)
        bundle = incident_mod.load_bundle(path)  # schema-validates
        attr = incident_mod.attribution(bundle)
    finally:
        recorder.incident_dir = prev_dir
        shutil.rmtree(bundle_dir, ignore_errors=True)
    # the loop's own record, replayed on its last step output
    metrics = {"loss": last_out.loss, **last_out.metrics}
    n = 200
    t0 = time.perf_counter()
    for i in range(n):
        recorder.record_step(i, metrics=metrics, monitors=last_out.monitors)
    record_cost_s = (time.perf_counter() - t0) / n
    avg_step_s = wall_s / steps if steps else None
    return {
        "dump_s": round(dump_s, 4),
        "bundle_bytes": bundle_bytes,
        "incident_id": bundle["incident_id"],
        "trigger": bundle["trigger"]["kind"],
        "ring_steps": coverage["steps"],
        "ring_seconds": coverage["seconds"],
        "trace_events": len(bundle["trace"]["traceEvents"]),
        "record_step_cost_s": round(record_cost_s, 9),
        "record_overhead_frac": (
            round(record_cost_s / avg_step_s, 6) if avg_step_s else None),
        "attribution": None if attr is None else {
            "steps": attr["steps"],
            "shares": attr["shares"],
            "share_sum": attr["share_sum"],
            "bytes_source": attr["inputs"]["bytes_source"],
            "collective_counts": attr["inputs"]["collective_counts"],
        },
    }


def measure_monitor(agg) -> dict:
    """The ``monitor`` block (``bench.py``'s ``measure_monitor``): the
    live-monitoring layer benchmarked on the run's own metrics.

    Spins an ephemeral :class:`~tpu_syncbn_torch.obs.server.MonitoringServer`
    on port 0 sharing the run's windowed aggregator (``agg`` was ticked
    around the timed loop) and reports:

    * ``metrics_fetch_s`` / ``exposition_bytes`` / ``series`` — one
      ``/metrics`` scrape end to end (render + HTTP), the latency a
      Prometheus scraper would pay against this process;
    * ``healthz_ok`` / ``readyz_ok`` — the probe endpoints answer;
    * ``window_agreement`` — windowed ``step.time_s`` count over the
      cumulative count: the delta layer saw exactly the steps the
      registry did (1.0 = no samples lost between ticks);
    * rolling ``steps_per_s_windowed`` / ``step_p99_s_windowed`` and one
      SLO evaluation (``step.time_s p99 < 60`` — a liveness-grade
      objective any healthy run meets) with its burn rate, proving the
      alert path computes on real data."""
    import urllib.error
    from urllib.request import urlopen

    from tpu_syncbn_torch.obs import server as obs_server, slo as obs_slo, telemetry

    def probe(url):
        """(status, body) without raising on 5xx — a 503 readiness answer
        is a measurement (``readyz_ok: false``), not a failure."""
        try:
            with urlopen(url, timeout=30) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    srv = obs_server.MonitoringServer(port=0, host="127.0.0.1", aggregator=agg)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        t0 = time.perf_counter()
        status, body = probe(base + "/metrics")
        fetch_s = time.perf_counter() - t0
        if status != 200:
            raise RuntimeError(f"/metrics answered {status}")
        healthz_ok = probe(base + "/healthz")[0] == 200
        readyz_ok = probe(base + "/readyz")[0] == 200
    finally:
        srv.close()

    windowed = agg.windowed_snapshot()
    telemetry.validate_snapshot(windowed)
    w_steps = windowed["histograms"].get("step.time_s", {}).get("count", 0)
    c_steps = telemetry.snapshot()["histograms"].get("step.time_s", {}).get("count", 0)
    tracker = obs_slo.SLOTracker(agg, [obs_slo.AlertRule(
        "bench_step", "step.time_s p99 < 60", windows_s=(3600.0,),
    )])
    tracker.evaluate()
    state = tracker.state()["bench_step"]
    burns = [b for b in state["burns"].values() if b is not None]
    p99 = agg.quantile("step.time_s", 0.99)
    rate = agg.rate("step.time_s")
    return {
        "port": srv.port,
        "metrics_fetch_s": round(fetch_s, 6),
        "exposition_bytes": len(body),
        "series": body.count(b"# TYPE "),
        "healthz_ok": bool(healthz_ok),
        "readyz_ok": bool(readyz_ok),
        "windowed_steps": w_steps,
        "cumulative_steps": c_steps,
        "window_agreement": round(w_steps / c_steps, 4) if c_steps else None,
        "steps_per_s_windowed": round(rate, 4) if rate is not None else None,
        "step_p99_s_windowed": round(p99, 6) if p99 is not None else None,
        "slo_burn_rate": round(max(burns), 4) if burns else None,
        "slo_firing": bool(state["firing"]),
    }


def measure_numerics(publisher, monitors, *, steps: int, wall_s: float) -> dict:
    """The ``numerics`` block (``bench.py``'s ``measure_numerics``): the
    numerics publisher rode the timed loop (one non-blocking ``publish`` a
    step beside ``flightrec.record_step``), so the ``numerics.*``
    histograms hold the loop's series. Reports:

    * ``monitors`` — the final step's numerics monitor values;
    * ``samples`` / ``published`` — the registry's sample count and how
      many step records the loop's publisher emitted;
    * ``record_step_cost_s`` / ``record_overhead_frac`` — one publish of
      plain-float monitors (the queue and emit path itself), micro-measured
      into a scratch registry, over the timed loop's average step;
    * ``drift`` — a forced threshold crossing must produce exactly ONE
      valid ``numerics_drift`` bundle carrying the step ring;
    * ``rules`` — the ``numerics_rules()`` SLO rule names."""
    from tpu_syncbn_torch.obs import (
        flightrec, incident as incident_mod, numerics as obs_numerics, telemetry,
    )

    publisher.flush()
    final: dict = {}
    for key in sorted(obs_numerics.PUBLISHED_MONITORS):
        if isinstance(monitors, dict) and key in monitors:
            try:
                v = float(monitors[key])
            except (TypeError, ValueError):
                final[key] = None
                continue
            # non-finite values become strings (strict JSON), as the
            # flight recorder's ring entries do
            finite = v == v and abs(v) != float("inf")
            final[key] = round(v, 6) if finite else str(v)
    # steady-state publish cost on plain floats (ready by construction),
    # into a scratch registry: 1000 synthetic records would otherwise
    # dilute the run's numerics series
    probe = obs_numerics.NumericsPublisher(thresholds={})
    sample = {k: 0.0 for k in ("bn_mean_skew", "bn_var_skew", "replica_grad_norm",
                               "replica_grad_norm_disp")}
    live_registry = telemetry.REGISTRY
    telemetry.REGISTRY = telemetry.Registry()
    try:
        t0 = time.perf_counter()
        for i in range(1000):
            probe.publish(i, sample)
        record_cost_s = (time.perf_counter() - t0) / 1000
    finally:
        telemetry.REGISTRY = live_registry
    avg_step_s = wall_s / steps if steps else None
    # forced drift: a publisher with a zero threshold dumps exactly one
    # numerics_drift bundle whose step ring holds the loop's monitors
    drift = None
    rec = flightrec.get()
    if rec is not None:
        drift_dir = tempfile.mkdtemp(prefix="bench_numerics_")
        prev_dir = rec.incident_dir
        rec.incident_dir = drift_dir
        try:
            dpub = obs_numerics.NumericsPublisher(thresholds={"bn_mean_skew": 0.0})
            dpub.publish(steps, {"bn_mean_skew": 1.0})
            names = [n for n in os.listdir(drift_dir) if n.endswith(".json")]
            drift = {"bundles": len(names), "trigger": None, "ring_steps": 0,
                     "valid": False}
            if len(names) == 1:
                bundle = incident_mod.load_bundle(os.path.join(drift_dir, names[0]))
                drift = {
                    "bundles": 1,
                    "trigger": bundle["trigger"]["kind"],
                    "ring_steps": len(bundle["rings"]["steps"]),
                    "valid": bundle["trigger"]["kind"] == "numerics_drift",
                }
        finally:
            rec.incident_dir = prev_dir
            shutil.rmtree(drift_dir, ignore_errors=True)
    snap = telemetry.snapshot()
    return {
        "monitors": final,
        "samples": snap["counters"].get("numerics.samples", 0),
        "published": publisher.published,
        "record_step_cost_s": round(record_cost_s, 9),
        "record_overhead_frac": (
            round(record_cost_s / avg_step_s, 6) if avg_step_s else None),
        "drift": drift,
        "rules": [r.name for r in obs_numerics.numerics_rules()],
    }


#: ``measure_autopilot``'s starting weight, (out, in): the JAX bench's
#: ``FaultyNet`` initialisation (flax's ``nnx.Linear(8, 4)`` under
#: ``nnx.Rngs(0)``, zero bias) as a table, so both blocks start from one
#: point. The planted fault's first steps are sensitive to it: at a global
#: batch of 2 the second step's clip fraction, hence the escalation's
#: chunk, moves with the weights.
_FAULTY_NET_WEIGHT = (
    (0.37836495, -0.32997137, 0.59664911, -0.4314579, 0.22701877, -0.24174356,
     0.34358928, -0.76552171),
    (-0.34285027, 0.22467545, -0.65830928, 0.09172684, -0.18077911, -0.32969859,
     -0.18817075, 0.1689815),
    (-0.28441685, 0.27537689, -0.47841427, 0.6201849, 0.34625265, 0.28822023,
     0.33631027, 0.63963628),
    (-0.43788025, -0.38614255, 0.05124438, 0.19298476, 0.13830097, 0.39950079,
     0.59191257, -0.43849984),
)


def measure_autopilot(*, n_chips: int, device: torch.device) -> dict:
    """The ``autopilot`` block (``bench.py``'s ``measure_autopilot``, key
    for key): the closed-loop controller A/B under a planted numerics
    fault, on a SCRATCH registry so its ``numerics.*`` series never reach
    the run's own numerics block or SLO evaluations.

    Two arms train the same tiny regression (one init, one batch, one
    learning rate) on the bench's device, each a ``DataParallel`` at
    ``compress="int8"`` without error feedback (on the card every step
    launches the three int8 kernels). The model carries an inert ``fault``
    parameter whose L1 penalty puts a gradient of ``FAULT_GAIN`` (three
    orders of magnitude above the real gradients) into the same 256-element
    chunk as every real gradient, so the chunk's range pins every real
    gradient to the clip edge (``clip_fraction`` ≈ 1):

    * **static int8**: the real signal never reaches the wire and the
      dequantized bias degrades the loss;
    * **autopilot**: the same trainer plus an
      :class:`~tpu_syncbn_torch.runtime.autopilot.Autopilot` on the
      ``numerics_rules()`` SLOs — ``numerics_clip`` burns, the controller
      escalates off int8 within one evaluation window
      (``escalate_within_chunks``) and the arm converges
      (``advantage_ratio``: the static arm's final eval MSE over this
      one's).

    The controller's clock is injected (30 s a chunk) and the installed
    flight recorder, if any, is pointed at a temporary directory with
    cooldown 0 for the block: every actuation must dump one schema-valid
    ``autopilot`` bundle naming its signal (``bundles``; None without a
    recorder). ``n_chips`` sets the global batch (2 a chip, as JAX's);
    each rank trains on its contiguous share."""
    import numpy as np

    from tpu_syncbn_torch import parallel, runtime
    from tpu_syncbn_torch.obs import (
        flightrec, incident as incident_mod, numerics as obs_numerics, telemetry, timeseries,
    )
    from tpu_syncbn_torch.runtime import autopilot as autopilot_mod

    FAULT_GAIN, FEATURES, OUT, STEPS, LR = 1000.0, 8, 4, 36, 0.2
    B = 2 * n_chips
    rng = np.random.RandomState(0)
    xs = rng.randn(B, FEATURES).astype(np.float32)
    w_true = (0.7 * rng.randn(FEATURES, OUT)).astype(np.float32)
    ys = xs @ w_true
    w0 = np.asarray(_FAULTY_NET_WEIGHT, np.float32)
    world, rank = runtime.process_count(), runtime.process_index()
    rows = slice(rank * B // world, (rank + 1) * B // world)

    class FaultyNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(FEATURES, OUT, device=device)
            with torch.no_grad():
                self.fc.weight.copy_(torch.from_numpy(w0))
                self.fc.bias.zero_()
            # inert for predictions; only the loss's L1 term sees it
            self.fault = torch.nn.Parameter(torch.ones(1, device=device))

        def forward(self, x):
            return self.fc(x)

    def loss_fn(m, batch):
        bx, by, flag = batch
        mse = ((m(bx) - by) ** 2).mean()
        return mse + flag.mean() * m.fault.abs().sum()

    def batch_with(flag):
        return tuple(torch.from_numpy(a[rows]).to(device)
                     for a in (xs, ys, np.full((B,), flag, np.float32)))

    train_batch = batch_with(FAULT_GAIN)
    eval_batch = batch_with(0.0)  # fault term off: the pure MSE

    def make_arm():
        model = FaultyNet()
        return parallel.DataParallel(
            model, torch.optim.SGD(model.parameters(), lr=LR), loss_fn, device=device,
            compress="int8", error_feedback=False, monitors=True)

    def eval_mse(dp):
        return round(float(dp.eval_step(eval_batch).loss), 6)

    live_registry = telemetry.REGISTRY
    rec = flightrec.get()
    ap_dir = prev_dir = prev_cooldown = None
    if rec is not None:
        ap_dir = tempfile.mkdtemp(prefix="bench_autopilot_")
        prev_dir, prev_cooldown = rec.incident_dir, rec.cooldown_s
        rec.incident_dir, rec.cooldown_s = ap_dir, 0.0
    try:
        telemetry.REGISTRY = scratch = telemetry.Registry()

        # static arm: int8 all the way down
        dp_static = make_arm()
        initial_mse = eval_mse(dp_static)
        for _ in range(STEPS):
            dp_static.train_step(train_batch)
        static_final = eval_mse(dp_static)

        # autopilot arm: the same trainer plus the controller on the
        # numerics SLOs, escalation only
        dp_auto = make_arm()
        agg = timeseries.WindowedAggregator(scratch)
        clock = {"t": 0.0}
        pilot = autopilot_mod.Autopilot(
            dp_auto, aggregator=agg, rules=obs_numerics.numerics_rules(),
            modes=("int8", "bf16", "none"), window_s=60.0, healthy_for_s=1e9,
            now=lambda: clock["t"])
        publisher = obs_numerics.NumericsPublisher(thresholds={})
        decisions: list[dict] = []
        for i in range(STEPS):
            out = dp_auto.train_step(train_batch)
            publisher.publish(i, out.monitors)
            publisher.flush()
            clock["t"] = 30.0 * (i + 1)
            agg.tick(now=clock["t"])
            decisions += pilot.on_chunk(step=i)
        auto_final = eval_mse(dp_auto)
    finally:
        telemetry.REGISTRY = live_registry
        bundles = None
        if rec is not None:
            rec.incident_dir, rec.cooldown_s = prev_dir, prev_cooldown
            # with cooldown 0 the tracker's own slo_alert bundles land here
            # too; only the autopilot ones are under test
            signals, n_autopilot, valid, other = [], 0, True, 0
            for name in sorted(os.listdir(ap_dir)):
                if not name.endswith(".json"):
                    continue
                b = incident_mod.load_bundle(os.path.join(ap_dir, name))  # validates
                if b["trigger"]["kind"] != "autopilot":
                    other += 1
                    continue
                n_autopilot += 1
                signals.append(b["trigger"]["detail"].get("signal"))
                valid = valid and (bool(b["trigger"]["detail"].get("signal"))
                                   and len(b["rings"].get("autopilot", ())) > 0)
            bundles = {"count": n_autopilot, "valid": valid and n_autopilot > 0,
                       "signals": signals, "other_kinds": other}
            shutil.rmtree(ap_dir, ignore_errors=True)
    escalations = [d for d in decisions if d["action"] == "escalate"]
    first_escalate = escalations[0] if escalations else None
    st = pilot.state()
    return {
        "steps": STEPS,
        "fault_gain": FAULT_GAIN,
        "initial_mse": initial_mse,
        "static_final_mse": static_final,
        "autopilot_final_mse": auto_final,
        # the A/B verdict: how much worse the uncontrolled arm ends up
        "advantage_ratio": round(static_final / max(auto_final, 1e-9), 3),
        # the 1-based chunk of the first escalation: "within one evaluation
        # window" is <= 2 (window_s over 30 s a chunk)
        "escalate_within_chunks": first_escalate["chunk"] if first_escalate else None,
        "first_signal": first_escalate["signal"] if first_escalate else None,
        "modes_visited": ["int8"] + [d["to"] for d in escalations],
        "final_mode": st["compress"],
        "actuations": st["actuations"],
        "clamped": st["clamped"],
        "suppressed": st["suppressed"],
        "bundles": bundles,
    }


def golden_ratios() -> dict:
    """``{"bf16", "int8"}``: fp32's lossy-eligible wire bytes over each
    mode's, from the port's pinned ``dataparallel.compressed_*`` goldens
    (arithmetic over the files, nothing recorded); null entries when a
    golden cannot be read."""
    from tpu_syncbn_torch.audit import program_audit
    from tpu_syncbn_torch.audit.contracts import load_contract

    gd = program_audit.default_golden_dir()
    try:
        def lossy(mode):
            return program_audit.lossy_collective_bytes(load_contract(
                program_audit.golden_path(gd, f"dataparallel.compressed_{mode}.train_step")))

        fp32 = lossy("fp32")
        return {m: round(fp32 / max(1, lossy(m)), 3) for m in ("bf16", "int8")}
    except (OSError, ValueError, KeyError) as e:
        log(f"collectives golden ratios unavailable: {e}")
        return {"bf16": None, "int8": None}


def measure_audit(dp, batch, device: torch.device) -> dict:
    """The ``audit`` block (``bench.py``'s ``measure_audit``): the source lint
    over the package (layer 2) and the audit's layer 3 over the benched
    trainer's own step body, recorded once on its state and ``batch`` and
    undone (``DataParallel.lowered_train_step(sharding=True)``). A healthy run
    reads ``implicit_reshards`` and ``replicated_intermediates`` 0;
    ``peak_bytes_per_device`` is the rank's peak live bytes over the body,
    the memory block's contract, and ``xla_peak_bytes`` the allocator's
    reading of the same application (``DESIGN.md`` §8 of the audit)."""
    from tpu_syncbn_torch import audit as audit_mod

    t0 = time.perf_counter()
    lint = audit_mod.run_audit(contracts=False)
    flow = dp.lowered_train_step(batch, sharding=True, memory=True).flow()
    return {
        "files_linted": lint.files_linted,
        "lint_violations": len(lint.violations),
        "sharding": {
            "collectives_explained": flow.collectives_explained,
            "implicit_reshards": flow.implicit_reshards,
            "replicated_intermediates": flow.replicated_intermediates,
            "max_replicated_mb": round(flow.max_replicated_bytes / 1e6, 3),
            "peak_mb_per_device": round(flow.peak_bytes_per_device / 1e6, 3),
            "peak_bytes_per_device": int(flow.peak_bytes_per_device),
            "xla_peak_bytes": flow.xla_peak_bytes,
        },
        "audit_s": round(time.perf_counter() - t0, 3),
    }


LAYOUT_KINDS = ("dp", "dp_fsdp", "dp_fsdp_int8")


def measure_layout() -> dict:
    """The ``layout`` block (``bench.py``'s ``measure_layout``): the same
    Adam MLP under plain DP, DP×FSDP and DP×FSDP on the int8 wire — the
    audit registry's ``layout.*`` programs, recorded on the pinned world of
    ``program_audit.PINNED_WORLD`` gloo processes on the host's CPU in one
    spawn: per kind its world, per-device peak and wire bytes a step;
    ``fsdp_peak_ratio`` the DP×FSDP peak over DP's (the
    ``contract.fsdp_peak_memory`` claim, ≤ 0.6 in JAX; ROADMAP C.7 records
    the port's, printed as measured) and ``int8_wire_ratio`` DP×FSDP's wire
    bytes over its int8 twin's."""
    from tpu_syncbn_torch.audit import program_audit

    t0 = time.perf_counter()
    names = [f"layout.{k}.train_step" for k in LAYOUT_KINDS]
    live = program_audit.pinned_world_contracts(names)
    if live["errors"]:
        raise RuntimeError(f"layout programs failed extraction: {live['errors']}")
    per_kind = {}
    for kind, name in zip(LAYOUT_KINDS, names):
        c = live["contracts"][name]
        per_kind[kind] = {"world": int(c.world),
                          "peak_bytes_per_device": int(c.sharding.peak_bytes_per_device),
                          "wire_bytes_per_device": int(live["costs"][name]["bytes_total"])}
    dp, fs, q = (per_kind[k] for k in LAYOUT_KINDS)
    return {
        **per_kind,
        "fsdp_peak_ratio": round(fs["peak_bytes_per_device"]
                                 / max(dp["peak_bytes_per_device"], 1), 4),
        "int8_wire_ratio": round(fs["wire_bytes_per_device"]
                                 / max(q["wire_bytes_per_device"], 1), 4),
        "layout_s": round(time.perf_counter() - t0, 3),
    }


def measure_memory(sampler, *, warm_peak_bytes: int | None, steps: int,
                   wall_s: float, audited_peak_bytes: int | None = None) -> dict:
    """The ``memory`` block (``bench.py``'s ``measure_memory``): the sampler
    watched the run (the caching allocator's counters on the card, the
    host's evidence on the CPU). The contract is the audited per-device
    peak of the benched step (``audited_peak_bytes``, the ``audit`` block's:
    ``contract_source: "sharding_audit"``, as JAX's), or where the audit
    block could not run the warm step's measured ``max_memory_allocated``
    (``"warm_step_peak"``), so ``used_frac`` says how far live memory after
    the loop sits from one step's peak. On the CPU there is no device
    reading: ``warm_peak_bytes``, the contract and both fractions are
    ``None``.

    * ``sample_cost_s`` / ``sample_overhead_frac`` — one sample,
      micro-measured, against the timed loop's average step;
    * ``pressure`` — a planted drill: a sampler with a tiny contract on a
      scratch registry and recorder dumps exactly one schema-valid
      ``mem_pressure`` bundle whose mem ring holds the samples before it;
    * ``profilez`` — one bounded capture through
      ``obs.profiling.serve_capture`` (the plain function behind the
      ``POST /profilez`` endpoint of ROADMAP A.11c) with the knob set to a
      scratch directory: status, bytes, seconds."""
    from tpu_syncbn_torch.obs import flightrec, incident as incident_mod, memwatch
    from tpu_syncbn_torch.obs import profiling, telemetry

    source = None
    if warm_peak_bytes:  # a device reading: the card's
        source = "sharding_audit" if audited_peak_bytes else "warm_step_peak"
        sampler.set_contract(int(audited_peak_bytes or warm_peak_bytes), source=source)
    log(f"memory block contract source: {source}")
    reading = sampler.sample()
    repeats = 25
    t0 = time.perf_counter()
    for _ in range(repeats):
        sampler.sample()
    sample_cost_s = (time.perf_counter() - t0) / repeats
    avg_step_s = wall_s / steps if steps else None

    drill_dir = tempfile.mkdtemp(prefix="bench_memwatch_")
    scratch = telemetry.Registry()
    rec = flightrec.FlightRecorder(registry=scratch, incident_dir=drill_dir)
    try:
        drill = memwatch.MemorySampler(registry=scratch, recorder=rec,
                                       contract_bytes_per_device=1 << 60)
        drill.sample()
        drill.sample()
        drill.set_contract(1, source="bench_drill")
        drill.sample()  # over contract: fires mem_pressure
        names = [n for n in os.listdir(drill_dir) if n.endswith(".json")]
        pressure = {"bundles": len(names), "trigger": None, "ring_mem": 0,
                    "valid": False}
        if len(names) == 1:
            bundle = incident_mod.load_bundle(os.path.join(drill_dir, names[0]))
            pressure = {"bundles": 1, "trigger": bundle["trigger"]["kind"],
                        "ring_mem": len(bundle["rings"]["mem"]),
                        "valid": (bundle["trigger"]["kind"] == "mem_pressure"
                                  and len(bundle["rings"]["mem"]) >= 3)}
    finally:
        rec.close()
        shutil.rmtree(drill_dir, ignore_errors=True)

    prof_dir = tempfile.mkdtemp(prefix="bench_profilez_")
    prev_knob = os.environ.get("TPU_SYNCBN_PROFILE_DIR")
    os.environ["TPU_SYNCBN_PROFILE_DIR"] = prof_dir
    try:
        t0 = time.perf_counter()
        status, payload = profiling.serve_capture(0.1)
        profilez = {"status": status, "bytes": payload.get("bytes"),
                    "device_events": payload.get("device_events"),
                    "roundtrip_s": round(time.perf_counter() - t0, 4)}
    finally:
        if prev_knob is None:
            os.environ.pop("TPU_SYNCBN_PROFILE_DIR", None)
        else:
            os.environ["TPU_SYNCBN_PROFILE_DIR"] = prev_knob
        shutil.rmtree(prof_dir, ignore_errors=True)
    return {
        "source": reading["source"],
        "bytes_in_use": reading["bytes_in_use"],
        "peak_bytes": reading["peak_bytes"],
        "warm_peak_bytes": warm_peak_bytes,
        "rss_bytes": reading.get("rss_bytes"),
        "cache_bytes_live": reading.get("cache_bytes_live"),
        "contract_bytes_per_device": reading.get("contract_bytes_per_device"),
        "contract_source": reading.get("contract_source"),
        "used_frac": reading.get("used_frac"),
        "headroom_frac": reading.get("headroom_frac"),
        "samples": sampler.samples,
        "sample_cost_s": round(sample_cost_s, 9),
        "sample_overhead_frac": (
            round(sample_cost_s / avg_step_s, 6) if avg_step_s else None),
        "pressure": pressure,
        "profilez": profilez,
    }


def compile_block(warm_s: float) -> dict:
    """The ``compile`` block (``bench.py``'s ``compile_block``): the run's
    compile events from the ``compile.*`` registry family — ``warmup_s``
    (the two warm-up steps: the first eager step's kernel builds and
    cuDNN's autotuning), total and per-family event counts, the
    ``compile.time_s`` histogram's totals, and the recompile-storm count
    (0 on a healthy run)."""
    from tpu_syncbn_torch.obs import telemetry

    snap = telemetry.snapshot()
    counters = snap["counters"]
    hist = snap["histograms"].get("compile.time_s") or {}
    families = {name[len("compile."):-len(".events")]: v
                for name, v in counters.items()
                if name.startswith("compile.") and name.endswith(".events")}
    return {
        "warmup_s": round(warm_s, 2),
        "events_total": counters.get("compile.events_total", 0),
        "storms": counters.get("compile.storms", 0),
        "time_s_count": hist.get("count", 0),
        "time_s_sum": round(hist.get("sum", 0.0), 4),
        "families": families,
    }


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def measure_serve(dp, batch) -> dict:
    """The ``serve`` block (``bench.py``'s ``measure_serve``, key for key):
    a closed-loop offered-load sweep against the dynamic-batching
    inference engine (``tpu_syncbn_torch.serve``) built from the bench's
    trained state, then the open-loop sweep and the two-tenant drill.

    Each closed-loop level runs ``clients`` client threads (each submits a
    single-image request, blocks on its future, repeats), so offered load
    is set by the client count. ``clients=1`` is the latency floor (every
    batch one item, p50 = engine time + admission wait);
    ``clients = 2 * max_batch`` saturates (the queue stays deeper than a
    full batch, so the batch-fill ratio must approach 1.0). The engine is
    warmed (one graph a bucket) before the sweep: ``warm_compile_s`` is
    reported apart, never inside a latency percentile. Headline fields are
    the saturating level's.

    ``open_loop`` (:func:`measure_serve_open_loop`) sweeps an open-loop
    Poisson generator from half the closed-loop capacity up, 3x a level,
    for at most 7 levels, against a deadline-enabled
    batcher: ``p99_bounded`` and ``degradation_graceful`` say whether the
    tail stayed bounded while the excess was shed. ``tenancy``
    (:func:`measure_serve_tenancy`) is the per-tenant isolation drill, and
    ``publish`` (:func:`measure_serve_publish`) the weight-swap drill. A
    section that fails reads null; the rest of the block stands."""
    import threading

    import numpy as np

    from tpu_syncbn_torch import serve as serve_lib

    x = batch[0] if isinstance(batch, (tuple, list)) else batch
    x = x.detach().float().cpu().numpy()
    gb = x.shape[0]
    # serve-side batch: capped at 16 so the client thread count (2x) and
    # request totals stay sane on any device
    max_batch = min(gb, 16)
    buckets = tuple(sorted({max(1, max_batch // 2), max_batch}))
    engine = serve_lib.InferenceEngine.from_trainer(dp, buckets=buckets)
    max_batch = engine.max_bucket
    max_wait_ms = 50.0

    t0 = time.perf_counter()
    engine.warm(x[:1])
    warm_s = time.perf_counter() - t0

    levels_out = []
    rejected_total = 0
    bat = None
    for clients in (1, 2 * max_batch):
        # fresh batcher per level: its CounterGroup is the level's
        # fill-ratio measurement
        bat = serve_lib.DynamicBatcher(
            engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue=4 * max_batch,
        )
        # the saturating level gets enough traffic that start/tail partial
        # batches cannot drag the aggregate fill below the bound
        per_client = 8 if clients > 1 else 2 * max_batch
        latencies: list[float] = []
        lat_lock = threading.Lock()

        def client(cid, batcher=bat, per_client=per_client):
            rng = np.random.RandomState(cid)
            local = []
            for _ in range(per_client):
                i = int(rng.randint(0, gb))
                t_req = time.perf_counter()
                try:
                    batcher.submit(x[i:i + 1]).result(timeout=600)
                except serve_lib.RejectedError:
                    continue  # shed — counted by the batcher
                local.append(time.perf_counter() - t_req)
            with lat_lock:
                latencies.extend(local)

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        _join_clients(threads)
        wall = time.perf_counter() - t0
        bat.close(drain=True)
        fill = bat.fill_ratio
        rejected_total += bat.counters.count("rejected")
        levels_out.append({
            "clients": clients,
            "requests": len(latencies),
            "throughput_rps": round(len(latencies) / wall, 2) if wall else None,
            "latency_p50_ms": round(float(np.percentile(latencies, 50)) * 1e3, 3),
            "latency_p99_ms": round(float(np.percentile(latencies, 99)) * 1e3, 3),
            "fill_ratio": round(fill, 4) if fill is not None else None,
        })
        log(f"serve clients={clients}: "
            f"{levels_out[-1]['throughput_rps']} req/s, "
            f"p50 {levels_out[-1]['latency_p50_ms']} ms, "
            f"p99 {levels_out[-1]['latency_p99_ms']} ms, "
            f"fill {levels_out[-1]['fill_ratio']}")
    sat = levels_out[-1]
    try:
        open_loop = measure_serve_open_loop(
            engine, x, gb=gb, max_batch=max_batch, max_wait_ms=max_wait_ms,
            capacity_rps=sat["throughput_rps"],
            closed_loop_p50_ms=sat["latency_p50_ms"],
        )
    except Exception as e:  # null only this section, keep closed-loop
        log(f"serve open-loop measurement failed: {type(e).__name__}: {e}")
        open_loop = None
    try:
        publish = measure_serve_publish(
            engine, x, gb=gb, max_batch=max_batch, max_wait_ms=max_wait_ms,
        )
    except Exception as e:  # null only this section, keep the rest
        log(f"serve publish measurement failed: {type(e).__name__}: {e}")
        publish = None
    try:
        tenancy = measure_serve_tenancy(
            engine, x, gb=gb, max_batch=max_batch, max_wait_ms=max_wait_ms,
        )
    except Exception as e:  # null only this section, keep the rest
        log(f"serve tenancy measurement failed: {type(e).__name__}: {e}")
        tenancy = None
    stats = engine.stats()
    return {
        "buckets": stats["buckets"],
        "max_batch": max_batch,
        "max_wait_ms": max_wait_ms,
        "warm_compile_s": round(warm_s, 2),
        "levels": levels_out,
        # headline = the saturating level
        "clients": sat["clients"],
        "requests": sat["requests"],
        "rejected": rejected_total,
        "throughput_rps": sat["throughput_rps"],
        "latency_p50_ms": sat["latency_p50_ms"],
        "latency_p99_ms": sat["latency_p99_ms"],
        "fill_ratio": sat["fill_ratio"],
        "buckets_compiled": stats["programs_compiled"],
        "drained": bat.drained,
        "open_loop": open_loop,
        "publish": publish,
        "tenancy": tenancy,
    }


def measure_serve_publish(engine, x, *, gb: int, max_batch: int,
                          max_wait_ms: float) -> dict:
    """The ``publish`` section of the serve block (``bench.py``'s
    ``measure_serve_publish``, key for key): the zero-downtime weight-swap
    drill (``serve.publish``) against the live warmed engine.

    Two identically loaded closed-loop runs: a baseline (no swap) and a
    swap run whose midpoint hot-swaps a same-structure new weight version
    through :class:`~tpu_syncbn_torch.serve.publish.SwapController` while
    the clients keep submitting — ``p99_during_swap_ms`` against
    ``baseline_p99_ms`` is the "zero downtime" claim as a number. The swap
    copies into the tensors the captured graphs read and keeps the
    outgoing weights as a device copy: ``double_buffer_peak_bytes`` is the
    engine's serving state with that copy held (``params_nbytes``),
    compared against the installed memwatch contract when one is pinned.
    The drill closes with a rollback (``rollback_bit_identical``: the
    restored first parameter equals its pre-swap copy bit for bit). One
    untimed swap and rollback run first: a kernel's first launch in a
    process waits for all queued work (CUDA's lazy module loading), which
    is not what a swap costs."""
    import threading

    import numpy as np

    from tpu_syncbn_torch import serve as serve_lib
    from tpu_syncbn_torch.obs import memwatch

    def run_load(clients, per_client, midpoint=None):
        """Closed-loop load; optionally fires ``midpoint()`` on this
        thread once every client has an answer. Returns (latencies,
        midpoint's result)."""
        bat = serve_lib.DynamicBatcher(
            engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue=4 * max_batch, health_name="serve_publish",
        )
        latencies: list[float] = []
        lat_lock = threading.Lock()

        def client(cid):
            rng = np.random.RandomState(cid)
            for _ in range(per_client):
                i = int(rng.randint(0, gb))
                t_req = time.perf_counter()
                try:
                    bat.submit(x[i:i + 1]).result(timeout=600)
                except serve_lib.RejectedError:
                    continue
                # per request, not at the client's exit: the midpoint
                # below watches this count to swap with requests in flight
                with lat_lock:
                    latencies.append(time.perf_counter() - t_req)

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        try:
            for th in threads:
                th.start()
            mid = None
            if midpoint is not None:
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline:
                    with lat_lock:
                        if len(latencies) >= clients:
                            break
                    time.sleep(0.005)
                mid = midpoint(bat)
            _join_clients(threads)
        finally:
            bat.close(drain=True)
        return latencies, mid

    # the new version: the same structure, one float tensor nudged —
    # numerically distinguishable, so the rollback check has teeth
    old_params = engine.param_template()
    first = next(n for n, t in old_params.items() if t.is_floating_point())
    probe_old = old_params[first].detach().cpu().clone()
    new_params = {n: t + 1e-3 if n == first else t for n, t in old_params.items()}
    rest = engine._live()[1]
    base_version = int(engine.version)
    engine.swap_params(new_params, rest, version=base_version + 1)
    engine.rollback()

    clients = max(2, max_batch)
    per_client = 8
    base_lat, _ = run_load(clients, per_client)
    baseline_p99_ms = round(float(np.percentile(base_lat, 99)) * 1e3, 3)

    def do_swap(bat):
        ctl = serve_lib.SwapController(engine, batcher=bat, health_name="publish_drill")
        try:
            return ctl.swap(new_params, rest, version=base_version + 1, source="bench")
        finally:
            ctl.close()

    swap_lat, swap_result = run_load(clients, per_client, midpoint=do_swap)
    p99_during_swap_ms = round(float(np.percentile(swap_lat, 99)) * 1e3, 3)
    log(f"serve publish: swap {swap_result['swap_s'] * 1e3:.1f} ms, "
        f"p99 during swap {p99_during_swap_ms} ms (baseline {baseline_p99_ms} ms)")

    # the double buffer: live serving state plus the retained device copy
    double_buffer = int(engine.params_nbytes())
    sampler = memwatch.get()
    contract = sampler.contract().get("bytes_per_device") if sampler is not None else None
    bounded = True if not contract else double_buffer <= contract

    t0 = time.perf_counter()
    restored = engine.rollback()
    rollback_s = time.perf_counter() - t0
    probe_restored = engine.param_template()[first].detach().cpu()
    rollback_bit_identical = bool(torch.equal(probe_old, probe_restored))
    log(f"serve publish: rollback to v{restored} {rollback_s * 1e3:.1f} ms, "
        f"bit_identical={rollback_bit_identical}")
    if restored != base_version:
        raise RuntimeError(f"rollback restored v{restored}, not v{base_version}")

    return {
        "swap_s": round(swap_result["swap_s"], 6),
        "commit_s": round(swap_result["commit_s"], 6),
        "swap_outcome": swap_result["outcome"],
        "requests_during_swap": len(swap_lat),
        "baseline_p99_ms": baseline_p99_ms,
        "p99_during_swap_ms": p99_during_swap_ms,
        "p99_ratio": round(p99_during_swap_ms / max(baseline_p99_ms, 1e-9), 4),
        "double_buffer_peak_bytes": double_buffer,
        "memwatch_contract_bytes": contract,
        "double_buffer_bounded": bounded,
        "rollback_s": round(rollback_s, 6),
        "rollback_bit_identical": rollback_bit_identical,
    }


def measure_serve_tenancy(engine, x, *, gb: int, max_batch: int,
                          max_wait_ms: float) -> dict:
    """The ``tenancy`` section of the serve block (``bench.py``'s
    ``measure_serve_tenancy``): two tenants share the warmed engine
    through separate batchers publishing ``tenant``-labeled series.
    ``aggressive`` carries an unmeetable per-request deadline (every
    admitted request becomes a ``serve.deadline_miss_total{tenant=
    "aggressive"}`` event), ``steady`` a generous one. Both get the same
    :class:`~tpu_syncbn_torch.obs.slo.SubsetRate` rule over their own
    labeled ``deadline_miss_total / requests`` pair, so the aggressive
    tenant's rule must fire while the steady tenant's stays quiet
    (``isolation_ok``), and the fired alert's bundle must carry the
    labeled series (``alert_bundle.labeled_series``)."""
    import threading

    import numpy as np

    from tpu_syncbn_torch import serve as serve_lib
    from tpu_syncbn_torch.obs import (
        flightrec, incident as incident_mod, slo as obs_slo, telemetry,
        timeseries,
    )

    deadline_ms = {"aggressive": 0.05, "steady": 60000.0}
    miss_target = 0.9  # budget 0.1: a 100% miss rate burns at 10x
    burn_threshold = 2.0
    clients, per_client = 2, 6

    agg = timeseries.WindowedAggregator(interval_s=0.25)
    agg.tick()  # baseline frame: deltas start at this run's counts
    tracker = obs_slo.SLOTracker(agg, [
        obs_slo.AlertRule(
            f"tenant_{t}",
            obs_slo.SubsetRate(
                total=telemetry.labeled_name("serve.requests", {"tenant": t}),
                bad=telemetry.labeled_name("serve.deadline_miss_total",
                                           {"tenant": t}),
                target=miss_target,
            ),
            windows_s=(60.0,), burn_threshold=burn_threshold,
        )
        for t in ("aggressive", "steady")
    ])

    # a fresh recorder sharing this aggregator catches the fired alert:
    # the bundle is the proof the labeled series travel with incidents
    bundle_dir = tempfile.mkdtemp(prefix="bench_tenancy_")
    prev_rec = flightrec.get()
    rec = flightrec.FlightRecorder(aggregator=agg, incident_dir=bundle_dir,
                                   cooldown_s=0.0)
    flightrec.install(rec)
    try:
        tenants_out = {}
        for tenant in ("aggressive", "steady"):
            bat = serve_lib.DynamicBatcher(
                engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
                max_queue=4 * max_batch, deadline_ms=deadline_ms[tenant],
                tenant=tenant,
            )

            def client(cid, batcher=bat):
                rng = np.random.RandomState(cid)
                for _ in range(per_client):
                    i = int(rng.randint(0, gb))
                    try:
                        batcher.submit(x[i:i + 1]).result(timeout=600)
                    except serve_lib.RejectedError:
                        continue  # shed/deadline-missed — counted

            threads = [threading.Thread(target=client, args=(c,), daemon=True)
                       for c in range(clients)]
            for th in threads:
                th.start()
            _join_clients(threads)
            bat.close(drain=True)
            agg.tick()  # land this tenant's deltas in a windowed frame
            requests = bat.counters.count("requests")
            misses = bat.counters.count("deadline_miss_total")
            lat = telemetry.labeled_name("serve.latency_s", {"tenant": tenant})
            p50, p99 = agg.quantile(lat, 0.5), agg.quantile(lat, 0.99)
            tenants_out[tenant] = {
                "requests": requests,
                "deadline_misses": misses,
                "miss_fraction": round(misses / requests, 4) if requests else None,
                "latency_p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
                "latency_p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
            }

        state = tracker.evaluate()
        for tenant in ("aggressive", "steady"):
            st = state[f"tenant_{tenant}"]
            burns = [b for b in st["burns"].values() if b is not None]
            tenants_out[tenant]["burn_rate"] = round(max(burns), 4) if burns else None
            tenants_out[tenant]["firing"] = bool(st["firing"])
            log(f"serve tenancy {tenant}: "
                f"{tenants_out[tenant]['deadline_misses']}/"
                f"{tenants_out[tenant]['requests']} deadline misses, "
                f"burn {tenants_out[tenant]['burn_rate']}, "
                f"firing={tenants_out[tenant]['firing']}")

        alert_bundle = None
        if rec.last_incident is not None:
            bundle = incident_mod.load_bundle(rec.last_incident["path"])
            labeled = [name for kind in ("counters", "gauges", "histograms")
                       for name in bundle["registry"].get(kind, {})
                       if "{" in name and 'tenant="' in name]
            alert_bundle = {
                "incident_id": bundle["incident_id"],
                "trigger": bundle["trigger"]["kind"],
                "labeled_series": len(labeled),
            }
    finally:
        if prev_rec is not None:
            flightrec.install(prev_rec)
        else:
            flightrec.uninstall()
        rec.close()
        agg.close()
        shutil.rmtree(bundle_dir, ignore_errors=True)

    return {
        "deadline_ms": deadline_ms,
        "miss_target": miss_target,
        "burn_threshold": burn_threshold,
        "tenants": tenants_out,
        "aggressive_burn": tenants_out["aggressive"]["burn_rate"],
        "steady_burn": tenants_out["steady"]["burn_rate"],
        "isolation_ok": bool(tenants_out["aggressive"]["firing"]
                             and not tenants_out["steady"]["firing"]),
        "alert_bundle": alert_bundle,
    }


def measure_serve_open_loop(engine, x, *, gb: int, max_batch: int,
                            max_wait_ms: float, capacity_rps: float,
                            closed_loop_p50_ms: float) -> dict:
    """The ``open_loop`` section of the serve block (``bench.py``'s
    ``measure_serve_open_loop``): an offered-load sweep past saturation.
    The per-request SLO is max(200 ms, 6 x the closed-loop p50). Offered
    load starts at half the closed-loop capacity and rises 3x a level
    until more than 5 % of a level is dropped (sheds + rejections) or 7
    levels ran; each level is a seeded Poisson schedule.
    The shed estimator reads the windowed ``serve.infer_s`` quantile (the
    batcher's own EWMA covers the first level's cold start)."""
    from tpu_syncbn_torch import serve as serve_lib
    from tpu_syncbn_torch.obs import timeseries

    slo_ms = max(200.0, 6.0 * closed_loop_p50_ms)
    rate = 0.5 * max(capacity_rps, 1.0)
    max_levels = 7
    drop_frac_target = 0.05
    agg = timeseries.WindowedAggregator(interval_s=0.25).start()
    bat = serve_lib.DynamicBatcher(
        engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
        max_queue=4 * max_batch, deadline_ms=slo_ms,
        estimator=serve_lib.LatencyEstimator(aggregator=agg),
        health_name="serve_open_loop",
    )
    try:
        gen = serve_lib.OpenLoopLoadGen(
            bat.submit, make_request=lambda i: x[i % gb:i % gb + 1],
            deadline_ms=slo_ms,
        )
        levels = []
        for li in range(max_levels):
            # bound the per-level request count so extreme escalation
            # stays a smoke, not a soak
            duration_s = max(0.25, min(1.5, 3000.0 / rate))
            report = gen.run(serve_lib.poisson_arrivals(rate, duration_s, seed=li),
                             collect_timeout_s=120.0)
            lvl = report.summary()
            lvl["p99_bounded"] = (lvl["latency_p99_ms"] is not None
                                  and lvl["latency_p99_ms"] <= slo_ms)
            levels.append(lvl)
            log(f"serve open-loop {lvl['offered_rps']} rps offered: "
                f"goodput {lvl['goodput_rps']} rps, "
                f"p99 {lvl['latency_p99_ms']} ms, "
                f"shed {lvl['shed']}, rejected {lvl['rejected']}")
            dropped_frac = (lvl["shed"] + lvl["rejected"]) / max(1, lvl["offered"])
            if li >= 1 and dropped_frac > drop_frac_target:
                break  # overload observed: sweep done
            rate *= 3.0
    finally:
        bat.close(drain=True)
        agg.close()
    top, first = levels[-1], levels[0]
    dropped = [lv["shed"] + lv["rejected"] for lv in levels]
    return {
        "slo_ms": round(slo_ms, 3),
        "deadline_ms": round(slo_ms, 3),
        "levels": levels,
        # headline = the most-overloaded level
        "offered_rps": top["offered_rps"],
        "goodput_rps": top["goodput_rps"],
        "latency_p99_ms": top["latency_p99_ms"],
        "deadline_miss_rate": top["deadline_miss_rate"],
        "shed_rate": top["shed_rate"],
        "shed": top["shed"],
        "rejected": top["rejected"],
        # the acceptance shape: tail bounded at every level, and overload
        # turned into sheds/rejections (the top level drops more than the
        # first)
        "p99_bounded": all(lv["p99_bounded"] for lv in levels),
        "sheds_rise": dropped[-1] > dropped[0],
        "degradation_graceful": (all(lv["p99_bounded"] for lv in levels)
                                 and dropped[-1] > dropped[0]
                                 and first["goodput_rps"] > 0),
    }


def measure_pipeline_bubbles(group, device: torch.device) -> dict | None:
    """The ``scan`` block's ``pipeline`` sub-block (``bench.py``'s
    ``measure_pipeline_bubbles``): bubble accounting for the pipeline
    schedules, on JAX's micro-model (a ``tanh(x @ w + b)`` stage 16 wide,
    2 rows a replica a microbatch, M = 2N) over a ``(data, pipe)`` mesh of
    every process in ``group`` (the job's world; N = 4 when it divides,
    else 2).

    For GPipe and 1F1B the measured bubble is ``1 − t_dense / t_schedule``,
    where ``t_dense`` times the same step on the zero-bubble timing
    reference (``pipeline_schedule.dense_timing_schedule``: every slot
    active, ``T = M`` ticks); predicted is the tables' ``1 − M/T``. Step
    times are the host clock over 3 steps after a warm one, ending in a
    synchronize. ``collective_calls`` is the port's tallies of one step a
    schedule (``{schedule: {op: calls}}``; the JAX block counts its
    programs' trace-time inventory): ``2·T`` ppermutes each. ``fused`` times
    one K = 2 ``train_steps_batches`` chunk, or is ``None`` where the K-step
    program cannot be built (a gloo group on CUDA tensors: only NCCL's
    collectives can be captured), with the reason logged.

    Returns ``None`` at world < 2, as JAX's does."""
    import numpy as np

    from tpu_syncbn_torch.parallel import collectives as coll
    from tpu_syncbn_torch.parallel import pipeline as pp
    from tpu_syncbn_torch.parallel import pipeline_schedule as ps

    n_chips = coll.world_size(group)
    if n_chips < 2:
        return None
    n = 4 if n_chips % 4 == 0 else 2
    d = n_chips // n
    m = 2 * n  # the M >= 2N regime the 1F1B-vs-GPipe claim is about
    feat, per_replica_mb = 16, 2

    def stage_fn(params, x):
        return torch.tanh(x @ params["w"] + params["b"])

    def loss_fn(y, t):
        return ((y - t) ** 2).mean()

    rng = np.random.default_rng(0)
    stacked = {"w": rng.standard_normal((n, feat, feat)).astype(np.float32) * 0.5,
               "b": rng.standard_normal((n, feat)).astype(np.float32)}
    gmb = per_replica_mb * d
    x = rng.standard_normal((m, gmb, feat)).astype(np.float32)
    t = rng.standard_normal((m, gmb, feat)).astype(np.float32)
    layout = pp.pipeline_mesh(n, device=device)
    di = layout.ranks.index(torch.distributed.get_rank()) // n  # this replica
    rows = slice(di * per_replica_mb, (di + 1) * per_replica_mb)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a[:, rows])).to(device)
                  for a in (x, t))
    calls = {}

    def timed_steps(schedule, reps=3):
        tr = pp.PipelineTrainer(stage_fn, loss_fn, stacked,
                                lambda params: torch.optim.SGD(params, lr=1e-2),
                                num_microbatches=m, schedule=schedule, layout=layout)
        coll.reset_tallies()
        tr.train_step(batch)  # warm
        _sync(device)
        calls[tr.schedule.name] = {op: v["calls"] for op, v in coll.tallies().items()}
        t0 = time.perf_counter()
        for _ in range(reps):
            tr.train_step(batch)
        _sync(device)
        return tr, (time.perf_counter() - t0) / reps

    _, dense_s = timed_steps(ps.dense_timing_schedule(m, n))
    schedules, fused = {}, None
    for name in ("gpipe", "1f1b"):
        sched = ps.get_schedule(name, m, n)
        tr, step_s = timed_steps(sched)
        schedules[name] = {
            "ticks": sched.ticks,
            "bubble_frac_predicted": round(sched.predicted_bubble_frac, 4),
            "bubble_frac_measured": round(max(0.0, 1.0 - dense_s / step_s), 4)
            if step_s > 0 else None,
            "step_s": round(step_s, 6),
        }
    backend = torch.distributed.get_backend()
    if device.type == "cuda" and backend != "nccl":
        log(f"pipeline: fused K-step chunk not built: a {backend} group's collectives "
            "cannot run inside a CUDA graph")
    else:
        k = 2
        chunk = tuple(b.expand(k, *b.shape).clone() for b in batch)
        tr.train_steps_batches(chunk)  # builds (captures) the program
        _sync(device)
        t0 = time.perf_counter()
        tr.train_steps_batches(chunk)
        _sync(device)
        fused = {"k": k, "dispatches": 1, "chunk_s": round(time.perf_counter() - t0, 6)}
    log(f"pipeline: {n} stages x {d} data, M={m} — bubble "
        f"gpipe {schedules['gpipe']['bubble_frac_measured']} "
        f"(predicted {schedules['gpipe']['bubble_frac_predicted']}), "
        f"1f1b {schedules['1f1b']['bubble_frac_measured']} "
        f"(predicted {schedules['1f1b']['bubble_frac_predicted']})")
    return {
        "n_stages": n,
        "data_world": d,
        "microbatches": m,
        "dense_step_s": round(dense_s, 6),
        "canonical_gpipe_bubble": round(ps.canonical_gpipe_bubble(m, n), 4),
        "schedules": schedules,
        "fused": fused,
        "collective_calls": calls,
    }


def run(device: torch.device, scan: int = 1, serve: bool = False) -> dict:
    """Build, warm up, count FLOPs, time; returns the JSON line's dict."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_syncbn_torch import models, nn, parallel, runtime
    from tpu_syncbn_torch.obs import flightrec, memwatch, numerics, stepstats, telemetry
    from tpu_syncbn_torch.obs import timeseries
    from tpu_syncbn_torch.ops import batch_norm as bn_ops
    from tpu_syncbn_torch.parallel import collectives as coll

    on_card = device.type == "cuda"
    cfg = bench_config(on_card)
    bs, steps, side = cfg["per_chip_batch"], cfg["steps"], cfg["side"]
    model = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.bfloat16, device=device,
        generator=torch.Generator().manual_seed(0)))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    dp = parallel.DataParallel(model, opt, _loss_fn, device=device)
    g = torch.Generator(device=device).manual_seed(runtime.process_index())
    batch = (torch.randn(bs, side, side, 3, device=device, generator=g),
             torch.randint(0, 1000, (bs,), device=device, generator=g))

    t0 = time.perf_counter()
    for _ in range(2):  # the first builds every kernel
        dp.train_step(batch)
    _sync(device)
    warm_s = time.perf_counter() - t0

    # the warm step's peak (the memory block's fallback contract) and its
    # collectives (the incident block's)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    coll.reset_tallies()
    with FlopCounterMode(display=False) as counter:
        dp.train_step(batch)
    flops = float(counter.get_total_flops())
    step_tallies = coll.tallies()
    warm_peak = torch.cuda.max_memory_allocated(device) if on_card else None

    # the flight recorder and the memory sampler ride the timed loop: the
    # recorder shares an aggregator anchored just before the loop and
    # ticked just after (its bundles land in a scratch directory); the
    # sampler takes a reading on each side, with its trigger off (the
    # memory block's drill fires one on its own recorder)
    agg = timeseries.WindowedAggregator()
    agg.tick()
    incident_tmp = tempfile.mkdtemp(prefix="bench_incidents_")
    recorder = flightrec.install(flightrec.FlightRecorder(
        aggregator=agg, incident_dir=incident_tmp))
    mem_sampler = memwatch.MemorySampler(pressure_threshold=None)
    mem_sampler.sample()

    # the loop's seams: a data-wait span a fetch, a step span a step, the
    # monitors published as their values land (no synchronize)
    fetch = stepstats.instrumented_batches(itertools.repeat(batch))
    publisher = numerics.NumericsPublisher()

    n_step = itertools.count(1)
    last = [None]

    def step():
        with stepstats.timed_span("step", "step.time_s"):
            out = last[0] = dp.train_step(next(fetch))
        flightrec.record_step(next(n_step), metrics={"loss": out.loss, **out.metrics},
                              monitors=out.monitors)
        publisher.publish(0, out.monitors)

    # closed after the last optimizer step: every update is in
    dt, inside = _timed_loop(device, steps, step)
    agg.tick()
    mem_sampler.sample()
    gap1, dispatch1 = _gap(dt, inside)
    scan_k = max(1, int(scan))
    scan_info = {"k": scan_k, "host_gap_frac_scan1": gap1,
                 "dispatch_frac_scan1": dispatch1, "chunks": steps,
                 "host_gap_frac": gap1, "dispatch_frac": dispatch1,
                 "img_per_sec_per_chip": round(bs * steps / dt, 2)}
    if scan_k > 1:
        chunk = tuple(t.expand(scan_k, *t.shape).clone() for t in batch)
        dp.train_steps_batches(chunk)  # builds (captures) the program
        chunks = -(-steps // scan_k)  # at least the per-step loop's steps

        def chunk_step():
            with stepstats.timed_span("scan_chunk", "step.chunk_time_s"):
                dp.train_steps_batches(chunk)

        dt_k, inside_k = _timed_loop(device, chunks, chunk_step)
        gap_k, dispatch_k = _gap(dt_k, inside_k)
        scan_info.update({"chunks": chunks, "host_gap_frac": gap_k,
                          "dispatch_frac": dispatch_k,
                          "img_per_sec_per_chip": round(bs * chunks * scan_k / dt_k, 2)})
    # pipeline-schedule bubble accounting, always measured at world > 1
    # (the micro-mesh trainers are tiny); the headline fields are 1F1B's
    # (the default schedule). A failure nulls only itself.
    try:
        pipeline_info = measure_pipeline_bubbles(
            torch.distributed.group.WORLD if torch.distributed.is_initialized() else None,
            device)
    except Exception as e:  # null the sub-block, keep the line
        log(f"pipeline bubble measurement failed: {type(e).__name__}: {e}")
        pipeline_info = None
    one_f1b = (pipeline_info or {}).get("schedules", {}).get("1f1b", {})
    scan_info.update({"pipeline": pipeline_info,
                      "bubble_frac_predicted": one_f1b.get("bubble_frac_predicted"),
                      "bubble_frac_measured": one_f1b.get("bubble_frac_measured")})
    publisher.flush()
    try:
        monitor_info = measure_monitor(agg)
        # before the incident block: its forced drift trigger is not forced
        # at the recorder, so it must land before a forced dump spends the
        # cooldown
        numerics_info = measure_numerics(publisher, last[0].monitors, steps=steps,
                                         wall_s=dt)
        # between the numerics and incident blocks, as in bench.py: it
        # zeroes the recorder's cooldown for its own bundles (restored
        # after), so it must not precede the drift trigger. An annotation:
        # a failure nulls only the block
        try:
            with stepstats.timed_span("autopilot_bench", "bench.autopilot_s"):
                autopilot_info = measure_autopilot(n_chips=runtime.process_count(),
                                                   device=device)
        except Exception as e:
            log(f"autopilot measurement failed: {type(e).__name__}: {e}")
            autopilot_info = None
        incident_info = measure_incident(recorder, last[0], steps=steps, wall_s=dt,
                                         flops_per_step=flops, tallies=step_tallies)
        # the audited peak of the benched step is the memory block's
        # contract; a failure nulls only the block (the contract falls
        # back to the warm step's peak)
        try:
            audit_info = measure_audit(dp, batch, device)
        except Exception as e:
            log(f"audit measurement failed: {type(e).__name__}: {e}")
            audit_info = None
        memory_info = measure_memory(
            mem_sampler, warm_peak_bytes=warm_peak, steps=steps, wall_s=dt,
            audited_peak_bytes=(audit_info or {}).get("sharding", {}).get(
                "peak_bytes_per_device"))
    finally:
        flightrec.uninstall()
        recorder.close()
        shutil.rmtree(incident_tmp, ignore_errors=True)
    compile_info = compile_block(warm_s)
    recovery = measure_recovery(dp)
    collectives = measure_collectives(device)
    try:
        layout_info = measure_layout() if runtime.is_master() else None
    except Exception as e:  # null the block, keep the line
        log(f"layout measurement failed: {type(e).__name__}: {e}")
        layout_info = None
    serve_info = None
    if serve:  # opt-in: it builds its own engine on the trained state
        try:
            with stepstats.timed_span("serve_bench", "bench.serve_s"):
                serve_info = measure_serve(dp, batch)
        except Exception as e:  # null the block, keep the line
            log(f"serve measurement failed: {type(e).__name__}: {e}")

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peak, peak_source = PEAK_FLOPS.get(kind, (None, None)) if on_card else (None, None)
    mfu = round(flops / (dt / steps) / peak, 4) if peak and flops else None
    use_kernels = bn_ops.get_kernel_mode() != "off" and on_card
    return {
        "metric": "resnet50_syncbn_dp_train_throughput",
        "value": round(bs * steps / dt, 2),
        "unit": "img/s/gpu",
        "backend": device.type,
        "bn_backend": "kernels" if use_kernels else "plain",
        "chips": runtime.process_count(),
        "per_chip_batch": bs,
        "image_side": side,
        "steps": steps,
        "compile_warmup_s": round(warm_s, 1),
        "mfu": mfu,
        "flops_per_step": flops,
        "flops_source": "torch-flop-counter",
        "peak_flops": peak,
        "peak_source": peak_source,
        "device_kind": kind,
        "host_load_1m": _host_load(),
        "recovery": recovery,
        "scan": scan_info,
        "collectives": collectives,
        "monitor": monitor_info,
        "numerics": numerics_info,
        "autopilot": autopilot_info,
        "incident": incident_info,
        "memory": memory_info,
        "compile": compile_info,
        "audit": audit_info,
        "layout": layout_info,
        "serve": serve_info,
        "telemetry": telemetry.snapshot(),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--scan", type=int, default=1,
                   help="also time K steps a dispatch (train_steps_batches "
                        "over K-stacked copies of the batch)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="write the run's Chrome trace (Perfetto) to PATH")
    p.add_argument("--serve", action="store_true",
                   help="also run the serving sweep on the trained state "
                        "(the serve block; null without it)")
    args = p.parse_args(argv)
    from tpu_syncbn_torch import runtime
    from tpu_syncbn_torch.obs import telemetry, tracing

    # the telemetry block is never empty: the registry records for the run
    telemetry.set_enabled(True)
    tracer = tracing.install() if args.trace else None
    device = runtime.initialize(args.device)
    line = run(device, scan=args.scan, serve=args.serve)
    if tracer is not None:
        # written before the line, so a reader of the line finds the trace
        tracing.uninstall()
        if runtime.is_master():
            tracer.save(args.trace)
    runtime.master_print(json.dumps(line))
    runtime.shutdown()
    return line


if __name__ == "__main__":
    main()
