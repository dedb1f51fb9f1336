"""``python -m tpu_syncbn_torch.bench --device cpu``: the port's headline
bench runs its small CPU config (here cut further by the
``BENCH_*`` overrides it honours) and prints one JSON line with every key
of its contract, ``mfu`` null (no peak on the CPU), FLOPs from
``torch.utils.flop_counter``, the ``monitor``, ``numerics``, ``incident``,
``memory`` and ``compile`` blocks (a port-0 server's scrape and probes on
the loop's window, the publisher's samples and one forced
``numerics_drift`` bundle, a forced bundle that validates, the host's
reading with no device contract, one planted ``mem_pressure`` bundle, a
profiler capture through ``serve_capture``, the first step's compile
event), and the
``telemetry`` block checked against the registry schema
(``obs.telemetry.validate_snapshot``), and ``serve`` null without
``--serve``; ``--trace`` writes a Chrome trace that validates. The serve
block's schema is held in process (``measure_serve`` on a narrow net). Numbers from this run are CPU numbers and are checked for
shape only."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "backend", "bn_backend", "chips",
        "per_chip_batch", "image_side", "steps", "compile_warmup_s", "mfu",
        "flops_per_step", "flops_source", "peak_flops", "peak_source",
        "device_kind", "host_load_1m", "recovery", "scan", "collectives",
        "monitor", "numerics", "incident", "memory", "compile", "serve", "telemetry"}
RECOVERY_KEYS = {"ckpt_roundtrip_s", "ckpt_roundtrip_seed_s", "manifest_overhead_s",
                 "manifest_overhead_frac", "ckpt_async_enqueue_s", "ckpt_async_flush_s",
                 "async_manifest_verified", "resume_after_kill_s",
                 "resumed_step_after_kill", "ckpt_bytes"}
SCAN_KEYS = {"k", "host_gap_frac_scan1", "dispatch_frac_scan1", "chunks",
             "host_gap_frac", "dispatch_frac", "img_per_sec_per_chip", "pipeline",
             "bubble_frac_predicted", "bubble_frac_measured"}
COLLECTIVES_KEYS = {"payload_mb_per_chip", "world", "modes", "golden_ratio", "measure_s"}
MODE_KEYS = {"wire_bytes", "ms", "gbytes_per_s", "compression_ratio"}
INCIDENT_KEYS = {"dump_s", "bundle_bytes", "incident_id", "trigger", "ring_steps",
                 "ring_seconds", "trace_events", "record_step_cost_s",
                 "record_overhead_frac", "attribution"}
MEMORY_KEYS = {"source", "bytes_in_use", "peak_bytes", "warm_peak_bytes", "rss_bytes",
               "cache_bytes_live", "contract_bytes_per_device", "contract_source",
               "used_frac", "headroom_frac", "samples", "sample_cost_s",
               "sample_overhead_frac", "pressure", "profilez"}
MONITOR_KEYS = {"port", "metrics_fetch_s", "exposition_bytes", "series", "healthz_ok",
                "readyz_ok", "windowed_steps", "cumulative_steps", "window_agreement",
                "steps_per_s_windowed", "step_p99_s_windowed", "slo_burn_rate",
                "slo_firing"}
NUMERICS_KEYS = {"monitors", "samples", "published", "record_step_cost_s",
                 "record_overhead_frac", "drift", "rules"}
COMPILE_KEYS = {"warmup_s", "events_total", "storms", "time_s_count", "time_s_sum",
                "families"}
SERVE_KEYS = {"buckets", "max_batch", "max_wait_ms", "warm_compile_s", "levels", "clients",
              "requests", "rejected", "throughput_rps", "latency_p50_ms", "latency_p99_ms",
              "fill_ratio", "buckets_compiled", "drained", "open_loop", "publish", "tenancy"}
PUBLISH_KEYS = {"swap_s", "commit_s", "swap_outcome", "requests_during_swap",
                "baseline_p99_ms", "p99_during_swap_ms", "p99_ratio",
                "double_buffer_peak_bytes", "memwatch_contract_bytes",
                "double_buffer_bounded", "rollback_s", "rollback_bit_identical"}
SERVE_LEVEL_KEYS = {"clients", "requests", "throughput_rps", "latency_p50_ms",
                    "latency_p99_ms", "fill_ratio"}
OPEN_LOOP_KEYS = {"slo_ms", "deadline_ms", "levels", "offered_rps", "goodput_rps",
                  "latency_p99_ms", "deadline_miss_rate", "shed_rate", "shed", "rejected",
                  "p99_bounded", "sheds_rise", "degradation_graceful"}
OPEN_LEVEL_KEYS = {"offered", "offered_rps", "duration_s", "answered", "goodput_rps",
                   "latency_p50_ms", "latency_p99_ms", "deadline_miss_rate", "shed_rate",
                   "reject_rate", "late", "shed", "rejected", "errored", "lost", "p99_bounded"}
TENANCY_KEYS = {"deadline_ms", "miss_target", "burn_threshold", "tenants", "aggressive_burn",
                "steady_burn", "isolation_ok", "alert_bundle"}
TENANT_KEYS = {"requests", "deadline_misses", "miss_fraction", "latency_p50_ms",
               "latency_p99_ms", "burn_rate", "firing"}


def test_bench_on_the_cpu_prints_its_line():
    env = dict(os.environ, PYTHONPATH=ROOT, BENCH_PER_CHIP_BATCH="2",
               BENCH_STEPS="2", BENCH_IMAGE_SIDE="32")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "tpu_syncbn_torch.bench",
                        "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(line) == KEYS
    assert line["metric"] == "resnet50_syncbn_dp_train_throughput"
    assert line["mfu"] is None and line["peak_flops"] is None
    assert line["backend"] == "cpu" and line["bn_backend"] == "plain"
    assert (line["per_chip_batch"], line["steps"], line["image_side"]) == (2, 2, 32)
    assert line["chips"] == 1 and line["value"] > 0
    assert line["flops_source"] == "torch-flop-counter"
    # ResNet-50 at 32²: ~0.17 GFLOP an image forward, x3 with the
    # backward, for 2 images (convolutions and the classifier only)
    assert 0.8e9 < line["flops_per_step"] < 1.3e9
    # the recovery block (bench.py's): a killed newest write falls back to
    # step 1, and the async write certifies
    rec = line["recovery"]
    assert set(rec) == RECOVERY_KEYS
    assert rec["resumed_step_after_kill"] == 1 and rec["async_manifest_verified"]
    assert rec["ckpt_bytes"] > 0
    assert set(line["scan"]) == SCAN_KEYS and line["scan"]["k"] == 1
    assert line["scan"]["chunks"] == 2
    # the pipeline sub-block needs two processes (bench.py's: None at world 1)
    assert line["scan"]["pipeline"] is None
    assert line["scan"]["bubble_frac_predicted"] is None
    assert line["scan"]["bubble_frac_measured"] is None
    check_collectives_block(line["collectives"], world=1)
    check_obs_blocks(line, steps=2)
    check_telemetry_block(line["telemetry"], steps=2)
    assert line["serve"] is None  # without --serve


def check_obs_blocks(line, steps):
    """The flight recorder rode the timed loop (its ring holds the steps)
    and its forced bundle validated; on the CPU the memory block has the
    host's reading and no device contract, its drill one ``mem_pressure``
    bundle, its capture a 200; the first eager step is the one compile
    event (family ``train``) and no storm. The monitor block scraped a
    port-0 server over the loop's window (every timed step in it), and the
    numerics block's forced drift gave one valid bundle."""
    mon = line["monitor"]
    assert set(mon) == MONITOR_KEYS
    assert mon["port"] > 0 and mon["exposition_bytes"] > 0 and mon["series"] > 0
    assert mon["metrics_fetch_s"] > 0 and mon["healthz_ok"] and mon["readyz_ok"]
    assert mon["windowed_steps"] == mon["cumulative_steps"] == steps
    assert mon["window_agreement"] == 1.0 and mon["steps_per_s_windowed"] > 0
    assert mon["slo_burn_rate"] == 0.0 and mon["slo_firing"] is False
    num = line["numerics"]
    assert set(num) == NUMERICS_KEYS
    assert num["published"] == steps and num["samples"] == steps + 1
    assert set(num["monitors"]) == {"bn_mean_skew", "bn_var_skew", "replica_grad_norm",
                                    "replica_grad_norm_disp"}
    assert num["record_step_cost_s"] > 0 and 0 < num["record_overhead_frac"] < 1
    assert num["drift"] == {"bundles": 1, "trigger": "numerics_drift",
                            "ring_steps": steps, "valid": True}
    assert num["rules"] == ["numerics_residual", "numerics_skew", "numerics_clip"]
    inc = line["incident"]
    assert set(inc) == INCIDENT_KEYS
    assert inc["trigger"] == "manual" and inc["bundle_bytes"] > 0
    assert inc["ring_steps"] == steps and inc["dump_s"] > 0
    assert 0 < inc["record_step_cost_s"] and 0 < inc["record_overhead_frac"] < 1
    attr = inc["attribution"]
    assert attr["steps"] == steps and abs(attr["share_sum"] - 1.0) < 1e-5
    mem = line["memory"]
    assert set(mem) == MEMORY_KEYS
    assert mem["source"] == "host" and mem["bytes_in_use"] > 0
    assert mem["warm_peak_bytes"] is None and mem["contract_bytes_per_device"] is None
    assert mem["used_frac"] is None and mem["headroom_frac"] is None
    assert mem["samples"] >= 2 + 1 + 25 and mem["sample_cost_s"] > 0
    assert mem["pressure"] == {"bundles": 1, "trigger": "mem_pressure", "ring_mem": 3,
                               "valid": True}
    assert mem["profilez"]["status"] == 200 and mem["profilez"]["bytes"] > 0
    comp = line["compile"]
    assert set(comp) == COMPILE_KEYS
    assert comp["families"] == {"train": 1} and comp["events_total"] == 1
    assert comp["storms"] == 0 and comp["time_s_count"] == 1


def check_telemetry_block(block, steps):
    """The registry snapshot: schema 1, the timed loop's step and data-wait
    histograms (one sample a timed step), the recovery block's checkpoint
    timings, the numerics monitors published once a timed step (and the
    numerics block's one forced drift sample)."""
    from tpu_syncbn_torch.obs import telemetry

    telemetry.validate_snapshot(block)
    hists = block["histograms"]
    assert hists["step.time_s"]["count"] == steps
    assert hists["step.data_wait_s"]["count"] == steps
    assert hists["checkpoint.save_s"]["count"] >= 1
    assert hists["checkpoint.load_s"]["count"] >= 1
    assert block["counters"]["numerics.samples"] == steps + 1
    assert hists["numerics.replica_grad_norm"]["count"] == steps


def check_collectives_block(block, world):
    """The ``collectives`` block at world 1: 1 MiB of f32 a GPU (262,144
    elements, 1,024 chunks of 256); fp32 4 B an element, bf16 2, int8 1 +
    8 B of range a chunk; shuffle-sharding sends nothing at world 1."""
    assert set(block) == COLLECTIVES_KEYS
    assert block["world"] == world and block["payload_mb_per_chip"] == 1.0
    assert block["golden_ratio"] == {"bf16": None, "int8": None}
    modes = block["modes"]
    assert set(modes) == {"fp32", "bf16", "int8", "shuffle_sharded"}
    for m in modes.values():
        assert set(m) == MODE_KEYS and m["ms"] >= 0
    n = 262_144
    assert [modes[k]["wire_bytes"] for k in ("fp32", "bf16", "int8")] == [
        4 * n, 2 * n, n + 8 * 1024]
    assert modes["fp32"]["compression_ratio"] == 1.0
    assert modes["bf16"]["compression_ratio"] == 2.0
    assert modes["int8"]["compression_ratio"] == 3.879
    assert modes["shuffle_sharded"]["wire_bytes"] == 0
    assert modes["shuffle_sharded"]["compression_ratio"] is None


def test_bench_scan_block_on_the_cpu(tmp_path):
    """``--scan 2``: the same batch through ``train_steps_batches`` on
    2-stacked copies, ceil(steps / 2) chunks: 3 steps time 2 chunks, at
    least as many steps as the per-step loop. With ``--trace`` the run's
    Chrome trace holds the loop's spans and validates."""
    from tpu_syncbn_torch.obs import tracing

    env = dict(os.environ, PYTHONPATH=ROOT, BENCH_PER_CHIP_BATCH="2",
               BENCH_STEPS="3", BENCH_IMAGE_SIDE="32")
    env.pop("XLA_FLAGS", None)
    trace = str(tmp_path / "bench_trace.json")
    r = subprocess.run([sys.executable, "-m", "tpu_syncbn_torch.bench",
                        "--device", "cpu", "--scan", "2", "--trace", trace],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    events = tracing.validate_trace(tracing.load_trace(trace))
    names = {e["name"] for e in events}
    assert {"data_wait", "step", "scan_chunk", "checkpoint_save",
            "checkpoint_load"} <= names
    scan = json.loads(r.stdout.strip().splitlines()[-1])["scan"]
    assert set(scan) == SCAN_KEYS
    assert scan["k"] == 2 and scan["chunks"] == 2
    for k in ("host_gap_frac", "dispatch_frac", "host_gap_frac_scan1",
              "dispatch_frac_scan1"):
        assert 0.0 <= scan[k] <= 1.0, k
    assert scan["img_per_sec_per_chip"] > 0


def test_measure_serve_block_schema_on_the_cpu():
    """``measure_serve`` in process on a narrow ResNet-18 (8² images,
    global batch 16): ``bench.py``'s serve block key for key — buckets
    (8, 16), closed-loop levels at 1 and 32 clients with the saturating
    fill >= 0.9 (JAX's acceptance bound), two programs built, the
    open-loop sweep's levels every request accounted for and offered load
    rising past the first level, the tenancy drill's aggressive tenant
    firing while the steady one stays quiet, and ``publish`` with JAX's
    keys: a swap under load, its rollback bit for bit, no program rebuilt.
    Times are CPU times: shapes only."""
    import numpy as np
    import torch

    from tpu_syncbn_torch import bench, models, nn, parallel
    from tpu_syncbn_torch.obs import telemetry

    telemetry.set_enabled(True)
    try:
        model = nn.convert_sync_batchnorm(models.resnet18(
            num_classes=10, small_input=True, width=8, device="cpu"))
        dp = parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                   bench._loss_fn, device="cpu")
        g = torch.Generator().manual_seed(0)
        batch = (torch.randn(16, 8, 8, 3, generator=g), torch.randint(0, 10, (16,), generator=g))
        dp.train_step(batch)
        block = bench.measure_serve(dp, batch)
    finally:
        telemetry.set_enabled(None)
        telemetry.REGISTRY.reset()
    assert set(block) == SERVE_KEYS
    assert block["buckets"] == [8, 16] and block["max_batch"] == 16
    assert block["max_wait_ms"] == 50.0 and block["buckets_compiled"] == 2
    assert [lv["clients"] for lv in block["levels"]] == [1, 32]
    for lv in block["levels"]:
        assert set(lv) == SERVE_LEVEL_KEYS and lv["requests"] >= 1
        assert lv["throughput_rps"] > 0 and 0 < lv["latency_p50_ms"] <= lv["latency_p99_ms"]
    assert block["requests"] == 256 and block["fill_ratio"] >= 0.9
    assert block["drained"] is True
    pub = block["publish"]
    assert set(pub) == PUBLISH_KEYS and pub["swap_outcome"] == "swapped"
    assert pub["rollback_bit_identical"] is True and pub["requests_during_swap"] >= 1
    assert pub["swap_s"] >= pub["commit_s"] > 0 and pub["rollback_s"] > 0
    assert pub["double_buffer_peak_bytes"] > 0 and pub["double_buffer_bounded"] is True
    assert pub["memwatch_contract_bytes"] is None
    ol = block["open_loop"]
    assert set(ol) == OPEN_LOOP_KEYS and ol["slo_ms"] >= 200.0
    assert 2 <= len(ol["levels"]) <= 7
    for lv in ol["levels"]:
        assert set(lv) == OPEN_LEVEL_KEYS and lv["lost"] == 0
        assert (lv["answered"] + lv["late"] + lv["shed"] + lv["rejected"] + lv["errored"]
                == lv["offered"])
    assert ol["levels"][-1]["offered_rps"] > 2 * ol["levels"][0]["offered_rps"]
    assert all(isinstance(ol[k], bool) for k in ("p99_bounded", "sheds_rise",
                                                  "degradation_graceful"))
    ten = block["tenancy"]
    assert set(ten) == TENANCY_KEYS and set(ten["tenants"]) == {"aggressive", "steady"}
    for t in ten["tenants"].values():
        assert set(t) == TENANT_KEYS and t["requests"] >= 1
    assert ten["aggressive_burn"] > ten["burn_threshold"] >= ten["steady_burn"]
    assert ten["isolation_ok"] is True
    assert ten["alert_bundle"]["trigger"] == "slo_alert"
    assert ten["alert_bundle"]["labeled_series"] >= 1
    assert np.isfinite(block["throughput_rps"])


def test_bench_config_defaults_and_overrides(monkeypatch):
    from tpu_syncbn_torch import bench

    for k in ("BENCH_PER_CHIP_BATCH", "BENCH_STEPS", "BENCH_IMAGE_SIDE"):
        monkeypatch.delenv(k, raising=False)
    assert bench.bench_config(True) == {"per_chip_batch": 64, "steps": 10, "side": 224}
    assert bench.bench_config(False) == {"per_chip_batch": 8, "steps": 20, "side": 64}
    monkeypatch.setenv("BENCH_STEPS", "3")
    assert bench.bench_config(True)["steps"] == 3
    assert bench.PEAK_FLOPS["NVIDIA H100 80GB HBM3"][0] == 989.4e12
