"""The port's memory watermarks (``tpu_syncbn_torch.obs.memwatch``)
against the JAX package's (``tpu_syncbn.obs.memwatch``): the same injected
device and host readings, on the same injected clock, through each
package's ``MemorySampler`` into its own registry give equal readings,
equal ``mem.*`` gauges, equal ``mem.used_frac`` samples and one
``mem_pressure`` trip a cooldown, each with one bundle. The real readers
on the CPU: no card reading, host evidence present, and CUDA never
initialized by a sample. The allocator mapping (``memory_stats`` keys) is
checked against a stand-in here; the real readings against
``memory_allocated`` are in tests/test_torch_gpu.py.
"""

import glob
import os
import time

import pytest
import torch

from tpu_syncbn_torch.obs import flightrec, incident, memwatch, telemetry


def _jax():
    from tpu_syncbn.obs import flightrec as jfr, memwatch as jmw, telemetry as jtel

    return jfr, jmw, jtel


@pytest.fixture(autouse=True)
def clean_obs():
    jfr, jmw, jtel = _jax()

    def reset():
        for fr, mw, tel in ((flightrec, memwatch, telemetry), (jfr, jmw, jtel)):
            for mod in (fr, mw):
                inst = mod.uninstall()
                if inst is not None:
                    inst.close()
            tel.REGISTRY.reset()
            tel.set_enabled(None)

    reset()
    yield
    reset()


def _host(cap):
    return {"rss_bytes": 1_000_000, "peak_rss_bytes": 1_200_000,
            "cache_bytes_live": 3_000, "arrays_bytes": 500_000,
            "arrays_count": 7, "arrays_truncated": False}


def _host_no_census(cap):
    return {"rss_bytes": 900_000, "peak_rss_bytes": 950_000, "cache_bytes_live": 0,
            "arrays_bytes": None, "arrays_count": None, "arrays_truncated": False}


def _two_devices():
    return [{"id": 0, "bytes_in_use": 800, "peak_bytes": 900, "limit_bytes": 2_000},
            {"id": 1, "bytes_in_use": 600, "peak_bytes": 1_000, "limit_bytes": 2_000}]


READERS = {
    "host_census": (lambda: None, _host),
    "host_rss": (lambda: None, _host_no_census),
    "devices": (_two_devices, _host_no_census),
}


def _run(mw, tel, fr, readers, tmp, contracts, *, threshold=memwatch.DEFAULT_PRESSURE_THRESHOLD):
    """Samples under each contract in turn, through a private registry and
    recorder; returns (readings, snapshot, bundle paths)."""
    tel.set_enabled(True)
    reg = tel.Registry()
    rec = fr.FlightRecorder(registry=reg, incident_dir=str(tmp))
    clock = iter(range(100))
    s = mw.MemorySampler(registry=reg, device_reader=readers[0], host_reader=readers[1],
                         recorder=rec, pressure_threshold=threshold,
                         now=lambda: float(next(clock)))
    out = []
    for c in contracts:
        s.set_contract(c, source=None if c is None else "drill")
        out.append(s.sample())
    snap = reg.snapshot()
    snap["histograms"].pop("mem.sample_s")  # wall-clock timing
    return out, snap, sorted(glob.glob(os.path.join(str(tmp), "incident_*.json"))), rec


@pytest.mark.parametrize("readers", sorted(READERS))
@pytest.mark.parametrize("contracts", [(None, None), (1_000_000, 1_000_000),
                                       (10_000_000, 10_000_000, 100_000, 100_000, 100_000),
                                       (2_000, 1_000, 700, 1_000)])
def test_same_readings_give_the_same_gauges_samples_and_trips(readers, contracts, tmp_path):
    jfr, jmw, jtel = _jax()
    mine, snap, paths, rec = _run(memwatch, telemetry, flightrec, READERS[readers],
                                  tmp_path / "port", contracts)
    theirs, jsnap, jpaths, _ = _run(jmw, jtel, jfr, READERS[readers], tmp_path / "jax",
                                    contracts)
    assert mine == theirs
    assert snap == jsnap
    trips = sum(r["pressure"] for r in mine)
    assert snap["counters"].get("mem.pressure_trips", 0) == trips
    # one bundle a cooldown, whatever the number of trips in it
    assert len(paths) == len(jpaths) == (1 if trips else 0)
    if trips:
        bundle = incident.load_bundle(paths[0])
        assert bundle["trigger"]["kind"] == "mem_pressure"
        assert len(bundle["rings"]["mem"]) == next(
            i for i, r in enumerate(mine) if r["pressure"]) + 1
        assert rec.counters.count("suppressed") == trips - 1
    if contracts[0] is not None:
        assert snap["histograms"]["mem.used_frac"]["count"] == len(contracts)


def test_threshold_none_never_triggers(tmp_path):
    jfr, jmw, jtel = _jax()
    for mw, tel, fr in ((memwatch, telemetry, flightrec), (jmw, jtel, jfr)):
        readings, _, paths, _ = _run(mw, tel, fr, READERS["host_census"], tmp_path / mw.__name__,
                                     (1, 1), threshold=None)
        assert not any(r["pressure"] for r in readings) and paths == []


def test_disabled_telemetry_publishes_nothing():
    reg = telemetry.Registry()
    s = memwatch.MemorySampler(registry=reg, device_reader=lambda: None, host_reader=_host)
    assert s.sample()["bytes_in_use"] == 500_000 and len(reg) == 0


def test_real_readers_on_the_cpu_never_initialize_cuda():
    assert not torch.cuda.is_initialized()
    assert memwatch.device_readings() is None
    host = memwatch.host_readings()
    assert host["rss_bytes"] > 0 and host["arrays_count"] is None
    telemetry.set_enabled(True)
    r = memwatch.MemorySampler().sample()
    assert r["source"] == "host" and r["bytes_in_use"] > 0 and "arrays_bytes" not in r
    assert not torch.cuda.is_initialized()


def test_allocator_counters_map_to_the_reading(monkeypatch):
    """The card's reading from the allocator's nested stats (a stand-in
    dict here): bytes in use and peak are the allocated bytes, the census
    the active blocks; the limit is the device's memory, read once."""
    stats = {0: {"allocated_bytes": {"all": {"current": 4096, "peak": 8192}},
                 "active": {"all": {"current": 3}},
                 "active_bytes": {"all": {"current": 5120}}}}
    props = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda i: stats[i])

    def properties(i):
        props.append(i)
        return type("P", (), {"total_memory": 80 << 30})()

    monkeypatch.setattr(torch.cuda, "get_device_properties", properties)
    monkeypatch.setattr(memwatch, "_limits", {})
    for _ in range(2):
        assert memwatch.device_readings() == [
            {"id": 0, "bytes_in_use": 4096, "peak_bytes": 8192, "limit_bytes": 80 << 30}]
    assert props == [0]
    host = memwatch.host_readings(0)
    assert (host["arrays_count"], host["arrays_bytes"]) == (3, 5120)


def test_bad_contract_and_interval_are_rejected():
    with pytest.raises(ValueError):
        memwatch.MemorySampler(contract_bytes_per_device=0)
    with pytest.raises(ValueError):
        memwatch.MemorySampler(interval_s=0)
    with pytest.raises(ValueError):
        memwatch.MemorySampler().set_contract(0)


def test_env_gate_and_the_background_thread(monkeypatch):
    monkeypatch.delenv("TPU_SYNCBN_MEMWATCH", raising=False)
    assert memwatch.install_from_env() is None
    monkeypatch.setenv("TPU_SYNCBN_MEMWATCH", "1")
    monkeypatch.setenv("TPU_SYNCBN_MEMWATCH_INTERVAL_S", "0.01")
    s = memwatch.install_from_env()
    assert s.interval_s == 0.01 and memwatch.install_from_env() is s
    deadline = time.monotonic() + 5.0
    while s.samples < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    s.close()
    assert s.samples >= 2 and not torch.cuda.is_initialized()


def test_every_sample_feeds_the_installed_recorders_mem_ring(tmp_path):
    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path)))
    s = memwatch.MemorySampler(device_reader=_two_devices, host_reader=_host_no_census)
    s.sample()
    s.sample()
    ring = rec.rings_snapshot()["mem"]
    assert len(ring) == 2 and ring[0]["source"] == "device" and ring[0]["bytes_in_use"] == 800


def test_mem_exports_merge_through_both_packages(tmp_path):
    jtel = _jax()[2]
    telemetry.set_enabled(True)
    paths = []
    for host, used in enumerate((400_000, 700_000)):
        reg = telemetry.Registry()
        memwatch.MemorySampler(
            registry=reg, device_reader=lambda: None,
            host_reader=lambda cap, used=used: {**_host(cap), "arrays_bytes": used},
            contract_bytes_per_device=1_000_000).sample()
        paths.append(reg.export_jsonl(str(tmp_path / f"h{host}.jsonl"), host=host))
    merged = telemetry.merge_exports(paths)
    assert merged == jtel.merge_exports(paths)
    assert merged["counters"]["mem.samples"] == 2
    assert merged["gauges"]["mem.device.bytes_in_use"] == 700_000
    assert merged["histograms"]["mem.used_frac"]["count"] == 2
