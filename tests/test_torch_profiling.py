"""The port's compile events and profiler capture
(``tpu_syncbn_torch.obs.profiling``) against the JAX package's
(``tpu_syncbn.obs.profiling``):

* ``RecompileDetector`` fed the same ``(family, program, t)`` sequence on
  an injected clock gives the same storm counts at the same events;
* the compile seams: ``cached_program`` notes one event a miss and none a
  hit (both cache branches); the trainers' first eager dispatch notes one
  ``compile.train`` / ``compile.gan`` event and later steps none;
* ``capture`` on the CPU writes a Chrome trace directory that loads, an
  over-budget capture is deleted, a concurrent second capture raises
  ``ProfilerBusy``; ``serve_capture``'s answers; ``profiler_trace`` and
  its deprecated ``utils`` alias; the ImageNet example's ``--profile-dir``.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest

from tpu_syncbn_torch.obs import flightrec, profiling, telemetry
from tpu_syncbn_torch.parallel import scan_driver


def _jax():
    from tpu_syncbn.obs import flightrec as jfr, profiling as jprof, telemetry as jtel

    return jfr, jprof, jtel


@pytest.fixture(autouse=True)
def clean_obs():
    jfr, jprof, jtel = _jax()

    def reset():
        for fr, prof, tel in ((flightrec, profiling, telemetry), (jfr, jprof, jtel)):
            rec = fr.uninstall()
            if rec is not None:
                rec.close()
            prof.set_detector(None)
            tel.REGISTRY.reset()
            tel.set_enabled(None)

    reset()
    for tel in (telemetry, jtel):
        tel.set_enabled(True)
    yield
    reset()


# -- the storm detector ----------------------------------------------------------


def _sequence(seed, n=60):
    """``(family, program, t)`` events: a few families and programs, bursts
    and gaps, on a monotonic clock."""
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.choice([0.5, 2.0, 15.0, 70.0], p=[0.5, 0.3, 0.15, 0.05]))
        out.append((str(rng.choice(["train", "GAN.fused", "program"])),
                    None if rng.rand() < 0.2 else f"{rng.randint(3):08x}", t))
    return out


def _detect(prof, events, window_s, threshold, tmp):
    clock = [0.0]
    fired = []

    class Rec:  # the recorder's trigger, counted
        def trigger(self, kind, detail):
            fired.append((kind, detail))

    det = prof.RecompileDetector(window_s=window_s, threshold=threshold,
                                 recorder=Rec(), now=lambda: clock[0])
    steps = []
    for i, (family, program, t) in enumerate(events):
        clock[0] = t
        if det.note(family, program):
            steps.append(i)
    return steps, dict(det.storms), fired


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("window_s,threshold", [(60.0, 5), (10.0, 2), (30.0, 3)])
def test_recompile_detector_equals_jax(seed, window_s, threshold, tmp_path):
    _, jprof, _ = _jax()
    events = _sequence(seed)
    mine = _detect(profiling, events, window_s, threshold, tmp_path)
    assert mine == _detect(jprof, events, window_s, threshold, tmp_path)
    assert [k for k, _ in mine[2]] == ["recompile_storm"] * len(mine[0])


def test_the_detector_bounds_its_keys_and_validates():
    det = profiling.RecompileDetector(window_s=1.0, threshold=2, now=lambda: 0.0)
    for i in range(profiling.MAX_TRACKED_PROGRAMS + 50):
        det.note("f", str(i))
    assert len(det._events) <= profiling.MAX_TRACKED_PROGRAMS
    with pytest.raises(ValueError):
        profiling.RecompileDetector(threshold=1)
    with pytest.raises(ValueError):
        profiling.RecompileDetector(window_s=0)
    assert profiling._family_token("GAN.Fused!") == "gan_fused"


def test_detector_reads_its_env_knobs(monkeypatch):
    monkeypatch.setenv("TPU_SYNCBN_RECOMPILE_WINDOW_S", "12.5")
    monkeypatch.setenv("TPU_SYNCBN_RECOMPILE_THRESHOLD", "nonsense")
    det = profiling.detector()
    assert (det.window_s, det.threshold) == (12.5, profiling.DEFAULT_STORM_THRESHOLD)
    assert profiling.detector() is det and profiling.set_detector(None) is det


# -- the compile seams -----------------------------------------------------------


def _counters():
    return telemetry.snapshot()["counters"]


@pytest.mark.parametrize("plain_dict", [False, True])
def test_cached_program_notes_a_miss_and_not_a_hit(plain_dict, tmp_path):
    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path)))
    cache = {} if plain_dict else scan_driver.ProgramCache(name="train")
    family = "program" if plain_dict else "train"
    built = []
    for key in ("a", "a", "b", "a"):
        scan_driver.cached_program(cache, key, lambda: built.append(1) or object())
    assert len(built) == 2
    c = _counters()
    assert c["compile.events_total"] == 2 and c[f"compile.{family}.events"] == 2
    assert telemetry.snapshot()["histograms"]["compile.time_s"]["count"] == 2
    ring = rec.rings_snapshot()["compile"]
    assert [e["family"] for e in ring] == [family, family]
    assert all("seconds" in e and e["program"] for e in ring)
    assert c.get("compile.storms", 0) == 0


def test_distinct_keys_are_no_storm_and_churn_is_one(tmp_path):
    rec = flightrec.install(flightrec.FlightRecorder(incident_dir=str(tmp_path)))
    profiling.set_detector(profiling.RecompileDetector(window_s=3600.0, threshold=4))
    warm = scan_driver.ProgramCache(name="train", max_entries=16)
    for key in range(8):
        scan_driver.cached_program(warm, key, lambda: object())
    assert glob.glob(os.path.join(str(tmp_path), "*.json")) == []
    churn = scan_driver.ProgramCache(name="gan", max_entries=2)
    for i in range(10):
        scan_driver.cached_program(churn, i % 3, lambda: object())
    assert len(glob.glob(os.path.join(str(tmp_path), "incident_*.json"))) == 1
    assert _counters()["compile.storms"] == 1


def test_first_eager_dispatch_is_one_compile_event():
    from test_torch_gan_trainer import host_data, port_trainer
    from test_torch_resilience import build_dp, make_batches

    dp = build_dp()
    for b in make_batches(3):
        dp.train_step(b)
    tr = port_trainer("dcgan")
    for batch in host_data(2):
        tr.train_step(*batch)
    c = _counters()
    assert c["compile.train.events"] == 1 and c["compile.gan.events"] == 1
    assert c["compile.events_total"] == 2


# -- the profiler capture --------------------------------------------------------


def test_capture_writes_a_chrome_trace_that_loads(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_SYNCBN_PROFILE_MAX_S", "0.05")
    out = profiling.capture(999.0, log_dir=str(tmp_path))
    assert out["ok"] and out["duration_s"] == 0.05 and out["bytes"] > 0
    assert os.path.basename(out["path"]).startswith("capture_")
    with open(os.path.join(out["path"], "trace.json")) as f:
        assert isinstance(json.load(f)["traceEvents"], list)
    again = profiling.capture(0.01, log_dir=str(tmp_path))
    assert again["path"] != out["path"]
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (out["path"], again["path"]))
    assert _counters()["obs.profilez.captures"] == 2


def test_an_over_budget_capture_is_deleted(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_SYNCBN_PROFILE_MAX_BYTES", "1")
    with pytest.raises(ValueError, match="cap"):
        profiling.capture(0.01, log_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_a_second_concurrent_capture_is_busy(tmp_path):
    first, started = {}, threading.Event()
    real_sleep = time.sleep

    def run():
        started.set()
        first["out"] = profiling.capture(0.3, log_dir=str(tmp_path))

    t = threading.Thread(target=run)
    t.start()
    started.wait()
    deadline = time.monotonic() + 5.0
    while not profiling._capture_lock.locked() and time.monotonic() < deadline:
        real_sleep(0.005)
    with pytest.raises(profiling.ProfilerBusy):
        profiling.capture(0.01, log_dir=str(tmp_path))
    with pytest.raises(profiling.ProfilerBusy):
        with profiling.profiler_trace(str(tmp_path / "lib")):
            pass
    t.join()
    assert first["out"]["ok"]


def test_a_cuda_capture_off_the_main_thread_is_refused(tmp_path, monkeypatch):
    """Kineto's CUDA side starts only on the thread that registered it:
    with CUDA initialized (stand-ins here), a capture from another thread
    raises at once instead of starting the profiler there."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    got = {}

    def run():
        try:
            profiling.capture(0.01, log_dir=str(tmp_path))
        except profiling.ProfilerUnavailable as e:
            got["error"] = str(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "main thread" in got["error"]
    assert not profiling._capture_lock.locked() and os.listdir(tmp_path) == []


def test_without_a_directory_and_serve_capture(monkeypatch, tmp_path):
    monkeypatch.delenv("TPU_SYNCBN_PROFILE_DIR", raising=False)
    with pytest.raises(profiling.ProfilerUnavailable):
        profiling.capture(0.01)
    assert profiling.serve_capture()[0] == 503
    monkeypatch.setenv("TPU_SYNCBN_PROFILE_DIR", str(tmp_path))
    status, body = profiling.serve_capture(0.01)
    assert status == 200 and body["ok"] and os.path.isdir(body["path"])
    monkeypatch.setenv("TPU_SYNCBN_PROFILE_MAX_BYTES", "1")
    assert profiling.serve_capture(0.01)[0] == 500


def test_profiler_trace_and_its_deprecated_alias(tmp_path):
    import torch

    from tpu_syncbn_torch import utils

    with pytest.warns(DeprecationWarning, match="obs.profiling"):
        cm = utils.profiler_trace(str(tmp_path / "off"), enabled=False)
    with cm:
        pass
    assert not os.path.exists(tmp_path / "off")
    with profiling.profiler_trace(str(tmp_path / "on")):
        torch.ones(8).add_(1)
    (path,) = glob.glob(str(tmp_path / "on" / "trace_h0_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::add_" in names


def test_the_imagenet_example_takes_profile_dir():
    from tpu_syncbn_torch import imagenet_resnet50 as ex

    assert ex.parse_args(["--profile-dir", "/x"]).profile_dir == "/x"
    assert ex.parse_args([]).profile_dir is None
