"""The port's autopilot (``tpu_syncbn_torch.runtime.autopilot``) against
tests/test_autopilot.py case for case, the autopilot classes of
tests/test_planner.py (``TestAutopilotMKnob``, ``TestAutopilotLayoutKnob``
but its ranked-plans case, ``TestPlanChangeObservability``), one decision
parity test against the JAX controller, and the ``ResilientLoop`` wiring.

Everything runs under injected clocks and manually ticked windowed
aggregators, so every transition — escalation on planted drift within one
window, cooldowns, the sustained-healthy hysteresis, clamps at the
candidate set's edge, suppression during divergence recovery — replays
deterministically. Not mirrored here: JAX's ``TestStandardRules`` cases on
``slo.standard_rules`` itself (``test_torch_slo.py`` holds the port's
against JAX field by field) and ``TestSetCompress``
(``test_torch_compressed_training.py::test_set_compress_parks_and_recalls_caches``).

The parity test drives JAX's ``Autopilot`` and the port's through the
same planted series (numerics and memory burns, host gap with headroom,
bubble gauges, step times, a divergence suppression) on the same clock,
each into its own package's registry and recorder: the decision lists,
``state()`` and the ``autopilot.*`` gauges and counters must be equal.
"""

import glob
import itertools
import os
import types

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import nn, parallel
from tpu_syncbn_torch.obs import (
    flightrec,
    incident,
    memwatch,
    numerics as obs_numerics,
    server as obs_server,
    telemetry,
    timeseries,
    tracing,
)
from tpu_syncbn_torch.parallel import scan_driver
from tpu_syncbn_torch.runtime import autopilot as autopilot_mod
from tpu_syncbn_torch.runtime import resilience
from tpu_syncbn_torch.runtime.autopilot import (
    COMPRESS_LADDER,
    DEFAULT_RULE_FAMILIES,
    Autopilot,
    chunked_batches,
)
from tpu_syncbn_torch.testing import faults

NET = dict(rtol=2e-4, atol=1e-5)


def _reset(obs, enabled):
    obs.telemetry.set_enabled(enabled)
    obs.telemetry.REGISTRY.reset()
    rec = obs.flightrec.uninstall()
    if rec is not None:
        rec.close()
    obs.tracing.uninstall()
    obs.server.HEARTBEATS.clear()


_PORT_OBS = types.SimpleNamespace(telemetry=telemetry, flightrec=flightrec,
                                  tracing=tracing, server=obs_server)


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Every test starts and ends with telemetry on, an empty registry, no
    recorder, no tracer and no heartbeats."""
    _reset(_PORT_OBS, True)
    yield
    _reset(_PORT_OBS, None)


class StubTrainer:
    """The DataParallel knob surface the compression actuator needs."""

    def __init__(self, compress="int8"):
        self.compress = compress
        self.program_caches = ()
        self.switches = []

    def set_compress(self, mode):
        self.switches.append(mode)
        self.compress = mode
        return True


def plant_numerics_burn(agg, *, t0=0.0, t1=5.0, n=20, tel=telemetry):
    """Frames carrying an EF residual ratio far over the 0.5 SLO:
    ``numerics_residual`` burns ~100x budget in every window with data."""
    agg.tick(now=t0)
    for _ in range(n):
        tel.observe("numerics.ef_residual_ratio", 0.9, buckets=(0.1, 0.5, 1.0))
    agg.tick(now=t1)


def plant_mem_burn(agg, *, t0=0.0, t1=5.0, n=20, tel=telemetry):
    """Frames with used_frac over the 0.9 pressure SLO."""
    agg.tick(now=t0)
    for _ in range(n):
        tel.observe("mem.used_frac", 0.95, buckets=(0.5, 0.9, 1.0))
    agg.tick(now=t1)


def plant_bubble(agg, frac, *, t0=0.0, t1=5.0, dispatch=None):
    agg.tick(now=t0)
    telemetry.set_gauge("pipeline.bubble_frac", frac)
    if dispatch is not None:
        telemetry.observe(incident._DISPATCH_HISTS[0], dispatch)
    agg.tick(now=t1)


def _install(tmp_path, **kw):
    kw.setdefault("incident_dir", str(tmp_path / "incidents"))
    kw.setdefault("cooldown_s", 0.0)
    return flightrec.install(flightrec.FlightRecorder(**kw))


def _bundles(rec):
    paths = sorted(glob.glob(os.path.join(rec.incident_dir, "incident_*.json")))
    return [incident.load_bundle(p) for p in paths]


def test_default_families_are_training_side():
    agg = timeseries.WindowedAggregator()
    pilot = Autopilot(None, aggregator=agg, modes=("none",))
    assert DEFAULT_RULE_FAMILIES == ("numerics", "mem", "compile")
    assert [r.name for r in pilot.tracker.rules] == [
        "numerics_residual", "numerics_skew", "numerics_clip", "mem_pressure",
        "recompile_storm"]


# -- constructor validation: the candidate sets ------------------------------


def _pilot(**kw):
    kw.setdefault("aggregator", timeseries.WindowedAggregator())
    kw.setdefault("rules", [])
    return Autopilot(**kw)


@pytest.mark.parametrize("kw,match", [
    (dict(modes=("int8", "fp8")), "audited ladder"),
    (dict(modes=("bf16", "int8")), "ladder order"),
    (dict(modes=()), "at least one rung"),
    (dict(trainer=StubTrainer("int8"), modes=("bf16", "none")), "outside the"),
    (dict(modes=("none",), k_candidates=(4, 2)), "ascending positive"),
    (dict(modes=("none",), k_candidates=(2, 2, 4)), "ascending positive"),
    (dict(modes=("none",), k_candidates=(0, 1)), "ascending positive"),
    (dict(modes=("none",), k_candidates=(1, 2), initial_k=3), "not in k_candidates"),
    (dict(modes=("none",), cache_bytes_bounds=(0, 100)), "cache_bytes_bounds"),
    (dict(modes=("none",), cache_bytes_bounds=(200, 100)), "cache_bytes_bounds"),
    (dict(modes=("none",), window_s=0.0), "window_s"),
    (dict(modes=("none",), healthy_for_s=-1.0), "window_s"),
    (dict(modes=("none",), m_candidates=(4, 8)), "pipe_schedule"),
    (dict(modes=("none",), m_candidates=(8, 4), pipe_schedule="gpipe", pipe_stages=4),
     "ascending"),
    (dict(modes=("none",), m_candidates=(4, 8), initial_m=2, pipe_schedule="gpipe",
          pipe_stages=4), "not in m_candidates"),
    (dict(modes=("none",), plan_candidates=(("a", 1.0), ("a", 2.0))), "repeat"),
    (dict(modes=("none",), plan_candidates=(("a", 1.0), ("b", 2.0)), plan_tolerance=0.5),
     "plan_tolerance"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_constructor_rejects(kw, match):
    """JAX's constructor checks, message for message (the ladder, the
    trainer's rung, ascending K and M sets, the M knob's schedule, the
    cache bounds, the timing, plan names and tolerance)."""
    with pytest.raises(ValueError, match=match):
        _pilot(**kw)


def test_default_modes_start_at_trainer_rung():
    pilot = _pilot(trainer=StubTrainer("bf16"))
    assert pilot.modes == ("bf16", "none")
    assert pilot.compress_rung == 0
    assert _pilot().modes == COMPRESS_LADDER


def test_every_m_candidate_schedule_is_derived_up_front():
    """An M the tick tables cannot build is refused at construction (the
    port's ``pipeline_schedule.get_schedule`` raises, as JAX's)."""
    with pytest.raises(ValueError):
        _pilot(modes=("none",), m_candidates=(4, 8), pipe_schedule="no_such",
               pipe_stages=4)


# -- the compression knob ------------------------------------------------------


class TestCompressPolicy:
    def _pilot(self, trainer, agg, nows, **kw):
        kw.setdefault("modes", ("int8", "bf16"))
        kw.setdefault("window_s", 4.0)
        kw.setdefault("healthy_for_s", 30.0)
        kw.setdefault("rules", obs_numerics.numerics_rules())
        return Autopilot(trainer, aggregator=agg, now=iter(nows).__next__, **kw)

    def test_escalates_on_planted_drift_within_one_window(self):
        trainer = StubTrainer("int8")
        agg = timeseries.WindowedAggregator()
        plant_numerics_burn(agg)
        pilot = self._pilot(trainer, agg, [10.0])
        [d] = pilot.on_chunk(step=7)
        assert d["knob"] == "compress" and d["action"] == "escalate"
        assert (d["frm"], d["to"]) == ("int8", "bf16")
        # the triggering signal is quoted, with its windowed burns
        assert d["signal"] == "numerics_residual"
        assert set(d["burns"]) == {"60.0", "300.0"}
        assert all(b > 2.0 for b in d["burns"].values())
        assert d["step"] == 7 and d["chunk"] == 1
        assert trainer.compress == "bf16"
        snap = telemetry.snapshot()
        assert snap["gauges"]["autopilot.compress_rung"] == 1.0
        assert snap["counters"]["autopilot.actuations"] == 1
        assert "autopilot.decision_s" in snap["histograms"]

    def test_full_lifecycle_cooldown_clamp_and_hysteresis(self):
        trainer = StubTrainer("int8")
        agg = timeseries.WindowedAggregator()
        plant_numerics_burn(agg)
        pilot = self._pilot(trainer, agg,
                            [10.0, 12.0, 20.0, 21.0, 400.0, 405.0, 431.0, 432.0, 436.0])
        acts = [[d["action"] for d in pilot.on_chunk(step=i)] for i in range(9)]
        assert acts == [["escalate"], [], ["clamp"], [], ["clamp"], [], ["deescalate"],
                        [], []]
        assert trainer.switches == ["bf16", "int8"]
        d = pilot.last_decision
        assert d["signal"] == "numerics_healthy" and d["healthy_for_s"] == 30.0
        st = pilot.state()
        assert (st["compress"], st["actuations"], st["clamped"], st["suppressed"],
                st["chunks"]) == ("int8", 2, 2, 0, 9)
        snap = telemetry.snapshot()
        assert snap["gauges"]["autopilot.compress_rung"] == 0.0
        assert snap["counters"]["autopilot.clamped"] == 2

    def test_recovering_suppresses_every_knob(self):
        trainer = StubTrainer("int8")
        agg = timeseries.WindowedAggregator()
        plant_numerics_burn(agg)
        pilot = self._pilot(trainer, agg, [10.0, 11.0])
        [d] = pilot.on_chunk(step=3, recovering=True)
        assert (d["action"], d["knob"], d["signal"]) == ("suppress", "all",
                                                         "divergence_recovery")
        assert trainer.compress == "int8"
        assert pilot.state()["suppressed"] == 1
        # suppression spends no cooldown: the next chunk escalates at once
        [d] = pilot.on_chunk(step=4)
        assert d["action"] == "escalate"

    def test_shadow_mode_records_without_a_trainer(self):
        agg = timeseries.WindowedAggregator()
        plant_numerics_burn(agg)
        pilot = self._pilot(None, agg, [10.0], modes=("int8", "bf16"))
        [d] = pilot.on_chunk(step=1)
        assert d["action"] == "escalate" and pilot.state()["compress"] == "bf16"


# -- the scan-K knob -------------------------------------------------------------


class TestKPolicy:
    def _pilot(self, agg, nows, **kw):
        kw.setdefault("modes", ("none",))
        kw.setdefault("rules", memwatch.mem_rules())
        kw.setdefault("window_s", 60.0)
        kw.setdefault("healthy_for_s", 20.0)
        return Autopilot(None, aggregator=agg, now=iter(nows).__next__, **kw)

    @pytest.mark.parametrize("initial_k,action,to", [(4, "lower", 2), (1, "clamp", None)])
    def test_mem_pressure_lowers_k_or_clamps_at_floor(self, initial_k, action, to):
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        calls = []
        pilot = self._pilot(agg, [10.0], k_candidates=(1, 2, 4), initial_k=initial_k,
                            set_scan_k=calls.append)
        [d] = pilot.on_chunk(step=1)
        assert (d["knob"], d["action"], d["frm"]) == ("scan_k", action, initial_k)
        assert d["signal"] == "mem_pressure"
        assert d.get("to") == to
        assert calls == ([to] if to else []) and pilot.scan_k == (to or initial_k)
        assert telemetry.snapshot()["gauges"]["autopilot.scan_k"] == float(to or initial_k)
        assert pilot.state()["clamped"] == (action == "clamp")

    def test_host_gap_with_headroom_raises_k_after_healthy_window(self):
        agg = timeseries.WindowedAggregator()
        agg.tick(now=0.0)
        telemetry.set_gauge("mem.headroom_frac", 0.6)
        agg.tick(now=5.0)  # no dispatch histograms: host_gap = 1.0
        calls = []
        pilot = self._pilot(agg, [10.0, 31.0, 100.0, 170.0], k_candidates=(1, 2, 4),
                            initial_k=1, set_scan_k=calls.append)
        assert pilot.on_chunk(step=1) == []  # the first chunk anchors health
        [d] = pilot.on_chunk(step=2)
        assert d["action"] == "raise" and (d["frm"], d["to"]) == (1, 2)
        assert (d["signal"], d["host_gap_frac"], d["headroom_frac"]) == ("host_gap", 1.0,
                                                                          0.6)
        agg.tick(now=95.0)
        [d] = pilot.on_chunk(step=3)
        assert d["action"] == "raise" and d["to"] == 4
        agg.tick(now=165.0)
        [d] = pilot.on_chunk(step=4)
        assert d["action"] == "clamp" and d["frm"] == 4
        assert calls == [2, 4]

    def test_no_raise_without_headroom_signal(self):
        agg = timeseries.WindowedAggregator()
        agg.tick(now=0.0)
        telemetry.count("loader.batches")  # a frame, but no headroom gauge
        agg.tick(now=5.0)
        pilot = self._pilot(agg, [10.0, 31.0], k_candidates=(1, 2), initial_k=1)
        assert pilot.on_chunk(step=1) == []
        assert pilot.on_chunk(step=2) == []
        assert pilot.scan_k == 1


# -- the program-cache budget knob ---------------------------------------------


def _cache(name, entries, cache_mod=scan_driver, **kw):
    cache = cache_mod.ProgramCache(name=name, **kw)
    for key, size in entries:
        cache[key] = object()
        cache._sizes[key] = size
    return cache


class TestCachePolicy:
    def _pilot(self, agg, nows, caches, **kw):
        kw.setdefault("modes", ("none",))
        kw.setdefault("rules", memwatch.mem_rules())
        kw.setdefault("window_s", 60.0)
        kw.setdefault("healthy_for_s", 20.0)
        kw.setdefault("cache_bytes_bounds", (256, 2048))
        return Autopilot(None, aggregator=agg, extra_caches=caches,
                         now=iter(nows).__next__, **kw)

    def test_mem_pressure_halves_budget_and_evicts(self):
        cache = _cache("ap0", [("a", 600), ("b", 600)])
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        pilot = self._pilot(agg, [10.0], (cache,))
        [d] = pilot.on_chunk(step=1)
        assert (d["knob"], d["action"], d["signal"]) == ("cache_bytes", "shrink",
                                                         "mem_pressure")
        # no budget set yet: the ceiling is the starting point
        assert (d["frm"], d["to"]) == (2048, 1024)
        assert cache.max_bytes == 1024
        assert list(cache) == ["b"]  # 1200 live > 1024: the oldest evicted
        assert cache.evictions == 1
        assert telemetry.snapshot()["gauges"]["autopilot.cache_max_bytes"] == 1024.0

    def test_mem_pressure_at_floor_clamps(self):
        cache = _cache("ap1", [("a", 100)], max_bytes=256)
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        pilot = self._pilot(agg, [10.0], (cache,))
        [d] = pilot.on_chunk(step=1)
        assert d["action"] == "clamp" and d["frm"] == 256
        assert cache.max_bytes == 256

    def test_budget_regrows_after_sustained_healthy_window(self):
        cache = _cache("ap2", [("a", 100)], max_bytes=512)
        agg = timeseries.WindowedAggregator()
        agg.tick(now=0.0)
        agg.tick(now=5.0)  # frames, but no memory signal ever burns
        pilot = self._pilot(agg, [10.0, 31.0, 32.0, 100.0, 200.0], (cache,))
        assert pilot.on_chunk(step=1) == []  # the health anchor
        [d] = pilot.on_chunk(step=2)
        assert d["action"] == "grow" and (d["frm"], d["to"]) == (512, 1024)
        assert d["signal"] == "mem_healthy"
        assert pilot.on_chunk(step=3) == []  # cooldown
        [d] = pilot.on_chunk(step=4)
        assert d["to"] == 2048
        assert pilot.on_chunk(step=5) == []  # at the ceiling: no churn
        assert cache.max_bytes == 2048 and pilot.state()["actuations"] == 2

    def test_set_max_bytes_evicts_and_validates(self):
        cache = _cache("ap3", [("a", 600), ("b", 600)])
        assert cache.set_max_bytes(700) == 600
        assert list(cache) == ["b"] and cache.evictions == 1
        with pytest.raises(ValueError, match="max_bytes"):
            cache.set_max_bytes(0)
        assert cache.set_max_bytes(None) == 600  # budget removed
        assert cache.max_bytes is None

    def test_trainer_caches_are_actuated_parked_ones_too(self):
        """The knob reaches every cache of ``DataParallel.program_caches``:
        the live rung's and the ones ``set_compress`` parked."""
        dp = _make_dp(compress="int8")
        dp.set_compress("bf16")  # parks int8's cache
        caches = dp.program_caches
        assert len(caches) == 2
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        pilot = Autopilot(dp, aggregator=agg, rules=memwatch.mem_rules(),
                          modes=("bf16", "none"), cache_bytes_bounds=(256, 2048),
                          now=iter([10.0]).__next__)
        [d] = pilot.on_chunk(step=1)
        assert (d["action"], d["to"]) == ("shrink", 1024)
        assert [c.max_bytes for c in caches] == [1024, 1024]


# -- the microbatch knob ---------------------------------------------------------


class TestMPolicy:
    def _pilot(self, agg, nows, **kw):
        kw.setdefault("modes", ("none",))
        kw.setdefault("rules", memwatch.mem_rules())
        kw.setdefault("window_s", 60.0)
        kw.setdefault("healthy_for_s", 20.0)
        kw.setdefault("pipe_schedule", "gpipe")
        kw.setdefault("pipe_stages", 4)
        return Autopilot(None, aggregator=agg, now=iter(nows).__next__, **kw)

    def test_bubble_gap_raises_m_after_healthy_window(self):
        agg = timeseries.WindowedAggregator()
        # gpipe n=4: m=4 -> bubble 5/7, m=8 -> 7/11; measured at the current
        # prediction, so the gap to the next M is real
        plant_bubble(agg, 0.71)
        calls = []
        pilot = self._pilot(agg, [10.0, 31.0], m_candidates=(4, 8),
                            set_microbatch=calls.append)
        assert pilot.on_chunk(step=1) == []  # the first chunk anchors health
        [d] = pilot.on_chunk(step=2)
        assert (d["knob"], d["action"], d["frm"], d["to"]) == ("microbatch_m", "raise", 4, 8)
        assert d["signal"] == "bubble_gap"
        assert d["bubble_predicted"] == pytest.approx(5 / 7, abs=1e-4)
        assert d["bubble_predicted_next"] == pytest.approx(7 / 11, abs=1e-4)
        assert calls == [8] and pilot.microbatch_m == 8
        assert telemetry.snapshot()["gauges"]["autopilot.microbatch_m"] == 8.0

    @pytest.mark.parametrize("frac", [0.10, None])
    def test_no_raise_when_bubble_low_or_unmeasured(self, frac):
        agg = timeseries.WindowedAggregator()
        if frac is None:
            agg.tick(now=0.0)
            telemetry.count("loader.batches")
            agg.tick(now=5.0)
        else:
            plant_bubble(agg, frac)  # below the next M's prediction
        pilot = self._pilot(agg, [10.0, 31.0], m_candidates=(4, 8))
        assert pilot.on_chunk(step=1) == []
        assert pilot.on_chunk(step=2) == []
        assert pilot.microbatch_m == 4

    @pytest.mark.parametrize("initial_m,action", [(8, "lower"), (4, "clamp")])
    def test_mem_pressure_lowers_m_or_clamps_at_floor(self, initial_m, action):
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        calls = []
        pilot = self._pilot(agg, [10.0], m_candidates=(4, 8), initial_m=initial_m,
                            set_microbatch=calls.append)
        [d] = pilot.on_chunk(step=1)
        assert (d["action"], d["frm"]) == (action, initial_m)
        assert d["signal"] == "mem_pressure" and d["burns"]
        assert calls == ([4] if action == "lower" else [])

    def test_clamp_at_top_when_bubble_persists(self):
        agg = timeseries.WindowedAggregator()
        plant_bubble(agg, 0.75)  # at m=8 (the top), well above 7/11
        pilot = self._pilot(agg, [10.0, 31.0], m_candidates=(4, 8), initial_m=8)
        assert pilot.on_chunk(step=1) == []
        [d] = pilot.on_chunk(step=2)
        assert (d["action"], d["frm"], d["signal"]) == ("clamp", 8, "bubble_gap")

    def test_actuates_the_pipeline_trainer(self):
        """``set_microbatch`` is ``PipelineTrainer.set_microbatches``'s
        shape: a stand-in with the same surface re-derives its schedule."""
        from tpu_syncbn_torch.parallel import pipeline_schedule

        class Pipe:
            num_microbatches, schedule = 8, None

            def set_microbatches(self, m):
                self.schedule = pipeline_schedule.get_schedule("gpipe", m, 4)
                self.num_microbatches = m
                return True

        pipe = Pipe()
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        pilot = self._pilot(agg, [10.0], m_candidates=(4, 8), initial_m=8,
                            set_microbatch=pipe.set_microbatches)
        pilot.on_chunk(step=1)
        assert pipe.num_microbatches == 4 and pipe.schedule.n_microbatches == 4


# -- the layout knob ---------------------------------------------------------------


class TestLayoutPolicy:
    PLANS = (("dp.fp32.k8", 0.001), ("zero.fp32.k8", 0.002), ("pipe.1f1b.n4.m8", 0.003))

    def _pilot(self, agg, nows, **kw):
        kw.setdefault("modes", ("none",))
        kw.setdefault("rules", [])
        kw.setdefault("window_s", 60.0)
        kw.setdefault("plan_candidates", self.PLANS)
        return Autopilot(None, aggregator=agg, now=iter(nows).__next__, **kw)

    def _plant_step_time(self, agg, seconds, *, t0=0.0, t1=5.0, n=1):
        agg.tick(now=t0)
        for _ in range(n):
            telemetry.observe(incident._DISPATCH_HISTS[0], seconds)
        agg.tick(now=t1)

    def test_accepts_planned_candidate_objects(self):
        """The duck-typed branch JAX keeps for its planner's
        ``PlannedCandidate``: ``name`` and ``predicted_step_s`` are read."""
        cands = [types.SimpleNamespace(candidate=object(), name=n, predicted_step_s=s)
                 for n, s in self.PLANS[:2]]
        pilot = self._pilot(timeseries.WindowedAggregator(), [1.0], plan_candidates=cands)
        assert pilot.state()["plan"] == "dp.fp32.k8"
        assert pilot.state()["plan_candidates"] == ["dp.fp32.k8", "zero.fp32.k8"]

    def test_plan_violation_escalates_to_next_rank(self):
        agg = timeseries.WindowedAggregator()
        self._plant_step_time(agg, 0.05)  # 50x the 1 ms plan
        calls = []
        pilot = self._pilot(agg, [10.0], set_layout=calls.append)
        [d] = pilot.on_chunk(step=1)
        assert (d["knob"], d["action"]) == ("layout", "escalate")
        assert (d["frm"], d["to"]) == ("dp.fp32.k8", "zero.fp32.k8")
        assert d["signal"] == "plan_violation"
        assert d["measured_step_s"] == pytest.approx(0.05)
        assert d["predicted_step_s"] == pytest.approx(0.001)
        assert calls == ["zero.fp32.k8"] and pilot.plan_rank == 1
        assert pilot.state()["plan"] == "zero.fp32.k8"
        assert telemetry.snapshot()["gauges"]["autopilot.plan_rank"] == 1.0

    def test_within_tolerance_holds_the_plan(self):
        agg = timeseries.WindowedAggregator()
        self._plant_step_time(agg, 0.0012)  # 1.2x < 1.5x
        pilot = self._pilot(agg, [10.0])
        assert pilot.on_chunk(step=1) == [] and pilot.plan_rank == 0

    def test_escalation_respects_cooldown_then_clamps_at_last_rank(self):
        agg = timeseries.WindowedAggregator()
        self._plant_step_time(agg, 0.05)
        pilot = self._pilot(agg, [10.0, 11.0, 80.0, 150.0])
        [d1] = pilot.on_chunk(step=1)
        assert d1["action"] == "escalate"
        assert pilot.on_chunk(step=2) == []  # cooldown
        agg.tick(now=75.0)
        self._plant_step_time(agg, 0.05, t0=75.0, t1=78.0)
        [d2] = pilot.on_chunk(step=3)
        assert d2["action"] == "escalate" and d2["to"] == "pipe.1f1b.n4.m8"
        self._plant_step_time(agg, 0.05, t0=140.0, t1=145.0)
        [d3] = pilot.on_chunk(step=4)
        assert d3["action"] == "clamp" and d3["frm"] == "pipe.1f1b.n4.m8"
        assert pilot.plan_rank == 2  # escalate-only

    def test_no_decision_without_step_measurements(self):
        agg = timeseries.WindowedAggregator()
        agg.tick(now=0.0)
        telemetry.count("loader.batches")
        agg.tick(now=5.0)
        assert self._pilot(agg, [10.0]).on_chunk(step=1) == []


# -- every decision observable: ring, bundles, /statusz ---------------------------


class TestDecisionObservability:
    def test_every_decision_lands_in_the_ring(self, tmp_path):
        rec = _install(tmp_path)
        agg = timeseries.WindowedAggregator()
        plant_numerics_burn(agg)
        pilot = Autopilot(StubTrainer("int8"), aggregator=agg,
                          rules=obs_numerics.numerics_rules(), modes=("int8", "bf16"),
                          window_s=4.0, now=iter([10.0, 11.0, 20.0]).__next__)
        pilot.on_chunk(step=1, recovering=True)
        pilot.on_chunk(step=2)
        pilot.on_chunk(step=3)
        ring = rec.rings_snapshot()["autopilot"]
        assert [e["action"] for e in ring] == ["suppress", "escalate", "clamp"]
        assert [e["knob"] for e in ring] == ["all", "compress", "compress"]
        assert all(isinstance(e["t"], float) for e in ring)

    def test_actuation_dumps_schema_valid_autopilot_bundle(self, tmp_path):
        rec = _install(tmp_path)
        agg = timeseries.WindowedAggregator()
        plant_numerics_burn(agg)
        pilot = Autopilot(StubTrainer("int8"), aggregator=agg,
                          rules=obs_numerics.numerics_rules(), modes=("int8", "bf16"),
                          window_s=4.0, now=iter([10.0, 20.0]).__next__)
        pilot.on_chunk(step=1)  # escalate: an autopilot bundle
        pilot.on_chunk(step=2)  # clamp: the ring only
        by_kind = {}
        for b in _bundles(rec):  # load_bundle validates
            by_kind.setdefault(b["trigger"]["kind"], []).append(b)
        # the rule's own transition dumped an slo_alert bundle too
        assert len(by_kind["autopilot"]) == 1
        detail = by_kind["autopilot"][0]["trigger"]["detail"]
        assert detail["action"] == "escalate" and detail["signal"] == "numerics_residual"
        assert detail["burns"]
        ring = by_kind["autopilot"][0]["rings"]["autopilot"]
        assert ring and all(isinstance(e["knob"], str) for e in ring)

    def test_bundle_validation_rejects_knobless_ring_entry(self, tmp_path):
        rec = _install(tmp_path)
        rec.record_autopilot("compress", action="escalate")
        bundle = incident.load_bundle(rec.trigger("manual", force=True))
        bundle["rings"]["autopilot"] = [{"action": "escalate"}]
        with pytest.raises(ValueError, match="autopilot-ring"):
            incident.validate_bundle(bundle)

    def test_ring_is_bounded_and_scalarized(self):
        rec = flightrec.FlightRecorder(autopilot_capacity=3)
        for i in range(7):
            rec.record_autopilot("compress", idx=i, burn=np.float32(1.5))
        ring = rec.rings_snapshot()["autopilot"]
        assert [e["idx"] for e in ring] == [4, 5, 6]
        assert ring[0]["burn"] == 1.5 and type(ring[0]["burn"]) is float
        with pytest.raises(ValueError, match="autopilot_capacity"):
            flightrec.FlightRecorder(autopilot_capacity=0)

    def test_statusz_renders_controller_counters(self, tmp_path):
        _install(tmp_path)
        agg = timeseries.WindowedAggregator()
        plant_numerics_burn(agg)
        pilot = Autopilot(StubTrainer("int8"), aggregator=agg,
                          rules=obs_numerics.numerics_rules(), modes=("int8", "bf16"),
                          window_s=4.0, now=iter([10.0]).__next__)
        pilot.on_chunk(step=1)
        report = obs_server.statusz_report(registry=telemetry.REGISTRY)
        assert report["autopilot"]["autopilot.compress_rung"] == 1.0
        assert report["autopilot"]["autopilot.actuations"] == 1
        text = obs_server.render_statusz(report)
        assert "autopilot" in text and "autopilot.actuations" in text
        assert "(no autopilot attached)" not in text

    def test_plan_change_kind_is_wired(self):
        assert "plan_change" in incident.TRIGGER_KINDS

    def test_layout_escalation_dumps_plan_change_bundle(self, tmp_path):
        rec = _install(tmp_path)
        agg = timeseries.WindowedAggregator()
        agg.tick(now=0.0)
        telemetry.observe(incident._DISPATCH_HISTS[0], 0.05)
        agg.tick(now=5.0)
        pilot = Autopilot(None, aggregator=agg, modes=("none",), rules=[], window_s=60.0,
                          plan_candidates=(("dp.fp32.k8", 0.001), ("zero.fp32.k8", 0.002)),
                          now=iter([10.0]).__next__)
        [d] = pilot.on_chunk(step=1)
        assert d["action"] == "escalate"
        bundles = _bundles(rec)
        assert [b["trigger"]["kind"] for b in bundles] == ["plan_change"]
        detail = bundles[0]["trigger"]["detail"]
        assert detail["knob"] == "layout" and detail["to"] == "zero.fp32.k8"
        assert any(e.get("knob") == "layout" for e in bundles[0]["rings"]["autopilot"])

    def test_m_actuation_fires_autopilot_not_plan_change(self, tmp_path):
        rec = _install(tmp_path)
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        pilot = Autopilot(None, aggregator=agg, modes=("none",), rules=memwatch.mem_rules(),
                          window_s=60.0, m_candidates=(4, 8), initial_m=8,
                          pipe_schedule="gpipe", pipe_stages=4, now=iter([10.0]).__next__)
        assert [d["action"] for d in pilot.on_chunk(step=1)] == ["lower"]
        kinds = [b["trigger"]["kind"] for b in _bundles(rec)]
        assert "autopilot" in kinds and "plan_change" not in kinds

    def test_decisions_are_trace_instants(self):
        tracer = tracing.install()
        agg = timeseries.WindowedAggregator()
        plant_numerics_burn(agg)
        pilot = Autopilot(StubTrainer("int8"), aggregator=agg,
                          rules=obs_numerics.numerics_rules(), modes=("int8", "bf16"),
                          window_s=4.0, now=iter([10.0]).__next__)
        pilot.on_chunk(step=1)
        events = [e for e in tracing.validate_trace(list(tracer.events))
                  if e["name"] == "autopilot"]
        assert len(events) == 1
        assert events[0]["args"]["action"] == "escalate"
        assert "burns" not in events[0]["args"]  # only scalars go to the trace


# -- the data-side K actuator ------------------------------------------------------


def test_chunked_batches_rereads_live_k_and_emits_tail():
    pilot = Autopilot(None, aggregator=timeseries.WindowedAggregator(), rules=[],
                      modes=("none",), k_candidates=(2, 4), initial_k=2)
    gen = chunked_batches([np.full((3,), i, np.float32) for i in range(5)], pilot)
    assert next(gen).shape == (2, 3)
    pilot.scan_k = 4  # an actuation landing mid-stream
    tail = next(gen)
    assert tail.shape == (3, 3)  # only 3 batches left
    np.testing.assert_array_equal(tail[:, 0], [2, 3, 4])
    with pytest.raises(StopIteration):
        next(gen)
    torch_chunks = list(chunked_batches(
        [(torch.full((2,), float(i)),) for i in range(3)], pilot))
    assert [c[0].shape for c in torch_chunks] == [torch.Size([3, 2])]


# -- decision parity with the JAX controller --------------------------------------


def _packages():
    """The two packages' modules the scripts need, by the same names."""
    from tpu_syncbn.obs import (
        flightrec as jfr, incident as jinc, memwatch as jmw, numerics as jnum,
        server as jsrv, telemetry as jtel, timeseries as jts, tracing as jtr,
    )
    from tpu_syncbn.parallel import scan_driver as jsd
    from tpu_syncbn.runtime import autopilot as jap

    jax_pkg = types.SimpleNamespace(
        telemetry=jtel, timeseries=jts, numerics=jnum, memwatch=jmw, incident=jinc,
        flightrec=jfr, tracing=jtr, server=jsrv, scan_driver=jsd, Autopilot=jap.Autopilot)
    port_pkg = types.SimpleNamespace(
        telemetry=telemetry, timeseries=timeseries, numerics=obs_numerics,
        memwatch=memwatch, incident=incident, flightrec=flightrec, tracing=tracing,
        server=obs_server, scan_driver=scan_driver, Autopilot=Autopilot)
    return {"jax": jax_pkg, "port": port_pkg}


def _numerics_ops(t0, t1, value=0.9, n=20):
    return [("tick", t0)] + [("observe", "numerics.ef_residual_ratio", value,
                              (0.1, 0.5, 1.0))] * n + [("tick", t1)]


def _mem_ops(t0, t1, n=20):
    return [("tick", t0)] + [("observe", "mem.used_frac", 0.95, (0.5, 0.9, 1.0))] * n \
        + [("tick", t1)]


def _clip_ops(t0, t1, n=10):
    return [("tick", t0)] + [("observe", "numerics.clip_fraction", 0.97,
                              (0.01, 0.05, 0.1, 0.5, 1.0))] * n + [("tick", t1)]


#: scenario -> (Autopilot keywords, the planted script). ``("chunk", t)``
#: drives one ``on_chunk`` at clock t; ``("recover", t)`` one with
#: ``recovering=True``; ``("step", s, n)`` observes n dispatch-time samples
PARITY = {
    "compress": (
        dict(modes=("int8", "bf16", "none"), window_s=4.0, healthy_for_s=30.0,
             rules="numerics", trainer="int8"),
        _numerics_ops(0.0, 5.0) + [("chunk", t) for t in (10.0, 12.0, 20.0, 21.0, 26.0)]
        + _clip_ops(30.0, 35.0) + [("chunk", t) for t in (36.0, 41.0)]
        + [("chunk", t) for t in (400.0, 405.0, 431.0, 432.0, 436.0, 470.0, 480.0)]
        + [("recover", 481.0), ("chunk", 482.0)]),
    "scan_k": (
        dict(modes=("none",), rules="mem", window_s=60.0, healthy_for_s=20.0,
             k_candidates=(1, 2, 4), initial_k=1),
        [("tick", 0.0), ("gauge", "mem.headroom_frac", 0.6), ("step", 0.001, 3),
         ("tick", 5.0), ("chunk", 10.0), ("chunk", 31.0), ("tick", 95.0), ("chunk", 100.0),
         ("tick", 165.0), ("chunk", 170.0)] + _mem_ops(235.0, 240.0)
        + [("chunk", 241.0), ("chunk", 250.0), ("chunk", 320.0)] + _mem_ops(320.0, 330.0)
        + [("chunk", 331.0), ("chunk", 392.0), ("chunk", 460.0)]),
    "cache_bytes": (
        dict(modes=("none",), rules="mem", window_s=60.0, healthy_for_s=20.0,
             cache_bytes_bounds=(256, 2048), caches=True),
        _mem_ops(0.0, 5.0) + [("chunk", 10.0), ("chunk", 11.0), ("chunk", 80.0),
                              ("chunk", 150.0), ("chunk", 220.0)]
        + [("tick", 600.0), ("chunk", 610.0), ("chunk", 700.0), ("chunk", 800.0),
           ("chunk", 900.0)]),
    "microbatch_m": (
        dict(modes=("none",), rules="mem", window_s=60.0, healthy_for_s=20.0,
             m_candidates=(2, 4, 8), pipe_schedule="gpipe", pipe_stages=4),
        [("tick", 0.0), ("gauge", "pipeline.bubble_frac", 0.8), ("tick", 5.0),
         ("chunk", 10.0), ("chunk", 31.0), ("tick", 95.0), ("chunk", 100.0),
         ("tick", 165.0), ("chunk", 170.0)] + _mem_ops(235.0, 240.0)
        + [("chunk", 241.0), ("chunk", 301.0), ("chunk", 302.0)]),
    "layout": (
        dict(modes=("none",), rules=(), window_s=60.0,
             plan_candidates=(("dp.fp32.k8", 0.001), ("zero.fp32.k8", 0.002),
                              ("pipe.1f1b.n4.m8", 0.003))),
        [("tick", 0.0), ("step", 0.05, 1), ("tick", 5.0), ("chunk", 10.0), ("chunk", 11.0),
         ("tick", 75.0), ("step", 0.0012, 4), ("tick", 78.0), ("chunk", 80.0),
         ("step", 0.05, 2), ("tick", 145.0), ("chunk", 150.0), ("tick", 210.0),
         ("step", 0.05, 1), ("tick", 215.0), ("chunk", 220.0)]),
    "every_knob": (
        dict(modes=("int8", "bf16", "none"), rules="all", window_s=30.0,
             healthy_for_s=60.0, trainer="int8", k_candidates=(2, 4, 8), initial_k=4,
             cache_bytes_bounds=(512, 4096), caches=True, m_candidates=(4, 8),
             pipe_schedule="1f1b", pipe_stages=4,
             plan_candidates=(("dp.int8.k4", 0.002), ("zero.int8.k4", 0.004))),
        [("tick", 0.0), ("gauge", "mem.headroom_frac", 0.7),
         ("gauge", "pipeline.bubble_frac", 0.6), ("step", 0.01, 2)]
        + _numerics_ops(1.0, 5.0)[1:] + [("chunk", 10.0), ("chunk", 20.0)]
        + _mem_ops(25.0, 30.0) + [("chunk", 45.0), ("recover", 46.0), ("chunk", 80.0)]
        + [("tick", 200.0), ("chunk", 210.0), ("chunk", 280.0), ("tick", 340.0),
           ("chunk", 350.0), ("chunk", 420.0)]),
}


def _run_parity(pkg, kw, ops, tmp_path):
    kw = dict(kw)
    pkg.telemetry.set_enabled(True)
    pkg.telemetry.REGISTRY.reset()
    rec = pkg.flightrec.install(pkg.flightrec.FlightRecorder(
        incident_dir=str(tmp_path), cooldown_s=0.0))
    try:
        rules = kw.pop("rules")
        kw["rules"] = {"numerics": lambda: pkg.numerics.numerics_rules(),
                       "mem": lambda: pkg.memwatch.mem_rules(),
                       "all": lambda: None}.get(rules, lambda: list(rules))()
        trainer = StubTrainer(kw.pop("trainer")) if "trainer" in kw else None
        caches = ()
        if kw.pop("caches", False):
            caches = (_cache("p0", [("a", 1500), ("b", 1500)], pkg.scan_driver),
                      _cache("p1", [("c", 700)], pkg.scan_driver))
        agg = pkg.timeseries.WindowedAggregator()
        clock = {"t": 0.0}
        calls = []
        pilot = pkg.Autopilot(
            trainer, aggregator=agg, extra_caches=caches, now=lambda: clock["t"],
            set_scan_k=lambda k: calls.append(("k", k)),
            set_microbatch=lambda m: calls.append(("m", m)),
            set_layout=lambda n: calls.append(("layout", n)), **kw)
        decisions = []
        for op in ops:
            if op[0] == "tick":
                agg.tick(now=op[1])
            elif op[0] == "observe":
                pkg.telemetry.observe(op[1], op[2], buckets=op[3])
            elif op[0] == "gauge":
                pkg.telemetry.set_gauge(op[1], op[2])
            elif op[0] == "step":
                for _ in range(op[2]):
                    pkg.telemetry.observe(pkg.incident._DISPATCH_HISTS[0], op[1])
            else:
                clock["t"] = op[1]
                decisions.append(pilot.on_chunk(step=len(decisions),
                                                recovering=op[0] == "recover"))
        snap = pkg.telemetry.snapshot()
        metrics = {n: v for part in ("gauges", "counters") for n, v in snap[part].items()
                   if n.startswith("autopilot.")}
        kinds = sorted(b["trigger"]["kind"] for b in (
            pkg.incident.load_bundle(p)
            for p in glob.glob(os.path.join(str(tmp_path), "incident_*.json"))))
        return {"decisions": decisions, "state": pilot.state(), "metrics": metrics,
                "calls": calls, "switches": trainer.switches if trainer else None,
                "caches": [c.stats() for c in caches], "kinds": kinds,
                "ring": [{k: v for k, v in e.items() if k != "t"}
                         for e in rec.rings_snapshot()["autopilot"]]}
    finally:
        pkg.flightrec.uninstall()
        rec.close()


@pytest.mark.parametrize("scenario", sorted(PARITY))
def test_decisions_match_jax(scenario, tmp_path):
    """One planted series through both controllers on one clock: every
    decision dict, ``state()``, the ``autopilot.*`` gauges and counters, the
    actuation callbacks, the caches' accounting, the bundles' kinds and the
    ring are equal."""
    kw, ops = PARITY[scenario]
    pkgs = _packages()
    try:
        got = {name: _run_parity(pkg, kw, ops, tmp_path / name)
               for name, pkg in pkgs.items()}
    finally:
        _reset(pkgs["jax"], None)
    port, ref = got["port"], got["jax"]
    assert [d for ds in ref["decisions"] for d in ds], "the scenario decided nothing"
    for i, (a, b) in enumerate(zip(port["decisions"], ref["decisions"])):
        assert a == b, f"chunk {i}"
    for key in ("decisions", "state", "metrics", "calls", "switches", "caches", "kinds",
                "ring"):
        assert port[key] == ref[key], key


# -- ResilientLoop wiring ------------------------------------------------------------


class TinyNet(torch.nn.Module):
    """JAX's test net: Linear(4, 4) then SyncBN."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc = torch.nn.Linear(4, 4)
        with torch.no_grad():
            for p in self.fc.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        self.bn = nn.BatchNorm1d(4, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def _loss(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def _make_dp(**kw):
    model = nn.convert_sync_batchnorm(TinyNet())
    return parallel.DataParallel(model, torch.optim.Adam(model.parameters(), lr=1e-2),
                                 _loss, device="cpu", **kw)


def _make_batch(seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(16, 4).astype(np.float32)),
            torch.from_numpy(rng.randn(16, 4).astype(np.float32)))


class TestResilientLoopIntegration:
    def test_divergence_rollback_suppresses_actuation(self, tmp_path):
        dp = _make_dp(divergence_guard="restore_last_good")
        agg = timeseries.WindowedAggregator()
        agg.tick(now=0.0)
        pilot = Autopilot(None, aggregator=agg, modes=("none",),
                          rules=obs_numerics.numerics_rules())
        batch = _make_batch()
        loop = resilience.ResilientLoop(dp, str(tmp_path / "ck"), ckpt_every=2,
                                        autopilot=pilot)
        try:
            loop.run(iter([batch] * 4))
            loop.run(faults.poison_nan(iter([batch] * 3), 1))
        finally:
            loop.close()
        assert loop.counters.count("divergence_restores") == 1
        st = pilot.state()
        # the guard owned the rollback chunk: one suppression, no actuation
        assert st["suppressed"] == 1 and st["actuations"] == 0
        assert st["last_decision"]["action"] == "suppress"
        assert st["last_decision"]["signal"] == "divergence_recovery"
        assert st["chunks"] == 4 + 3  # every step once, the rollback's as its suppression

    def test_watchdog_deadline_follows_live_k(self, tmp_path, monkeypatch):
        created, deadlines = [], []
        real_watchdog = resilience.Watchdog

        class CapturingWatchdog(real_watchdog):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                created.append(self)

            def pat(self):
                deadlines.append(self.deadline_s)
                super().pat()

        monkeypatch.setattr(resilience, "Watchdog", CapturingWatchdog)
        dp = _make_dp(compress="none")
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        clock = itertools.count(10, 100)
        pilot = Autopilot(None, aggregator=agg, rules=memwatch.mem_rules(),
                          modes=("none",), k_candidates=(1, 2), initial_k=2, window_s=60.0,
                          healthy_for_s=1e9, now=lambda: float(next(clock)))
        loop = resilience.ResilientLoop(dp, str(tmp_path / "ck"), ckpt_every=100,
                                        scan_steps=2, step_deadline_s=30.0, autopilot=pilot)
        try:
            loop.run(chunked_batches(iter([_make_batch()] * 6), pilot), max_steps=6)
        finally:
            loop.close()
        assert loop.step == 6
        # the first chunk burned mem_pressure: K lowered 2 -> 1, mirrored
        assert pilot.scan_k == 1 and loop.scan_steps == 1
        assert pilot.state()["actuations"] == 1
        # built at 30 x 2, recomputed at every chunk from the live K
        assert len(created) == 1 and created[0].deadline_s == 30.0
        assert deadlines == [60.0, 30.0, 30.0, 30.0, 30.0]

    def test_one_step_chunks_after_a_lowering_run_as_chunks(self, tmp_path):
        """After K drops to 1 the loop still sends each (1, ...)-stacked
        chunk through ``train_steps_batches`` (as JAX's loop does), and the
        run equals six plain steps."""
        dp = _make_dp(compress="none")
        seen = []
        real = dp.train_steps_batches

        def spy(batches):
            seen.append(scan_driver.scan_length(batches))
            return real(batches)

        dp.train_steps_batches = spy
        dp.train_step = None  # the chunked loop never takes the step path
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        clock = itertools.count(10, 100)
        pilot = Autopilot(None, aggregator=agg, rules=memwatch.mem_rules(),
                          modes=("none",), k_candidates=(1, 3), initial_k=3, window_s=60.0,
                          healthy_for_s=1e9, now=lambda: float(next(clock)))
        batches = [_make_batch(s) for s in range(6)]
        loop = resilience.ResilientLoop(dp, str(tmp_path / "ck"), ckpt_every=100,
                                        scan_steps=3, autopilot=pilot)
        try:
            out = loop.run(chunked_batches(iter(batches), pilot))
        finally:
            loop.close()
        assert seen == [3, 1, 1, 1] and out["steps"] == 6 and loop.scan_steps == 1
        ref = _make_dp(compress="none")
        for b in batches:
            ref.train_step(b)
        for (k, a), b in zip(dp.model.state_dict().items(), ref.model.state_dict().values()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=k, **NET)

    def test_step_loop_keeps_its_k(self, tmp_path):
        """Unchunked (``scan_steps=1``) the loop drives the policy step a
        step and leaves its own K alone, as JAX's does."""
        dp = _make_dp(compress="none")
        agg = timeseries.WindowedAggregator()
        plant_mem_burn(agg)
        pilot = Autopilot(None, aggregator=agg, rules=memwatch.mem_rules(),
                          modes=("none",), k_candidates=(1, 2), initial_k=2,
                          now=itertools.count(10, 100).__next__)
        loop = resilience.ResilientLoop(dp, str(tmp_path / "ck"), ckpt_every=100,
                                        autopilot=pilot)
        try:
            loop.run(iter([_make_batch()] * 3))
        finally:
            loop.close()
        assert pilot.chunks == 3 and pilot.scan_k == 1 and loop.scan_steps == 1


def test_int8_trainer_escalates_and_recalls_its_parked_programs():
    """The controller on a real ``DataParallel``: a planted numerics burn
    escalates int8 -> bf16 (the int8 cache parked, the residual zeroed in
    place), and after the healthy window it de-escalates back to the very
    int8 cache object — recalled, not rebuilt (no new miss)."""
    dp = _make_dp(compress="int8")
    stacked = scan_driver.stack_batches([_make_batch(s) for s in range(2)])
    dp.train_steps_batches(stacked)
    int8_cache = dp._train_steps_cache
    residual = dp._residual
    misses = int8_cache.misses
    agg = timeseries.WindowedAggregator()
    plant_numerics_burn(agg)
    clock = {"t": 10.0}
    pilot = Autopilot(dp, aggregator=agg, rules=obs_numerics.numerics_rules(),
                      modes=("int8", "bf16"), window_s=4.0, healthy_for_s=30.0,
                      now=lambda: clock["t"])
    [d] = pilot.on_chunk(step=2)
    assert (d["action"], dp.compress) == ("escalate", "bf16")
    assert dp._residual is residual and not residual.any()
    dp.train_steps_batches(stacked)
    for clock["t"] in (400.0, 405.0, 440.0):
        pilot.on_chunk(step=4)
    assert dp.compress == "int8" and dp._train_steps_cache is int8_cache
    dp.train_steps_batches(stacked)
    assert int8_cache.misses == misses and int8_cache.hits >= 1


def test_tensor_parallel_rules_refusal_names_the_design_question():
    """The refusal of tensor-parallel ``rules`` stays; its message names
    the open design question (ROADMAP 10d), not a missing module."""
    from tpu_syncbn_torch.parallel.layout import P, SpecLayout

    model = nn.convert_sync_batchnorm(TinyNet())
    layout = SpecLayout.tensor_parallel(model=1, rules=(("*", P()),), device="cpu")
    with pytest.raises(NotImplementedError) as err:
        parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1), _loss,
                              device="cpu", layout=layout)
    msg = str(err.value)
    assert "ROADMAP 10d" in msg and "design" in msg
    assert "not ported" not in msg and "A.13" not in msg
    assert parallel.trainer.DataParallel.__doc__.count("ROADMAP 10d") == 1


def test_module_surface_matches_jax():
    """Every public name and knob constant of JAX's module, and the
    constructor's keywords and defaults, one for one."""
    import inspect

    from tpu_syncbn.runtime import autopilot as jap

    for name in ("COMPRESS_LADDER", "DEFAULT_RULE_FAMILIES", "_KNOBS"):
        assert getattr(autopilot_mod, name) == getattr(jap, name), name
    want = {n for n in vars(jap) if not n.startswith("__")
            and getattr(getattr(jap, n), "__module__", jap.__name__) == jap.__name__}
    got = {n for n in vars(autopilot_mod) if not n.startswith("__")
           and getattr(getattr(autopilot_mod, n), "__module__",
                       autopilot_mod.__name__) == autopilot_mod.__name__}
    assert want - {"annotations"} <= got
    sig = inspect.signature(Autopilot.__init__).parameters
    jsig = inspect.signature(jap.Autopilot.__init__).parameters
    assert [(n, p.default) for n, p in sig.items() if n != "now"] == \
        [(n, p.default) for n, p in jsig.items() if n != "now"]
    assert {n for n in vars(Autopilot) if not n.startswith("__")} == \
        {n for n in vars(jap.Autopilot) if not n.startswith("__")}
