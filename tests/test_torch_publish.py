"""The port's weight publication (``tpu_syncbn_torch.serve.publish``, the
publication half of ``utils.checkpoint``, the publication faults and
``ResilientLoop(publish_dir=)``) against the JAX package's: JAX's
tests/test_publish.py case for case, then the same scripts through both
packages.

Four layers, bottom up, as in JAX's file:

* the **publication store**: versioned manifest-verified payloads behind
  an atomically flipped pointer — corruption and skew rejected at load,
  the pointer the authority, pruning sparing the pointed-at version, the
  async checkpointer publishing through its ordered worker;
* **redistribution** of ZeRO flat shards into the serving tree, bit for
  bit the host gather;
* **engine versioning**: a swap copies into the tensors the programs
  read (no new program), a batch in flight finishes on its version,
  skew touches nothing, rollback is bit for bit;
* the **swap controller**: readiness window, memwatch-bounded double
  buffer, probe and automatic rollback, and the chaos matrix over the
  publication faults.

Parity with JAX (CPU, JAX on a 1-device mesh): one store script and one
controller script through both packages give the same file set on disk
(up to the payload's extension), the same manifest and pointer keys,
versions and steps, the same outcomes, exception classes and result keys,
the same ``serve.*`` and ``checkpoint.*`` counters, the same readiness
flips and serve-ring kinds, the same ``/statusz`` publication section and
the same ``publication_rules`` verdict. For numbers, the JAX engine's
weights after its swap are carried into the port
(``models.load_jax_params``), published, swapped in with
``swap_from_publication`` and held against the JAX engine's ``predict`` at
rtol 2e-4 / atol 1e-5 (``test_torch_serve.py``'s tolerance).
"""

import json
import logging
import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import models, nn, parallel, serve
from tpu_syncbn_torch.obs import flightrec, memwatch, telemetry, tracing
from tpu_syncbn_torch.obs import server as obs_server
from tpu_syncbn_torch.parallel.redistribute import portable_redistribute
from tpu_syncbn_torch.testing import faults
from tpu_syncbn_torch.utils import checkpoint as ckpt

TOL = dict(rtol=2e-4, atol=1e-5)
WAIT_S = 30


def _obs_modules():
    """Both packages' process-global observability modules."""
    from tpu_syncbn.obs import flightrec as jfr, memwatch as jmw, profiling as jprof
    from tpu_syncbn.obs import telemetry as jtel, tracing as jtr
    from tpu_syncbn_torch.obs import profiling

    return ((telemetry, tracing, flightrec, memwatch, profiling),
            (jtel, jtr, jfr, jmw, jprof))


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Every test starts and ends, in both packages, with telemetry at its
    default, an empty registry, a fresh recompile-storm detector (engines
    built by earlier tests are no storm) and no tracer, recorder or
    sampler."""

    def reset():
        for tel, tr, fr, mw, prof in _obs_modules():
            prof.set_detector(None)
            tel.set_enabled(None)
            tel.REGISTRY.reset()
            tr.uninstall()
            rec = fr.uninstall()
            if rec is not None:
                rec.close()
            sampler = mw.uninstall()
            if sampler is not None:
                sampler.close()

    reset()
    yield
    reset()


class Net(torch.nn.Module):
    """JAX's tests/test_publish.py ``Net``: Linear(4, 6) then BatchNorm1d(6)."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 6)
        self.bn = nn.BatchNorm1d(6, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def _sq_loss(m, b):
    return (m(b) ** 2).mean()


def _batch(s):
    return np.random.RandomState(s).randn(16, 4).astype(np.float32)


def _trained_dp(*, zero=False, steps=3, state=None):
    torch.manual_seed(0)
    model = nn.convert_sync_batchnorm(Net())
    if state is not None:
        models.load_jax_params(model, state)
    dp = parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=0.05),
                               _sq_loss, device="cpu", zero=zero)
    for s in range(steps):
        dp.train_step(_batch(s))
    return dp


#: trainers only READ by the tests that share them (build engines,
#: redistribute, publish their weights); tests that train further build
#: their own
_DP_CACHE: dict = {}


def _shared_dp(*, zero=False):
    if zero not in _DP_CACHE:
        _DP_CACHE[zero] = _trained_dp(zero=zero)
    return _DP_CACHE[zero]


def _np_tree(seed=0):
    """A small plain-numpy publication tree (JAX's ``_np_tree``)."""
    rng = np.random.RandomState(seed)
    return {
        "params": {"w": rng.randn(4, 6).astype(np.float32),
                   "b": rng.randn(6).astype(np.float32)},
        "rest": {"count": np.int64(3)},
    }


def _template(tree):
    """Zeros in ``tree``'s structure, as tensors: the load template."""
    return ckpt._map(lambda a: torch.zeros_like(torch.as_tensor(a)), tree)


def _x(n, seed=9):
    return np.random.RandomState(seed).randn(n, 4).astype(np.float32)


def _params(eng):
    return eng.param_template()


def _rest(eng):
    return eng._live()[1]


def _perturbed(params, eps=1e-3):
    """Same structure, one float tensor nudged — structurally identical (a
    swap reuses the programs), numerically distinguishable."""
    out, done = {}, False
    for n, t in params.items():
        if not done and t.is_floating_point():
            out[n], done = t + eps, True
        else:
            out[n] = t
    return out


def _leaf0(eng):
    return next(iter(eng.param_template().values())).clone()


def _local_eval(model, x):
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(torch.from_numpy(x)).numpy()
    finally:
        model.train(was)


# ------------------------------------------------------- publication store


class TestPublicationStore:
    def test_publish_load_round_trip(self, tmp_path):
        tree = _np_tree()
        d = str(tmp_path)
        path = ckpt.publish_version(d, 7, tree, step=3)
        assert os.path.exists(path)
        assert ckpt.published_versions(d) == [7]
        assert ckpt.published_version(d) == 7
        manifest = ckpt.read_published_manifest(d, 7)
        assert manifest["version"] == 7 and manifest["step"] == 3
        loaded, version = ckpt.load_published(d, _template(tree))
        assert version == 7
        for (_, got), (_, want) in zip(ckpt._leaves(loaded), ckpt._leaves(tree)):
            assert torch.equal(got, torch.as_tensor(want))

    def test_pointer_is_authority_and_prune_spares_it(self, tmp_path):
        tree = _np_tree()
        d = str(tmp_path)
        for v in (1, 2, 3, 4):
            ckpt.publish_version(d, v, tree, keep=2)
        assert ckpt.published_versions(d) == [3, 4]
        assert ckpt.published_version(d) == 4
        ptr = ckpt.read_published_pointer(d)
        assert ptr["version"] == 4 and ptr["tree_hash"]

    def test_corrupt_payload_rejected_pointer_untouched(self, tmp_path):
        tree = _np_tree()
        d = str(tmp_path)
        ckpt.publish_version(d, 1, tree)
        faults.corrupt_publication(d, "truncate")
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.load_published(d, _template(tree))
        # the pointer never moved: re-publication can heal in place
        assert ckpt.published_version(d) == 1

    def test_bitflip_payload_rejected(self, tmp_path):
        tree = _np_tree()
        d = str(tmp_path)
        ckpt.publish_version(d, 1, tree)
        faults.corrupt_publication(d, "bitflip", seed=5)
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.load_published(d, _template(tree))

    def test_missing_manifest_is_corruption(self, tmp_path):
        tree = _np_tree()
        d = str(tmp_path)
        ckpt.publish_version(d, 1, tree)
        faults.corrupt_publication(d, target="manifest")
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.load_published(d, _template(tree))

    def test_skew_rejected_before_deserialization(self, tmp_path, monkeypatch):
        tree = _np_tree()
        d = str(tmp_path)
        ckpt.publish_version(d, 1, tree)
        faults.skew_published_manifest(d, seed=3)
        template = _template(tree)
        expect = ckpt.tree_structure_hash(template)
        # the payload is never deserialized
        monkeypatch.setattr(ckpt, "_from_bytes", lambda *a: pytest.fail("deserialized"))
        with pytest.raises(ckpt.PublicationSkewError):
            ckpt.load_published(d, template, expect_tree_hash=expect)

    def test_async_publish_through_ordered_worker(self, tmp_path):
        tree = _np_tree()
        d = str(tmp_path)
        with ckpt.AsyncCheckpointer(keep=3) as ac:
            ac.save(str(tmp_path / "ckpt"), 10, _np_tree(seed=1))
            ac.publish(d, 11, tree)
            assert ac.flush(timeout=60)
        assert ckpt.published_version(d) == 11
        assert ckpt.available_steps(str(tmp_path / "ckpt")) == [10]
        _, version = ckpt.load_published(d, _template(tree))
        assert version == 11


# ---------------------------------------------------------- redistribution


class TestRedistribute:
    def test_matches_host_gather_bit_identical(self):
        from tpu_syncbn_torch.parallel.zero import unshard_params

        dp = _shared_dp(zero=True)
        via_devices = portable_redistribute(dp._flat, dp._shards, dp._layout)
        via_host = unshard_params(dp._flat, dp._shards)
        assert list(via_devices) == list(via_host)
        for name in via_host:
            assert torch.equal(via_devices[name], via_host[name])

    def test_output_is_the_full_tree_on_the_trainers_device(self):
        """JAX's ``test_output_replicated_on_mesh``: every rank holds the
        whole tree. At world 1: every parameter, its full shape, on the
        trainer's device, equal to the module the step's gather wrote."""
        dp = _shared_dp(zero=True)
        out = portable_redistribute(dp._flat, dp._shards, dp._layout)
        params = dict(dp.model.named_parameters())
        assert set(out) == set(params)
        for name, t in out.items():
            assert t.shape == params[name].shape and t.device == dp.device
            assert torch.equal(t, params[name].detach())


# -------------------------------------------------------- engine versioning


class TestEngineSwap:
    def test_swap_serves_new_version_zero_recompile(self):
        eng = serve.InferenceEngine.from_trainer(_shared_dp(), buckets=(8,))
        x = _x(8)
        eng.warm(x[:1])
        compiled = eng.stats()["programs_compiled"]
        old_out = eng.predict(x)
        assert eng.version == 0 and eng.previous_version is None
        old = eng.swap_params(_perturbed(_params(eng)), version=1)
        assert old == 0
        assert eng.version == 1 and eng.previous_version == 0
        new_out = eng.predict(x)
        assert not np.array_equal(old_out, new_out)
        assert eng.stats()["programs_compiled"] == compiled
        assert eng.stats()["version"] == 1
        assert eng.health()["version"] == 1

    def test_structure_skew_rejected_engine_untouched(self):
        eng = serve.InferenceEngine.from_trainer(_shared_dp(), buckets=(8,))
        x = _x(8)
        before = eng.predict(x)
        with pytest.raises(serve.VersionSkewError):
            eng.swap_params({"wrong": torch.zeros(3)}, version=1)
        assert eng.version == 0
        np.testing.assert_array_equal(before, eng.predict(x))

    def test_rollback_bit_identical(self):
        eng = serve.InferenceEngine.from_trainer(_shared_dp(), buckets=(8,))
        x = _x(8)
        old_leaf = _leaf0(eng)
        old_out = eng.predict(x)
        eng.swap_params(_perturbed(_params(eng)), version=1)
        assert eng.rollback() == 0
        assert eng.version == 0
        assert torch.equal(old_leaf, _leaf0(eng))
        np.testing.assert_array_equal(old_out, eng.predict(x))
        # the rolled-back-from state stays retained for a post-mortem
        assert eng.previous_version == 1

    def test_rollback_without_previous_raises(self):
        eng = serve.InferenceEngine.from_trainer(_shared_dp(), buckets=(8,))
        with pytest.raises(RuntimeError, match="no previous"):
            eng.rollback()
        assert eng.version == 0

    def test_engine_owns_buffers_against_trainer_updates(self):
        """JAX's ``test_engine_owns_buffers_against_trainer_donation``: the
        engine COPIES the state it takes from a live trainer (the trainer
        updates its tensors in place), so training on changes nothing the
        engine serves."""
        dp = _trained_dp()
        eng = serve.InferenceEngine.from_trainer(dp, buckets=(8,))
        x = _x(8)
        ctl = serve.SwapController(eng, health_name="pub_own")
        try:
            ctl.swap_from_trainer(dp)
        finally:
            ctl.close()
        swapped = eng.predict(x)
        for s in range(3, 6):
            dp.train_step(_batch(s))
        np.testing.assert_array_equal(swapped, eng.predict(x))

    def test_inflight_batch_pins_old_version(self):
        """A swap landing while a request is in flight (between its
        copy-in and copy-out: its program is running) waits for it, so the
        batch finishes on the version it started on; the next request
        runs the new one."""
        eng = serve.InferenceEngine.from_trainer(_shared_dp(), buckets=(8,))
        x = _x(8)
        eng.warm(x[:1])
        old_out = eng.predict(x)
        new_params = _perturbed(_params(eng))
        prog = eng._program(8, x)
        real_run = prog.run
        swapped: list = []
        swapper = threading.Thread(
            target=lambda: swapped.append(eng.swap_params(new_params, version=1)))

        def run_with_a_swap_racing(engine, batch, n):
            swapper.start()
            time.sleep(0.05)
            assert not swapped  # the swap waits for this call
            return real_run(engine, batch, n)

        prog.run = run_with_a_swap_racing
        inflight_out = eng.predict(x)
        swapper.join(WAIT_S)
        assert not swapper.is_alive() and swapped == [0]
        np.testing.assert_array_equal(old_out, inflight_out)
        del prog.run
        assert eng.version == 1
        assert not np.array_equal(old_out, eng.predict(x))


# --------------------------------------------------------- swap controller


class _StubBreaker:
    """Duck-typed circuit breaker for probe-window tests."""

    def __init__(self, state="closed"):
        self.state = state


class TestSwapController:
    def _engine(self, buckets=(8,)):
        dp = _shared_dp()
        eng = serve.InferenceEngine.from_trainer(dp, buckets=buckets)
        eng.warm(_x(1))
        return dp, eng

    def test_clean_swap_and_telemetry(self):
        telemetry.set_enabled(True)
        _, eng = self._engine()
        x = _x(8)
        ctl = serve.SwapController(eng, health_name="pub_t1")
        try:
            result = ctl.swap(_perturbed(_params(eng)), version=1, canary=x[:1])
            assert result["outcome"] == "swapped"
            assert result["version"] == 1
            assert result["previous_version"] == 0
            assert result["swap_s"] > 0
            snap = telemetry.REGISTRY.snapshot()
            assert snap["counters"]["serve.swaps_total"] == 1
            assert snap["gauges"]["serve.version.active"] == 1
            assert snap["gauges"]["serve.version.previous"] == 0
            assert snap["gauges"]['serve.version{mode="active"}'] == 1
            assert snap["histograms"]["serve.swap_s"]["count"] == 1
        finally:
            ctl.close()

    def test_swap_lands_in_flight_recorder(self, tmp_path):
        rec = flightrec.install(flightrec.FlightRecorder(
            cooldown_s=0.0, incident_dir=str(tmp_path / "incidents")))
        _, eng = self._engine()
        ctl = serve.SwapController(eng, health_name="pub_rec")
        try:
            ctl.swap(_perturbed(_params(eng)), version=1)
        finally:
            ctl.close()
        kinds = [e["kind"] for e in rec.rings_snapshot()["serve"]]
        assert "weight_swap" in kinds
        assert rec.last_incident is not None
        assert rec.last_incident["trigger"] == "weight_swap"

    def test_readiness_window_flips_during_swap(self):
        _, eng = self._engine()
        seen = {}

        def hook(phase):
            if phase == "commit":
                ok, detail = ctl.readiness()
                seen["commit"] = (ok, detail["swapping"])

        ctl = serve.SwapController(eng, health_name="pub_ready", phase_hook=hook)
        try:
            ctl.swap(_perturbed(_params(eng)), version=1)
            assert seen["commit"] == (False, True)  # not ready mid-swap
            ok, detail = ctl.readiness()
            assert ok and not detail["swapping"]
            assert detail["version"] == 1
            _, checks = obs_server.evaluate_readiness()
            assert "pub_ready" in checks
        finally:
            ctl.close()
        _, checks = obs_server.evaluate_readiness()
        assert "pub_ready" not in checks  # close() unregisters

    def test_swap_from_trainer_zero_on_devices(self):
        """JAX's ``test_swap_from_trainer_zero_on_mesh``: a ``zero=True``
        trainer's module holds the gathered values after each step, so the
        swap reads it, and what it reads equals its flat shards through
        ``portable_redistribute`` bit for bit."""
        dp = _trained_dp(zero=True)
        eng = serve.InferenceEngine.from_trainer(dp, buckets=(8,))
        x = _x(8)
        before = eng.predict(x)
        for s in range(3, 6):
            dp.train_step(_batch(s))
        ctl = serve.SwapController(eng, health_name="pub_tr")
        try:
            result = ctl.swap_from_trainer(dp)
        finally:
            ctl.close()
        assert result["outcome"] == "swapped"
        assert result["source"] == "trainer"
        after = eng.predict(x)
        assert not np.array_equal(before, after)
        # the swapped-in weights ARE the trainer's current ones
        np.testing.assert_allclose(after, _local_eval(dp.model, x), rtol=1e-5, atol=1e-6)
        gathered = portable_redistribute(dp._flat, dp._shards, dp._layout)
        served = eng.param_template()
        assert set(gathered) <= set(served)
        for name, full in gathered.items():
            assert torch.equal(served[name], full), name

    def test_swap_from_publication_round_trip(self, tmp_path):
        _, eng = self._engine()
        d = str(tmp_path)
        ckpt.publish_version(d, 42, {"params": _perturbed(_params(eng)), "rest": _rest(eng)})
        x = _x(8)
        before = eng.predict(x)
        ctl = serve.SwapController(eng, health_name="pub_pub")
        try:
            result = ctl.swap_from_publication(d, canary=x[:1])
        finally:
            ctl.close()
        assert result["outcome"] == "swapped"
        assert result["version"] == 42
        assert result["source"] == "publication"
        assert eng.version == 42
        assert not np.array_equal(before, eng.predict(x))

    def test_corrupt_publication_rejected_under_live_load(self, tmp_path):
        """A corrupted publication is rejected with ZERO failed requests —
        the old version serves every in-flight and later request."""
        _, eng = self._engine()
        d = str(tmp_path)
        ckpt.publish_version(d, 1, {"params": _perturbed(_params(eng)), "rest": _rest(eng)})
        faults.corrupt_publication(d, "bitflip", seed=7)
        x = _x(32)
        failures, answered = [], []
        stop = threading.Event()
        bat = serve.DynamicBatcher(eng, max_batch=8, max_wait_ms=2, max_queue=64,
                                   health_name="pub_chaos")
        try:
            def client():
                i = 0
                while not stop.is_set():
                    try:
                        bat.submit(x[i % 32:i % 32 + 1]).result(timeout=60)
                        answered.append(i)
                    except Exception as e:  # any failure breaks the claim
                        failures.append(e)
                    i += 1

            th = threading.Thread(target=client, daemon=True)
            th.start()
            ctl = serve.SwapController(eng, batcher=bat, health_name="pub_chaos_ctl")
            try:
                deadline = time.monotonic() + WAIT_S
                while len(answered) < 4 and time.monotonic() < deadline:
                    time.sleep(0.005)
                with pytest.raises(ckpt.CheckpointCorruptError):
                    ctl.swap_from_publication(d)
                assert ctl.rejected == 1
            finally:
                ctl.close()
            n_after = len(answered) + 4
            deadline = time.monotonic() + WAIT_S
            while len(answered) < n_after and time.monotonic() < deadline:
                time.sleep(0.005)
            stop.set()
            th.join(timeout=WAIT_S)
            assert not th.is_alive()
        finally:
            stop.set()
            bat.close(drain=True)
        assert not failures
        assert len(answered) >= 8
        assert eng.version == 0  # the old version never left

    def test_version_skew_swap_rejected(self, tmp_path):
        _, eng = self._engine()
        d = str(tmp_path)
        ckpt.publish_version(d, 1, {"params": _perturbed(_params(eng)), "rest": _rest(eng)})
        faults.skew_published_manifest(d, seed=11)
        ctl = serve.SwapController(eng, health_name="pub_skew")
        try:
            with pytest.raises(ckpt.PublicationSkewError):
                ctl.swap_from_publication(d)
            assert ctl.rejected == 1
        finally:
            ctl.close()
        assert eng.version == 0

    def test_canary_failure_auto_rolls_back(self):
        """New weights structurally fine, but the engine crashes serving
        them: the controller rolls back to the retained version."""
        telemetry.set_enabled(True)
        _, eng = self._engine()
        x = _x(8)
        old_out = eng.predict(x)
        proxy = faults.crash_engine_on_version(eng, 1)
        ctl = serve.SwapController(proxy, health_name="pub_crash")
        try:
            result = ctl.swap(_perturbed(_params(eng)), version=1, canary=x[:1])
        finally:
            ctl.close()
        assert result["outcome"] == "rolled_back"
        assert result["version"] == 0
        assert result["failed_version"] == 1
        assert eng.version == 0
        np.testing.assert_array_equal(old_out, proxy.predict(x))
        snap = telemetry.REGISTRY.snapshot()
        assert snap["counters"]["serve.rollbacks_total"] == 1
        assert snap["gauges"]["serve.version.active"] == 0

    def test_breaker_open_within_probe_window_rolls_back(self):
        _, eng = self._engine()
        breaker = _StubBreaker("closed")
        ctl = serve.SwapController(eng, breaker=breaker, probe_window_s=5.0,
                                   probe_poll_s=0.01, health_name="pub_brk")

        def open_soon():
            time.sleep(0.05)
            breaker.state = "open"

        th = threading.Thread(target=open_soon, daemon=True)
        try:
            th.start()
            t0 = time.monotonic()
            result = ctl.swap(_perturbed(_params(eng)), version=1)
            elapsed = time.monotonic() - t0
        finally:
            th.join(WAIT_S)
            ctl.close()
        assert result["outcome"] == "rolled_back"
        assert eng.version == 0
        assert elapsed < 5.0  # rolled back on the open, not the window

    def test_sigterm_mid_swap_aborts_cleanly(self):
        """Preemption inside the critical window (before commit) aborts
        the swap with the old version serving. The guard is installed
        first: SIGTERM's default handler would end the process."""
        from tpu_syncbn_torch.runtime.resilience import PreemptionGuard

        _, eng = self._engine()
        phases: list = []
        hook = faults.signal_at_phase("not_ready", signal.SIGTERM, calls=phases)
        with PreemptionGuard() as guard:
            ctl = serve.SwapController(eng, guard=guard, phase_hook=hook,
                                       health_name="pub_term")
            try:
                with pytest.raises(serve.SwapAbortedError):
                    ctl.swap(_perturbed(_params(eng)), version=1)
            finally:
                ctl.close()
            assert guard.preempted
        assert eng.version == 0
        assert eng.previous_version is None  # commit never happened
        assert phases[:3] == ["verify", "preflight", "not_ready"]
        assert "commit" not in phases

    def test_preempted_before_swap_never_starts(self):
        from tpu_syncbn_torch.runtime.resilience import PreemptionGuard

        _, eng = self._engine()
        with PreemptionGuard() as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.monotonic() + WAIT_S
            while not guard.preempted and time.monotonic() < deadline:
                time.sleep(0.001)
            assert guard.preempted
            ctl = serve.SwapController(eng, guard=guard, health_name="pub_pre")
            try:
                with pytest.raises(serve.SwapAbortedError):
                    ctl.swap(_perturbed(_params(eng)), version=1)
            finally:
                ctl.close()
        assert eng.version == 0

    def test_memwatch_contract_aborts_oversized_swap(self, tmp_path):
        """With a pinned contract the double buffer cannot fit: the
        controller fires mem_pressure and aborts cleanly."""
        telemetry.set_enabled(True)
        rec = flightrec.install(flightrec.FlightRecorder(
            cooldown_s=0.0, incident_dir=str(tmp_path / "incidents")))
        memwatch.install(memwatch.MemorySampler(contract_bytes_per_device=1,
                                                interval_s=3600.0))
        _, eng = self._engine()
        assert eng.params_nbytes() > 0
        ctl = serve.SwapController(eng, health_name="pub_mem")
        try:
            with pytest.raises(serve.SwapAbortedError):
                ctl.swap(_perturbed(_params(eng)), version=1)
        finally:
            ctl.close()
        assert eng.version == 0
        snap = telemetry.REGISTRY.snapshot()
        assert snap["counters"]["serve.swap_rejected_total"] == 1
        assert rec.last_incident is not None
        assert rec.last_incident["trigger"] == "mem_pressure"

    def test_manual_rollback(self):
        _, eng = self._engine()
        x = _x(8)
        old_out = eng.predict(x)
        ctl = serve.SwapController(eng, health_name="pub_man")
        try:
            ctl.swap(_perturbed(_params(eng)), version=1)
            result = ctl.rollback(reason="operator drill")
        finally:
            ctl.close()
        assert result["outcome"] == "rolled_back"
        assert eng.version == 0
        np.testing.assert_array_equal(old_out, eng.predict(x))

    def test_faulted_proxy_stays_swappable(self):
        _, eng = self._engine()
        proxy = faults.slow_engine(eng, 0.0)
        assert proxy.version == 0
        proxy.swap_params(_perturbed(_params(eng)), version=3)
        assert proxy.version == 3 and eng.version == 3
        assert proxy.rollback() == 0
        assert proxy.params_nbytes() == eng.params_nbytes()


# ----------------------------------------------------- trainer integration


class TestTrainerIntegration:
    def test_from_trainer_warns_toward_publication_path(self):
        """JAX warns on a mesh of more than one device; the port on a
        trainer of world above 1 (a duck-typed trainer here: a real one
        needs a process group), and not at world 1."""
        dp = _shared_dp()
        records: list = []
        handler = logging.Handler()
        handler.emit = records.append
        # the port's loggers do not propagate (dist.get_logger)
        logger = logging.getLogger("tpu_syncbn_torch.serve")
        logger.addHandler(handler)
        try:
            serve.InferenceEngine.from_trainer(dp, buckets=(8,))
            assert not records
            wide = types.SimpleNamespace(model=dp.model, device=dp.device,
                                         _layout=None, world=2)
            serve.InferenceEngine.from_trainer(wide, buckets=(8,))
        finally:
            logger.removeHandler(handler)
        msgs = [r.getMessage() for r in records if r.levelno >= logging.WARNING]
        assert any("publication path" in m and "swap_from_trainer" in m for m in msgs)

    def test_resilient_loop_publishes_at_cadence(self, tmp_path):
        from tpu_syncbn_torch.runtime.resilience import ResilientLoop

        dp = _trained_dp(steps=0)
        pub_dir = str(tmp_path / "pub")
        with ResilientLoop(dp, str(tmp_path / "ckpt"), ckpt_every=2,
                           publish_dir=pub_dir, publish_every=2) as loop:
            summary = loop.run(iter([_batch(s) for s in range(4)]))
        assert summary["steps"] == 4 and summary["publishes"] == 2
        assert ckpt.published_versions(pub_dir) == [2, 4]
        assert ckpt.published_version(pub_dir) == 4
        # the published tree hot-swaps into an engine built from the same
        # trainer: the whole cross-process path
        eng = serve.InferenceEngine.from_trainer(dp, buckets=(8,))
        ctl = serve.SwapController(eng, health_name="pub_loop")
        try:
            result = ctl.swap_from_publication(pub_dir)
        finally:
            ctl.close()
        assert result["outcome"] == "swapped" and result["version"] == 4

    def test_resilient_loop_async_publish(self, tmp_path):
        from tpu_syncbn_torch.runtime.resilience import ResilientLoop

        dp = _trained_dp(steps=0)
        pub_dir = str(tmp_path / "pub")
        with ResilientLoop(dp, str(tmp_path / "ckpt"), ckpt_every=2,
                           publish_dir=pub_dir, publish_every=2,
                           async_checkpoint=True) as loop:
            loop.run(iter([_batch(s) for s in range(2)]))
            assert loop.flush_checkpoints(timeout=60)
        assert ckpt.published_version(pub_dir) == 2

    def test_loop_arguments(self, tmp_path):
        """``publish_every`` defaults to ``ckpt_every`` and must be >= 1;
        ``autopilot=`` beside a publication directory is kept on the loop
        (``test_torch_autopilot.py`` drives it)."""
        from tpu_syncbn_torch.runtime.resilience import ResilientLoop

        dp = _shared_dp()
        loop = ResilientLoop(dp, str(tmp_path), ckpt_every=5, publish_dir=str(tmp_path))
        assert loop.publish_every == 5 and loop.publish_keep == 3
        with pytest.raises(ValueError, match="publish_every"):
            ResilientLoop(dp, str(tmp_path), publish_dir=str(tmp_path), publish_every=0)
        pilot = object()
        loop = ResilientLoop(dp, str(tmp_path), publish_dir=str(tmp_path), autopilot=pilot)
        assert loop.autopilot is pilot and loop.publish_dir == str(tmp_path)


# ------------------------------------------------------ parity with JAX


def _jax_pkg():
    from tpu_syncbn import serve as jserve
    from tpu_syncbn.obs import flightrec as jfr, memwatch as jmw, telemetry as jtel
    from tpu_syncbn.obs import server as jsrv, slo as jslo, timeseries as jts
    from tpu_syncbn.runtime import resilience as jres
    from tpu_syncbn.testing import faults as jfaults
    from tpu_syncbn.utils import checkpoint as jckpt

    return types.SimpleNamespace(serve=jserve, ckpt=jckpt, faults=jfaults, fr=jfr, mw=jmw,
                                 tel=jtel, srv=jsrv, slo=jslo, ts=jts, res=jres)


def _port_pkg():
    from tpu_syncbn_torch.obs import slo, timeseries
    from tpu_syncbn_torch.runtime import resilience

    return types.SimpleNamespace(serve=serve, ckpt=ckpt, faults=faults, fr=flightrec,
                                 mw=memwatch, tel=telemetry, srv=obs_server, slo=slo,
                                 ts=timeseries, res=resilience)


@pytest.fixture(scope="module")
def jax_net():
    """The JAX trainer on a 1-device mesh and its trained state, once."""
    from test_torch_serve import _jax_trained_net

    return _jax_trained_net()


def _jax_perturbed(params, eps):
    import jax

    done = [False]

    def bump(a):
        arr = np.asarray(a)
        if not done[0] and np.issubdtype(arr.dtype, np.floating):
            done[0] = True
            return jax.numpy.asarray(arr + eps)
        return a

    return jax.tree_util.tree_map(bump, params)


def _files(d: str) -> list[str]:
    return sorted(n.replace(".msgpack", ".pt") for n in os.listdir(d)) \
        if os.path.isdir(d) else []


def _store_script(p, root: str, tree) -> dict:
    """One store script: publications, pruning, each fault, the async
    worker. Returns what both packages must agree on."""
    out: dict = {}

    def load(d, **kw):
        try:
            return p.ckpt.load_published(d, tree, **kw)[1]
        except Exception as e:
            return type(e).__name__

    d = os.path.join(root, "pub")
    for v in (1, 2, 3, 4):
        p.ckpt.publish_version(d, v, tree, keep=2, step=10 * v)
    out["files"] = _files(d)
    ptr = p.ckpt.read_published_pointer(d)
    man = p.ckpt.read_published_manifest(d, 4)
    out["pointer"] = {k: v for k, v in ptr.items() if k not in ("tree_hash", "nbytes", "path")}
    out["pointer_keys"] = sorted(ptr)
    out["pointer_path"] = ptr["path"].replace(".msgpack", ".pt")
    out["manifest"] = {k: man[k] for k in ("format", "version", "step")}
    out["manifest_keys"] = sorted(man)
    out["load"] = load(d)
    for name, fault in (("truncate", lambda d: p.faults.corrupt_publication(d, "truncate")),
                        ("bitflip", lambda d: p.faults.corrupt_publication(d, "bitflip", seed=5)),
                        ("manifest", lambda d: p.faults.corrupt_publication(d, target="manifest")),
                        ("skew", lambda d: p.faults.skew_published_manifest(d, seed=3)),
                        ("injector", lambda d: p.faults.FaultInjector(4).corrupt_publication(d))):
        fd = os.path.join(root, name)
        p.ckpt.publish_version(fd, 1, tree)
        fault(fd)
        out[name] = (load(fd, expect_tree_hash=p.ckpt.read_published_pointer(fd)["tree_hash"]),
                     p.ckpt.published_version(fd), _files(fd))
    out["missing"] = load(os.path.join(root, "nothing"))
    with p.ckpt.AsyncCheckpointer(keep=3) as ac:
        ac.save(os.path.join(root, "ckpt"), 10, tree)
        ac.publish(os.path.join(root, "apub"), 11, tree)
        assert ac.flush(timeout=60)
    out["async"] = (p.ckpt.published_version(os.path.join(root, "apub")),
                    p.ckpt.read_published_manifest(os.path.join(root, "apub"), 11).get("step"),
                    _files(os.path.join(root, "apub")))
    return out


def test_store_script_matches_jax(tmp_path):
    """The same store script through both packages: the same file set (up
    to the payload's extension), pointer and manifest keys, versions and
    steps, and the same exception class for each fault."""
    results = []
    for name, p in (("port", _port_pkg()), ("jax", _jax_pkg())):
        p.tel.set_enabled(True)
        results.append(_store_script(p, str(tmp_path / name), _np_tree()))
        snap = p.tel.REGISTRY.snapshot()
        results[-1]["counters"] = {k: v for k, v in snap["counters"].items()
                                   if k.startswith("checkpoint.")}
    ours, theirs = results
    assert ours == theirs
    assert ours["files"] == ["published.json", "weights_v3.manifest.json", "weights_v3.pt",
                             "weights_v4.manifest.json", "weights_v4.pt"]
    assert ours["skew"][0] == "PublicationSkewError"
    assert ours["truncate"][0] == ours["manifest"][0] == "CheckpointCorruptError"


def _swap_script(p, eng, perturb, rest, x, root: str) -> dict:
    """One controller script over an engine: a clean swap, a publication,
    each rejected publication, a canary rollback, a manual rollback, a
    memwatch abort and a preempted swap, with a flight recorder, a
    windowed aggregator and ``publication_rules``. Returns what both
    packages must agree on."""
    p.tel.set_enabled(True)
    rec = p.fr.install(p.fr.FlightRecorder(cooldown_s=0.0,
                                           incident_dir=os.path.join(root, "inc")))
    agg = p.ts.WindowedAggregator(interval_s=1.0)
    tracker = p.slo.SLOTracker(agg, p.slo.publication_rules(windows_s=(2.0,)))
    agg.tick(now=0.0)
    steps: list = []
    flips: list = []

    def hook(phase):
        flips.append((phase, ctl.readiness()[0]))

    def step(name, fn):
        try:
            r = fn()
            steps.append((name, r["outcome"], r["version"], r.get("previous_version"),
                          r.get("failed_version"), r["source"], sorted(r)))
        except Exception as e:
            steps.append((name, type(e).__name__))

    d = os.path.join(root, "pub")
    ctl = p.serve.SwapController(eng, health_name="pub_parity", phase_hook=hook)
    try:
        step("swap", lambda: ctl.swap(perturb(1), version=1, canary=x[:1]))
        p.ckpt.publish_version(d, 2, {"params": perturb(2), "rest": rest()}, step=7)
        step("publication", lambda: ctl.swap_from_publication(d, canary=x[:1]))
        for v, fault in ((3, lambda: p.faults.corrupt_publication(d, "truncate")),
                         (4, lambda: p.faults.corrupt_publication(d, "bitflip", seed=7)),
                         (5, lambda: p.faults.corrupt_publication(d, target="manifest")),
                         (6, lambda: p.faults.skew_published_manifest(d, seed=11))):
            p.ckpt.publish_version(d, v, {"params": perturb(v), "rest": rest()})
            fault()
            step(f"publication_v{v}", lambda: ctl.swap_from_publication(d))
        step("missing", lambda: ctl.swap_from_publication(os.path.join(root, "none")))
        proxy = p.faults.crash_engine_on_version(eng, 8)
        with p.serve.SwapController(proxy, health_name="pub_parity_crash") as ctl2:
            step("canary", lambda: ctl2.swap(perturb(8), version=8, canary=x[:1]))
        step("manual", lambda: ctl.rollback(reason="drill"))
        sampler = p.mw.install(p.mw.MemorySampler(contract_bytes_per_device=1,
                                                  interval_s=3600.0))
        step("mem", lambda: ctl.swap(perturb(9), version=9))
        p.mw.uninstall()
        sampler.close()
        with p.res.PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
            os.kill(os.getpid(), signal.SIGUSR1)
            deadline = time.monotonic() + WAIT_S
            while not guard.preempted and time.monotonic() < deadline:
                time.sleep(0.001)
            with p.serve.SwapController(eng, guard=guard, health_name="pub_parity_pre") as ctl3:
                step("preempted", lambda: ctl3.swap(perturb(10), version=10))
        out = {"steps": steps, "flips": flips, "readiness": ctl.readiness()[1],
               "version": (eng.version, eng.previous_version)}
    finally:
        ctl.close()
        p.fr.uninstall()
        rec.close()
    agg.tick(now=1.0)
    out["slo"] = {name: {k: v[k] for k in ("firing", "burns")}
                  for name, v in tracker.evaluate(now=1.0).items()}
    snap = p.tel.REGISTRY.snapshot()
    out["counters"] = {k: v for k, v in snap["counters"].items()
                       if k.startswith(("serve.swap", "serve.rollback", "checkpoint."))}
    out["gauges"] = {k: v for k, v in snap["gauges"].items() if k.startswith("serve.version")}
    out["histograms"] = {k: v["count"] for k, v in snap["histograms"].items()
                         if k.startswith(("serve.swap", "checkpoint."))}
    # every key but the swap seconds' sum (a time)
    out["statusz"] = {k: v for k, v in p.srv.statusz_report()["publication"].items()
                      if k != "serve.swap_s.sum"}
    ring = rec.rings_snapshot()["serve"]
    out["ring"] = [(e["kind"], e.get("outcome"), e.get("reason")) for e in ring]
    kinds = []
    for name in sorted(os.listdir(os.path.join(root, "inc"))):
        with open(os.path.join(root, "inc", name)) as f:
            kinds.append(json.load(f)["trigger"]["kind"])
    out["bundles"] = sorted(kinds)
    out["files"] = _files(d)
    return out


def test_controller_script_matches_jax(jax_net, tmp_path):
    """The same controller script through both packages, the port's engine
    holding the JAX trainer's state: the same outcomes and exception
    classes, result keys, versions, readiness flips, counters, gauges,
    histogram counts, ``/statusz`` publication section, serve-ring
    entries, bundle triggers, files on disk and ``publication_rules``
    verdict (two rollbacks against one swap fire it)."""
    from tpu_syncbn import serve as jserve

    x = _x(8)
    jeng = jserve.InferenceEngine.from_trainer(jax_net[0], buckets=(8,))
    peng = serve.InferenceEngine.from_trainer(_trained_dp(steps=0, state=jax_net[1]),
                                              buckets=(8,))
    ours = _swap_script(_port_pkg(), peng, lambda v: _perturbed(_params(peng), 1e-3 * v),
                        lambda: _rest(peng), x, str(tmp_path / "port"))
    theirs = _swap_script(_jax_pkg(), jeng, lambda v: _jax_perturbed(jeng._params, 1e-3 * v),
                          lambda: jeng._rest, x, str(tmp_path / "jax"))
    assert ours == theirs
    assert [s[1] for s in ours["steps"]] == [
        "swapped", "swapped", "CheckpointCorruptError", "CheckpointCorruptError",
        "CheckpointCorruptError", "PublicationSkewError", "FileNotFoundError",
        "rolled_back", "rolled_back", "SwapAbortedError", "SwapAbortedError"]
    assert ours["slo"]["publication_rollbacks"]["firing"] is True
    assert ours["counters"]["serve.swap_rejected_total"] == 7


def test_predict_after_publication_matches_jax(jax_net, tmp_path):
    """The JAX engine's weights after its swap, carried into the port
    (``load_jax_params``), published and swapped in with
    ``swap_from_publication``: ``predict`` equals the JAX engine's below,
    at and past the bucket (chunked)."""
    from flax import nnx

    from test_torch_resnet import flat_state
    from tpu_syncbn import serve as jserve

    jeng = jserve.InferenceEngine.from_trainer(jax_net[0], buckets=(8,))
    jeng.swap_params(_jax_perturbed(jeng._params, 0.05), version=1)
    carried = flat_state(nnx.merge(jeng.graphdef, jeng._params, jeng._rest))
    src = nn.convert_sync_batchnorm(Net())
    models.load_jax_params(src, carried)
    d = str(tmp_path)
    ckpt.publish_version(d, 1, {"params": dict(src.named_parameters()),
                                "rest": dict(src.named_buffers())})
    eng = serve.InferenceEngine.from_trainer(_trained_dp(steps=1), buckets=(8,))
    with serve.SwapController(eng, health_name="pub_jax") as ctl:
        assert ctl.swap_from_publication(d)["version"] == 1
    for n in (1, 5, 8, 13):
        x = _x(n, seed=n)
        np.testing.assert_allclose(eng.predict(x), np.asarray(jeng.predict(x)), **TOL)


def test_exports_phases_and_fault_draws_match_jax(tmp_path):
    """``serve.__all__`` and ``SWAP_PHASES`` equal JAX's; a seeded
    ``FaultInjector`` draws the same publication faults (mode, flipped
    offset, bogus hash) in both packages; ``signal_at_phase`` refuses an
    unknown phase alike."""
    p, j = _port_pkg(), _jax_pkg()
    from tpu_syncbn.serve import publish as jpublish

    assert p.serve.__all__ == j.serve.__all__
    assert serve.SWAP_PHASES == jpublish.SWAP_PHASES
    draws = []
    for name, pkg in (("port", p), ("jax", j)):
        inj = pkg.faults.FaultInjector(13)
        got = []
        for i in range(4):
            d = str(tmp_path / f"{name}{i}")
            pkg.ckpt.publish_version(d, 1, _np_tree())
            got.append(inj.corrupt_publication(d) is not None)
            got.append(inj.skew_published_manifest(d))
        with pytest.raises(ValueError, match="at_phase"):
            pkg.faults.signal_at_phase("nowhere")
        draws.append(got)
    assert draws[0] == draws[1]


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_resilient_loop_publication_matches_jax(tmp_path, async_checkpoint):
    """The same ``ResilientLoop(publish_dir=, publish_every=2)`` run (4 SGD
    steps) in both packages from the same state: the same files, pointer
    and manifest keys, versions and steps, the same ``publishes`` count;
    each package's newest publication swapped into its own engine answers
    alike (rtol 2e-4 / atol 1e-5)."""
    from test_torch_serve import _jax_trained_net
    from tpu_syncbn.runtime.resilience import ResilientLoop as JLoop
    from tpu_syncbn_torch.runtime.resilience import ResilientLoop

    jdp, state = _jax_trained_net()
    pdp = _trained_dp(steps=0, state=state)
    x = _x(8)
    out = []
    for name, pkg, loop_cls, dp in (("port", _port_pkg(), ResilientLoop, pdp),
                                    ("jax", _jax_pkg(), JLoop, jdp)):
        pub = str(tmp_path / name / "pub")
        with loop_cls(dp, str(tmp_path / name / "ckpt"), ckpt_every=3, publish_dir=pub,
                      publish_every=2, publish_keep=1,
                      async_checkpoint=async_checkpoint) as loop:
            summary = loop.run(iter([_batch(s) for s in range(3, 7)]))
            assert loop.flush_checkpoints(timeout=60)
        ptr = pkg.ckpt.read_published_pointer(pub)
        man = pkg.ckpt.read_published_manifest(pub, ptr["version"])
        eng = pkg.serve.InferenceEngine.from_trainer(dp, buckets=(8,))
        with pkg.serve.SwapController(eng, health_name=f"pub_loop_{name}") as ctl:
            result = ctl.swap_from_publication(pub)
        out.append({"files": _files(pub), "pointer_keys": sorted(ptr),
                    "manifest_keys": sorted(man), "version": ptr["version"],
                    "step": (ptr.get("step"), man.get("step")),
                    "publishes": summary["publishes"], "result": sorted(result),
                    "predict": np.asarray(eng.predict(x))})
    ours, theirs = out
    np.testing.assert_allclose(ours.pop("predict"), theirs.pop("predict"), **TOL)
    assert ours == theirs
    assert ours["version"] == 4 and ours["publishes"] == 2
    assert ours["files"] == ["published.json", "weights_v4.manifest.json", "weights_v4.pt"]
