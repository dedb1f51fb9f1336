"""The port's resilience layer (``tpu_syncbn_torch.runtime.resilience``)
against the cases of tests/test_resilience.py and of
tests/test_scan_driver.py's ``TestResilientLoopScan`` where the port has
the feature: deterministic backoff, the preemption flag and its handlers,
the watchdog's diagnostics, ``stall_guard``, the event counters, and
``ResilientLoop`` — chunked (``scan_steps``) against the step loop, a
SIGTERM in the middle of a chunk checkpointing at its boundary, the async
writer stopped by ``close()``, a flush error that must not mask the
loop's own failure, ``restore_last_good`` at a chunk boundary, and the
constructor arguments of the publication and autopilot hooks. Where a case
counts a trigger (a stall, a divergence restore), it also checks that an
installed flight recorder dumps exactly one bundle for it
(``obs.flightrec``).

The trainer is the JAX tests' ``Net`` (Linear(8, 8) then SyncBN) with
SGD(0.1, momentum 0.9) on the CPU; a chunked run equals the step loop
within rtol 2e-4 / atol 1e-5 (tests/test_torch_scan_driver.py says why).
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import nn, parallel
from tpu_syncbn_torch.obs import telemetry
from tpu_syncbn_torch.obs.telemetry import CounterGroup
from tpu_syncbn_torch.parallel import scan_driver
from tpu_syncbn_torch.runtime import resilience
from tpu_syncbn_torch.testing import faults
from tpu_syncbn_torch.utils import checkpoint as ckpt

NET = dict(rtol=2e-4, atol=1e-5)


class TestBackoff:
    def test_delays_deterministic_for_key(self):
        a = resilience.backoff_delays(5, base_s=1.0, key="host0")
        assert a == resilience.backoff_delays(5, base_s=1.0, key="host0")
        assert len(a) == 4

    def test_jitter_differs_across_keys(self):
        assert (resilience.backoff_delays(5, base_s=1.0, key="host0")
                != resilience.backoff_delays(5, base_s=1.0, key="host1"))

    def test_exponential_capped_and_bounded_jitter(self):
        delays = resilience.backoff_delays(6, base_s=1.0, max_s=4.0, jitter=0.25, key="k")
        for i, d in enumerate(delays):
            nominal = min(4.0, 2.0 ** i)
            assert nominal * 0.75 <= d <= nominal * 1.25

    def test_retry_succeeds_after_failures(self):
        calls, sleeps = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("coordinator not up")
            return "joined"

        out = resilience.retry_with_backoff(flaky, attempts=4, base_s=0.5, key="h",
                                            sleep=sleeps.append)
        assert out == "joined" and len(calls) == 3
        assert sleeps == resilience.backoff_delays(4, base_s=0.5, key="h")[:2]

    def test_retry_exhaustion_reraises_last(self):
        def always():
            raise TimeoutError("never")

        with pytest.raises(TimeoutError, match="never"):
            resilience.retry_with_backoff(always, attempts=3, base_s=0.01,
                                          sleep=lambda s: None)

    def test_retry_does_not_catch_unlisted(self):
        def boom():
            raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            resilience.retry_with_backoff(boom, attempts=5, sleep=lambda s: None)


class TestPreemptionGuard:
    def test_flag_set_and_handlers_restored(self):
        before = signal.getsignal(signal.SIGUSR1)
        with resilience.PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
            assert not g.preempted
            os.kill(os.getpid(), signal.SIGUSR1)
            assert g.wait(2) and g.preempted
        assert signal.getsignal(signal.SIGUSR1) is before

    def test_callback_and_subscribers_invoked(self):
        got, sub = [], []
        with resilience.PreemptionGuard(signals=(signal.SIGUSR1,),
                                        callback=got.append) as g:
            g.subscribe(sub.append)
            g.subscribe(lambda s: 1 / 0)  # a broken listener is swallowed
            os.kill(os.getpid(), signal.SIGUSR1)
            g.wait(2)
        assert got == sub == [signal.SIGUSR1] and g.signum == signal.SIGUSR1

    def test_second_signal_goes_to_the_previous_handler(self):
        seen = []
        prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
        try:
            with resilience.PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
                os.kill(os.getpid(), signal.SIGUSR1)
                assert g.wait(2) and not seen
                os.kill(os.getpid(), signal.SIGUSR1)  # the operator means it
                time.sleep(0.1)
            assert seen == [signal.SIGUSR1]
        finally:
            signal.signal(signal.SIGUSR1, prev)

    def test_outside_the_main_thread_raises(self):
        errs = []

        def run():
            try:
                with resilience.PreemptionGuard(signals=(signal.SIGUSR1,)):
                    pass
            except ValueError as e:
                errs.append(e)

        t = threading.Thread(target=run)
        t.start()
        t.join()
        assert errs


class TestWatchdog:
    def test_stall_dumps_diagnostics_and_fires_callback(self):
        stalls = []
        with resilience.Watchdog(0.15, name="unit", on_stall=stalls.append) as w:
            time.sleep(0.6)
        assert w.stall_count >= 1
        assert stalls and "WATCHDOG" in stalls[0]
        assert "thread" in stalls[0]  # per-thread stacks present

    def test_pat_keeps_it_quiet(self):
        stalls = []
        with resilience.Watchdog(0.3, on_stall=stalls.append) as w:
            for _ in range(6):
                time.sleep(0.05)
                w.pat()
        assert w.stall_count == 0 and not stalls

    def test_one_dump_per_stall_not_per_poll(self, tmp_path):
        from tpu_syncbn_torch.obs import flightrec

        rec = flightrec.install(flightrec.FlightRecorder(
            incident_dir=str(tmp_path), cooldown_s=0.0))
        stalls = []
        try:
            with resilience.Watchdog(0.1, on_stall=stalls.append, poll_s=0.02) as w:
                time.sleep(0.5)
        finally:
            flightrec.uninstall()
            rec.close()
        assert w.stall_count == 1 == len(stalls)
        # one watchdog_stall bundle for the one stall, even with no cooldown
        assert rec.counters.count("bundles") == 1
        assert rec.last_incident["trigger"] == "watchdog_stall"

    def test_start_unarmed_waits_for_first_pat(self):
        stalls = []
        with resilience.Watchdog(0.15, on_stall=stalls.append, start_armed=False,
                                 poll_s=0.02) as w:
            time.sleep(0.5)           # cold start (kernels built): no stall
            assert w.stall_count == 0
            w.pat()                   # armed now
            time.sleep(0.5)           # idle past the deadline: a real stall
        assert w.stall_count == 1 and len(stalls) == 1

    def test_abandoned_stall_guard_stops_pulling_source(self):
        pulled = []

        def source():
            for i in range(100):
                pulled.append(i)
                yield i

        g = resilience.stall_guard(source(), deadline_s=5)
        assert next(g) == 0
        g.close()  # the consumer abandons it
        time.sleep(0.5)
        assert len(pulled) <= 3

    def test_rejects_bad_deadline(self):
        with pytest.raises(ValueError, match="deadline"):
            resilience.Watchdog(0)
        with pytest.raises(ValueError, match="deadline"):
            next(resilience.stall_guard(iter([1]), deadline_s=0))

    def test_dump_stacks_mentions_host_identity(self):
        d = resilience.dump_stacks("hdr")
        assert d.startswith("hdr")
        assert "host 0/1" in d and f"pid {os.getpid()}" in d
        assert "--- thread MainThread ---" in d


class TestCounterGroup:
    def test_bump_count_summary(self):
        c = CounterGroup("resilience")
        assert c.count("x") == 0
        assert c.bump("x") == 1
        assert c.bump("x", 2) == 3
        c.bump("y")
        assert c.summary() == {"x": 3, "y": 1}
        assert "CounterGroup" in repr(c)

    def test_thread_safety(self):
        c = CounterGroup()

        def work():
            for _ in range(1000):
                c.bump("n")

        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert c.count("n") == 8000


# -- ResilientLoop ---------------------------------------------------------------


class Net(torch.nn.Module):
    """The JAX scan tests' Net: Linear(8, 8) then BatchNorm1d(8)."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc = torch.nn.Linear(8, 8)
        with torch.no_grad():
            for p in self.fc.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        self.bn = nn.BatchNorm1d(8, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def mse_loss(m, b):
    return (m(b) ** 2).mean()


def build_dp(**kw):
    model = nn.convert_sync_batchnorm(Net())
    return parallel.DataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1,
                                                        momentum=0.9),
                                 mse_loss, device="cpu", **kw)


def make_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(16, 8).astype(np.float32)) for _ in range(n)]


def chunks_of(batches, k):
    return [scan_driver.stack_batches(batches[i:i + k])
            for i in range(0, len(batches), k)]


def assert_state_matches(a, b):
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=k, **NET)


class TestResilientLoopValidation:
    def test_rejects_bad_ckpt_every_and_scan_steps(self, tmp_path):
        with pytest.raises(ValueError, match="ckpt_every"):
            resilience.ResilientLoop(object(), str(tmp_path), ckpt_every=0)
        with pytest.raises(ValueError, match="scan_steps"):
            resilience.ResilientLoop(object(), str(tmp_path), scan_steps=0)

    @pytest.mark.parametrize("kw,item", [(dict(publish_dir="p"), "A.12"),
                                         (dict(publish_every=5), "A.12"),
                                         (dict(autopilot=object()), "A.14")])
    def test_unported_hooks_raise_naming_their_item(self, tmp_path, kw, item):
        """The hooks of later items, all ported since, construct the loop
        with their settings: the publication arguments (A.12;
        ``publish_every`` defaults to ``ckpt_every``; ``test_torch_publish.py``
        drives them) and the autopilot (A.14a; ``test_torch_autopilot.py``
        drives it)."""
        if item == "A.14":
            loop = resilience.ResilientLoop(object(), str(tmp_path), **kw)
            assert loop.autopilot is kw["autopilot"]
            return
        loop = resilience.ResilientLoop(object(), str(tmp_path), ckpt_every=7, **kw)
        assert loop.publish_dir == kw.get("publish_dir")
        assert loop.publish_every == kw.get("publish_every", 7) and loop.publish_keep == 3

    def test_trainer_rejects_bad_guard_policy(self):
        with pytest.raises(ValueError, match="divergence_guard"):
            build_dp(divergence_guard="explode")


class TestResilientLoopScan:
    def test_chunked_loop_matches_step_loop(self, tmp_path):
        batches = make_batches(4, seed=6)
        dp_ref = build_dp()
        for b in batches:
            dp_ref.train_step(b)
        dp = build_dp()
        loop = resilience.ResilientLoop(dp, str(tmp_path / "ck"), ckpt_every=2,
                                        keep=5, scan_steps=2)
        summary = loop.run(chunks_of(batches, 2))
        assert summary["steps"] == 4 and summary["step"] == 4
        assert_state_matches(dp, dp_ref)
        # ckpt_every=2 crossed at steps 2 and 4: one save per crossing
        assert ckpt.verified_steps(str(tmp_path / "ck")) == [2, 4]
        assert summary["checkpoints"] == 2

    def test_sigterm_mid_chunk_checkpoints_at_boundary(self, tmp_path):
        """The in-flight chunk's K steps complete (one program), then the
        loop checkpoints at the chunk boundary and exits preempted; with
        async checkpointing the write is durable when run() returns."""
        batches = make_batches(4, seed=7)
        dp_ref = build_dp()
        for b in batches:
            dp_ref.train_step(b)
        dp = build_dp()
        ckdir = str(tmp_path / "ck")
        loop = resilience.ResilientLoop(dp, ckdir, ckpt_every=100, scan_steps=2,
                                        async_checkpoint=True)
        summary = loop.run(faults.signal_at(iter(chunks_of(batches, 2)), at_step=1))
        assert summary["preempted"] is True
        assert summary["step"] == 4  # the signalled chunk still ran
        assert ckpt.verified_steps(ckdir) == [4]
        state, step = ckpt.load_checkpoint(ckdir, dp.state_dict())
        assert step == 4
        for k, v in dp_ref.model.named_parameters():
            np.testing.assert_allclose(state["params"][k].numpy(), v.detach().numpy(),
                                       err_msg=k, **NET)
        loop.close()

    def test_close_stops_async_worker(self, tmp_path):
        dp = build_dp()
        ckdir = str(tmp_path / "ck")
        with resilience.ResilientLoop(dp, ckdir, ckpt_every=1,
                                      async_checkpoint=True) as loop:
            loop.run(iter(make_batches(1, seed=12)))
        assert loop._async._closed
        assert not loop._async._thread.is_alive()
        assert ckpt.verified_steps(ckdir) == [1]
        loop.close()  # idempotent

    def test_flush_error_does_not_mask_primary_failure(self, tmp_path):
        """A background write failure surfacing in run()'s cleanup must not
        replace the loop's own failure; the flush error is logged (and
        consumed) instead."""
        dp = build_dp()
        blocked = tmp_path / "ck"
        blocked.write_text("a file where the directory should go")

        class Boom(RuntimeError):
            pass

        def batches():
            yield from make_batches(1, seed=13)
            raise Boom("primary training failure")

        with resilience.ResilientLoop(dp, str(blocked), ckpt_every=1,
                                      async_checkpoint=True) as loop:
            with pytest.raises(Boom):
                loop.run(batches())
            assert loop.flush_checkpoints(timeout=30)

    def test_a_flush_error_on_a_clean_exit_raises(self, tmp_path):
        """Returning over a failed boundary write would claim durability it
        lacks."""
        dp = build_dp()
        blocked = tmp_path / "ck"
        blocked.write_text("not a directory")
        with resilience.ResilientLoop(dp, str(blocked), ckpt_every=1,
                                      async_checkpoint=True) as loop:
            with pytest.raises(RuntimeError, match="async checkpoint write"):
                loop.run(iter(make_batches(1, seed=14)))

    def test_restore_last_good_at_chunk_boundary(self, tmp_path):
        from tpu_syncbn_torch.obs import flightrec, incident

        batches = make_batches(6, seed=8)
        batches[3] = torch.full_like(batches[3], float("nan"))  # inside chunk 1
        dp = build_dp(divergence_guard="restore_last_good")
        ckdir = str(tmp_path / "ck")
        loop = resilience.ResilientLoop(dp, ckdir, ckpt_every=2, keep=5, scan_steps=2)
        rec = flightrec.install(flightrec.FlightRecorder(
            incident_dir=str(tmp_path / "incidents"), cooldown_s=0.0))
        telemetry.set_enabled(True)  # the numerics publisher publishes
        try:
            summary = loop.run(chunks_of(batches, 2))
        finally:
            telemetry.set_enabled(None)
            flightrec.uninstall()
            rec.close()
        bundles = [incident.load_bundle(os.path.join(rec.incident_dir, p))
                   for p in sorted(os.listdir(rec.incident_dir))]
        # one divergence_restore bundle; the NaN step is its chunk's last,
        # so the publisher's drift check fires too (a bundle a non-finite
        # monitor: no cooldown here)
        kinds = [b["trigger"]["kind"] for b in bundles]
        assert kinds.count("divergence_restore") == 1
        assert set(kinds) == {"divergence_restore", "numerics_drift"}
        # the divergence_restore bundle's step ring holds the finite chunk
        # before the fault and the faulty chunk's final step (the NaN)
        (bundle,) = [b for b in bundles if b["trigger"]["kind"] == "divergence_restore"]
        assert bundle["trigger"]["detail"] == {"step": 4, "restored_step": 2}
        ring = bundle["rings"]["steps"]
        assert [e["step"] for e in ring] == [2, 4]
        assert np.isfinite(ring[0]["metrics"]["loss"]) and ring[0]["metrics"]["nonfinite"] == 0.0
        assert ring[1]["metrics"]["loss"] == "nan" and ring[1]["metrics"]["nonfinite"] == 1.0
        assert not loop.recovering  # the next finite chunk completed the rollback
        # chunk 1 held the NaN step: the last verified checkpoint (step 2)
        # came back at the chunk boundary, then chunk 2 ran from it
        assert summary["nonfinite_steps"] == 1
        assert summary["divergence_restores"] == 1
        assert summary["step"] == 4 and summary["steps"] == 6
        assert ckpt.verified_steps(ckdir) == [2, 4]
        assert all(bool(torch.isfinite(p).all()) for p in dp.model.parameters())

    def test_step_deadline_scales_with_the_chunk(self, tmp_path):
        seen = []

        class Spy(resilience.Watchdog):
            def __init__(self, deadline_s, **kw):
                seen.append(deadline_s)
                super().__init__(deadline_s, **kw)

        dp = build_dp()
        orig = resilience.Watchdog
        resilience.Watchdog = Spy
        try:
            loop = resilience.ResilientLoop(dp, str(tmp_path), step_deadline_s=30.0,
                                            scan_steps=2)
            loop.run(chunks_of(make_batches(2), 2))
        finally:
            resilience.Watchdog = orig
        assert seen == [60.0]


# -- the ImageNet example's --scan-steps, --data-deadline and preemption ---------

EXAMPLE = ["--device", "cpu", "--image-size", "32", "--dataset-size", "32",
           "--batch-size", "8", "--num-classes", "10", "--dtype", "f32"]


def test_imagenet_example_scan_steps_and_data_deadline_on_the_cpu():
    """``--scan-steps 2`` feeds 2-stacked chunks to train_steps_batches:
    4 steps in 2 chunks, the schedule stepped 4 times, a finite loss, under
    a ``--data-deadline`` that a healthy loader never trips. (The chunk's
    arithmetic against ``train_step`` is pinned in
    tests/test_torch_scan_driver.py; this 32-image ResNet-50 is chaotic
    enough that one ulp on one weight tensor moves its fourth loss by ~5 %.)"""
    from tpu_syncbn_torch import imagenet_resnet50 as ex

    one = ex.main(EXAMPLE + ["--epochs", "1"])
    fused = ex.main(EXAMPLE + ["--epochs", "1", "--scan-steps", "2",
                               "--data-deadline", "60"])
    assert fused["steps"] == one["steps"] == 4 and not fused["preempted"]
    assert len(fused["step_s"]) == len(fused["data_wait_s"]) == 2  # two chunks
    assert np.isfinite(fused["loss"]) and 0.0 <= fused["final_top1"] <= 1.0


def test_imagenet_example_checkpoints_the_epoch_on_sigterm_and_resumes(tmp_path,
                                                                        monkeypatch):
    """SIGTERM before the second chunk of epoch 1: that chunk finishes, the
    example checkpoints tagged with epoch 1 and returns (exit 0)
    preempted; ``--resume`` replays epoch 1 from that state."""
    from tpu_syncbn_torch import imagenet_resnet50 as ex

    real = ex.tdata.device_prefetch
    calls = []

    def prefetch(it, **kw):
        calls.append(kw.get("scan_steps"))
        out = real(it, **kw)
        return faults.signal_at(out, at_step=1) if len(calls) == 2 else out

    monkeypatch.setattr(ex.tdata, "device_prefetch", prefetch)
    args = EXAMPLE + ["--epochs", "2", "--scan-steps", "2", "--ckpt-dir", str(tmp_path)]
    out = ex.main(args)
    assert out["preempted"] and out["steps"] == 8
    assert ckpt.verified_steps(str(tmp_path)) == [1]
    monkeypatch.setattr(ex.tdata, "device_prefetch", real)
    again = ex.main(args + ["--resume"])
    assert again["start_epoch"] == 1 and again["steps"] == 8 and not again["preempted"]
    assert ckpt.verified_steps(str(tmp_path)) == [1, 2]
