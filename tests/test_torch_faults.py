"""The fault matrix of tests/test_faults.py on the port: every injected
failure (``tpu_syncbn_torch.testing.faults``, seeded, no wall-clock
randomness) against the recovery the port documents — corrupt or
bit-flipped checkpoints fall back to the newest verified one, a killed
loader worker surfaces as ``WorkerError``, SIGTERM checkpoints at a step
boundary and two fresh trainers resume it identically, NaN batches under
the three guard policies (``restore_last_good`` through
``ResilientLoop``, with its thrash bound), and stalled batches against
``stall_guard``. Not ported here: the multi-host agreement cases (the
port's are in tests/test_torch_checkpoint.py) and ZeRO (ROADMAP A.10).

The trainer is the JAX tests' TinyNet (Linear(4, 4) then SyncBN) with
Adam(1e-2) on the CPU. This module imports no JAX: the loader's spawned
workers import it to unpickle ``RangeDataset``.
"""

import gc
import os
import time
import weakref

import numpy as np
import pytest
import torch

from tpu_syncbn_torch import nn, parallel, utils
from tpu_syncbn_torch.data.loader import DataLoader, WorkerError
from tpu_syncbn_torch.runtime import resilience
from tpu_syncbn_torch.testing import faults
from tpu_syncbn_torch.utils import checkpoint as ckpt
from tpu_syncbn_torch.utils.checkpoint import CheckpointCorruptError


class TinyNet(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc = torch.nn.Linear(4, 4)
        with torch.no_grad():
            for p in self.fc.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        self.bn = nn.BatchNorm1d(4, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def loss_fn(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def make_batch(seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(16, 4).astype(np.float32)),
            torch.from_numpy(rng.randn(16, 4).astype(np.float32)))


def make_trainer(seed=0, **kw):
    model = nn.convert_sync_batchnorm(TinyNet(seed))
    return parallel.DataParallel(model, torch.optim.Adam(model.parameters(), lr=1e-2),
                                 loss_fn, device="cpu", **kw)


def snap(dp) -> dict:
    return {k: v.detach().clone() for k, v in dp.model.named_parameters()}


def params_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


class RangeDataset:
    """Module-level (spawn-picklable) dataset for process-worker tests."""

    def __init__(self, n=64):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.float32)


# ---------------------------------------------------------------------------
# checkpoint corruption


class TestCorruptCheckpoint:
    def _two_checkpoints(self, d):
        dp = make_trainer()
        batch = make_batch()
        dp.train_step(batch)
        ckpt.save_checkpoint(d, 1, dp.state_dict())
        good = snap(dp)
        dp.train_step(batch)
        ckpt.save_checkpoint(d, 2, dp.state_dict())
        return dp, good

    def test_truncated_newest_falls_back_to_verified(self, tmp_path):
        d = str(tmp_path)
        _, good_step1 = self._two_checkpoints(d)
        faults.corrupt_checkpoint(d, 2, "truncate")
        assert not ckpt.verify_checkpoint(d, 2)
        assert ckpt.verified_steps(d) == [1]
        dp2 = make_trainer(seed=9)
        restored, step = utils.load_checkpoint(d, dp2.state_dict())
        assert step == 1  # newest VERIFIED, not newest
        dp2.load_state_dict(restored)
        params_equal(snap(dp2), good_step1)

    def test_bitflipped_newest_falls_back_to_verified(self, tmp_path):
        d = str(tmp_path)
        _, good_step1 = self._two_checkpoints(d)
        faults.corrupt_checkpoint(d, 2, "bitflip", seed=123)
        assert not ckpt.verify_checkpoint(d, 2)
        dp2 = make_trainer(seed=9)
        restored, step = utils.load_checkpoint(d, dp2.state_dict())
        assert step == 1
        dp2.load_state_dict(restored)
        params_equal(snap(dp2), good_step1)

    def test_bitflip_is_deterministic_by_seed(self, tmp_path):
        p1, p2 = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
        for p in (p1, p2):
            with open(p, "wb") as f:
                f.write(bytes(range(256)) * 8)
        assert faults.bitflip_file(p1, seed=7) == faults.bitflip_file(p2, seed=7)
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            assert f1.read() == f2.read()

    def test_all_corrupt_raises_loudly(self, tmp_path):
        d = str(tmp_path)
        self._two_checkpoints(d)
        faults.corrupt_checkpoint(d, 1, "truncate")
        faults.corrupt_checkpoint(d, 2, "bitflip")
        with pytest.raises(CheckpointCorruptError, match="failed verification"):
            utils.load_checkpoint(d, make_trainer().state_dict())

    def test_explicit_corrupt_step_raises_not_falls_back(self, tmp_path):
        d = str(tmp_path)
        self._two_checkpoints(d)
        faults.corrupt_checkpoint(d, 2, "truncate")
        with pytest.raises(CheckpointCorruptError, match="step 2"):
            utils.load_checkpoint(d, make_trainer().state_dict(), step=2)

    def test_resume_latest_skips_corrupt(self, tmp_path):
        d = str(tmp_path)
        _, good_step1 = self._two_checkpoints(d)
        faults.corrupt_checkpoint(d, 2, "truncate")
        dp2 = make_trainer(seed=5)
        assert parallel.resume_latest(dp2, d) == 1
        params_equal(snap(dp2), good_step1)

    def test_resume_latest_empty_dir_is_fresh_start(self, tmp_path):
        assert parallel.resume_latest(make_trainer(), str(tmp_path / "none")) == 0

    def test_bad_mode_and_empty_file_raise(self, tmp_path):
        self._two_checkpoints(str(tmp_path))
        with pytest.raises(ValueError, match="mode"):
            faults.corrupt_checkpoint(str(tmp_path), 1, "shred")
        empty = tmp_path / "empty.bin"
        empty.write_bytes(b"")
        with pytest.raises(ValueError, match="empty"):
            faults.bitflip_file(str(empty))
        p = tmp_path / "t.bin"
        p.write_bytes(b"x" * 100)
        assert faults.truncate_file(str(p), keep_bytes=10) == 10
        assert os.path.getsize(p) == 10


class TestFaultInjector:
    def test_a_seed_gives_a_reproducible_sequence(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TPU_SYNCBN_FAULT_SEED", "11")
        assert faults.fault_seed() == 11
        offs = []
        for run in ("a", "b"):
            inj = faults.FaultInjector()
            assert inj.seed == 11
            got = []
            for i in range(3):
                p = tmp_path / f"{run}{i}.bin"
                p.write_bytes(bytes(range(256)) * 4)
                got.append((inj.bitflip_file(str(p)), inj.truncate_file(str(p))))
            offs.append(got)
        assert offs[0] == offs[1]

    def test_corrupt_checkpoint_through_the_injector(self, tmp_path):
        d = str(tmp_path)
        dp = make_trainer()
        dp.train_step(make_batch())
        ckpt.save_checkpoint(d, 1, dp.state_dict())
        faults.FaultInjector(3).corrupt_checkpoint(d, 1)
        assert not ckpt.verify_checkpoint(d, 1)


# ---------------------------------------------------------------------------
# worker kill


class TestWorkerKill:
    def test_killed_worker_surfaces_not_hangs(self):
        loader = DataLoader(RangeDataset(64), batch_size=4, num_workers=2,
                            worker_type="process")
        it = iter(loader)
        next(it)  # the pool is live
        faults.kill_loader_worker(loader, wid=0)
        with pytest.raises(WorkerError, match="died"):
            for _ in range(64):
                next(it)
        loader.close()
        loader.close()  # idempotent double close

    def test_abandoned_loader_reaps_workers_via_finalizer(self):
        loader = DataLoader(RangeDataset(8), batch_size=4, num_workers=1,
                            worker_type="process")
        it = iter(loader)
        next(it)
        procs = loader._pool["procs"]
        fin = loader._pool_finalizer
        assert isinstance(fin, weakref.finalize) and fin.alive
        del it, loader  # dropped WITHOUT close()
        gc.collect()
        assert not fin.alive
        deadline = time.monotonic() + 10
        while any(p.is_alive() for p in procs):
            assert time.monotonic() < deadline, "workers were orphaned"
            time.sleep(0.05)

    def test_a_loader_without_a_pool_refuses(self):
        with pytest.raises(ValueError, match="process pool"):
            faults.kill_loader_worker(DataLoader(RangeDataset(8), batch_size=4))


# ---------------------------------------------------------------------------
# SIGTERM (preemption)


class TestPreemption:
    def test_sigterm_checkpoints_at_boundary_and_resumes_identically(self, tmp_path):
        d = str(tmp_path)
        dp = make_trainer()
        batch = make_batch()
        loop = resilience.ResilientLoop(dp, d, ckpt_every=100)
        # SIGTERM right before batch 3: the loop finishes that step (step
        # 4) and checkpoints at its boundary
        summary = loop.run(faults.signal_at(iter([batch] * 10), at_step=3))
        assert summary["preempted"] is True
        assert summary["steps"] == 4
        assert ckpt.verified_steps(d) == [summary["step"]]
        saved = snap(dp)
        # two fresh trainers of the restarted job resume the same state
        resumed = []
        for seed in (7, 8):
            dp_r = make_trainer(seed=seed)
            assert resilience.ResilientLoop(dp_r, d).resume() == summary["step"]
            resumed.append(dp_r)
        params_equal(snap(resumed[0]), saved)
        params_equal(snap(resumed[0]), snap(resumed[1]))
        out = resumed[0].train_step(batch)
        assert np.isfinite(float(out.loss))

    def test_second_signal_is_not_swallowed(self):
        with resilience.PreemptionGuard(signals=(resilience.signal.SIGUSR1,)) as g:
            os.kill(os.getpid(), resilience.signal.SIGUSR1)
            assert g.wait(2)
            assert g.preempted and g.signum == resilience.signal.SIGUSR1

    def test_sigterm_self_reaches_the_guard(self):
        with resilience.PreemptionGuard() as g:
            faults.sigterm_self()
            assert g.wait(2) and g.signum == resilience.signal.SIGTERM


# ---------------------------------------------------------------------------
# NaN gradient


class TestNaNGradient:
    def test_poison_nan_nanifies_float_leaves_only(self):
        x, y = make_batch()
        batch = {"x": x, "n": torch.arange(3), "a": np.ones(2, np.float32)}
        out = list(faults.poison_nan(iter([batch, batch]), 1))
        assert out[0] is batch
        assert bool(torch.isnan(out[1]["x"]).all()) and np.isnan(out[1]["a"]).all()
        assert torch.equal(out[1]["n"], torch.arange(3))
        sel = next(faults.poison_nan(iter([1]), 0, leaf_selector=lambda b: b + 1))
        assert sel == 2

    def test_skip_step_never_pollutes_params(self):
        dp = make_trainer(divergence_guard="skip_step")
        batch = make_batch()
        dp.train_step(batch)
        before = snap(dp)
        out = dp.train_step(next(faults.poison_nan(iter([batch]), 0)))
        assert float(out.metrics["nonfinite"]) == 1.0
        params_equal(snap(dp), before)
        # the optimizer state rolled back too: the next finite step equals
        # that of a trainer that never saw the NaN batch
        control = make_trainer(divergence_guard="skip_step")
        control.train_step(batch)
        assert float(dp.train_step(batch).loss) == float(control.train_step(batch).loss)

    def test_halve_lr_decays_scale_per_event(self):
        dp = make_trainer(divergence_guard="halve_lr")
        batch = make_batch()
        poisoned = list(faults.poison_nan(iter([batch] * 4), 1))
        poisoned = list(faults.poison_nan(iter(poisoned), 2))
        for b in poisoned:
            out = dp.train_step(b)
        assert dp.guard_state == {"lr_scale": 0.25, "nonfinite_count": 2}
        assert np.isfinite(float(out.loss))

    def test_restore_last_good_reloads_checkpoint(self, tmp_path):
        d = str(tmp_path)
        dp = make_trainer(divergence_guard="restore_last_good")
        batch = make_batch()
        loop = resilience.ResilientLoop(dp, d, ckpt_every=2)
        loop.run(iter([batch] * 4))  # checkpoints at steps 2 and 4
        good = snap(dp)
        summary = loop.run(faults.poison_nan(iter([batch] * 3), 1))
        assert summary["divergence_restores"] == 1
        assert summary["nonfinite_steps"] == 1
        dp_ref = make_trainer(seed=3, divergence_guard="restore_last_good")
        assert parallel.resume_latest(dp_ref, d) >= 4
        # the restore put step 4's state back; one finite step after it
        assert summary["step"] == 5
        assert not all(torch.equal(a, b) for a, b in zip(good.values(), snap(dp).values()))

    def test_restore_last_good_without_checkpoint_degrades_to_skip(self, tmp_path):
        dp = make_trainer(divergence_guard="restore_last_good")
        batch = make_batch()
        loop = resilience.ResilientLoop(dp, str(tmp_path), ckpt_every=100)
        summary = loop.run(faults.poison_nan(iter([batch] * 3), 1))
        assert summary["steps"] == 3 and summary["step"] == 3
        assert summary.get("divergence_restores", 0) == 0
        assert summary["divergence_skips_without_checkpoint"] == 1
        assert np.isfinite(float(dp.train_step(batch).loss))

    def test_restore_last_good_bounds_thrash(self, tmp_path):
        d = str(tmp_path)
        dp = make_trainer(divergence_guard="restore_last_good")
        batch = make_batch()
        loop = resilience.ResilientLoop(dp, d, ckpt_every=1, max_restores=2)
        loop.run(iter([batch] * 2))

        def always_nan():
            while True:
                yield next(faults.poison_nan(iter([batch]), 0))

        with pytest.raises(FloatingPointError, match="refusing to thrash"):
            loop.run(always_nan())
        assert loop.counters.count("divergence_restores") == 2


# ---------------------------------------------------------------------------
# stalled batch


class TestStalledBatch:
    def test_stall_guard_raises_within_deadline(self):
        batch = make_batch()
        delayed = faults.delay_batch(iter([batch] * 5), at_step=2, delay_s=10.0)
        guarded = resilience.stall_guard(delayed, deadline_s=0.5, name="test-batch")
        t0 = time.monotonic()
        with pytest.raises(resilience.StallError, match="deadline"):
            for _ in guarded:
                pass
        assert time.monotonic() - t0 < 5.0  # bounded, nowhere near 10 s

    def test_stall_guard_transparent_when_healthy(self):
        items = [1, 2, 3]
        assert list(resilience.stall_guard(iter(items), deadline_s=5)) == items

    def test_stall_guard_propagates_source_errors(self):
        def bad():
            yield 1
            raise RuntimeError("source died")

        g = resilience.stall_guard(bad(), deadline_s=5)
        assert next(g) == 1
        with pytest.raises(RuntimeError, match="source died"):
            next(g)
