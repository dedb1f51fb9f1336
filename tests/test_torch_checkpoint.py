"""The port's checkpoints (``tpu_syncbn_torch.utils.checkpoint`` and
``parallel.resume_latest``), ported from the JAX package's tests of its
own: round trip, pruning, a specific step and a missing one
(tests/test_utils.py:37-80); corrupt checkpoints, manifests and the
agreement of several processes (tests/test_faults.py ``TestCorruptCheckpoint``,
``TestManifest``, ``TestMultiHostAgreement``); the background writer
(tests/test_scan_driver.py ``TestAsyncCheckpointer``); and ``payload_sum64``
against the JAX function on the same bytes.

The JAX tests fake a second host by patching the broadcast; here two gloo
processes share a temporary directory, so the barrier, the broadcast of the
master's pick and the followers' direct reads all run for real. The
spawned processes import this module, so JAX is imported inside the one
test that compares with it.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch import nn, parallel, utils
from tpu_syncbn_torch.utils import checkpoint as ckpt
from tpu_syncbn_torch.utils.checkpoint import CheckpointCorruptError

WORLD = 2
JOIN_TIMEOUT_S = 120


class TinyNet(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc = torch.nn.Linear(4, 4)
        with torch.no_grad():
            self.fc.weight.copy_(torch.randn(4, 4, generator=g) * 0.5)
            self.fc.bias.copy_(torch.randn(4, generator=g) * 0.1)
        self.bn = nn.BatchNorm1d(4, device="cpu")

    def forward(self, x):
        return self.bn(self.fc(x))


def loss_fn(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def make_batch(seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(16, 4).astype(np.float32)),
            torch.from_numpy(rs.randn(16, 4).astype(np.float32)))


def make_trainer(seed=0, **kw):
    model = nn.convert_sync_batchnorm(TinyNet(seed))
    return parallel.DataParallel(model, torch.optim.Adam(model.parameters(), lr=1e-2),
                                 loss_fn, device="cpu", **kw)


def params(dp):
    return {k: v.detach().clone() for k, v in dp.model.named_parameters()}


def params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def truncate(d, step):
    path = ckpt._path(d, step)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def bitflip(d, step, seed=0):
    path = ckpt._path(d, step)
    rs = np.random.RandomState(seed)
    offset, bit = rs.randint(os.path.getsize(path)), rs.randint(8)
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([byte ^ (1 << bit)]))


# -- round trip, pruning, steps (tests/test_utils.py:37-80) ------------------


def test_checkpoint_roundtrip_resume(tmp_path):
    d = str(tmp_path)
    dp = make_trainer()
    batch = make_batch()
    for _ in range(3):
        dp.train_step(batch)
    path = utils.save_checkpoint(d, step=3, tree=dp.state_dict())
    assert path and os.path.exists(path) and path.endswith("ckpt_3.pt")
    out_after = dp.train_step(batch)  # continue one step

    # a fresh, differently initialized trainer restores and repeats the
    # same step: the same trajectory, bit for bit (Adam's moments and step
    # count included)
    dp2 = make_trainer(seed=1)
    restored, step = utils.load_checkpoint(d, dp2.state_dict())
    assert step == 3
    dp2.load_state_dict(restored)
    out2 = dp2.train_step(batch)
    assert float(out2.loss) == float(out_after.loss)
    params_equal(params(dp2), params(dp))


def test_checkpoint_pruning(tmp_path):
    d = str(tmp_path)
    for s in range(5):
        utils.save_checkpoint(d, step=s, tree={"x": torch.ones(2)}, keep=2)
    assert utils.available_steps(d) == [3, 4]


def test_checkpoint_specific_step_and_missing(tmp_path):
    d = str(tmp_path)
    utils.save_checkpoint(d, step=1, tree={"x": torch.ones(2)})
    utils.save_checkpoint(d, step=7, tree={"x": torch.full((2,), 7.0)})
    tree, step = utils.load_checkpoint(d, {"x": torch.zeros(2)}, step=1)
    assert step == 1
    np.testing.assert_allclose(tree["x"].numpy(), 1.0)
    with pytest.raises(FileNotFoundError):
        utils.load_checkpoint(d, {"x": torch.zeros(2)}, step=5)
    with pytest.raises(FileNotFoundError):
        utils.load_checkpoint(str(tmp_path / "empty"), {"x": torch.zeros(2)})


def test_a_checkpoint_of_another_structure_is_refused(tmp_path):
    """The template's structure is checked: another shape raises for an
    explicit step and is skipped by the latest-step walk; a trainer built
    with another guard setting refuses the state."""
    d = str(tmp_path)
    utils.save_checkpoint(d, 1, {"x": torch.ones(2)})
    utils.save_checkpoint(d, 2, {"x": torch.ones(3)})
    with pytest.raises(CheckpointCorruptError, match="step 2"):
        utils.load_checkpoint(d, {"x": torch.zeros(2)}, step=2)
    tree, step = utils.load_checkpoint(d, {"x": torch.zeros(2)})
    assert step == 1 and tree["x"].shape == (2,)
    dp = make_trainer()
    dp.train_step(make_batch())
    guarded = make_trainer(divergence_guard="skip_step")
    with pytest.raises(ValueError, match="opt_state structure mismatch"):
        guarded.load_state_dict(dp.state_dict())


# -- corrupt checkpoints (tests/test_faults.py TestCorruptCheckpoint) --------


class TestCorruptCheckpoint:
    def _two_checkpoints(self, d):
        dp = make_trainer()
        batch = make_batch()
        dp.train_step(batch)
        utils.save_checkpoint(d, 1, dp.state_dict())
        good = params(dp)
        dp.train_step(batch)
        utils.save_checkpoint(d, 2, dp.state_dict())
        return dp, good

    @pytest.mark.parametrize("corrupt", [truncate, bitflip])
    def test_corrupt_newest_falls_back_to_verified(self, tmp_path, corrupt):
        d = str(tmp_path)
        _, good_step1 = self._two_checkpoints(d)
        corrupt(d, 2)
        assert not ckpt.verify_checkpoint(d, 2)
        assert ckpt.verified_steps(d) == [1]
        dp2 = make_trainer(seed=9)
        restored, step = utils.load_checkpoint(d, dp2.state_dict())
        assert step == 1  # newest VERIFIED, not newest
        dp2.load_state_dict(restored)
        params_equal(params(dp2), good_step1)

    def test_all_corrupt_raises_loudly(self, tmp_path):
        d = str(tmp_path)
        self._two_checkpoints(d)
        truncate(d, 1)
        bitflip(d, 2)
        with pytest.raises(CheckpointCorruptError, match="failed verification"):
            utils.load_checkpoint(d, make_trainer().state_dict())

    def test_explicit_corrupt_step_raises_not_falls_back(self, tmp_path):
        d = str(tmp_path)
        self._two_checkpoints(d)
        truncate(d, 2)
        with pytest.raises(CheckpointCorruptError, match="step 2"):
            utils.load_checkpoint(d, make_trainer().state_dict(), step=2)

    def test_resume_latest_skips_corrupt(self, tmp_path):
        d = str(tmp_path)
        _, good_step1 = self._two_checkpoints(d)
        truncate(d, 2)
        dp2 = make_trainer(seed=5)
        assert parallel.resume_latest(dp2, d) == 1
        params_equal(params(dp2), good_step1)

    def test_resume_latest_empty_dir_is_fresh_start(self, tmp_path):
        assert parallel.resume_latest(make_trainer(), str(tmp_path / "none")) == 0

    def test_resume_latest_raises_when_every_candidate_fails(self, tmp_path):
        d = str(tmp_path)
        self._two_checkpoints(d)
        truncate(d, 1)
        truncate(d, 2)
        with pytest.raises(CheckpointCorruptError):
            parallel.resume_latest(make_trainer(), d)


# -- manifests (tests/test_faults.py TestManifest) ---------------------------


class TestManifest:
    def test_save_writes_certifying_manifest(self, tmp_path):
        d = str(tmp_path)
        utils.save_checkpoint(d, 5, {"x": torch.arange(8, dtype=torch.float32)})
        m = ckpt.read_manifest(d, 5)
        assert m["step"] == 5 and m["format"] == ckpt.MANIFEST_FORMAT
        assert m["nbytes"] == os.path.getsize(ckpt._path(d, 5))
        assert ckpt.verify_checkpoint(d, 5)
        assert ckpt.verified_steps(d) == [5]

    def test_prune_removes_manifests_and_is_idempotent(self, tmp_path):
        d = str(tmp_path)
        for s in range(5):
            utils.save_checkpoint(d, s, {"x": torch.ones(2)}, keep=2)
        assert utils.available_steps(d) == [3, 4]
        assert ckpt.verified_steps(d) == [3, 4]
        assert not os.path.exists(ckpt._manifest_path(d, 0))
        # a concurrent prune already removed what this save prunes next
        os.unlink(ckpt._path(d, 3))
        os.unlink(ckpt._manifest_path(d, 3))
        utils.save_checkpoint(d, 9, {"x": torch.ones(2)}, keep=1)
        assert utils.available_steps(d) == [9]

    def test_checkpoint_without_manifest_still_loads(self, tmp_path):
        d = str(tmp_path)
        torch.save({"x": torch.full((2,), 3.0)}, ckpt._path(d, 3))
        tree, step = utils.load_checkpoint(d, {"x": torch.zeros(2)})
        assert step == 3
        np.testing.assert_allclose(tree["x"].numpy(), 3.0)
        assert not ckpt.verify_checkpoint(d, 3)  # loadable, not certified

    def test_tree_hash_stable_and_shape_sensitive(self):
        a = {"x": torch.zeros(2, 3)}
        b = {"x": torch.ones(2, 3)}   # same structure
        c = {"x": torch.zeros(3, 2)}  # another shape
        e = {"y": torch.zeros(2, 3)}  # another name
        f = {"x": torch.zeros(2, 3, dtype=torch.bfloat16)}  # another dtype
        h = ckpt.tree_structure_hash
        assert h(a) == h(b)
        assert len({h(a), h(c), h(e), h(f)}) == 4

    def test_manifest_json_is_strict(self, tmp_path):
        d = str(tmp_path)
        utils.save_checkpoint(d, 1, {"x": torch.ones(2)})
        with open(ckpt._manifest_path(d, 1)) as f:
            m = json.load(f)
        assert set(m) == {"format", "step", "nbytes", "sum64", "crc32", "tree_hash"}

    def test_crc32_is_skipped_above_the_threshold(self, tmp_path, monkeypatch):
        d = str(tmp_path)
        monkeypatch.setattr(ckpt, "_CRC32_MAX_BYTES", 16)
        utils.save_checkpoint(d, 1, {"x": torch.ones(64)})
        m = ckpt.read_manifest(d, 1)
        assert m["crc32"] is None and m["sum64"] and ckpt.verify_checkpoint(d, 1)
        bitflip(d, 1, seed=4)
        assert not ckpt.verify_checkpoint(d, 1)  # sum64 alone catches it


@pytest.mark.parametrize("n", list(range(18)) + [(1 << 20) + 3])
def test_payload_sum64_equals_the_jax_function(n):
    from tpu_syncbn.utils import checkpoint as jckpt

    data = np.random.RandomState(n).randint(0, 256, n, dtype=np.uint8).tobytes()
    assert ckpt.payload_sum64(data) == jckpt.payload_sum64(data)


# -- the background writer (tests/test_scan_driver.py TestAsyncCheckpointer) -


class TestAsyncCheckpointer:
    def _state(self, seed=0):
        rs = np.random.RandomState(seed)
        return {"w": torch.from_numpy(rs.randn(32, 8).astype(np.float32)),
                "n": torch.tensor(3, dtype=torch.int32)}

    def test_write_certifies_and_loads(self, tmp_path):
        d = str(tmp_path)
        state = self._state()
        with ckpt.AsyncCheckpointer(keep=3) as ac:
            ac.save(d, 1, state)
            assert ac.flush(timeout=30)
        assert ckpt.verify_checkpoint(d, 1)
        loaded, step = ckpt.load_checkpoint(d, self._state())
        assert step == 1
        assert all(torch.equal(loaded[k], state[k]) for k in state)

    def test_snapshot_is_copy_before_step(self, tmp_path):
        """The steps that follow save() update the parameters in place
        while the writer runs; the flushed checkpoint holds the state at
        save time."""
        d = str(tmp_path)
        dp = make_trainer()
        dp.train_step(make_batch(1))
        expect = params(dp)
        live = dp.state_dict()
        with ckpt.AsyncCheckpointer(keep=3) as ac:
            ac.save(d, 1, {"live": dict(dp.model.named_parameters()), **live})
            dp.train_step(make_batch(2))
            dp.train_step(make_batch(3))
            assert ac.flush(timeout=60)
        loaded, _ = ckpt.load_checkpoint(d, None)
        params_equal({k: v for k, v in loaded["live"].items()}, expect)
        params_equal(loaded["params"], expect)

    def test_ordering_newest_step_wins(self, tmp_path):
        d = str(tmp_path)
        with ckpt.AsyncCheckpointer(keep=2, max_pending=4) as ac:
            for step in (1, 2, 3):
                ac.save(d, step, self._state(step))
            assert ac.flush(timeout=60)
        assert ckpt.verified_steps(d) == [2, 3]
        _, step = ckpt.load_checkpoint(d, self._state())
        assert step == 3

    def test_async_payload_is_the_synchronous_one(self, tmp_path):
        state = self._state(5)
        utils.save_checkpoint(str(tmp_path / "sync"), 1, state)
        with ckpt.AsyncCheckpointer() as ac:
            ac.save(str(tmp_path / "async"), 1, state)
        sync, async_ = (ckpt._path(str(tmp_path / k), 1) for k in ("sync", "async"))
        with open(sync, "rb") as a, open(async_, "rb") as b:
            assert a.read() == b.read()

    def test_background_error_surfaces_at_flush(self, tmp_path):
        target = tmp_path / "blocked"
        target.write_text("a file where the directory should go")
        ac = ckpt.AsyncCheckpointer()
        ac.save(str(target), 1, self._state())
        with pytest.raises(RuntimeError, match="async checkpoint write"):
            ac.flush(timeout=30)
        ac.close()
        ac.close()  # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            ac.save(str(tmp_path), 2, self._state())

    def test_validates_max_pending(self):
        with pytest.raises(ValueError, match="max_pending"):
            ckpt.AsyncCheckpointer(max_pending=0)


# -- agreement between processes (tests/test_faults.py TestMultiHostAgreement)


def _write(d, step, value, manifest=True):
    """A checkpoint ``{"x": [value, value]}`` at ``step``; without its
    manifest when ``manifest`` is False (a payload no manifest certifies)."""
    tree = {"x": torch.full((2,), float(value))}
    if manifest:
        ckpt.save_checkpoint(d, step, tree)
    else:
        os.makedirs(d, exist_ok=True)
        torch.save(tree, ckpt._path(d, step))


def _prepare(name, d):
    """The master's directory for each case."""
    if name == "agreed":
        _write(d, 1, 1.0)
        _write(d, 2, 2.0)
    elif name == "master_corrupt_newest":
        _write(d, 1, 1.0)
        _write(d, 2, 2.0)
        truncate(d, 2)
    elif name == "mixed_legacy":
        _write(d, 100, 7.0, manifest=False)
        _write(d, 200, 1.0)
        truncate(d, 200)
    elif name == "newer_legacy_wins":
        _write(d, 8, 1.0)
        _write(d, 10, 3.0, manifest=False)
    elif name in ("follower_retries", "follower_corrupt_read"):
        _write(d, 1, 1.0)
        _write(d, 2, 2.0)
    elif name == "all_corrupt":
        _write(d, 1, 1.0)
        truncate(d, 1)


CASES = ("agreed", "master_corrupt_newest", "mixed_legacy", "newer_legacy_wins",
         "follower_retries", "follower_corrupt_read", "all_corrupt")


def _follower_patches(name, d):
    """What the follower's view of the shared directory does in each case;
    returns the undo."""
    saved = {k: getattr(ckpt, k) for k in ("available_steps", "_path", "_read_with_retry")}
    if name == "agreed":
        # the follower's listing lags: it sees nothing, yet the agreed
        # file is readable
        ckpt.available_steps = lambda _d: []
    elif name == "follower_retries":
        # the agreed payload becomes visible to the follower only 0.3 s
        # after it first looks
        late = os.path.join(d, "late")
        real = saved["_path"](d, 2)
        ckpt._path = lambda _d, s: os.path.join(late, f"ckpt_{s}.pt")

        def land():
            os.makedirs(late)
            with open(real, "rb") as src, open(os.path.join(late, "ckpt_2.pt"), "wb") as dst:
                dst.write(src.read())

        threading.Timer(0.3, land).start()
    elif name == "follower_corrupt_read":
        def flipped(path, **kw):
            data = saved["_read_with_retry"](path, **kw)
            if path.endswith(".pt"):
                data = bytes([data[0] ^ 1]) + data[1:]
            return data

        ckpt._read_with_retry = flipped

    def undo():
        for k, v in saved.items():
            setattr(ckpt, k, v)

    return undo


def _agreement_replica(rank, rdv, root):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=WORLD, rank=rank)
    results = {}
    try:
        # only the master writes
        results["follower_save"] = ckpt.save_checkpoint(
            os.path.join(root, "writes"), 1, {"x": torch.ones(2)})
        for name in CASES:
            d = os.path.join(root, name)
            if rank == 0:
                _prepare(name, d)
            tdist.barrier()
            undo = _follower_patches(name, d) if rank == 1 else (lambda: None)
            try:
                tree, step = ckpt.load_checkpoint(d, {"x": torch.zeros(2)})
                results[name] = [step, float(tree["x"][0])]
            except Exception as e:  # recorded, and held by the test
                results[name] = [type(e).__name__, str(e)]
            finally:
                undo()
            tdist.barrier()
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def agreement(tmp_path_factory):
    root = tmp_path_factory.mktemp("agreement")
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_agreement_replica,
                         args=(r, str(root / "rdv"), str(root)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    assert not alive, f"replicas still running after {JOIN_TIMEOUT_S}s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = []
    for r in range(WORLD):
        with open(root / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


class TestMultiProcessAgreement:
    def test_only_the_master_writes(self, agreement):
        master, follower = agreement
        assert master["follower_save"].endswith("ckpt_1.pt")
        assert follower["follower_save"] is None

    def test_follower_with_lagging_listing_restores_the_agreed_step(self, agreement):
        assert [r["agreed"] for r in agreement] == [[2, 2.0]] * WORLD

    def test_master_agreement_skips_its_own_corrupt_newest(self, agreement):
        assert [r["master_corrupt_newest"] for r in agreement] == [[1, 1.0]] * WORLD

    def test_mixed_legacy_dir_falls_back_to_the_legacy_step(self, agreement):
        """An old payload without a manifest plus a newer manifested one
        cut mid-write: the processes agree on the legacy step, as one
        process would."""
        assert [r["mixed_legacy"] for r in agreement] == [[100, 7.0]] * WORLD

    def test_newest_loadable_wins_regardless_of_manifest(self, agreement):
        assert [r["newer_legacy_wins"] for r in agreement] == [[10, 3.0]] * WORLD

    def test_follower_retries_until_the_rename_lands(self, agreement):
        assert [r["follower_retries"] for r in agreement] == [[2, 2.0]] * WORLD

    def test_follower_detects_a_locally_corrupt_payload(self, agreement):
        master, follower = agreement
        assert master["follower_corrupt_read"] == [2, 2.0]
        kind, msg = follower["follower_corrupt_read"]
        assert kind == "CheckpointCorruptError" and "process 1" in msg

    def test_nothing_loadable_fails_alike_everywhere(self, agreement):
        for r in agreement:
            kind, msg = r["all_corrupt"]
            assert kind == "FileNotFoundError" and "master" in msg
