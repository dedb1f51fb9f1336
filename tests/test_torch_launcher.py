"""The port's launcher, ``python -m tpu_syncbn_torch.launch``:

* ``build_parser`` takes the JAX launcher's flags with its defaults;
* ``--simulate-chips 2`` runs this file as a world-2 script over gloo: each
  rank records torchrun's environment, finds that asking for ``cuda``
  raises, then trains a narrow SyncBN ResNet-18 (weights carried over from
  the JAX model with ``models/weights.py``, batches from a seed) for three
  steps; its losses and final state match the JAX ``DataParallel`` on a
  2-device mesh (ROADMAP A.1's "done when");
* in the same run, a parameter reached on one rank only (and one reached
  on none) leaves both ranks with identical parameters, equal to the
  world-1 step on the whole batch (the trainer's zero-filled gradients);
* a child that exits 3 makes the launcher exit 3, and its sibling is gone;
* a rendezvous that never completes ends at the rendezvous timeout;
* ``--nproc-per-node 2`` on a machine without two cards exits non-zero,
  naming both numbers.

Every launch has a deadline, after which its whole process group is
killed. Tolerances: as tests/test_torch_trainer.py (losses rtol 1e-5,
state rtol 2e-4 / atol 1e-5); the ragged-gradient parameters rtol 1e-6
(one matrix-vector product summed in another order).
"""

import argparse
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpu_syncbn_torch.runtime import launcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIS = os.path.abspath(__file__)
LAUNCH_TIMEOUT_S = 240
NET = dict(rtol=2e-4, atol=1e-5)
RAGGED = dict(rtol=1e-6, atol=1e-7)


def _launch(args, timeout=LAUNCH_TIMEOUT_S, **env):
    """Run the launcher; on a deadline, kill its whole session."""
    e = dict(os.environ, PYTHONPATH=ROOT, **env)
    e.pop("XLA_FLAGS", None)
    p = subprocess.Popen([sys.executable, "-m", "tpu_syncbn_torch.launch", *args],
                         cwd=ROOT, env=e, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"launcher still running after {timeout}s")
    return p.returncode, out


# -- the world-2 script (this file, run by the launcher) --------------------


def _ragged_loss(model, batch):
    """``a`` is reached by every row, ``b`` only by rows flagged 1, ``c``
    by none."""
    x, flag = batch
    loss = (x @ model.a).pow(2).mean()
    use = flag.bool()
    if use.any():
        loss = loss + (x[use] @ model.b).pow(2).mean()
    return loss


class _Ragged(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.a = torch.nn.Parameter(torch.randn(4, generator=g))
        self.b = torch.nn.Parameter(torch.randn(4, generator=g))
        self.c = torch.nn.Parameter(torch.randn(4, generator=g))


def ragged_batches():
    """Two steps of 2 shards x 3 rows; shard 0 reaches ``b``, shard 1 not."""
    x = np.random.RandomState(9).randn(2, 6, 4).astype(np.float32)
    flag = np.zeros((2, 6), np.int64)
    flag[:, :3] = 1
    return x, flag


def _ragged_run(rank, world, device):
    from tpu_syncbn_torch import parallel

    model = _Ragged()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if world == 1:  # the whole batch: the mean of the two shards' losses
        def loss_fn(m, batch):
            x, flag = batch
            return (_ragged_loss(m, (x[:3], flag[:3]))
                    + _ragged_loss(m, (x[3:], flag[3:]))) / 2
    else:
        loss_fn = _ragged_loss
    dp = parallel.DataParallel(model, opt, loss_fn, device=device)
    n = 6 // world
    x, flag = ragged_batches()
    for step in range(2):
        sl = slice(rank * n, (rank + 1) * n)
        dp.train_step((torch.from_numpy(x[step, sl]), torch.from_numpy(flag[step, sl])))
    return {f"ragged.{k}": v.detach().numpy() for k, v in model.state_dict().items()}


def _script_main(argv):
    """What each rank of the world-2 run does."""
    from tpu_syncbn_torch import models, nn, parallel, runtime

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = {k: np.array(os.environ.get(k, "")) for k in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
        "MASTER_PORT", "TPU_SYNCBN_FORCE_CPU")}
    try:
        runtime.initialize("cuda")
        out["cuda_error"] = np.array("")
    except RuntimeError as e:
        out["cuda_error"] = np.array(str(e))
    torch.set_num_threads(1)
    device = runtime.initialize(args.device)
    rank, world = runtime.process_index(), runtime.process_count()

    init = dict(np.load(os.path.join(args.out, "init.npz")))
    data = np.load(os.path.join(args.out, "batches.npz"))
    model = nn.convert_sync_batchnorm(models.resnet18(
        num_classes=10, small_input=True, width=8, device=device))
    models.load_jax_params(model, init)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

    def loss_fn(m, batch):
        x, y = batch
        return torch.nn.functional.cross_entropy(m(x), y.long())

    dp = parallel.DataParallel(model, opt, loss_fn, device=device)
    n = data["x"].shape[1] // world
    losses = [float(dp.train_step((x[rank * n:(rank + 1) * n],
                                   y[rank * n:(rank + 1) * n])).loss)
              for x, y in zip(data["x"], data["y"])]
    out["losses"] = np.asarray(losses)
    out.update({f"state.{k}": v.detach().numpy() for k, v in model.state_dict().items()})
    out.update(_ragged_run(rank, world, device))
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **out)
    runtime.shutdown()


if __name__ == "__main__":
    _script_main(sys.argv[1:])


# -- tests -------------------------------------------------------------------


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The JAX trajectory on a 2-device mesh, then the same weights and
    batches through the launcher at world 2."""
    from test_torch_trainer import batches, jax_trajectory
    from tpu_syncbn import runtime as jruntime

    d = tmp_path_factory.mktemp("launch2")
    host = batches()
    init, jlosses, jstate = jax_trajectory(jruntime.data_parallel_mesh(2), "off", host)
    np.savez(d / "init.npz", **init)
    np.savez(d / "batches.npz", x=np.stack([b[0] for b in host]),
             y=np.stack([b[1] for b in host]))
    t0 = time.monotonic()
    rc, out = _launch(["--simulate-chips", "2", THIS, "--", "--device", "cpu",
                       "--out", str(d)])
    assert rc == 0, out
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return ranks, jlosses, jstate, time.monotonic() - t0


def test_parser_takes_the_jax_launchers_flags_and_defaults():
    from tpu_syncbn.runtime.launcher import build_parser as jax_parser

    ours, theirs = launcher.build_parser(), jax_parser()
    flags = lambda p: sorted(s for a in p._actions for s in a.option_strings)  # noqa: E731
    assert flags(ours) == flags(theirs)
    for argv in (["s.py"], ["--simulate-chips", "2", "s.py", "--", "--device", "cpu"],
                 ["--nproc-per-node", "4", "--coordinator", "h:1", "--num-processes",
                  "2", "--process-id", "1", "s.py", "a", "--b"]):
        assert vars(ours.parse_args(argv)) == vars(theirs.parse_args(argv))


def test_simulated_ranks_get_torchruns_environment(world2):
    ranks = world2[0]
    ports = {str(r["MASTER_PORT"]) for r in ranks}
    assert len(ports) == 1 and ports.pop().isdigit()
    for rank, r in enumerate(ranks):
        env = {k: str(r[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                      "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                                      "TPU_SYNCBN_FORCE_CPU")}
        assert env == dict(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                           LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                           TPU_SYNCBN_FORCE_CPU="1")


def test_simulated_ranks_refuse_cuda(world2):
    for r in world2[0]:
        assert "TPU_SYNCBN_FORCE_CPU=1" in str(r["cuda_error"])


def test_world2_training_under_the_launcher_matches_jax(world2):
    ranks, jlosses, jstate, _ = world2
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
    got = {k[len("state."):]: v for k, v in ranks[0].items() if k.startswith("state.")}
    for key, want in jstate.items():
        name = key[:-len(".kernel")] + ".weight" if key.endswith(".kernel") else key
        g = got[name]
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif key == "fc.kernel":
            g = g.T
        np.testing.assert_allclose(g, want, err_msg=key, **NET)
    assert len(jstate) == len(got)
    for key in got:  # the replicas agree bit for bit
        np.testing.assert_array_equal(ranks[1][f"state.{key}"], got[key], err_msg=key)


def test_a_parameter_reached_on_one_rank_only(world2):
    ranks = world2[0]
    want = _ragged_run(0, 1, "cpu")
    for key, w in want.items():
        for r in ranks:
            np.testing.assert_allclose(r[key], w, err_msg=key, **RAGGED)
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    init = _Ragged().state_dict()
    assert not np.allclose(want["ragged.b"], init["b"].numpy())  # b moved
    np.testing.assert_array_equal(want["ragged.c"], init["c"].numpy())  # c did not


def test_a_failing_child_takes_its_sibling_down(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(
        "import os, sys, time\n"
        "d = sys.argv[1]\n"
        "if os.environ['RANK'] == '0':\n"
        "    open(os.path.join(d, 'pid0.tmp'), 'w').write(str(os.getpid()))\n"
        "    os.replace(os.path.join(d, 'pid0.tmp'), os.path.join(d, 'pid0'))\n"
        "    time.sleep(600)\n"
        "while not os.path.exists(os.path.join(d, 'pid0')):\n"
        "    time.sleep(0.05)\n"
        "sys.exit(3)\n")
    t0 = time.monotonic()
    rc, out = _launch(["--simulate-chips", "2", str(script), str(tmp_path)], timeout=120)
    assert rc == 3, out
    assert time.monotonic() - t0 < 60
    pid = int((tmp_path / "pid0").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_a_rendezvous_that_never_completes_ends_at_its_timeout(tmp_path):
    script = tmp_path / "stall.py"
    script.write_text(
        "import os, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    time.sleep(600)  # never joins\n"
        "from tpu_syncbn_torch import runtime\n"
        "runtime.initialize('cpu')\n")
    t0 = time.monotonic()
    rc, out = _launch(["--simulate-chips", "2", str(script)], timeout=120,
                      TPU_SYNCBN_RENDEZVOUS_TIMEOUT_S="3",
                      TPU_SYNCBN_RENDEZVOUS_ATTEMPTS="1")
    assert rc != 0, out
    assert time.monotonic() - t0 < 60, out


def test_more_processes_than_cards_exit_naming_both(monkeypatch):
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    from tpu_syncbn_torch.runtime import probe

    monkeypatch.setattr(probe, "_probe_cache", {})
    monkeypatch.delenv("TPU_SYNCBN_FORCE_CPU", raising=False)
    with pytest.raises(SystemExit) as e:
        launcher.main(["--nproc-per-node", "2", "never_run.py"])
    msg = str(e.value.code)
    have = torch.cuda.device_count()
    assert "--nproc-per-node 2" in msg and f"this node has {have}" in msg


@pytest.mark.slow
def test_launch_parallelism_tour():
    """The port's tour passes every mode's oracle check end to end through
    the launcher at 4 simulated processes (tests/test_launcher.py's tour
    test, for the port)."""
    rc, out = _launch(["--simulate-chips", "4", "tpu_syncbn_torch/parallelism_tour.py",
                       "--", "--device", "cpu"], timeout=600, OMP_NUM_THREADS="2")
    assert rc == 0, out[-3000:]
    assert "tour complete" in out and "FAIL" not in out
    assert out.count("[PASS]") == 10
