"""The port's backend probe, rendezvous and meshes, without a process group:

* ``probe_backend`` finds no card here, answers from its cache the second
  time, and parses a card's answer;
* ``ensure_backend`` raises without a usable card, or with too few GPUs,
  unless the CPU is asked for (``device="cpu"`` or
  ``TPU_SYNCBN_FORCE_CPU=1``), and never moves to the CPU on its own;
* ``DistributedConfig.from_env`` reads what the JAX one reads;
  ``initialize``'s rendezvous knobs take argument > environment > default;
* the rendezvous retry gives up after N attempts with the JAX package's
  backoff sequence, destroying a half-made group between attempts
  (a failing ``init_process_group`` is injected; no real sleep);
* ``mesh_shape`` resolves the ``-1`` wildcard and raises the same errors as
  the JAX ``make_mesh``, for world sizes given as numbers.

Exact comparisons throughout (no floating-point arithmetic is compared).
"""

import datetime
import subprocess
import types

import pytest
import torch

from tpu_syncbn_torch import runtime
from tpu_syncbn_torch.runtime import distributed, probe, resilience

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
       "MASTER_PORT", "TPU_SYNCBN_COORDINATOR", "TPU_SYNCBN_NUM_PROCESSES",
       "TPU_SYNCBN_PROCESS_ID", "TPU_SYNCBN_RENDEZVOUS_ATTEMPTS",
       "TPU_SYNCBN_RENDEZVOUS_TIMEOUT_S", "TPU_SYNCBN_RENDEZVOUS_BACKOFF_S",
       "TPU_SYNCBN_FORCE_CPU")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")


def test_probe_finds_no_card_here_and_is_cached(monkeypatch, no_card):
    monkeypatch.setattr(probe, "_probe_cache", {})
    assert probe.probe_backend(timeout=120) is None

    def no_second_probe(*a, **k):
        raise AssertionError("probed twice")

    monkeypatch.setattr(probe.subprocess, "run", no_second_probe)
    assert probe.probe_backend() is None


@pytest.mark.parametrize("answer", ["card", "none", "crash", "hang"])
def test_probe_reads_the_subprocess_answer(monkeypatch, answer):
    def run(cmd, **kw):
        assert kw["timeout"] == 5.0
        if answer == "hang":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        out = "PROBE 2 9 0 NVIDIA H100 80GB HBM3\n" if answer == "card" else ""
        return subprocess.CompletedProcess(cmd, 1 if answer == "crash" else 0, out, "")

    monkeypatch.setattr(probe, "_probe_cache", {})
    monkeypatch.setattr(probe.subprocess, "run", run)
    want = probe.BackendInfo("gpu", 2, "NVIDIA H100 80GB HBM3", (9, 0)) \
        if answer == "card" else None
    assert probe.probe_backend(timeout=5.0) == want


def test_ensure_backend_raises_without_a_card_unless_the_cpu_is_asked_for(clean_env):
    clean_env.setattr(probe, "_probe_cache", {"result": None})
    clean_env.setenv("TPU_SYNCBN_FORCE_CPU", "0")
    with pytest.raises(RuntimeError, match="requested but this node has 0"):
        probe.ensure_backend(1)
    assert not distributed.cpu_forced()  # nothing moved to the CPU
    clean_env.setattr(probe, "_probe_cache", {
        "result": probe.BackendInfo("gpu", 1, "NVIDIA H100", (9, 0))})
    assert probe.ensure_backend(1).device_count == 1
    with pytest.raises(RuntimeError, match="2 GPU.*this node has 1"):
        probe.ensure_backend(2)
    # asked for: the CPU, and from then on a CUDA request raises
    assert probe.ensure_backend(4, device="cpu") == probe.BackendInfo("cpu", 4)
    assert distributed.cpu_forced()
    with pytest.raises(RuntimeError, match="TPU_SYNCBN_FORCE_CPU=1"):
        runtime.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="TPU_SYNCBN_FORCE_CPU=1"):
        runtime.initialize()
    # the environment variable alone asks for it too, without a probe
    clean_env.setattr(probe, "_probe_cache", {})
    clean_env.setattr(probe.subprocess, "run", None)
    assert probe.ensure_backend(2) == probe.BackendInfo("cpu", 2)
    assert probe.enable_persistent_compilation_cache().endswith("_build")


def test_force_cpu_refuses_after_cuda_was_initialized(clean_env):
    clean_env.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialized CUDA"):
        probe.force_cpu()
    assert not distributed.cpu_forced()


def test_config_from_env_reads_what_the_jax_one_reads(clean_env):
    from tpu_syncbn.runtime.distributed import DistributedConfig as JConfig

    def fields(c):
        return c.coordinator_address, c.num_processes, c.process_id

    assert fields(runtime.DistributedConfig.from_env()) == fields(JConfig.from_env())
    clean_env.setenv("MASTER_ADDR", "node0")
    clean_env.setenv("MASTER_PORT", "1234")
    clean_env.setenv("WORLD_SIZE", "8")
    clean_env.setenv("RANK", "5")
    clean_env.setenv("LOCAL_RANK", "1")
    clean_env.setenv("LOCAL_WORLD_SIZE", "4")
    cfg = runtime.DistributedConfig.from_env()
    assert fields(cfg) == fields(JConfig.from_env()) == ("node0:1234", 8, 5)
    assert (cfg.local_rank, cfg.local_world_size) == (1, 4)
    assert (runtime.local_device_count(), runtime.global_device_count()) == (4, 1)
    clean_env.setenv("TPU_SYNCBN_COORDINATOR", "node1:99")
    clean_env.setenv("TPU_SYNCBN_NUM_PROCESSES", "2")
    clean_env.setenv("TPU_SYNCBN_PROCESS_ID", "1")
    assert fields(runtime.DistributedConfig.from_env()) == fields(JConfig.from_env()) \
        == ("node1:99", 2, 1)


def test_initialize_knobs_take_argument_then_env_then_default(clean_env):
    seen = {}
    clean_env.setattr(distributed, "_rendezvous_with_retry",
                      lambda kw, **knobs: seen.update(kw, **knobs))
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    clean_env.setenv("MASTER_ADDR", "localhost")
    clean_env.setenv("MASTER_PORT", "4321")
    clean_env.setenv("TPU_SYNCBN_RENDEZVOUS_ATTEMPTS", "5")
    clean_env.setenv("TPU_SYNCBN_RENDEZVOUS_TIMEOUT_S", "9")
    assert runtime.initialize("cpu", rendezvous_attempts=2) == torch.device("cpu")
    assert seen == dict(backend="gloo", init_method="tcp://localhost:4321",
                        world_size=2, rank=1, attempts=2, timeout_s=9.0,
                        backoff_s=1.0, jitter_key="rank1")
    seen.clear()
    cfg = runtime.DistributedConfig("h:1", 4, 3)
    runtime.initialize(cfg, device="cpu", rendezvous_backoff_s=0.25)
    assert (seen["init_method"], seen["world_size"], seen["rank"],
            seen["attempts"], seen["backoff_s"]) == ("tcp://h:1", 4, 3, 5, 0.25)


def test_rendezvous_gives_up_after_n_attempts_with_the_jax_backoff(monkeypatch):
    from tpu_syncbn.runtime.resilience import backoff_delays as jax_delays

    calls, sleeps = [], []

    def failing_init(**kw):
        calls.append(kw)
        raise RuntimeError("store unreachable")

    monkeypatch.setattr(distributed.tdist, "init_process_group", failing_init)
    monkeypatch.setattr(resilience, "time", types.SimpleNamespace(sleep=sleeps.append))
    with pytest.raises(RuntimeError, match="store unreachable"):
        distributed._rendezvous_with_retry(
            dict(backend="gloo", init_method="tcp://x:1", world_size=2, rank=1),
            attempts=4, timeout_s=7.0, backoff_s=0.5, jitter_key="rank1")
    assert len(calls) == 4
    assert all(c["timeout"] == datetime.timedelta(seconds=7.0) for c in calls)
    assert sleeps == jax_delays(4, base_s=0.5, key="rank1")
    assert resilience.backoff_delays(6, base_s=2.0, key="rank3") == \
        jax_delays(6, base_s=2.0, key="rank3")


def test_rendezvous_destroys_a_half_made_group_before_retrying(monkeypatch):
    state = {"made": False, "attempts": 0, "destroyed": 0}

    def init(**kw):
        state["attempts"] += 1
        state["made"] = True
        if state["attempts"] == 1:
            raise RuntimeError("peer vanished mid-rendezvous")
        assert "timeout" not in kw  # none given: torch's default

    def destroy():
        state["made"] = False
        state["destroyed"] += 1

    monkeypatch.setattr(distributed.tdist, "init_process_group", init)
    monkeypatch.setattr(distributed.tdist, "is_initialized", lambda: state["made"])
    monkeypatch.setattr(distributed.tdist, "destroy_process_group", destroy)
    monkeypatch.setattr(resilience, "time", types.SimpleNamespace(sleep=lambda s: None))
    distributed._rendezvous_with_retry({}, attempts=3, timeout_s=None,
                                       backoff_s=1.0, jitter_key="rank0")
    assert state == {"made": True, "attempts": 2, "destroyed": 1}


MESH_CASES = [
    (None, 8), ({"data": -1}, 8), ({"data": 2, "model": -1}, 8),
    ({"data": -1, "model": 4}, 8), ({"data": 2, "model": 4}, 8),
    ({"data": -1}, 1), ({"data": -1, "model": 3}, 8),
    ({"data": -1, "model": -1}, 8), ({"data": 0}, 8), ({"data": 3}, 8),
    ({"data": 2, "model": 2}, 8),
]


@pytest.mark.parametrize("axis_sizes,n", MESH_CASES,
                         ids=[f"{a}-{n}" for a, n in MESH_CASES])
def test_mesh_shape_matches_jax_make_mesh(axis_sizes, n):
    import jax

    from tpu_syncbn.runtime.distributed import make_mesh as jax_make_mesh

    def outcome(f):
        try:
            return f()
        except ValueError as e:
            return ("ValueError", str(e))

    want = outcome(lambda: (lambda m: (tuple(m.axis_names), m.devices.shape))(
        jax_make_mesh(axis_sizes, devices=jax.devices()[:n])))
    assert outcome(lambda: runtime.mesh_shape(axis_sizes, n)) == want


def test_meshes_need_a_process_group_and_count_replicas(clean_env):
    with pytest.raises(RuntimeError, match="needs a process group"):
        runtime.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="requested 2 replicas but only 1 devices"):
        runtime.data_parallel_mesh(2, device="cpu")
    runtime.barrier("no-op at world 1")
