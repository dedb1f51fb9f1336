"""Process launcher — the counterpart of ``tpu_syncbn.runtime.launcher``,
and the port's ``python -m torch.distributed.launch --nproc_per_node=N``
(the recipe's step 6).

The JAX launcher runs one process per host, which drives every local chip.
The port is the recipe's own model, one process per GPU, so this launcher
spawns ``--nproc-per-node`` children on its node. Each gets torchrun's
environment (``RANK = process_id · nproc + local``, ``WORLD_SIZE =
num_processes · nproc``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) and runs the script with ``__name__ ==
"__main__"``. The launcher then watches them: the first child to fail
takes its siblings down, and its exit code is the launcher's.

Usage::

    python -m tpu_syncbn_torch.launch --nproc-per-node 4 \\
        tpu_syncbn_torch/train.py -- --epochs 2
    python -m tpu_syncbn_torch.launch --simulate-chips 2 \\
        tpu_syncbn_torch/train.py -- --device cpu

Several nodes: the same command on each, with ``--coordinator HOST:PORT
--num-processes NODES --process-id NODE``.

``--nproc-per-node`` beyond this node's GPU count exits non-zero: two
ranks never share a card behind the user's back. ``--simulate-chips N``
runs N CPU processes over gloo with ``TPU_SYNCBN_FORCE_CPU=1``, under
which a CUDA request raises; the script asks for the CPU itself
(``-- --device cpu``). No ``--local_rank`` is injected: scripts read their
identity from ``runtime.initialize`` and ``runtime.process_index``.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

#: What each child runs: the script as ``__main__``, with its own argv.
_CHILD = ("import runpy, sys; sys.argv = sys.argv[1:]; "
          "runpy.run_path(sys.argv[0], run_name='__main__')")

#: Seconds a sibling of a failed child gets to exit on SIGTERM before
#: SIGKILL.
TERMINATE_GRACE_S = 10.0

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_syncbn_torch.launch",
        description="one process per GPU (the port's torch.distributed.launch)",
    )
    p.add_argument(
        "--simulate-chips", type=int, default=None, metavar="N",
        help="run N CPU processes over gloo (testing without cards); the "
        "children have TPU_SYNCBN_FORCE_CPU=1, so the script must ask for "
        "the CPU itself (e.g. -- --device cpu)",
    )
    p.add_argument(
        "--nproc-per-node", type=int, default=None, metavar="N",
        help="processes on this node, one per GPU (default 1); more than "
        "the node's GPUs exits non-zero",
    )
    p.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="rendezvous address (MASTER_ADDR:MASTER_PORT); default: a "
        "free port on localhost (one node)",
    )
    p.add_argument("--num-processes", type=int, default=None,
                   help="number of nodes, one launcher each (default 1)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this node's index (default 0)")
    p.add_argument("script", help="training script to run")
    p.add_argument("script_args", nargs=argparse.REMAINDER,
                   help="arguments passed through to the script")
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _exit_code(rc: int) -> int:
    """A child's return code as the launcher's: a signal becomes 128 + it."""
    return 128 - rc if rc < 0 else rc


def _terminate(procs: list[subprocess.Popen]) -> None:
    """SIGTERM every live child, then SIGKILL whichever outlives the
    grace period; every child is reaped."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.terminate()
    deadline = time.monotonic() + TERMINATE_GRACE_S
    for p in live:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _watch(procs: list[subprocess.Popen], poll_s: float = 0.05) -> int:
    """0 when every child exits 0; else the first failure's code, after
    its siblings are terminated."""
    while True:
        done = 0
        for p in procs:
            rc = p.poll()
            if rc is None:
                continue
            if rc != 0:
                _terminate(procs)
                return _exit_code(rc)
            done += 1
        if done == len(procs):
            return 0
        time.sleep(poll_s)


def _world_layout(args) -> tuple[int, int, int, str, int, bool]:
    """(nproc, num_processes, process_id, host, port, simulate) from the
    flags, checked; exits non-zero on a request it cannot honour."""
    from tpu_syncbn_torch.runtime import probe

    simulate = args.simulate_chips is not None
    if simulate:
        if args.simulate_chips < 1:
            raise SystemExit("--simulate-chips must be >= 1")
        if args.nproc_per_node not in (None, args.simulate_chips):
            raise SystemExit(
                f"--nproc-per-node {args.nproc_per_node} and --simulate-chips "
                f"{args.simulate_chips} disagree"
            )
        nproc = args.simulate_chips
    else:
        nproc = 1 if args.nproc_per_node is None else args.nproc_per_node
        if nproc < 1:
            raise SystemExit("--nproc-per-node must be >= 1")
        try:
            probe.ensure_backend(nproc)
        except RuntimeError as e:
            raise SystemExit(f"--nproc-per-node {nproc}: {e}") from None
    num_processes = 1 if args.num_processes is None else args.num_processes
    process_id = 0 if args.process_id is None else args.process_id
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise SystemExit(
            f"--process-id {process_id} must lie in [0, --num-processes "
            f"{num_processes})"
        )
    if args.coordinator is None:
        if num_processes > 1:
            raise SystemExit("--num-processes > 1 needs --coordinator HOST:PORT")
        host, port = "localhost", _free_port()
    else:
        host, sep, port_s = args.coordinator.rpartition(":")
        if not sep or not host or not port_s.isdigit():
            raise SystemExit(f"--coordinator must be HOST:PORT, got {args.coordinator!r}")
        port = int(port_s)
    return nproc, num_processes, process_id, host, port, simulate


def main(argv: list[str] | None = None) -> int:
    """Spawn the children, watch them, return the exit code (see the
    module docstring). Refusals exit through ``SystemExit`` with the
    reason."""
    from tpu_syncbn_torch.runtime.distributed import FORCE_CPU_ENV

    args = build_parser().parse_args(argv)
    nproc, num_processes, process_id, host, port, simulate = _world_layout(args)
    script_args = args.script_args
    if script_args and script_args[0] == "--":
        script_args = script_args[1:]
    world = num_processes * nproc
    path = os.environ.get("PYTHONPATH")
    procs: list[subprocess.Popen] = []
    prev = signal.signal(signal.SIGTERM, lambda sig, _frame: sys.exit(128 + sig))
    try:
        for local in range(nproc):
            rank = process_id * nproc + local
            env = dict(
                os.environ,
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local),
                LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR=host,
                MASTER_PORT=str(port),
                TPU_SYNCBN_COORDINATOR=f"{host}:{port}",
                TPU_SYNCBN_NUM_PROCESSES=str(world),
                TPU_SYNCBN_PROCESS_ID=str(rank),
                # the children import this package wherever they start
                PYTHONPATH=_PKG_ROOT + (os.pathsep + path if path else ""),
            )
            if simulate:
                env[FORCE_CPU_ENV] = "1"
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, args.script, *script_args],
                env=env))
        return _watch(procs)
    finally:
        _terminate(procs)
        signal.signal(signal.SIGTERM, prev)
