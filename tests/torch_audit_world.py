"""The world-8 gloo spawn that the port's audit tests share
(``test_torch_audit_contracts.py``, ``test_torch_audit_sharding.py``): one
spawn for the whole run, whatever the number of xdist workers and of
files that read it (:func:`shared_dir`).

Each of the ``program_audit.PINNED_WORLD`` (8) CPU processes records the
registry (``program_audit.rank_blob``: contracts, costs, errors and the
layer-3 output placements) and the hand-built cases that need
collectives: layer 1's (:func:`extraction_cases`) and layer 3's
(:func:`sharding_cases`), each as JSON in ``rank<r>.json``.
"""

import json
import os
import tempfile
import threading
import time

import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from tpu_syncbn_torch.audit import program_audit
from tpu_syncbn_torch.audit.contracts import ExtractionError, extract_contract

JOIN_TIMEOUT_S = 300


def extraction_cases(world: int) -> dict:
    """Layer 1's hand-built cases that need collectives, on this rank."""
    from tpu_syncbn_torch.parallel import collectives as C

    group = tdist.group.WORLD
    out = {}
    c = extract_contract(lambda x: C.psum(x, group), (torch.ones(4),), name="t",
                         world=world, arg_labels=("x",))
    out["psum"] = c.to_json()
    try:
        extract_contract(lambda x: tdist.all_reduce(x.clone()), (torch.ones(4),),
                         name="t", world=world, arg_labels=("x",))
        out["outside_seam"] = None
    except ExtractionError as e:
        out["outside_seam"] = [e.rule, str(e)]
    # another thread's seam calls while the body records (a psum, and a
    # ppermute, a kind the dispatcher does not see) are not the body's
    side = tdist.new_group(list(range(world)))

    def other():
        C.psum(torch.ones(2), side)
        C.ppermute(torch.ones(2), [(r, (r + 1) % world) for r in range(world)], side)

    def body(x):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        return C.psum(x, group)

    out["foreign_thread"] = extract_contract(body, (torch.ones(4),), name="t", world=world,
                                             arg_labels=("x",)).to_json()
    return out


def _sgd_step(w, x, *, reduce: bool):
    """One SGD step of a linear least-squares fit: the gradient of this
    rank's batch, all-reduced first when ``reduce``."""
    from tpu_syncbn_torch.parallel import collectives as C

    with torch.no_grad():
        g = 2.0 * x.t() @ (x @ w) / x.shape[0]
        if reduce:
            g = C.pmean(g, tdist.group.WORLD)
        w.sub_(0.1 * g)


def _bn_forward(model, x):
    model.train()
    return model(x)


def sharding_cases(world: int) -> dict:
    """Layer 3's hand-built cases that need collectives, on this rank: each
    a contract's ``sharding`` block (or the extraction error's rule)."""
    from tpu_syncbn_torch import nn as pnn
    from tpu_syncbn_torch.mesh_axes import DATA_AXIS
    from tpu_syncbn_torch.parallel import collectives as C
    from tpu_syncbn_torch.parallel.layout import P

    group = tdist.group.WORLD
    mesh = {DATA_AXIS: world}
    data = P(DATA_AXIS)
    rank = tdist.get_rank()

    def case(fn, args, labels, specs, declared=()):
        try:
            return extract_contract(fn, args, name="t", world=world, arg_labels=labels,
                                    declared_donated=declared, mesh_axes=mesh,
                                    in_specs=specs).sharding.to_json()
        except ExtractionError as e:
            return {"error": [e.rule, str(e)]}

    x = torch.full((world, 4), float(rank))
    side = tdist.new_group(list(range(world)))  # a group no layout names
    out = {
        "psum": case(lambda t: C.psum(t, group), (x,), ("x",), (data,)),
        "reduce_scatter": case(lambda t: C.reduce_scatter(t, group),
                               (torch.ones(world, 4),), ("x",), (P(),)),
        "all_gather": case(lambda t: C.all_gather(t, group), (x,), ("x",), (data,)),
        "ppermute": case(lambda t: C.ppermute(t, [(r, (r + 1) % world) for r in range(world)],
                                              group), (torch.ones(4),), ("x",), (P(),)),
        "unnamed_group": case(lambda t: C.psum(t, side), (x,), ("x",), (data,)),
    }
    torch.manual_seed(0)
    w = torch.randn(4, 2)
    xb = torch.randn(8, 4) + rank
    out["unreduced_grad"] = case(lambda w_, b: _sgd_step(w_, b, reduce=False), (w, xb),
                                 ("params", "batch"), (P(), data), declared=("params",))
    out["reduced_grad"] = case(lambda w_, b: _sgd_step(w_, b, reduce=True), (w, xb),
                               ("params", "batch"), (P(), data), declared=("params",))
    for tag, sync in (("plain_bn", False), ("sync_bn", True)):
        torch.manual_seed(0)
        bn = pnn.BatchNorm1d(4, device="cpu")
        model = pnn.convert_sync_batchnorm(torch.nn.Sequential(bn)) if sync \
            else torch.nn.Sequential(torch.nn.BatchNorm1d(4))
        params = list(model.parameters())
        rest = [b for b in model.buffers() if b is not None]
        out[tag] = case(lambda p, r, b: _bn_forward(model, b), (params, rest, xb),
                        ("params", "rest", "batch"), (P(), P(), data),
                        declared=("params", "rest"))
    return out


def replica(rank: int, world: int, rdv: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                             rank=rank)
    try:
        blob = program_audit.rank_blob()
        blob["extraction"] = extraction_cases(world)
        blob["sharding_cases"] = sharding_cases(world)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(blob, f)
    finally:
        tdist.destroy_process_group()


def shared_dir(tmp_path_factory, name: str, make):
    """The directory ``make(d)`` filled, made once per test run whatever the
    number of xdist workers: the first worker to take the lock runs it and
    marks it done; the others wait on the lock, then read its files."""
    import fcntl

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, which its workers share
    d = root / name
    d.mkdir(exist_ok=True)
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (d / "done").exists():
                make(d)
                (d / "done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return d


def world8_blobs(tmp_path_factory) -> list[dict]:
    """Each rank's JSON of the pinned world (:func:`replica`), spawned once
    for the run."""
    world = program_audit.PINNED_WORLD

    def run(out):
        rdv = tempfile.mkdtemp(dir=out)  # a fresh rendezvous each attempt
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=replica,
                             args=(r, world, os.path.join(rdv, "rdv"), str(out)))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5)
        assert not alive, f"world-{world} replicas still running after {JOIN_TIMEOUT_S}s"
        assert [p.exitcode for p in procs] == [0] * world
        (out / "seconds").write_text(f"{time.perf_counter() - t0:.3f}")

    d = shared_dir(tmp_path_factory, "audit8", run)
    blobs = []
    for r in range(world):
        with open(d / f"rank{r}.json") as f:
            blobs.append(json.load(f))
    return blobs
