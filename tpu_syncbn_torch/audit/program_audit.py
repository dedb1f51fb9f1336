"""Layer 1 of the program auditor: record every step body the port builds
and hold it to its pinned :class:`~tpu_syncbn_torch.audit.contracts.ProgramContract`
— the counterpart of ``tpu_syncbn.audit.jaxpr_audit``.

The registry builds each program the way the trainers and the engine
build it — the same trainer classes, the same step bodies (the body a
K-step program captures, ``DataParallel._program_body``), the same
strategy functions — on the JAX registry's tiny models, on CPU tensors,
and records one application of it on every rank of a gloo world of
:data:`PINNED_WORLD` processes (:func:`pinned_world_contracts`). Each
rank extracts its own contract; ranks that disagree are an error naming
the rank and the field. Programs are registered under the JAX names
(``DESIGN.md`` beside this file maps each, and says how an executed count
relates to JAX's program-text count where they differ), each with the mesh
and declared specs JAX's golden pins, so the same recording runs layer 3
(:mod:`~tpu_syncbn_torch.audit.sharding_audit`): each contract's
``sharding`` block, :func:`check_sharding`'s rules and
``contract.fsdp_peak_memory`` (ROADMAP C.7 pinned, :data:`PEAK_ITEMS`).

Goldens live in ``tpu_syncbn_torch/audit/goldens/<name>.json`` (re-pin
with ``python -m tpu_syncbn_torch.audit --write-goldens``: the CLI prints
the old → new field diff and refuses to overwrite a mismatching golden
without ``--force``). ``layout.serve.eval_fsdp`` is not registered: the
engine refuses sharded layouts until ROADMAP A.12c.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn as tnn

from tpu_syncbn_torch.audit import contract_cache
from tpu_syncbn_torch.mesh_axes import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS
from tpu_syncbn_torch.parallel.layout import P
from tpu_syncbn_torch.audit.contracts import (
    ExtractionError,
    ProgramContract,
    compare_contracts,
    load_contract,
    save_contract,
)
# the one finding type of both layers, kept in the standard-library lint
from tpu_syncbn_torch.audit.srclint import Violation

#: World the goldens are pinned at: JAX's virtual CPU mesh
#: (``tpu_syncbn/audit/jaxpr_audit.py:76``), here gloo processes.
PINNED_WORLD = 8

_GLOBAL_BATCH = 16
_FEATURES = 8
_LATENT = 4

#: How long the pinned world may take before its processes are killed.
PINNED_TIMEOUT_S = 300.0

#: Programs whose host reads are a recorded divergence from JAX's goldens,
#: and its ROADMAP C item: torch's Adam reads its step count and learning
#: rate on the host when its tensors are on the CPU (the card's body runs
#: Adam ``capturable`` and reads nothing; ``chip_smoke.py`` ``[audit]``).
HOST_READ_ITEMS = {
    "dataparallel.zero_guard.train_step": "C.6",
    "gan.train_step": "C.6",
    "layout.dp.train_step": "C.6",
    "layout.dp_fsdp.train_step": "C.6",
    "layout.dp_fsdp_int8.train_step": "C.6",
}


#: The DP×FSDP pair of ``contract.fsdp_peak_memory`` whose recorded peak
#: ratio is a recorded divergence from JAX's goldens, and its ROADMAP C
#: item: the port's sharded layout keeps the module's full parameters
#: between steps beside the flat shards (ROADMAP 10a, C.7's repair).
PEAK_ITEMS = {("layout.dp_fsdp.train_step", "layout.dp.train_step"): "C.7"}

#: ``contract.fsdp_peak_memory``'s bound (``jaxpr_audit.py:905-924``).
FSDP_PEAK_RATIO = 0.6


def lossy_collective_bytes(contract: ProgramContract) -> int:
    """A program's lossy-eligible wire bytes: every collective byte but
    the ``pmin`` family (the divergence guard's finiteness consensus stays
    exact f32, excluded from the compression claim on both sides)."""
    return sum(v for k, v in contract.collective_bytes.items() if k != "pmin")


def default_golden_dir() -> str:
    """``goldens/`` beside this module: the port's pins live in its own
    package (``tests/contracts/`` holds the JAX package's)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def golden_path(golden_dir: str, name: str) -> str:
    return os.path.join(golden_dir, f"{name}.json")


@dataclasses.dataclass
class ProgramSpec:
    """One registered program: ``fn(*example_args)`` applies its body
    ``steps`` times; ``arg_labels`` names each argument's tensors and
    ``declared_donated`` those the body must update in place.
    ``mesh_axes`` and ``in_specs`` (one prefix spec tree a label) are the
    mesh and the declared specs JAX's golden pins for the same program
    (layer 3); ``layout`` is the ``SpecLayout`` whose groups the body's
    collectives run over (None: the world group spans every axis), and
    ``out_specs`` the outputs' specs where JAX's builder declares a
    ``shard_map`` ``out_specs`` for values the port returns as is."""

    name: str
    fn: Callable
    example_args: tuple
    arg_labels: tuple[str, ...]
    world: int
    declared_donated: tuple[str, ...] = ()
    steps: int = 1
    mesh_axes: dict | None = None
    in_specs: tuple | None = None
    layout: Any = None
    out_specs: Any = None


# ---------------------------------------------------------------------------
# tiny deterministic models (contract fixtures, not benchmarks)


def _group():
    import torch.distributed as tdist

    return tdist.group.WORLD if tdist.is_initialized() else None


def _world() -> int:
    from tpu_syncbn_torch.parallel import collectives

    return collectives.world_size(_group())


def _rank() -> int:
    from tpu_syncbn_torch.parallel import collectives

    return collectives.axis_index(_group())


def _randn(*shape, seed: int, shared: bool = False) -> torch.Tensor:
    """Seeded normals: this rank's own, or the same on every rank
    (``shared``: a replicated operand)."""
    rng = np.random.default_rng(seed * 1000 + (0 if shared else _rank()))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _tiny_model():
    from tpu_syncbn_torch import nn as pnn

    torch.manual_seed(0)
    net = tnn.Sequential()
    net.add_module("fc", tnn.Linear(_FEATURES, _FEATURES))
    net.add_module("bn", pnn.BatchNorm1d(_FEATURES, device="cpu"))
    return pnn.convert_sync_batchnorm(net)


def _tiny_gan():
    from tpu_syncbn_torch import nn as pnn

    torch.manual_seed(0)
    g = tnn.Sequential(tnn.Linear(_LATENT, _FEATURES), pnn.BatchNorm1d(_FEATURES, device="cpu"))
    torch.manual_seed(1)
    d = tnn.Sequential(tnn.Linear(_FEATURES, 1), pnn.BatchNorm1d(1, device="cpu"))
    return pnn.convert_sync_batchnorm(g), pnn.convert_sync_batchnorm(d)


def _mse(model, batch):
    return (model(batch) ** 2).mean()


def _compress_mlp():
    """The BN-free MLP of the compressed and layout programs (~2.2k
    parameters): every byte on the wire is gradient or loss payload, or
    the guard's exact ``pmin``."""
    torch.manual_seed(0)
    return tnn.Sequential(tnn.Linear(_FEATURES, 16 * _FEATURES), tnn.Tanh(),
                          tnn.Linear(16 * _FEATURES, _FEATURES))


def _batch(*lead, seed: int = 1):
    """This rank's shard of a ``(*lead, GLOBAL_BATCH, FEATURES)`` batch."""
    return _randn(*lead, _GLOBAL_BATCH // _world(), _FEATURES, seed=seed)


def _dp_spec(name: str, dp, *, k: int = 1, stacked: bool = False,
             declared=("params", "rest", "opt_state")) -> ProgramSpec:
    """A ``DataParallel`` step body (K applications when ``k > 1``) with the
    chunk's learning rates filled as ``train_steps`` fills them, and the
    trainer's own mesh and declared specs (a stacked batch: a leading
    unsharded axis)."""
    from tpu_syncbn_torch.parallel.trainer import _schedule_lrs

    prog = dp._program_body(k, stacked)
    prog.chunk.opt.fill(_schedule_lrs(dp.optimizer, dp.lr_scheduler, k))
    groups = dp._state_groups(prog.chunk)
    specs = dp._state_specs(prog.chunk, (lambda b: P(None, *b)) if stacked else (lambda b: b))
    mesh_axes, layout = dp.audit_mesh()
    batch = _batch(k) if stacked else _batch()
    return ProgramSpec(
        name=name,
        fn=lambda params, rest, opt_state, b: prog.loop(b),
        example_args=(groups["params"], groups["rest"], groups["opt_state"], batch),
        arg_labels=("params", "rest", "opt_state", "batches" if stacked else "batch"),
        declared_donated=tuple(declared), world=_world(), steps=k,
        mesh_axes=mesh_axes, layout=layout,
        in_specs=(specs["params"], specs["rest"], specs["opt_state"], specs["batch"]))


def _sgd(params):
    return torch.optim.SGD(params, lr=0.1, momentum=0.9)


# ---------------------------------------------------------------------------
# program registry


def _dp_train_step() -> ProgramSpec:
    from tpu_syncbn_torch import parallel

    m = _tiny_model()
    dp = parallel.DataParallel(m, _sgd(m.parameters()), _mse, device="cpu")
    return _dp_spec("dataparallel.train_step", dp)


def _dp_zero_guard_train_step() -> ProgramSpec:
    from tpu_syncbn_torch import parallel

    m = _tiny_model()
    dp = parallel.DataParallel(m, torch.optim.Adam(m.parameters(), lr=1e-3), _mse,
                               zero=True, divergence_guard="skip_step", device="cpu")
    return _dp_spec("dataparallel.zero_guard.train_step", dp)


def _dp_scan(k: int) -> ProgramSpec:
    from tpu_syncbn_torch import parallel

    m = _tiny_model()
    dp = parallel.DataParallel(m, _sgd(m.parameters()), _mse, device="cpu")
    return _dp_spec(f"dataparallel.scan_k{k}.train_steps", dp, k=k, stacked=True)


def _layout_train_step(kind: str) -> ProgramSpec:
    """The same Adam MLP step under plain DP, DP×FSDP at ``(data=2,
    fsdp=4)``, and DP×FSDP on the int8 wire."""
    from tpu_syncbn_torch import parallel

    kw: dict = {}
    if kind == "dp":
        layout = parallel.SpecLayout.data_parallel(device="cpu")
    else:
        layout = parallel.SpecLayout.fsdp(data=-1, fsdp=4, device="cpu")
        if kind == "dp_fsdp_int8":
            kw["compress"] = "int8"
    m = _compress_mlp()
    dp = parallel.DataParallel(m, torch.optim.Adam(m.parameters(), lr=1e-3), _mse,
                               layout=layout, device="cpu", **kw)
    return _dp_spec(f"layout.{kind}.train_step", dp, declared=("params", "opt_state"))


def _dp_compressed_train_step(mode: str) -> ProgramSpec:
    """The MLP step at wire fp32 / bf16 / int8 with the guard armed and
    monitors off (the ratio pinned sharply, as JAX's trio)."""
    from tpu_syncbn_torch import parallel

    m = _compress_mlp()
    dp = parallel.DataParallel(
        m, _sgd(m.parameters()), _mse, compress="none" if mode == "fp32" else mode,
        divergence_guard="skip_step", monitors=False, device="cpu")
    return _dp_spec(f"dataparallel.compressed_{mode}.train_step", dp,
                    declared=("params", "opt_state"))


def _autopilot_train_step(mode: str) -> ProgramSpec:
    """The autopilot's rungs as it runs them: ONE trainer built at int8
    with error feedback, then ``set_compress``ed to the rung."""
    from tpu_syncbn_torch import parallel

    m = _compress_mlp()
    dp = parallel.DataParallel(
        m, _sgd(m.parameters()), _mse, compress="int8", error_feedback=True,
        divergence_guard="skip_step", monitors=False, device="cpu")
    dp.set_compress("none" if mode == "fp32" else mode)
    return _dp_spec(f"autopilot.compressed_{mode}.train_step", dp,
                    declared=("params", "opt_state"))


def _syncbn_compressed_stats() -> ProgramSpec:
    """``reduce_moments`` on the bf16 wire: (Σx, Σx²) compressed, the count
    an exact f32 psum."""
    from tpu_syncbn_torch.parallel import collectives

    group = _group()
    args = (_randn(_FEATURES, seed=2), _randn(_FEATURES, seed=3).abs(),
            torch.tensor(float(_GLOBAL_BATCH // _world())))
    data = P(DATA_AXIS)
    return ProgramSpec(
        name="syncbn.compressed_stats",
        fn=lambda s, sq, c: collectives.reduce_moments(s, sq, c, group, mode="bf16"),
        example_args=args, arg_labels=("sum", "sumsq", "count"), world=_world(),
        mesh_axes={DATA_AXIS: _world()}, in_specs=(data, data, data),
        # JAX's shard_map stacks each replica's (replicated) moments along
        # dim 0 under out_specs P('data') (jaxpr_audit.py:454-457)
        out_specs=(data, data, data))


def _gan_train_step() -> ProgramSpec:
    from tpu_syncbn_torch import parallel
    from tpu_syncbn_torch.parallel.trainer import _schedule_lrs

    g, d = _tiny_gan()
    gan = parallel.GANTrainer(g, d, torch.optim.Adam(g.parameters(), 1e-4),
                              torch.optim.Adam(d.parameters(), 1e-4), device="cpu")
    n = _GLOBAL_BATCH // _world()
    batch = (_randn(1, n, _FEATURES, seed=4), _randn(1, n, _LATENT, seed=5),
             _randn(1, n, _LATENT, seed=6))
    prog = gan._build_program(1, batch)
    for opt in (gan.g_optimizer, gan.d_optimizer):
        prog.opts[id(opt)].fill(_schedule_lrs(opt, None, 1))

    def buffers(m):
        return [b for b in m.buffers() if b is not None]

    # the step's batches unstacked, as JAX's step takes them (the body's
    # one-step stack is a view of each)
    return ProgramSpec(
        name="gan.train_step",
        fn=lambda *a: prog.loop(tuple(t.unsqueeze(0) for t in a[6:])),
        example_args=(list(g.parameters()), buffers(g), list(d.parameters()), buffers(d),
                      prog.opts[id(gan.g_optimizer)].state_tensors(),
                      prog.opts[id(gan.d_optimizer)].state_tensors(), *(b[0] for b in batch)),
        arg_labels=("g_params", "g_rest", "d_params", "d_rest",
                    "g_opt_state", "d_opt_state", "real", "z_d", "z_g"),
        declared_donated=("g_params", "g_rest", "d_params", "d_rest",
                          "g_opt_state", "d_opt_state"),
        world=_world(), mesh_axes={DATA_AXIS: _world()}, layout=gan.layout,
        in_specs=(P(),) * 6 + (P(DATA_AXIS),) * 3)


def _serve_eval_bucket() -> ProgramSpec:
    """The engine's bucket-8 program: its eval forward (what each bucket's
    CUDA graph records) on a bucket-sized batch."""
    from tpu_syncbn_torch.serve.engine import InferenceEngine

    eng = InferenceEngine(_tiny_model(), buckets=(8,), device="cpu")

    def forward(params, rest, batch):
        with torch.no_grad():
            return eng._forward(batch)

    return ProgramSpec(
        name="serve.eval_bucket8", fn=forward,
        example_args=(list(eng.model.parameters()),
                      [b for b in eng.model.buffers() if b is not None],
                      _randn(eng.buckets[0], _FEATURES, seed=7)),
        arg_labels=("params", "rest", "batch"), world=_world(),
        mesh_axes={DATA_AXIS: _world()}, in_specs=(P(), P(), P(DATA_AXIS)))


def _serve_redistribute() -> ProgramSpec:
    """ZeRO flat shards → the full parameter tree (the publication path):
    one tiled ``all_gather`` a dtype."""
    from tpu_syncbn_torch.parallel.layout import SpecLayout
    from tpu_syncbn_torch.parallel.redistribute import build_redistribute
    from tpu_syncbn_torch.parallel.zero import FlatLayout

    speclay = SpecLayout.zero(device="cpu")
    world = _world()
    layout = FlatLayout(dict(_tiny_model().named_parameters()), world)
    with torch.no_grad():
        full = layout.flatten(dict(_tiny_model().named_parameters()))
        store = {dt: v.view(world, -1)[_rank()].clone() for dt, v in full.items()}
    return ProgramSpec(
        name="serve.redistribute", fn=build_redistribute(layout, speclay),
        example_args=(store,), arg_labels=("store",), world=world,
        mesh_axes=dict(speclay.axis_sizes), layout=speclay, in_specs=(P(DATA_AXIS),))


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)

    return run


def _tensor_tp_mlp() -> ProgramSpec:
    """The Megatron MLP: column → gelu → row, ONE psum."""
    from tpu_syncbn_torch.parallel import tensor

    group, world = _group(), _world()
    d, h = _FEATURES, 2 * world
    w1, b1 = _randn(d, h, seed=8, shared=True), _randn(h, seed=9, shared=True)
    w2, b2 = _randn(h, d, seed=10, shared=True), _randn(d, seed=11, shared=True)
    r = _rank()
    args = (_randn(_GLOBAL_BATCH, d, seed=12, shared=True), tensor.shard_columns(w1, r, world),
            b1.chunk(world)[r], tensor.shard_rows(w2, r, world), b2)
    return ProgramSpec(
        name="tensor.tp_mlp",
        fn=_no_grad(lambda x, a, b, c, e: tensor.tp_mlp(x, a, b, c, e, group)),
        example_args=args, arg_labels=("x", "w1", "b1", "w2", "b2"), world=world,
        mesh_axes={MODEL_AXIS: world},
        in_specs=(P(), P(None, MODEL_AXIS), P(MODEL_AXIS), P(MODEL_AXIS, None), P()))


def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _pipeline_gpipe() -> ProgramSpec:
    """The GPipe forward over every rank as a stage: one ``ppermute`` a
    tick (``M + N − 1`` ticks)."""
    from tpu_syncbn_torch.parallel import pipeline

    world, d, m, mb = _world(), _FEATURES, 4, 2
    run = pipeline.pipeline_parallel(_stage_fn, _group())
    stacked = {"w": _randn(world, d, d, seed=13, shared=True),
               "b": _randn(world, d, seed=14, shared=True)}
    return ProgramSpec(
        name="pipeline.gpipe", fn=_no_grad(run),
        example_args=(stacked, _randn(m, mb, d, seed=15, shared=True)),
        arg_labels=("stage_params", "microbatches"), world=world,
        mesh_axes={PIPE_AXIS: world}, in_specs=(P(PIPE_AXIS), P()))


def _pipeline_train(schedule: str) -> ProgramSpec:
    """The pipeline training step's body on the ``(data=2, pipe=4)``
    layout: two ``ppermute``s a tick, the loss psum, the data-axis grad
    means; the 1f1b program with the guard armed."""
    from tpu_syncbn_torch.parallel import pipeline
    from tpu_syncbn_torch.parallel.trainer import _schedule_lrs

    n, m, mb, d = 4, 4, 2, _FEATURES

    def loss_fn(y, t):
        return ((y - t) ** 2).mean()

    rng = np.random.default_rng(0)
    stacked = {"w": rng.standard_normal((n, d, d)).astype(np.float32),
               "b": rng.standard_normal((n, d)).astype(np.float32)}
    tr = pipeline.PipelineTrainer(
        _stage_fn, loss_fn, stacked, _sgd, num_microbatches=m, schedule=schedule,
        layout=pipeline.pipeline_mesh(n, device="cpu"),
        divergence_guard="skip_step" if schedule == "1f1b" else None, device="cpu")
    batch = (_randn(m, mb, d, seed=16, shared=True), _randn(m, mb, d, seed=17, shared=True))
    prog = tr._build_program(1, False, batch)
    prog.chunk.opt.fill(_schedule_lrs(tr.optimizer, None, 1))
    opt_state = prog.chunk.opt.state_tensors()
    return ProgramSpec(
        name=f"pipeline.train_{schedule}",
        fn=lambda params, opt_state, b: prog.loop(b),
        example_args=(list(tr._params.values()), opt_state, batch),
        arg_labels=("params", "opt_state", "batch"),
        declared_donated=("params", "opt_state"), world=_world(),
        mesh_axes=dict(tr.layout.axis_sizes), layout=tr.layout,
        # the stage's parameters and their momenta over the pipe axis, the
        # steps' scalars replicated
        in_specs=(P(PIPE_AXIS), [P(PIPE_AXIS) if t.dim() else P() for t in opt_state],
                  P(None, DATA_AXIS)))


def _expert_switch_moe() -> ProgramSpec:
    """Switch MoE: two ``all_to_all``s (dispatch and return), the aux
    loss's mean."""
    from tpu_syncbn_torch.parallel import expert

    group, world = _group(), _world()
    d, h = _FEATURES, 4
    args = (_randn(8, d, seed=18), _randn(d, world, seed=19, shared=True),
            _randn(1, d, h, seed=20), _randn(1, h, d, seed=21))
    return ProgramSpec(
        name="expert.switch_moe",
        fn=_no_grad(lambda x, r, wi, wo: expert.expert_parallel_moe(x, r, wi, wo, group)),
        example_args=args, arg_labels=("x", "router_w", "w_in", "w_out"), world=world,
        mesh_axes={EXPERT_AXIS: world},
        in_specs=(P(EXPERT_AXIS), P(), P(EXPERT_AXIS), P(EXPERT_AXIS)))


def _sequence_ring_attention() -> ProgramSpec:
    """Ring attention: the (K, V) block one rank on per hop, N − 1 hops."""
    from tpu_syncbn_torch.parallel import sequence

    group, world = _group(), _world()
    b, l_local, h, dh = 2, 4, 2, 4
    qkv = tuple(_randn(b, l_local, h, dh, seed=22 + i) for i in range(3))
    return ProgramSpec(
        name="sequence.ring_attention",
        fn=_no_grad(lambda q, k, v: sequence.ring_attention(q, k, v, group)),
        example_args=qkv, arg_labels=("q", "k", "v"), world=world,
        mesh_axes={SEQ_AXIS: world}, in_specs=(P(None, SEQ_AXIS),) * 3)


PROGRAM_BUILDERS: dict[str, Callable[[], ProgramSpec]] = {
    "dataparallel.train_step": _dp_train_step,
    "dataparallel.zero_guard.train_step": _dp_zero_guard_train_step,
    "dataparallel.scan_k1.train_steps": lambda: _dp_scan(1),
    "dataparallel.scan_k4.train_steps": lambda: _dp_scan(4),
    "dataparallel.compressed_fp32.train_step":
        lambda: _dp_compressed_train_step("fp32"),
    "dataparallel.compressed_bf16.train_step":
        lambda: _dp_compressed_train_step("bf16"),
    "dataparallel.compressed_int8.train_step":
        lambda: _dp_compressed_train_step("int8"),
    "autopilot.compressed_fp32.train_step":
        lambda: _autopilot_train_step("fp32"),
    "autopilot.compressed_bf16.train_step":
        lambda: _autopilot_train_step("bf16"),
    "autopilot.compressed_int8.train_step":
        lambda: _autopilot_train_step("int8"),
    "layout.dp.train_step": lambda: _layout_train_step("dp"),
    "layout.dp_fsdp.train_step": lambda: _layout_train_step("dp_fsdp"),
    "layout.dp_fsdp_int8.train_step": lambda: _layout_train_step("dp_fsdp_int8"),
    "syncbn.compressed_stats": _syncbn_compressed_stats,
    "gan.train_step": _gan_train_step,
    "serve.eval_bucket8": _serve_eval_bucket,
    "serve.redistribute": _serve_redistribute,
    "tensor.tp_mlp": _tensor_tp_mlp,
    "pipeline.gpipe": _pipeline_gpipe,
    "pipeline.train_gpipe": lambda: _pipeline_train("gpipe"),
    "pipeline.train_1f1b": lambda: _pipeline_train("1f1b"),
    "expert.switch_moe": _expert_switch_moe,
    "sequence.ring_attention": _sequence_ring_attention,
}


def build_contracts(names: Sequence[str] | None = None, *, costs: dict | None = None,
                    errors: list | None = None, memory: bool = False
                    ) -> dict[str, ProgramContract]:
    """Record the registered programs in this process (its process group,
    or none: world 1) and return their contracts, each with its layer-3
    ``sharding`` block (``memory``: with the allocator's reading,
    ``xla_peak_bytes``). ``costs`` (a dict)
    receives each program's :func:`~tpu_syncbn_torch.audit.contracts.weighted_cost_summary`;
    with ``errors`` (a list) an :class:`ExtractionError` is appended as
    ``(name, rule, message)`` instead of raised. Memoized through
    :mod:`~tpu_syncbn_torch.audit.contract_cache`."""
    picked = list(PROGRAM_BUILDERS) if names is None else list(names)
    out: dict[str, ProgramContract] = {}
    for name in picked:
        spec = PROGRAM_BUILDERS[name]()
        try:
            out[name] = contract_cache.cached_contract(
                spec.fn, spec.example_args, name=spec.name, world=spec.world,
                arg_labels=spec.arg_labels, declared_donated=spec.declared_donated,
                steps=spec.steps, mesh_axes=spec.mesh_axes, in_specs=spec.in_specs,
                layout=spec.layout, out_specs=spec.out_specs, memory=memory)
        except ExtractionError as e:
            if errors is None:
                raise
            errors.append((name, e.rule, str(e)))
            continue
        if costs is not None:
            costs[name] = contract_cache.cached_cost(
                spec.fn, spec.example_args, name=spec.name, world=spec.world)
    return out


# ---------------------------------------------------------------------------
# the pinned world


def _replica(rank: int, world: int, rdv: str, out_dir: str, names,
             memory: bool = False) -> None:
    import torch.distributed as tdist

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                             rank=rank)
    try:
        blob = rank_blob(names, memory=memory)
        tmp = os.path.join(out_dir, f"rank{rank}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, os.path.join(out_dir, f"rank{rank}.json"))
    finally:
        tdist.destroy_process_group()


#: Layer-3 fields that are each rank's own: the world reports their
#: combination over ranks (:func:`merge_ranks`), not rank 0's.
RANK_LOCAL_SHARDING = ("out_specs", "peak_bytes_per_device", "max_replicated_bytes",
                       "xla_peak_bytes")


def _rank_view(contract: dict) -> dict:
    sharding = contract.get("sharding")
    if sharding is None:
        return contract
    return {**contract, "sharding": {k: v for k, v in sharding.items()
                                     if k not in RANK_LOCAL_SHARDING}}


def rank_blob(names: Sequence[str] | None = None, *, memory: bool = False) -> dict:
    """This rank's part of the pinned world, as JSON: its contracts, costs
    and extraction errors, and each program's output placements
    (layer 3's ``out_leaves``, which :func:`merge_ranks` combines)."""
    costs: dict = {}
    errors: list = []
    live = build_contracts(names, costs=costs, errors=errors, memory=memory)
    return {"contracts": {n: c.to_json() for n, c in live.items()},
            "costs": costs, "errors": errors,
            "outputs": {n: c.sharding.out_leaves for n, c in live.items()
                        if c.sharding is not None}}


def rank_diffs(per_rank: list[dict]) -> list[tuple[str, str, str]]:
    """``(name, rule, message)`` for every field in which a rank's contract
    differs from rank 0's (a program rank 0 has and another lacks too), the
    layer-3 fields of :data:`RANK_LOCAL_SHARDING` aside."""
    out = []
    per_rank = [{n: _rank_view(c) for n, c in r.items()} for r in per_rank]
    base = per_rank[0]
    for r, other in enumerate(per_rank[1:], start=1):
        for name in sorted(set(base) | set(other)):
            a, b = base.get(name), other.get(name)
            if a is None or b is None:
                holder = 0 if b is None else r
                out.append((name, "contract.rank_divergence",
                            f"{name}: only rank {holder} of ranks 0 and {r} recorded it"))
                continue
            for field in sorted(set(a) | set(b)):
                if a.get(field) != b.get(field):
                    out.append((name, "contract.rank_divergence",
                                f"{name}: rank {r} {field} = {b.get(field)!r}, rank 0 "
                                f"has {a.get(field)!r}"))
    return out


def pinned_world_contracts(names: Sequence[str] | None = None, *,
                           world: int = PINNED_WORLD,
                           timeout: float = PINNED_TIMEOUT_S,
                           memory: bool = False) -> dict:
    """Record the registry on ``world`` spawned gloo processes, every one
    on the CPU (``memory``: each layer-3 block with the allocator's
    reading, ``xla_peak_bytes``; the CLI's ``--shardings``). Returns ``{"contracts": {name: ProgramContract}`` (rank
    0's), ``"costs": {name: summary}`` (rank 0's, ``flops`` the largest of
    any rank: a pipeline's first stage computes no input gradient),
    ``"errors": [(name, rule, message)]`` (extraction errors and ranks
    that disagree), ``"seconds"``}. The caller's environment and process
    group are left alone."""
    import torch.multiprocessing as tmp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tpu_syncbn_audit_") as d:
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=_replica,
                             args=(r, world, os.path.join(d, "rdv"), d,
                                   None if names is None else list(names), memory))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5)
        if alive:
            raise RuntimeError(f"the pinned world of {world} processes was still "
                               f"running after {timeout:.0f} s")
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"the pinned world's processes exited {codes}")
        blobs = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                blobs.append(json.load(f))
    return {**merge_ranks(blobs), "seconds": time.perf_counter() - t0}


def merge_ranks(blobs: list[dict]) -> dict:
    """The pinned world's result from each rank's blob: rank 0's contracts
    and costs, with ``flops`` the largest of any rank (a pipeline's first
    stage computes no input gradient) and the layer-3 fields that are each
    rank's own combined as JAX's SPMD program would report them: the
    per-device peak and the largest replicated intermediate the largest of
    any rank, the output specs over every rank
    (:func:`~tpu_syncbn_torch.audit.sharding_audit.merge_out_leaves`);
    ``xla_peak_bytes`` stays rank 0's. ``errors``: extraction errors and
    ranks that disagree."""
    from tpu_syncbn_torch.audit.sharding_audit import merge_out_leaves

    errors = [tuple(e) for e in blobs[0]["errors"]]
    errors += rank_diffs([b["contracts"] for b in blobs])
    costs = blobs[0]["costs"]
    for name, cost in costs.items():
        cost["flops"] = max(b["costs"].get(name, {}).get("flops", 0) for b in blobs)
    contracts = {}
    for name, blob in blobs[0]["contracts"].items():
        sharding = blob.get("sharding")
        if sharding is not None and all(name in b["contracts"] for b in blobs):
            ranks = [b["contracts"][name]["sharding"] for b in blobs]
            sharding = {**sharding,
                        "peak_bytes_per_device": max(r["peak_bytes_per_device"] for r in ranks),
                        "max_replicated_bytes": max(r["max_replicated_bytes"] for r in ranks)}
            outs = [b.get("outputs", {}).get(name) for b in blobs]
            if all(o is not None for o in outs):
                sharding["out_specs"] = merge_out_leaves(outs)
            blob = {**blob, "sharding": sharding}
        contracts[name] = ProgramContract.from_json(blob)
    return {"contracts": contracts, "costs": costs, "errors": errors}


# ---------------------------------------------------------------------------
# invariants + golden comparison


def check_invariants(contracts: dict[str, ProgramContract]) -> list[Violation]:
    """Cross-program rules that hold whatever the goldens pin: JAX's rules
    under JAX's names, restated for recorded bodies (``DESIGN.md`` §4).
    Counts are per optimizer step; where the port executes what JAX's
    program text spells once (the pipeline's ticks, the ring's hops) the
    rule says so."""
    out: list[Violation] = []

    def v(rule: str, msg: str) -> None:
        out.append(Violation(rule=rule, message=msg, path="<recording>", line=0))

    serve = contracts.get("serve.eval_bucket8")
    if serve is not None:
        if serve.total_collectives:
            v("contract.serve_collectives",
              "serve eval program must be collective-free, found "
              f"{serve.collectives} — eval BN must normalize with running stats")
        if sum(serve.donated_aliased.values()):
            v("contract.serve_donation",
              "serve eval program must write none of its inputs (the batcher's "
              f"staging and the weights the graphs read), found {serve.donated_aliased}")

    rd = contracts.get("serve.redistribute")
    if rd is not None:
        if not rd.collectives.get("all_gather", 0):
            v("contract.redistribute_gather",
              "serve.redistribute must move shards with all_gather, found "
              f"{rd.collectives} — a host gather smuggled back in leaves no collectives")
        extra = {k: n for k, n in rd.collectives.items() if k != "all_gather"}
        if extra:
            v("contract.redistribute_gather",
              "serve.redistribute is a pure layout change: all_gather only, found "
              f"extra collectives {extra}")

    k1 = contracts.get("dataparallel.scan_k1.train_steps")
    k4 = contracts.get("dataparallel.scan_k4.train_steps")
    if k1 is not None and k4 is not None and (
            k1.collectives != k4.collectives
            or k1.collective_bytes != k4.collective_bytes):
        v("contract.scan_variance",
          "a K-step chunk's collectives must be K times one step's (per optimizer "
          f"step): K=1 {k1.collectives} {k1.collective_bytes} vs K=4 "
          f"{k4.collectives} {k4.collective_bytes}")

    tp = contracts.get("tensor.tp_mlp")
    if tp is not None and tp.collectives != {"psum": 1}:
        v("contract.tp_one_psum",
          "the Megatron column->row pairing costs exactly ONE psum, found "
          f"{tp.collectives}")

    gp = contracts.get("pipeline.gpipe")
    if gp is not None:
        if gp.collectives.get("psum", 0):
            v("contract.pipeline_ring",
              "pipeline.gpipe must be psum-free (the stage-stacked output needs no "
              f"mask), found {gp.collectives}")
        if not gp.collectives.get("ppermute", 0):
            v("contract.pipeline_ring",
              f"pipeline.gpipe lost its ppermute ring: {gp.collectives}")
    for sched in ("gpipe", "1f1b"):
        c = contracts.get(f"pipeline.train_{sched}")
        if c is None:
            continue
        # executed: two a tick (JAX's text: the two in the tick body)
        n = c.collectives.get("ppermute", 0)
        if n == 0 or n % 2:
            v("contract.pipeline_ring",
              f"pipeline.train_{sched} must move activations and cotangents "
              f"through exactly TWO ppermutes a tick (2·T a step), found {c.collectives}")
        gathered = {k: n for k, n in c.collectives.items()
                    if k in ("all_gather", "all_to_all")}
        if gathered:
            v("contract.pipeline_ring",
              f"pipeline.train_{sched} gathers instead of ringing ({gathered}) — a "
              "stage materialized another stage's state")

    # the composed DP×FSDP layout's memory claim: sharding the parameters
    # and Adam's moments 1/fsdp has to show in the per-device peak
    pair = ("layout.dp_fsdp.train_step", "layout.dp.train_step")
    fs_l, dp_l = (contracts.get(n) for n in pair)
    if (dp_l is not None and fs_l is not None
            and dp_l.sharding is not None and fs_l.sharding is not None):
        dp_peak = dp_l.sharding.peak_bytes_per_device
        fs_peak = fs_l.sharding.peak_bytes_per_device
        ratio = fs_peak / max(1, dp_peak)
        item = PEAK_ITEMS.get(pair)
        if fs_peak > FSDP_PEAK_RATIO * dp_peak and item is None:
            v("contract.fsdp_peak_memory",
              "composed DP×FSDP train step must hold per-device peak memory ≤ "
              f"{FSDP_PEAK_RATIO}× the DP-only program, found {fs_peak} vs {dp_peak} bytes "
              f"(ratio {ratio:.2f}) — flat param/opt shards are no longer paying for the "
              "composition (ROADMAP C.7: the module's full parameters held between steps)")
        elif fs_peak <= FSDP_PEAK_RATIO * dp_peak and item is not None:
            v("contract.fsdp_peak_memory",
              f"DP×FSDP peak ratio {ratio:.2f} is within {FSDP_PEAK_RATIO}×: ROADMAP "
              f"{item} is repaired — take the pair out of program_audit.PEAK_ITEMS")

    moe = contracts.get("expert.switch_moe")
    if moe is not None and moe.collectives.get("all_to_all", 0) != 2:
        v("contract.moe_two_all_to_all",
          "expert-parallel MoE relocates compute with exactly TWO all_to_alls "
          f"(dispatch + return), found {moe.collectives}")

    for fam in ("dataparallel", "autopilot"):
        fp32c = contracts.get(f"{fam}.compressed_fp32.train_step")
        if fp32c is None:
            continue
        for mode, factor in (("bf16", 2.0), ("int8", 3.5)):
            c = contracts.get(f"{fam}.compressed_{mode}.train_step")
            if c is None:
                continue
            ratio = lossy_collective_bytes(fp32c) / max(1, lossy_collective_bytes(c))
            if ratio < factor:
                v("contract.compression_ratio",
                  f"{fam} compressed_{mode} train step puts {lossy_collective_bytes(c)} "
                  f"lossy-eligible bytes on the wire vs {lossy_collective_bytes(fp32c)} "
                  f"fp32 — ratio {ratio:.2f} < the floor {factor}×")
            if (c.collectives.get("pmin", 0) != fp32c.collectives.get("pmin", 0)
                    or c.collective_bytes.get("pmin", 0)
                    != fp32c.collective_bytes.get("pmin", 0)):
                v("contract.guard_stays_fp32",
                  f"{fam} compressed_{mode} train step's divergence-guard pmin "
                  f"({c.collectives.get('pmin', 0)} call(s), "
                  f"{c.collective_bytes.get('pmin', 0)} B) differs from the fp32 "
                  "program's — the finiteness consensus must never ride a lossy wire")

    stats = contracts.get("syncbn.compressed_stats")
    if stats is not None and not stats.collectives.get("pmax"):
        if stats.collectives.get("psum", 0) < 2:
            v("contract.stats_count_exact",
              "syncbn.compressed_stats must reduce the count through its own exact "
              f"psum next to the compressed payload, found {stats.collectives}")

    for name, c in contracts.items():
        for label in c.donated_declared:
            if not c.donated_aliased.get(label):
                v("contract.donation_lost",
                  f"{name}: state {label!r} must be updated in place but the body "
                  "wrote none of its tensors at their addresses — a replaced "
                  "tensor breaks every captured replay (ScanSteps.stale)")
        written = {k: n for k, n in c.donated_aliased.items()
                   if k not in c.donated_declared}
        if written:
            v("contract.input_written",
              f"{name}: the body wrote inputs it does not own: {written}")
        item = HOST_READ_ITEMS.get(name)
        reads = {k: n for k, n in c.host_callbacks.items()
                 if not (item and k.endswith("@optimizer.step"))}
        if reads:
            v("contract.host_callback",
              f"{name}: host read(s) {reads} inside a step body — each one "
              "synchronizes the device, and a CUDA graph cannot capture it")
        elif c.host_callbacks and item:
            pass  # torch's CPU Adam (ROADMAP C.6): pinned exactly by the golden
        elif any(k.endswith("@optimizer.step") for k in c.host_callbacks):
            v("contract.host_callback",
              f"{name}: host read(s) {c.host_callbacks} inside the optimizer step "
              "of a program not listed under ROADMAP C.6")
    return out


def check_sharding(contracts: dict[str, ProgramContract], *,
                   mem_budget: int | None = None) -> list[Violation]:
    """Layer 3's detectors, whatever the goldens pin (JAX's
    ``check_sharding``, ``jaxpr_audit.py:987-1025``): accidental replication
    above the threshold, implicit reshards, and with ``mem_budget`` (bytes)
    the per-device peak, the larger of the recorded peak and the
    allocator's reading."""
    out: list[Violation] = []

    def v(rule: str, msg: str) -> None:
        out.append(Violation(rule=rule, message=msg, path="<recording>", line=0))

    for name, c in contracts.items():
        s = c.sharding
        if s is None:
            continue
        for detail in s.replication_detail:
            v("sharding.replication",
              f"{name}: intermediate materialized fully replicated on every device above "
              f"the {s.replication_threshold}-byte threshold — {detail}. Shard it, or "
              "gather closer to its use site")
        for detail in s.reshard_detail:
            v("sharding.implicit_reshard",
              f"{name}: layout change not explained by a declared collective — {detail}")
        if mem_budget is not None:
            peak = max(s.peak_bytes_per_device, s.xla_peak_bytes or 0)
            if peak > mem_budget:
                v("sharding.mem_budget",
                  f"{name}: per-device peak {peak} B exceeds the --mem-budget contract of "
                  f"{mem_budget} B (recorded {s.peak_bytes_per_device} B, allocator "
                  f"{s.xla_peak_bytes} B)")
    return out


def check_goldens(contracts: dict[str, ProgramContract],
                  golden_dir: str) -> tuple[list[Violation], list[str]]:
    """Compare live contracts to the pinned goldens: ``(violations,
    unpinned)``."""
    violations: list[Violation] = []
    unpinned: list[str] = []
    for name, contract in contracts.items():
        path = golden_path(golden_dir, name)
        if not os.path.exists(path):
            unpinned.append(name)
            continue
        golden = load_contract(path)
        for diff in compare_contracts(contract, golden):
            violations.append(Violation(rule="contract.golden_mismatch", message=diff,
                                        path=os.path.relpath(path), line=0))
    return violations, unpinned


def golden_diffs(contracts: dict[str, ProgramContract],
                 golden_dir: str) -> dict[str, list[str]]:
    """Per-contract field-level old → new summary against the goldens
    (what ``--write-goldens`` prints); a new program maps to one marker."""
    out: dict[str, list[str]] = {}
    for name, contract in contracts.items():
        path = golden_path(golden_dir, name)
        if not os.path.exists(path):
            out[name] = ["<new golden — no previous pin>"]
            continue
        golden = load_contract(path)
        diffs = compare_contracts(contract, golden)
        # the comparison skips xla_peak_bytes when either side took no
        # reading, but a re-pin that would erase a pinned reading is a
        # reviewable change, not a silent one
        if (golden.sharding is not None and golden.sharding.xla_peak_bytes is not None
                and contract.sharding is not None
                and contract.sharding.xla_peak_bytes is None):
            diffs.append(
                f"{name}: sharding.xla_peak_bytes = None, golden pins "
                f"{golden.sharding.xla_peak_bytes} — re-pinning without --shardings would "
                "erase the memory cross-check (add --shardings, or --force to drop it "
                "deliberately)")
        if diffs:
            out[name] = diffs
    return out


def write_goldens(contracts: dict[str, ProgramContract], golden_dir: str) -> list[str]:
    """Pin (or re-pin) every contract as a golden JSON file; returns the
    paths written. Only after an intentional program change."""
    os.makedirs(golden_dir, exist_ok=True)
    written = []
    for name, contract in contracts.items():
        path = golden_path(golden_dir, name)
        save_contract(contract, path)
        written.append(path)
    return written
