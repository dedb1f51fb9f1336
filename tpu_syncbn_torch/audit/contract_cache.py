"""Memoized contract extraction: one recording per (program fingerprint,
world) per process — the counterpart of ``tpu_syncbn.audit.contract_cache``.

The planner (ROADMAP A.14c) will enumerate candidate layouts whose
programs often coincide, and an audit run in a process that already
planned rebuilds the registry's programs; recording a body again is pure
waste, so both paths key their extraction through this cache. The
fingerprint is everything that determines the recorded program, not the
callable's identity (trainers are rebuilt per call):

* the program name, and whether it is a contract or a cost,
* the world,
* every argument's structure and tensor shapes and dtypes,
* the declared in-place state and the steps a call applies,
* layer 3's mesh axes and declared specs, and whether the allocator's
  reading is taken.

Hits and misses are counted as ``planner.contract_cache_hits`` /
``planner.contract_cache_misses``. The cache is process-global and
unbounded: entries are small, and the candidate surface is enumerable.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from tpu_syncbn_torch.obs import telemetry

_CONTRACTS: dict[tuple, Any] = {}
_COSTS: dict[tuple, dict] = {}

#: Process-lifetime hit/miss tallies — the source of truth for
#: :func:`stats` (the telemetry counters mirror them, but telemetry may
#: be disabled).
_TALLY = {"hits": 0, "misses": 0}


def _signature(tree) -> Any:
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), str(tree.dtype))
    if isinstance(tree, dict):
        return ("D", tuple((str(k), _signature(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_signature(v) for v in tree))
    return (type(tree).__name__,)


def fingerprint(*, name: str, world: int, example_args: Sequence[Any],
                declared_donated: Sequence[str] = (), steps: int = 1,
                mesh_axes=None, in_specs=None, memory: bool = False) -> tuple:
    """The (program fingerprint, world) cache key."""
    return (name, int(world), _signature(tuple(example_args)),
            tuple(declared_donated), int(steps),
            None if mesh_axes is None else tuple(sorted(mesh_axes.items())),
            repr(in_specs), bool(memory))


def _cost_key(name: str, world: int, example_args) -> tuple:
    return fingerprint(name=name, world=world, example_args=example_args) + ("__cost__",)


def _lookup(cache: dict, key: tuple, build: Callable[[], Any]):
    if key in cache:
        _TALLY["hits"] += 1
        telemetry.count("planner.contract_cache_hits")
        return cache[key]
    _TALLY["misses"] += 1
    telemetry.count("planner.contract_cache_misses")
    cache[key] = build()
    return cache[key]


def cached_contract(fn: Callable, example_args: Sequence[Any], *, name: str, world: int,
                    arg_labels: Sequence[str], declared_donated: Sequence[str] = (),
                    steps: int = 1, mesh_axes=None, in_specs=None, layout=None,
                    out_specs=None, memory: bool = False):
    """Memoizing front end for
    :func:`tpu_syncbn_torch.audit.contracts.extract_contract` — same
    arguments, same return, at most one recording per fingerprint per
    process. The recording's cost is kept for :func:`cached_cost`."""
    from tpu_syncbn_torch.audit import contracts

    def build():
        rec: list = []
        out = contracts.extract_contract(
            fn, example_args, name=name, world=world, arg_labels=arg_labels,
            declared_donated=declared_donated, steps=steps, recording=rec,
            mesh_axes=mesh_axes, in_specs=in_specs, layout=layout, out_specs=out_specs,
            memory=memory)
        _COSTS.setdefault(_cost_key(name, world, example_args), rec[0].cost())
        return out

    key = fingerprint(name=name, world=world, example_args=example_args,
                      declared_donated=declared_donated, steps=steps, mesh_axes=mesh_axes,
                      in_specs=in_specs, memory=memory)
    return _lookup(_CONTRACTS, key, build)


def cached_cost(fn: Callable, example_args: Sequence[Any], *, name: str,
                world: int) -> dict:
    """Memoized :func:`tpu_syncbn_torch.audit.contracts.weighted_cost_summary`
    of one recorded application of ``fn(*example_args)`` (the state it
    moves put back) — the execution-weighted flop and byte figures the
    planner's cost model reads."""
    from tpu_syncbn_torch.audit import contracts

    def build():
        labels = [f"arg{i}" for i in range(len(example_args))]
        with contracts.Recorder(dict(zip(labels, example_args)), restore=True) as rec:
            fn(*example_args)
        return rec.cost()

    return _lookup(_COSTS, _cost_key(name, world, example_args), build)


def stats() -> dict:
    """Live hit/miss tallies plus entry counts (JSON-ready)."""
    return {
        "hits": _TALLY["hits"],
        "misses": _TALLY["misses"],
        "contracts": len(_CONTRACTS),
        "costs": len(_COSTS),
    }


def clear() -> None:
    """Drop every memoized entry and zero the tallies (tests; the
    mirrored telemetry counters are the registry's to reset)."""
    _CONTRACTS.clear()
    _COSTS.clear()
    _TALLY["hits"] = 0
    _TALLY["misses"] = 0
