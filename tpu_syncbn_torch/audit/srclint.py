"""Layer 2 of the port's audit: an AST lint of the port's own source —
the counterpart of ``tpu_syncbn.audit.srclint``. Each rule is a class of
bug that bit (or nearly bit) the JAX package or the port; the rule
docstrings cite the incident, and ``DESIGN.md`` §7 beside this file
places each of the JAX package's twelve rules (ported, re-aimed or
retired). Every rule has a planted-violation fixture under
``tests/torch_audit_fixtures/`` proving it can fire.

Suppression: a source line ending in ``# audit: ok`` suppresses every
rule on that line; ``# audit: ok[rule_id]`` suppresses one rule. Give
the reason in a comment beside it.

Standard library only (``ast``, ``re``, ``dataclasses``, ``os``): no
tracing, no device, nothing of the linted files is imported, so a sweep
runs wherever Python does (``chip_smoke.py`` ``[audit]`` lints the tree
on the card's host).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Iterable, Sequence

#: Telemetry metric-name schema: dotted lowercase with a subsystem
#: prefix (``serve.latency_s``, ``collectives.psum.bytes``).
METRIC_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
#: CounterGroup prefixes are a single schema token (the dot is added
#: when mirroring into the registry).
PREFIX_RE = re.compile(r"^[a-z0-9_]+$")

#: The port's subsystem vocabulary: the first dotted token of every
#: literal metric name (and every CounterGroup prefix) must come from
#: here, so a typo'd subsystem (``sevre.latency_s``) cannot mint a new
#: top-level family. ``tests/test_torch_audit_srclint.py`` holds it
#: against every name the port's producers register. The JAX package's
#: families, all of them: ``planner`` is the contract cache's, and
#: ``pipeline.bubble_frac`` is the gauge the autopilot reads.
KNOWN_METRIC_PREFIXES = frozenset({
    "audit", "autopilot", "bench", "checkpoint", "collectives", "compile",
    "data", "events", "gan", "incident", "loader", "mem", "monitor",
    "numerics", "obs", "pipeline", "planner", "probe", "rendezvous",
    "resilience", "scan", "serve", "slo", "step", "telemetry", "train",
})

#: The closed label-key vocabulary: every literal ``labels={...}`` key
#: must come from here. A new key is a new dimension, added deliberately.
LABEL_KEYS = frozenset({
    "tenant", "model", "version", "mode", "family", "device", "knob",
})
LABEL_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*$")

_SUPPRESS_RE = re.compile(r"#\s*audit:\s*ok(?:\[([a-z0-9_,\s]+)\])?")

#: The package directory this module lints by default.
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Directories of the package that hold no source of it.
_SKIP_DIRS = frozenset({"__pycache__", "_build"})


@dataclasses.dataclass
class Violation:
    """One finding of the audit, from either layer: the lint's carry a
    file and line, the program layer's ``path='<recording>'``."""

    rule: str
    message: str
    path: str
    line: int
    col: int = 0

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# AST helpers


def _attach_parents(tree: ast.AST) -> None:
    """Give every node its parent, and the tree the list of its nodes
    (one walk shared by every rule)."""
    nodes = []
    stack = [tree]
    while stack:
        node = stack.pop()
        nodes.append(node)
        for child in ast.iter_child_nodes(node):
            child._audit_parent = node  # type: ignore[attr-defined]
            stack.append(child)
    tree._audit_nodes = nodes  # type: ignore[attr-defined]


def _nodes(tree: ast.AST) -> list:
    """Every node of ``tree`` (``ast.walk``'s set, computed once)."""
    nodes = getattr(tree, "_audit_nodes", None)
    return nodes if nodes is not None else list(ast.walk(tree))


def _parent(node: ast.AST):
    return getattr(node, "_audit_parent", None)


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain; None for anything dynamic."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_name(func: ast.AST) -> str | None:
    """The last name of a call target (``f`` of ``f(...)``/``a.b.f(...)``)."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _enclosing_functions(node: ast.AST) -> Iterable[ast.AST]:
    cur = _parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield cur
        cur = _parent(cur)


def _in_with_on(node: ast.AST, attr_names: set[str]) -> bool:
    """Is ``node`` lexically inside a ``with self.<lock>:`` block for any
    lock attribute in ``attr_names``?"""
    cur = _parent(node)
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                d = _dotted(item.context_expr)
                if d is None and isinstance(item.context_expr, ast.Call):
                    d = _dotted(item.context_expr.func)
                if d and d.startswith("self.") and d[5:] in attr_names:
                    return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        cur = _parent(cur)
    return False


def _first_str_arg(call: ast.Call) -> tuple[str, ast.AST] | None:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value, call.args[0]
    return None


def _walk_own_body(fdef: ast.AST) -> Iterable[ast.AST]:
    """Every node of ``fdef`` EXCLUDING the subtrees of nested
    function/class definitions (lambdas are descended into: they run in
    the enclosing body)."""
    return _walk_own(ast.iter_child_nodes(fdef))


def _walk_own(starts: Iterable[ast.AST]) -> Iterable[ast.AST]:
    """The nodes under ``starts`` (themselves included), not descending
    into nested function/class definitions."""
    stack = list(starts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _param_defaults(fdef: ast.AST) -> list[tuple[ast.arg, ast.AST | None]]:
    """``(parameter, default)`` of a def: the defaults align with the tail
    of the positional parameters; a keyword-only one without a default
    pairs with None."""
    pos = list(fdef.args.posonlyargs) + list(fdef.args.args)
    return (list(zip(pos[len(pos) - len(fdef.args.defaults):], fdef.args.defaults))
            + list(zip(fdef.args.kwonlyargs, fdef.args.kw_defaults)))


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _import_bindings(tree: ast.AST) -> dict[str, str]:
    """Local name -> the dotted module path or object it was imported
    as, for every ``import``/``from ... import`` in the file
    (``import torch.distributed as tdist`` binds ``tdist`` to
    ``torch.distributed``; ``import torch`` binds ``torch``)."""
    out: dict[str, str] = {}
    for node in _nodes(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    top = alias.name.split(".", 1)[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom):
            module = "." * node.level + (node.module or "")
            for alias in node.names:
                out[alias.asname or alias.name] = f"{module}.{alias.name}"
    return out


def _resolved(node: ast.AST, imports: dict[str, str]) -> str | None:
    """The dotted path of a Name/Attribute chain with its first name
    replaced by what the file imported it as (``tdist.barrier`` ->
    ``torch.distributed.barrier``); None when the chain does not start at
    an imported name."""
    d = _dotted(node)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    if head not in imports:
        return None
    return imports[head] + ("." + rest if rest else "")


# ---------------------------------------------------------------------------
# rule: raw_api_bypass

#: ``torch.distributed`` functions that put bytes on the wire (or hold
#: every rank). The port's one home of them is ``parallel/collectives.py``,
#: whose ``_tally`` seam the audit's recorder and ``DispatchWireTally``
#: read: a raw call elsewhere is invisible to both.
RAW_COLLECTIVE_RE = re.compile(
    r"^(all_reduce\w*|all_gather\w*|reduce_scatter\w*|broadcast\w*"
    r"|all_to_all\w*|send|recv|isend|irecv|batch_isend_irecv|barrier"
    r"|monitored_barrier|reduce|gather\w*|scatter\w*)$"
)

#: The raw profiler entry points (and ``_KinetoProfile`` under any path):
#: a process singleton (Kineto) that wedges when started off the main
#: thread on the card. ``obs/profiling.py`` owns the main-thread hand-off
#: and the busy lock.
RAW_PROFILER_APIS = frozenset({
    "torch.profiler.profile",
    "torch.profiler.profiler.profile",
    "torch.autograd.profiler.profile",
})

#: (file suffix, dotted api) pairs allowed to touch a raw API; ``*`` is
#: every API of the rule.
RAW_API_ALLOW: tuple[tuple[str, str], ...] = (
    # the one home of the collectives and their tally seam
    ("tpu_syncbn_torch/parallel/collectives.py", "*"),
    # runtime.distributed.barrier: the host-side control plane every
    # rank's barrier("name") goes through; it puts no payload on the wire
    ("tpu_syncbn_torch/runtime/distributed.py", "torch.distributed.barrier"),
    # the checkpoint loader's agreement on rank 0's step: one int64 on
    # the default group before any program runs, never inside a body
    ("tpu_syncbn_torch/utils/checkpoint.py", "torch.distributed.broadcast"),
    # obs.profiling: the bounded, single-flight, main-thread capture
    ("tpu_syncbn_torch/obs/profiling.py", "torch.profiler.profile"),
)


def _raw_api_allowed(path: str, api: str) -> bool:
    norm = _norm(path)
    return any(norm.endswith(suffix) and allowed in ("*", api)
               for suffix, allowed in RAW_API_ALLOW)


def _raw_api_route(api: str) -> str | None:
    """The sanctioned route for ``api``, or None when it is not raw."""
    if api in RAW_PROFILER_APIS or api.rsplit(".", 1)[-1] == "_KinetoProfile":
        return ("obs.profiling.capture / profiler_trace (the main-thread "
                "hand-off and the single-flight lock)")
    head, _, name = api.rpartition(".")
    if head == "torch.distributed" and RAW_COLLECTIVE_RE.match(name):
        return ("parallel.collectives (its _tally seam feeds the audit's "
                "recorder and DispatchWireTally), or runtime.distributed "
                "for the host control plane")
    return None


def check_raw_api_bypass(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``raw_api_bypass``: a raw ``torch.distributed`` collective outside
    ``parallel/collectives.py``, or the raw torch profiler outside
    ``obs/profiling.py`` — the JAX rule's profiler half re-aimed, and its
    compat half replaced by the collectives seam. A raw collective
    bypasses ``collectives._tally``: the audit's recorder reports it as a
    wire op with no seam call and ``DispatchWireTally`` misses its bytes.
    A raw ``torch.profiler.profile`` started off the main thread wedges
    Kineto on the card. Names are resolved through the file's
    imports, so ``dist.barrier`` of the port's ``runtime.distributed``
    wrapper stays clean and ``torch.profiler.record_function`` is no
    profiler start."""
    imports = _import_bindings(tree)
    out: list[Violation] = []

    def flag(node: ast.AST, api: str, how: str) -> None:
        route = _raw_api_route(api)
        if route is None or _raw_api_allowed(path, api):
            return
        out.append(Violation(
            rule="raw_api_bypass", path=path, line=node.lineno,
            col=node.col_offset,
            message=f"{how} {api} — route through {route}",
        ))

    for node in _nodes(tree):
        if isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for alias in node.names:
                flag(node, f"{node.module}.{alias.name}",
                     f"`from {node.module} import {alias.name}`:")
        elif isinstance(node, ast.Attribute):
            if isinstance(_parent(node), ast.Attribute):
                continue  # only the top of each chain
            api = _resolved(node, imports)
            if api is not None:
                flag(node, api, "raw API")
    return out


# ---------------------------------------------------------------------------
# rule: host_sync_in_step

#: Functions that are step bodies themselves (and so is every def nested
#: in them): the bodies the port captures into a CUDA graph and the
#: program builders whose nested defs are such bodies. A function named
#: here that holds a ``with torch.cuda.graph(...)`` block has that block
#: as its body instead: the code around a capture is its set-up, run once
#: a build (``_Program._capture``'s warm-up and synchronizes).
STEP_BUILDER_RE = re.compile(
    r"^(_chunk_step|_program_body|_build_program|_forward|_capture"
    r"|_iteration)$"
)

#: Call targets whose function argument becomes a captured body:
#: ``scan_driver.build_scan_steps(step_fn, ...)`` and
#: ``torch.cuda.make_graphed_callables(callables, ...)``.
TRACE_ENTRIES = frozenset({"build_scan_steps", "make_graphed_callables"})

#: Host-sync method calls: each one copies to the host and waits for the
#: card, which a CUDA graph cannot capture (``cudaErrorStreamCaptureUnsupported``)
#: and which, eagerly, stalls the host once a step.
HOST_SYNC_ATTRS = frozenset({
    "item", "tolist", "cpu", "numpy", "synchronize", "nonzero", "unique",
    "masked_select", "argwhere",
})
#: ``torch.<name>`` functions with data-dependent output shapes: the
#: host reads the size from the card.
HOST_SYNC_TORCH = frozenset({"nonzero", "unique", "masked_select", "argwhere"})


def _graph_blocks(fdef: ast.AST) -> list[ast.With]:
    """The ``with torch.cuda.graph(...)`` blocks of ``fdef``'s own body."""
    out = []
    for node in _walk_own_body(fdef):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
            isinstance(item.context_expr, ast.Call)
            and (_dotted(item.context_expr.func) or "").endswith("cuda.graph")
            for item in node.items
        ):
            out.append(node)
    return out


def _entry_targets(arg: ast.AST) -> Iterable[ast.AST]:
    """The function expressions an argument of a trace entry stands for:
    itself, the first argument of a ``functools.partial``, the members of
    a tuple or list."""
    if isinstance(arg, (ast.Tuple, ast.List)):
        for elt in arg.elts:
            yield from _entry_targets(elt)
    elif isinstance(arg, ast.Call) and _call_name(arg.func) == "partial" \
            and arg.args:
        yield from _entry_targets(arg.args[0])
    else:
        yield arg


def _step_bodies(tree: ast.AST) -> dict[ast.AST, list[ast.AST]]:
    """Step-body scope -> the nodes that start its body. A scope is a def
    (its whole own body), or a def holding a capture block (the block's
    statements) or a lambda passed to a trace entry."""
    defs_by_name: dict[str, list[ast.AST]] = {}
    for node in _nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)
    roots: set[ast.AST] = set()
    lambdas: list[ast.Lambda] = []
    for node in _nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and STEP_BUILDER_RE.match(node.name):
            roots.add(node)
        elif isinstance(node, ast.Call) \
                and _call_name(node.func) in TRACE_ENTRIES:
            args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                          if kw.arg in ("step_fn", "callables")]
            for arg in args:
                for target in _entry_targets(arg):
                    if isinstance(target, ast.Lambda):
                        lambdas.append(target)
                        continue
                    name = (target.id if isinstance(target, ast.Name) else
                            target.attr if isinstance(target, ast.Attribute)
                            and _dotted(target.value) == "self" else None)
                    roots.update(defs_by_name.get(name, ()))
    bodies: dict[ast.AST, list[ast.AST]] = {}
    for node in _nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node in roots or any(f in roots for f in _enclosing_functions(node))
        ):
            blocks = _graph_blocks(node) if node in roots else []
            bodies[node] = ([s for b in blocks for s in b.body] if blocks
                            else list(ast.iter_child_nodes(node)))
    # every capture block is a body, wherever it is
    for node in _nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node not in bodies:
            blocks = _graph_blocks(node)
            if blocks:
                bodies[node] = [s for b in blocks for s in b.body]
    for lam in lambdas:
        bodies[lam] = [lam.body]
    return bodies


def step_body_functions(tree: ast.AST) -> list[ast.AST]:
    """The defs :func:`check_host_sync_in_step` checks as step bodies
    (``chip_smoke.py`` ``[audit]`` holds the bodies the card captures
    against them by file and first line)."""
    if getattr(tree, "_audit_nodes", None) is None:
        _attach_parents(tree)
    return [n for n in _step_bodies(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _host_sync(call: ast.Call) -> str | None:
    """The host-sync form ``call`` is, or None."""
    func = call.func
    dotted = _dotted(func) or ""
    name = _call_name(func)
    kws = {kw.arg for kw in call.keywords}
    if name == "one_hot" and "num_classes" not in kws and len(call.args) < 2:
        return "one_hot without num_classes"
    if name == "repeat_interleave" and "output_size" not in kws:
        # tensor repeats: the output's length is their sum, read on the
        # host; an int count (a literal) is known statically. The
        # function's one-argument form takes the repeats alone.
        args = list(call.args)
        if dotted.startswith("torch.") and len(args) > 1:
            args = args[1:]
        repeats = next((kw.value for kw in call.keywords
                        if kw.arg == "repeats"), args[0] if args else None)
        if repeats is None or isinstance(repeats, ast.Constant):
            return None
        return "repeat_interleave without output_size"
    if dotted == "torch.where" and len(call.args) == 1 and not call.keywords:
        return "torch.where(condition)"
    if dotted.startswith("torch.") and dotted.count(".") == 1 \
            and name in HOST_SYNC_TORCH:
        return dotted
    if isinstance(func, ast.Attribute) and name in HOST_SYNC_ATTRS:
        if name == "synchronize" and dotted == "torch.cuda.synchronize":
            return dotted
        return f".{name}()"
    return None


def check_host_sync_in_step(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``host_sync_in_step``: a host sync inside a step body — a function
    handed to ``scan_driver.build_scan_steps`` or
    ``torch.cuda.make_graphed_callables`` (directly, through
    ``functools.partial``, or as ``self.<method>``), the body of a
    ``with torch.cuda.graph(...)`` block, a function :data:`STEP_BUILDER_RE`
    names, and every def nested in these (each reported once).

    The JAX rule's idea on the port's entry points: a body that reads
    the card on the host cannot be captured (CUDA raises during capture)
    and eagerly stalls the host once a step. Host syncs: ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``
    and ``.synchronize()`` on a stream or event, ``torch.nonzero`` /
    ``.nonzero()``, ``torch.unique``, ``masked_select``, ``argwhere``
    and a one-argument ``torch.where``, ``F.one_hot`` without
    ``num_classes`` (ROADMAP C.5: it reads the index range on the host)
    and ``repeat_interleave`` of tensor repeats without ``output_size``.
    ``chip_smoke.py`` ``[audit]`` runs each form on a CUDA tensor under
    ``torch.cuda.set_sync_debug_mode("error")``: each must raise, and
    each near miss (``num_classes=``, ``output_size=``, a three-argument
    ``torch.where``, a pinned ``non_blocking`` upload) must not. A form
    the mode cannot see (:data:`NOT_OBSERVABLE`) is listed there as such
    and counts as no pass. A read after the replay (the trainer's guard
    ``.tolist()`` in ``_run_scanned``) is outside every body and clean,
    as the host read is the caller's in JAX."""
    out: list[Violation] = []
    for scope, starts in _step_bodies(tree).items():
        name = getattr(scope, "name", "<lambda>")
        # nested defs are their own scopes
        for node in _walk_own(starts):
            if not isinstance(node, ast.Call):
                continue
            hit = _host_sync(node)
            if hit:
                out.append(Violation(
                    rule="host_sync_in_step", path=path, line=node.lineno,
                    col=node.col_offset,
                    message=f"host-sync call {hit} inside step body "
                            f"{name!r} — a captured graph cannot hold it "
                            "and the eager step waits for the card",
                ))
    return out


#: The host-sync forms the rule names, one a call ``chip_smoke.py``
#: ``[audit]`` runs on a CUDA tensor under sync debug mode "error".
HOST_SYNC_FORMS = (
    ".item()", ".tolist()", ".cpu()", ".numpy()", "torch.cuda.synchronize",
    "stream.synchronize()", "event.synchronize()", "torch.nonzero",
    ".nonzero()", "torch.unique", ".unique()", "torch.masked_select",
    ".masked_select()", "torch.argwhere", ".argwhere()",
    "torch.where(condition)", "one_hot without num_classes",
    "repeat_interleave without output_size",
)

#: Forms of :data:`HOST_SYNC_FORMS` that ``torch.cuda.set_sync_debug_mode``
#: does not report on the card (``chip_smoke.py`` ``[audit]`` prints them
#: as not observable, and counts them as no pass). On an H100 under torch
#: 2.11 (cu128): ``.numpy()`` of a CUDA tensor raises a ``TypeError``
#: before any copy, and ``torch.cuda.synchronize`` and an event's
#: ``synchronize`` wait for the card without the mode's check (only a
#: stream's synchronize and the copies to the host are watched).
NOT_OBSERVABLE = frozenset({".numpy()", "torch.cuda.synchronize",
                            "event.synchronize()"})


# ---------------------------------------------------------------------------
# rule: unlocked_shared_state

#: Methods of a lock-owning class that mutate a shared container in
#: place must do it under the lock. These are the in-place mutators.
CONTAINER_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "add", "discard", "popitem", "setdefault", "appendleft", "popleft",
}
_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}


def _lock_held_methods(cls: ast.ClassDef, lock_attrs: set[str]) -> set[str]:
    """Private methods of ``cls`` that run only with a lock held: every
    reference to ``self.<method>`` in the class is a call, and each such
    call is inside ``with self.<lock>:`` or directly inside another such
    method (a fixpoint). A method never referenced is not one."""
    methods = {m.name: m for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    refs: dict[str, list[tuple[ast.AST, str | None]]] = {}
    for method in methods.values():
        for node in ast.walk(method):
            if isinstance(node, ast.Attribute) and node.attr in methods \
                    and _dotted(node.value) == "self":
                # a reference from a nested def runs whenever that def
                # does: only a lexical lock covers it
                inner = next(_enclosing_functions(node), None)
                refs.setdefault(node.attr, []).append(
                    (node, method.name if inner is method else None))
    # private helpers only: a public method is called from outside
    held = {name for name in refs
            if name.startswith("_") and not name.startswith("__")}
    changed = True
    while changed:
        changed = False
        for name in list(held):
            for node, caller in refs[name]:
                call = _parent(node)
                if not (isinstance(call, ast.Call) and call.func is node) \
                        or not (_in_with_on(node, lock_attrs)
                                or caller in held):
                    held.discard(name)
                    changed = True
                    break
    return held


def check_unlocked_shared_state(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``unlocked_shared_state``: in a class that owns a lock (it
    created ``threading.Lock/RLock/Condition`` in ``__init__``), an
    in-place mutation of a shared container attribute — or a
    ``+=``/``-=`` on a shared numeric counter (non-atomic
    read-modify-write) — outside a ``with self.<lock>:`` block. A torn
    dict update under a second thread is a heisenbug, not a test failure.
    The port's refinement: a method that runs only with the lock held
    (:func:`_lock_held_methods`, e.g. the audit recorder's ``_host_read``
    called from ``_on_op``'s locked block) is under the lock too."""
    out: list[Violation] = []
    for cls in _nodes(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        init = next((n for n in cls.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
        if init is None:
            continue
        lock_attrs: set[str] = set()
        container_attrs: set[str] = set()
        counter_attrs: set[str] = set()
        for stmt in ast.walk(init):
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            for target in targets:
                d = _dotted(target)
                if not d or not d.startswith("self.") or "." in d[5:]:
                    continue
                attr = d[5:]
                if _creates_lock(value):
                    lock_attrs.add(attr)
                elif _creates_container(value):
                    container_attrs.add(attr)
                elif isinstance(value, ast.Constant) \
                        and isinstance(value.value, (int, float)) \
                        and not isinstance(value.value, bool):
                    counter_attrs.add(attr)
        if not lock_attrs or not (container_attrs or counter_attrs):
            continue
        held = _lock_held_methods(cls, lock_attrs)
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) \
                    or method.name == "__init__" or method.name in held:
                continue
            for node in ast.walk(method):
                attr = _mutated_container_attr(node, container_attrs)
                if attr is None and isinstance(node, ast.AugAssign):
                    d = _dotted(node.target)
                    if d and d.startswith("self.") \
                            and d[5:] in counter_attrs:
                        attr = d[5:]
                if attr is None:
                    continue
                if _in_with_on(node, lock_attrs):
                    continue
                out.append(Violation(
                    rule="unlocked_shared_state", path=path,
                    line=node.lineno, col=node.col_offset,
                    message=f"self.{attr} mutated outside "
                            f"`with self.<lock>:` in {cls.name}."
                            f"{method.name} — this class owns "
                            f"{sorted(lock_attrs)} precisely because its "
                            "state is shared across threads",
                ))
    return out


def _creates_lock(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    d = _dotted(value.func) or ""
    return d.split(".")[-1] in _LOCK_FACTORIES


def _creates_container(value: ast.AST) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        d = _dotted(value.func) or ""
        return d.split(".")[-1] in {"dict", "list", "set", "deque",
                                    "defaultdict", "OrderedDict"}
    if isinstance(value, ast.BinOp):  # e.g. [0] * (n + 1)
        return _creates_container(value.left) \
            or _creates_container(value.right)
    return False


def _mutated_container_attr(
    node: ast.AST, container_attrs: set[str]
) -> str | None:
    def attr_of(expr: ast.AST) -> str | None:
        d = _dotted(expr)
        if d and d.startswith("self.") and d[5:] in container_attrs:
            return d[5:]
        return None

    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                hit = attr_of(t.value)
                if hit:
                    return hit
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                hit = attr_of(t.value)
                if hit:
                    return hit
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in CONTAINER_MUTATORS:
            return attr_of(node.func.value)
    return None


# ---------------------------------------------------------------------------
# rule: telemetry_name_schema

_TELEMETRY_HELPERS = {"count", "observe", "set_gauge", "timed"}
_REGISTRY_METHODS = {"counter", "gauge", "histogram"}


def _is_registry_getter(attr: str, base: str) -> bool:
    """``registry.counter(...)`` / ``REGISTRY.gauge(...)`` and friends."""
    return attr in _REGISTRY_METHODS and "registry" in base.lower()


def _is_label_sink(attr: str, base: str) -> bool:
    """Is this call a telemetry sink whose ``labels={...}`` kwarg mints
    registry series? Module helpers (``telemetry.count(...)`` and
    friends, plus ``inc_gauge``), Registry instrument getters, and
    ``CounterGroup.bump``."""
    if (attr in _TELEMETRY_HELPERS or attr == "inc_gauge") \
            and base.endswith("telemetry"):
        return True
    return _is_registry_getter(attr, base) or attr == "bump"


def check_telemetry_name_schema(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``telemetry_name_schema``: literal metric names must be dotted
    lowercase with a subsystem prefix (``serve.latency_s``) and
    ``CounterGroup`` prefixes a single token, both from
    :data:`KNOWN_METRIC_PREFIXES`; literal label keys come from
    :data:`LABEL_KEYS`. The JSONL export/merge and the incident bundles
    key on the schema."""
    out: list[Violation] = []
    for node in _nodes(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        func_name = _call_name(func)
        if func_name == "CounterGroup":
            for kw in node.keywords:
                if kw.arg == "prefix" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    if not PREFIX_RE.match(kw.value.value):
                        out.append(Violation(
                            rule="telemetry_name_schema", path=path,
                            line=kw.value.lineno, col=kw.value.col_offset,
                            message=f"CounterGroup prefix "
                                    f"{kw.value.value!r} must match "
                                    f"{PREFIX_RE.pattern}",
                        ))
                    elif kw.value.value not in KNOWN_METRIC_PREFIXES:
                        out.append(Violation(
                            rule="telemetry_name_schema", path=path,
                            line=kw.value.lineno, col=kw.value.col_offset,
                            message=f"CounterGroup prefix "
                                    f"{kw.value.value!r} is not a known "
                                    "subsystem token — typo, or extend "
                                    "KNOWN_METRIC_PREFIXES deliberately",
                        ))
            continue
        if not isinstance(func, ast.Attribute):
            continue
        base = _dotted(func.value) or ""
        if _is_label_sink(func.attr, base):
            for kw in node.keywords:
                if kw.arg != "labels" or not isinstance(kw.value, ast.Dict):
                    continue
                for k in kw.value.keys:
                    if not isinstance(k, ast.Constant) \
                            or not isinstance(k.value, str):
                        continue
                    if not LABEL_KEY_RE.match(k.value):
                        out.append(Violation(
                            rule="telemetry_name_schema", path=path,
                            line=k.lineno, col=k.col_offset,
                            message=f"label key {k.value!r} does not "
                                    f"match {LABEL_KEY_RE.pattern}",
                        ))
                    elif k.value not in LABEL_KEYS:
                        out.append(Violation(
                            rule="telemetry_name_schema", path=path,
                            line=k.lineno, col=k.col_offset,
                            message=f"label key {k.value!r} is not in "
                                    "the closed label vocabulary "
                                    f"{sorted(LABEL_KEYS)} — a new "
                                    "dimension is added deliberately, "
                                    "to LABEL_KEYS",
                        ))
        if not (func.attr in _TELEMETRY_HELPERS and base.endswith("telemetry")
                or _is_registry_getter(func.attr, base)):
            continue
        checked = _first_str_arg(node)
        if checked is None:
            continue
        name, lit = checked
        if not METRIC_NAME_RE.match(name):
            out.append(Violation(
                rule="telemetry_name_schema", path=path, line=lit.lineno,
                col=lit.col_offset,
                message=f"telemetry name {name!r} does not match the "
                        f"schema {METRIC_NAME_RE.pattern} "
                        "(subsystem-dotted lowercase)",
            ))
        elif name.split(".", 1)[0] not in KNOWN_METRIC_PREFIXES:
            out.append(Violation(
                rule="telemetry_name_schema", path=path, line=lit.lineno,
                col=lit.col_offset,
                message=f"telemetry name {name!r} has unknown subsystem "
                        f"prefix {name.split('.', 1)[0]!r} — typo, or "
                        "extend KNOWN_METRIC_PREFIXES deliberately",
            ))
    return out


# ---------------------------------------------------------------------------
# rule: unbounded_label_value

#: String literals shaped like per-request identity: long hex runs,
#: uuid prefixes, long digit runs.
_REQUEST_ID_LITERAL_RE = re.compile(
    r"(?i)(?:[0-9a-f]{12,}|[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}|\d{6,})"
)

#: Call names whose result is per-call-unique (or arbitrarily wide)
#: when fed to a label value.
_UNBOUNDED_VALUE_CALLS = {"str", "format", "hex", "uuid1", "uuid4"}


def check_unbounded_label_value(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``unbounded_label_value``: a label value built per request — an
    f-string, string concatenation/formatting, a ``str()``/``.format()``
    conversion, or a literal shaped like a request id. Labels are
    dimensions (tenant, model, mode: a small closed set of values);
    per-request identity belongs in trace spans and flight-recorder
    rings, not the registry keyspace, where each distinct value mints a
    series that lives for the process."""
    out: list[Violation] = []

    def flag(node: ast.AST, key: str, what: str) -> None:
        out.append(Violation(
            rule="unbounded_label_value", path=path,
            line=node.lineno, col=node.col_offset,
            message=f"label {key!r} gets {what} as its value — label "
                    "values must be a small closed set (per-request "
                    "identity belongs in traces/rings, not the registry "
                    "keyspace; overflow collapses into 'other')",
        ))

    for node in _nodes(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        base = _dotted(node.func.value) or ""
        if not _is_label_sink(node.func.attr, base):
            continue
        for kw in node.keywords:
            if kw.arg != "labels" or not isinstance(kw.value, ast.Dict):
                continue
            for k, v in zip(kw.value.keys, kw.value.values):
                key = (k.value if isinstance(k, ast.Constant)
                       and isinstance(k.value, str) else "?")
                if isinstance(v, ast.JoinedStr):
                    flag(v, key, "an f-string")
                elif isinstance(v, ast.BinOp):
                    flag(v, key, "string concatenation/%-formatting")
                elif isinstance(v, ast.Call):
                    cname = _call_name(v.func) or ""
                    if cname in _UNBOUNDED_VALUE_CALLS:
                        flag(v, key, f"a {cname}() result")
                elif isinstance(v, ast.Constant) \
                        and isinstance(v.value, str) \
                        and _REQUEST_ID_LITERAL_RE.search(v.value):
                    flag(v, key, "a request-id-shaped literal")
    return out


# ---------------------------------------------------------------------------
# rule: unpaired_trace_span

_SPAN_MAKERS_ATTR = {"span", "timed", "timed_span"}


def check_unpaired_trace_span(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``unpaired_trace_span``: a span/timer context manager created and
    discarded (``tracing.span("x")`` as a bare statement) — the span is
    never entered, so it never closes, and the trace silently loses the
    region. Spans must be ``with``-entered (or returned/stored for a
    caller's ``with``)."""
    out: list[Violation] = []
    for node in _nodes(tree):
        if not isinstance(node, ast.Expr) or not isinstance(node.value,
                                                            ast.Call):
            continue
        call = node.value
        name = None
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _SPAN_MAKERS_ATTR:
            base = _dotted(call.func.value) or ""
            # tracer.span / tracing.span / telemetry.timed /
            # stepstats.timed_span — not arbitrary .timed attrs
            if call.func.attr == "timed" and not base.endswith("telemetry"):
                continue
            name = _dotted(call.func)
        elif isinstance(call.func, ast.Name) \
                and call.func.id == "timed_span":
            name = "timed_span"
        if name is None:
            continue
        out.append(Violation(
            rule="unpaired_trace_span", path=path, line=node.lineno,
            col=node.col_offset,
            message=f"{name}(...) creates a context manager that is "
                    "immediately discarded — the span is never "
                    "entered/closed; use `with {0}(...):`".format(name),
        ))
    return out


# ---------------------------------------------------------------------------
# rule: wallclock_duration

def _is_wallclock_call(node: ast.AST) -> bool:
    """``time.time()`` in either spelling (``import time`` /
    ``from time import time``)."""
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    return d == "time.time" or (
        isinstance(node.func, ast.Name) and node.func.id == "time"
    )


def _outside_functions(tree: ast.AST) -> Iterable[ast.AST]:
    """Every node not inside a function (a def node itself included, as
    it sits in its enclosing scope)."""
    stack = [tree]
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def check_wallclock_duration(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``wallclock_duration``: a duration computed by subtracting
    ``time.time()`` readings. Wall clock steps and slews under NTP (and
    jumps across suspend), so a "duration" from it can be negative or
    minutes off — catastrophic in a deadline, watchdog or rate (the SLO
    tracker and every window of ``obs.timeseries`` key off elapsed
    time). Durations come from ``time.monotonic()`` /
    ``time.perf_counter()``; ``time.time()`` is for timestamps only.

    Detected forms: a ``-`` expression with a ``time.time()`` call on
    either side, and subtraction of names/attributes bound from
    ``time.time()`` in the same function (``t0 = time.time(); ...;
    elapsed = time.time() - t0``)."""
    out: list[Violation] = []

    def scan(scope_body: Iterable[ast.AST]) -> None:
        nodes = list(scope_body)
        # pass 1: names/attrs bound from time.time() anywhere in the
        # scope (binding-before-use is over-approximated, which for a
        # lint errs the right way)
        wall_names: set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign) and _is_wallclock_call(node.value):
                for t in node.targets:
                    d = _dotted(t)
                    if d:
                        wall_names.add(d)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and _is_wallclock_call(node.value):
                d = _dotted(node.target)
                if d:
                    wall_names.add(d)
        # pass 2: subtractions touching a wall-clock reading
        for node in nodes:
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)):
                continue
            sides = (node.left, node.right)
            hit = any(_is_wallclock_call(s) for s in sides) or any(
                (d := _dotted(s)) and d in wall_names for s in sides
            )
            if hit:
                out.append(Violation(
                    rule="wallclock_duration", path=path,
                    line=node.lineno, col=node.col_offset,
                    message="duration computed from time.time() — wall "
                            "clock steps/slews under NTP; use "
                            "time.monotonic() or time.perf_counter() "
                            "for elapsed time (time.time() is for "
                            "timestamps only)",
                ))

    # one scope per function (bindings don't leak across defs), plus the
    # module top level
    for fdef in _nodes(tree):
        if isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan(_walk_own_body(fdef))
    scan(_outside_functions(tree))
    return out


# ---------------------------------------------------------------------------
# rule: unbounded_blocking

def _is_thread_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func) or ""
    return d == "threading.Thread" or d == "Thread" or d.endswith(".Thread")


def _has_timeout(call: ast.Call) -> bool:
    return any(kw.arg == "timeout" for kw in call.keywords)


def check_unbounded_blocking(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``unbounded_blocking``: a blocking queue ``get()``/``put(item)``
    or thread ``join()`` with no timeout, inside a thread-owning scope
    (a class or function that constructs ``threading.Thread``). Any
    no-timeout wait in that position blocks *forever* when the peer
    thread has died: no error, no log, a stuck subsystem (the JAX
    serving batcher's ``close()`` incident). Bound the wait and handle
    expiry, or suppress with a comment explaining why the peer provably
    answers (a sentinel enqueued from ``close``).

    Detected forms (timeouts make each one clean): ``x.get()`` with no
    arguments, ``x.put(item)`` with a single argument, and ``x.join()``
    with no arguments. The port's refinement: a receiver bound by an
    ``import`` in the file is a module, not a queue or a thread, so
    ``flightrec.get()`` / ``memwatch.get()`` (the installed-instance
    accessors) are clean."""
    imports = _import_bindings(tree)
    threaded: set[ast.AST] = set()
    for node in _nodes(tree):
        if _is_thread_ctor(node):
            cur = _parent(node)
            while cur is not None:
                if isinstance(cur, (ast.ClassDef, ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    threaded.add(cur)
                cur = _parent(cur)
    out: list[Violation] = []
    for node in _nodes(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or _has_timeout(node):
            continue
        func = node.func
        attr = func.attr
        hit = None
        if attr == "get" and not node.args and not node.keywords:
            hit = ("queue-style .get() with no timeout blocks "
                   "forever if the producer thread died")
        elif attr == "put" and len(node.args) == 1 and not node.keywords:
            hit = ("bounded-queue .put(item) with no timeout blocks "
                   "forever if the consumer thread died")
        elif attr == "join" and not node.args and not node.keywords:
            hit = (".join() with no timeout blocks forever if the "
                   "thread is wedged — bound it and check "
                   "is_alive() after")
        if hit is None:
            continue
        if isinstance(func.value, ast.Name) and func.value.id in imports:
            continue  # a module's accessor, not a queue or a thread
        if not _inside(node, threaded):
            continue
        out.append(Violation(
            rule="unbounded_blocking", path=path,
            line=node.lineno, col=node.col_offset,
            message=f"{_dotted(func) or attr}: {hit}",
        ))
    return out


def _inside(node: ast.AST, scopes: set) -> bool:
    """Is ``node`` inside any of ``scopes``?"""
    cur = _parent(node)
    while cur is not None:
        if cur in scopes:
            return True
        cur = _parent(cur)
    return False


# ---------------------------------------------------------------------------
# rule: hardcoded_mesh_axis

#: Axis-name literals the rule polices: a layout can only rename or
#: compose axes centrally if no call site spells its own. The constants
#: live in tpu_syncbn_torch/mesh_axes.py, the ONE module allowed to
#: contain these.
MESH_AXIS_LITERALS = frozenset({"data", "model", "fsdp"})

#: Call targets whose string arguments are mesh-axis names: the JAX
#: package's sharding constructors and named-axis collectives, and the
#: port's ``init_device_mesh``/``DeviceMesh`` and ``SpecLayout.group``.
_AXIS_CALL_NAMES = frozenset({
    "PartitionSpec", "P", "Mesh", "AbstractMesh", "NamedSharding",
    "make_mesh",
    "psum", "pmean", "pmin", "pmax", "all_gather", "all_to_all",
    "reduce_scatter", "psum_scatter", "ppermute", "pgather",
    "axis_index", "axis_size", "pcast_varying", "broadcast",
    "init_device_mesh", "DeviceMesh", "group",
})

#: Keyword names that carry axis names in any call (the port's
#: ``mesh_dim_names=`` and the trainers' ``param_shard_axis=`` besides
#: JAX's).
_AXIS_KWARGS = frozenset({"axis_name", "axis_names", "axis",
                          "mesh_dim_names", "param_shard_axis"})

#: File suffixes allowed to contain the literals: the constants module.
_MESH_AXIS_ALLOW = ("tpu_syncbn_torch/mesh_axes.py",)


def _axis_literals_under(node: ast.AST) -> Iterable[ast.Constant]:
    """String constants in the policed set, looking through tuples/lists
    (``DeviceMesh(t, mesh, mesh_dim_names=("data",))``)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.Tuple, ast.List)):
            stack.extend(n.elts)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and n.value in MESH_AXIS_LITERALS:
            yield n


def check_hardcoded_mesh_axis(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``hardcoded_mesh_axis``: a mesh-axis name (``"data"`` /
    ``"model"`` / ``"fsdp"``) spelled as a string literal in an
    axis-naming position — a mesh or layout constructor argument, a
    collective's axis argument, an axis keyword or default, a
    ``mesh[...]`` index, or an ``*_AXIS`` constant assignment — anywhere
    outside ``tpu_syncbn_torch/mesh_axes.py``. Import the constant
    instead: a layout refactor renames or composes axes centrally, and a
    private literal is the coupling that breaks it silently."""
    norm = _norm(path)
    if any(norm.endswith(suffix) for suffix in _MESH_AXIS_ALLOW):
        return []
    out: list[Violation] = []

    def hit(lit: ast.Constant, where: str) -> None:
        out.append(Violation(
            rule="hardcoded_mesh_axis", path=path, line=lit.lineno,
            col=lit.col_offset,
            message=f"mesh-axis literal {lit.value!r} {where} — import "
                    "the constant from tpu_syncbn_torch.mesh_axes (the "
                    "one module allowed to spell axis names)",
        ))

    for node in _nodes(tree):
        if isinstance(node, ast.Call):
            fname = _call_name(node.func)
            if fname in _AXIS_CALL_NAMES:
                for arg in node.args:
                    for lit in _axis_literals_under(arg):
                        hit(lit, f"as a {fname}(...) argument")
            for kw in node.keywords:
                if kw.arg in _AXIS_KWARGS:
                    for lit in _axis_literals_under(kw.value):
                        hit(lit, f"as the {kw.arg}= keyword")
        elif isinstance(node, ast.Subscript):
            if (_dotted(node.value) or "").rsplit(".", 1)[-1] == "mesh":
                for lit in _axis_literals_under(node.slice):
                    hit(lit, "as a mesh[...] index")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for arg, default in _param_defaults(node):
                if arg.arg in _AXIS_KWARGS and default is not None:
                    for lit in _axis_literals_under(default):
                        hit(lit, f"as the default of {arg.arg!r}")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id.endswith("_AXIS")
                   for t in targets) and node.value is not None:
                for lit in _axis_literals_under(node.value):
                    hit(lit, "bound to an *_AXIS constant outside the "
                             "constants module")
    return out


# ---------------------------------------------------------------------------
# rule: private_mesh_plumbing

#: Process-group and mesh constructors the rule polices. Annotations and
#: isinstance checks are fine; the hazard is CONSTRUCTING one.
_MESH_CTOR_RE = re.compile(
    r"^(DeviceMesh|init_device_mesh|new_group|new_subgroups\w*)$")

#: File suffixes allowed to construct them: the layout layer.
_PRIVATE_MESH_ALLOW = (
    # SpecLayout: the one object that owns the mesh, its groups and specs
    "tpu_syncbn_torch/parallel/layout.py",
    # the subgroups of collectives.group_for, cached a spec
    "tpu_syncbn_torch/parallel/collectives.py",
    # make_mesh, the device-enumeration factory SpecLayout builds on
    # (the JAX package allows its runtime/distributed.py for the same)
    "tpu_syncbn_torch/runtime/distributed.py",
    "tpu_syncbn_torch/mesh_axes.py",
)


def check_private_mesh_plumbing(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``private_mesh_plumbing``: a ``DeviceMesh`` / ``init_device_mesh``
    / ``torch.distributed.new_group`` / ``new_subgroups*`` constructed
    outside the layout layer. Trainers, engines and strategy modules
    consume a :class:`~tpu_syncbn_torch.parallel.layout.SpecLayout` (or
    ``runtime.distributed.make_mesh`` / ``collectives.group_for``)
    instead of assembling their own groups: a private group is the
    siloing that keeps DP, ZeRO, TP and pipeline from composing on one
    mesh, and a ``new_group`` a call site makes afresh is a new NCCL
    communicator every time (the layer caches one a spec)."""
    norm = _norm(path)
    if any(norm.endswith(suffix) for suffix in _PRIVATE_MESH_ALLOW):
        return []
    out: list[Violation] = []
    for node in _nodes(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _call_name(node.func)
        if fname and _MESH_CTOR_RE.match(fname):
            out.append(Violation(
                rule="private_mesh_plumbing", path=path,
                line=node.lineno, col=node.col_offset,
                message=f"{fname}(...) constructed outside the layout "
                        "layer — consume a parallel.layout.SpecLayout "
                        "(layout.group(axes), the presets), "
                        "runtime.distributed.make_mesh or "
                        "collectives.group_for; a private group is the "
                        "siloing that keeps DP/FSDP/TP/pipe from "
                        "composing into one program",
            ))
    return out


# ---------------------------------------------------------------------------
# rule: lossy_default_mode

#: Parameter names that carry a wire-compression mode anywhere in the
#: stack (``collectives.compressed_*``, the trainers' ``compress=``,
#: SyncBN's ``stats_compress=``).
_LOSSY_MODE_PARAMS = frozenset({
    "mode", "compress", "stats_compress", "compress_stats",
    "grad_compression",
})
#: The lossy wire dtypes. ``"none"``/``None``/``"fp32"`` defaults are
#: clean; these as a DEFAULT are the hazard.
_LOSSY_MODE_LITERALS = frozenset({"bf16", "int8"})


def check_lossy_default_mode(
    tree: ast.AST, path: str, src_lines: Sequence[str]
) -> list[Violation]:
    """``lossy_default_mode``: a compression-mode parameter whose
    *default* value is a lossy wire dtype (``"bf16"``/``"int8"``).
    Lossy collectives are opt-in at every call site: the divergence
    guard's ``pmin`` consensus and SyncBN's moment/count reductions must
    never ride a quantized wire because a caller forgot a flag. The
    program layer's ``contract.guard_stays_fp32`` pins the same property
    in the recorded programs."""
    out: list[Violation] = []
    for node in _nodes(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for arg, default in _param_defaults(node):
            if (
                arg.arg in _LOSSY_MODE_PARAMS
                and isinstance(default, ast.Constant)
                and default.value in _LOSSY_MODE_LITERALS
            ):
                out.append(Violation(
                    rule="lossy_default_mode", path=path,
                    line=default.lineno, col=default.col_offset,
                    message=f"parameter {arg.arg!r} of {node.name!r} "
                            f"defaults to lossy mode "
                            f"{default.value!r} — wire compression must "
                            "be explicit opt-in (default 'none'); a "
                            "lossy default silently re-routes every "
                            "caller, including guard/stat collectives",
                ))
    return out


# ---------------------------------------------------------------------------
# driver

#: Rule id -> check. The JAX package's ``donate_after_use`` is retired
#: (``DESIGN.md`` §7): the port has no donation, and state rebound
#: instead of written in place is the program layer's
#: ``contract.donation_lost``.
RULES: dict[str, Callable] = {
    "raw_api_bypass": check_raw_api_bypass,
    "host_sync_in_step": check_host_sync_in_step,
    "unlocked_shared_state": check_unlocked_shared_state,
    "telemetry_name_schema": check_telemetry_name_schema,
    "unbounded_label_value": check_unbounded_label_value,
    "unpaired_trace_span": check_unpaired_trace_span,
    "wallclock_duration": check_wallclock_duration,
    "unbounded_blocking": check_unbounded_blocking,
    "hardcoded_mesh_axis": check_hardcoded_mesh_axis,
    "private_mesh_plumbing": check_private_mesh_plumbing,
    "lossy_default_mode": check_lossy_default_mode,
}


def _suppressed(src_lines: Sequence[str], v: Violation) -> bool:
    if not v.line or v.line > len(src_lines):
        return False
    m = _SUPPRESS_RE.search(src_lines[v.line - 1])
    if not m:
        return False
    rules = m.group(1)
    if rules is None:
        return True
    return v.rule in {r.strip() for r in rules.split(",")}


def lint_file(path: str, *, rules: Sequence[str] | None = None) -> list[Violation]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, path, rules=rules)


def lint_source(
    src: str, path: str, *, rules: Sequence[str] | None = None
) -> list[Violation]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation(rule="parse_error", path=path,
                          line=e.lineno or 0,
                          message=f"file does not parse: {e.msg}")]
    _attach_parents(tree)
    src_lines = src.splitlines()
    out: list[Violation] = []
    for rule_id in (rules if rules is not None else RULES):
        for v in RULES[rule_id](tree, path, src_lines):
            if not _suppressed(src_lines, v):
                out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return out


def package_files(pkg_root: str | None = None) -> list[str]:
    """Every ``.py`` file under ``pkg_root`` (default: the port's package,
    found beside this module, not imported), sorted."""
    root = PKG_ROOT if pkg_root is None else pkg_root
    files: list[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
        for fn in filenames:
            if fn.endswith(".py"):
                files.append(os.path.join(dirpath, fn))
    return sorted(files)


def lint_package(
    pkg_root: str | None = None, *, rules: Sequence[str] | None = None
) -> list[Violation]:
    out: list[Violation] = []
    for path in package_files(pkg_root):
        out.extend(lint_file(path, rules=rules))
    return out
