"""Checkpoint / resume with integrity manifests, and weight publication —
the counterpart of ``tpu_syncbn.utils.checkpoint``.

The master process writes ("rank 0 writes", the recipe's convention for
logging too) any nest of dicts, lists and tuples whose leaves are tensors
or plain Python values: the trainer's ``state_dict()`` (parameters, BN
buffers, optimizer, scheduler and guard state), with numbered steps and
pruning.

The payload ``ckpt_{N}.pt`` is ``torch.save`` bytes, read back with
``torch.load(weights_only=True)``: tensors and plain containers only, so
loading a checkpoint runs no pickled code. It is certified by a sibling
``ckpt_{N}.manifest.json`` holding the payload's checksums (``sum64``
always; CRC32 too while the payload is small enough for a serial pass to
be free), byte length, step, and a hash of the tree's structure (names,
shapes, dtypes). Both files are written atomically (tmp + rename), payload
strictly before manifest, so a crash at any byte leaves either a fully
certified checkpoint or an uncertified leftover, never a certified but
truncated one. Loading the latest checkpoint skips candidates whose
certification fails and falls back to the newest verified older step.

Weight publication (the serving side's versioned hot swap,
``serve.publish``) writes ``weights_v{N}.pt`` and its
``weights_v{N}.manifest.json`` the same way, reads the landed payload back
against its manifest, and only then flips the ``published.json`` pointer
(:func:`publish_version`); :func:`load_published` resolves the pointer and
rejects a corrupt or structurally skewed version instead of falling back.

With more than one process, every rank restores the step the master
chose: one barrier, one broadcast of the master's pick over the default
group, then each follower reads that path (retrying briefly for a shared
filesystem's lagging listing) and checks it against its manifest.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import queue
import re
import tempfile
import threading
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as tdist

from tpu_syncbn_torch.obs import telemetry, tracing
from tpu_syncbn_torch.runtime import distributed as dist

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")
_PUB_RE = re.compile(r"^weights_v(\d+)\.pt$")

#: Bump when the manifest schema changes incompatibly.
MANIFEST_FORMAT = 1

#: The atomically renamed pointer file naming the currently published
#: weight version. Serving consumers resolve through it, never by listing
#: the directory: a half-written version is unreachable until the pointer
#: lands, and the pointer lands only after read-back verification.
PUBLISHED_POINTER = "published.json"

#: Payloads up to this size also get a CRC32 (serial, ~1 GB/s); above it
#: only the vectorized ``sum64`` checksum is computed, keeping
#: verification a small part of the checkpoint round trip at any size.
_CRC32_MAX_BYTES = int(
    float(os.environ.get("TPU_SYNCBN_CKPT_CRC32_MAX_MB", "32")) * (1 << 20)
)


def payload_sum64(data: bytes) -> str:
    """Fast integrity checksum: little-endian uint64 block sum (mod 2^64)
    plus the tail bytes and the length, hex-encoded. Runs at memory
    bandwidth via numpy (~10-20x zlib.crc32), and *guarantees* detection
    of truncation (length term) and any single bit flip (a flipped bit
    changes one block by ±2^k, which cannot cancel mod 2^64) — the two
    corruption modes a killed writer or bad disk actually produces."""
    mv = memoryview(data)
    head = len(data) & ~7
    if head:
        blocks = np.frombuffer(mv[:head], dtype="<u8")
        s = int(np.add.reduce(blocks, dtype=np.uint64))
    else:
        s = 0
    tail = int.from_bytes(bytes(mv[head:]), "little")
    s = (s + tail) & 0xFFFFFFFFFFFFFFFF
    return f"{s:016x}:{len(data):x}"


class CheckpointCorruptError(RuntimeError):
    """Raised when an explicitly requested checkpoint (or every available
    candidate) fails integrity verification or deserialization."""


class PublicationSkewError(RuntimeError):
    """Raised when a published weight version's recorded tree structure
    (manifest ``tree_hash``) does not match what the consumer expects — a
    publisher running ahead of (or behind) the server's model schema.
    Distinct from :class:`CheckpointCorruptError`: the bytes are intact,
    the *shape* is wrong, and retrying the read cannot help."""


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree, key=str)
                for item in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.manifest.json")


def tree_structure_hash(tree: Any) -> str:
    """Stable hash of a tree's *structure* (every leaf's path, and a
    tensor's dtype and shape or a plain value's type; values excluded),
    written into the manifest so a checkpoint records which model and
    optimizer shape produced it."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            kind = f"{leaf.dtype}:{tuple(leaf.shape)}"
        else:
            kind = type(leaf).__name__
        h.update(f"{path}={kind};".encode())
    return h.hexdigest()[:16]


def _atomic_write(directory: str, final_path: str, data: bytes) -> None:
    """tmp + rename in ``directory`` (same filesystem, hence atomic)."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, final_path)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def read_manifest(directory: str, step: int) -> dict | None:
    """The parsed manifest for ``step``, or None when absent/unreadable
    (a payload without a manifest loads, but cannot be *verified* and
    loses fallback priority to certified ones)."""
    try:
        with open(_manifest_path(directory, step)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _payload_matches(manifest: dict, data: bytes) -> bool:
    if manifest.get("nbytes") != len(data):
        return False
    sum64 = manifest.get("sum64")
    crc32 = manifest.get("crc32")
    if sum64 is None and crc32 is None:
        return False  # a manifest that certifies nothing certifies nothing
    if sum64 is not None and sum64 != payload_sum64(data):
        return False
    if crc32 is not None and crc32 != (zlib.crc32(data) & 0xFFFFFFFF):
        return False
    return True


def verify_checkpoint(directory: str, step: int) -> bool:
    """True iff ``step``'s payload exists AND its manifest certifies it
    (byte length and checksums match). A payload without a manifest, and
    anything truncated, bit-flipped or mid-write, reports False.
    Verification time and failures feed telemetry (``checkpoint.verify_s``
    / ``checkpoint.verify_failures``) under a ``checkpoint_verify`` span."""
    t0 = time.perf_counter()
    with tracing.span("checkpoint_verify", step=int(step)):
        ok = _verify_checkpoint_impl(directory, step)
    telemetry.observe("checkpoint.verify_s", time.perf_counter() - t0)
    if not ok:
        telemetry.count("checkpoint.verify_failures")
    return ok


def _verify_checkpoint_impl(directory: str, step: int) -> bool:
    manifest = read_manifest(directory, step)
    if manifest is None:
        return False
    try:
        with open(_path(directory, step), "rb") as f:
            data = f.read()
    except OSError:
        return False
    return _payload_matches(manifest, data)


def verified_steps(directory: str) -> list[int]:
    """Ascending steps whose manifest certifies the payload."""
    return [s for s in available_steps(directory)
            if verify_checkpoint(directory, s)]


def snapshot_to_host(tree: Any) -> Any:
    """Copy-before-step snapshot: ``tree`` with every tensor leaf an owned
    CPU copy, made in one batched device-to-host copy per (device, dtype):
    the leaves are packed into one flat buffer on their device, that
    buffer is copied to the host, and the leaves come back as views of the
    host buffer, which nothing else references. The next optimizer step
    updates the trainer's tensors in place, so a snapshot that merely
    referenced them would change under the background writer. Plain
    values (ints, floats, strings, None) are kept as they are."""
    groups: dict[tuple, dict[int, torch.Tensor]] = {}
    for _, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            groups.setdefault((leaf.device, leaf.dtype), {})[id(leaf)] = leaf
    host: dict[int, torch.Tensor] = {}
    for group in groups.values():
        ts = list(group.values())
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
        # cat already copied on the CPU; from a card, one copy to the host
        flat = flat.to("cpu")
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            host[id(t)] = part.view(t.shape)
    return _map(lambda x: host[id(x)] if isinstance(x, torch.Tensor) else x,
                tree)


def _to_bytes(host_tree: Any) -> bytes:
    buf = io.BytesIO()
    torch.save(host_tree, buf)
    return buf.getvalue()


def _from_bytes(data: bytes, target: Any) -> Any:
    """The tree in ``data`` (tensors on the CPU), after checking that it
    has ``target``'s structure (:func:`_check_structure`)."""
    tree = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    if target is not None:
        _check_structure(target, tree)
    return tree


def _check_structure(target: Any, tree: Any, path: str = "") -> None:
    """Raise ``ValueError`` unless ``tree`` has ``target``'s structure:
    the same dict keys and sequence lengths, and at each tensor leaf of
    ``target`` a tensor of the same shape and dtype. An empty dict in
    ``target`` takes any dict: a ``torch.optim`` optimizer holds no
    per-parameter state until its first step, so a fresh trainer's
    template cannot list what a trained one saved."""
    where = path or "the root"
    if isinstance(target, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{where}: expected a dict, got {type(tree).__name__}")
        if target and set(map(str, target)) != set(map(str, tree)):
            raise ValueError(
                f"{where}: keys {sorted(map(str, tree))[:8]} do not match "
                f"the template's {sorted(map(str, target))[:8]}")
        if target:
            by_name = {str(k): v for k, v in tree.items()}
            for k, v in target.items():
                _check_structure(v, by_name[str(k)], f"{path}/{k}")
    elif isinstance(target, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(target):
            raise ValueError(f"{where}: expected a sequence of {len(target)}")
        for i, (t, v) in enumerate(zip(target, tree)):
            _check_structure(t, v, f"{path}[{i}]")
    elif isinstance(target, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != target.shape \
                or tree.dtype != target.dtype:
            got = (f"{tree.dtype} {tuple(tree.shape)}"
                   if isinstance(tree, torch.Tensor) else type(tree).__name__)
            raise ValueError(f"{where}: expected {target.dtype} "
                             f"{tuple(target.shape)}, got {got}")


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    keep: int = 3) -> str | None:
    """Write ``tree`` as ``ckpt_{step}.pt`` plus its integrity manifest —
    master process only (other ranks return None at once); both writes
    atomic via tmp + rename, payload before manifest; prunes to the newest
    ``keep`` checkpoints. Save latency rides telemetry (the
    ``checkpoint.save_s`` histogram, the ``checkpoint.saves`` counter) and
    a ``checkpoint_save`` span."""
    if not dist.is_master():
        return None
    t0 = time.perf_counter()
    with tracing.span("checkpoint_save", step=int(step)):
        path = _write_host_tree(directory, step, snapshot_to_host(tree), keep=keep)
    telemetry.observe("checkpoint.save_s", time.perf_counter() - t0)
    telemetry.count("checkpoint.saves")
    return path


def _write_host_tree(directory: str, step: int, host_tree: Any, *,
                     keep: int) -> str:
    """Serialize and certify an already host-resident tree — the write
    half shared by the synchronous path and the :class:`AsyncCheckpointer`
    thread."""
    os.makedirs(directory, exist_ok=True)
    data = _to_bytes(host_tree)
    _atomic_write(directory, _path(directory, step), data)
    manifest = {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "nbytes": len(data),
        "sum64": payload_sum64(data),
        # serial CRC32 only while it's cheap; sum64 carries integrity
        # above the threshold (see _CRC32_MAX_BYTES)
        "crc32": (zlib.crc32(data) & 0xFFFFFFFF)
        if len(data) <= _CRC32_MAX_BYTES else None,
        "tree_hash": tree_structure_hash(host_tree),
    }
    _atomic_write(directory, _manifest_path(directory, step),
                  json.dumps(manifest).encode())
    if keep > 0:
        for old in available_steps(directory)[:-keep]:
            # Idempotent prune: a concurrent prune may have removed a path
            # between the listing and the unlink. The manifest goes FIRST,
            # so an interrupted prune leaves an uncertified payload (skipped
            # by the verified fallback), never a certified dangling manifest.
            with contextlib.suppress(FileNotFoundError):
                os.unlink(_manifest_path(directory, old))
            with contextlib.suppress(FileNotFoundError):
                os.unlink(_path(directory, old))
    return _path(directory, step)


def _load_verified_local(directory: str, target: Any, logger):
    """Latest-checkpoint selection with integrity fallback: newest to
    oldest, skipping any candidate that fails its manifest or does not
    deserialize into ``target``'s structure. Returns (tree, step)."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory!r}")
    tried: list[str] = []
    for step in reversed(steps):
        manifest = read_manifest(directory, step)
        try:
            with open(_path(directory, step), "rb") as f:
                data = f.read()
        except OSError as e:
            tried.append(f"step {step}: unreadable ({e})")
            continue
        if manifest is not None and not _payload_matches(manifest, data):
            tried.append(f"step {step}: payload fails manifest CRC/size "
                         "(truncated or corrupt)")
            telemetry.count("checkpoint.verify_failures")
            logger.warning(
                "checkpoint step %d in %s fails integrity verification; "
                "falling back to an older checkpoint", step, directory,
            )
            continue
        try:
            return _from_bytes(data, target), step
        except Exception as e:  # an unreadable payload or another structure
            tried.append(f"step {step}: deserialization failed "
                         f"({type(e).__name__}: {e})")
            logger.warning(
                "checkpoint step %d in %s failed to deserialize (%s); "
                "falling back to an older checkpoint", step, directory, e,
            )
            continue
    raise CheckpointCorruptError(
        f"every checkpoint in {directory!r} failed verification:\n  "
        + "\n  ".join(tried)
    )


def load_checkpoint(directory: str, target: Any, *, step: int | None = None):
    """Restore the latest (or a specific) checkpoint, checked against the
    structure of ``target`` (a template such as ``dp.state_dict()``; None
    checks nothing). Returns ``(tree, step)`` with every tensor on the
    CPU. Raises FileNotFoundError when nothing exists, and
    :class:`CheckpointCorruptError` when an explicitly requested step (or
    every candidate) fails verification.

    Latest selection (``step=None``) is fault-tolerant: a candidate whose
    manifest does not certify its payload, or whose payload does not
    deserialize into ``target``'s structure, is skipped with a warning and
    the newest *verified* older checkpoint restores instead.

    With more than one process (a shared filesystem), the ranks first
    meet at a barrier, then take the *master's* newest verified step from
    one broadcast: listing independently could race the master's
    in-flight write or prune and restore different steps on different
    ranks. Followers then open the agreed path directly, with a short
    retry (a filesystem's attribute cache can lag a peer's rename), and
    check the payload against the manifest, so every rank restores the
    same bytes.

    Load latency rides telemetry (``checkpoint.load_s``,
    ``checkpoint.loads``) under a ``checkpoint_load`` span; a skipped
    corrupt candidate counts into ``checkpoint.verify_failures``."""
    t0 = time.perf_counter()
    with tracing.span("checkpoint_load", step=-1 if step is None else int(step)):
        result = _load_checkpoint_impl(directory, target, step=step)
    telemetry.observe("checkpoint.load_s", time.perf_counter() - t0)
    telemetry.count("checkpoint.loads")
    return result


def _load_checkpoint_impl(directory: str, target: Any, *, step: int | None):
    logger = dist.get_logger("tpu_syncbn_torch.checkpoint")
    multi = dist.process_count() > 1
    if multi:
        dist.barrier("ckpt-load")
        if step is None:
            agreed = _broadcast_from_master(
                _best_step(directory) if dist.is_master() else 0)
            if agreed < 0:
                # the master sees nothing usable: fail alike everywhere
                raise FileNotFoundError(
                    f"no loadable checkpoints in {directory!r} on the "
                    "master process")
            step = agreed
    if multi and not dist.is_master():
        data = _read_with_retry(_path(directory, step))
        manifest = _read_manifest_with_retry(directory, step)
        if manifest is not None and not _payload_matches(manifest, data):
            raise CheckpointCorruptError(
                f"process {dist.process_index()}: step {step} payload does "
                "not match its manifest (local read corrupt/truncated)")
        return _from_bytes(data, target), step
    if step is None:
        return _load_verified_local(directory, target, logger)
    # explicit step: no fallback — the caller asked for THIS state
    steps = available_steps(directory)
    if step not in steps:
        raise FileNotFoundError(
            f"step {step} not in {steps}" if steps
            else f"no checkpoints in {directory!r}")
    with open(_path(directory, step), "rb") as f:
        data = f.read()
    manifest = read_manifest(directory, step)
    if manifest is not None and not _payload_matches(manifest, data):
        raise CheckpointCorruptError(
            f"checkpoint step {step} in {directory!r} fails manifest "
            f"verification (expected {manifest.get('nbytes')} bytes "
            f"sum64={manifest.get('sum64')}, got {len(data)} bytes "
            f"sum64={payload_sum64(data)})")
    try:
        return _from_bytes(data, target), step
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint step {step} in {directory!r} failed to "
            f"deserialize ({type(e).__name__}: {e})") from e


def _broadcast_from_master(value: int) -> int:
    """Rank 0's ``value`` on every rank: one broadcast over the default
    group (on the card for NCCL, on the CPU for gloo)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if tdist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.int64, device=dev)
    tdist.broadcast(t, src=0)
    return int(t.item())


def _best_step(directory: str) -> int:
    """The master's choice for the agreement, mirroring the fallback walk
    of :func:`_load_verified_local`: newest first, skipping only
    candidates whose manifest FAILS to certify them; a step without a
    manifest is a candidate exactly as it is for one process, so the same
    directory resumes to the same step whatever the process count. -1 when
    every candidate is a corrupt manifested checkpoint (or nothing
    exists)."""
    for step in reversed(available_steps(directory)):
        if read_manifest(directory, step) is None \
                or verify_checkpoint(directory, step):
            return step
    return -1


def _read_with_retry(path: str, attempts: int = 5, delay: float = 0.2) -> bytes:
    """Open ``path`` directly, retrying briefly on FileNotFoundError —
    shared-filesystem attribute caches can lag a peer's just-completed
    rename even though the data is readable."""
    for i in range(attempts):
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            if i == attempts - 1:
                raise
            time.sleep(delay * (2**i))
    raise AssertionError("unreachable")


def _read_manifest_with_retry(directory: str, step: int, attempts: int = 3,
                              delay: float = 0.2) -> dict | None:
    """Follower-side manifest read: retries FileNotFoundError like the
    payload read, but resolves to None (no manifest, or a listing still
    lagging) instead of raising — the payload is the authority, the
    manifest an extra check when visible."""
    try:
        data = _read_with_retry(_manifest_path(directory, step),
                                attempts=attempts, delay=delay)
        return json.loads(data)
    except (OSError, json.JSONDecodeError):
        return None


# ---------------------------------------------------------------------------
# weight publication (the serving side's versioned hot swap, serve.publish)


def _pub_path(directory: str, version: int) -> str:
    return os.path.join(directory, f"weights_v{version}.pt")


def _pub_manifest_path(directory: str, version: int) -> str:
    return os.path.join(directory, f"weights_v{version}.manifest.json")


def _pointer_path(directory: str) -> str:
    return os.path.join(directory, PUBLISHED_POINTER)


def published_versions(directory: str) -> list[int]:
    """Ascending weight versions present on disk (payload files — some may
    be unverified leftovers; the pointer is the authority)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _PUB_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def read_published_pointer(directory: str) -> dict | None:
    """The parsed ``published.json`` pointer, or None when absent or
    unreadable (no version has ever been published successfully)."""
    try:
        with open(_pointer_path(directory)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def published_version(directory: str) -> int | None:
    """The currently published weight version number, or None."""
    ptr = read_published_pointer(directory)
    if ptr is None or not isinstance(ptr.get("version"), int):
        return None
    return ptr["version"]


def read_published_manifest(directory: str, version: int) -> dict | None:
    try:
        with open(_pub_manifest_path(directory, version)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _publishable(host_tree: Any) -> Any:
    """``host_tree`` with numpy leaves as owned CPU tensors (copies): the
    payload is read back with ``torch.load(weights_only=True)``, which
    takes tensors and plain values only."""
    return _map(lambda x: torch.tensor(x)
                if isinstance(x, (np.ndarray, np.generic)) else x, host_tree)


def _publish_host_tree(directory: str, version: int, host_tree: Any, *,
                       keep: int, step: int | None = None) -> str:
    """The publication write half (an already host-resident tree): payload
    and manifest exactly like a checkpoint (atomic, payload before
    manifest), then a **read-back verification** of the landed payload
    against its manifest, and only then the atomic ``published.json``
    pointer flip. A writer killed at any byte — or a disk that corrupted
    the payload in flight — leaves the pointer on the previous good
    version; a consumer never resolves to a truncated or bit-flipped
    publication. Prunes to the newest ``keep`` versions, never the one the
    pointer names."""
    os.makedirs(directory, exist_ok=True)
    data = _to_bytes(host_tree)
    _atomic_write(directory, _pub_path(directory, version), data)
    manifest = {
        "format": MANIFEST_FORMAT,
        "version": int(version),
        "nbytes": len(data),
        "sum64": payload_sum64(data),
        "crc32": (zlib.crc32(data) & 0xFFFFFFFF)
        if len(data) <= _CRC32_MAX_BYTES else None,
        "tree_hash": tree_structure_hash(host_tree),
    }
    if step is not None:
        manifest["step"] = int(step)
    _atomic_write(directory, _pub_manifest_path(directory, version),
                  json.dumps(manifest).encode())
    # re-read what the filesystem holds (not the bytes still in hand)
    # before making it reachable
    with open(_pub_path(directory, version), "rb") as f:
        landed = f.read()
    if not _payload_matches(manifest, landed):
        telemetry.count("checkpoint.verify_failures")
        raise CheckpointCorruptError(
            f"publication v{version} failed read-back verification in "
            f"{directory!r} (wrote {len(data)} bytes, read back "
            f"{len(landed)}) — pointer NOT updated")
    pointer = {
        "format": MANIFEST_FORMAT,
        "version": int(version),
        "path": os.path.basename(_pub_path(directory, version)),
        "tree_hash": manifest["tree_hash"],
        "nbytes": len(data),
    }
    if step is not None:
        pointer["step"] = int(step)
    _atomic_write(directory, _pointer_path(directory), json.dumps(pointer).encode())
    if keep > 0:
        # a rollback target must stay loadable: the pointed-at version is
        # never pruned; manifest first, as the checkpoint pruner does
        current = pointer["version"]
        for old in published_versions(directory)[:-keep]:
            if old == current:
                continue
            with contextlib.suppress(FileNotFoundError):
                os.unlink(_pub_manifest_path(directory, old))
            with contextlib.suppress(FileNotFoundError):
                os.unlink(_pub_path(directory, old))
    return _pub_path(directory, version)


def publish_version(directory: str, version: int, tree: Any, *,
                    keep: int = 3, step: int | None = None) -> str | None:
    """Atomically publish ``tree`` (tensors on any device, numpy arrays or
    plain values) as weight version ``version`` — master process only
    (other ranks return None). The pointer flips only after the payload
    passes read-back verification against its freshly written manifest,
    so :func:`load_published` sees either the previous good version or
    this one, never a torn write. Latency rides ``checkpoint.publish_s``
    and ``checkpoint.publishes`` under a ``checkpoint_publish`` span."""
    if not dist.is_master():
        return None
    t0 = time.perf_counter()
    with tracing.span("checkpoint_publish", version=int(version)):
        path = _publish_host_tree(directory, version,
                                  _publishable(snapshot_to_host(tree)),
                                  keep=keep, step=step)
    telemetry.observe("checkpoint.publish_s", time.perf_counter() - t0)
    telemetry.count("checkpoint.publishes")
    return path


def load_published(directory: str, target: Any, *,
                   expect_tree_hash: str | None = None):
    """Resolve the ``published.json`` pointer and load that weight version,
    checked against ``target``'s structure (None checks nothing). Returns
    ``(tree, version)`` with every tensor on the CPU.

    Verification is mandatory: a missing manifest, a payload failing its
    checksums, or a payload that does not deserialize into ``target``'s
    structure raises :class:`CheckpointCorruptError` — the caller keeps
    serving its current version (there is no fallback walk: the pointer
    names ONE version, and a corrupt publication must be rejected, not
    papered over). ``expect_tree_hash`` (the consumer's own
    :func:`tree_structure_hash` of its template) also rejects a
    structurally skewed publication with :class:`PublicationSkewError`
    *before* the payload is read or deserialized. ``FileNotFoundError``
    when nothing has been published."""
    ptr = read_published_pointer(directory)
    if ptr is None or not isinstance(ptr.get("version"), int):
        raise FileNotFoundError(
            f"no published version in {directory!r} (missing or "
            f"unreadable {PUBLISHED_POINTER})")
    version = ptr["version"]
    manifest = read_published_manifest(directory, version)
    if manifest is None:
        telemetry.count("checkpoint.verify_failures")
        raise CheckpointCorruptError(
            f"published v{version} in {directory!r} has no readable "
            "manifest — cannot certify the payload")
    if expect_tree_hash is not None and manifest.get("tree_hash") != expect_tree_hash:
        raise PublicationSkewError(
            f"published v{version} tree_hash {manifest.get('tree_hash')!r} "
            f"!= expected {expect_tree_hash!r} — publisher and server "
            "disagree on the model structure (schema skew)")
    try:
        with open(_pub_path(directory, version), "rb") as f:
            data = f.read()
    except OSError as e:
        telemetry.count("checkpoint.verify_failures")
        raise CheckpointCorruptError(
            f"published v{version} payload unreadable in {directory!r}: {e}") from e
    if not _payload_matches(manifest, data):
        telemetry.count("checkpoint.verify_failures")
        raise CheckpointCorruptError(
            f"published v{version} in {directory!r} fails manifest "
            f"verification (expected {manifest.get('nbytes')} bytes "
            f"sum64={manifest.get('sum64')}, got {len(data)} bytes "
            f"sum64={payload_sum64(data)})")
    try:
        return _from_bytes(data, target), version
    except Exception as e:
        raise CheckpointCorruptError(
            f"published v{version} in {directory!r} failed to deserialize "
            f"({type(e).__name__}: {e})") from e


class AsyncCheckpointer:
    """Checkpoint writes off the training hot path.

    ``save()`` takes the *snapshot* synchronously — one batched
    device-to-host copy into owned CPU tensors (:func:`snapshot_to_host`)
    — then hands serialization, the integrity manifest (the same bytes and
    manifest as :func:`save_checkpoint` writes), the atomic writes and
    pruning to ONE background thread. The step loop pays the copy and
    nothing else.

    Ordering and durability:

    * writes (saves and :meth:`publish`'s publications) are processed
      strictly in submission order by a single worker, so manifests
      certify in that order and the newest-verified resume walk never
      sees an out-of-order certification;
    * ``max_pending`` bounds host memory (each pending write holds one
      full state snapshot); a ``save()`` past the bound *blocks* until the
      writer drains — backpressure, never silent dropping;
    * ``flush()`` blocks until everything submitted is durable;
    * a background write failure is re-raised at the next ``save()`` or
      ``flush()`` — an async fault must not be a silent one.

    Master process only, like :func:`save_checkpoint` (other ranks' saves
    are cheap no-ops)."""

    def __init__(self, *, keep: int = 3, max_pending: int = 2):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.keep = keep
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._errors: list[BaseException] = []
        self._cond = threading.Condition()
        # incremented BEFORE enqueue: a flush() that follows a save() can
        # never miss the write in a handoff window
        self._pending = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="async-checkpointer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            # idle-wait for work by design: close() always enqueues the
            # None sentinel, so this get provably ends (as JAX's,
            # tpu_syncbn/utils/checkpoint.py:791)
            item = self._queue.get()  # audit: ok[unbounded_blocking]
            if item is None:
                return
            op, directory, number, host_tree, keep = item
            t0 = time.perf_counter()
            try:
                if op == "publish":
                    with tracing.span("checkpoint_publish", version=int(number),
                                      mode="async"):
                        _publish_host_tree(directory, number, host_tree, keep=keep)
                    telemetry.observe("checkpoint.publish_s", time.perf_counter() - t0)
                    telemetry.count("checkpoint.publishes")
                else:
                    with tracing.span("checkpoint_save", step=int(number), mode="async"):
                        _write_host_tree(directory, number, host_tree, keep=keep)
                    telemetry.observe("checkpoint.save_s", time.perf_counter() - t0)
                    telemetry.count("checkpoint.saves")
            except BaseException as e:  # surfaces at the next save()/flush()
                with self._cond:
                    self._errors.append(e)
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def _raise_pending_error(self) -> None:
        with self._cond:
            err = self._errors.pop(0) if self._errors else None
        if err is not None:
            raise RuntimeError(
                "async checkpoint write failed in the background") from err

    @property
    def pending(self) -> int:
        """Writes submitted but not yet durable."""
        with self._cond:
            return self._pending

    def save(self, directory: str, step: int, tree: Any, *,
             keep: int | None = None) -> None:
        """Snapshot ``tree`` now and schedule the serialized, certified
        write. Blocks only for the snapshot — and for backpressure when
        ``max_pending`` writes are already queued. Raises any error a
        previous background write hit."""
        self._raise_pending_error()
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        if not dist.is_master():
            return
        t0 = time.perf_counter()
        host_tree = snapshot_to_host(tree)
        telemetry.observe("checkpoint.async_snapshot_s", time.perf_counter() - t0)
        telemetry.count("checkpoint.async_saves")
        with self._cond:
            self._pending += 1
        # enqueue OUTSIDE the condition: a put on the bounded queue may
        # block (the documented backpressure), and the worker needs the
        # condition to drain. The single worker stops only at close()'s
        # sentinel (its loop catches BaseException per item), so the put
        # always drains (JAX: tpu_syncbn/utils/checkpoint.py:865)
        self._queue.put(("save", directory, int(step), host_tree,  # audit: ok[unbounded_blocking]
                         self.keep if keep is None else keep))

    def publish(self, directory: str, version: int, tree: Any, *,
                keep: int | None = None) -> None:
        """Snapshot ``tree`` now and schedule an atomic weight publication
        (:func:`publish_version`'s payload, manifest, read-back
        verification and pointer flip) through the same ordered worker as
        :meth:`save` — so a ``save(step=N)`` followed by a
        ``publish(version=N)`` certifies in submission order and one
        ``flush()`` covers both. The same backpressure, master-only and
        error-surfacing contracts as :meth:`save`."""
        self._raise_pending_error()
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        if not dist.is_master():
            return
        t0 = time.perf_counter()
        host_tree = _publishable(snapshot_to_host(tree))
        telemetry.observe("checkpoint.async_snapshot_s", time.perf_counter() - t0)
        with self._cond:
            self._pending += 1
        # the same backpressure as save()'s, drained by the same worker
        # (JAX: tpu_syncbn/utils/checkpoint.py:889)
        self._queue.put(("publish", directory, int(version), host_tree,  # audit: ok[unbounded_blocking]
                         self.keep if keep is None else keep))

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every submitted write is durable (or ``timeout``
        seconds pass — returns False on timeout). Re-raises background
        write errors."""
        with self._cond:
            done = self._cond.wait_for(lambda: self._pending == 0, timeout)
        self._raise_pending_error()
        return done

    def close(self, timeout: float | None = None) -> None:
        """Flush, then stop the worker thread. Idempotent. If the flush
        times out (the worker wedged on a hung write), the sentinel is
        offered without blocking, honouring the caller's bound, and the
        daemon worker is left to die with the process."""
        if self._closed:
            return
        self._closed = True
        try:
            self.flush(timeout)
        finally:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass  # wedged mid-write with a full queue: see docstring
            else:
                self._thread.join(timeout=5)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
