"""Retry with bounded exponential backoff — the part of
``tpu_syncbn.runtime.resilience`` the rendezvous needs, kept as a copy
(that module is framework-free, but the JAX package's ``__init__`` imports
JAX, so the port never imports it).

The jitter is deterministic: keyed off a string (the rank) through CRC32,
not a wall-clock RNG, so a retry schedule is reproducible in a test yet
differs between processes — N restarted ranks must not re-storm a
recovering rendezvous store in lockstep.
"""

from __future__ import annotations

import time
import zlib
from typing import Any, Callable


def backoff_delays(
    attempts: int,
    *,
    base_s: float = 1.0,
    max_s: float = 30.0,
    jitter: float = 0.25,
    key: str = "",
) -> list[float]:
    """The ``attempts - 1`` sleeps between retries: ``base_s · 2**i``
    capped at ``max_s``, spread by ±``jitter`` of itself with a unit
    interval hashed from ``(key, i)``."""
    delays = []
    for i in range(max(0, attempts - 1)):
        d = min(max_s, base_s * (2 ** i))
        u = (zlib.crc32(f"{key}:{i}".encode()) & 0xFFFFFFFF) / 0xFFFFFFFF
        delays.append(d * (1.0 + jitter * (2.0 * u - 1.0)))
    return delays


def retry_with_backoff(
    fn: Callable[[], Any],
    *,
    attempts: int = 3,
    base_s: float = 1.0,
    max_s: float = 30.0,
    jitter: float = 0.25,
    key: str = "",
    retry_on: tuple = (Exception,),
    describe: str = "operation",
    sleep: Callable[[float], None] | None = None,
) -> Any:
    """Call ``fn`` up to ``attempts`` times with :func:`backoff_delays`
    between failures; the last failure re-raises. Each retry is logged
    with its exception (WARNING, so every rank shows it)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if sleep is None:
        sleep = time.sleep
    delays = backoff_delays(attempts, base_s=base_s, max_s=max_s,
                            jitter=jitter, key=key)
    from tpu_syncbn_torch.runtime.distributed import get_logger

    logger = get_logger("tpu_syncbn_torch.resilience")
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if i == attempts - 1:
                raise
            logger.warning(
                "%s failed (attempt %d/%d: %s: %s); retrying in %.2fs",
                describe, i + 1, attempts, type(e).__name__, e, delays[i],
            )
            sleep(delays[i])
    raise AssertionError("unreachable")
