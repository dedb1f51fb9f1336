"""Process-group runtime (rendezvous, rank identity, rank-0 logging)."""

from tpu_syncbn_torch.runtime.distributed import (
    barrier,
    get_logger,
    initialize,
    is_initialized,
    is_master,
    master_print,
    process_count,
    process_index,
    resolve_device,
    shutdown,
)

__all__ = [
    "barrier", "get_logger", "initialize", "is_initialized", "is_master",
    "master_print", "process_count", "process_index", "resolve_device",
    "shutdown",
]
