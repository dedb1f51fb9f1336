"""Process-group runtime (rendezvous, rank identity, meshes, backend
probe, launcher, rank-0 logging) and the resilience layer (preemption,
watchdogs, the resilient step loop)."""

from tpu_syncbn_torch.runtime.distributed import (
    DistributedConfig,
    barrier,
    cpu_forced,
    data_parallel_mesh,
    get_logger,
    global_device_count,
    initialize,
    is_initialized,
    is_master,
    local_device_count,
    make_mesh,
    master_print,
    mesh_shape,
    process_count,
    process_index,
    resolve_device,
    shutdown,
)
from tpu_syncbn_torch.runtime.resilience import (
    PreemptionGuard,
    ResilientLoop,
    StallError,
    Watchdog,
    backoff_delays,
    retry_with_backoff,
    stall_guard,
)
from tpu_syncbn_torch.runtime.probe import (
    BackendInfo,
    enable_persistent_compilation_cache,
    ensure_backend,
    force_cpu,
    probe_backend,
)

__all__ = [
    "PreemptionGuard", "ResilientLoop", "StallError", "Watchdog",
    "backoff_delays", "retry_with_backoff", "stall_guard",
    "BackendInfo", "DistributedConfig", "barrier", "cpu_forced",
    "data_parallel_mesh", "enable_persistent_compilation_cache",
    "ensure_backend", "force_cpu", "get_logger", "global_device_count",
    "initialize", "is_initialized", "is_master", "local_device_count",
    "make_mesh", "master_print", "mesh_shape", "probe_backend",
    "process_count", "process_index", "resolve_device", "shutdown",
]
