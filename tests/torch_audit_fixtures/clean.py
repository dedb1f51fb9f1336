"""Near-miss code that must NOT fire any rule — the false-positive guard
of tests/test_torch_audit_srclint.py."""

import threading
import time

import torch
import torch.nn.functional as F

from tpu_syncbn_torch.obs import flightrec, telemetry, tracing
from tpu_syncbn_torch.parallel import collectives, scan_driver
from tpu_syncbn_torch.runtime import distributed as dist


def host_side(batch):
    # host code outside any step body: syncs are allowed
    telemetry.count("data.batches")
    return batch.mean().item(), batch.tolist()


class Trainer:
    def _chunk_step(self, chunk, k, batch):
        # the near misses of host_sync_in_step inside a body
        labels = F.one_hot(batch.long(), num_classes=8)
        rep = torch.repeat_interleave(batch, self.counts, output_size=64)
        twice = batch.repeat_interleave(2)
        keep = torch.where(batch > 0, batch, torch.zeros_like(batch))
        host = torch.ones(4, pin_memory=True)
        dev = host.to("cuda", non_blocking=True)
        loss = collectives.psum(labels.sum() + rep.sum() + twice.sum()
                                + keep.sum() + dev.sum(), self.group)
        return {"loss": loss}

    def _build(self, n):
        return scan_driver.build_scan_steps(
            self._chunk_step, n_steps=n, stacked=False, device=self.device,
            state=list)


def control_plane():
    dist.barrier("ready")  # the port's wrapper, not a raw collective


class LockedProperly:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []
        self._pending = 0
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        return flightrec.get()  # ok: a module's accessor, not a queue

    def add(self, x):
        with self._lock:
            self._items.append(x)
            self._pending += 1

    def close(self):
        self._t.join(timeout=5.0)
        return self._t.is_alive()


def timed(tracer_batch):
    t0 = time.perf_counter()
    with tracing.span("serve.batch"):
        out = tracer_batch * 2
    telemetry.observe("serve.batch_s", time.perf_counter() - t0,
                      labels={"mode": "active"})
    return out
