"""The port's headline bench — the counterpart of ``bench.py``'s default
run: bf16 ResNet-50 converted to SyncBN, trained by ``DataParallel`` with
SGD(0.1, momentum 0.9), batch 64 a GPU at 224², 10 timed steps. Prints one
JSON line:

    {"metric": "resnet50_syncbn_dp_train_throughput", "value": img/s per GPU,
     "unit": "img/s/gpu", "backend", "bn_backend", "chips", "per_chip_batch",
     "image_side", "steps", "compile_warmup_s", "mfu", "flops_per_step",
     "flops_source", "peak_flops", "peak_source", "device_kind",
     "host_load_1m"}

Run on one GPU (or under ``python -m tpu_syncbn_torch.launch`` on several;
every rank times its own steps, the master prints):

    python -m tpu_syncbn_torch.bench
    BENCH_PER_CHIP_BATCH=32 BENCH_STEPS=20 BENCH_IMAGE_SIDE=224 python -m tpu_syncbn_torch.bench

``--device cpu`` (tests) runs a small config (batch 8, 20 steps at 64²,
the same overrides) and prints the same keys with ``mfu: null``.

The timed window starts after two warm-up steps (they build the kernels:
``compile_warmup_s``) and ends in ``torch.cuda.synchronize()`` after the
last optimizer step, so it holds every update, not only the last loss.

FLOPs a step come from ``torch.utils.flop_counter.FlopCounterMode`` over
one training step (forward, backward and update): it counts convolution
and matrix-multiply work only, so BatchNorm, activations, the loss and
the optimizer add nothing to ``flops_per_step`` (``flops_source``
"torch-flop-counter"). The peak comes from :data:`PEAK_FLOPS`, keyed on
``torch.cuda.get_device_name()``; a card not in it gives ``mfu: null``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.nn.functional as F

#: dense bf16 tensor-core peak by device name: (FLOP/s, source)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": (
        989.4e12, "NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s dense BF16"),
}


def bench_config(on_accel: bool) -> dict:
    """The workload, with ``BENCH_PER_CHIP_BATCH`` / ``BENCH_STEPS`` /
    ``BENCH_IMAGE_SIDE`` overrides (``bench.py``'s ``bench_config``)."""
    batch, steps, side = (64, 10, 224) if on_accel else (8, 20, 64)
    return {
        "per_chip_batch": int(os.environ.get("BENCH_PER_CHIP_BATCH", batch)),
        "steps": int(os.environ.get("BENCH_STEPS", steps)),
        "side": int(os.environ.get("BENCH_IMAGE_SIDE", side)),
    }


def _host_load() -> float | None:
    try:
        return round(os.getloadavg()[0], 2)
    except (AttributeError, OSError):
        return None


def _loss_fn(model, batch):
    x, y = batch
    return F.cross_entropy(model(x).float(), y.long())  # CE in f32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device: torch.device) -> dict:
    """Build, warm up, count FLOPs, time; returns the JSON line's dict."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_syncbn_torch import models, nn, parallel, runtime
    from tpu_syncbn_torch.ops import batch_norm as bn_ops

    on_card = device.type == "cuda"
    cfg = bench_config(on_card)
    bs, steps, side = cfg["per_chip_batch"], cfg["steps"], cfg["side"]
    model = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=1000, dtype=torch.bfloat16, device=device,
        generator=torch.Generator().manual_seed(0)))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    dp = parallel.DataParallel(model, opt, _loss_fn, device=device)
    g = torch.Generator(device=device).manual_seed(runtime.process_index())
    batch = (torch.randn(bs, side, side, 3, device=device, generator=g),
             torch.randint(0, 1000, (bs,), device=device, generator=g))

    t0 = time.perf_counter()
    for _ in range(2):  # the first builds every kernel
        dp.train_step(batch)
    _sync(device)
    warm_s = time.perf_counter() - t0

    with FlopCounterMode(display=False) as counter:
        dp.train_step(batch)
    flops = float(counter.get_total_flops())

    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        dp.train_step(batch)
    _sync(device)  # after the last optimizer step: every update is in
    dt = time.perf_counter() - t0

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peak, peak_source = PEAK_FLOPS.get(kind, (None, None)) if on_card else (None, None)
    mfu = round(flops / (dt / steps) / peak, 4) if peak and flops else None
    use_kernels = bn_ops.get_kernel_mode() != "off" and on_card
    return {
        "metric": "resnet50_syncbn_dp_train_throughput",
        "value": round(bs * steps / dt, 2),
        "unit": "img/s/gpu",
        "backend": device.type,
        "bn_backend": "kernels" if use_kernels else "plain",
        "chips": runtime.process_count(),
        "per_chip_batch": bs,
        "image_side": side,
        "steps": steps,
        "compile_warmup_s": round(warm_s, 1),
        "mfu": mfu,
        "flops_per_step": flops,
        "flops_source": "torch-flop-counter",
        "peak_flops": peak,
        "peak_source": peak_source,
        "device_kind": kind,
        "host_load_1m": _host_load(),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    from tpu_syncbn_torch import runtime

    device = runtime.initialize(args.device)
    line = run(device)
    runtime.master_print(json.dumps(line))
    runtime.shutdown()
    return line


if __name__ == "__main__":
    main()
