"""ResNet-50 + SyncBN + DataParallel + DistributedSampler on ImageNet-style
JPEG folders — the counterpart of ``examples/imagenet_resnet50.py``: bf16
compute, SGD with Nesterov momentum, weight decay and a per-step cosine
schedule, top-1 eval, throughput metering.

One GPU (the tree holds ``train/<class>/*.jpg`` and ``val/<class>/*.jpg``,
or one split directory):

    python -m tpu_syncbn_torch.imagenet_resnet50 --data-root /data/imagenet \\
        --epochs 1 --batch-size 64 [--worker-type process]

Several GPUs of one host (one process per GPU):

    python -m tpu_syncbn_torch.launch --nproc-per-node 4 \\
        tpu_syncbn_torch/imagenet_resnet50.py -- --data-root /data/imagenet

On the CPU (plain versions of the kernels):

    python -m tpu_syncbn_torch.imagenet_resnet50 --device cpu \\
        --data-root /data/tiny --epochs 1 --image-size 32 --batch-size 8

Without ``--data-root`` a deterministic synthetic ImageNet-shaped dataset
stands in; the pipeline, sharding and step are the same. The done line
gives the steps, the final val top-1, the throughput, and the median step
time and ``data_wait`` (the time the training loop waited for its next
batch) over the steps after the first.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import time

import torch
import torch.nn.functional as F

from tpu_syncbn_torch import data as tdata
from tpu_syncbn_torch import models, nn, parallel, runtime, utils

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_imagefolder_datasets(root: str, image_size: int):
    """``root/train`` + ``root/val`` (or one split directory used for
    both) with the standard ImageNet train and eval transforms; the val
    split takes the train split's class mapping."""
    T = tdata.transforms
    train_tf = T.Compose([
        T.RandomResizedCrop(image_size),
        T.RandomHorizontalFlip(),
        T.ToFloat(),
        T.Normalize(IMAGENET_MEAN, IMAGENET_STD),
    ])
    eval_tf = T.Compose([
        # shorter side to 256/224 of the crop, aspect kept, then the centre
        T.ResizeShortestEdge(max(image_size, int(round(image_size * 256 / 224)))),
        T.CenterCrop(image_size),
        T.ToFloat(),
        T.Normalize(IMAGENET_MEAN, IMAGENET_STD),
    ])
    train_root = os.path.join(root, "train")
    val_root = os.path.join(root, "val")
    if not os.path.isdir(train_root):
        train_root = val_root = root  # single-split tree
    if not os.path.isdir(val_root):
        val_root = train_root
    train_ds = tdata.ImageFolderDataset(train_root, train_tf)
    val_ds = tdata.ImageFolderDataset(
        val_root, eval_tf, class_to_idx=train_ds.class_to_idx
    )
    return train_ds, val_ds


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--data-root", default=None,
                   help="ImageFolder tree (root/train/<class>/*.jpg and "
                        "root/val/<class>/*.jpg, or a single split dir); "
                        "synthetic data when omitted")
    p.add_argument("--batch-size", type=int, default=256, help="global")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--dataset-size", type=int, default=2048)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--dtype", choices=["f32", "bf16"], default="bf16")
    p.add_argument("--eval-every", type=int, default=0,
                   help="eval every N epochs (0 = only at the end)")
    p.add_argument("--metrics-log", default=None,
                   help="append per-log-interval scalars (loss/top1/img-s) "
                        "to this JSONL file, master only")
    p.add_argument("--worker-type", choices=["thread", "process"],
                   default="thread",
                   help="loader workers: threads (default) or spawned "
                        "processes")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def _loss_fn(m, batch):
    x, y = batch
    logits = m(x).float()
    loss = F.cross_entropy(logits, y.long())
    return loss, {"top1": (logits.argmax(-1) == y).float().mean()}


def cosine_decay(step: int, decay_steps: int) -> float:
    """``optax.cosine_decay_schedule``'s multiplier at ``step`` (alpha 0)."""
    t = min(step, decay_steps)
    return 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))


def make_optimizer(model, lr: float, decay_steps: int):
    """SGD with Nesterov momentum 0.9 and weight decay 1e-4, and its
    per-step cosine schedule — ``optax.chain(add_decayed_weights(1e-4),
    sgd(cosine_decay_schedule(lr, decay_steps), momentum=0.9,
    nesterov=True))``: the decay is added to the gradient before the
    momentum, and the momentum buffer starts at the first gradient."""
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9,
                          nesterov=True, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: cosine_decay(step, max(decay_steps, 1)))
    return opt, sched


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = runtime.initialize(args.device)
    log = runtime.get_logger("imagenet")
    log.info("world: %d process(es) on %s", runtime.process_count(), device)

    shape = (args.image_size, args.image_size, 3)
    if args.data_root:
        train_ds, val_ds = make_imagefolder_datasets(
            args.data_root, args.image_size
        )
        args.num_classes = len(train_ds.class_to_idx)
        args.dataset_size = len(train_ds)
        log.info("real data: %d train / %d val images, %d classes",
                 len(train_ds), len(val_ds), args.num_classes)
    else:
        train_ds = tdata.SyntheticImageDataset(
            length=args.dataset_size, shape=shape,
            num_classes=args.num_classes, seed=0,
        )
        val_ds = tdata.SyntheticImageDataset(
            length=max(args.batch_size, args.dataset_size // 8), shape=shape,
            num_classes=args.num_classes, seed=1,
        )
    summary = train(args, train_ds, val_ds, device)
    runtime.shutdown()
    return summary


def train(args, train_ds, val_ds, device: torch.device) -> dict:
    """Train and evaluate on the given datasets; returns the done line's
    numbers (``steps``, ``final_top1``, ``img_per_sec``, ``loss``) and the
    per-step host times ``step_s`` and ``data_wait_s``."""
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    model = nn.convert_sync_batchnorm(models.resnet50(
        num_classes=args.num_classes, dtype=dtype, device=device,
        generator=torch.Generator().manual_seed(0),
    ))
    parallel.sync_module_states(model)  # DDP's init-time broadcast

    world = runtime.process_count()
    if args.batch_size % world:
        raise SystemExit("--batch-size must be divisible by the process count")
    per_process = args.batch_size // world
    steps_per_epoch = args.dataset_size // args.batch_size
    opt, sched = make_optimizer(model, args.lr, args.epochs * steps_per_epoch)
    dp = parallel.DataParallel(model, opt, _loss_fn, device=device)

    sampler = tdata.DistributedSampler(
        len(train_ds), num_replicas=world, rank=runtime.process_index(),
        shuffle=True, seed=0,
    )
    loader = tdata.DataLoader(train_ds, batch_size=per_process, sampler=sampler,
                              num_workers=8, drop_last=True,
                              worker_type=args.worker_type)
    if len(loader) == 0:
        raise SystemExit(
            f"dataset of {len(train_ds)} yields zero batches of "
            f"{args.batch_size} with drop_last — lower --batch-size"
        )

    def run_eval():
        val_sampler = tdata.DistributedSampler(
            len(val_ds), num_replicas=world, rank=runtime.process_index(),
            shuffle=False,
        )
        eval_loader = tdata.DataLoader(val_ds, batch_size=per_process,
                                       sampler=val_sampler, drop_last=True)
        meter = utils.AverageMeter("top1")
        for batch in tdata.device_prefetch(iter(eval_loader), device=device):
            out = dp.eval_step(batch)
            meter.update(float(out.metrics["top1"]), n=args.batch_size)
        return meter.avg

    tput = utils.ThroughputMeter()
    step = 0
    loss = float("nan")
    step_s, data_wait_s = [], []
    last_eval = None
    scalars = utils.ScalarLogger(args.metrics_log) if args.metrics_log else None
    try:
        for epoch in range(args.epochs):
            sampler.set_epoch(epoch)
            batches = tdata.device_prefetch(iter(loader), device=device)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                t1 = time.perf_counter()
                if batch is None:
                    break
                out = dp.train_step(batch)
                sched.step()
                loss, top1 = float(out.loss), float(out.metrics["top1"])
                t2 = time.perf_counter()  # float() waited for the step
                data_wait_s.append(t1 - t0)
                step_s.append(t2 - t0)
                step += 1
                tput.tick(args.batch_size)
                if step % 10 == 0:
                    runtime.master_print(
                        f"e{epoch} s{step}: loss {loss:.4f} top1 {top1:.3f} "
                        f"{tput.samples_per_sec:.0f} img/s"
                    )
                    if scalars:
                        scalars.log(step, epoch=epoch, loss=loss, top1=top1,
                                    img_per_sec=tput.samples_per_sec)
            if args.eval_every and (epoch + 1) % args.eval_every == 0:
                last_eval = run_eval()
                runtime.master_print(f"epoch {epoch}: val top1 {last_eval:.4f}")
                if scalars:
                    scalars.log(step, epoch=epoch, val_top1=last_eval)
            else:
                last_eval = None  # the model changed since the last eval
        final_top1 = last_eval if last_eval is not None else run_eval()
        if scalars:
            scalars.log(step, final_val_top1=final_top1)
    finally:
        loader.close()
        if scalars:
            scalars.close()
    steady = slice(1, None) if len(step_s) > 1 else slice(None)
    summary = {
        "steps": step, "final_top1": final_top1, "loss": loss,
        "img_per_sec": tput.samples_per_sec,
        "step_s": step_s, "data_wait_s": data_wait_s,
        "step_median_ms": 1e3 * statistics.median(step_s[steady]) if step_s else math.nan,
        "data_wait_median_ms": 1e3 * statistics.median(data_wait_s[steady]) if step_s else math.nan,
    }
    runtime.master_print(
        f"done: {step} steps, final val top1 {final_top1:.4f}, "
        f"throughput {tput.samples_per_sec:.0f} img/s, step median "
        f"{summary['step_median_ms']:.2f} ms, data_wait median "
        f"{summary['data_wait_median_ms']:.2f} ms"
    )
    return summary


if __name__ == "__main__":
    main()
