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

Checkpoints: ``--ckpt-dir D`` writes a certified checkpoint of the whole
training state (parameters, BN buffers, optimizer, schedule, guard) at
the end of every epoch, tagged with the number of epochs done
(``--async-ckpt``: written by a background thread, the loop paying only
the copy to the host); ``--resume`` restarts from the newest verified one
in D at the epoch it was taken. ``--accum-steps K`` splits each batch
into K microbatches with one gradient all-reduce;
``--divergence-guard`` skips a step whose loss or gradients are not
finite. ``--scan-steps K`` runs K optimizer steps as one program
(``DataParallel.train_steps_batches`` over K-stacked chunks of
``device_prefetch(scan_steps=K)``: one CUDA graph replay a chunk on the
card); ``--data-deadline S`` raises ``StallError`` when a batch takes more
than S seconds to arrive instead of hanging. SIGTERM or SIGINT finishes
the step (or chunk) in flight, checkpoints the epoch it interrupted (with
``--ckpt-dir``) and exits 0; ``--resume`` replays that epoch.
``--profile-dir D`` writes a ``torch.profiler`` Chrome trace of the
training epochs into D (master only; ``obs.profiling.profiler_trace``).

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
from tpu_syncbn_torch.obs import profiling

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
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--divergence-guard", default=None,
                   choices=["skip_step", "halve_lr", "restore_last_good"],
                   help="non-finite loss/grad policy (DataParallel)")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="fuse K optimizer steps into one program fed by "
                        "K-stacked staging chunks (one CUDA graph replay a "
                        "chunk on the card; 1 = per-step loop)")
    p.add_argument("--data-deadline", type=float, default=None,
                   help="seconds before a hung batch fetch raises "
                        "StallError instead of hanging the job")
    p.add_argument("--async-ckpt", action="store_true",
                   help="checkpoint via the background AsyncCheckpointer "
                        "(the loop pays only the state snapshot)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="eval every N epochs (0 = only at the end)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the training "
                        "epochs (not the final eval) into this directory, "
                        "master only")
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
    numbers (``steps``, ``final_top1``, ``img_per_sec``, ``loss``), the
    epoch the run started at (``start_epoch``: 0, or the resumed
    checkpoint's), whether a signal cut it short (``preempted``), and the
    per-step host times ``step_s`` (a chunk's time over its K steps) and
    ``data_wait_s`` (per step or chunk) of this run."""
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
    decay_steps = args.epochs * (args.dataset_size // args.batch_size)
    opt, sched = make_optimizer(model, args.lr, decay_steps)
    dp = parallel.DataParallel(
        model, opt, _loss_fn, device=device, accum_steps=args.accum_steps,
        divergence_guard=args.divergence_guard, lr_scheduler=sched)
    log = runtime.get_logger("imagenet")

    start_epoch = 0
    if args.ckpt_dir and args.resume:
        # newest VERIFIED checkpoint (corrupt or truncated ones are skipped
        # with a warning); 0 means a fresh start
        start_epoch = parallel.resume_latest(dp, args.ckpt_dir)
        if not start_epoch:
            log.info("no checkpoint found; starting fresh")
        # this run's schedule at the restored step, as the JAX example's
        # optax schedule is a function of the restored count (--epochs,
        # hence the schedule's length, may differ from the saving run's)
        for g, base in zip(opt.param_groups, sched.base_lrs):
            g["lr"] = base * cosine_decay(sched.last_epoch, max(decay_steps, 1))

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

    # checkpoint writes: synchronous rank-0 writes, or the background
    # AsyncCheckpointer (the loop pays only the snapshot; closed, so
    # flushed, before every exit)
    async_ckpt = (utils.AsyncCheckpointer()
                  if args.async_ckpt and args.ckpt_dir else None)

    def save_ckpt(tag: int) -> None:
        if not args.ckpt_dir:
            return
        if async_ckpt is not None:
            async_ckpt.save(args.ckpt_dir, tag, dp.state_dict())
        else:
            utils.save_checkpoint(args.ckpt_dir, tag, dp.state_dict())

    def train_batches():
        it = tdata.device_prefetch(iter(loader), device=device,
                                   scan_steps=args.scan_steps)
        if args.data_deadline:
            # a wedged data worker becomes a catchable StallError at the
            # deadline instead of an indefinite hang
            it = runtime.stall_guard(it, args.data_deadline, name="train-batch")
        return it

    tput = utils.ThroughputMeter()
    # a resumed run keeps the logged step monotonic across runs (the JSONL
    # file is append-mode); len(loader) is the real steps an epoch
    step = start_epoch * len(loader)
    loss = float("nan")
    step_s, data_wait_s = [], []
    last_eval = None
    preempted = False
    scalars = utils.ScalarLogger(args.metrics_log) if args.metrics_log else None
    try:
        # SIGTERM/SIGINT (a preemption notice): finish the step or chunk in
        # flight, checkpoint at the epoch boundary, exit 0; the restarted
        # job resumes at this epoch with --resume
        # the profiler's scope is the training epochs; it closes before the
        # final eval below (per-epoch --eval-every evals stay inside it)
        with runtime.PreemptionGuard() as guard, profiling.profiler_trace(
                args.profile_dir or "", enabled=bool(args.profile_dir)):
            for epoch in range(start_epoch, args.epochs):
                sampler.set_epoch(epoch)
                batches = train_batches()
                while not guard.preempted:
                    t0 = time.perf_counter()
                    batch = next(batches, None)
                    t1 = time.perf_counter()
                    if batch is None:
                        break
                    if args.scan_steps > 1:
                        # a K-stacked chunk: one program, stacked outputs
                        out = dp.train_steps_batches(batch)
                        k = int(out.loss.shape[0])
                        loss, top1 = float(out.loss[-1]), float(out.metrics["top1"][-1])
                    else:
                        out = dp.train_step(batch)
                        k = 1
                        loss, top1 = float(out.loss), float(out.metrics["top1"])
                    t2 = time.perf_counter()  # float() waited for the step
                    data_wait_s.append(t1 - t0)
                    step_s.append((t2 - t0) / k)
                    step += k
                    tput.tick(args.batch_size * k)
                    if step % 10 < k:
                        runtime.master_print(
                            f"e{epoch} s{step}: loss {loss:.4f} top1 {top1:.3f} "
                            f"{tput.samples_per_sec:.0f} img/s"
                        )
                        if scalars:
                            scalars.log(step, epoch=epoch, loss=loss, top1=top1,
                                        img_per_sec=tput.samples_per_sec)
                if guard.preempted:
                    # tagged with the CURRENT epoch: the resume replays it
                    # from its deterministic sampler order
                    save_ckpt(epoch)
                    if async_ckpt is not None:
                        async_ckpt.flush()  # durable before the exit
                    log.warning("preempted: checkpointed at epoch %d boundary; "
                                "exiting cleanly", epoch)
                    preempted = True
                    break
                save_ckpt(epoch + 1)
                if args.eval_every and (epoch + 1) % args.eval_every == 0:
                    last_eval = run_eval()
                    runtime.master_print(f"epoch {epoch}: val top1 {last_eval:.4f}")
                    if scalars:
                        scalars.log(step, epoch=epoch, val_top1=last_eval)
                else:
                    last_eval = None  # the model changed since the last eval
        if async_ckpt is not None:
            async_ckpt.close()  # every write durable (or raised) before eval
        final_top1 = last_eval if last_eval is not None else run_eval()
        if scalars:
            scalars.log(step, final_val_top1=final_top1)
    finally:
        loader.close()
        if scalars:
            scalars.close()
        if async_ckpt is not None:
            # an exception is unwinding (the normal path closed it above):
            # a write failure surfacing here must not replace it, and a
            # wedged writer must not hang the exit
            try:
                async_ckpt.close(timeout=60)
            except Exception:
                log.exception("async checkpoint close failed at exit")
    steady = slice(1, None) if len(step_s) > 1 else slice(None)
    summary = {
        "steps": step, "start_epoch": start_epoch, "preempted": preempted,
        "final_top1": final_top1, "loss": loss,
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
