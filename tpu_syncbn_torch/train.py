"""train.py — the recipe's complete training script on the PyTorch port,
the counterpart of ``examples/distributed_train.py``.

One GPU:

    python -m tpu_syncbn_torch.train --epochs 2

Several GPUs of one host (one process per GPU, torchrun's environment;
NCCL between cards is not yet run: the multi-replica path is tested over
gloo, on the CPU and with four processes sharing one card):

    python -m tpu_syncbn_torch.launch --nproc-per-node 4 tpu_syncbn_torch/train.py -- --epochs 2
    torchrun --nproc-per-node 4 -m tpu_syncbn_torch.train --epochs 2

On the CPU (plain versions of the kernels, gloo between processes):

    python -m tpu_syncbn_torch.train --device cpu --epochs 1

``--data-root DIR`` trains on CIFAR-10 when ``DIR/cifar-10-batches-py``
holds its python batches (nothing is downloaded), on synthetic data
otherwise. ``--zero`` shards the weight update over the processes
(``DataParallel(zero=True)``); ``--fsdp N`` composes DP×FSDP
(``SpecLayout.fsdp(fsdp=N)``: the update sharded over groups of N):

    python -m tpu_syncbn_torch.launch --simulate-chips 2 tpu_syncbn_torch/train.py -- --device cpu
    python -m tpu_syncbn_torch.launch --simulate-chips 2 tpu_syncbn_torch/train.py -- --device cpu --fsdp 2

Every numbered step of the recipe appears below, marked ``# [step N]``.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from tpu_syncbn_torch import data as tdata
from tpu_syncbn_torch import models, nn, parallel, runtime


def parse_args(argv=None):
    # [step 1] — no --local_rank: the rank comes from the launcher's
    # environment. Only ordinary training arguments remain.
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64, help="global batch")
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--dataset-size", type=int, default=512)
    p.add_argument("--arch", default="resnet18", choices=sorted(models.RESNETS))
    p.add_argument("--data-root", default=None,
                   help="directory containing cifar-10-batches-py (falls "
                   "back to synthetic data when absent)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--no-syncbn", action="store_true",
                   help="skip convert_sync_batchnorm (per-replica BN stats "
                   "— the behaviour SyncBN exists to fix)")
    p.add_argument("--zero", action="store_true",
                   help="shard parameters' update and optimizer state over the "
                   "processes (ZeRO: DataParallel(zero=True))")
    p.add_argument("--fsdp", type=int, default=0,
                   help="compose DP x FSDP: the update sharded over groups of N "
                   "processes (SpecLayout.fsdp(fsdp=N))")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    # [step 2] — device binding + process group (NCCL on the card, gloo
    # on the CPU; none at world 1)
    device = runtime.initialize(args.device)
    log = runtime.get_logger("train")
    log.info("world: %d process(es) on %s", runtime.process_count(), device)

    # model (CIFAR-10-shaped ResNet)
    model = models.RESNETS[args.arch](
        num_classes=10, small_input=True, device=device,
        generator=torch.Generator().manual_seed(0),
    )

    # [step 3] — SyncBN conversion (drop-in tree rewrite)
    if not args.no_syncbn:
        model = nn.convert_sync_batchnorm(model)

    # [step 4] — DDP wrap
    def loss_fn(m, batch):
        x, y = batch
        logits = m(x).float()
        loss = F.cross_entropy(logits, y.long())
        return loss, {"acc": (logits.argmax(-1) == y).float().mean()}

    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    layout = parallel.SpecLayout.fsdp(fsdp=args.fsdp, device=device) if args.fsdp else None
    dp = parallel.DataParallel(model, opt, loss_fn, device=device, zero=args.zero,
                               layout=layout)
    log.info("layout: %r", dp.layout)

    # [step 5] — sharded data + loader
    ds = None
    if args.data_root:
        ds = tdata.load_cifar10(args.data_root, train=True)
    if ds is None:
        ds = tdata.SyntheticImageDataset(
            length=args.dataset_size, shape=(32, 32, 3), num_classes=10
        )
    sampler = tdata.DistributedSampler(
        len(ds), num_replicas=runtime.process_count(),
        rank=runtime.process_index(), shuffle=True, seed=0,
    )
    if args.batch_size % runtime.process_count():
        raise SystemExit("--batch-size must be divisible by the process count")
    per_process_batch = args.batch_size // runtime.process_count()
    loader = tdata.DataLoader(
        ds, batch_size=per_process_batch, sampler=sampler,
        num_workers=8, drop_last=True,
    )
    if len(loader) == 0:
        raise SystemExit(
            f"dataset of {len(ds)} yields zero batches of "
            f"{args.batch_size} with drop_last — lower --batch-size"
        )

    # train loop — rank-0 logging only
    step = 0
    out = None
    for epoch in range(args.epochs):
        sampler.set_epoch(epoch)  # reshuffle each epoch
        for batch in tdata.device_prefetch(iter(loader), device=device):
            out = dp.train_step(batch)
            step += 1
            if step % 10 == 0:
                runtime.master_print(
                    f"epoch {epoch} step {step}: "
                    f"loss {float(out.loss):.4f} acc {float(out.metrics['acc']):.3f}"
                )
    final = f"final loss {float(out.loss):.4f}" if out is not None else "no steps ran"
    runtime.master_print(f"done: {step} steps, {final}")
    runtime.shutdown()


if __name__ == "__main__":
    main()

# [step 6] — launch: ``python -m tpu_syncbn_torch.train`` on one GPU, or
# ``python -m tpu_syncbn_torch.launch --nproc-per-node N
# tpu_syncbn_torch/train.py`` (or ``torchrun --nproc-per-node N -m
# tpu_syncbn_torch.train``) on N.
