"""DCGAN / SNGAN on CIFAR-10 with SyncBN in G and D — the counterpart of
``examples/gan_train.py``, the reference's GAN capability config
(BASELINE.json config 5).

One GPU:

    python -m tpu_syncbn_torch.gan_train --iters 200 [--arch sngan]

Several GPUs of one host (one process per GPU, ``--batch-size`` global):

    python -m tpu_syncbn_torch.launch --nproc-per-node 4 tpu_syncbn_torch/gan_train.py -- --iters 200

On the CPU (plain versions of the kernels):

    python -m tpu_syncbn_torch.gan_train --device cpu --iters 4 --batch-size 8

``--data-root DIR`` trains on CIFAR-10 when ``DIR/cifar-10-batches-py``
holds its python batches, else on an ImageFolder tree of real images
scaled to 32×32 in [-1, 1]; without it, on synthetic CIFAR-shaped data.
Each rank draws fresh latents from ``numpy.random.RandomState(seed +
rank)``. ``--ckpt-dir`` writes the trainer's state at the end; a 16-sample
``generate`` closes the run.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from tpu_syncbn_torch import data as tdata
from tpu_syncbn_torch import models, nn, parallel, runtime, utils


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=64, help="global")
    p.add_argument("--latent-dim", type=int, default=128)
    p.add_argument("--arch", choices=["dcgan", "sngan"], default="dcgan")
    p.add_argument("--g-lr", type=float, default=2e-4)
    p.add_argument("--d-lr", type=float, default=2e-4)
    p.add_argument("--data-root", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def make_dataset(data_root, log):
    """CIFAR-10 pickles, else an ImageFolder tree in [-1, 1] at 32×32,
    else synthetic CIFAR-shaped images (the JAX example's order)."""
    ds = None
    if data_root:
        ds = tdata.load_cifar10(data_root, train=True)
        if ds is None:
            T = tdata.transforms
            try:
                ds = tdata.ImageFolderDataset(
                    data_root,
                    T.Compose([T.ResizeShortestEdge(32), T.CenterCrop(32),
                               T.ToFloat(), T.Normalize((0.5,) * 3, (0.5,) * 3)]),
                )
                log.info("ImageFolder: %d real images", len(ds))
            except FileNotFoundError as e:
                log.warning("--data-root %r is neither a CIFAR pickle dir nor "
                            "an image tree (%s); using synthetic data",
                            data_root, e)
    if ds is None:
        ds = tdata.SyntheticImageDataset(length=2048, shape=(32, 32, 3))
    return ds


def main(argv=None) -> dict:
    """Train; returns ``{"trainer", "iters", "samples"}`` (the samples on
    the trainer's device)."""
    args = parse_args(argv)
    device = runtime.initialize(args.device)
    log = runtime.get_logger("gan")
    world, rank = runtime.process_count(), runtime.process_index()
    log.info("world: %d process(es) on %s", world, device)
    if args.batch_size % world:
        raise SystemExit("--batch-size must be divisible by the process count")

    G = models.DCGANGenerator(latent_dim=args.latent_dim, device=device,
                              generator=torch.Generator().manual_seed(args.seed))
    d_gen = torch.Generator().manual_seed(args.seed + 1)
    if args.arch == "sngan":
        D, loss = models.SNGANDiscriminator(device=device, generator=d_gen), "hinge"
    else:
        D, loss = models.DCGANDiscriminator(device=device, generator=d_gen), "bce"
    # SyncBN in both G and D (the reference README's GAN case)
    G = nn.convert_sync_batchnorm(G)
    D = nn.convert_sync_batchnorm(D)
    trainer = parallel.GANTrainer(
        G, D,
        torch.optim.Adam(G.parameters(), lr=args.g_lr, betas=(0.5, 0.999)),
        torch.optim.Adam(D.parameters(), lr=args.d_lr, betas=(0.5, 0.999)),
        loss=loss, device=device,
    )

    ds = make_dataset(args.data_root, log)
    sampler = tdata.DistributedSampler(len(ds), num_replicas=world, rank=rank,
                                       shuffle=True, seed=args.seed)
    per_rank = args.batch_size // world
    loader = tdata.DataLoader(ds, batch_size=per_rank, sampler=sampler,
                              num_workers=4, drop_last=True)
    if len(loader) == 0:
        raise SystemExit(f"dataset of {len(ds)} yields no batch of {per_rank}")

    rng = np.random.RandomState(args.seed + rank)

    def z(n=per_rank):
        return torch.from_numpy(rng.randn(n, args.latent_dim).astype(np.float32))

    it = 0
    d_meter, g_meter = utils.AverageMeter("d"), utils.AverageMeter("g")
    while it < args.iters:
        sampler.set_epoch(it)  # reshuffle per pass
        with contextlib.closing(tdata.device_prefetch(iter(loader), device=device)) as batches:
            for batch in batches:
                real = batch[0] if isinstance(batch, (tuple, list)) else batch
                out = trainer.train_step(real, z(), z())
                d_meter.update(float(out.d_loss))
                g_meter.update(float(out.g_loss))
                it += 1
                if it % 20 == 0:
                    runtime.master_print(
                        f"iter {it}: d {d_meter.avg:.4f} g {g_meter.avg:.4f} "
                        f"D(real) {float(out.metrics['d_real']):.3f} "
                        f"D(fake) {float(out.metrics['d_fake']):.3f}")
                    d_meter.reset()
                    g_meter.reset()
                if it >= args.iters:
                    break
    if args.ckpt_dir:
        utils.save_checkpoint(args.ckpt_dir, it, trainer.state_dict())
    samples = trainer.generate(z(16))
    runtime.master_print(
        f"done: {it} iters; sample range "
        f"[{float(samples.min()):.3f}, {float(samples.max()):.3f}]")
    runtime.shutdown()
    return {"trainer": trainer, "iters": it, "samples": samples}


if __name__ == "__main__":
    main()
