"""RetinaNet-R50-FPN + SyncBN at per-GPU batch 2 — the counterpart of
``examples/retinanet_train.py``, the reference's small-batch detection
capability config (BASELINE.json config 4; the workload class the recipe
exists for).

One GPU:

    python -m tpu_syncbn_torch.retinanet_train --iters 50

Several GPUs of one host (one process per GPU):

    python -m tpu_syncbn_torch.launch --nproc-per-node 4 tpu_syncbn_torch/retinanet_train.py -- --iters 50

On the CPU (plain versions of the kernels; ``--arch small`` is a width-16
ResNet of one BasicBlock a stage under a 32-channel FPN):

    python -m tpu_syncbn_torch.retinanet_train --device cpu --arch small --image-size 64 --iters 4

Trains in float32, as the JAX example does, with Adam under the port's
``DataParallel``. COCO-format data via ``--coco-annotations`` and
``--coco-images`` when given, synthetic detection data otherwise. After
training the master decodes the first ``--eval-images`` images, runs
per-class NMS and prints COCO-style AP@[.5:.95] (on the train images: a
sanity number; point the annotations at a val split for a held-out one).
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from tpu_syncbn_torch import data as tdata
from tpu_syncbn_torch import models, nn, parallel, runtime, utils
from tpu_syncbn_torch.models import detection as det


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--per-chip-batch", type=int, default=2)  # the config
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--max-boxes", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--arch", choices=["r50", "small"], default="r50",
                   help="'small' = tiny backbone for CPU simulation")
    p.add_argument("--coco-annotations", default=None)
    p.add_argument("--coco-images", default=None)
    p.add_argument("--eval-images", type=int, default=64,
                   help="images for the final mAP eval")
    p.add_argument("--eval-top-k", type=int, default=100)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def build_model(arch: str, num_classes: int, size, device) -> models.RetinaNet:
    """The example's RetinaNet: R50-FPN, or the small CPU-simulation one
    (BasicBlock (1, 1, 1, 1), width 16, FPN 32); seed 0."""
    if arch == "small":
        backbone = models.ResNet(models.BasicBlock, (1, 1, 1, 1), num_classes=1,
                                 width=16, device=device,
                                 generator=torch.Generator().manual_seed(0))
        return models.RetinaNet(num_classes=num_classes, image_size=size,
                                fpn_channels=32, backbone=backbone,
                                device=device,
                                generator=torch.Generator().manual_seed(0))
    return models.retinanet_r50_fpn(num_classes=num_classes, image_size=size,
                                    device=device,
                                    generator=torch.Generator().manual_seed(0))


def make_dataset(args, size, log):
    """COCO-format data resized to ``size`` (boxes scaled alike) when
    given, else synthetic detection data; may set ``args.num_classes``."""
    if args.coco_annotations and args.coco_images:
        base = tdata.CocoDetectionDataset(args.coco_annotations, args.coco_images,
                                          max_boxes=args.max_boxes)
        args.num_classes = base.num_classes
        log.info("COCO: %d images, %d classes", len(base), base.num_classes)
        resize = tdata.transforms.Resize(args.image_size)

        def fit(sample):
            image, boxes, labels, valid = sample
            h, w = image.shape[:2]
            scale = np.asarray([args.image_size / w, args.image_size / h] * 2,
                               np.float32)
            return resize(image), boxes * scale, labels, valid

        return tdata.TransformDataset(base, fit)
    return tdata.SyntheticDetectionDataset(
        length=64, image_size=size, num_classes=args.num_classes,
        max_boxes=args.max_boxes)


def evaluate(model, ds, n_eval: int, num_classes: int, top_k: int) -> dict:
    """Decode + per-class NMS per image, then COCO-style AP over the first
    ``n_eval`` images of ``ds``; the model is left in eval mode."""
    model.eval()
    device = next(model.parameters()).device
    detections, ground_truths = [], []
    for i in range(n_eval):
        image, gboxes, glabels, gvalid = ds[i]
        boxes, scores, classes, keep = model.decode(
            torch.from_numpy(np.asarray(image)[None]).to(device), top_k=top_k)
        above = keep[0].cpu().numpy()
        b = boxes[0].cpu().numpy()[above]
        s = scores[0].cpu().numpy()[above]
        c = classes[0].cpu().numpy()[above]
        kept = det.batched_nms(b, s, c)
        detections.append((b[kept], s[kept], c[kept]))
        gvalid = np.asarray(gvalid)
        ground_truths.append((np.asarray(gboxes)[gvalid], np.asarray(glabels)[gvalid]))
    return utils.evaluate_detections(detections, ground_truths,
                                     num_classes=num_classes)


def main(argv=None) -> dict:
    """Train and evaluate; returns ``{"dp", "iters", "loss", "ap"}`` (``ap``
    None off the master)."""
    args = parse_args(argv)
    device = runtime.initialize(args.device)
    log = runtime.get_logger("retinanet")
    world = runtime.process_count()
    log.info("world: %d process(es) on %s; per-GPU batch %d (global %d)",
             world, device, args.per_chip_batch, args.per_chip_batch * world)
    size = (args.image_size, args.image_size)
    ds = make_dataset(args, size, log)  # first: the classes come from it

    # SyncBN in the backbone: the point of per-GPU batch 2
    model = nn.convert_sync_batchnorm(
        build_model(args.arch, args.num_classes, size, device))
    dp = parallel.DataParallel(
        model, torch.optim.Adam(model.parameters(), lr=args.lr),
        lambda m, b: m.loss(*b), device=device)

    sampler = tdata.DistributedSampler(len(ds), num_replicas=world,
                                       rank=runtime.process_index(),
                                       shuffle=True, seed=0)
    loader = tdata.DataLoader(ds, batch_size=args.per_chip_batch,
                              sampler=sampler, num_workers=4, drop_last=True)
    it, loss = 0, float("nan")
    meter = utils.AverageMeter("loss")
    while it < args.iters:
        sampler.set_epoch(it)
        with contextlib.closing(tdata.device_prefetch(iter(loader), device=device)) as batches:
            for batch in batches:
                out = dp.train_step(batch)
                loss = float(out.loss)
                meter.update(loss)
                it += 1
                if it % 10 == 0:
                    runtime.master_print(
                        f"iter {it}: loss {meter.avg:.4f} "
                        f"(cls {float(out.metrics['cls_loss']):.4f} "
                        f"box {float(out.metrics['box_loss']):.4f})")
                    meter.reset()
                if it >= args.iters:
                    break
    if args.ckpt_dir:
        utils.save_checkpoint(args.ckpt_dir, it, dp.state_dict())

    # master-only eval (the rank-0 convention)
    ap = None
    if runtime.is_master():
        n_eval = min(len(ds), args.eval_images)
        ap = evaluate(model, ds, n_eval, args.num_classes, args.eval_top_k)
        runtime.master_print(
            f"done: {it} iters; eval on {n_eval} images: "
            f"mAP@[.5:.95] {ap['mAP']:.4f}  AP50 {ap['AP50']:.4f}  "
            f"AP75 {ap['AP75']:.4f}")
    runtime.barrier("eval")  # release the other ranks
    runtime.shutdown()
    return {"dp": dp, "iters": it, "loss": loss, "ap": ap}


if __name__ == "__main__":
    main()
