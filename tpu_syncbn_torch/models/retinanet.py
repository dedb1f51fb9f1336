"""RetinaNet-R50-FPN — the counterpart of ``tpu_syncbn.models.retinanet``:
the small-per-GPU-batch SyncBN capability config (BASELINE.json config 4,
"RetinaNet-R50-FPN COCO, per-chip batch=2"; the case the reference's
recipe exists for).

As in the JAX package: NHWC images in, anchors for a fixed image size
built at construction (a buffer, ``anchors``), ground truth padded to a
fixed ``max_boxes`` with a validity mask, nearest-neighbour top-down
upsampling, and BatchNorm only in the backbone (the ported
``models/resnet.py`` ResNet-50 through ``features()``: 53 BN layers); the
FPN and head convs are plain biased convs, so ``convert_sync_batchnorm``
syncs exactly the backbone statistics. Inside, activations are
channels_last NCHW tensors; P6 and P7 are 3×3 stride-2 convs with JAX's
asymmetric "SAME" padding (``resnet.same_pads``).

The loss is per image, as the JAX loss is ``vmap``-ed: each image's focal
and box losses are normalized by its own foreground count, then averaged
over the images.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_syncbn_torch.models import detection as det
from tpu_syncbn_torch.models.resnet import Bottleneck, Conv2d, ResNet
from tpu_syncbn_torch.runtime.distributed import resolve_device


def _conv(cin, cout, kernel, stride, device, generator) -> Conv2d:
    """``nnx.Conv`` with the JAX ResNet's He fan-out init and a zero bias."""
    return Conv2d(cin, cout, kernel, stride, device=device, generator=generator,
                  bias=True)


def _upsample2(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Nearest-neighbour 2× upsample, then crop to ``target_hw`` (odd
    sizes)."""
    y = F.interpolate(x, scale_factor=2, mode="nearest")
    return y[:, :, :target_hw[0], :target_hw[1]]


class FPN(nn.Module):
    """Feature pyramid over C3–C5 with the RetinaNet extras: P6 = conv
    stride 2 on C5, P7 = conv stride 2 on relu(P6) (torchvision
    LastLevelP6P7)."""

    def __init__(self, in_channels: tuple[int, int, int], out_channels: int,
                 *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.lateral = nn.ModuleList(
            [_conv(c, out_channels, 1, 1, **kw) for c in in_channels])
        self.output = nn.ModuleList(
            [_conv(out_channels, out_channels, 3, 1, **kw) for _ in in_channels])
        self.p6 = _conv(in_channels[-1], out_channels, 3, 2, **kw)
        self.p7 = _conv(out_channels, out_channels, 3, 2, **kw)

    def forward(self, c3, c4, c5):
        lat = [conv(c) for conv, c in zip(self.lateral, (c3, c4, c5))]
        p5 = lat[2]
        p4 = lat[1] + _upsample2(p5, lat[1].shape[2:])
        p3 = lat[0] + _upsample2(p4, lat[0].shape[2:])
        p3, p4, p5 = (out(p) for out, p in zip(self.output, (p3, p4, p5)))
        p6 = self.p6(c5)
        p7 = self.p7(F.relu(p6))
        return [p3, p4, p5, p6, p7]


class RetinaHead(nn.Module):
    """Shared classification and regression subnets (4 convs each, then
    an output conv); the class bias starts at the focal prior −log(99)."""

    def __init__(self, channels: int, num_anchors: int, num_classes: int,
                 *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.cls_tower = nn.ModuleList(
            [_conv(channels, channels, 3, 1, **kw) for _ in range(4)])
        self.box_tower = nn.ModuleList(
            [_conv(channels, channels, 3, 1, **kw) for _ in range(4)])
        self.cls_out = _conv(channels, num_anchors * num_classes, 3, 1, **kw)
        prior = 0.01
        with torch.no_grad():
            self.cls_out.bias.fill_(-math.log((1 - prior) / prior))
        self.box_out = _conv(channels, num_anchors * 4, 3, 1, **kw)
        self.num_classes = num_classes
        self.num_anchors = num_anchors

    def forward(self, feats):
        cls_all, box_all = [], []
        for f in feats:
            c = f
            for conv in self.cls_tower:
                c = F.relu(conv(c))
            b = f
            for conv in self.box_tower:
                b = F.relu(conv(b))
            n = f.shape[0]
            # (N, A·K, H, W) -> (N, H·W·A, K): the JAX NHWC reshape's order
            cls_all.append(self.cls_out(c).permute(0, 2, 3, 1)
                           .reshape(n, -1, self.num_classes))
            box_all.append(self.box_out(b).permute(0, 2, 3, 1).reshape(n, -1, 4))
        return torch.cat(cls_all, 1), torch.cat(box_all, 1)


class RetinaNet(nn.Module):
    """RetinaNet with a ResNet-FPN backbone (ResNet-50 by default).

    ``forward(images)`` → (cls_logits (B, A, K), box_deltas (B, A, 4)).
    ``loss(images, gt_boxes, gt_labels, gt_valid)`` → (total, aux dict),
    with ground truth padded to a fixed ``max_boxes`` and masked by
    ``gt_valid``. Parameters are drawn from ``generator`` (default: seeded
    with 0)."""

    def __init__(
        self,
        *,
        num_classes: int = 80,
        image_size: tuple[int, int] = (512, 512),
        fpn_channels: int = 256,
        backbone: ResNet | None = None,
        device: str | torch.device | None = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        if backbone is None:
            backbone = ResNet(Bottleneck, (3, 4, 6, 3), num_classes=1,
                              device=dev, generator=g)
        self.backbone = backbone
        dims = (backbone.feature_dim // 4, backbone.feature_dim // 2,
                backbone.feature_dim)  # C3, C4, C5
        self.fpn = FPN(dims, fpn_channels, device=dev, generator=g)
        self.head = RetinaHead(fpn_channels, 9, num_classes, device=dev,
                               generator=g)
        self.num_classes = num_classes
        self.image_size = tuple(image_size)
        self.register_buffer("anchors",
                             det.retinanet_anchors(self.image_size, device=dev))

    def forward(self, images: torch.Tensor):
        feats = self.backbone.features(images)  # C2..C5
        return self.head(self.fpn(feats[1], feats[2], feats[3]))

    def loss(self, images, gt_boxes, gt_labels, gt_valid):
        """Focal classification + smooth-L1 box loss, each normalized by
        the image's number of foreground anchors, then averaged over the
        images (the JAX loss's ``vmap``)."""
        cls_logits, box_deltas = self(images)
        anchors = self.anchors
        cls_l, box_l = [], []
        for logits, deltas, boxes, labels, valid in zip(
                cls_logits, box_deltas, gt_boxes, gt_labels, gt_valid):
            matched, _ = det.match_anchors(anchors, boxes, valid.bool())
            fg = matched >= 0
            ignore = matched == -2
            safe = matched.clamp_min(0)
            cls_t = F.one_hot(labels.long()[safe], self.num_classes).to(
                logits.dtype) * fg[:, None]
            focal = det.sigmoid_focal_loss(logits, cls_t)
            cls_loss = torch.where(ignore[:, None], 0.0, focal).sum()
            box_t = det.box_encode(boxes[safe], anchors)
            box_loss = det.smooth_l1(deltas, box_t).sum(-1)
            box_loss = torch.where(fg, box_loss, 0.0).sum()
            n_fg = fg.sum().clamp_min(1)
            cls_l.append(cls_loss / n_fg)
            box_l.append(box_loss / n_fg)
        cls_m, box_m = torch.stack(cls_l).mean(), torch.stack(box_l).mean()
        return cls_m + box_m, {"cls_loss": cls_m.detach(), "box_loss": box_m.detach()}

    @torch.no_grad()
    def decode(self, images, *, score_thresh: float = 0.05, top_k: int = 100):
        """Inference: the top-k scoring anchors per image, decoded (NMS is
        the host's post-process). ``torch.topk`` orders equal scores in no
        promised order, on the card least of all: compare decoded sets, or
        scores without ties."""
        cls_logits, box_deltas = self(images)
        scores = torch.sigmoid(cls_logits)  # (B, A, K)
        best_score, best_class = scores.max(-1).values, scores.argmax(-1)
        k = min(top_k, best_score.shape[1])
        top_scores, top_idx = torch.topk(best_score, k, dim=1)
        boxes = det.box_decode(
            box_deltas.gather(1, top_idx[..., None].expand(-1, -1, 4)),
            self.anchors[top_idx])
        classes = best_class.gather(1, top_idx)
        return boxes, top_scores, classes, top_scores >= score_thresh


def retinanet_r50_fpn(**kw) -> RetinaNet:
    return RetinaNet(**kw)
