"""Detection building blocks — the counterpart of
``tpu_syncbn.models.detection``: anchors, box coding, IoU matching and the
losses in torch, with the JAX functions' shapes and tie rules; the host
NMS (``nms``, ``batched_nms``) as numpy copies.

Ground truth arrives padded to a fixed ``max_boxes`` with a validity mask,
matching is a dense IoU argmax, and the losses mask invalid entries: the
same static shapes as the JAX package, so one batch shape serves every
step.

Tie rules of :func:`match_anchors`, part of its semantics:
* an anchor's best GT is the first maximum (``torch.argmax``, as
  ``jnp.argmax``);
* an anchor that is the best anchor of several GTs is promoted to the
  highest GT index (torchvision's sequential overwrite), through the
  argmax of the reversed columns;
* padded invalid GTs are masked to IoU −1 and promote nothing.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# -- anchors ------------------------------------------------------------------


def generate_level_anchors(
    feat_h: int,
    feat_w: int,
    stride: int,
    sizes: Sequence[float],
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    *,
    device=None,
) -> torch.Tensor:
    """Anchors for one FPN level, (H·W·A, 4) as (x1, y1, x2, y2), centered
    on the stride grid (torchvision AnchorGenerator semantics)."""
    base = []
    for size in sizes:
        area = float(size) ** 2
        for r in ratios:
            w = math.sqrt(area / r)
            h = w * r
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base_a = torch.tensor(base, dtype=torch.float32, device=device)  # (A, 4)
    cx = (torch.arange(feat_w, dtype=torch.float32, device=device) + 0.5) * stride
    cy = (torch.arange(feat_h, dtype=torch.float32, device=device) + 0.5) * stride
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # (H, W), x along W
    centers = torch.stack([cxg, cyg, cxg, cyg], dim=-1).reshape(-1, 1, 4)
    return (centers + base_a[None]).reshape(-1, 4)


def retinanet_anchors(
    image_size: tuple[int, int],
    strides: Sequence[int] = (8, 16, 32, 64, 128),
    anchor_scale: float = 4.0,
    *,
    device=None,
) -> torch.Tensor:
    """All-level RetinaNet anchors concatenated: per level, 3 octave scales
    (2^0, 2^1/3, 2^2/3) × 3 ratios, base size ``anchor_scale × stride``."""
    h, w = image_size
    out = []
    for stride in strides:
        sizes = [anchor_scale * stride * (2 ** (o / 3)) for o in range(3)]
        out.append(generate_level_anchors(
            math.ceil(h / stride), math.ceil(w / stride), stride, sizes,
            device=device))
    return torch.cat(out, dim=0)


# -- box coding ---------------------------------------------------------------


def _centers(boxes: torch.Tensor, floor: float | None = None):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    if floor is not None:
        w, h = w.clamp_min(floor), h.clamp_min(floor)
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


def box_encode(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(x1y1x2y2 boxes, anchors) → (dx, dy, dw, dh) regression targets
    (Faster R-CNN coding, weights 1)."""
    ax, ay, aw, ah = _centers(anchors)
    bx, by, bw, bh = _centers(boxes, floor=1e-6)
    return torch.stack([(bx - ax) / aw, (by - ay) / ah,
                        torch.log(bw / aw), torch.log(bh / ah)], dim=-1)


def box_decode(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`box_encode`; clamps dw/dh like torchvision
    (log(1000/16) ≈ 4.135) for numerical safety."""
    ax, ay, aw, ah = _centers(anchors)
    clamp = math.log(1000.0 / 16)
    dw = deltas[..., 2].clamp(-clamp, clamp)
    dh = deltas[..., 3].clamp(-clamp, clamp)
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h],
                       dim=-1)


# -- IoU + matching -----------------------------------------------------------


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: (N, 4) × (M, 4) → (N, M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def match_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    high: float = 0.5,
    low: float = 0.4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-IoU assigner (torchvision Matcher semantics with
    allow_low_quality_matches): per anchor, the best valid GT index or −1
    (background) / −2 (ignore, between thresholds). Anchors that are the
    best anchor for some GT are force-matched to it (tie rules in the
    module docstring).

    Returns (matched_idx (N,) int64, max_iou (N,))."""
    iou = box_iou(anchors, gt_boxes)  # (N, M)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    best_gt = torch.argmax(iou, dim=1)
    best_iou = iou.gather(1, best_gt[:, None])[:, 0]
    matched = torch.where(
        best_iou >= high, best_gt,
        torch.where(best_iou < low, torch.full_like(best_gt, -1),
                    torch.full_like(best_gt, -2)))
    gt_best_iou = iou.max(dim=0).values  # (M,)
    ok = gt_valid & (gt_best_iou > 0)
    is_best = (iou >= gt_best_iou[None, :]) & ok[None, :]  # (N, M)
    m = gt_boxes.shape[0]
    promote_to = m - 1 - torch.argmax(is_best.flip(1).to(torch.uint8), dim=1)
    has_promo = is_best.any(dim=1)
    return torch.where(has_promo, promote_to, matched), best_iou


# -- losses -------------------------------------------------------------------


def sigmoid_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Elementwise sigmoid focal loss (RetinaNet paper; torchvision
    ``sigmoid_focal_loss`` semantics, reduction='none')."""
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 0.1111) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


# -- host-side NMS (eval post-process), copied from the JAX package ----------


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.5):
    """Greedy non-maximum suppression on the host (numpy) — the eval
    post-process torchvision runs after RetinaNet decode. Returns indices
    of kept boxes in descending score order."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        lt = np.maximum(boxes[i, :2], boxes[rest, :2])
        rb = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        area_i = max((boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1]), 0)
        area_r = np.clip(boxes[rest, 2] - boxes[rest, 0], 0, None) * np.clip(
            boxes[rest, 3] - boxes[rest, 1], 0, None
        )
        union = area_i + area_r - inter
        iou = np.where(union > 0, inter / union, 0.0)
        order = rest[iou <= iou_threshold]
    return keep


def batched_nms(boxes, scores, classes, iou_threshold: float = 0.5):
    """Per-class NMS (boxes of different classes never suppress each
    other), torchvision.ops.batched_nms semantics."""
    boxes = np.asarray(boxes, np.float32)
    classes = np.asarray(classes)
    if boxes.size == 0:
        return []
    # offset trick: shift each class into a disjoint coordinate region.
    # Normalize to a non-negative origin first — decoded boxes can have
    # negative coordinates near image edges, which would otherwise leak
    # across class regions.
    boxes = boxes - float(boxes.min())
    span = float(boxes.max()) + 1.0
    offsets = classes.astype(np.float32)[:, None] * span
    return nms(boxes + offsets, scores, iou_threshold)
