"""A copy of ``tpu_syncbn.utils.coco_map`` (numpy only; the port imports nothing of the
JAX package), held equal to it by ``tests/test_torch_coco_fid.py``.

Self-contained COCO-style mean average precision (AP@[.5:.95]).

The reference's detection workload (``README.md:3``) is judged by COCO
mAP; pycocotools is not available in this environment, so this implements
the COCO evaluation protocol directly: greedy score-ordered matching per
class per IoU threshold, 101-point interpolated precision, averaged over
the 10 IoU thresholds 0.50:0.05:0.95.

Deviations from pycocotools (documented, not accidental): no crowd
regions (the data pipeline carries no ``iscrowd``), and a single "all"
area range. Both reduce to the standard protocol on data without crowds.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix for (N,4) x (M,4) xyxy boxes."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None
    )
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None
    )
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _ap_from_matches(
    scores: np.ndarray, is_tp: np.ndarray, num_gt: int
) -> float:
    """101-point interpolated AP from per-detection TP flags (COCO)."""
    if num_gt == 0:
        return np.nan
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = is_tp[order]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(~tp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    # monotone non-increasing precision envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # precision at the 101 recall points (0 where recall never reached)
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    interp = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(interp.mean())


def evaluate_detections(
    detections: Sequence[tuple[np.ndarray, np.ndarray, np.ndarray]],
    ground_truths: Sequence[tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    *,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
    max_dets: int = 100,
) -> dict:
    """COCO-style AP over a dataset.

    ``detections[i]`` = ``(boxes (N,4) xyxy, scores (N,), classes (N,))``
    for image ``i``; ``ground_truths[i]`` = ``(boxes (M,4), classes (M,))``
    (pass only valid boxes — apply the padding mask upstream).

    Returns ``{"mAP", "AP50", "AP75", "per_class" (K,) np.ndarray}``;
    classes with zero ground-truth boxes are NaN in ``per_class`` and
    excluded from the means (COCO convention).
    """
    if len(detections) != len(ground_truths):
        raise ValueError(
            f"{len(detections)} detection lists vs "
            f"{len(ground_truths)} ground-truth lists"
        )
    n_thr = len(iou_thresholds)
    ap = np.full((n_thr, num_classes), np.nan)

    for c in range(num_classes):
        # gather per-image class-c detections and GT
        per_image = []
        num_gt = 0
        for (dboxes, dscores, dcls), (gboxes, gcls) in zip(
            detections, ground_truths
        ):
            dm = np.asarray(dcls) == c
            gm = np.asarray(gcls) == c
            db, ds = np.asarray(dboxes)[dm], np.asarray(dscores)[dm]
            if len(ds) > max_dets:
                keep = np.argsort(-ds, kind="stable")[:max_dets]
                db, ds = db[keep], ds[keep]
            gb = np.asarray(gboxes)[gm]
            num_gt += len(gb)
            # IoU depends only on the boxes — compute once, reuse for all
            # 10 thresholds
            iou = (
                _box_iou_np(db, gb)
                if len(db) and len(gb)
                else np.zeros((len(db), len(gb)))
            )
            per_image.append((db, ds, gb, iou))
        if num_gt == 0:
            continue

        all_scores = np.concatenate([ds for _, ds, _, _ in per_image]) if per_image else np.zeros(0)
        for ti, thr in enumerate(iou_thresholds):
            tps = []
            for db, ds, gb, iou in per_image:
                if len(ds) == 0:
                    continue
                order = np.argsort(-ds, kind="stable")
                matched = np.zeros(len(gb), bool)
                tp = np.zeros(len(ds), bool)
                if len(gb):
                    for d in order:
                        cand = np.where(~matched & (iou[d] >= thr))[0]
                        if cand.size:
                            best = cand[np.argmax(iou[d][cand])]
                            matched[best] = True
                            tp[d] = True
                tps.append(tp)
            is_tp = np.concatenate(tps) if tps else np.zeros(0, bool)
            ap[ti, c] = _ap_from_matches(all_scores, is_tp, num_gt)

    import warnings

    with warnings.catch_warnings():
        # all-NaN columns (classes with no GT) are expected and excluded;
        # silence nanmean's "Mean of empty slice"
        warnings.simplefilter("ignore", category=RuntimeWarning)
        per_class = np.nanmean(ap, axis=0)
        valid = ~np.isnan(ap)
        m_ap = float(np.nanmean(ap)) if valid.any() else 0.0
        i50 = int(np.argmin(np.abs(iou_thresholds - 0.50)))
        i75 = int(np.argmin(np.abs(iou_thresholds - 0.75)))
        ap50 = float(np.nanmean(ap[i50])) if valid[i50].any() else 0.0
        ap75 = float(np.nanmean(ap[i75])) if valid[i75].any() else 0.0
    return {"mAP": m_ap, "AP50": ap50, "AP75": ap75, "per_class": per_class}
