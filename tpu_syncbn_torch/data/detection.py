"""Detection data — the counterpart of ``tpu_syncbn.data.detection``,
copied (numpy only): padded-ground-truth datasets for the RetinaNet
capability config (BASELINE.json config 4).

Ground truth is padded to a fixed ``max_boxes`` per image with a validity
mask, the contract ``models.RetinaNet.loss`` consumes. COCO-format
annotations on disk load through :class:`CocoDetectionDataset` when
present; a deterministic synthetic generator stands in otherwise. The
per-index generation is the JAX package's numpy code, so
:class:`SyntheticDetectionDataset` gives bit-identical pixels and boxes
for the same arguments.
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpu_syncbn_torch.data.dataset import Dataset


def pad_ground_truth(
    boxes: np.ndarray, labels: np.ndarray, max_boxes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (N,4) boxes / (N,) labels to ``max_boxes`` with a validity mask;
    excess boxes are truncated (torchvision keeps them — TPU static shapes
    force the cap; choose max_boxes above the dataset's true maximum)."""
    n = min(len(boxes), max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_labels = np.zeros((max_boxes,), np.int32)
    valid = np.zeros((max_boxes,), bool)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = labels[:n]
    valid[:n] = True
    return out_boxes, out_labels, valid


class SyntheticDetectionDataset(Dataset):
    """Deterministic *learnable* synthetic detection samples:
    ``(image HWC, boxes (M,4), labels (M,), valid (M,))`` with 1..max_boxes
    random boxes per image — shapes ready for RetinaNet.loss.

    Each box region is painted with a class-specific color (a fixed
    palette keyed on the label) over a noise background, so localization
    and classification are actually learnable from pixels — a detector
    can be trained to nonzero mAP on this data, which is what the
    detection A/B's task-metric readout needs. ``noise`` scales the
    additive pixel noise (task difficulty knob); ``box_frac`` bounds box
    side length as a fraction of the image side (the default 10-30%
    sits below RetinaNet's smallest default anchor at 64x64 — pass
    e.g. ``(0.4, 0.7)`` for boxes the anchor grid can match at IoU>=0.5).

    Occlusion caveat: overlapping boxes are painted in order, so a later
    box overwrites an earlier box's class-colored pixels while the
    occluded ground truth is kept. That is bounded label noise at the
    default ``max_boxes=2`` but grows with ``max_boxes`` — it caps the
    AP any detector (or the A/B's val_map instrument) can reach on this
    data. Painting is deliberately left bit-identical across versions
    because recorded A/B artifacts key on the exact pixel stream."""

    def __init__(
        self,
        length: int = 256,
        image_size: tuple[int, int] = (64, 64),
        num_classes: int = 5,
        max_boxes: int = 8,
        seed: int = 0,
        noise: float = 0.3,
        box_frac: tuple[float, float] = (0.1, 0.3),
    ):
        self.length = length
        self.image_size = image_size
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.seed = seed
        self.noise = noise
        self.box_frac = box_frac
        # class palette: fixed across instances with the same num_classes
        # (train and held-out sets must mean the same thing by a label)
        self.palette = np.random.RandomState(12345).uniform(
            -1.5, 1.5, (num_classes, 3)
        ).astype(np.float32)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        rng = np.random.RandomState((self.seed * 999_983 + idx) % (2**31))
        h, w = self.image_size
        image = self.noise * rng.randn(h, w, 3).astype(np.float32)
        n = rng.randint(1, self.max_boxes + 1)
        lo, hi = self.box_frac
        x1 = rng.uniform(0, w * (1 - lo), n)
        y1 = rng.uniform(0, h * (1 - lo), n)
        bw = rng.uniform(w * lo, w * hi, n)
        bh = rng.uniform(h * lo, h * hi, n)
        boxes = np.stack(
            [x1, y1, np.minimum(x1 + bw, w), np.minimum(y1 + bh, h)], axis=1
        ).astype(np.float32)
        labels = rng.randint(0, self.num_classes, n).astype(np.int32)
        for (bx1, by1, bx2, by2), lab in zip(boxes, labels):
            # clamp into the canvas: rounding can push a box start to the
            # image edge (x1 can approach w for small box_frac minima),
            # and the painted block's shape must match its slice exactly
            ix1 = min(int(round(bx1)), w - 1)
            iy1 = min(int(round(by1)), h - 1)
            ix2 = min(max(int(round(bx2)), ix1 + 1), w)
            iy2 = min(max(int(round(by2)), iy1 + 1), h)
            image[iy1:iy2, ix1:ix2] = (
                self.palette[lab]
                + self.noise * rng.randn(iy2 - iy1, ix2 - ix1, 3)
            ).astype(np.float32)
        return (image,) + pad_ground_truth(boxes, labels, self.max_boxes)


class CocoDetectionDataset(Dataset):
    """COCO-format annotations + real images (or a pre-decoded store).

    ``annotation_file`` is standard COCO instances JSON. Images load from
    ``image_root``: the actual ``file_name`` (JPEG/PNG, PIL decode — the
    real-COCO path, reference ``README.md:76-91`` step 5) when present,
    else ``{file_name}.npy`` (HWC float32 from a one-off pre-decode
    pass). Category ids are densified to [0, K).

    ``image_size=(H, W)`` resizes every image to a fixed shape (bilinear)
    and scales its boxes to match — TPU static-shape requirement for
    batched detection training.
    """

    def __init__(self, annotation_file: str, image_root: str, *,
                 max_boxes: int = 100,
                 image_size: tuple[int, int] | None = None):
        with open(annotation_file) as f:
            coco = json.load(f)
        self.image_root = image_root
        self.max_boxes = max_boxes
        self.image_size = image_size
        cats = sorted(c["id"] for c in coco.get("categories", []))
        self.cat_to_dense = {c: i for i, c in enumerate(cats)}
        self.num_classes = len(cats)
        anns_by_img: dict[int, list] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.entries = []
        for img in coco.get("images", []):
            anns = anns_by_img.get(img["id"], [])
            boxes = np.asarray(
                [
                    [a["bbox"][0], a["bbox"][1],
                     a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                    for a in anns
                ],
                np.float32,
            ).reshape(-1, 4)
            labels = np.asarray(
                [self.cat_to_dense[a["category_id"]] for a in anns], np.int32
            )
            self.entries.append((img["file_name"], boxes, labels))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx):
        file_name, boxes, labels = self.entries[idx]
        raw = os.path.join(self.image_root, file_name)
        if os.path.exists(raw):
            from tpu_syncbn_torch.data.image_folder import decode_image

            image = decode_image(raw).astype(np.float32) / 255.0
        else:
            image = np.load(raw + ".npy").astype(np.float32)
        if self.image_size is not None:
            h, w = image.shape[:2]
            th, tw = self.image_size
            if (h, w) != (th, tw):
                from tpu_syncbn_torch.data.transforms import _resize_bilinear

                image = _resize_bilinear(image, (th, tw))
                boxes = boxes * np.asarray(
                    [tw / w, th / h, tw / w, th / h], np.float32
                )
        return (image,) + pad_ground_truth(boxes, labels, self.max_boxes)
