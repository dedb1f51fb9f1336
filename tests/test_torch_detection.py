"""The port's detection ops and data (``tpu_syncbn_torch.models.detection``,
``tpu_syncbn_torch.data.detection``) against the JAX package's, on the
same numpy inputs: anchors, box coding, IoU, the matcher with its tie
rules (the JAX tests' own cases, tests/test_retinanet.py, and random
ones), the focal and smooth-L1 losses, the host NMS copies,
``pad_ground_truth``, ``SyntheticDetectionDataset`` and
``CocoDetectionDataset`` on a small COCO JSON written into ``tmp_path``.

Tolerances: f32 ops rtol 1e-5 / atol 1e-6 (anchors bit-identical); the
matcher's indices, the numpy copies (NMS, the datasets) exactly equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_syncbn.data import detection as jdata
from tpu_syncbn.models import detection as jdet
from tpu_syncbn_torch.data import detection as tdata
from tpu_syncbn_torch.models import detection as det

OP = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.asarray(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def random_boxes(rs, n, lo=0.0, hi=100.0):
    xy = rs.uniform(lo, hi, (n, 2))
    wh = rs.uniform(1.0, 40.0, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("size", [(64, 64), (512, 512), (100, 75)])
def test_anchors_are_bit_identical(size):
    want = np.asarray(jdet.retinanet_anchors(size))
    got = det.retinanet_anchors(size).numpy()
    np.testing.assert_array_equal(got, want)
    lvl = det.generate_level_anchors(3, 5, 16, [32.0, 40.3]).numpy()
    np.testing.assert_array_equal(
        lvl, np.asarray(jdet.generate_level_anchors(3, 5, 16, [32.0, 40.3])))


def test_box_coding_and_iou_match_jax():
    rs = np.random.RandomState(0)
    anchors = random_boxes(rs, 50)
    boxes = random_boxes(rs, 50)
    boxes[3, 2] = boxes[3, 0]  # a zero-width box takes the 1e-6 floor
    np.testing.assert_allclose(det.box_encode(t(boxes), t(anchors)).numpy(),
                               np.asarray(jdet.box_encode(j(boxes), j(anchors))), **OP)
    deltas = (rs.randn(50, 4) * 3).astype(np.float32)  # past the dw/dh clamp too
    np.testing.assert_allclose(det.box_decode(t(deltas), t(anchors)).numpy(),
                               np.asarray(jdet.box_decode(j(deltas), j(anchors))),
                               rtol=1e-5, atol=1e-4)
    back = det.box_decode(det.box_encode(t(boxes[:3]), t(anchors[:3])), t(anchors[:3]))
    np.testing.assert_allclose(back.numpy(), boxes[:3], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(det.box_iou(t(anchors), t(boxes)).numpy(),
                               np.asarray(jdet.box_iou(j(anchors), j(boxes))), **OP)
    a = np.asarray([[0, 0, 10, 10]], np.float32)
    b = np.asarray([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]], np.float32)
    np.testing.assert_allclose(det.box_iou(t(a), t(b)).numpy()[0],
                               [1.0, 25 / 175, 0.0], rtol=1e-5)


# the JAX tests' matcher cases (tests/test_retinanet.py:41-66, :182-201)
MATCHER_CASES = {
    "thresholds_and_promotion": (
        [[0, 0, 10, 10], [0, 0, 12, 10], [4, 4, 18, 18], [40, 40, 50, 50],
         [100, 100, 110, 110]],
        [[0, 0, 10, 10], [39, 39, 52, 55]], [True, True]),
    "no_valid_gt": ([[0, 0, 10, 10]], [[0, 0, 0, 0]] * 3, [False] * 3),
    "padded_invalid_gt": ([[0, 0, 10, 10], [50, 50, 60, 60]],
                          [[0, 0, 10, 22], [0, 0, 0, 0], [0, 0, 0, 0]],
                          [True, False, False]),
    "tie_highest_gt_wins": ([[0, 0, 10, 10]], [[0, 0, 10, 30], [0, 0, 30, 10]],
                            [True, True]),
}


@pytest.mark.parametrize("case", sorted(MATCHER_CASES))
def test_matcher_cases_match_jax(case):
    anchors, gt, valid = (np.asarray(v, dt) for v, dt in
                          zip(MATCHER_CASES[case], (np.float32, np.float32, bool)))
    jm, jiou = jdet.match_anchors(j(anchors), j(gt), j(valid))
    m, iou = det.match_anchors(t(anchors), t(gt), t(valid))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), **OP)
    expect = {"thresholds_and_promotion": lambda m: m[0] == 0 and m[1] == 0
              and m[3] == 1 and m[4] == -1,
              "no_valid_gt": lambda m: m[0] == -1,
              "padded_invalid_gt": lambda m: m[0] == 0,
              "tie_highest_gt_wins": lambda m: m[0] == 1}[case]
    assert expect(m.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matcher_on_real_anchors_matches_jax(seed):
    """The 64² anchor grid against random padded ground truth, with exact
    ties planted (a GT duplicated, an anchor copied as a GT)."""
    rs = np.random.RandomState(seed)
    anchors = np.asarray(jdet.retinanet_anchors((64, 64)))
    gt = random_boxes(rs, 6, 0, 50)
    gt[4] = gt[1]               # two GTs with the same best anchors
    gt[5] = anchors[17]         # an anchor that is exactly a GT
    valid = np.asarray([True, True, False, True, True, rs.rand() < 0.5])
    jm, jiou = jdet.match_anchors(j(anchors), j(gt), j(valid))
    m, iou = det.match_anchors(t(anchors), t(gt), t(valid))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), **OP)
    assert (m.numpy() >= 0).any() and (m.numpy() == -1).any()


def test_losses_match_jax():
    rs = np.random.RandomState(3)
    logits = (rs.randn(64, 5) * 4).astype(np.float32)
    targets = (rs.rand(64, 5) < 0.2).astype(np.float32)
    for kw in ({}, {"alpha": -1.0, "gamma": 1.0}):
        np.testing.assert_allclose(
            det.sigmoid_focal_loss(t(logits), t(targets), **kw).numpy(),
            np.asarray(jdet.sigmoid_focal_loss(j(logits), j(targets), **kw)), **OP)
    pred, tgt = rs.randn(64, 4).astype(np.float32), rs.randn(64, 4).astype(np.float32)
    tgt[:8] = pred[:8] + 0.05  # inside beta: the quadratic branch
    np.testing.assert_allclose(det.smooth_l1(t(pred), t(tgt)).numpy(),
                               np.asarray(jdet.smooth_l1(j(pred), j(tgt))), **OP)


@pytest.mark.parametrize("seed", range(4))
def test_nms_copies_equal_jax(seed):
    rs = np.random.RandomState(seed)
    boxes = random_boxes(rs, 40, -20, 60)
    scores = rs.rand(40).astype(np.float32)
    classes = rs.randint(0, 3, 40)
    for thr in (0.3, 0.5):
        assert det.nms(boxes, scores, thr) == jdet.nms(boxes, scores, thr)
        assert det.batched_nms(boxes, scores, classes, thr) == \
            jdet.batched_nms(boxes, scores, classes, thr)
    assert det.batched_nms(np.zeros((0, 4)), np.zeros(0), np.zeros(0)) == []
    assert det.nms(np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]]),
                   np.asarray([0.9, 0.8, 0.7])) == [0, 2]


def test_pad_ground_truth_equals_jax():
    rs = np.random.RandomState(4)
    boxes, labels = random_boxes(rs, 7), rs.randint(0, 9, 7).astype(np.int32)
    for cap in (3, 7, 10):
        for got, want in zip(tdata.pad_ground_truth(boxes, labels, cap),
                             jdata.pad_ground_truth(boxes, labels, cap)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"image_size": (48, 40), "num_classes": 3,
                                     "max_boxes": 32, "seed": 7,
                                     "box_frac": (0.4, 0.7)}])
def test_synthetic_detection_dataset_is_bit_identical(kw):
    a, b = tdata.SyntheticDetectionDataset(length=12, **kw), \
        jdata.SyntheticDetectionDataset(length=12, **kw)
    assert len(a) == len(b) == 12
    for i in (0, 5, 11):
        for got, want in zip(a[i], b[i]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(IndexError):
        a[12]


def test_coco_detection_dataset_equals_jax(tmp_path):
    from PIL import Image

    ann = {
        "images": [{"id": 1, "file_name": "img1"}, {"id": 2, "file_name": "img2.png"},
                   {"id": 3, "file_name": "empty"}],
        "categories": [{"id": 7}, {"id": 3}],
        "annotations": [
            {"image_id": 1, "category_id": 7, "bbox": [10, 20, 30, 40]},
            {"image_id": 1, "category_id": 3, "bbox": [0, 0, 5, 5]},
            {"image_id": 2, "category_id": 3, "bbox": [4, 4, 8, 12]},
        ],
    }
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    rs = np.random.RandomState(5)
    np.save(tmp_path / "img1.npy", rs.rand(64, 64, 3).astype(np.float32))
    np.save(tmp_path / "empty.npy", rs.rand(16, 16, 3).astype(np.float32))
    Image.fromarray(rs.randint(0, 256, (30, 40, 3), dtype=np.uint8)).save(
        tmp_path / "img2.png")
    for size in (None, (32, 32)):
        a = tdata.CocoDetectionDataset(str(tmp_path / "ann.json"), str(tmp_path),
                                       max_boxes=4, image_size=size)
        b = jdata.CocoDetectionDataset(str(tmp_path / "ann.json"), str(tmp_path),
                                       max_boxes=4, image_size=size)
        assert a.num_classes == b.num_classes == 2 and len(a) == 3
        for i in range(3):
            for got, want in zip(a[i], b[i]):
                np.testing.assert_array_equal(got, want)
    _, boxes, labels, valid = tdata.CocoDetectionDataset(
        str(tmp_path / "ann.json"), str(tmp_path), max_boxes=4)[0]
    np.testing.assert_allclose(boxes[0], [10, 20, 40, 60])  # xywh -> xyxy
    assert labels[0] == 1 and labels[1] == 0  # densified: id 7 -> 1, id 3 -> 0
    assert valid.tolist() == [True, True, False, False]
