"""The port's numpy copies ``utils.coco_map.evaluate_detections`` and
``utils.fid`` (``gaussian_stats``, ``_sqrtm_psd``, ``frechet_distance``)
against the JAX package's, on random inputs: exactly equal (the same
numpy code on the same arrays)."""

import numpy as np
import pytest

from tpu_syncbn.utils import coco_map as jmap
from tpu_syncbn.utils import fid as jfid
from tpu_syncbn_torch.utils import coco_map, fid


def _boxes(rs, n):
    xy = rs.uniform(0, 80, (n, 2))
    return np.concatenate([xy, xy + rs.uniform(4, 30, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_detections_equals_jax(seed):
    rs = np.random.RandomState(seed)
    k = 4
    dets, gts = [], []
    for _ in range(6):
        g = _boxes(rs, rs.randint(0, 5))
        gc = rs.randint(0, k - 1, len(g))  # class k-1 has no ground truth
        # detections near the ground truth (true positives at some IoUs)
        # plus strays, more than max_dets for one image
        near = g + rs.randn(*g.shape).astype(np.float32) * 3
        d = np.concatenate([near, _boxes(rs, rs.randint(0, 8))])
        dc = np.concatenate([gc, rs.randint(0, k, len(d) - len(near))])
        dets.append((d, rs.rand(len(d)).astype(np.float32), dc))
        gts.append((g, gc))
    for max_dets in (100, 3):
        got = coco_map.evaluate_detections(dets, gts, k, max_dets=max_dets)
        want = jmap.evaluate_detections(dets, gts, k, max_dets=max_dets)
        assert set(got) == set(want) == {"mAP", "AP50", "AP75", "per_class"}
        for key in ("mAP", "AP50", "AP75"):
            assert got[key] == want[key]
        np.testing.assert_array_equal(got["per_class"], want["per_class"])
    with pytest.raises(ValueError, match="detection lists"):
        coco_map.evaluate_detections(dets[:2], gts, k)


@pytest.mark.parametrize("shrinkage", [None, 0.3, "oas"])
def test_frechet_distance_equals_jax(shrinkage):
    rs = np.random.RandomState(7)
    a = rs.randn(40, 6)
    b = rs.randn(50, 6) * 1.3 + 0.2
    sa, ja = fid.gaussian_stats(a, shrinkage), jfid.gaussian_stats(a, shrinkage)
    sb, jb = fid.gaussian_stats(b, shrinkage), jfid.gaussian_stats(b, shrinkage)
    for x, y in zip(sa + sb, ja + jb):
        np.testing.assert_array_equal(x, y)
    assert fid.frechet_distance(*sa, *sb) == jfid.frechet_distance(*ja, *jb)
    assert fid.frechet_distance(*sa, *sa) == jfid.frechet_distance(*ja, *ja)
    c = rs.randn(5, 5)
    np.testing.assert_array_equal(fid._sqrtm_psd(c @ c.T), jfid._sqrtm_psd(c @ c.T))
    with pytest.raises(ValueError):
        fid.gaussian_stats(a[:1])
