"""The port's ImageFolderDataset against tpu_syncbn.data.image_folder on a
tree the test writes with PIL: the same classes, class mapping (also a
pinned one), sample order, decoded pixels and labels, transforms applied
per item, the same errors, and a custom loader with other extensions."""

import os

import numpy as np
import pytest
from PIL import Image

from tpu_syncbn import data as jdata
from tpu_syncbn_torch import data as tdata


def write_tree(root, classes=("ant", "bee", "cow"), n=4, seed=0, fmt="JPEG"):
    """root/<class>/<i>.jpg with noise images of varying size (the class
    names sort differently from their creation order on purpose), plus a
    text file and an empty class directory that must be skipped."""
    rs = np.random.RandomState(seed)
    ext = {"JPEG": ".jpg", "PNG": ".png"}[fmt]
    for c in reversed(classes):
        d = os.path.join(root, c)
        os.makedirs(d, exist_ok=True)
        for i in reversed(range(n)):
            h, w = rs.randint(20, 40), rs.randint(20, 40)
            px = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(px).save(os.path.join(d, f"img_{i:02d}{ext}"),
                                     format=fmt, quality=90)
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("not an image")
    os.makedirs(os.path.join(root, "zzz_empty"), exist_ok=True)
    return str(root)


def assert_same_dataset(j, t):
    assert t.classes == j.classes and t.class_to_idx == j.class_to_idx
    assert len(t) == len(j)
    assert [(os.path.relpath(p), y) for p, y in t.samples] == \
        [(os.path.relpath(p), y) for p, y in j.samples]
    for i in range(len(t)):
        (jx, jy), (tx, ty) = j[i], t[i]
        assert tx.dtype == jx.dtype and tx.shape == jx.shape
        assert np.array_equal(tx, jx)
        assert ty == jy and ty.dtype == jy.dtype == np.int32


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_same_classes_samples_and_pixels(tmp_path, fmt):
    root = write_tree(tmp_path, fmt=fmt)
    j, t = jdata.ImageFolderDataset(root), tdata.ImageFolderDataset(root)
    assert t.classes == ["ant", "bee", "cow", "zzz_empty"]
    assert len(t) == 12 and t.samples[0][0].endswith(os.path.join("ant", "img_00" + (
        ".jpg" if fmt == "JPEG" else ".png")))
    assert_same_dataset(j, t)
    x = tdata.decode_image(t.samples[5][0])
    assert np.array_equal(x, jdata.decode_image(t.samples[5][0]))
    assert x.dtype == np.uint8 and x.ndim == 3 and x.shape[2] == 3


def test_pinned_class_mapping_drops_and_renumbers(tmp_path):
    root = write_tree(tmp_path)
    pinned = {"cow": 0, "ant": 1}  # "bee" left out, as a val split might
    j = jdata.ImageFolderDataset(root, class_to_idx=pinned)
    t = tdata.ImageFolderDataset(root, class_to_idx=pinned)
    assert t.classes == ["cow", "ant"] and len(t) == 8
    assert_same_dataset(j, t)


def test_transform_runs_per_item(tmp_path):
    root = write_tree(tmp_path)
    jt, tt = jdata.transforms, tdata.transforms
    j = jdata.ImageFolderDataset(root, jt.Compose([
        jt.RandomResizedCrop(16, seed=2), jt.ToFloat()]))
    t = tdata.ImageFolderDataset(root, tt.Compose([
        tt.RandomResizedCrop(16, seed=2), tt.ToFloat()]))
    for i in (0, 3, 11, 3):
        (jx, jy), (tx, ty) = j[i], t[i]
        assert tx.shape == (16, 16, 3) and tx.dtype == np.float32
        assert np.array_equal(tx, jx) and ty == jy


def test_custom_loader_and_extensions(tmp_path):
    rs = np.random.RandomState(1)
    for c in ("a", "b"):
        os.makedirs(tmp_path / c)
        for i in range(3):
            np.save(tmp_path / c / f"{i}.npy", rs.randint(0, 255, (8, 9, 3), dtype=np.uint8))
    kw = dict(extensions=(".NPY",), loader=np.load)
    j = jdata.ImageFolderDataset(str(tmp_path), **kw)
    t = tdata.ImageFolderDataset(str(tmp_path), **kw)
    assert len(t) == 6
    assert_same_dataset(j, t)


def test_the_same_errors(tmp_path):
    for mod in (jdata, tdata):
        with pytest.raises(FileNotFoundError, match="not a directory"):
            mod.ImageFolderDataset(str(tmp_path / "missing"))
    (tmp_path / "cls").mkdir()
    for mod in (jdata, tdata):
        with pytest.raises(FileNotFoundError, match="no images"):
            mod.ImageFolderDataset(str(tmp_path))
