"""Image pipeline: decode, transforms, ImageFolder, COCO reader."""

import json
import os

import numpy as np
import pytest

from of_spmm.data import (
    CenterCrop, CocoDetection, Compose, DataLoader, ImageFolder, Normalize,
    RandomHorizontalFlip, RandomResizedCrop, Resize, decode_image,
    detection_collate,
)
from of_spmm.data.vision import HAVE_PIL, _resize_bilinear_np


def _write_png(path, h=32, w=48, color=(255, 0, 0)):
    from PIL import Image
    arr = np.zeros((h, w, 3), np.uint8)
    arr[:] = color
    Image.fromarray(arr).save(path)


@pytest.mark.skipif(not HAVE_PIL, reason="PIL not installed")
def test_decode_resize_crop_normalize(tmp_path):
    p = str(tmp_path / "a.png")
    _write_png(p, 40, 60, (10, 200, 30))
    img = decode_image(p)
    assert img.shape == (40, 60, 3)
    t = Compose((Resize(36), CenterCrop(32), Normalize()))
    out = t(img)
    assert out.shape == (3, 32, 32)
    assert out.dtype == np.float32


def test_numpy_bilinear_matches_identity():
    x = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    y = _resize_bilinear_np(x, 4, 6)
    np.testing.assert_array_equal(x, y)


@pytest.mark.skipif(not HAVE_PIL, reason="PIL not installed")
def test_image_folder_loader(tmp_path):
    for cls, color in (("cat", (255, 0, 0)), ("dog", (0, 0, 255))):
        os.makedirs(tmp_path / cls)
        for i in range(3):
            _write_png(str(tmp_path / cls / f"{i}.png"), color=color)
    t = Compose((RandomResizedCrop(16), RandomHorizontalFlip(), Normalize()))
    ds = ImageFolder(str(tmp_path), transform=t)
    assert len(ds) == 6
    dl = DataLoader(ds, batch_size=2, num_workers=0)
    xb, yb = next(iter(dl))
    assert xb.shape == (2, 3, 16, 16)
    assert set(ds.class_to_idx) == {"cat", "dog"}


@pytest.mark.skipif(not HAVE_PIL, reason="PIL not installed")
def test_coco_detection(tmp_path):
    imgdir = tmp_path / "imgs"
    os.makedirs(imgdir)
    _write_png(str(imgdir / "x.png"), 20, 20)
    ann = {
        "images": [{"id": 7, "file_name": "x.png", "height": 20, "width": 20}],
        "annotations": [
            {"id": 1, "image_id": 7, "bbox": [1, 2, 5, 6], "category_id": 3},
            {"id": 2, "image_id": 7, "bbox": [0, 0, 9, 9], "category_id": 1},
        ],
    }
    af = str(tmp_path / "ann.json")
    with open(af, "w") as f:
        json.dump(ann, f)
    ds = CocoDetection(str(imgdir), af)
    img, boxes, labels = ds[0]
    assert img.shape == (20, 20, 3)
    assert boxes.shape == (2, 4)
    assert labels.tolist() == [3, 1]
    imgs, bs, ls = detection_collate([ds[0], ds[0]])
    assert imgs.shape == (2, 20, 20, 3) and len(bs) == 2
