"""The port of the JAX package's ``datasets/voc2012.py`` (a copy: the port imports
nothing of the JAX package). PASCAL VOC 2012 detection/segmentation dataset.

Parity: the reference's v2/dataset/voc2012.py (image +
segmentation label pairs; also the detection demo's data).

Real data: the standard ``VOCtrainval_11-May-2012.tar`` under
DATA_HOME/voc2012 — JPEGImages decoded with PIL, Annotations XML
bndboxes parsed into the same padded-dense form, Main train/val image
sets. Synthetic surrogate otherwise for detection training: images with
1-2 colored rectangles. Samples either way are (image [3,H,W],
gt_boxes [M,4] normalized corners, gt_labels [M], gt_mask [M]) padded
to MAX_BOXES — the padded-dense ground-truth form the JAX package's
ssd_loss consumes.
"""
from __future__ import annotations


import numpy as np

from paddle_tpu_torch.datasets import common

NUM_CLASSES = 21  # 20 + background
MAX_BOXES = 4
IMAGE_SIZE = 64

# the canonical 20 VOC classes, ids 1..20 (0 = background)
VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def _archive():
    return common.dataset_path("voc2012", "VOCtrainval_11-May-2012.tar")


def _has_real():
    return common.has_real_data("voc2012", "VOCtrainval_11-May-2012.tar")


def _real(split, limit=None, size=IMAGE_SIZE):
    """Parse JPEGImages + Annotations XML into the padded-dense form."""
    import io
    import tarfile
    import xml.etree.ElementTree as ET

    from PIL import Image

    cls_idx = {c: i + 1 for i, c in enumerate(VOC_CLASSES)}
    root = "VOCdevkit/VOC2012"

    def reader():
        with tarfile.open(_archive(), "r") as tar:
            names = set(tar.getnames())
            set_name = f"{root}/ImageSets/Main/{split}.txt"
            ids = tar.extractfile(set_name).read().decode().split()
            if limit is not None:
                ids = ids[:limit]
            for img_id in ids:
                jpg = f"{root}/JPEGImages/{img_id}.jpg"
                xml = f"{root}/Annotations/{img_id}.xml"
                if jpg not in names or xml not in names:
                    continue
                tree = ET.fromstring(tar.extractfile(xml).read())
                sz = tree.find("size")
                W = float(sz.find("width").text)
                H = float(sz.find("height").text)
                boxes = np.zeros((MAX_BOXES, 4), np.float32)
                labels = np.zeros(MAX_BOXES, np.int64)
                mask = np.zeros(MAX_BOXES, np.float32)
                j = 0
                for obj in tree.iter("object"):
                    if j >= MAX_BOXES:
                        break
                    name = obj.find("name").text.strip()
                    if name not in cls_idx:
                        continue
                    bb = obj.find("bndbox")
                    boxes[j] = [
                        float(bb.find("xmin").text) / W,
                        float(bb.find("ymin").text) / H,
                        float(bb.find("xmax").text) / W,
                        float(bb.find("ymax").text) / H,
                    ]
                    labels[j] = cls_idx[name]
                    mask[j] = 1.0
                    j += 1
                img = Image.open(io.BytesIO(
                    tar.extractfile(jpg).read()))
                img = img.convert("RGB").resize((size, size))
                arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
                yield arr, boxes, labels, mask

    return reader


def _synthetic(n, seed, size=IMAGE_SIZE):
    rng = np.random.RandomState(seed)

    def reader():
        for _ in range(n):
            img = rng.rand(3, size, size).astype(np.float32) * 0.2
            m = int(rng.randint(1, 3))
            boxes = np.zeros((MAX_BOXES, 4), np.float32)
            labels = np.zeros(MAX_BOXES, np.int64)
            mask = np.zeros(MAX_BOXES, np.float32)
            for j in range(m):
                w, h = rng.randint(8, size // 2, 2)
                x1 = int(rng.randint(0, size - w))
                y1 = int(rng.randint(0, size - h))
                cls = int(rng.randint(1, NUM_CLASSES))
                img[:, y1:y1 + h, x1:x1 + w] = \
                    (np.asarray([cls % 3, (cls // 3) % 3, cls % 5],
                                np.float32)[:, None, None] / 5.0 + 0.3)
                boxes[j] = [x1 / size, y1 / size, (x1 + w) / size,
                            (y1 + h) / size]
                labels[j] = cls
                mask[j] = 1.0
            yield img, boxes, labels, mask

    return reader


def train(n: int = 256):
    if _has_real():
        return _real("train", limit=n)
    return _synthetic(n, seed=31)


def val(n: int = 64):
    if _has_real():
        return _real("val", limit=n)
    return _synthetic(n, seed=32)
