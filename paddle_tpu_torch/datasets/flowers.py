"""The port of the JAX package's ``datasets/flowers.py`` (a copy: the port imports
nothing of the JAX package). Oxford 102 flowers dataset.

Parity: the reference's v2/dataset/flowers.py (224x224x3
images, 102 classes; the image-classification fine-tune workload).

Real data: the standard ``102flowers.tgz`` (jpg/image_XXXXX.jpg) plus
``imagelabels.mat`` and ``setid.mat`` under DATA_HOME/flowers, decoded
with PIL + scipy.io exactly like the reference's reader (1-indexed
labels and image ids; trnid/valid/tstid splits). Synthetic surrogate
otherwise: class-dependent color/texture prototypes at the same
shape/scale so CNN convergence tests are meaningful.
"""
from __future__ import annotations


import numpy as np

from paddle_tpu_torch.datasets import common

NUM_CLASSES = 102
IMAGE_SHAPE = (3, 224, 224)


def _has_real():
    return all(common.has_real_data("flowers", f)
               for f in ("102flowers.tgz", "imagelabels.mat",
                         "setid.mat"))


def _real(split_key, limit=None, size=224):
    """(ref flowers.py reader_creator over setid.mat splits). One
    sequential pass over the tgz (random access would re-decompress
    from byte 0 on every backward seek), yielding in archive order
    filtered to the split; ``limit`` caps the sample count."""
    import io
    import itertools
    import re
    import tarfile

    from PIL import Image
    from scipy.io import loadmat

    def samples():
        labels = loadmat(common.dataset_path(
            "flowers", "imagelabels.mat"))["labels"].ravel()
        ids = set(int(i) for i in loadmat(common.dataset_path(
            "flowers", "setid.mat"))[split_key].ravel())
        with tarfile.open(common.dataset_path(
                "flowers", "102flowers.tgz"), "r:gz") as tar:
            for m in tar:
                match = re.match(r"jpg/image_(\d+)\.jpg$", m.name)
                if not match or int(match.group(1)) not in ids:
                    continue
                img_id = int(match.group(1))
                img = Image.open(io.BytesIO(tar.extractfile(m).read()))
                img = img.convert("RGB").resize((size, size))
                arr = (np.asarray(img, np.float32) / 255.0)
                yield (arr.transpose(2, 0, 1).reshape(-1),
                       int(labels[img_id - 1]) - 1)

    def reader():
        return itertools.islice(samples(), limit)

    return reader


def _synthetic(n, seed, size=224):
    rng = np.random.RandomState(seed)
    proto_rng = np.random.RandomState(0xF10E)
    protos = proto_rng.rand(NUM_CLASSES, 3, 8, 8).astype(np.float32)

    def reader():
        for _ in range(n):
            label = int(rng.randint(0, NUM_CLASSES))
            base = np.kron(protos[label], np.ones((size // 8, size // 8),
                                                  np.float32))
            img = base + rng.randn(3, size, size).astype(np.float32) * 0.1
            yield np.clip(img, 0, 1).reshape(-1), label

    return reader


def train(n: int = 512):
    if _has_real():
        return _real("trnid", limit=n)
    return _synthetic(n, seed=21)


def test(n: int = 128):
    if _has_real():
        return _real("tstid", limit=n)
    return _synthetic(n, seed=22)


def valid(n: int = 128):
    if _has_real():
        return _real("valid", limit=n)
    return _synthetic(n, seed=23)
