"""The port of the JAX package's ``datasets/cifar.py`` (a copy: the port
imports nothing of the JAX package). CIFAR-10/100 dataset (parity: the
reference's v2/dataset/cifar.py).

Samples: (3072-dim float image in [0,1] laid out CHW, int label).
Real data: the standard python-pickle archives
(``cifar-10-python.tar.gz`` / ``cifar-100-python.tar.gz``) under
DATA_HOME/cifar, parsed exactly like the reference's reader_creator.
Synthetic surrogate otherwise: class-prototype color blobs.
"""
from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.datasets import common

IMAGE_DIM = 3 * 32 * 32


def _real(archive, name_filter, label_key):
    """(ref cifar.py reader_creator: pickle batches inside the tar)."""
    import pickle
    import tarfile

    def reader():
        with tarfile.open(archive, "r:gz") as tf:
            members = sorted(
                (m for m in tf.getmembers() if name_filter(m.name)),
                key=lambda m: m.name)
            for m in members:
                batch = pickle.load(tf.extractfile(m), encoding="bytes")
                for img, lab in zip(batch[b"data"], batch[label_key]):
                    yield (np.asarray(img, np.float32) / 255.0), int(lab)

    return reader


def _synthetic(n, num_classes, seed):
    rng = np.random.RandomState(seed)
    protos = np.random.RandomState(0xCAFE + num_classes).rand(num_classes, IMAGE_DIM)

    def reader():
        for _ in range(n):
            label = int(rng.randint(0, num_classes))
            img = 0.7 * protos[label] + 0.3 * rng.rand(IMAGE_DIM)
            yield img.astype(np.float32), label

    return reader


def train10(n_synthetic: int = 4096):
    path = common.dataset_path("cifar", "cifar-10-python.tar.gz")
    if os.path.exists(path):
        return _real(path, lambda n: "data_batch" in n, b"labels")
    return _synthetic(n_synthetic, 10, seed=11)


def test10(n_synthetic: int = 512):
    path = common.dataset_path("cifar", "cifar-10-python.tar.gz")
    if os.path.exists(path):
        return _real(path, lambda n: "test_batch" in n, b"labels")
    return _synthetic(n_synthetic, 10, seed=12)


def train100(n_synthetic: int = 4096):
    path = common.dataset_path("cifar", "cifar-100-python.tar.gz")
    if os.path.exists(path):
        return _real(path, lambda n: n.endswith("train"), b"fine_labels")
    return _synthetic(n_synthetic, 100, seed=13)


def test100(n_synthetic: int = 512):
    path = common.dataset_path("cifar", "cifar-100-python.tar.gz")
    if os.path.exists(path):
        return _real(path, lambda n: n.endswith("test"), b"fine_labels")
    return _synthetic(n_synthetic, 100, seed=14)
