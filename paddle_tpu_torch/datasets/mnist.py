"""The port of the JAX package's ``datasets/mnist.py`` (a copy: the port imports
nothing of the JAX package). MNIST dataset.

Parity: the reference's v2/dataset/mnist.py (train/test
readers yielding (784-dim float image in [-1,1], int label)).

Real IDX files are used when present under DATA_HOME/mnist; otherwise a
deterministic synthetic surrogate with the same sample structure and a
learnable class signal (class-dependent mean patterns) is generated, so
convergence tests are meaningful without network access.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.datasets import common

IMAGE_DIM = 784
NUM_CLASSES = 10


def _synthetic(n: int, seed: int):
    rng = np.random.RandomState(seed)
    # fixed per-class prototype patterns
    protos = np.random.RandomState(0xC0FFEE).randn(NUM_CLASSES, IMAGE_DIM) * 0.8

    def reader():
        for i in range(n):
            label = int(rng.randint(0, NUM_CLASSES))
            img = protos[label] + rng.randn(IMAGE_DIM) * 0.5
            yield np.clip(img, -1, 1).astype(np.float32), label

    return reader


def _idx_reader(image_path: str, label_path: str):
    def reader():
        with gzip.open(label_path, "rb") as lf, gzip.open(image_path, "rb") as imf:
            _, n = struct.unpack(">II", lf.read(8))
            _, n2, rows, cols = struct.unpack(">IIII", imf.read(16))
            for _ in range(min(n, n2)):
                label = struct.unpack("B", lf.read(1))[0]
                img = np.frombuffer(imf.read(rows * cols), np.uint8)
                img = img.astype(np.float32) / 127.5 - 1.0
                yield img, int(label)

    return reader


def train(n_synthetic: int = 8192):
    ip = common.dataset_path("mnist", "train-images-idx3-ubyte.gz")
    lp = common.dataset_path("mnist", "train-labels-idx1-ubyte.gz")
    if os.path.exists(ip) and os.path.exists(lp):
        return _idx_reader(ip, lp)
    return _synthetic(n_synthetic, seed=1)


def test(n_synthetic: int = 1024):
    ip = common.dataset_path("mnist", "t10k-images-idx3-ubyte.gz")
    lp = common.dataset_path("mnist", "t10k-labels-idx1-ubyte.gz")
    if os.path.exists(ip) and os.path.exists(lp):
        return _idx_reader(ip, lp)
    return _synthetic(n_synthetic, seed=2)
