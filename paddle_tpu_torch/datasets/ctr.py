"""The port of the JAX package's ``datasets/ctr.py`` (a copy: the port imports
nothing of the JAX package). CTR / sparse high-dimensional dataset (DeepFM-style workload).

Parity target: the sparse-parameter training path of the reference
(SparseRemoteParameterUpdater + SparsePrefetchRowCpuMatrix,
the reference's paddle/trainer/RemoteParameterUpdater.h:265,
the reference's paddle/math/SparseRowMatrix.h:206) exercised by CTR-scale
models (BASELINE.json config #4).

Samples: (field_feature_ids[int64 x NUM_FIELDS], click label). Real
data: criteo-style TSV ``train.txt`` / ``test.txt`` under DATA_HOME/ctr
(label, 13 integer columns ignored here, 26 categorical hashes — one id
per field, hashed into the per-field bucket space). Synthetic surrogate
otherwise, with planted feature weights so AUC is learnable.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from paddle_tpu_torch.datasets import common

NUM_FIELDS = 26
FEATURE_DIM = 100_000  # sparse id space per field hash bucket


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(0xAD).randn(1 << 12) * 0.7

    def reader():
        for _ in range(n):
            ids = rng.randint(0, FEATURE_DIM, NUM_FIELDS).astype(np.int64)
            logit = w[ids % len(w)].sum() / np.sqrt(NUM_FIELDS)
            p = 1.0 / (1.0 + np.exp(-logit))
            label = int(rng.rand() < p)
            yield ids, label

    return reader


def _real(path):
    def reader():
        with open(path) as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 1 + 13 + NUM_FIELDS:
                    continue
                label = int(cols[0])
                cats = cols[1 + 13:1 + 13 + NUM_FIELDS]
                ids = np.asarray(
                    [zlib.crc32(c.encode()) % FEATURE_DIM for c in cats],
                    np.int64)
                yield ids, label

    return reader


def train(n_synthetic: int = 8192):
    path = common.dataset_path("ctr", "train.txt")
    if os.path.exists(path):
        return _real(path)
    return _synthetic(n_synthetic, seed=71)


def test(n_synthetic: int = 1024):
    path = common.dataset_path("ctr", "test.txt")
    if os.path.exists(path):
        return _real(path)
    return _synthetic(n_synthetic, seed=72)
