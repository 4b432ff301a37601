"""The port of the JAX package's ``datasets/uci_housing.py`` (a copy: the port imports
nothing of the JAX package). UCI housing regression dataset
(parity: the reference's v2/dataset/uci_housing.py).

Samples: (13-dim float features, 1-dim float target). Real data: the
whitespace ``housing.data`` file under DATA_HOME/uci_housing, feature-
normalised and 80/20 split exactly like the reference's load_data.
Synthetic surrogate otherwise: a fixed linear model + noise, so
fit_a_line converges.
"""
from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.datasets import common

FEATURE_DIM = 13
_TRUE_W = np.random.RandomState(0xBEEF).randn(FEATURE_DIM).astype(np.float32)


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)

    def reader():
        for _ in range(n):
            x = rng.randn(FEATURE_DIM).astype(np.float32)
            y = float(x @ _TRUE_W + rng.randn() * 0.1 + 22.5)
            yield x, np.array([y], np.float32)

    return reader


def _load_real(path):
    """(ref uci_housing.py load_data: (x - avg) / (max - min) feature
    normalisation over the full matrix, first 80% train)."""
    data = np.loadtxt(path).astype(np.float32)
    feats, target = data[:, :FEATURE_DIM], data[:, FEATURE_DIM:]
    maxs, mins, avgs = feats.max(0), feats.min(0), feats.mean(0)
    feats = (feats - avgs) / np.maximum(maxs - mins, 1e-6)
    offset = int(len(data) * 0.8)
    return feats, target, offset


def _real(path, is_train):
    def reader():
        feats, target, offset = _load_real(path)
        sl = slice(0, offset) if is_train else slice(offset, None)
        for x, y in zip(feats[sl], target[sl]):
            yield x, np.asarray(y, np.float32)

    return reader


def train(n_synthetic: int = 2048):
    path = common.dataset_path("uci_housing", "housing.data")
    if os.path.exists(path):
        return _real(path, is_train=True)
    return _synthetic(n_synthetic, seed=21)


def test(n_synthetic: int = 256):
    path = common.dataset_path("uci_housing", "housing.data")
    if os.path.exists(path):
        return _real(path, is_train=False)
    return _synthetic(n_synthetic, seed=22)
