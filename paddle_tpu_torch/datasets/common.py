"""The port of the JAX package's ``datasets/common.py`` (a copy: the port imports
nothing of the JAX package). Dataset cache plumbing.

Parity: the reference's v2/dataset/common.py (download
cache under ~/.cache/paddle/dataset, md5-verified fetches,
cluster_files_reader).

This environment has zero network egress, so each dataset loader looks
for real files under ``DATA_HOME`` first and otherwise falls back to a
deterministic synthetic generator with identical sample structure —
keeping every demo/test/benchmark hermetic while preserving the
reference's reader API shapes.
"""
from __future__ import annotations

import hashlib
import os

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu", "dataset"))


def dataset_path(module: str, filename: str) -> str:
    return os.path.join(DATA_HOME, module, filename)


def has_real_data(module: str, filename: str) -> bool:
    return os.path.exists(dataset_path(module, filename))


def md5file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cluster_files_reader(file_pattern: str, trainer_count: int,
                         trainer_id: int):
    """Shard files across trainers (ref common.py cluster_files_reader)."""
    import glob

    def reader():
        files = sorted(glob.glob(file_pattern))
        for i, path in enumerate(files):
            if i % trainer_count == trainer_id:
                with open(path) as f:
                    for line in f:
                        yield line.rstrip("\n")

    return reader
