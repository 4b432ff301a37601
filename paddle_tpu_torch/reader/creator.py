"""Reader creators: the port of the JAX package's ``reader/creator.py``
(the reference's v2/reader/creator.py:22,42,60,91).

``np_array`` and ``text_file`` as in the JAX package; ``recordio`` (the
record-file reader) and ``cloud_reader`` (the master service's
task-sharded reader) need ``reader/recordio.py`` and ``cloud/``, ROADMAP
A11's, and raise naming it.
"""
from __future__ import annotations

import numpy as np

__all__ = ["np_array", "text_file", "recordio", "cloud_reader"]


def np_array(x: np.ndarray):
    """Yield rows of a numpy array (ref creator.py:22)."""

    def reader():
        yield from np.asarray(x)

    return reader


def text_file(path: str):
    """Yield lines, newline stripped (ref creator.py:42)."""

    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths):
    raise NotImplementedError(
        "reader.creator.recordio needs reader/recordio.py, not ported yet "
        "(ROADMAP A11)")


def cloud_reader(glob_paths, master_addr: str, pass_id_holder=None):
    raise NotImplementedError(
        "reader.creator.cloud_reader needs the master service (cloud/), "
        "not ported yet (ROADMAP A11)")
