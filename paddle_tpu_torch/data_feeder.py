"""DataFeeder — python sample batches into feed arrays: the port of the
JAX package's ``data_feeder.py`` (the reference's
DataProviderConverter, py_paddle/dataprovider_converter.py:254, and
fluid DataFeeder).

Per-slot conversion of int, dense and sequence data into numpy arrays
on the host: dense slots stack, LoD slots concatenate their rows and
carry ``LoD.from_lengths`` of the per-sample lengths. The Executor (or
``reader.device_buffered``) moves them to the device.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.framework.program import Variable

__all__ = ["DataFeeder"]


def _np_dtype(var: Variable) -> np.dtype:
    return np.dtype(dtype_name(var.dtype))


def _rows(seq) -> np.ndarray:
    a = np.asarray(seq)
    return a.reshape(-1, 1) if a.ndim == 1 else a


class DataFeeder:
    def __init__(self, feed_list: Sequence[Variable], place=None):
        self.feed_vars = list(feed_list)
        self.place = place

    def feed(self, data: Sequence[Sequence]) -> dict:
        """data: list of samples; each sample is a tuple aligned with
        feed_list. Dense slots stack; lod slots concatenate rows and carry
        LoD offsets."""
        out = {}
        for i, var in enumerate(self.feed_vars):
            col = [sample[i] for sample in data]
            if var.lod_level > 0:
                out[var.name] = self._to_lod_tensor(col, var)
            else:
                out[var.name] = self._to_dense(col, var)
        return out

    def _to_dense(self, col: List, var: Variable):
        arr = np.asarray(col)
        dtype = _np_dtype(var)
        if arr.dtype != dtype:
            arr = arr.astype(dtype)
        # scalars (e.g. int labels) -> [N, 1] as the reference does
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        return arr

    def _to_lod_tensor(self, col: List, var: Variable):
        dtype = _np_dtype(var)
        if var.lod_level == 1:
            lengths = [len(seq) for seq in col]
            rows = [_rows(seq) for seq in col]
            flat = (np.concatenate(rows, axis=0) if rows
                    else np.zeros((0, 1)))
            return LoDTensor(flat.astype(dtype, copy=False),
                             LoD.from_lengths([lengths]))
        # nested sequences: col[i] is a list of sub-sequences
        outer, inner, rows = [], [], []
        for sample in col:
            outer.append(len(sample))
            for sub in sample:
                a = _rows(sub)
                inner.append(len(a))
                rows.append(a)
        flat = np.concatenate(rows, axis=0)
        return LoDTensor(flat.astype(dtype, copy=False),
                         LoD.from_lengths([outer, inner]))
