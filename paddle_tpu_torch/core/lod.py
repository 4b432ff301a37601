"""LoD — level-of-detail ragged-sequence metadata, and the LoDTensor: the
port of the JAX package's ``core/lod.py``.

A LoD is a list of levels; each level is a monotonically increasing
offset vector. ``[[0, 2, 5]]`` = two sequences of lengths 2 and 3 packed
along axis 0; a second level nests sub-sequences inside those (the
reference's ``LoDTensor``, paddle/framework/lod_tensor.h).

Ragged data lives in packed-segment form: values concatenated along axis
0 plus host-side numpy offsets. The offsets drive shapes and index
arithmetic on the host; the index tensors derived from them
(``segment_ids``, ``pack_indices``) are torch tensors on the data's
device, copied there without the host waiting for the card, and nothing
is read back.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["LoD", "LoDTensor", "to_lod_tensor", "pack_indices",
           "host_to_device"]


def host_to_device(arr: np.ndarray, device=None) -> torch.Tensor:
    """A host index array as a tensor on ``device``. The copy is queued
    on the current stream (``non_blocking``: CUDA stages pageable memory
    before the call returns), so the host does not wait for the card."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device, non_blocking=True)


class LoD:
    """Nested sequence offsets. Immutable."""

    __slots__ = ("levels",)

    def __init__(self, levels: Sequence[Sequence[int]] = ()):
        lv = []
        for level in levels:
            arr = np.asarray(level, dtype=np.int64)
            if arr.ndim != 1 or arr.size < 1 or arr[0] != 0:
                raise ValueError(f"invalid LoD level {level!r}")
            if np.any(np.diff(arr) < 0):
                raise ValueError(
                    f"LoD offsets must be non-decreasing: {level!r}")
            lv.append(arr)
        self.levels = tuple(lv)

    @staticmethod
    def from_lengths(lengths_per_level: Sequence[Sequence[int]]) -> "LoD":
        """Build from recursive sequence lengths (fluid's
        ``recursive_sequence_lengths``)."""
        levels = []
        for lens in lengths_per_level:
            offs = np.concatenate([[0], np.cumsum(np.asarray(lens,
                                                             np.int64))])
            levels.append(offs)
        return LoD(levels)

    def __len__(self):
        return len(self.levels)

    def __bool__(self):
        return len(self.levels) > 0

    def __eq__(self, other):
        return (isinstance(other, LoD)
                and len(self.levels) == len(other.levels)
                and all(np.array_equal(a, b)
                        for a, b in zip(self.levels, other.levels)))

    def __repr__(self):
        return f"LoD({[lv.tolist() for lv in self.levels]})"

    def num_sequences(self, level: int = 0) -> int:
        return len(self.levels[level]) - 1

    def sequence_lengths(self, level: int = -1) -> np.ndarray:
        return np.diff(self.levels[level])

    def total_size(self, level: int = -1) -> int:
        return int(self.levels[level][-1])

    def max_length(self, level: int = -1) -> int:
        lens = self.sequence_lengths(level)
        return int(lens.max()) if lens.size else 0

    def offsets(self, level: int = -1) -> np.ndarray:
        return self.levels[level]

    def flatten_to_level(self, level: int) -> "LoD":
        """Collapse nesting above `level` (keep levels[level:])."""
        return LoD(self.levels[level:])

    def segment_ids(self, level: int = -1, total: int | None = None,
                    device=None) -> torch.Tensor:
        """int64 per-row segment id for the innermost (or given) level,
        on ``device``; rows past the LoD's end (padding) map to the
        out-of-range segment ``num_sequences``."""
        offs = self.levels[level]
        n = int(offs[-1]) if total is None else int(total)
        ids = np.full(n, len(offs) - 1, dtype=np.int64)
        lens = np.diff(offs)
        ids[: int(offs[-1])] = np.repeat(np.arange(len(lens)), lens)
        return host_to_device(ids, device)


class LoDTensor:
    """A tensor plus optional LoD ragged metadata; ragged data is packed
    along axis 0 (the reference's lod_tensor.h:83)."""

    __slots__ = ("array", "lod")

    def __init__(self, array, lod: LoD | None = None):
        if isinstance(array, LoDTensor):
            lod = lod or array.lod
            array = array.array
        self.array = (array if torch.is_tensor(array)
                      else torch.as_tensor(np.asarray(array)))
        self.lod = lod or LoD()
        if self.lod and self.array.shape[0] < self.lod.total_size():
            raise ValueError(
                f"LoD covers {self.lod.total_size()} rows but tensor has "
                f"{self.array.shape[0]}")

    @property
    def shape(self):
        return self.array.shape

    @property
    def dtype(self):
        return self.array.dtype

    def numpy(self) -> np.ndarray:
        return self.array.detach().cpu().numpy()

    def __repr__(self):
        return (f"LoDTensor(shape={tuple(self.array.shape)}, "
                f"dtype={self.array.dtype}, lod={self.lod})")


def to_lod_tensor(value, lod=None) -> LoDTensor:
    if isinstance(value, LoDTensor):
        return value
    if isinstance(lod, (list, tuple)):
        lod = LoD(lod)
    return LoDTensor(value, lod)


def pack_indices(lod: LoD, device=None):
    """Gather/scatter indices between packed ``[total, ...]`` and padded
    ``[B, T, ...]`` form (the reference's operators/math/
    sequence2batch.h), computed on the host from the offsets.

    Returns (gather [B, T] int64, mask [B, T] float32, scatter [total]
    int64 into the flattened padded array, B, T); the tensors on
    ``device``."""
    offs = lod.offsets(-1)
    lens = np.diff(offs)
    B, T = len(lens), int(lens.max()) if len(lens) else 0
    gather = np.zeros((B, T), np.int64)
    mask = np.zeros((B, T), np.float32)
    scatter = np.zeros(int(offs[-1]), np.int64)
    for b, (s, n) in enumerate(zip(offs[:-1], lens)):
        gather[b, :n] = np.arange(s, s + n)
        mask[b, :n] = 1.0
        scatter[s:s + n] = b * T + np.arange(n)
    return (host_to_device(gather, device), host_to_device(mask, device),
            host_to_device(scatter, device), B, T)
