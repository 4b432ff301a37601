"""The port of the JAX package's ``reader/provider.py`` (a copy: the port imports
nothing of the JAX package). The @provider data-source decorator.

Parity: the PyDataProvider2 protocol — user generators decorated with
``@provider(input_types=...)`` declaring dense/sparse/int/sequence slots,
driven by the C++ DataProvider
(the reference's trainer/PyDataProvider2.py:55,365,
the reference's paddle/gserver/dataproviders/PyDataProvider2.cpp).

TPU redesign: slot declarations validate/convert each yielded sample to
the framework's feed forms (numpy for dense/int, (rows, values) for
sparse, lists for sequences); the C++ double-buffer thread collapses
into reader.decorator.buffered.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

__all__ = ["InputType", "provider", "dense_vector", "integer_value",
           "sparse_binary_vector", "integer_value_sequence",
           "dense_vector_sequence"]


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str
    dim: int

    def convert(self, value):
        if self.kind == "dense":
            arr = np.asarray(value, np.float32).reshape(-1)
            if arr.shape[0] != self.dim:
                raise ValueError(
                    f"dense slot expects dim {self.dim}, got {arr.shape[0]}")
            return arr
        if self.kind == "int":
            iv = int(value)
            if not 0 <= iv < self.dim:
                raise ValueError(
                    f"integer slot value {iv} outside [0, {self.dim})")
            return iv
        if self.kind == "sparse_binary":
            idx = np.asarray(value, np.int64).reshape(-1)
            if idx.size and (idx.min() < 0 or idx.max() >= self.dim):
                raise ValueError("sparse index out of range")
            return idx
        if self.kind == "int_seq":
            seq = [int(v) for v in value]
            if any(not 0 <= v < self.dim for v in seq):
                raise ValueError("sequence token outside vocabulary")
            return seq
        if self.kind == "dense_seq":
            return [np.asarray(v, np.float32).reshape(self.dim)
                    for v in value]
        raise AssertionError(self.kind)


def dense_vector(dim: int) -> InputType:
    return InputType("dense", dim)


def integer_value(value_range: int) -> InputType:
    return InputType("int", value_range)


def sparse_binary_vector(dim: int) -> InputType:
    return InputType("sparse_binary", dim)


def integer_value_sequence(value_range: int) -> InputType:
    return InputType("int_seq", value_range)


def dense_vector_sequence(dim: int) -> InputType:
    return InputType("dense_seq", dim)


def provider(input_types: Sequence[InputType], should_shuffle: bool = False,
             buffer_size: int = 0):
    """Decorate ``gen(*args) -> yields samples`` into a reader factory:
    each sample is validated/converted against ``input_types``
    (ref PyDataProvider2.py @provider + init_hook protocol)."""
    types = list(input_types)

    def deco(gen):
        @functools.wraps(gen)
        def factory(*args, **kwargs):
            def reader():
                for sample in gen(*args, **kwargs):
                    if len(types) == 1 and not isinstance(sample, tuple):
                        sample = (sample,)
                    if len(sample) != len(types):
                        raise ValueError(
                            f"sample has {len(sample)} slots, provider "
                            f"declares {len(types)}")
                    yield tuple(t.convert(v) for t, v in zip(types, sample))

            out = reader
            if should_shuffle:
                from paddle_tpu_torch.reader.decorator import shuffle
                out = shuffle(out, buf_size=buffer_size or 512)
            elif buffer_size:
                from paddle_tpu_torch.reader.decorator import buffered
                out = buffered(out, size=buffer_size)
            return out

        return factory

    return deco
