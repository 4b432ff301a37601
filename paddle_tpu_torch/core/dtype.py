"""Data type registry: the port of the JAX package's ``core/dtype.py``
(the reference's ``VarType.Type`` enum, framework.proto:97-113).

A dtype is a ``torch.dtype``; strings take the canonical names and the
reference's spellings (``fp32``, ``bf16`` ...), and numpy dtypes map
by name. ``bfloat16`` is a first-class training dtype (AMP computes in
it over fp32 masters).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name", "is_float", "is_integer",
           "FLOAT_DTYPES", "INT_DTYPES"]

# Canonical name -> torch dtype.
_DTYPE_MAP = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    # reference spellings (framework.proto enum names, lowercased)
    "fp16": torch.float16,
    "fp32": torch.float32,
    "fp64": torch.float64,
    "bf16": torch.bfloat16,
}
_NAMES = {v: k for k, v in reversed(list(_DTYPE_MAP.items()))}

FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")
INT_DTYPES = ("int8", "uint8", "int16", "int32", "int64")


def convert_dtype(dtype) -> torch.dtype:
    """Normalise a user-provided dtype (string / numpy / torch) to a
    torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_MAP:
            return _DTYPE_MAP[key]
        raise ValueError(f"unknown dtype {dtype!r}")
    name = np.dtype(dtype).name
    if name not in _DTYPE_MAP:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPE_MAP[name]


def dtype_name(dtype) -> str:
    """Canonical string name for a dtype (``"float32"``, ``"int64"``,
    ``"bfloat16"`` ...): numpy's name, which the JAX package's programs
    print too."""
    return _NAMES[convert_dtype(dtype)]


def is_float(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    dt = convert_dtype(dtype)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)
