"""Parameter initializers, realized as init ops in the startup program:
the port of the JAX package's ``initializer.py`` (fluid/initializer.py:
Constant / Uniform / Normal / Xavier / MSRA appended as fill and random
ops).

Each appends the same op with the same attributes as the JAX package,
so both packages' startup programs are one op list. The values differ
(a torch generator is not a JAX PRNG stream): parity tests run the JAX
startup program and carry its values over (``convert.scope_from_jax``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.framework.program import (Parameter,
                                                default_startup_program)

__all__ = ["Initializer", "ConstantInitializer", "UniformInitializer",
           "NormalInitializer", "XavierInitializer", "MSRAInitializer",
           "NumpyArrayInitializer", "Constant", "Uniform", "Normal",
           "Xavier", "MSRA"]


def _startup_var(param: Parameter):
    sp = default_startup_program()
    gb = sp.global_block()
    if param.name not in gb.vars:
        gb.create_var(name=param.name, shape=param.shape, dtype=param.dtype,
                      persistable=True)
    return gb


class Initializer:
    def __call__(self, param: Parameter, block=None):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(shape):
        if len(shape) == 2:
            fan_in, fan_out = shape[0], shape[1]
        elif len(shape) > 2:
            rs = int(np.prod(shape[2:]))
            fan_in, fan_out = shape[1] * rs, shape[0] * rs
        else:
            fan_in = fan_out = int(np.prod(shape))
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, param, block=None):
        gb = _startup_var(param)
        gb.append_op("fill_constant", outputs={"Out": param.name},
                     attrs={"shape": list(param.shape), "dtype": "float32",
                            "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, param, block=None):
        gb = _startup_var(param)
        gb.append_op("uniform_random", outputs={"Out": param.name},
                     attrs={"shape": list(param.shape), "min": float(self.low),
                            "max": float(self.high), "seed": self.seed,
                            "dtype": "float32"})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block=None):
        gb = _startup_var(param)
        gb.append_op("gaussian_random", outputs={"Out": param.name},
                     attrs={"shape": list(param.shape), "mean": float(self.loc),
                            "std": float(self.scale), "seed": self.seed,
                            "dtype": "float32"})


class XavierInitializer(Initializer):
    """Glorot init (ref fluid/initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, param, block=None):
        fi, fo = self._fan_in_out(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(param, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / (fi + fo)), self.seed)(param, block)


class MSRAInitializer(Initializer):
    """He init (ref fluid/initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, param, block=None):
        fi, _ = self._fan_in_out(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(param, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fi), self.seed)(param, block)


class NumpyArrayInitializer(Initializer):
    """Initialize from a concrete array (used by save/load + tests): a
    CPU tensor written straight into the global scope; the Executor
    moves it to its device at its first run."""

    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, param, block=None):
        from paddle_tpu_torch.core.scope import global_scope

        _startup_var(param)
        # direct scope write; no op needed
        global_scope().set_tensor(param.name,
                                  torch.from_numpy(self.value.copy()))


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
