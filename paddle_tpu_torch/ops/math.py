"""Dense math operators the text nets, the book models and the MNIST MLP
emit: the port of the JAX package's ``ops/math.py`` ``mul`` and
``matmul`` (``amp_compute``), the elementwise ops (``elementwise_add``,
fc's bias; ``_sub``, ``_mul``, ``_div``), ``scale``, ``sum`` (fc over
several inputs), ``mean``, ``concat`` and ``split``, ``lookup_table``
(the embedding) and ``top_k`` (the accuracy metric's first half), and
the startup program's initializer ops ``fill_constant``,
``uniform_random`` and ``gaussian_random``; the reference's mul_op.cc,
matmul_op.cc, elementwise_*_op.cc, scale_op.cc, sum_op.cc, mean_op.cc,
concat_op.cc, split_op.cc, lookup_table_op.cc, top_k_op.cc,
fill_constant_op.cc, uniform_random_op.cc and gaussian_random_op.cc.

The random ops draw from the ``torch.Generator`` the Executor hands
them (seeded from its seed, the step and the op's index), or from one
seeded with the op's own nonzero ``seed`` attribute, on the Executor's
device. A JAX PRNG stream is not a torch one: the same seed gives other
numbers than the JAX package, from the same distribution.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.framework.registry import register_op

__all__ = ["mul", "matmul", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "scale", "sum_op", "mean",
           "concat", "split", "lookup_table", "top_k", "fill_constant",
           "uniform_random", "gaussian_random"]

_LOW = (torch.bfloat16, torch.float16)


def _flatten2d(x, num_col_dims):
    lead = int(np.prod(x.shape[:num_col_dims])) if num_col_dims > 0 else 1
    return x.reshape(lead, -1)


def _accum_matmul(x, y):
    """Matmul with fp32 accumulation for bf16/f16 operands (AMP), rounded
    back to the operands' promoted dtype once at the end (the JAX
    ``preferred_element_type=float32``): the products of bf16 operands
    are exact in fp32, so the fp32 product of the operands as stored is
    that function."""
    if x.dtype in _LOW or y.dtype in _LOW:
        out = torch.matmul(x.float(), y.float())
        return out.to(torch.promote_types(x.dtype, y.dtype))
    return torch.matmul(x, y)


@register_op("mul", inputs=["X", "Y"], outputs=["Out"],
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1},
             amp_compute=True)
def mul(ins, attrs, ctx):
    """fluid mul: flatten-then-matmul."""
    x, y = ins["X"][0], ins["Y"][0]
    xn, yn = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    y2 = y.reshape(int(np.prod(y.shape[:yn])), -1)
    out = _accum_matmul(_flatten2d(x, xn), y2)
    return {"Out": out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))}


def _broadcast_y(x, y, axis):
    """fluid elementwise broadcast: y's dims align to x at ``axis``."""
    if x.shape == y.shape or y.dim() == 0:
        return y
    ax = axis if axis >= 0 else x.dim() - y.dim()
    return y.reshape((1,) * ax + tuple(y.shape)
                     + (1,) * (x.dim() - ax - y.dim()))


@register_op("matmul", inputs=["X", "Y"], outputs=["Out"],
             attrs={"transpose_X": False, "transpose_Y": False, "alpha": 1.0},
             amp_compute=True)
def matmul(ins, attrs, ctx):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs["transpose_X"] and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs["transpose_Y"] and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = _accum_matmul(x, y)
    if attrs["alpha"] != 1.0:
        out = out * attrs["alpha"]
    return {"Out": out}


def _register_elementwise(name, fn):
    @register_op(name, inputs=["X", "Y"], outputs=["Out"], attrs={"axis": -1})
    def _ew(ins, attrs, ctx, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": _fn(x, _broadcast_y(x, y, attrs["axis"]))}
    _ew.__name__ = name
    return _ew


elementwise_add = _register_elementwise("elementwise_add", torch.add)
elementwise_sub = _register_elementwise("elementwise_sub", torch.sub)
elementwise_mul = _register_elementwise("elementwise_mul", torch.mul)
elementwise_div = _register_elementwise("elementwise_div", torch.div)


@register_op("scale", inputs=["X"], outputs=["Out"],
             attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True})
def scale(ins, attrs, ctx):
    x = ins["X"][0]
    s, b = attrs["scale"], attrs["bias"]
    out = x * s + b if attrs["bias_after_scale"] else (x + b) * s
    return {"Out": out.to(x.dtype)}


@register_op("sum", inputs=["X"], outputs=["Out"])
def sum_op(ins, attrs, ctx):
    """add_n over duplicable X (ref operators/sum_op.cc)."""
    return {"Out": functools.reduce(torch.add, ins["X"])}


@register_op("mean", inputs=["X"], outputs=["Out"])
def mean(ins, attrs, ctx):
    return {"Out": torch.mean(ins["X"][0])}


@register_op("concat", inputs=["X"], outputs=["Out"], attrs={"axis": 0})
def concat(ins, attrs, ctx):
    return {"Out": torch.cat(ins["X"], dim=attrs["axis"])}


@register_op("split", inputs=["X"], outputs=["Out"],
             attrs={"num": 0, "sections": None, "axis": 0})
def split(ins, attrs, ctx):
    x = ins["X"][0]
    axis = attrs["axis"]
    if attrs["sections"]:
        return {"Out": list(torch.split(x, list(attrs["sections"]),
                                        dim=axis))}
    n = attrs["num"]
    if x.shape[axis] % n:
        raise ValueError(f"split: axis {axis} of size {x.shape[axis]} does "
                         f"not divide into {n} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // n, dim=axis))}


@register_op("lookup_table", inputs=["W", "Ids"], outputs=["Out"],
             attrs={"padding_idx": None, "is_sparse": False})
def lookup_table(ins, attrs, ctx):
    """Embedding gather; its gradient is autograd's scatter-add (the
    dense analog of the reference's SelectedRows)."""
    w, ids = ins["W"][0], ins["Ids"][0]
    flat = ids.reshape(-1).to(torch.int64)
    out = w[flat]
    if attrs["padding_idx"] is not None:
        out = out * (flat != attrs["padding_idx"])[:, None].to(out.dtype)
    lead = tuple(ids.shape[:-1] if ids.shape[-1] == 1 else ids.shape)
    ctx.set_lod("Out", ctx.lod("Ids"))
    return {"Out": out.reshape(lead + (w.shape[-1],))}


@register_op("top_k", inputs=["X"], outputs=["Out", "Indices"],
             attrs={"k": 1})
def top_k(ins, attrs, ctx):
    vals, idx = torch.topk(ins["X"][0], attrs["k"], dim=-1)
    return {"Out": vals, "Indices": idx.to(torch.int32)}


@register_op("fill_constant", inputs=[], outputs=["Out"],
             attrs={"shape": None, "dtype": "float32", "value": 0.0})
def fill_constant(ins, attrs, ctx):
    return {"Out": torch.full(tuple(attrs["shape"]), attrs["value"],
                              dtype=convert_dtype(attrs["dtype"]),
                              device=ctx.device)}


def _generator(ctx, seed):
    """The Executor's generator, or (a nonzero ``seed`` attribute) one of
    the op's own on the same device."""
    if seed == 0:
        return ctx.rng
    gen = torch.Generator(device=ctx.rng.device)
    gen.manual_seed(int(seed))
    return gen


@register_op("uniform_random", inputs=[], outputs=["Out"], needs_rng=True,
             attrs={"shape": None, "min": -1.0, "max": 1.0, "dtype": "float32",
                    "seed": 0})
def uniform_random(ins, attrs, ctx):
    gen = _generator(ctx, attrs["seed"])
    u = torch.rand(tuple(attrs["shape"]), generator=gen, device=gen.device,
                   dtype=convert_dtype(attrs["dtype"]))
    return {"Out": attrs["min"] + (attrs["max"] - attrs["min"]) * u}


@register_op("gaussian_random", inputs=[], outputs=["Out"], needs_rng=True,
             attrs={"shape": None, "mean": 0.0, "std": 1.0, "dtype": "float32",
                    "seed": 0})
def gaussian_random(ins, attrs, ctx):
    gen = _generator(ctx, attrs["seed"])
    z = torch.randn(tuple(attrs["shape"]), generator=gen, device=gen.device,
                    dtype=convert_dtype(attrs["dtype"]))
    return {"Out": attrs["mean"] + attrs["std"] * z}
