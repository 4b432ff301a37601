"""Dense math operators the text nets, the book models and the MNIST MLP
emit: the port of the JAX package's ``ops/math.py`` ``mul`` and
``matmul`` (``amp_compute``), the elementwise ops (``elementwise_add``,
fc's bias; ``_sub``, ``_mul``, ``_div``, ``_max``), ``scale``, ``sum``
(fc over several inputs), ``mean``, ``concat``, ``split`` and ``stack``,
``reshape`` and ``transpose`` (the space-to-depth stem of
``models/image.py``), ``cast`` and ``isfinite`` (the health monitor's
ops, ``obs/health.py``), ``tensor_stats`` (the numerics observatory's
per-tensor summary, ``obs/numerics.py``),
``lookup_table`` (the embedding) and ``top_k`` (the accuracy metric's
first half), the training plane's helpers ``sign`` (L1 decay),
``assign`` (ModelAverage's shadow) and ``increment`` (a learning-rate
schedule's global step), and the startup program's initializer ops
``fill_constant``, ``uniform_random`` and ``gaussian_random``; the
reference's mul_op.cc, matmul_op.cc, elementwise_*_op.cc, scale_op.cc,
sum_op.cc, mean_op.cc, concat_op.cc, split_op.cc, stack_op.cc,
cast_op.cc, isfinite_op.cc, reshape_op.cc,
transpose_op.cc, lookup_table_op.cc, top_k_op.cc, sign_op.cc,
assign_op.cc, increment_op.cc, fill_constant_op.cc,
uniform_random_op.cc and gaussian_random_op.cc.

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
from paddle_tpu_torch.framework.dtype_limits import headroom_edges
from paddle_tpu_torch.framework.registry import register_op

__all__ = ["mul", "matmul", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_max", "scale",
           "sum_op", "mean", "cast", "concat", "split", "stack", "reshape",
           "transpose", "isfinite", "tensor_stats", "STAT_NAMES", "N_STATS",
           "lookup_table", "top_k", "sign", "assign", "increment",
           "fill_constant", "uniform_random", "gaussian_random"]

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
elementwise_max = _register_elementwise("elementwise_max", torch.maximum)


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


@register_op("cast", inputs=["X"], outputs=["Out"], attrs={"dtype": "float32"})
def cast(ins, attrs, ctx):
    return {"Out": ins["X"][0].to(convert_dtype(attrs["dtype"]))}


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


@register_op("stack", inputs=["X"], outputs=["Out"], attrs={"axis": 0})
def stack(ins, attrs, ctx):
    return {"Out": torch.stack(ins["X"], dim=attrs["axis"])}


@register_op("reshape", inputs=["X"], outputs=["Out"], attrs={"shape": None})
def reshape(ins, attrs, ctx):
    """fluid semantics: a 0 copies the input's dim, one -1 is inferred."""
    x = ins["X"][0]
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": x.reshape(shape)}


@register_op("transpose", inputs=["X"], outputs=["Out"], attrs={"axis": None})
def transpose(ins, attrs, ctx):
    return {"Out": ins["X"][0].permute(list(attrs["axis"]))}


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


def _total_order_key(x):
    """An integer key whose order is IEEE-754's total order of ``x``'s
    floats: -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN (a negative
    float's magnitude bits are flipped, so their order reverses)."""
    bits = x.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[x.element_size()])
    flip = torch.iinfo(bits.dtype).max
    return torch.where(bits < 0, bits ^ flip, bits)


@register_op("top_k", inputs=["X"], outputs=["Out", "Indices"],
             attrs={"k": 1})
def top_k(ins, attrs, ctx):
    """``jax.lax.top_k``'s values and indices: XLA's TopK on the CPU
    orders floats by IEEE total order, descending (+NaN first, then
    +inf, ..., +0 above -0, ..., -inf, -NaN last), ties to the lower
    index. A stable descending sort of the total-order key gives that
    order; ``torch.topk`` would rank every NaN alike and ±0 equal, and
    does not keep ties in index order."""
    x = ins["X"][0]
    key = _total_order_key(x) if x.is_floating_point() else x
    idx = torch.sort(key, dim=-1, descending=True,
                     stable=True).indices[..., :attrs["k"]]
    return {"Out": torch.gather(x, -1, idx), "Indices": idx.to(torch.int32)}


@register_op("sign", inputs=["X"], outputs=["Out"])
def sign(ins, attrs, ctx):
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0 there)."""
    x = ins["X"][0]
    return {"Out": torch.where(torch.isnan(x), x, torch.sign(x))}


@register_op("assign", inputs=["X"], outputs=["Out"])
def assign(ins, attrs, ctx):
    """A copy of X (a new tensor: nothing the Executor holds aliases
    another variable's storage)."""
    return {"Out": ins["X"][0].clone()}


@register_op("increment", inputs=["X"], outputs=["Out"], attrs={"step": 1.0})
def increment(ins, attrs, ctx):
    """``X + step``, step cast to X's dtype (an integer X stays one)."""
    x = ins["X"][0]
    step = attrs["step"] if x.is_floating_point() else int(attrs["step"])
    return {"Out": x + step}


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


@register_op("isfinite", inputs=["X"], outputs=["Out"])
def isfinite(ins, attrs, ctx):
    """Whole-tensor finiteness (ref operators/isfinite_op.cc): ``[1]``
    float32, 1.0 when every element is finite, so the flag can ride a
    float concat (the health monitor's fused ``[3]`` vector)."""
    x = ins["X"][0]
    return {"Out": torch.isfinite(x).all().to(torch.float32).reshape(1)}


# The lanes ``tensor_stats`` emits, in output order: one table for the
# pass that plants the op (analysis/instrument.py) and the monitor that
# reads the fetch (obs/numerics.py), the JAX package's layout.
STAT_NAMES = (
    "absmax",          # max |x| over finite elements
    "rms",             # sqrt(mean(x^2)) over finite elements
    "mean",            # mean over finite elements
    "nonfinite_count", # number of NaN/Inf elements
    "zero_frac",       # fraction of exact zeros
    "exp_hi_frac",     # finite fraction within headroom_bits of dtype max
    "exp_lo_frac",     # finite nonzero fraction within headroom_bits of tiny
    "count",           # total element count
)
N_STATS = len(STAT_NAMES)
_F32_TINY = 2.0 ** -126    # float32's smallest normal


@register_op("tensor_stats", inputs=["X"], outputs=["Out"],
             attrs={"headroom_bits": 8.0}, propagate_lod=False)
def tensor_stats(ins, attrs, ctx):
    """A ``[N_STATS]`` float32 summary of one tensor (``STAT_NAMES``),
    computed in float32 as the JAX op computes it: absmax / rms / mean
    over the finite elements (nonfinite ones are masked out, so the
    lanes stay comparable while ``nonfinite_count`` names the blowup),
    the zero fraction over all elements, and the finite fractions within
    ``headroom_bits`` powers of two of the tensor's own dtype's max
    (``exp_hi_frac``) or, nonzero, of its smallest normal
    (``exp_lo_frac``; ``framework/dtype_limits.headroom_edges``; integer
    tensors take float32's). Subnormal float32 values count as zeros, as
    XLA, which flushes them, counts them in the JAX op. An empty tensor
    gives all zeros."""
    x = ins["X"][0]
    hi, lo = headroom_edges(x.dtype, float(attrs["headroom_bits"]))
    f32 = torch.float32
    n = x.numel()
    if n == 0:
        return {"Out": torch.zeros((N_STATS,), dtype=f32, device=x.device)}
    zero = torch.zeros((), dtype=f32, device=x.device)
    xf = x.to(f32)
    xf = torch.where(xf.abs() < _F32_TINY, zero, xf)
    finite = torch.isfinite(xf)
    absx = torch.where(finite, xf, zero).abs()
    n_finite = finite.to(f32).sum()
    denom = torch.clamp_min(n_finite, 1.0)
    # scalars made on the device (a fill, no host-to-device copy)
    hi_edge = torch.full((), hi, dtype=f32, device=x.device)
    lo_edge = torch.full((), lo, dtype=f32, device=x.device)
    count = torch.full((), float(n), dtype=f32, device=x.device)
    out = torch.stack([
        absx.max(),
        torch.sqrt(torch.where(finite, xf * xf, zero).sum() / denom),
        torch.where(finite, xf, zero).sum() / denom,
        count - n_finite,
        (xf == 0.0).to(f32).mean(),
        (finite & (absx >= hi_edge)).to(f32).sum() / denom,
        (finite & (absx > 0.0) & (absx <= lo_edge)).to(f32).sum() / denom,
        count])
    return {"Out": out}
