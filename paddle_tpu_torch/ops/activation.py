"""Activation operators: the port of the JAX package's
``ops/activation.py``, all 36 ops with their attributes and defaults
(the reference's activation_op.cc, softmax_op.cc, maxout_op.cc and the
legacy ActivationFunction registry).

The JAX ops are plain ``jnp`` expressions, and so are these: plain
PyTorch, each the JAX expression written with the same primitives, so
nonfinite inputs give the JAX values. Where autograd's derivative of
that expression differs from ``jax.grad``'s on NaN or ±inf inputs, the
op carries JAX's derivative in a ``torch.autograd.Function``:

- ``relu``: ``jax.nn.relu``'s custom JVP, ``where(x > 0, g, 0)`` (0 at a
  NaN input; autograd's ``threshold_backward`` passes g through);
- ``abs``: ``where(x >= 0, g, -g)`` (JAX's select; ``sign(x)`` is NaN at
  NaN and 0 at 0);
- ``rsqrt``: ``g * -0.5 * (y / x)`` (autograd's ``y ** 3`` flips the sign
  of the infinity at -0);
- ``pow``: ``factor * x ** (factor - 1)`` at every factor (autograd's
  ``pow`` gives zeros at factor 0, JAX NaN where ``x ** -1`` is not
  finite);
- ``softplus`` / ``logsigmoid``: ``jnp.logaddexp``'s custom JVP,
  ``g * exp(x - y)`` with +inf read as 0 on both sides;
- the clips (``brelu``, ``relu6``, ``soft_relu``, ``hard_sigmoid``):
  ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, whose JVPs multiply g
  by 1, 0.5 at a tie, or 0 (autograd's ``clamp`` passes g at the bounds).
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.framework.registry import register_op

__all__ = ["ACTIVATION_OPS", "softmax", "log_softmax", "maxout", "prelu"]


def _tie_mask(x, ref, other):
    """``lax.max`` / ``lax.min``'s JVP factor for the operand ``x`` of a
    result ``ref`` against the other operand: 1 where x made the result
    alone, 0.5 at a tie, 0 elsewhere (NaN included)."""
    won = (x == ref).to(x.dtype)
    return won * torch.where(other == ref, 0.5, 1.0).to(x.dtype)


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        m = torch.maximum(x, torch.full_like(x, lo))
        y = torch.minimum(m, torch.full_like(x, hi))
        ctx.save_for_backward(x, m, y)
        ctx.lo, ctx.hi = lo, hi
        return y

    @staticmethod
    def backward(ctx, g):
        x, m, y = ctx.saved_tensors
        mask = _tie_mask(x, m, torch.full_like(x, ctx.lo)) * _tie_mask(
            m, y, torch.full_like(x, ctx.hi))
        return g * mask, None, None


def _clip(x, lo, hi):
    return _Clip.apply(x, float(lo), float(hi))


class _Relu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, g, torch.zeros_like(g))


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.rsqrt(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (-0.5 * (y / x))


class _Pow(torch.autograd.Function):
    """``x ** factor`` with ``lax.pow``'s derivative ``factor * x **
    (factor - 1)``, unspecialised (at factor 0: NaN where ``x ** -1`` is
    infinite or NaN; autograd's ``pow`` gives zeros)."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.save_for_backward(x)
        ctx.factor = factor
        return torch.pow(x, factor)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (ctx.factor * torch.pow(x, ctx.factor - 1)), None


def _no_posinf(t):
    return torch.where(torch.isposinf(t), torch.zeros_like(t), t)


class _Softplus(torch.autograd.Function):
    """``jnp.logaddexp(x, 0)``: NaN (or an infinity of the same sign as
    0, none) passes as ``x + 0``; else ``max(x, 0) + log1p(exp(-|x|))``."""

    @staticmethod
    def forward(ctx, x):
        y = torch.where(torch.isnan(x), x,
                        torch.clamp_min(x, 0) + torch.log1p(
                            torch.exp(-torch.abs(x))))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(_no_posinf(x) - _no_posinf(y))


def _softplus(x):
    return _Softplus.apply(x)


def _sigmoid(x):
    return torch.sigmoid(x)


# name -> (fn(x, attrs), attribute defaults): the JAX file's
# ``_register_unary`` table, in its order
ACTIVATION_OPS = {
    "sigmoid": (lambda x, a: _sigmoid(x), {}),
    "logsigmoid": (lambda x, a: -_softplus(-x), {}),
    "exp": (lambda x, a: torch.exp(x), {}),
    "relu": (lambda x, a: _Relu.apply(x), {}),
    "tanh": (lambda x, a: torch.tanh(x), {}),
    "tanh_shrink": (lambda x, a: x - torch.tanh(x), {}),
    "sqrt": (lambda x, a: torch.sqrt(x), {}),
    "rsqrt": (lambda x, a: _Rsqrt.apply(x), {}),
    "abs": (lambda x, a: _Abs.apply(x), {}),
    "ceil": (lambda x, a: torch.ceil(x), {}),
    "floor": (lambda x, a: torch.floor(x), {}),
    "round": (lambda x, a: torch.round(x), {}),
    "reciprocal": (lambda x, a: 1.0 / x, {}),
    "log": (lambda x, a: torch.log(x), {}),
    "square": (lambda x, a: torch.square(x), {}),
    "softsign": (lambda x, a: x / (_Abs.apply(x) + 1), {}),
    "sin": (lambda x, a: torch.sin(x), {}),
    "cos": (lambda x, a: torch.cos(x), {}),
    # jax.nn.gelu's default, the tanh approximation
    "gelu": (lambda x, a: x * (0.5 * (1.0 + torch.tanh(
        math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))), {}),
    "silu": (lambda x, a: x * _sigmoid(x), {}),
    "brelu": (lambda x, a: _clip(x, a["t_min"], a["t_max"]),
              {"t_min": 0.0, "t_max": 24.0}),
    "leaky_relu": (lambda x, a: torch.where(x >= 0, x, a["alpha"] * x),
                   {"alpha": 0.02}),
    "soft_relu": (lambda x, a: torch.log1p(torch.exp(
        _clip(x, -a["threshold"], a["threshold"]))), {"threshold": 40.0}),
    "softplus": (lambda x, a: _softplus(x), {}),
    "elu": (lambda x, a: torch.where(x >= 0, x,
                                     a["alpha"] * (torch.exp(x) - 1)),
            {"alpha": 1.0}),
    "relu6": (lambda x, a: _clip(x, 0.0, a["threshold"]),
              {"threshold": 6.0}),
    "pow": (lambda x, a: _Pow.apply(x, float(a["factor"])),
            {"factor": 1.0}),
    "stanh": (lambda x, a: a["scale_b"] * torch.tanh(a["scale_a"] * x),
              {"scale_a": 2.0 / 3.0, "scale_b": 1.7159}),
    "hard_shrink": (lambda x, a: torch.where(
        _Abs.apply(x) > a["threshold"], x, torch.zeros_like(x)),
        {"threshold": 0.5}),
    "thresholded_relu": (lambda x, a: torch.where(
        x > a["threshold"], x, torch.zeros_like(x)), {"threshold": 1.0}),
    "hard_sigmoid": (lambda x, a: _clip(a["slope"] * x + a["offset"],
                                        0.0, 1.0),
                     {"slope": 0.2, "offset": 0.5}),
    "swish": (lambda x, a: x * _sigmoid(a["beta"] * x), {"beta": 1.0}),
}


def _register_unary(name, fn, attrs):
    @register_op(name, inputs=["X"], outputs=["Out"], attrs=attrs)
    def _act(ins, attrs, ctx, _fn=fn):
        return {"Out": _fn(ins["X"][0], attrs)}
    return _act


for _name, (_fn, _attrs) in ACTIVATION_OPS.items():
    _register_unary(_name, _fn, _attrs)


@register_op("softmax", inputs=["X"], outputs=["Out"], attrs={"axis": -1})
def softmax(ins, attrs, ctx):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs["axis"])}


@register_op("log_softmax", inputs=["X"], outputs=["Out"], attrs={"axis": -1})
def log_softmax(ins, attrs, ctx):
    """``jax.nn.log_softmax``: the max shifted out as a constant, then
    ``shifted - log(sum(exp(shifted)))`` (a row holding +inf is NaN)."""
    x, axis = ins["X"][0], attrs["axis"]
    shifted = x - torch.amax(x, dim=axis, keepdim=True).detach()
    return {"Out": shifted - torch.log(
        torch.sum(torch.exp(shifted), dim=axis, keepdim=True))}


@register_op("maxout", inputs=["X"], outputs=["Out"], attrs={"groups": 2})
def maxout(ins, attrs, ctx):
    """NCHW channels split into ``groups``-wide groups, the max over each
    (a tie shares the gradient, as ``jnp.max``'s)."""
    x = ins["X"][0]
    n, c, h, w = x.shape
    g = attrs["groups"]
    return {"Out": torch.amax(x.reshape(n, c // g, g, h, w), dim=2)}


@register_op("prelu", inputs=["X", "Alpha"], outputs=["Out"])
def prelu(ins, attrs, ctx):
    """``Alpha``: one value, or one per channel (axis 1)."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if alpha.numel() > 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": torch.where(x >= 0, x, alpha * x)}
