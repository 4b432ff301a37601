"""Optimizer-update operators: the port of the JAX package's
``ops/optimizer_ops.py``, whole: the updates ``sgd``, ``momentum``,
``adam``, ``adamax``, ``adagrad``, ``decayed_adagrad``, ``adadelta``,
``rmsprop``, ``ftrl``, ``proximal_gd`` and ``proximal_adagrad`` (the
reference's sgd_op.cc ... proximal_adagrad_op.cc), the learning-rate
schedule ``lr_schedule`` (LearningRateScheduler.cpp's strategies), the
shadow average ``ema_update`` (AverageOptimizer.h) and the static
pruning pair ``magnitude_prune_mask`` / ``apply_mask``
(ParameterUpdaterHook.cpp).

An update is a pure function (Param, state) -> (Param', state'): each
output is a new tensor, nothing is written in place, so the forward
segment of a step never sees the values its own update makes. The
Executor runs these ops after the ``backward`` pseudo-op, outside
autograd. Scalars from attributes enter as Python numbers, so no op
copies anything from the host to the card in a step; the one table
(``piecewise_decay``'s boundaries and values) is put on a device once
and kept (``_piecewise_tables``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch.framework.registry import register_op

__all__ = ["sgd", "momentum", "adam", "adamax", "adagrad",
           "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "proximal_gd",
           "proximal_adagrad", "lr_schedule", "ema_update",
           "magnitude_prune_mask", "apply_mask"]


@register_op("sgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"])
def sgd(ins, attrs, ctx):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    return {"ParamOut": p - lr.reshape(()).to(p.dtype) * g}


@register_op("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"],
             attrs={"mu": 0.9, "use_nesterov": False})
def momentum(ins, attrs, ctx):
    """``v' = mu v + g``; ``p' = p - lr v'``, or with Nesterov
    ``p' = p - lr (g + mu v')``."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0].reshape(())
    mu = attrs["mu"]
    v_out = mu * v + g
    if attrs["use_nesterov"]:
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam",
             inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"],
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
def adam(ins, attrs, ctx):
    """``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, the powers kept as
    [1] accumulators multiplied once a step, eps outside the root."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * g * g
    b1po, b2po = b1p * b1, b2p * b2
    lr_t = lr * torch.sqrt(1 - b2po.reshape(())) / (1 - b1po.reshape(()))
    po = p - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return {"ParamOut": po, "Moment1Out": m1o, "Moment2Out": m2o,
            "Beta1PowOut": b1po, "Beta2PowOut": b2po}


@register_op("adamax",
             inputs=["Param", "Grad", "LearningRate", "Moment", "InfNorm",
                     "Beta1Pow"],
             outputs=["ParamOut", "MomentOut", "InfNormOut"],
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
def adamax(ins, attrs, ctx):
    """``m' = b1 m + (1 - b1) g``; ``u' = max(b2 u, |g|)``;
    ``p' = p - lr / (1 - b1^t) * m' / (u' + eps)``. Beta1Pow is not
    advanced here (the JAX op's contract)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    m, u, b1p = ins["Moment"][0], ins["InfNorm"][0], ins["Beta1Pow"][0]
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    mo = b1 * m + (1 - b1) * g
    uo = torch.maximum(b2 * u, torch.abs(g))
    po = p - (lr / (1 - b1p.reshape(()))) * (mo / (uo + eps))
    return {"ParamOut": po, "MomentOut": mo, "InfNormOut": uo}


@register_op("adagrad", inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"], attrs={"epsilon": 1e-6})
def adagrad(ins, attrs, ctx):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    mo = ins["Moment"][0] + g * g
    po = p - lr * g / (torch.sqrt(mo) + attrs["epsilon"])
    return {"ParamOut": po, "MomentOut": mo}


@register_op("decayed_adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"],
             attrs={"decay": 0.95, "epsilon": 1e-6})
def decayed_adagrad(ins, attrs, ctx):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    d = attrs["decay"]
    mo = d * ins["Moment"][0] + (1 - d) * g * g
    po = p - lr * g / (torch.sqrt(mo) + attrs["epsilon"])
    return {"ParamOut": po, "MomentOut": mo}


@register_op("adadelta", inputs=["Param", "Grad", "AvgSquaredGrad",
                                 "AvgSquaredUpdate"],
             outputs=["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
             attrs={"rho": 0.95, "epsilon": 1e-6})
def adadelta(ins, attrs, ctx):
    """No learning rate (the reference's adadelta_op.cc)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    asg, asu = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho, eps = attrs["rho"], attrs["epsilon"]
    asg_o = rho * asg + (1 - rho) * g * g
    update = -torch.sqrt((asu + eps) / (asg_o + eps)) * g
    asu_o = rho * asu + (1 - rho) * update * update
    return {"ParamOut": p + update, "AvgSquaredGradOut": asg_o,
            "AvgSquaredUpdateOut": asu_o}


@register_op("rmsprop", inputs=["Param", "Grad", "MeanSquare", "Moment",
                                "LearningRate"],
             outputs=["ParamOut", "MeanSquareOut", "MomentOut"],
             attrs={"decay": 0.9, "momentum": 0.0, "epsilon": 1e-10})
def rmsprop(ins, attrs, ctx):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    d, mu, eps = attrs["decay"], attrs["momentum"], attrs["epsilon"]
    ms_o = d * ms + (1 - d) * g * g
    mom_o = mu * mom + lr * g / torch.sqrt(ms_o + eps)
    return {"ParamOut": p - mom_o, "MeanSquareOut": ms_o, "MomentOut": mom_o}


def _pow(x, e):
    """``x ** e`` (either may be a tensor) rounded once to float32 from
    float64, as XLA's CPU code computes a float32 power: torch's float32
    ``pow`` can land an ulp away, which Ftrl's ``(n'^k - n^k) / lr``
    magnifies."""
    x = x.double() if torch.is_tensor(x) else x
    e = e.double() if torch.is_tensor(e) else e
    return torch.pow(x, e).float()


@register_op("ftrl", inputs=["Param", "SquaredAccumulator",
                             "LinearAccumulator", "Grad", "LearningRate"],
             outputs=["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
             attrs={"l1": 0.0, "l2": 0.0, "lr_power": -0.5})
def ftrl(ins, attrs, ctx):
    """FTRL-proximal (the reference's ftrl_op.cc): a weight whose linear
    accumulator lies within ``l1`` of 0 is set to 0."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1, l2, lrp = attrs["l1"], attrs["l2"], attrs["lr_power"]
    new_sq = sq + g * g
    sigma = (_pow(new_sq, -lrp) - _pow(sq, -lrp)) / lr
    new_lin = lin + g - sigma * p
    x = l1 * torch.sign(new_lin) - new_lin
    y = _pow(new_sq, -lrp) / lr + 2 * l2
    po = torch.where(torch.abs(new_lin) > l1, x / y, torch.zeros_like(p))
    return {"ParamOut": po, "SquaredAccumOut": new_sq,
            "LinearAccumOut": new_lin}


def _shrink(prox, lr, l1, l2):
    """The proximal l1 / l2 step: ``sign(x) max(|x| - lr l1, 0) / (1 +
    lr l2)``."""
    return (torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1, 0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], attrs={"l1": 0.0, "l2": 0.0})
def proximal_gd(ins, attrs, ctx):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    return {"ParamOut": _shrink(p - lr * g, lr, attrs["l1"], attrs["l2"])}


@register_op("proximal_adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"],
             attrs={"l1": 0.0, "l2": 0.0})
def proximal_adagrad(ins, attrs, ctx):
    """Adagrad's moment, then the proximal shrink. The reference divides
    by ``sqrt(m')`` bare; the JAX op's 1e-12 guard changes only 0 / 0 (a
    zero gradient on a zero moment), which would make the weight NaN."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(()).to(p.dtype)
    m_out = ins["Moment"][0] + g * g
    prox = p - lr * g / (torch.sqrt(m_out) + 1e-12)
    return {"ParamOut": _shrink(prox, lr, attrs["l1"], attrs["l2"]),
            "MomentOut": m_out}


@functools.lru_cache(maxsize=64)
def _piecewise_tables(bounds, values, device):
    """``piecewise_decay``'s boundaries and values as float32 tensors on
    ``device``, made once for each (table, device): a step then copies
    nothing from the host (a pageable copy would wait for the card)."""
    return (torch.tensor(bounds, dtype=torch.float32, device=device),
            torch.tensor(values, dtype=torch.float32, device=device))


def _f32(x: float) -> float:
    """``x`` rounded to float32 (a constant as XLA holds it)."""
    return float(np.float32(x))


def _fma(a, b: float, c: float):
    """``a * b + c`` with one rounding to float32, as XLA's CPU code
    fuses a product and a sum (the float64 product of two float32
    values is exact)."""
    return (a.double() * _f32(b) + _f32(c)).float()


@register_op("lr_schedule", inputs=["Step"], outputs=["Out"],
             attrs={"strategy": "exponential_decay", "base_lr": 0.1,
                    "decay_steps": 1000.0, "decay_rate": 0.9,
                    "staircase": False, "end_lr": 0.0, "power": 1.0,
                    "cycle": False, "boundaries": [], "values": []})
def lr_schedule(ins, attrs, ctx):
    """lr = f(global step) in float32 on the step's device, one op for
    every strategy of the reference's scheduler registry
    (LearningRateScheduler.cpp: poly, exp, discrete, linear, manual).

    Each formula is the JAX op's as the JAX Executor's compiled step
    evaluates it, so that the port's lr is the JAX package's to the
    ulp: XLA folds constants (a division by ``decay_steps`` becomes a
    product with its float32 reciprocal ``r``, two constant factors
    one), rounds ``x ** power`` once (``_pow``; a constant raised to the
    step takes torch's float32 ``pow``, which agrees with XLA's) and
    fuses a product and a sum into one rounding (``_fma``). The
    formulas in exact arithmetic: exponential ``base * rate ** (step /
    decay_steps)``, natural_exp ``base * exp(-rate * step /
    decay_steps)``, inverse_time ``base /
    (1 + rate * step / decay_steps)`` (``staircase``: the ratio
    floored), polynomial ``(base - end) * (1 - step / decay_steps) **
    power + end`` (step clamped to ``decay_steps``, or with ``cycle``
    the horizon stretched to the next multiple), piecewise
    ``values[#boundaries <= step]``, linear ``max(end, base - rate *
    step)``."""
    step = ins["Step"][0].reshape(()).to(torch.float32)
    s = attrs["strategy"]
    base, rate = attrs["base_lr"], attrs["decay_rate"]
    r = _f32(1.0 / attrs["decay_steps"])
    if s in ("exponential_decay", "natural_exp_decay",
             "inverse_time_decay"):
        ratio = torch.floor(step * r) if attrs["staircase"] else None
        if s == "exponential_decay":
            lr = base * torch.pow(rate, step * r if ratio is None
                                  else ratio)
        elif s == "natural_exp_decay":
            lr = torch.exp(step * _f32(_f32(-rate) * r) if ratio is None
                           else ratio * -rate) * base
        elif ratio is None:
            lr = base / _fma(step, _f32(rate) * r, 1.0)
        else:
            lr = base / _fma(ratio, rate, 1.0)
    elif s == "polynomial_decay":
        steps = attrs["decay_steps"]
        if attrs["cycle"]:
            horizon = torch.clamp_min(torch.ceil(step * r), 1.0) * steps
            rest = 1.0 - step / horizon
        else:
            rest = _fma(torch.clamp_max(step, steps), -r, 1.0)
        lr = _fma(_pow(rest, attrs["power"]), base - attrs["end_lr"],
                  attrs["end_lr"])
    elif s == "piecewise_decay":
        bounds, values = _piecewise_tables(
            tuple(attrs["boundaries"]), tuple(attrs["values"]), step.device)
        lr = values[torch.searchsorted(bounds, step.reshape(1), right=True)]
    elif s == "linear_decay":
        lr = torch.clamp_min(_fma(step, -rate, base), attrs["end_lr"])
    else:
        raise ValueError(f"unknown lr schedule strategy {s!r}")
    return {"Out": lr.reshape(1).to(torch.float32)}


@register_op("ema_update", inputs=["Param", "Avg"], outputs=["AvgOut"],
             attrs={"decay": 0.999})
def ema_update(ins, attrs, ctx):
    """The shadow average's step, ``d avg + (1 - d) p`` (AverageOptimizer's
    windowed mean as an exponential moving average, as in the JAX op)."""
    d = attrs["decay"]
    return {"AvgOut": d * ins["Avg"][0] + (1.0 - d) * ins["Param"][0]}


@register_op("magnitude_prune_mask", inputs=["Param"], outputs=["Mask"],
             attrs={"sparsity_ratio": 0.6})
def magnitude_prune_mask(ins, attrs, ctx):
    """Static pruning's mask: 0 on the smallest ``sparsity_ratio`` of |w|
    (ParameterUpdaterHook.cpp StaticPruningHook). The threshold is the
    first kept magnitude, so ties with it survive."""
    p = ins["Param"][0]
    flat = torch.abs(p).reshape(-1)
    k = int(round(float(attrs["sparsity_ratio"]) * flat.shape[0]))
    if k <= 0:
        return {"Mask": torch.ones_like(p)}
    if k >= flat.shape[0]:
        return {"Mask": torch.zeros_like(p)}
    thr = torch.sort(flat).values[k]
    return {"Mask": (torch.abs(p) >= thr).to(p.dtype)}


@register_op("apply_mask", inputs=["Param", "Mask"], outputs=["ParamOut"])
def apply_mask(ins, attrs, ctx):
    return {"ParamOut": ins["Param"][0] * ins["Mask"][0]}
