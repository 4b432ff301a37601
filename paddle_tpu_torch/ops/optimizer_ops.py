"""Optimizer-update operators: the port of the JAX package's
``ops/optimizer_ops.py`` ``sgd``, ``momentum`` and ``adam`` (the
reference's sgd_op.cc, momentum_op.cc and adam_op.cc).

An update is a pure function (Param, state) -> (Param', state'): each
output is a new tensor, nothing is written in place, so the forward
segment of a step never sees the values its own update makes. The
Executor runs these ops after the ``backward`` pseudo-op, outside
autograd. The rest of the family (adagrad, adamax, ...) is
ROADMAP A3.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.registry import register_op

__all__ = ["sgd", "momentum", "adam"]


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
