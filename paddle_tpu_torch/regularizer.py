"""Weight-decay regularizers: the port of the JAX package's
``regularizer.py`` (fluid/regularizer.py; OptimizerWithRegularizer.h).

The classes are here so that ``ParamAttr(regularizer=...)`` and
``Optimizer(regularization=...)`` name them as in the JAX package; the
decay ops they append (``scale``, ``sign``) are ROADMAP A3's, so
appending one raises, naming it.
"""
from __future__ import annotations

__all__ = ["WeightDecayRegularizer", "L1DecayRegularizer",
           "L2DecayRegularizer", "L1Decay", "L2Decay",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError(
            f"{type(self).__name__} appends scale/sign ops, which the port "
            "has not yet (ROADMAP A3)")


class L2DecayRegularizer(WeightDecayRegularizer):
    """coeff * param added to the gradient (not ported yet: A3)."""


class L1DecayRegularizer(WeightDecayRegularizer):
    """coeff * sign(param) added to the gradient (not ported yet: A3)."""


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, block):
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            g = reg.append_regularization_op(p, g, block)
        out.append((p, g))
    return out
