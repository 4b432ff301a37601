"""Weight-decay regularizers: the port of the JAX package's
``regularizer.py`` (fluid/regularizer.py; the legacy
OptimizerWithRegularizer.h). A regularizer set on a parameter
(``ParamAttr(regularizer=...)`` or ``Parameter.regularizer``) appends its
decay ops onto the parameter's gradient before the optimizer's update:
L2 ``scale`` + ``sum``, L1 ``sign`` + ``scale`` + ``sum``.

``Optimizer(regularization=...)`` is accepted and ignored, as in the JAX
package, whose ``minimize`` decays only through each parameter's own
regularizer (ROADMAP C5).
"""
from __future__ import annotations

__all__ = ["WeightDecayRegularizer", "L1DecayRegularizer",
           "L2DecayRegularizer", "L1Decay", "L2Decay",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """``grad += coeff * param``."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": param}, outputs={"Out": decay},
                        attrs={"scale": self.coeff})
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": grad})
        return grad


class L1DecayRegularizer(WeightDecayRegularizer):
    """``grad += coeff * sign(param)``."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        sgn = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("sign", inputs={"X": param}, outputs={"Out": sgn})
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": sgn}, outputs={"Out": decay},
                        attrs={"scale": self.coeff})
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": grad})
        return grad


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
