"""Optimizers — build the update region of the program: the port of the
JAX package's ``optimizer.py`` ``Optimizer``, ``SGD``, ``Momentum``
and ``Adam`` (fluid/optimizer.py:13,190: accumulators and
``minimize``).

``minimize`` appends the ``backward`` pseudo-op, a learning-rate
variable filled once by the startup program, each optimizer's
accumulators (persistables filled by the startup program) and one
update op per parameter, with the names, slots and attributes of the
JAX package. The Executor runs the update ops after the backward
segment, outside autograd.

Not ported yet, each raising ``NotImplementedError`` naming ROADMAP A3:
``regularization=`` and per-parameter regularizers (their ``scale`` /
``sign`` ops), ``global_clip_norm=`` (``clip.py``), a learning-rate
scheduler (``lr_scheduler.py``: anything but a number), the other
optimizers (Adagrad, Adamax, DecayedAdagrad, AdaDelta, RMSProp, Ftrl)
and ``ModelAverage``. Per-parameter update hooks are
ROADMAP A8's (``param_hooks.py``).
"""
from __future__ import annotations

import numbers
from typing import Dict, Optional

from paddle_tpu_torch.framework.backward import append_backward
from paddle_tpu_torch.framework.program import (
    Parameter,
    Variable,
    default_main_program,
    default_startup_program,
    unique_name,
)
from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.regularizer import append_regularization_ops

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Adam", "AdamOptimizer",
    "Momentum", "MomentumOptimizer", "Adagrad", "AdagradOptimizer",
    "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
    "DecayedAdagradOptimizer", "AdaDelta", "AdaDeltaOptimizer", "RMSProp",
    "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "ModelAverage",
]


class Optimizer:
    def __init__(self, learning_rate=0.001, regularization=None,
                 global_clip_norm: Optional[float] = None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "a learning-rate scheduler needs lr_scheduler.py, which the "
                "port has not yet (ROADMAP A3); pass a number")
        if regularization is not None:
            raise NotImplementedError(
                "regularization= appends scale/sign ops, which the port has "
                "not yet (ROADMAP A3)")
        if global_clip_norm is not None:
            raise NotImplementedError(
                "global_clip_norm= needs clip.py, which the port has not "
                "yet (ROADMAP A3)")
        self.learning_rate = learning_rate
        self.regularization = regularization
        self.global_clip_norm = global_clip_norm
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None

    # -- plumbing -----------------------------------------------------
    def _create_lr_var(self) -> Variable:
        """The [1] learning-rate variable, filled once by the startup
        program."""
        if self._lr_var is not None:
            return self._lr_var
        main = default_main_program()
        name = unique_name("learning_rate")
        lr = main.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True)
        sp = default_startup_program().global_block()
        sp.create_var(name=name, shape=[1], dtype="float32", persistable=True)
        sp.append_op("fill_constant", outputs={"Out": name},
                     attrs={"shape": [1], "dtype": "float32",
                            "value": float(self.learning_rate)})
        self._lr_var = lr
        return lr

    def _add_accumulator(self, name: str, param: Parameter, fill_value=0.0,
                         shape=None) -> Variable:
        key = f"{name}_{param.name}"
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        main = default_main_program()
        var = main.global_block().create_var(
            name=unique_name(key), shape=shape or list(param.shape),
            dtype=param.dtype, persistable=True)
        ConstantInitializer(fill_value)(var)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter) -> Variable:
        return self._accumulators[name][param.name]

    # -- interface ----------------------------------------------------
    def _create_accumulators(self, block, params):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        block = loss.block.program.global_block()
        params_grads = append_regularization_ops(params_grads, block)
        hooked = [p.name for p, _ in params_grads
                  if getattr(p, "update_hooks", None)]
        if hooked:
            raise NotImplementedError(
                f"parameter(s) {hooked} carry update hooks, which need "
                "param_hooks.py, not ported yet (ROADMAP A8)")
        self._create_lr_var()
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = []
        for pg in params_grads:
            ops.append(self._append_optimize_op(block, pg))
        return ops, params_grads


class SGDOptimizer(Optimizer):
    """(ref fluid/optimizer.py SGDOptimizer; sgd_op.cc)."""

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "sgd",
            inputs={"Param": p, "Grad": g, "LearningRate": self._lr_var},
            outputs={"ParamOut": p})


class MomentumOptimizer(Optimizer):
    """(ref fluid/optimizer.py MomentumOptimizer; momentum_op.cc): one
    ``velocity`` accumulator a parameter."""

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "VelocityOut": v},
            attrs={"mu": self.momentum, "use_nesterov": self.use_nesterov})


class AdamOptimizer(Optimizer):
    """(ref fluid/optimizer.py AdamOptimizer; adam_op.cc)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=1.0, shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=1.0, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        return block.append_op(
            "adam",
            inputs={"Param": p, "Grad": g, "LearningRate": self._lr_var,
                    "Moment1": m1, "Moment2": m2, "Beta1Pow": b1p,
                    "Beta2Pow": b2p},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon})


def _deferred(name, what="this optimizer's update op"):
    """A JAX package name that the port does not have yet: constructing
    it raises, naming ROADMAP A3."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name} needs {what}, which the port has not yet "
            "(ROADMAP A3)")

    return type(name, (), {"__init__": __init__,
                           "__doc__": "Not ported yet (ROADMAP A3)."})


AdagradOptimizer = _deferred("AdagradOptimizer")
AdamaxOptimizer = _deferred("AdamaxOptimizer")
DecayedAdagradOptimizer = _deferred("DecayedAdagradOptimizer")
AdaDeltaOptimizer = _deferred("AdaDeltaOptimizer")
RMSPropOptimizer = _deferred("RMSPropOptimizer")
FtrlOptimizer = _deferred("FtrlOptimizer")
ModelAverage = _deferred("ModelAverage", "the ema_update and assign ops")

SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
AdaDelta = AdaDeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
