"""Optimizers — build the update region of the program: the port of the
JAX package's ``optimizer.py``, whole (fluid/optimizer.py:13,190:
accumulators and ``minimize``; the legacy FirstOrderOptimizer.h and
AverageOptimizer.h).

``minimize`` appends the ``backward`` pseudo-op; each parameter's
regularizer's decay ops (``regularizer.py``); with ``global_clip_norm=``
the global-norm clip (``clip.py``); the learning-rate variable, filled
once by the startup program from a number or, from an
``lr_scheduler.LRScheduler``, recomputed every step by ``lr_schedule``
from a persistable global step that ``increment`` advances; each
optimizer's accumulators (persistables filled by the startup program);
and one update op per parameter, with the names, slots and attributes
of the JAX package. The Executor runs everything after the backward
segment outside autograd, and writes the persistables back after the
step. ``ModelAverage`` keeps a shadow average of the parameters
(``ema_update``) and swaps it in on the device.

``regularization=`` is accepted and ignored, as in the JAX package
(ROADMAP C5). Per-parameter update hooks raise, naming ROADMAP A8
(``param_hooks.py``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

from paddle_tpu_torch.clip import append_gradient_clip_by_global_norm
from paddle_tpu_torch.framework.backward import append_backward
from paddle_tpu_torch.framework.program import (
    Parameter,
    Variable,
    default_main_program,
    default_startup_program,
    unique_name,
)
from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.lr_scheduler import LRScheduler
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
        """``learning_rate``: a number or an ``LRScheduler``.
        ``regularization``: kept and not used, as in the JAX package
        (ROADMAP C5): decay comes from each parameter's regularizer.
        ``global_clip_norm``: clip the gradients by their global norm."""
        self.learning_rate = learning_rate
        self.regularization = regularization
        self.global_clip_norm = global_clip_norm
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None
        self._global_step_var: Optional[Variable] = None

    # -- plumbing -----------------------------------------------------
    def _create_lr_var(self) -> Variable:
        """The [1] learning-rate variable. A number fills it once in the
        startup program; an ``LRScheduler`` seeds it there with its
        initial lr and recomputes it every step with ``lr_schedule``
        from a persistable float32 global step, which ``increment``
        then advances (LearningRateScheduler.cpp's plane, on the
        device)."""
        if self._lr_var is not None:
            return self._lr_var
        main = default_main_program()
        name = unique_name("learning_rate")
        lr = main.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True)
        sp = default_startup_program().global_block()
        sp.create_var(name=name, shape=[1], dtype="float32", persistable=True)
        sched = self.learning_rate
        if isinstance(sched, LRScheduler):
            sp.append_op("fill_constant", outputs={"Out": name},
                         attrs={"shape": [1], "dtype": "float32",
                                "value": float(sched.initial_lr)})
            gb = main.global_block()
            step_name = unique_name("global_step")
            step = gb.create_var(name=step_name, shape=[1],
                                 dtype="float32", persistable=True)
            sp.create_var(name=step_name, shape=[1], dtype="float32",
                          persistable=True)
            sp.append_op("fill_constant", outputs={"Out": step_name},
                         attrs={"shape": [1], "dtype": "float32",
                                "value": 0.0})
            gb.append_op("lr_schedule", inputs={"Step": step},
                         outputs={"Out": lr}, attrs=sched.op_attrs())
            gb.append_op("increment", inputs={"X": step},
                         outputs={"Out": step}, attrs={"step": 1.0})
            self._global_step_var = step
        else:
            sp.append_op("fill_constant", outputs={"Out": name},
                         attrs={"shape": [1], "dtype": "float32",
                                "value": float(sched)})
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
        hooked = [p.name for p, _ in params_grads
                  if getattr(p, "update_hooks", None)]
        if hooked:
            raise NotImplementedError(
                f"parameter(s) {hooked} carry update hooks, which need "
                "param_hooks.py, not ported yet (ROADMAP A8)")
        block = loss.block.program.global_block()
        params_grads = append_regularization_ops(params_grads, block)
        if self.global_clip_norm is not None:
            params_grads = append_gradient_clip_by_global_norm(
                params_grads, block, self.global_clip_norm)
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


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"epsilon": self.epsilon})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self.beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "adamax",
            inputs={"Param": p, "Grad": g, "LearningRate": self._lr_var,
                    "Moment": self._get_accumulator("moment", p),
                    "InfNorm": self._get_accumulator("inf_norm", p),
                    "Beta1Pow": self._get_accumulator("beta1_pow", p)},
            outputs={"ParamOut": p,
                     "MomentOut": self._get_accumulator("moment", p),
                     "InfNormOut": self._get_accumulator("inf_norm", p)},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"decay": self.decay, "epsilon": self.epsilon})


class AdaDeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": p, "Grad": g, "AvgSquaredGrad": asg,
                    "AvgSquaredUpdate": asu},
            outputs={"ParamOut": p, "AvgSquaredGradOut": asg,
                     "AvgSquaredUpdateOut": asu},
            attrs={"rho": self.rho, "epsilon": self.epsilon})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.9, momentum=0.0,
                 epsilon=1e-10, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.momentum, self.epsilon = decay, momentum, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ms = self._get_accumulator("mean_square", p)
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": p, "Grad": g, "MeanSquare": ms, "Moment": m,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "MeanSquareOut": ms, "MomentOut": m},
            attrs={"decay": self.decay, "momentum": self.momentum,
                   "epsilon": self.epsilon})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": p, "Grad": g, "SquaredAccumulator": sq,
                    "LinearAccumulator": lin, "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "SquaredAccumOut": sq,
                     "LinearAccumOut": lin},
            attrs={"l1": self.l1, "l2": self.l2, "lr_power": self.lr_power})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
AdaDelta = AdaDeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer


class ModelAverage:
    """Parameter averaging for evaluation and serving (the reference's
    AverageOptimizer.h apply / restore). As in the JAX package the
    windowed arithmetic mean is an exponential moving average: a shadow
    a parameter, seeded with its initial value by the startup program
    (``assign``), updated by ``ema_update`` in every step after the
    optimizer's update. Create it after ``minimize``::

        opt.minimize(loss)
        ma = pt.optimizer.ModelAverage(decay=0.999)
        ... train ...
        with ma.apply():
            ... evaluate / save with the averaged weights ...
    """

    def __init__(self, decay: float = 0.999, parameter_list=None):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = float(decay)
        main = default_main_program()
        gb = main.global_block()
        sp = default_startup_program().global_block()
        if parameter_list is None:
            params = [p for p in gb.all_parameters() if p.trainable]
        else:
            params = [gb.var(p) if isinstance(p, str) else p
                      for p in parameter_list]
        self._pairs = []   # (param_name, avg_name)
        for p in params:
            avg_name = unique_name(f"{p.name}.ema")
            gb.create_var(name=avg_name, shape=p.shape, dtype=p.dtype,
                          persistable=True)
            sp.create_var(name=avg_name, shape=p.shape, dtype=p.dtype,
                          persistable=True)
            sp.append_op("assign", inputs={"X": p.name},
                         outputs={"Out": avg_name})
            gb.append_op("ema_update",
                         inputs={"Param": p.name, "Avg": avg_name},
                         outputs={"AvgOut": avg_name},
                         attrs={"decay": self.decay})
            self._pairs.append((p.name, avg_name))

    def apply(self):
        """Context manager: the averaged weights in the global scope for
        its body, the live ones back on exit. The swap stays on the
        device: the live tensors are kept by reference and each shadow
        is cloned into its parameter's slot (so training inside the body
        trains a copy, never the shadow itself), with no host copy and
        no wait for the card."""
        from paddle_tpu_torch.core.scope import global_scope

        @contextlib.contextmanager
        def _ctx():
            scope = global_scope()
            backup = {}
            for pname, aname in self._pairs:
                backup[pname] = scope.get_tensor(pname).array
                scope.set_tensor(pname,
                                 scope.get_tensor(aname).array.clone())
            try:
                yield
            finally:
                for pname, val in backup.items():
                    scope.set_tensor(pname, val)
        return _ctx()
