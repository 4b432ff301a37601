"""Learning-rate schedules, driven by a global-step variable: the port of
the JAX package's ``lr_scheduler.py`` (the reference's
LearningRateScheduler.cpp strategies poly, exp, discrete, linear and
manual, and the fluid learning-rate-decay functions that succeeded
them).

A scheduler is a declarative bundle of attributes for the
``lr_schedule`` op (``ops/optimizer_ops.py``). The optimizer creates one
persistable float32 global-step variable; every train step the op
computes lr = f(step) on the step's device, with the update ops, then
``increment`` advances the step; nothing goes to the host. Pass a
scheduler anywhere an optimizer takes ``learning_rate``::

    opt = pt.optimizer.SGD(pt.lr_scheduler.ExponentialDecay(
        0.1, decay_steps=1000, decay_rate=0.9))
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["LRScheduler", "ExponentialDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "PiecewiseDecay",
           "LinearDecay", "ManualLR"]


class LRScheduler:
    """Base: subclasses define ``strategy`` and the op attrs."""

    strategy: str = ""

    def op_attrs(self) -> dict:
        raise NotImplementedError

    @property
    def initial_lr(self) -> float:
        """lr at step 0 (used to seed the lr variable)."""
        raise NotImplementedError


class ExponentialDecay(LRScheduler):
    """lr = base * decay_rate^(step/decay_steps); ``staircase`` floors
    the exponent (ref LearningRateScheduler.cpp exp strategy)."""

    strategy = "exponential_decay"

    def __init__(self, base_lr: float, decay_steps: float, decay_rate: float,
                 staircase: bool = False):
        self.base_lr = float(base_lr)
        self.decay_steps = float(decay_steps)
        self.decay_rate = float(decay_rate)
        self.staircase = bool(staircase)

    def op_attrs(self):
        return {"strategy": self.strategy, "base_lr": self.base_lr,
                "decay_steps": self.decay_steps,
                "decay_rate": self.decay_rate, "staircase": self.staircase}

    @property
    def initial_lr(self):
        return self.base_lr


class NaturalExpDecay(ExponentialDecay):
    """lr = base * exp(-decay_rate * step/decay_steps)."""

    strategy = "natural_exp_decay"


class InverseTimeDecay(ExponentialDecay):
    """lr = base / (1 + decay_rate * step/decay_steps)."""

    strategy = "inverse_time_decay"


class PolynomialDecay(LRScheduler):
    """lr = (base-end) * (1 - step/decay_steps)^power + end
    (ref LearningRateScheduler.cpp poly strategy). ``cycle`` restarts
    the decay with a stretched horizon instead of clamping."""

    strategy = "polynomial_decay"

    def __init__(self, base_lr: float, decay_steps: float,
                 end_lr: float = 0.0001, power: float = 1.0,
                 cycle: bool = False):
        self.base_lr = float(base_lr)
        self.decay_steps = float(decay_steps)
        self.end_lr = float(end_lr)
        self.power = float(power)
        self.cycle = bool(cycle)

    def op_attrs(self):
        return {"strategy": self.strategy, "base_lr": self.base_lr,
                "decay_steps": self.decay_steps, "end_lr": self.end_lr,
                "power": self.power, "cycle": self.cycle}

    @property
    def initial_lr(self):
        return self.base_lr


class PiecewiseDecay(LRScheduler):
    """Step-wise constant lr: values[i] for step in
    [boundaries[i-1], boundaries[i]) (ref discrete strategy)."""

    strategy = "piecewise_decay"

    def __init__(self, boundaries: Sequence[float], values: Sequence[float]):
        if len(values) != len(boundaries) + 1:
            raise ValueError(
                f"need len(values) == len(boundaries)+1, got "
                f"{len(values)} values / {len(boundaries)} boundaries")
        if list(boundaries) != sorted(boundaries):
            raise ValueError("boundaries must be increasing")
        self.boundaries: List[float] = [float(b) for b in boundaries]
        self.values: List[float] = [float(v) for v in values]

    def op_attrs(self):
        return {"strategy": self.strategy, "boundaries": self.boundaries,
                "values": self.values}

    @property
    def initial_lr(self):
        return self.values[0]


class ManualLR(PiecewiseDecay):
    """The reference's "manual" strategy: per-segment lr given as
    segment *sizes* (steps) and values
    (ref LearningRateScheduler.cpp manual)."""

    def __init__(self, segment_steps: Sequence[float],
                 values: Sequence[float]):
        if len(segment_steps) != len(values) - 1:
            raise ValueError(
                "need len(values) == len(segment_steps)+1 (the last value "
                "holds after the final segment)")
        bounds, acc = [], 0.0
        for s in segment_steps:
            acc += float(s)
            bounds.append(acc)
        super().__init__(bounds, values)
        self.strategy = "piecewise_decay"


class LinearDecay(LRScheduler):
    """lr = max(end_lr, base - slope*step)
    (ref LearningRateScheduler.cpp linear strategy)."""

    strategy = "linear_decay"

    def __init__(self, base_lr: float, slope: float, end_lr: float = 0.0):
        self.base_lr = float(base_lr)
        self.slope = float(slope)
        self.end_lr = float(end_lr)

    def op_attrs(self):
        return {"strategy": self.strategy, "base_lr": self.base_lr,
                "decay_rate": self.slope, "end_lr": self.end_lr}

    @property
    def initial_lr(self):
        return self.base_lr
