"""Parameter attributes: the port of the JAX package's ``param_attr.py``
(fluid/param_attr.py, and ParameterConfig of ModelConfig.proto)."""
from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(
        self,
        name: Optional[str] = None,
        initializer=None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        update_hooks=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        # per-parameter post-update hooks (ref ParameterUpdaterHook.cpp);
        # their ops are ROADMAP A8's, so minimize raises on one
        self.update_hooks = list(update_hooks or ())

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            raise ValueError("use bias_attr=False at the layer level")
        # an Initializer instance
        return ParamAttr(initializer=arg)
