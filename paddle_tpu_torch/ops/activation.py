"""Activation operators the text classifier and the MNIST MLP emit: the
port of the JAX package's ``ops/activation.py`` ``softmax`` and
``relu`` (the reference's softmax_op.cc, activation_op.cc)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.registry import register_op

__all__ = ["softmax", "relu"]


@register_op("softmax", inputs=["X"], outputs=["Out"], attrs={"axis": -1})
def softmax(ins, attrs, ctx):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs["axis"])}


@register_op("relu", inputs=["X"], outputs=["Out"])
def relu(ins, attrs, ctx):
    return {"Out": torch.relu(ins["X"][0])}
