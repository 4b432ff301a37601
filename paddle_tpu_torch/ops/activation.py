"""Activation operators the text nets and the MNIST MLP emit: the port of
the JAX package's ``ops/activation.py`` ``softmax``, ``relu``,
``sigmoid`` and ``tanh`` (the reference's softmax_op.cc,
activation_op.cc), the ops ``layers.fc(act=...)`` and the layers' unary
sugar append."""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.registry import register_op

__all__ = ["softmax", "relu", "sigmoid", "tanh"]


@register_op("softmax", inputs=["X"], outputs=["Out"], attrs={"axis": -1})
def softmax(ins, attrs, ctx):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs["axis"])}


@register_op("relu", inputs=["X"], outputs=["Out"])
def relu(ins, attrs, ctx):
    return {"Out": torch.relu(ins["X"][0])}


@register_op("sigmoid", inputs=["X"], outputs=["Out"])
def sigmoid(ins, attrs, ctx):
    return {"Out": torch.sigmoid(ins["X"][0])}


@register_op("tanh", inputs=["X"], outputs=["Out"])
def tanh(ins, attrs, ctx):
    return {"Out": torch.tanh(ins["X"][0])}
