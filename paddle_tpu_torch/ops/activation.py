"""Activation operators the text classifier emits: the port of the JAX
package's ``ops/activation.py`` ``softmax`` (the reference's
softmax_op.cc)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.registry import register_op

__all__ = ["softmax"]


@register_op("softmax", inputs=["X"], outputs=["Out"], attrs={"axis": -1})
def softmax(ins, attrs, ctx):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs["axis"])}
