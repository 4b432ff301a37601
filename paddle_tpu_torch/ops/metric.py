"""Metric operators: the port of the JAX package's ``ops/metric.py``
``accuracy`` (the reference's accuracy_op.cc)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.registry import register_op

__all__ = ["accuracy"]


@register_op("accuracy", inputs=["Out", "Indices", "Label"],
             outputs=["Accuracy", "Correct", "Total"])
def accuracy(ins, attrs, ctx):
    """Top-k accuracy from top_k's Indices; counts in int32, as in the
    JAX op. Nothing is read back to the host."""
    idx, label = ins["Indices"][0], ins["Label"][0]
    label = label.reshape(-1, 1).to(idx.dtype)
    correct = (idx == label).any(dim=1).sum().to(torch.int32)
    total = torch.full((), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    return {"Accuracy": (correct / total).to(torch.float32).reshape(1),
            "Correct": correct.reshape(1), "Total": total.reshape(1)}
