"""Loss operators: a copy of the JAX package's ``ops/loss.py``
``nll_from_logits`` (the transformer's and the seq2seq model's loss),
the ``softmax_with_cross_entropy`` op (the reference's
softmax_with_cross_entropy_op.cc), ``square_error_cost`` (fit_a_line's
loss; the reference's squared_l2_distance_op.cc / v2 mse_cost) and
``squared_l2_norm`` (a gradient's share of the global-norm clip; the
reference's squared_l2_norm_op.cc)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.registry import register_op

__all__ = ["nll_from_logits", "softmax_with_cross_entropy",
           "square_error_cost", "squared_l2_norm"]


def nll_from_logits(logits, targets):
    """Per-position NLL over the trailing class/vocab axis, computed as
    ``logsumexp(logits) - logits[target]``: the same value as
    ``-log_softmax(logits)[target]`` without materializing the ``[...,
    C]`` log-prob array."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - tgt


@register_op("softmax_with_cross_entropy", inputs=["Logits", "Label"],
             outputs=["Softmax", "Loss"], attrs={"soft_label": False})
def softmax_with_cross_entropy(ins, attrs, ctx):
    """Numerically stable fused CE. Hard labels go through
    ``nll_from_logits`` in fp32; Softmax is emitted too, in the logits'
    dtype."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    if attrs["soft_label"]:
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
        return {"Softmax": torch.exp(logp), "Loss": loss}
    lf = logits.float()
    loss = nll_from_logits(lf, label.reshape(-1))[:, None]
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    softmax = torch.exp(lf - lse).to(logits.dtype)
    return {"Softmax": softmax, "Loss": loss.to(logits.dtype)}


@register_op("square_error_cost", inputs=["X", "Y"], outputs=["Out"])
def square_error_cost(ins, attrs, ctx):
    """(x - y)^2, elementwise."""
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": torch.square(x - y)}


@register_op("squared_l2_norm", inputs=["X"], outputs=["Out"])
def squared_l2_norm(ins, attrs, ctx):
    x = ins["X"][0]
    return {"Out": torch.sum(x * x).reshape(1)}
