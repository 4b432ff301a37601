"""Loss helpers: a copy of the JAX package's ``ops/loss.py``
``nll_from_logits``. The registered loss ops of that file come with the
op registry."""
from __future__ import annotations

import torch

__all__ = ["nll_from_logits"]


def nll_from_logits(logits, targets):
    """Per-position NLL over the trailing class/vocab axis, computed as
    ``logsumexp(logits) - logits[target]``: the same value as
    ``-log_softmax(logits)[target]`` without materializing the ``[...,
    C]`` log-prob array."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - tgt
