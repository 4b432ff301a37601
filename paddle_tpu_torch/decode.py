"""Per-step decoding heads.

``greedy_step`` is the JAX package's ``decode.greedy_step`` (argmax with
finished rows frozen on EOS), the head of the whole-mode serving
engine's decode step and prefill. Beam search is not ported yet
(ROADMAP A6.5).
"""
from __future__ import annotations

import torch

__all__ = ["greedy_step"]


def greedy_step(log_probs, finished, eos_id: int):
    """One greedy sampling step: argmax over the vocab axis, with
    finished rows frozen on EOS. ``log_probs``: [batch, vocab] (any
    monotone transform of probabilities — logits work, argmax is
    invariant); ``finished``: [batch] bool. Returns ``(next_token
    int32 [batch], finished' [batch])``, both on the device of
    ``log_probs`` (nothing is read back)."""
    nxt = torch.argmax(log_probs, dim=-1).to(torch.int32)
    nxt = torch.where(finished, torch.full_like(nxt, int(eos_id)), nxt)
    return nxt, finished | (nxt == int(eos_id))
