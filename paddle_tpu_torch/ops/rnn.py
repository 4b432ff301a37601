"""Recurrence helpers: a copy of the JAX package's ``ops/rnn.py``
``_fused_ok`` (the engagement predicate of the fused recurrence kernels),
``_lens_from_mask`` and ``_reverse_valid``, which the seq2seq encoder
uses. The registered RNN ops of that file (``dynamic_lstm``,
``dynamic_gru``, ...) come with the op registry (ROADMAP A4).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import in_spmd_trace

__all__ = ["_fused_ok", "_lens_from_mask", "_reverse_valid"]


def _fused_ok(B, D, dtype, std_acts):
    """Engage the fused time-step kernel (``kernels/fused_rnn.py``)?
    Only for the standard gate math, float32/bfloat16, and shapes that
    tile (D % 128 == 0, B % 8 == 0): the JAX predicate's shape clauses,
    so each side of it runs the same route as the JAX package. Its
    "backend is a TPU" clause is dropped (the CUDA kernels are the
    target; on the CPU the same route runs their plain versions), and
    so is ``FLAGS.fused_rnn``. Returns ``False`` or ``"direct"``; inside
    an SPMD trace (the JAX ``"dp"`` mode) it raises, naming ROADMAP A9."""
    if not std_acts:
        return False
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if in_spmd_trace():
        raise NotImplementedError(
            "the fused recurrence inside an SPMD trace (the JAX 'dp' mode, "
            "gru_scan_dp / lstm_scan_dp) needs the port's parallel/ "
            "package (ROADMAP A9)")
    if D % 128 != 0 or B % 8 != 0:
        return False
    return "direct"


def _lens_from_mask(mask, dtype=torch.float32):
    """``[B, T]`` 0/1 mask -> ``[B, 1]`` lengths (on the mask's device;
    nothing is read back)."""
    return torch.sum(mask, dim=1, keepdim=True).to(dtype)


def _reverse_valid(arr, mask, T):
    """Flip each sequence's valid (left-aligned) prefix along time axis
    1; the padded tail stays where it is."""
    lens = torch.sum(mask, dim=1).to(torch.int64)
    t_idx = torch.arange(T, device=arr.device)[None, :]
    rev = torch.where(t_idx < lens[:, None], lens[:, None] - 1 - t_idx,
                      t_idx)
    idx = rev.reshape(rev.shape + (1,) * (arr.dim() - 2))
    return torch.gather(arr, 1, idx.expand(arr.shape[:2] + arr.shape[2:]))
