"""Ragged-sequence (LoD) operators: the port of the JAX package's
``ops/sequence.py`` ``_require_lod``, the ``sequence_pool`` op (the
reference's operators/sequence_pool_op.cc) and the ``sequence_conv`` op
(sequence_conv_op.cc, math/context_project.h).

Sequences stay in packed-segment form (values on axis 0 plus host
offsets, see ``core.lod``); a per-sequence reduction is one
``index_add`` / ``scatter_reduce`` over segment ids made on the host
from the offsets, where the JAX package has ``jax.ops.segment_*``.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.lod import LoD, host_to_device
from paddle_tpu_torch.framework.registry import register_op
from paddle_tpu_torch.ops.math import _accum_matmul

__all__ = ["_require_lod", "sequence_pool", "sequence_conv"]


def _require_lod(ctx, slot="X"):
    lod = ctx.lod(slot)
    if not lod:
        raise ValueError(f"sequence op requires LoD on input {slot!r}")
    return lod


def _segment_reduce(x, seg, num, how):
    """Per-segment sum / max / min of x's rows; ``seg`` may hold the
    out-of-range id ``num`` (padding rows), which is dropped, as
    ``jax.ops.segment_*`` drops it. An empty segment's max (min) is -inf
    (+inf), the JAX identity."""
    shape = (num + 1,) + tuple(x.shape[1:])
    if how == "sum":
        out = x.new_zeros(shape).index_add(0, seg, x)
    else:
        fill = float("-inf") if how == "amax" else float("inf")
        idx = seg.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
        out = x.new_full(shape, fill).scatter_reduce(0, idx, x, how,
                                                     include_self=False)
    return out[:num]


@register_op("sequence_pool", inputs=["X", "SeqLens"],
             outputs=["Out", "MaxIndex"], optional_inputs=["SeqLens"],
             attrs={"pooltype": "AVERAGE"}, propagate_lod=False)
def sequence_pool(ins, attrs, ctx):
    """Pool each sequence of the packed X (SUM, AVERAGE, SQRT, MAX, MIN,
    LAST, FIRST). ``SeqLens`` (optional, [B] int): runtime valid lengths
    for bucketed batches whose static LoD is padded to a bucket
    boundary; positions past a sample's true length are excluded."""
    x = ins["X"][0]
    lod = _require_lod(ctx)
    offs = lod.offsets(-1)
    num = lod.num_sequences(-1)
    seg = lod.segment_ids(-1, total=x.shape[0], device=x.device)
    seq_lens = ins["SeqLens"][0] if ins.get("SeqLens") else None
    pt = attrs["pooltype"].upper()
    bshape = (-1,) + (1,) * (x.dim() - 1)
    if seq_lens is not None:
        seq_lens = seq_lens.reshape(-1).to(torch.int64)
        # each packed row's position within its sequence (host numpy:
        # the LoD is host metadata) against its sequence's runtime length
        offs_np = np.asarray(offs)
        seg_np = np.repeat(np.arange(len(offs_np) - 1), np.diff(offs_np))
        pos = host_to_device(np.arange(int(offs_np[-1])) - offs_np[seg_np],
                             x.device)
        valid = pos < seq_lens[host_to_device(seg_np, x.device)]
        vmask = valid.reshape(bshape)
        lens = torch.clamp(seq_lens, min=1).to(x.dtype).reshape(bshape)
        if pt in ("SUM", "AVERAGE", "SQRT"):
            x = torch.where(vmask, x, 0.0)
        elif pt == "MAX":
            x = torch.where(vmask, x, float("-inf"))
        elif pt == "MIN":
            x = torch.where(vmask, x, float("inf"))
    else:
        lens = host_to_device(np.maximum(np.diff(offs), 1), x.device).to(
            x.dtype).reshape(bshape)
    if pt == "SUM":
        out = _segment_reduce(x, seg, num, "sum")
    elif pt == "AVERAGE":
        out = _segment_reduce(x, seg, num, "sum") / lens
    elif pt == "SQRT":
        out = _segment_reduce(x, seg, num, "sum") / torch.sqrt(lens)
    elif pt in ("MAX", "MIN"):
        out = _segment_reduce(x, seg, num, "amax" if pt == "MAX" else "amin")
        out = torch.where(torch.isfinite(out), out, 0.0)
    elif pt == "LAST":
        if seq_lens is not None:
            idx = (host_to_device(offs[:-1], x.device)
                   + torch.clamp(seq_lens, min=1) - 1)
            out = x[idx]
        else:
            out = x[host_to_device(offs[1:] - 1, x.device)]
    elif pt == "FIRST":
        out = x[host_to_device(offs[:-1], x.device)]
    else:
        raise ValueError(f"unknown pooltype {pt}")
    # outer levels (if nested) survive pooling over the innermost level
    ctx.set_lod("Out", LoD(lod.levels[:-1]) if len(lod) > 1 else None)
    return {"Out": out}


def _context_index(offs, clen, cstart):
    """``[total, clen]`` packed-row index of each row's context window
    (row r + cstart + c), -1 where that row lies outside r's sequence."""
    offs = np.asarray(offs, np.int64)
    total = int(offs[-1])
    seg = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    lo, hi = offs[:-1][seg], offs[1:][seg]
    src = np.arange(total)[:, None] + cstart + np.arange(clen)[None, :]
    inside = (src >= lo[:, None]) & (src < hi[:, None])
    return np.where(inside, src, -1)


@register_op("sequence_conv", inputs=["X", "Filter"], outputs=["Out"],
             attrs={"contextStart": None, "contextLength": 3,
                    "contextStride": 1}, amp_compute=True)
def sequence_conv(ins, attrs, ctx):
    """Context-window projection, then one matmul: each packed row's
    window of ``contextLength`` rows from ``contextStart`` (default
    ``-(contextLength - 1) // 2``), rows outside its sequence zero,
    flattened to ``[total, contextLength * D]`` @ Filter. The window
    index is made on the host from the LoD offsets."""
    x, w = ins["X"][0], ins["Filter"][0]
    lod = _require_lod(ctx)
    clen = attrs["contextLength"]
    cstart = attrs["contextStart"]
    if cstart is None:
        cstart = -((clen - 1) // 2)
    idx = _context_index(lod.offsets(-1), clen, cstart)
    gi = host_to_device(np.maximum(idx, 0), x.device)
    mask = host_to_device((idx >= 0).astype(np.float32), x.device)
    ctxmat = x[gi] * mask[..., None].to(x.dtype)      # [total, clen, D]
    ctxmat = ctxmat.reshape(x.shape[0], clen * x.shape[-1])
    return {"Out": _accum_matmul(ctxmat, w)}
