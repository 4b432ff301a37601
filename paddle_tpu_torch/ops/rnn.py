"""Recurrent ops over ragged batches: the port of the JAX package's
``ops/rnn.py`` ``dynamic_lstm`` and ``fused_lstm`` (the reference's
operators/lstm_op.cc and its fully fused hl_cuda_lstm.cu), with the
helpers of the fused recurrence: the engagement predicate ``_fused_ok``,
``_pack``, ``_lens_from_mask`` and ``_reverse_valid`` (which the seq2seq
encoder uses too).

Ragged input is padded once to ``[B, T, ...]`` (gather indices from the
host LoD offsets; a reshape when every sequence has the same length) and
the recurrence runs with a length mask. Two routes, as in the JAX
package:

- where ``_fused_ok`` holds, the fused kernels of
  ``kernels/fused_rnn.py``: ``dynamic_lstm`` runs ``lstm_scan`` (B10 /
  B11) over the pre-projected gates; ``fused_lstm`` on uniform lengths
  and not reversed runs ``lstm_scan_proj`` (B14 / B15), the input
  projection inside the recurrence, and otherwise computes the gates
  with one matmul and delegates to ``dynamic_lstm``;
- elsewhere (peepholes, non-standard activations, shapes that do not
  tile, ``FLAGS.fused_rnn`` off) a Python loop over time steps with the
  JAX ``lax.scan`` body's math in the input's dtype; its gradients come
  from autograd.

Gate order: i, f, c~, o.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.lod import pack_indices
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.framework.registry import register_op
from paddle_tpu_torch.kernels import in_spmd_trace
from paddle_tpu_torch.kernels.fused_rnn import lstm_scan, lstm_scan_proj
from paddle_tpu_torch.ops.sequence import _require_lod

__all__ = ["_fused_ok", "_lens_from_mask", "_pack", "_reverse_valid",
           "dynamic_lstm", "fused_lstm"]

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _fused_ok(B, D, dtype, std_acts):
    """Engage the fused time-step kernels (``kernels/fused_rnn.py``)?
    Only with ``FLAGS.fused_rnn`` on, for the standard gate math,
    float32/bfloat16, and shapes that tile (D % 128 == 0, B % 8 == 0):
    the JAX predicate's clauses, so each side of it runs the same route
    as the JAX package. Its "backend is a TPU" clause is dropped (the
    CUDA kernels are the target; on the CPU the same route runs their
    plain versions). Returns ``False`` or ``"direct"``; inside an SPMD
    trace (the JAX ``"dp"`` mode) it raises, naming ROADMAP A9."""
    if not FLAGS.fused_rnn or not std_acts:
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


def _pack(x, lod, width):
    """Packed ``[total, width]`` -> padded ``[B, T, width]``, its
    ``[B, T]`` mask, an unpack function, B and T. With every sequence of
    one length the gather/scatter is a reshape."""
    offs = np.asarray(lod.offsets(-1))
    lens = np.diff(offs)
    B = len(lens)
    if B and (lens == lens[0]).all():
        T = int(lens[0])
        xp = x.reshape(B, T, width)
        mask = torch.ones((B, T), dtype=torch.float32, device=x.device)
        return (xp, mask, lambda hs: hs.reshape(B * T, hs.shape[-1]), B,
                T)
    gather, mask, scatter, B, T = pack_indices(lod, device=x.device)
    xp = x.reshape(-1, width)[gather]
    return (xp, mask,
            lambda hs: hs.reshape(B * T, hs.shape[-1])[scatter], B, T)


def _reverse_valid(arr, mask, T):
    """Flip each sequence's valid (left-aligned) prefix along time axis
    1; the padded tail stays where it is."""
    lens = torch.sum(mask, dim=1).to(torch.int64)
    t_idx = torch.arange(T, device=arr.device)[None, :]
    rev = torch.where(t_idx < lens[:, None], lens[:, None] - 1 - t_idx,
                      t_idx)
    idx = rev.reshape(rev.shape + (1,) * (arr.dim() - 2))
    return torch.gather(arr, 1, idx.expand(arr.shape[:2] + arr.shape[2:]))


def _opt(ins, slot):
    return ins[slot][0] if ins.get(slot) else None


def _runtime_mask(ins, mask, T):
    """The ``SeqLens`` runtime lengths (bucketed batches) folded into the
    static LoD mask."""
    seq_lens = _opt(ins, "SeqLens")
    if seq_lens is None:
        return mask
    rt = (torch.arange(T, device=mask.device)[None, :]
          < seq_lens.reshape(-1)[:, None])
    return mask * rt.to(mask.dtype)


def _init_state(ins, B, D, x):
    """H0 / C0 in x's dtype, zeros where absent."""
    out = []
    for slot in ("H0", "C0"):
        v = _opt(ins, slot)
        out.append(torch.zeros((B, D), dtype=x.dtype, device=x.device)
                   if v is None else v.to(x.dtype))
    return out


@register_op("dynamic_lstm",
             inputs=["Input", "Weight", "Bias", "H0", "C0", "SeqLens"],
             outputs=["Hidden", "Cell"],
             optional_inputs=["Bias", "H0", "C0", "SeqLens"],
             attrs={"use_peepholes": False, "is_reverse": False,
                    "gate_activation": "sigmoid",
                    "cell_activation": "tanh",
                    "candidate_activation": "tanh"},
             amp_compute=True)
def dynamic_lstm(ins, attrs, ctx):
    """Input: packed pre-projected gates [total, 4D] with LoD; Weight:
    the recurrent projection [D, 4D]; Bias [1, 4D] (+ [1, 7D] with
    peepholes: W_ic, W_fc, W_oc). ``SeqLens`` (optional, [B] int):
    runtime valid lengths over the static LoD mask (the bucketed-batch
    path)."""
    x, w = ins["Input"][0], ins["Weight"][0]
    lod = _require_lod(ctx, "Input")
    D = w.shape[0]
    gate_act = _ACT[attrs["gate_activation"]]
    cell_act = _ACT[attrs["cell_activation"]]
    cand_act = _ACT[attrs["candidate_activation"]]
    use_peep = attrs["use_peepholes"]
    bias = _opt(ins, "Bias")
    gate_bias = peep = None
    if bias is not None:
        b = bias.reshape(-1)
        gate_bias = b[:4 * D]
        if use_peep:
            peep = b[4 * D:7 * D]

    xp, mask, unpack, B, T = _pack(x, lod, 4 * D)  # [B, T, 4D]
    mask = _runtime_mask(ins, mask, T)
    if attrs["is_reverse"]:
        xp = _reverse_valid(xp, mask, T)
    h_init, c_init = _init_state(ins, B, D, x)
    std_acts = (attrs["gate_activation"] == "sigmoid"
                and attrs["cell_activation"] == "tanh"
                and attrs["candidate_activation"] == "tanh")
    if not use_peep and _fused_ok(B, D, x.dtype, std_acts):
        xp_t = xp.transpose(0, 1)                   # [T, B, 4D]
        if gate_bias is not None:
            xp_t = xp_t + gate_bias.to(xp_t.dtype)
        hs, cs = lstm_scan(xp_t.contiguous(), w.to(x.dtype).contiguous(),
                           _lens_from_mask(mask), h_init.contiguous(),
                           c_init.contiguous())
        hs, cs = hs.transpose(0, 1), cs.transpose(0, 1)
    else:
        xs = xp.transpose(0, 1)                     # [T, B, 4D]
        mT = mask.transpose(0, 1)[..., None].to(x.dtype)   # [T, B, 1]
        h, c = h_init, c_init
        hl, cl = [], []
        for t in range(T):
            gates = xs[t] + h @ w
            if gate_bias is not None:
                gates = gates + gate_bias.to(gates.dtype)
            gi, gf, gc, go = torch.split(gates, D, dim=-1)
            if use_peep:
                gi = gi + c * peep[:D].to(gates.dtype)
                gf = gf + c * peep[D:2 * D].to(gates.dtype)
            i = gate_act(gi)
            f = gate_act(gf)
            c_new = f * c + i * cand_act(gc)
            if use_peep:
                go = go + c_new * peep[2 * D:].to(gates.dtype)
            o = gate_act(go)
            h_new = o * cell_act(c_new)
            m_t = mT[t]
            h = m_t * h_new + (1 - m_t) * h
            c = m_t * c_new + (1 - m_t) * c
            hl.append(h)
            cl.append(c)
        zero = x.new_zeros((B, 0, D))
        hs = torch.stack(hl, dim=1) if hl else zero
        cs = torch.stack(cl, dim=1) if cl else zero
    if attrs["is_reverse"]:
        hs = _reverse_valid(hs, mask, T)
        cs = _reverse_valid(cs, mask, T)
    ctx.set_lod("Hidden", lod)
    ctx.set_lod("Cell", lod)
    return {"Hidden": unpack(hs), "Cell": unpack(cs)}


@register_op("fused_lstm",
             inputs=["Input", "WeightX", "Weight", "Bias", "H0", "C0",
                     "SeqLens"],
             outputs=["Hidden", "Cell"],
             optional_inputs=["Bias", "H0", "C0", "SeqLens"],
             attrs={"is_reverse": False},
             amp_compute=True)
def fused_lstm(ins, attrs, ctx):
    """LSTM owning its input projection: Input is the raw layer input
    (packed [total, E] with LoD), WeightX [E, 4D], Weight [D, 4D], Bias
    [1, 4D]. On uniform lengths, not reversed, where the kernels engage
    (and E % 128 == 0), the projection runs inside the recurrence
    (``lstm_scan_proj``); everywhere else the op computes the gates with
    one matmul and delegates to ``dynamic_lstm``, the same math."""
    x, wx, w = ins["Input"][0], ins["WeightX"][0], ins["Weight"][0]
    lod = _require_lod(ctx, "Input")
    D = w.shape[0]
    E = wx.shape[0]
    bias = _opt(ins, "Bias")
    if bias is not None and bias.numel() != 4 * D:
        # no peephole path here: a 7D (peephole) or otherwise mis-sized
        # bias must fail loudly, not be truncated to its first 4D entries
        raise ValueError(
            f"fused_lstm: Bias must have 4*D = {4 * D} elements "
            f"(i/f/c/o gate biases), got {bias.numel()}")
    lens_np = np.diff(np.asarray(lod.offsets(-1)))
    B = len(lens_np)
    uniform = bool(B) and bool((lens_np == lens_np[0]).all())
    if (uniform and E % 128 == 0 and not attrs["is_reverse"]
            and _fused_ok(B, D, x.dtype, True) == "direct"):
        xp, mask, unpack, B, T = _pack(x, lod, E)   # [B, T, E] reshape
        mask = _runtime_mask(ins, mask, T)
        h_init, c_init = _init_state(ins, B, D, x)
        b = (torch.zeros((4 * D,), dtype=x.dtype, device=x.device)
             if bias is None else bias.reshape(4 * D).to(x.dtype))
        hs, cs = lstm_scan_proj(
            xp.transpose(0, 1).contiguous(), wx.to(x.dtype).contiguous(),
            b.contiguous(), w.to(x.dtype).contiguous(),
            _lens_from_mask(mask), h_init.contiguous(), c_init.contiguous())
        ctx.set_lod("Hidden", lod)
        ctx.set_lod("Cell", lod)
        return {"Hidden": unpack(hs.transpose(0, 1)),
                "Cell": unpack(cs.transpose(0, 1))}

    # composed fallback: one matmul for the gates, then dynamic_lstm
    gates = x.reshape(-1, E) @ wx.to(x.dtype)
    sub_ins = {"Input": [gates], "Weight": [w]}
    if bias is not None:
        sub_ins["Bias"] = [bias]
    for slot in ("H0", "C0", "SeqLens"):
        if ins.get(slot):
            sub_ins[slot] = ins[slot]
    sub_attrs = {"use_peepholes": False,
                 "is_reverse": attrs["is_reverse"],
                 "gate_activation": "sigmoid",
                 "cell_activation": "tanh",
                 "candidate_activation": "tanh"}
    return dynamic_lstm(sub_ins, sub_attrs, ctx)
