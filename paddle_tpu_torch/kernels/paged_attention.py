"""Ragged paged attention for the mixed chunked-prefill + decode step.

``paged_attention_mixed`` is the port of the JAX package's
``kernels/paged_attention.py:paged_attention_mixed``: T independent
single-token query rows, each with its own slot (which block-table row
it reads) and its own context length, over a block-paged K/V pool
``[num_blocks, heads, block_size, head_dim]``. Each row folds the keys
at positions ``< ctx_lens[t]`` through an fp32 online softmax; a row
with ``ctx_lens[t] == 0`` outputs an exact zero row. Pools are float32
or bfloat16, or int8 / float8_e4m3fn payloads with per-block fp32
scales ``[num_blocks, heads]`` (``k_scale``/``v_scale``): each gathered
block is dequantized as ``payload * scale`` before the same fold.

On CUDA tensors the wrapper launches the hand-written sm_90a kernel in
``csrc/paged_attention.cu`` (bandwidth-bound; see the note there) and
raises on anything it does not take. On CPU tensors it runs the plain
version, ``paged_attention_mixed_reference`` — the same dense gather +
masked softmax as the JAX package's reference, which the tests hold
against the Pallas kernel in interpret mode.
"""
from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch import kernels as _kernels

__all__ = ["NEG_INF", "paged_attention_mixed",
           "paged_attention_mixed_reference", "paged_attention_reference"]

NEG_INF = -1e30  # finite stand-in for -inf: keeps exp() NaN-free
MAX_HEAD_DIM = 128  # the CUDA kernel keeps head_dim/32 floats per lane
# the kernel's lanes: pool dtype -> (lane id, scaled, launch counter)
_LANES = {
    torch.float32: (0, False, "paged_attention_mixed"),
    torch.bfloat16: (1, False, "paged_attention_mixed"),
    torch.int8: (2, True, "paged_attention_mixed_quant"),
    torch.float8_e4m3fn: (3, True, "paged_attention_mixed_quant"),
}

_entry = None


def _cuda_entry():
    """The kernel's C entry, built and bound on first use."""
    global _entry
    if _entry is None:
        from paddle_tpu_torch.kernels import _build
        fn = _build.load("paged_attention").paged_attention_mixed
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _check_pools(q, k_pool, v_pool, k_scale, v_scale):
    if tuple(k_pool.shape) != tuple(v_pool.shape):
        raise ValueError(f"k_pool {tuple(k_pool.shape)} != v_pool "
                         f"{tuple(v_pool.shape)}")
    H, d = q.shape[1], q.shape[2]
    if k_pool.dim() != 4 or k_pool.shape[1] != H or k_pool.shape[3] != d:
        raise ValueError(
            "pools must be [num_blocks, heads, block_size, head_dim] "
            f"matching q's heads/head_dim; got {tuple(k_pool.shape)} vs "
            f"q {tuple(q.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if k_scale is not None:
        want = (k_pool.shape[0], k_pool.shape[1])
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != want:
                raise ValueError(f"{name} must be [num_blocks, heads] "
                                 f"{want}, got {tuple(sc.shape)}")


def _check_cuda(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                row_slots, ctx_lens):
    """What the CUDA kernel takes: every tensor on q's card and
    contiguous; float32 q; float32 or bfloat16 pools without scales, or
    int8 / float8_e4m3fn pools with float32 scales; int32 index arrays;
    head_dim <= 128. Returns the kernel's lane."""
    named = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_tables", block_tables), ("row_slots", row_slots),
             ("ctx_lens", ctx_lens))
    if k_scale is not None:
        named += (("k_scale", k_scale), ("v_scale", v_scale))
    for name, x in named:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32 for the CUDA kernel, got "
                        f"{q.dtype}")
    lane = _LANES.get(k_pool.dtype)
    if (lane is None or v_pool.dtype != k_pool.dtype
            or lane[1] != (k_scale is not None)):
        raise TypeError(
            f"no CUDA kernel lane for {k_pool.dtype}/{v_pool.dtype} pools "
            f"{'with' if k_scale is not None else 'without'} scales: it "
            "takes float32 or bfloat16 pools without scales, int8 or "
            "float8_e4m3fn pools with scales")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or v_scale.dtype != torch.float32):
        raise TypeError(f"k_scale/v_scale must be float32, got "
                        f"{k_scale.dtype}/{v_scale.dtype}")
    for name, x in named[3:6]:
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[2]} > {MAX_HEAD_DIM} is not "
                         "supported by the CUDA kernel")
    if block_tables.dim() != 2 or block_tables.shape[1] < 1:
        raise ValueError(f"block_tables must be [slots, max_pages], got "
                         f"{tuple(block_tables.shape)}")
    return lane


def paged_attention_mixed(q, k_pool, v_pool, block_tables, row_slots,
                          ctx_lens, *, k_scale=None, v_scale=None,
                          sm_scale=None):
    """Attention for a MIXED batch of independent single-token rows.

    Args:
      q: ``[rows, heads, head_dim]`` — one query token per row.
      k_pool, v_pool: ``[num_blocks, heads, block_size, head_dim]``.
      block_tables: ``[slots, max_pages]`` int32 slot-major tables;
        entries past a row's page count may name any block (stale) and
        are never read.
      row_slots: ``[rows]`` int32 — which table row each query row reads.
      ctx_lens: ``[rows]`` int32 — keys each row sees, INCLUDING itself;
        0 masks the row (output 0).
      k_scale, v_scale: ``[num_blocks, heads]`` fp32 per-block scales of
        a quantized pool, or None for a float pool.
      sm_scale: logit scale; default ``1/sqrt(head_dim)``.

    Returns ``[rows, heads, head_dim]``. CUDA tensors launch the kernel
    (adding one to ``kernels.LAUNCHES["paged_attention_mixed"]`` for
    float pools, ``["paged_attention_mixed_quant"]`` for quantized ones)
    or raise; CPU tensors take the plain version. Row slots and table
    entries are not range-checked on the card (that would cost a host
    sync); the engine builds them.
    """
    if q.dim() != 3:
        raise ValueError(f"q must be [rows, heads, head_dim], got shape "
                         f"{tuple(q.shape)}")
    _check_pools(q, k_pool, v_pool, k_scale, v_scale)
    T = q.shape[0]
    if tuple(row_slots.shape) != (T,) or tuple(ctx_lens.shape) != (T,):
        raise ValueError(
            f"row_slots/ctx_lens must be [rows] = ({T},), got "
            f"{tuple(row_slots.shape)} / {tuple(ctx_lens.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_mixed_reference(
            q, k_pool, v_pool, block_tables, row_slots, ctx_lens,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention_mixed for device {q.device}")
    lane, scaled, counter = _check_cuda(q, k_pool, v_pool, k_scale,
                                        v_scale, block_tables, row_slots,
                                        ctx_lens)
    fn = _cuda_entry()
    out = torch.empty_like(q)
    N, H, B, d = k_pool.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(lane, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if scaled else None,
                 v_scale.data_ptr() if scaled else None,
                 block_tables.data_ptr(), row_slots.data_ptr(),
                 ctx_lens.data_ptr(), out.data_ptr(), T, H, d, B,
                 block_tables.shape[1], float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_mixed kernel launch failed: "
                           f"CUDA error {err}")
    _kernels.LAUNCHES[counter] += 1
    return out


def paged_attention_mixed_reference(q, k_pool, v_pool, block_tables,
                                    row_slots, ctx_lens, *, k_scale=None,
                                    v_scale=None, sm_scale=None):
    """Plain version: gather each row's block-table row by its slot id,
    then the single-query dense reference on the [rows]-major batch."""
    slots = row_slots.to(device=block_tables.device, dtype=torch.long)
    return paged_attention_reference(q, k_pool, v_pool,
                                     block_tables[slots], ctx_lens,
                                     k_scale=k_scale, v_scale=v_scale,
                                     sm_scale=sm_scale)


def paged_attention_reference(q, k_pool, v_pool, block_tables, seq_lens,
                              *, k_scale=None, v_scale=None,
                              sm_scale=None):
    """Dense reference: gather every row's pages into a contiguous
    context and run masked softmax attention, exactly the JAX package's
    ``paged_attention_reference`` (fp32 statistics, finite ``NEG_INF``
    mask, zero row at length 0). A quantized pool's gathered blocks are
    dequantized with their stored per-block scales first. ``block_tables``
    is ``[rows, max_pages]``; O(rows * max_pages * block_size) memory."""
    S, H, d = q.shape
    block_size = k_pool.shape[2]
    n_pages = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    tables = block_tables.to(torch.long)
    lens = seq_lens.to(device=q.device, dtype=torch.long)
    kg = k_pool[tables].float()                    # [S, P, H, B, d]
    vg = v_pool[tables].float()
    if k_scale is not None:
        kg = kg * k_scale[tables][:, :, :, None, None]
        vg = vg * v_scale[tables][:, :, :, None, None]
    k = kg.permute(0, 2, 1, 3, 4).reshape(S, H, n_pages * block_size, d)
    v = vg.permute(0, 2, 1, 3, 4).reshape(S, H, n_pages * block_size, d)
    s = torch.einsum("shd,shtd->sht", q.float(), k) * sm_scale
    mask = (torch.arange(n_pages * block_size, device=q.device)[None, None]
            < lens[:, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("sht,shtd->shd", p / safe_l, v)
    return out.to(q.dtype)
