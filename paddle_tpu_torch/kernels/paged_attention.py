"""Paged attention over the block-paged KV cache: the mixed step, the
decode step and the chunk (prefill) forms.

The ports of the JAX package's ``kernels/paged_attention.py`` entries,
over a block-paged K/V pool ``[num_blocks, heads, block_size,
head_dim]`` read through per-slot block tables:

- ``paged_attention_mixed``: T independent single-token query rows,
  each with its own slot and its own context length (the chunked
  engine's mixed step);
- ``paged_attention``: ONE query per slot, ``seq_lens[s]`` keys of
  ``tables[s]`` (the whole-mode decode step);
- ``paged_attention_chunk``: G query rows per slot, ``ctx_lens[s, g]``
  keys each, which carries the causal intra-chunk mask (the whole-mode
  prefill).

Each row folds the keys at positions ``< ctx`` through an fp32 online
softmax; a row with context 0 outputs an exact zero row. Pools are
float32 or bfloat16, or int8 / float8_e4m3fn payloads with per-block
fp32 scales ``[num_blocks, heads]`` (``k_scale``/``v_scale``): each
gathered block is dequantized as ``payload * scale`` before the same
fold.

On CUDA tensors each wrapper launches its hand-written sm_90a kernel
(``csrc/paged_attention.cu``'s row-tile kernel for the mixed and decode
forms, head_dim up to 256; ``csrc/paged_attention_chunk.cu`` for the
chunk form, head_dim up to 128; see the notes there) and raises on
anything it does not take. On CPU tensors it runs
the plain version: ``paged_attention_reference`` — the same dense
gather + masked softmax as the JAX package's reference, which the tests
hold against the Pallas kernels in interpret mode — and, for the other
two forms, that reference over gathered tables or looped over rows.
"""
from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch import kernels as _kernels

__all__ = ["NEG_INF", "paged_attention", "paged_attention_chunk",
           "paged_attention_chunk_reference", "paged_attention_mixed",
           "paged_attention_mixed_reference", "paged_attention_reference"]

NEG_INF = -1e30  # finite stand-in for -inf: keeps exp() NaN-free
# the widest head_dim each CUDA kernel takes: the row-tile kernel of the
# mixed and decode forms is instantiated up to 256 dims, the chunk kernel
# up to 128 (ROADMAP C4)
MAX_HEAD_DIM = {"paged_attention_mixed": 256, "paged_attention_decode": 256,
                "paged_attention_chunk": 128}
# pool dtype -> (lane id, scaled)
_LANES = {
    torch.float32: (0, False),
    torch.bfloat16: (1, False),
    torch.int8: (2, True),
    torch.float8_e4m3fn: (3, True),
}
# C entry -> (library, pointer arguments, int arguments): each entry
# takes the lane, the pointers, the ints, sm_scale and the stream
_ENTRIES = {
    "paged_attention_mixed": ("paged_attention", 9, 5),
    "paged_attention_decode": ("paged_attention", 8, 5),
    "paged_attention_chunk": ("paged_attention_chunk", 8, 6),
}
_entries = {}


def _cuda_entry(name):
    """A kernel's C entry, built and bound on first use."""
    fn = _entries.get(name)
    if fn is None:
        from paddle_tpu_torch.kernels import _build
        lib, n_ptr, n_int = _ENTRIES[name]
        fn = getattr(_build.load(lib), name)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check_pools(q, k_pool, v_pool, k_scale, v_scale):
    if tuple(k_pool.shape) != tuple(v_pool.shape):
        raise ValueError(f"k_pool {tuple(k_pool.shape)} != v_pool "
                         f"{tuple(v_pool.shape)}")
    H, d = q.shape[-2], q.shape[-1]
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


def _check_cuda(entry, q, k_pool, v_pool, k_scale, v_scale, block_tables,
                index_arrays):
    """What the CUDA kernel of ``entry`` takes: every tensor on q's card
    and contiguous; float32 q; float32 or bfloat16 pools without scales,
    or int8 / float8_e4m3fn pools with float32 scales; int32 tables and
    index arrays (``index_arrays``: ``(name, tensor)`` pairs); head_dim
    at most ``MAX_HEAD_DIM[entry]``. Returns ``(lane id, scaled)``."""
    named = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_tables", block_tables)) + tuple(index_arrays)
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
    for name, x in named[3:4] + tuple(index_arrays):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM[entry]:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_HEAD_DIM[entry]} "
                         f"is not supported by the CUDA kernel of {entry} "
                         "(ROADMAP C4)")
    if block_tables.dim() != 2 or block_tables.shape[1] < 1:
        raise ValueError(f"block_tables must be [slots, max_pages], got "
                         f"{tuple(block_tables.shape)}")
    return lane


def _launch(entry, counters, q, k_pool, v_pool, k_scale, v_scale,
            block_tables, index_arrays, sizes, sm_scale):
    """Check the CUDA tensors, launch ``entry`` on q's current stream
    into a fresh output shaped like q, raise on a CUDA error, and count
    the launch under ``counters[scaled]``."""
    lane, scaled = _check_cuda(entry, q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, index_arrays)
    fn = _cuda_entry(entry)
    out = torch.empty_like(q)
    _N, H, B, d = k_pool.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(lane, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if scaled else None,
                 v_scale.data_ptr() if scaled else None,
                 block_tables.data_ptr(),
                 *[x.data_ptr() for _n, x in index_arrays],
                 out.data_ptr(), *sizes, H, d, B, block_tables.shape[1],
                 float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error "
                           f"{err}")
    _kernels.LAUNCHES[counters[scaled]] += 1
    return out


def _default_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def paged_attention_mixed(q, k_pool, v_pool, block_tables, row_slots,
                          ctx_lens, *, k_scale=None, v_scale=None,
                          sm_scale=None, interpret=None):
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
      interpret: the JAX wrapper's Pallas-interpreter switch: True on a
        CPU tensor is the plain version (as without it), on a CUDA
        tensor a ``ValueError``.

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
    sm_scale = _default_scale(q, sm_scale)
    _kernels.check_interpret(interpret, q, "paged_attention_mixed")
    if q.device.type == "cpu":
        return paged_attention_mixed_reference(
            q, k_pool, v_pool, block_tables, row_slots, ctx_lens,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention_mixed for device {q.device}")
    return _launch("paged_attention_mixed",
                   ("paged_attention_mixed", "paged_attention_mixed_quant"),
                   q, k_pool, v_pool, k_scale, v_scale, block_tables,
                   (("row_slots", row_slots), ("ctx_lens", ctx_lens)),
                   (T,), sm_scale)


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    k_scale=None, v_scale=None, sm_scale=None,
                    interpret=None):
    """One decode step of attention over block-paged K/V.

    Args:
      q: ``[slots, heads, head_dim]`` — ONE query token per slot.
      k_pool, v_pool: ``[num_blocks, heads, block_size, head_dim]``.
      block_tables: ``[slots, max_pages]`` int32 — each slot's pages;
        entries past the slot's page count are never read.
      seq_lens: ``[slots]`` int32 — context length per slot, INCLUDING
        the current token (whose K/V must already be in the pool). 0
        marks an inactive slot: its output row is 0.
      k_scale, v_scale, sm_scale, interpret: as
        ``paged_attention_mixed``.

    Returns ``[slots, heads, head_dim]``. CUDA tensors launch the
    mixed form's row-tile kernel with row i on slot i, so the result has
    ``paged_attention_mixed``'s bits on identity slots
    (``kernels.LAUNCHES["paged_attention"]``, or
    ``["paged_attention_quant"]`` for quantized pools), or raise; CPU
    tensors take ``paged_attention_reference``.
    """
    if q.dim() != 3:
        raise ValueError(f"q must be [slots, heads, head_dim], got shape "
                         f"{tuple(q.shape)}")
    _check_pools(q, k_pool, v_pool, k_scale, v_scale)
    S = q.shape[0]
    if tuple(seq_lens.shape) != (S,):
        raise ValueError(f"seq_lens must be [slots] = ({S},), got "
                         f"{tuple(seq_lens.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"block_tables must be [slots = {S}, max_pages], "
                         f"got {tuple(block_tables.shape)}")
    sm_scale = _default_scale(q, sm_scale)
    _kernels.check_interpret(interpret, q, "paged_attention")
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, seq_lens, k_scale=k_scale,
            v_scale=v_scale, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention for device {q.device}")
    return _launch("paged_attention_decode",
                   ("paged_attention", "paged_attention_quant"),
                   q, k_pool, v_pool, k_scale, v_scale, block_tables,
                   (("seq_lens", seq_lens),), (S,), sm_scale)


def paged_attention_chunk(q, k_pool, v_pool, block_tables, ctx_lens, *,
                          k_scale=None, v_scale=None, sm_scale=None,
                          interpret=None):
    """Attention for a CHUNK of q_len query rows per slot over the
    block-paged pool (the whole-prompt prefill rides this).

    Args:
      q: ``[slots, q_len, heads, head_dim]`` query chunk per slot.
      k_pool, v_pool: ``[num_blocks, heads, block_size, head_dim]``.
      block_tables: ``[slots, max_pages]`` int32.
      ctx_lens: ``[slots, q_len]`` int32 — context length of each chunk
        row INCLUDING itself (row g at absolute position p sees ``p + 1``
        keys), which encodes the causal intra-chunk mask; 0 masks a row
        entirely (its output is exactly zero).
      k_scale, v_scale, sm_scale, interpret: as ``paged_attention``.

    Returns ``[slots, q_len, heads, head_dim]``; q_len = 1 gives what
    ``paged_attention`` gives. CUDA tensors launch the row-tiled chunk
    kernel (``kernels.LAUNCHES["paged_attention_chunk"]``, or
    ``["paged_attention_chunk_quant"]`` for quantized pools; head_dim a
    multiple of 4) or raise; CPU tensors take
    ``paged_attention_chunk_reference``.
    """
    if q.dim() != 4:
        raise ValueError(f"q must be [slots, q_len, heads, head_dim], got "
                         f"shape {tuple(q.shape)}")
    _check_pools(q, k_pool, v_pool, k_scale, v_scale)
    S, G = q.shape[0], q.shape[1]
    if tuple(ctx_lens.shape) != (S, G):
        raise ValueError(f"ctx_lens must be [slots, q_len] = {(S, G)}, "
                         f"got {tuple(ctx_lens.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"block_tables must be [slots = {S}, max_pages], "
                         f"got {tuple(block_tables.shape)}")
    sm_scale = _default_scale(q, sm_scale)
    _kernels.check_interpret(interpret, q, "paged_attention_chunk")
    if q.device.type == "cpu":
        return paged_attention_chunk_reference(
            q, k_pool, v_pool, block_tables, ctx_lens, k_scale=k_scale,
            v_scale=v_scale, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention_chunk for device {q.device}")
    if q.shape[-1] % 4:
        raise ValueError(f"head_dim {q.shape[-1]} is not a multiple of 4, "
                         "which the CUDA chunk kernel needs")
    return _launch("paged_attention_chunk",
                   ("paged_attention_chunk", "paged_attention_chunk_quant"),
                   q, k_pool, v_pool, k_scale, v_scale, block_tables,
                   (("ctx_lens", ctx_lens),), (S, G), sm_scale)


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


def paged_attention_chunk_reference(q, k_pool, v_pool, block_tables,
                                    ctx_lens, *, k_scale=None,
                                    v_scale=None, sm_scale=None):
    """Plain version of the chunk form: a loop of SINGLE-query dense
    references, one per chunk row, as the JAX package's
    ``paged_attention_chunk_reference`` — every row's reductions have the
    shapes of ``paged_attention_reference``, so q_len = 1 equals it bit
    for bit."""
    G = q.shape[1]
    rows = [paged_attention_reference(q[:, g], k_pool, v_pool,
                                      block_tables, ctx_lens[:, g],
                                      k_scale=k_scale, v_scale=v_scale,
                                      sm_scale=sm_scale)
            for g in range(G)]
    return torch.stack(rows, dim=1)


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
