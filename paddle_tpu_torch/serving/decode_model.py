"""A causal decoder LM over the block-paged KV cache, in PyTorch.

The port of the JAX package's ``serving/decode_model.py`` for the
chunked-prefill serving path: the same pre-LN, learned-position,
tied-head, GELU decoder, with parameters as a plain dict of tensors in
the JAX layout (``x @ W``; ``wqkv`` is ``[D, 3*H*hd]``), so
``convert.params_from_jax`` copies weights across without transposing.

``mixed_step`` is the one entry of the chunked serving loop: T
independent (slot, position, token) rows per call — decode rows and
prompt-chunk rows packed together — whose shapes never depend on batch
composition. The whole-prompt engine has two: ``decode_step`` (one
token per slot) and ``prefill`` (one request's prompt tail, padded to a
rung, through ``decode_chunk``). Every dense op acts per row and
attention reads only the row's own context, so a request's tokens are
the same solo or in a churning batch at the same step shapes. Attention
goes through ``kernels.paged_attention_mixed``, ``kernels.
paged_attention`` and ``kernels.paged_attention_chunk`` (the CUDA
kernels for tensors on the card, their plain versions on the CPU); the
rest is plain PyTorch, as the JAX package left it to XLA.

Quantized serving keeps the same signatures: ``quantize_decoder_params``
replaces the projection weights with 1-byte payloads and per-channel
scales that ``_proj`` sends through ``kernels.quant_matmul``, and a
quantized pool is the ``(payload, scales, cal)`` tuple of
``kvcache.make_pools``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention, paged_attention_chunk,
    paged_attention_chunk_reference, paged_attention_mixed,
    paged_attention_mixed_reference, paged_attention_reference)
from paddle_tpu_torch.kernels.quant_matmul import (quant_matmul,
                                                   quant_matmul_reference,
                                                   quantize_weight)
from paddle_tpu_torch.serving.kvcache import KVCacheConfig

__all__ = ["DecoderConfig", "init_params", "param_bytes", "mixed_step",
           "decode_step", "decode_chunk", "prefill", "QUANT_PROJ_KEYS",
           "quantize_decoder_params", "dense_prefill"]

_LN_EPS = 1e-5
# Projection weights eligible for the quantized-matmul lane. Embed/pos
# stay fp32 (gather + tied LM head); layernorm scales and biases are
# vectors, and quantizing them saves nothing.
QUANT_PROJ_KEYS = ("wqkv", "wo", "w1", "w2")
# absmax/rms ceilings of a plan's fallback rule, copied from the JAX
# package's analysis/quant.py: int8 holds a ratio-32 distribution with
# <= 2-bit noise at the rms point; e4m3's exponent covers ~2^8 of spread
_INT8_RATIO_MAX = 32.0
_FP8_RATIO_MAX = 256.0


@dataclass(frozen=True)
class DecoderConfig:
    """Static decoder hyperparameters (same defaults as the JAX
    package's)."""

    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    head_dim: int = 16
    n_layers: int = 2
    d_ff: int = 128
    max_seq_len: int = 256

    def kv_config(self, block_size: int, num_blocks: int,
                  dtype: str = "float32") -> KVCacheConfig:
        return KVCacheConfig(
            num_layers=self.n_layers, num_heads=self.n_heads,
            head_dim=self.head_dim, block_size=block_size,
            num_blocks=num_blocks, dtype=dtype)


def init_params(cfg: DecoderConfig, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Deterministic small-scale init from a ``torch.Generator`` on
    ``device`` (the card by default). Same shapes, scales and layout as
    the JAX package's ``init_params``; the numbers differ (another
    generator), so tests copy weights across with ``params_from_jax``.
    The LM head is tied to ``embed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    hd = cfg.n_heads * cfg.head_dim

    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=gen, device=dev,
                                  dtype=torch.float32)

    def ones(n):
        return torch.ones((n,), device=dev, dtype=torch.float32)

    def zeros(n):
        return torch.zeros((n,), device=dev, dtype=torch.float32)

    p: Dict[str, torch.Tensor] = {
        "embed": normal(cfg.vocab_size, cfg.d_model),
        "pos": normal(cfg.max_seq_len, cfg.d_model),
        "lnf_s": ones(cfg.d_model),
        "lnf_b": zeros(cfg.d_model),
    }
    for l in range(cfg.n_layers):
        p[f"l{l}_ln1_s"] = ones(cfg.d_model)
        p[f"l{l}_ln1_b"] = zeros(cfg.d_model)
        p[f"l{l}_wqkv"] = normal(cfg.d_model, 3 * hd)
        p[f"l{l}_bqkv"] = zeros(3 * hd)
        p[f"l{l}_wo"] = normal(hd, cfg.d_model)
        p[f"l{l}_ln2_s"] = ones(cfg.d_model)
        p[f"l{l}_ln2_b"] = zeros(cfg.d_model)
        p[f"l{l}_w1"] = normal(cfg.d_model, cfg.d_ff)
        p[f"l{l}_b1"] = zeros(cfg.d_ff)
        p[f"l{l}_w2"] = normal(cfg.d_ff, cfg.d_model)
        p[f"l{l}_b2"] = zeros(cfg.d_model)
    return p


def param_bytes(cfg: DecoderConfig, dtype_bytes: int = 4) -> int:
    """Analytic parameter footprint of ``init_params(cfg)`` (tied LM
    head: embed counted once)."""
    hd = cfg.n_heads * cfg.head_dim
    per_layer = (2 * cfg.d_model                       # ln1
                 + cfg.d_model * 3 * hd + 3 * hd       # wqkv + bqkv
                 + hd * cfg.d_model                    # wo
                 + 2 * cfg.d_model                     # ln2
                 + cfg.d_model * cfg.d_ff + cfg.d_ff   # w1 + b1
                 + cfg.d_ff * cfg.d_model + cfg.d_model)  # w2 + b2
    total = (cfg.vocab_size * cfg.d_model              # embed (tied)
             + cfg.max_seq_len * cfg.d_model           # pos
             + 2 * cfg.d_model                         # lnf
             + cfg.n_layers * per_layer)
    return total * int(dtype_bytes)


def _plan_dtype_for(plan, name: str, w) -> Optional[str]:
    """Precision for projection ``name`` under ``plan``: a bare dtype
    string ("int8" / "fp8-e4m3") quantizes every projection; a plan
    object's ``.decisions`` (each with ``.name`` and ``.dtype``) are
    matched by name or name suffix; a projection with no decision falls
    back to the absmax/rms ratio rule on the weight itself. None keeps
    the weight in fp32."""
    if plan is None:
        return None
    if isinstance(plan, str):
        return plan
    suffix = name.split("_", 1)[-1]          # "l0_wqkv" -> "wqkv"
    for d in getattr(plan, "decisions", ()):
        if d.name == name or d.name.endswith(suffix):
            return d.dtype if d.dtype in ("int8", "fp8-e4m3") else None
    w = w.float()
    absmax = float(w.abs().max())
    rms = float(w.square().mean().sqrt())
    if rms <= 0.0:
        return "int8"
    ratio = absmax / rms
    if ratio <= _INT8_RATIO_MAX:
        return "int8"
    if ratio <= _FP8_RATIO_MAX:
        return "fp8-e4m3"
    return None


def quantize_decoder_params(cfg: DecoderConfig, params, quant_plan):
    """Rewrite ``params`` for quantized projections per ``quant_plan``
    (the JAX package's ``quantize_decoder_params``): each projection in
    ``QUANT_PROJ_KEYS`` planned as int8 or fp8-e4m3 is REPLACED by
    ``name__q`` (1-byte payload) and ``name__scale`` (per-output-channel
    fp32), so the fp32 weight's memory is freed. Returns a new dict;
    the input is not mutated."""
    out = dict(params)
    for l in range(cfg.n_layers):
        for key in QUANT_PROJ_KEYS:
            name = f"l{l}_{key}"
            w = params[name]
            dtype = _plan_dtype_for(quant_plan, name, w)
            if dtype is None:
                continue
            wq, scale = quantize_weight(w, dtype)
            del out[name]
            out[name + "__q"] = wq
            out[name + "__scale"] = scale
    return out


def _ln(x, s, b):
    """Layernorm with the biased variance and eps 1e-5, as the JAX
    package's ``_ln``."""
    return F.layer_norm(x, (x.shape[-1],), s, b, _LN_EPS)


def _proj(params, name, x, add=None, plain=False):
    """``add + x @ params[name]`` (``add`` a bias or the residual) — or
    the quantized-matmul lane when ``quantize_decoder_params`` replaced
    the weight with its ``name__q`` / ``name__scale`` form (its plain
    version when ``plain``)."""
    wq = params.get(name + "__q")
    if wq is None:
        w = params[name]
        return x @ w if add is None else torch.addmm(add, x, w)
    qmm = quant_matmul_reference if plain else quant_matmul
    y = qmm(x, wq, params[name + "__scale"])
    return y if add is None else y + add


def _qkv(cfg, params, l, x, plain=False):
    """[n, D] -> q, k, v each [n, H, head_dim]."""
    h = _ln(x, params[f"l{l}_ln1_s"], params[f"l{l}_ln1_b"])
    qkv = _proj(params, f"l{l}_wqkv", h, params[f"l{l}_bqkv"], plain)
    hd = cfg.n_heads * cfg.head_dim
    shape = (-1, cfg.n_heads, cfg.head_dim)
    return (qkv[:, :hd].reshape(shape), qkv[:, hd:2 * hd].reshape(shape),
            qkv[:, 2 * hd:].reshape(shape))


def _mlp(cfg, params, l, x, plain=False):
    h = _ln(x, params[f"l{l}_ln2_s"], params[f"l{l}_ln2_b"])
    # jax.nn.gelu defaults to the tanh approximation
    a = F.gelu(_proj(params, f"l{l}_w1", h, params[f"l{l}_b1"], plain),
               approximate="tanh")
    return _proj(params, f"l{l}_w2", a, params[f"l{l}_b2"], plain)


def _logits(cfg, params, x):
    return _ln(x, params["lnf_s"], params["lnf_b"]) @ params["embed"].T


def _write_plan(blk, off, valid):
    """Where each row's K/V write lands, decided once per step, over
    the flat rows of a step (``[T]`` for the mixed step, ``[S]`` for the
    decode step, ``[S*G]`` for a chunk).

    The JAX package drops invalid rows with an out-of-range scatter
    (``mode="drop"``); torch raises on those indices, and a boolean
    mask would cost a host sync. So an invalid row is sent to repeat
    the write of the first valid row — same place, same value — and
    when no row is valid every row rewrites one place with what it
    already holds: the invalid rows change nothing. Valid rows never
    share a target (each writes its slot's own position in an exclusive
    block), so the result does not depend on write order.

    Returns ``(blk, off, src_row, any_valid)``: per-row targets, the
    row whose value each writes, and a [1, 1, 1] flag. Every index
    stays a device tensor (a 0-dim one would be read back to the host).
    """
    first = torch.argmax(valid.to(torch.int32)).reshape(1)  # or row 0
    rows = torch.arange(valid.shape[0], device=valid.device)
    src_row = torch.where(valid, rows, first)
    return (blk[src_row], off[src_row], src_row,
            valid[first].reshape(1, 1, 1))


def _pool_layer(pool, l):
    """Layer ``l``'s view of a pool (bare tensor or the quantized
    ``(payload, scales, cal)`` tuple): ``(payload_l, scales_l or
    None)``."""
    if isinstance(pool, tuple):
        return pool[0][l], pool[1][l]
    return pool[l], None


def _quantize_kv(rows, scale, dtype):
    """K/V rows ``[n, H, d]`` / per-head write scale ``[H]`` -> 1-byte
    payload values, as the JAX package's ``_scatter_kv`` makes them.
    fp8 is not clipped there, and JAX's e4m3 cast turns a magnitude
    past 464 (the rounding midpoint above 448) into NaN where torch's
    saturates: the port writes the NaN too, so its pools stay equal to
    the reference's (ROADMAP C2)."""
    scaled = rows.float() / scale[None, :, None]
    if dtype == torch.int8:
        return torch.round(scaled).clamp(-127, 127).to(torch.int8)
    scaled = torch.where(scaled.abs() > 464.0,
                         torch.full_like(scaled, float("nan")), scaled)
    return scaled.to(dtype)


def _scatter_kv(pool, l, plan, rows):
    """Write per-row K or V heads ``rows [n, H, d]`` into pool layer
    ``l`` IN PLACE, following ``_write_plan``. A quantized pool
    quantizes ``rows`` with its write scale ``cal[l]`` and records that
    scale in the written block's ``scales`` row, so reads dequantize a
    block with the scale it was written under."""
    blk, off, src_row, any_valid = plan
    if not isinstance(pool, tuple):
        pl = pool[l]                               # [N, H, B, d] view
        pl[blk, :, off, :] = torch.where(
            any_valid, rows[src_row].to(pl.dtype), pl[blk, :, off, :])
        return
    payload, scales, cal = pool
    s = cal[l]                                     # [H] write scale
    q = _quantize_kv(rows[src_row], s, payload.dtype)
    # 1-byte payloads move as uint8, which every indexing op takes
    pl = payload[l].view(torch.uint8)
    pl[blk, :, off, :] = torch.where(any_valid, q.view(torch.uint8),
                                     pl[blk, :, off, :])
    sl = scales[l]                                 # [N, H] view
    sl[blk] = torch.where(any_valid[0], s.expand(blk.shape[0], -1),
                          sl[blk])


def _attend(kernel, reference, plain, k_pool, v_pool, *args):
    """``attend(q, l)`` for ``_layers``: attention of layer ``l`` through
    ``kernel`` (``reference`` when ``plain``) over that layer's pool
    views and scales, with ``args`` (tables, row slots, lengths) after
    the pools."""
    def attend(q, l):
        k_l, k_sc = _pool_layer(k_pool, l)
        v_l, v_sc = _pool_layer(v_pool, l)
        fn = reference if plain else kernel
        return fn(q, k_l, v_l, *args, k_scale=k_sc, v_scale=v_sc)
    return attend


def _layers(cfg, params, k_pool, v_pool, x, plan, attend, plain):
    """The decoder's layers over flat rows ``x [n, d_model]``: each layer
    writes its K/V into the pools by ``plan`` (``_write_plan``) and then
    attends through ``attend(q [n, heads, head_dim], l)``, which returns
    q's shape or any shape of n rows. Returns the logits [n, vocab]."""
    n = x.shape[0]
    for l in range(cfg.n_layers):
        q, k, v = _qkv(cfg, params, l, x, plain)
        _scatter_kv(k_pool, l, plan, k)
        _scatter_kv(v_pool, l, plan, v)
        attn = attend(q.contiguous(), l)
        x = _proj(params, f"l{l}_wo", attn.reshape(n, -1), x, plain)
        x = x + _mlp(cfg, params, l, x, plain)
    return _logits(cfg, params, x)


def _is_plain(attn_impl) -> bool:
    if attn_impl not in (None, "reference"):
        raise ValueError(f"attn_impl must be None (the kernels on CUDA, "
                         f"their plain versions on CPU) or 'reference', "
                         f"got {attn_impl!r}")
    return attn_impl == "reference"


@torch.no_grad()
def mixed_step(cfg: DecoderConfig, params, k_pool, v_pool,
               tokens, row_slots, positions, valid, block_tables,
               attn_impl: Optional[str] = None,
               write_limit: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unified chunked-prefill + decode step: T independent
    (slot, position, token) rows in ONE call.

    ``tokens[t]`` sits at absolute position ``positions[t]`` of slot
    ``row_slots[t]``. Rows with ``valid[t]`` false, or at positions >=
    ``write_limit`` (default ``cfg.max_seq_len``), are masked: their
    K/V writes are dropped and their logits are garbage the caller
    ignores. Valid rows write K/V first, then attend over ``position +
    1`` keys, so chunk rows of one slot packed in position order see
    earlier rows of their own chunk (the causal intra-chunk mask).

    Unlike the JAX version, ``k_pool``/``v_pool`` (bare tensors, or the
    quantized ``(payload, scales, cal)`` tuples) are updated IN PLACE;
    they are also returned, so the ``(logits [T, vocab], k_pool,
    v_pool)`` signature stays. Row arrays may be tensors or numpy
    arrays; they are moved to the params' device. ``attn_impl=None``
    takes the kernels (``paged_attention_mixed`` and, for quantized
    weights, ``quant_matmul``: on CUDA tensors they launch);
    ``"reference"`` forces the plain version of both, for comparisons
    only.
    """
    plain = _is_plain(attn_impl)
    dev = params["embed"].device
    bs = _pool_layer(k_pool, 0)[0].shape[2]        # [N, H, B, d]
    if write_limit is None:
        write_limit = cfg.max_seq_len
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.as_tensor(positions, device=dev).to(torch.int32)
    slots = torch.as_tensor(row_slots, device=dev).to(torch.int32)
    tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    valid = torch.as_tensor(valid, device=dev).bool() & (
        pos < int(write_limit))
    safe_pos = pos.clamp(0, cfg.max_seq_len - 1).long()
    x = params["embed"][tokens] + params["pos"][safe_pos]
    page = (pos // bs).clamp(0, tables.shape[1] - 1).long()
    plan = _write_plan(tables[slots.long(), page].long(),
                       (pos % bs).long(), valid)
    ctx_lens = torch.where(valid, pos + 1, torch.zeros_like(pos))
    attend = _attend(paged_attention_mixed, paged_attention_mixed_reference,
                     plain, k_pool, v_pool, tables, slots, ctx_lens)
    logits = _layers(cfg, params, k_pool, v_pool, x, plan, attend, plain)
    return logits, k_pool, v_pool


@torch.no_grad()
def decode_step(cfg: DecoderConfig, params, k_pool, v_pool, tokens,
                block_tables, seq_lens, active,
                attn_impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode iteration over every slot (the whole-mode engine's
    step).

    ``tokens[s]`` is slot ``s``'s last sampled token, not yet written;
    its position is ``seq_lens[s]`` (the tokens written so far). The
    step writes each active slot's new K/V into its current block,
    attends over ``seq_lens + 1`` positions through
    ``kernels.paged_attention``, and returns ``(logits [slots, vocab],
    k_pool, v_pool)``. Inactive slots write nothing and their logits
    are garbage the engine ignores. Pools are updated IN PLACE, as in
    ``mixed_step``; ``attn_impl`` as there.
    """
    plain = _is_plain(attn_impl)
    dev = params["embed"].device
    bs = _pool_layer(k_pool, 0)[0].shape[2]
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.as_tensor(seq_lens, device=dev).to(torch.int32)
    active = torch.as_tensor(active, device=dev).bool()
    tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    x = params["embed"][tokens] + \
        params["pos"][pos.clamp(0, cfg.max_seq_len - 1).long()]
    page = (pos // bs).clamp(0, tables.shape[1] - 1).long()
    rows = torch.arange(tokens.shape[0], device=dev)
    plan = _write_plan(tables[rows, page].long(), (pos % bs).long(),
                       active)
    ctx_lens = torch.where(active, pos + 1, torch.zeros_like(pos))
    attend = _attend(paged_attention, paged_attention_reference, plain,
                     k_pool, v_pool, tables, ctx_lens)
    logits = _layers(cfg, params, k_pool, v_pool, x, plan, attend, plain)
    return logits, k_pool, v_pool


def _chunk_forward(cfg, params, k_pool, v_pool, tokens, tables, pos,
                   valid, plain):
    """The layers of a chunk step: ``tokens``/``pos``/``valid`` are
    ``[S, G]`` device tensors (positions int32), ``tables`` ``[S, P]``
    int32. Returns logits ``[S, G, vocab]``; pools change in place."""
    S, G = tokens.shape
    dev = tokens.device
    bs = _pool_layer(k_pool, 0)[0].shape[2]
    x = params["embed"][tokens.reshape(-1)] + params["pos"][
        pos.clamp(0, cfg.max_seq_len - 1).long().reshape(-1)]
    page = (pos // bs).clamp(0, tables.shape[1] - 1).long()
    blk = tables[torch.arange(S, device=dev)[:, None], page]    # [S, G]
    plan = _write_plan(blk.reshape(-1).long(),
                       (pos % bs).reshape(-1).long(), valid.reshape(-1))
    ctx_lens = torch.where(valid, pos + 1, torch.zeros_like(pos))
    attend = _attend(paged_attention_chunk, paged_attention_chunk_reference,
                     plain, k_pool, v_pool, tables, ctx_lens)
    logits = _layers(cfg, params, k_pool, v_pool, x, plan,
                     lambda q, l: attend(q.view(S, G, *q.shape[1:]), l),
                     plain)
    return logits.reshape(S, G, -1)


@torch.no_grad()
def decode_chunk(cfg: DecoderConfig, params, k_pool, v_pool, tokens,
                 block_tables, start_lens, q_lens, active,
                 attn_impl: Optional[str] = None,
                 write_limit: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """G tokens per slot in one call (the paged prefill with slots=1,
    and later the speculative verify lane).

    ``tokens``: [slots, G]; row g of slot s sits at absolute position
    ``start_lens[s] + g``. Rows with ``g >= q_lens[s]``, rows of
    inactive slots, and rows at positions >= ``write_limit`` (default
    ``cfg.max_seq_len``) are masked: they write no K/V and their logits
    are garbage the caller ignores. Valid rows write K/V first, then
    attend over ``position + 1`` keys through
    ``kernels.paged_attention_chunk`` — the causal intra-chunk mask
    falls out of the per-row context lengths. Returns ``(logits [slots,
    G, vocab], k_pool, v_pool)``, pools updated IN PLACE.
    """
    plain = _is_plain(attn_impl)
    dev = params["embed"].device
    if write_limit is None:
        write_limit = cfg.max_seq_len
    tokens = torch.as_tensor(tokens, device=dev).long()
    tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    start = torch.as_tensor(start_lens, device=dev).to(torch.int32)
    qn = torch.as_tensor(q_lens, device=dev).to(torch.int32)
    active = torch.as_tensor(active, device=dev).bool()
    G = tokens.shape[1]
    g_idx = torch.arange(G, device=dev, dtype=torch.int32)
    pos = start[:, None] + g_idx[None, :]                     # [S, G]
    valid = (active[:, None] & (g_idx[None, :] < qn[:, None])
             & (pos < int(write_limit)))
    logits = _chunk_forward(cfg, params, k_pool, v_pool, tokens, tables,
                            pos, valid, plain)
    return logits, k_pool, v_pool


@torch.no_grad()
def prefill(cfg: DecoderConfig, params, k_pool, v_pool, tokens,
            true_len: int, start_len: int, block_table_row,
            attn_impl: Optional[str] = None,
            write_limit: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One request's cold prompt TAIL in one call: ``decode_chunk``
    with one slot.

    ``tokens``: [rung] — the prompt minus its prefix-cache hit, padded
    up a ladder rung (pad rows write no K/V and see no keys);
    ``true_len``: the real tail length and ``start_len``: the hit
    length, both host ints (tail row i sits at absolute position
    ``start_len + i`` and attends over the hit blocks plus earlier tail
    rows, through the pool); ``block_table_row``: [max_pages] int32,
    hit blocks + fresh blocks.

    Returns ``(logits_last [vocab], k_pool, v_pool)``: the prediction
    after the final real prompt token; pools updated IN PLACE.
    """
    plain = _is_plain(attn_impl)
    dev = params["embed"].device
    if write_limit is None:
        write_limit = cfg.max_seq_len
    tokens = torch.as_tensor(tokens, device=dev).long()
    row = torch.as_tensor(block_table_row, device=dev).to(torch.int32)
    R = tokens.shape[0]
    true_len, start_len = int(true_len), int(start_len)
    # host ints: positions and validity are built on the device from
    # them, with nothing copied to or read back from the card
    g_idx = torch.arange(R, device=dev, dtype=torch.int32)
    pos = (g_idx + start_len)[None, :]
    valid = ((g_idx < true_len) & (pos[0] < int(write_limit)))[None, :]
    logits = _chunk_forward(cfg, params, k_pool, v_pool, tokens[None, :],
                            row[None, :], pos, valid, plain)
    last = min(max(true_len - 1, 0), R - 1)
    return logits[0, last], k_pool, v_pool


@torch.no_grad()
def dense_prefill(cfg: DecoderConfig, params, tokens, true_len):
    """Prompt forward with a dense per-request KV cache (the JAX
    package's ``dense_prefill``, in plain PyTorch: it has no kernel
    there either). Returns ``(k_cache, v_cache)`` shaped ``[n_layers,
    heads, max_seq_len, head_dim]`` holding K/V for positions <
    ``true_len`` (garbage elsewhere). The engine's KV calibration probe
    runs it."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    R = tokens.shape[0]
    positions = torch.arange(R, device=dev)
    real = positions < int(true_len)
    x = params["embed"][tokens] + \
        params["pos"][positions.clamp(0, cfg.max_seq_len - 1)]
    shape = (cfg.n_layers, cfg.n_heads, cfg.max_seq_len, cfg.head_dim)
    kc = torch.zeros(shape, dtype=torch.float32, device=dev)
    vc = torch.zeros_like(kc)
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    causal = (positions[None, :] <= positions[:, None]) & real[None, :]
    for l in range(cfg.n_layers):
        q, k, v = _qkv(cfg, params, l, x)
        kc[l, :, :R] = k.transpose(0, 1)
        vc[l, :, :R] = v.transpose(0, 1)
        s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
        s = torch.where(causal[None], s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("hqk,khd->qhd", p, v.float())
        x = _proj(params, f"l{l}_wo", attn.reshape(R, -1), x)
        x = x + _mlp(cfg, params, l, x)
    return kc, vc
