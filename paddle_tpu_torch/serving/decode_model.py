"""A causal decoder LM over the block-paged KV cache, in PyTorch.

The port of the JAX package's ``serving/decode_model.py`` for the
chunked-prefill serving path: the same pre-LN, learned-position,
tied-head, GELU decoder, with parameters as a plain dict of tensors in
the JAX layout (``x @ W``; ``wqkv`` is ``[D, 3*H*hd]``), so
``convert.params_from_jax`` copies weights across without transposing.

``mixed_step`` is the one entry of the serving loop: T independent
(slot, position, token) rows per call — decode rows and prompt-chunk
rows packed together — whose shapes never depend on batch composition.
Every dense op acts per row and attention reads only the row's own
context, so a request's tokens are the same solo or in a churning
batch. Attention goes through ``kernels.paged_attention_mixed`` (the
CUDA kernel for tensors on the card, its plain version on the CPU); the
rest is plain PyTorch, as the JAX package left it to XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention_mixed, paged_attention_mixed_reference)
from paddle_tpu_torch.serving.kvcache import KVCacheConfig

__all__ = ["DecoderConfig", "init_params", "param_bytes", "mixed_step"]

_LN_EPS = 1e-5


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


def _ln(x, s, b):
    """Layernorm with the biased variance and eps 1e-5, as the JAX
    package's ``_ln``."""
    return F.layer_norm(x, (x.shape[-1],), s, b, _LN_EPS)


def _qkv(cfg, params, l, x):
    """[n, D] -> q, k, v each [n, H, head_dim]."""
    h = _ln(x, params[f"l{l}_ln1_s"], params[f"l{l}_ln1_b"])
    qkv = torch.addmm(params[f"l{l}_bqkv"], h, params[f"l{l}_wqkv"])
    hd = cfg.n_heads * cfg.head_dim
    shape = (-1, cfg.n_heads, cfg.head_dim)
    return (qkv[:, :hd].reshape(shape), qkv[:, hd:2 * hd].reshape(shape),
            qkv[:, 2 * hd:].reshape(shape))


def _mlp(cfg, params, l, x):
    h = _ln(x, params[f"l{l}_ln2_s"], params[f"l{l}_ln2_b"])
    # jax.nn.gelu defaults to the tanh approximation
    a = F.gelu(torch.addmm(params[f"l{l}_b1"], h, params[f"l{l}_w1"]),
               approximate="tanh")
    return torch.addmm(params[f"l{l}_b2"], a, params[f"l{l}_w2"])


def _logits(cfg, params, x):
    return _ln(x, params["lnf_s"], params["lnf_b"]) @ params["embed"].T


def _write_plan(blk, off, valid):
    """Where each row's K/V write lands, decided once per step.

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


def _scatter_kv(pool, l, plan, rows):
    """Write per-row K or V heads ``rows [n, H, d]`` into pool layer
    ``l`` IN PLACE, following ``_write_plan``."""
    blk, off, src_row, any_valid = plan
    pl = pool[l]                                   # [N, H, B, d] view
    pl[blk, :, off, :] = torch.where(any_valid, rows[src_row].to(pl.dtype),
                                     pl[blk, :, off, :])


def _attend_mixed(q, k_pool, v_pool, l, block_tables, row_slots,
                  ctx_lens, attn_impl):
    if attn_impl is None:
        return paged_attention_mixed(q, k_pool[l], v_pool[l],
                                     block_tables, row_slots, ctx_lens)
    if attn_impl == "reference":
        return paged_attention_mixed_reference(q, k_pool[l], v_pool[l],
                                               block_tables, row_slots,
                                               ctx_lens)
    raise ValueError(f"attn_impl must be None (the kernel on CUDA, its "
                     f"plain version on CPU) or 'reference', got "
                     f"{attn_impl!r}")


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

    Unlike the JAX version, ``k_pool``/``v_pool`` are updated IN PLACE;
    they are also returned, so the ``(logits [T, vocab], k_pool,
    v_pool)`` signature stays. Row arrays may be tensors or numpy
    arrays; they are moved to the pools' device. ``attn_impl=None``
    takes ``paged_attention_mixed`` (the kernel for CUDA pools);
    ``"reference"`` forces the plain version, for comparisons only.
    """
    dev = k_pool.device
    bs = k_pool.shape[3]
    if write_limit is None:
        write_limit = cfg.max_seq_len
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.as_tensor(positions, device=dev).to(torch.int32)
    slots = torch.as_tensor(row_slots, device=dev).to(torch.int32)
    tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    valid = torch.as_tensor(valid, device=dev).bool() & (
        pos < int(write_limit))
    T = tokens.shape[0]
    safe_pos = pos.clamp(0, cfg.max_seq_len - 1).long()
    x = params["embed"][tokens] + params["pos"][safe_pos]
    page = (pos // bs).clamp(0, tables.shape[1] - 1).long()
    plan = _write_plan(tables[slots.long(), page].long(),
                       (pos % bs).long(), valid)
    ctx_lens = torch.where(valid, pos + 1, torch.zeros_like(pos))
    for l in range(cfg.n_layers):
        q, k, v = _qkv(cfg, params, l, x)
        _scatter_kv(k_pool, l, plan, k)
        _scatter_kv(v_pool, l, plan, v)
        attn = _attend_mixed(q.contiguous(), k_pool, v_pool, l, tables,
                             slots, ctx_lens, attn_impl)
        x = torch.addmm(x, attn.reshape(T, -1), params[f"l{l}_wo"])
        x = x + _mlp(cfg, params, l, x)
    return _logits(cfg, params, x), k_pool, v_pool
