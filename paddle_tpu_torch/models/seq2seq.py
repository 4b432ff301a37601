"""Seq2seq NMT with attention — encoder-decoder GRU + Bahdanau attention:
the port of the JAX package's ``models/seq2seq.py`` on one card.

Pure functions over a flat params dict, the JAX layout unchanged
(``x @ W``, gates u | r | c~), every leaf fp32 (master weights).
Compute runs in ``cfg.dtype``: ``_compute_cast`` casts the float params
once per call, so gradients reach the fp32 masters through the cast.

The encoder is a bidirectional GRU over pre-projected gates. Where the
JAX engagement predicate holds (``ops/rnn.py:_fused_ok``: fp32/bf16,
hidden % 128 == 0, batch % 8 == 0) its recurrence is
``kernels.fused_rnn.gru_scan``: the hand-written forward (B12) and
backward (B13) kernels on the card, their plain versions on the CPU.
Elsewhere it is a Python loop with the same math in the compute dtype
(the JAX ``lax.scan`` route). Training is teacher-forced
(``decode_train_loss``) with Adam (``make_train_step``); the decoder
loop is a Python loop over target steps, each step checkpointed
(``torch.utils.checkpoint``, non-reentrant) when ``remat`` is on.
Generation is ``decode.beam_search``.

Nothing in a train step or a search reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import decode
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.kernels.fused_rnn import gru_scan
from paddle_tpu_torch.ops.loss import nll_from_logits
from paddle_tpu_torch.ops.rnn import _fused_ok, _lens_from_mask, _reverse_valid

__all__ = ["Seq2SeqConfig", "init_params", "encode", "decode_train_loss",
           "make_train_step", "generate"]


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    src_vocab: int = 8000
    tgt_vocab: int = 8000
    emb_dim: int = 256
    hidden_dim: int = 256
    bos_id: int = 0
    eos_id: int = 1
    beam_size: int = 4
    max_gen_len: int = 32
    # compute dtype (master weights stay fp32; grads come back fp32
    # through the cast)
    dtype: torch.dtype = torch.float32
    # recompute each decoder step in the backward pass. None = auto: on
    # for fp32, off for bf16 (the JAX default)
    remat: Any = None


def _compute_cast(params, dtype):
    """Cast float params to the compute dtype (no-op for fp32)."""
    if dtype == torch.float32:
        return params
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def init_params(cfg: Seq2SeqConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random fp32 params from a ``torch.Generator`` on ``device`` (the
    card by default; ``"cpu"`` when asked for). Same keys, shapes and
    scales (Glorot-style normal, zero biases) as the JAX package's
    ``init_params``; the numbers differ (another generator), so tests copy
    weights across with ``convert.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    E, H = cfg.emb_dim, cfg.hidden_dim

    def glorot(*shape):
        fan = sum(shape[:2]) if len(shape) > 1 else shape[0]
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * math.sqrt(2.0 / fan)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        "src_emb": glorot(cfg.src_vocab, E),
        "tgt_emb": glorot(cfg.tgt_vocab, E),
        # bidirectional encoder GRU (fwd + bwd), gates [u, r, c]
        "enc_fwd_w": glorot(E + H, 3 * H),
        "enc_fwd_b": zeros(3 * H),
        "enc_bwd_w": glorot(E + H, 3 * H),
        "enc_bwd_b": zeros(3 * H),
        # decoder init projection from the final backward state
        "dec_init_w": glorot(H, H),
        # Bahdanau attention: score = v . tanh(Wh h_dec + We h_enc)
        "att_dec_w": glorot(H, H),
        "att_enc_w": glorot(2 * H, H),
        "att_v": glorot(H),
        # decoder GRU over [emb ; context]
        "dec_w": glorot(E + 2 * H + H, 3 * H),
        "dec_b": zeros(3 * H),
        # readout
        "out_w": glorot(H, cfg.tgt_vocab),
        "out_b": zeros(cfg.tgt_vocab),
    }


def _gru_cell(x, h, w, b):
    """Gate order u (update), r (reset), c (candidate)."""
    H = h.shape[-1]
    xh = torch.cat([x, h], dim=-1)
    gates = xh @ w[:, :2 * H] + b[:2 * H]
    u = torch.sigmoid(gates[..., :H])
    r = torch.sigmoid(gates[..., H:])
    xrh = torch.cat([x, r * h], dim=-1)
    c = torch.tanh(xrh @ w[:, 2 * H:] + b[2 * H:])
    return u * h + (1.0 - u) * c


def _flip_valid(x, src_mask):
    """Flip each row's valid (left-aligned) prefix along time axis 1,
    keeping left alignment."""
    return _reverse_valid(x, src_mask, x.shape[1])


def _use_fused_gru(B, H, dtype):
    return _fused_ok(B, H, dtype, std_acts=True)


def _gru_run(xg, wh, src_mask, h0):
    """Masked GRU over pre-projected input gates xg [B, T, 3H] with
    recurrent weights wh [H, 3H]; returns (hs [B, T, H] with state
    carried through masked steps, final h [B, H]).

    Where the predicate holds, the fused kernels (``gru_scan``);
    elsewhere a loop with identical math in xg's dtype."""
    B, T, _ = xg.shape
    H = wh.shape[0]
    if _use_fused_gru(B, H, xg.dtype):
        lens = _lens_from_mask(src_mask)
        hs = gru_scan(xg.transpose(0, 1).contiguous(),
                      wh.to(xg.dtype).contiguous(), lens, h0)
        hs = hs.transpose(0, 1)
    else:
        h = h0
        out = []
        for t in range(T):
            x_t, mk = xg[:, t], src_mask[:, t, None]
            g_ur = x_t[:, :2 * H] + h @ wh[:, :2 * H]
            u = torch.sigmoid(g_ur[:, :H])
            r = torch.sigmoid(g_ur[:, H:])
            c = torch.tanh(x_t[:, 2 * H:] + (r * h) @ wh[:, 2 * H:])
            h_new = u * h + (1.0 - u) * c
            h = torch.where(mk > 0, h_new, h)
            out.append(h)
        hs = torch.stack(out, dim=1)
    # final state = the last VALID step's h (carried through the tail)
    return hs, hs[:, -1]


def encode(params, src_tokens, src_mask, cfg: Seq2SeqConfig):
    """Bidirectional GRU encoder over padded [B, Ts] tokens. The input
    gates of all steps are one matmul per direction outside the
    recurrence. Returns (enc_out [B, Ts, 2H], dec_h0 [B, H], att_keys
    [B, Ts, H])."""
    emb = params["src_emb"][src_tokens.long()]      # [B, T, E]
    E = emb.shape[-1]
    m = src_mask[..., None].to(emb.dtype)            # [B, T, 1]
    B = emb.shape[0]
    H = cfg.hidden_dim
    h0 = torch.zeros((B, H), dtype=emb.dtype, device=emb.device)

    def run(w, b, xs):
        xg = xs @ w[:E] + b                          # [B, T, 3H]
        return _gru_run(xg, w[E:], src_mask, h0)

    fwd, _ = run(params["enc_fwd_w"], params["enc_fwd_b"], emb)
    emb_rev = _flip_valid(emb, src_mask)
    bwd_rev, h_bwd = run(params["enc_bwd_w"], params["enc_bwd_b"], emb_rev)
    bwd = _flip_valid(bwd_rev, src_mask)
    enc = torch.cat([fwd, bwd], dim=-1) * m          # [B, T, 2H], pad zeroed
    dec_h0 = torch.tanh(h_bwd @ params["dec_init_w"])
    att_keys = enc @ params["att_enc_w"]             # [B, T, H]
    return enc, dec_h0, att_keys


def _attend(h_dec, enc, att_keys, src_mask, params):
    """Bahdanau additive attention -> context [B, 2H], weights [B, T]."""
    q = h_dec @ params["att_dec_w"]                  # [B, H]
    e = torch.tanh(att_keys + q[:, None, :]) @ params["att_v"]  # [B, T]
    e = torch.where(src_mask > 0, e, -1e9)
    a = torch.softmax(e, dim=-1)
    ctx = torch.einsum("bt,bth->bh", a, enc)
    return ctx, a


def _dec_step(params, h, tok_emb, enc, att_keys, src_mask):
    ctx, _ = _attend(h, enc, att_keys, src_mask, params)
    x = torch.cat([tok_emb, ctx], dim=-1)
    h = _gru_cell(x, h, params["dec_w"], params["dec_b"])
    logits = h @ params["out_w"] + params["out_b"]
    return h, logits


def decode_train_loss(params, src_tokens, src_mask, tgt_in, tgt_out,
                      tgt_mask, cfg: Seq2SeqConfig):
    """Teacher-forced cross-entropy, masked mean over target tokens: a
    0-d fp32 tensor on the params' device. The embedding's share of the
    decoder gates is one matmul for all steps, the loop carries only the
    attention and the [B, H] recurrent matmuls, and the [H, V] readout
    runs once over the collected states."""
    params = _compute_cast(params, cfg.dtype)
    enc, h, att_keys = encode(params, src_tokens, src_mask, cfg)
    emb = params["tgt_emb"][tgt_in.long()]           # [B, T, E]
    E, H = cfg.emb_dim, cfg.hidden_dim
    w, b = params["dec_w"], params["dec_b"]
    w_e, w_c, w_h = w[:E], w[E:E + 2 * H], w[E + 2 * H:]
    xg_e = emb @ w_e + b                             # [B, T, 3H]

    def step(h, xg_t):
        ctx, _ = _attend(h, enc, att_keys, src_mask, params)
        xg = xg_t + ctx @ w_c                        # full x-contribution
        g_ur = xg[:, :2 * H] + h @ w_h[:, :2 * H]
        u = torch.sigmoid(g_ur[:, :H])
        r = torch.sigmoid(g_ur[:, H:])
        c = torch.tanh(xg[:, 2 * H:] + (r * h) @ w_h[:, 2 * H:])
        return u * h + (1.0 - u) * c

    use_remat = (cfg.dtype == torch.float32) if cfg.remat is None \
        else cfg.remat
    hs = []
    for t in range(xg_e.shape[1]):
        if use_remat:
            # (the step draws no random numbers: no RNG state to keep)
            h = checkpoint(step, h, xg_e[:, t], use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = step(h, xg_e[:, t])
        hs.append(h)
    hs = torch.stack(hs, dim=1)                      # [B, T, H]
    logits = hs @ params["out_w"] + params["out_b"]  # [B, T, V]
    # loss math in fp32
    nll = nll_from_logits(logits.float(), tgt_out)
    return torch.sum(nll * tgt_mask) / torch.clamp(torch.sum(tgt_mask),
                                                   min=1.0)


class _Adam:
    """Adam over the flat params dict (the JAX ``_Adam``, same update,
    same op order). The step count ``t`` is a 0-d int32 tensor on the
    device and the bias corrections ``b1 ** t`` are fp32 powers there, as
    in JAX; nothing is read back."""

    def __init__(self, lr=0.001, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        p0 = next(iter(params.values()))
        return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()},
                "t": torch.zeros((), dtype=torch.int32, device=p0.device)}

    def update(self, grads, state, params):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        b1t, b2t = torch.pow(self.b1, tf), torch.pow(self.b2, tf)
        m = {k: self.b1 * state["m"][k] + (1 - self.b1) * grads[k]
             for k in params}
        v = {k: self.b2 * state["v"][k] + (1 - self.b2) * grads[k] * grads[k]
             for k in params}
        new_params = {
            k: params[k] - self.lr * (m[k] / (1 - b1t))
            / (torch.sqrt(v[k] / (1 - b2t)) + self.eps) for k in params}
        return new_params, {"m": m, "v": v, "t": t}


def make_train_step(cfg: Seq2SeqConfig, lr=0.001):
    """Adam train step over the padded batch: returns ``(opt, step)``
    with ``step(params, opt_state, batch) -> (params, opt_state, loss)``
    (new dicts, as the JAX step returns new pytrees; the loss is a 0-d
    fp32 tensor on the card, not read back). ``batch`` holds ``src``,
    ``src_mask``, ``tgt_in``, ``tgt_out``, ``tgt_mask`` on the params'
    device."""
    opt = _Adam(lr)

    def step(params, opt_state, batch):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = decode_train_loss(
                live, batch["src"], batch["src_mask"], batch["tgt_in"],
                batch["tgt_out"], batch["tgt_mask"], cfg)
            grads = dict(zip(live, torch.autograd.grad(
                loss, list(live.values()))))
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return opt, step


@torch.no_grad()
def generate(params, src_tokens, src_mask, cfg: Seq2SeqConfig,
             beam_size=None, max_len=None, length_penalty=0.0,
             score_hook=None):
    """Beam-search translation of padded [B, Ts] sources (on the params'
    device). ``score_hook``: optional per-step candidate-score adjuster
    (see ``decode.beam_search``)."""
    K = beam_size or cfg.beam_size
    T = max_len or cfg.max_gen_len
    B = src_tokens.shape[0]
    params = _compute_cast(params, cfg.dtype)
    enc, h0, att_keys = encode(params, src_tokens, src_mask, cfg)

    def rep(x):
        """Each batch row K times in a row (``jnp.repeat``; an expand, so
        nothing is read back)."""
        return x.unsqueeze(1).expand(x.shape[0], K, *x.shape[1:]).reshape(
            x.shape[0] * K, *x.shape[1:])

    # enc/keys/mask are identical across a batch element's beams, so they
    # live in the closure, not in the re-gathered state
    enc_r, keys_r, mask_r = rep(enc), rep(att_keys), rep(src_mask)

    def step_fn(state, tokens):
        emb = params["tgt_emb"][tokens.long()]
        h, logits = _dec_step(params, state["h"], emb, enc_r, keys_r,
                              mask_r)
        # beam scores accumulate across steps: keep them fp32 even when
        # the decoder computes in bf16
        return torch.log_softmax(logits.float(), dim=-1), {"h": h}

    return decode.beam_search(step_fn, {"h": rep(h0)}, batch_size=B,
                              beam_size=K, max_len=T, bos_id=cfg.bos_id,
                              eos_id=cfg.eos_id, vocab_size=cfg.tgt_vocab,
                              length_penalty=length_penalty,
                              score_hook=score_hook)
