"""Functional transformer LM: the port of the JAX package's
``models/transformer.py`` on one card.

Pure functions over a params tree, the JAX layout unchanged: ``{"embed"
[V, D], "pos_embed" [max_len, D], "out_ln_scale" [D], "layers": [{
"ln1_scale", "ln2_scale", "wqkv" [D, 3D], "wo" [D, D], "w1" [D, F],
"w2" [F, D]}, ...]}``, every leaf fp32 (master weights), ``x @ W`` for
every projection, the LM head tied to ``embed``. Compute runs in
``cfg.dtype`` (bf16 by default): each block casts its weights, the RMS
norms take their statistics in fp32, and the logits are upcast to fp32
for the loss.

``attn_impl="flash"`` runs attention through ``kernels.flash_attention``
(hand-written forward and backward kernels on the card); ``"xla"`` is the
plain masked softmax (fp32 softmax, ``-1e9`` mask). Training is
``make_train_step``: autograd over ``loss_fn`` and an in-place SGD +
momentum update (the JAX step donates its state; here the tensors of
``params`` and ``velocity`` are updated where they are).

Not on one card yet (they raise ``NotImplementedError`` naming ROADMAP
A9, the port's ``parallel/``): the switch-MoE FFN (``moe_experts > 0``),
ring attention (``attn_impl="ring"``), a device ``mesh``, and the
sharded, multislice and pipeline train-step builders.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from paddle_tpu_torch.ops.loss import nll_from_logits

__all__ = ["TransformerConfig", "forward", "init_params", "loss_fn",
           "make_kstep_train_step", "make_multislice_train_step",
           "make_pipeline_train_step", "make_sharded_train_step",
           "make_train_step", "param_specs", "pipeline_loss_fn",
           "sgd_momentum_step", "stack_layer_params",
           "stacked_param_specs"]

_A9 = "needs the port's parallel/ package (ROADMAP A9)"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # "xla": plain masked-softmax attention; "flash": the flash-attention
    # kernels (kernels.flash_attention); "flash_reference": the same
    # function through their plain versions on any device (the oracle the
    # kernels are held against on the card); "ring" waits for ROADMAP A9
    attn_impl: str = "xla"
    # > 0 replaces the dense FFN with a switch-MoE (ROADMAP A9)
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    # recompute each block in the backward pass (torch.utils.checkpoint,
    # as jax.checkpoint): activation memory O(1) blocks for ~1/3 more
    # FLOPs. With attn_impl="flash" the forward kernel then runs twice
    # per block and step.
    remat: bool = False

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def _check_supported(cfg: TransformerConfig, mesh=None):
    if cfg.moe_experts > 0:
        raise NotImplementedError(f"moe_experts > 0 (switch-MoE FFN) {_A9}")
    if cfg.attn_impl == "ring":
        raise NotImplementedError(f"attn_impl='ring' (ring attention) {_A9}")
    if mesh is not None:
        raise NotImplementedError(f"a device mesh {_A9}")


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random fp32 params from a ``torch.Generator`` on ``device`` (the
    card by default; ``"cpu"`` when asked for). Same tree, shapes and
    scales as the JAX package's ``init_params``; the numbers differ
    (another generator), so tests copy weights across with
    ``convert.params_from_jax``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    D, Fd, V = cfg.d_model, cfg.d_ff, cfg.vocab_size

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    def ones():
        return torch.ones((D,), device=dev, dtype=torch.float32)

    scale = 1.0 / math.sqrt(D)
    params: Dict[str, Any] = {
        "embed": normal((V, D), scale),
        "pos_embed": normal((cfg.max_len, D), scale),
        "out_ln_scale": ones(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1_scale": ones(),
            "ln2_scale": ones(),
            "wqkv": normal((D, 3 * D), scale),
            "wo": normal((D, D), scale),
            "w1": normal((D, Fd), scale),
            "w2": normal((Fd, D), 1.0 / math.sqrt(Fd)),
        })
    return params


def _rms_norm(x, scale):
    """``x * rsqrt(mean(x^2) + 1e-6)`` in fp32, cast to x's dtype, THEN
    times the scale in x's dtype (the JAX order)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _sdpa(q, k, v, cfg: TransformerConfig, mesh=None):
    """Causal scaled-dot-product attention on ``[B, H, T, hd]``."""
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True)
    if cfg.attn_impl == "flash_reference":
        return flash_attention_reference(q, k, v, causal=True)
    if cfg.attn_impl != "xla":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; expected "
                         "'xla', 'flash', 'flash_reference', or 'ring'")
    T = q.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(cfg.head_dim)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    logits = torch.where(mask, logits.float(), -1e9)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _attention(x, wqkv, wo, cfg: TransformerConfig, mesh=None):
    B, T, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    # the JAX split into q | k | v thirds and heads, as one copy into
    # [3, B, H, T, hd] (each of q, k, v contiguous, as the kernels take)
    qkv = (x @ wqkv).view(B, T, 3, H, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.contiguous().unbind(0)
    out = _sdpa(q, k, v, cfg, mesh)
    return out.transpose(1, 2).reshape(B, T, D) @ wo


def _block(h, lp, cfg: TransformerConfig, mesh=None):
    """One transformer block (dense FFN: its MoE load-balance loss, which
    JAX returns beside h, is zero)."""
    dt = cfg.dtype
    a = _rms_norm(h, lp["ln1_scale"])
    h = h + _attention(a, lp["wqkv"].to(dt), lp["wo"].to(dt), cfg, mesh)
    m = _rms_norm(h, lp["ln2_scale"])
    # jax.nn.gelu defaults to the tanh approximation
    m = F.gelu(m @ lp["w1"].to(dt), approximate="tanh") @ lp["w2"].to(dt)
    return h + m


def _head(x, params, cfg: TransformerConfig):
    """Final norm + tied-embedding projection in ``cfg.dtype``, then the
    logits upcast to fp32."""
    x = _rms_norm(x, params["out_ln_scale"])
    return (x @ params["embed"].to(cfg.dtype).T).float()


def _nll(logits, targets):
    return torch.mean(nll_from_logits(logits, targets))


def forward(params, tokens, cfg: TransformerConfig, mesh=None,
            return_aux: bool = False):
    """tokens ``[B, T]`` int (on the params' device) -> fp32 logits
    ``[B, T, V]`` (and, with return_aux, the summed MoE aux loss: zero
    for the dense FFN)."""
    _check_supported(cfg, mesh)
    _B, T = tokens.shape
    dt = cfg.dtype
    tokens = tokens.long()
    x = params["embed"].to(dt)[tokens] + params["pos_embed"].to(dt)[:T][None]
    for lp in params["layers"]:
        if cfg.remat:
            x = checkpoint(_block, x, lp, cfg, use_reentrant=False)
        else:
            x = _block(x, lp, cfg)
    logits = _head(x, params, cfg)
    if not return_aux:
        return logits
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, tokens, targets, cfg: TransformerConfig, mesh=None,
            aux_weight: float = 0.01):
    """Mean NLL + (for MoE configs) the router load-balance aux loss."""
    logits, aux = forward(params, tokens, cfg, mesh, return_aux=True)
    return _nll(logits, targets) + aux_weight * aux


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params-shaped tree, dict keys sorted (the JAX
    flattening order)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure around ``leaves`` (in ``_leaves`` order)."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            built = {key: walk(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return [walk(item) for item in node]
        return next(it)

    return walk(tree)


def _sgd_momentum(ps, vs, gs, lr, mu):
    with torch.no_grad():
        torch._foreach_mul_(vs, mu)
        torch._foreach_add_(vs, gs)
        torch._foreach_add_(ps, vs, alpha=-lr)


def sgd_momentum_step(params, velocity, grads, lr=0.1, mu=0.9):
    """``v = mu * v + g; p = p - lr * v`` over the trees, in place (the
    JAX step donates these buffers); returns ``(params, velocity)``."""
    _sgd_momentum(_leaves(params), _leaves(velocity), _leaves(grads), lr, mu)
    return params, velocity


def make_train_step(cfg: TransformerConfig, mesh=None, lr: float = 0.1):
    """``step(params, velocity, tokens, targets) -> (params, velocity,
    loss)``: the loss and its gradient in every param, then the SGD +
    momentum update in place. The loss is a 0-d fp32 tensor on the
    card, not read back."""
    _check_supported(cfg, mesh)

    def step(params, velocity, tokens, targets):
        leaves = _leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(_rebuild(params, live), tokens, targets, cfg)
            grads = torch.autograd.grad(loss, live)
        _sgd_momentum(leaves, _leaves(velocity), list(grads), lr, 0.9)
        return params, velocity, loss.detach()

    return step


def make_kstep_train_step(cfg: TransformerConfig, mesh=None,
                          lr: float = 0.1):
    """K training steps per call over stacked ``[K, B, T]`` batches:
    ``fn(params, velocity, toks_k, tgts_k) -> (params, velocity,
    losses[K])``, the same as K sequential ``make_train_step`` steps.
    JAX runs them as one ``lax.scan``; here they are a Python loop (the
    captured loop is ROADMAP A2's)."""
    step = make_train_step(cfg, mesh, lr)

    def kstep(params, velocity, toks_k, tgts_k):
        losses = []
        for i in range(toks_k.shape[0]):
            params, velocity, loss = step(params, velocity, toks_k[i],
                                          tgts_k[i])
            losses.append(loss)
        return params, velocity, torch.stack(losses)

    return kstep


def param_specs(cfg: TransformerConfig):
    raise NotImplementedError(f"param_specs (tp/ep sharding specs) {_A9}")


def make_sharded_train_step(mesh, cfg: TransformerConfig, lr: float = 0.1):
    raise NotImplementedError(f"make_sharded_train_step {_A9}")


def make_multislice_train_step(mesh, cfg: TransformerConfig,
                               lr: float = 0.1):
    raise NotImplementedError(f"make_multislice_train_step {_A9}")


def stack_layer_params(params):
    raise NotImplementedError(f"stack_layer_params (pipeline layout) {_A9}")


def stacked_param_specs(cfg: TransformerConfig):
    raise NotImplementedError(f"stacked_param_specs {_A9}")


def pipeline_loss_fn(stacked, tokens, targets, cfg: TransformerConfig,
                     mesh, n_micro: int):
    raise NotImplementedError(f"pipeline_loss_fn {_A9}")


def make_pipeline_train_step(mesh, cfg: TransformerConfig, n_micro: int = 4,
                             lr: float = 0.1):
    raise NotImplementedError(f"make_pipeline_train_step {_A9}")
