"""Flash attention, forward and backward: tiled online-softmax attention
that never holds the ``[Tq, Tk]`` probabilities in device memory in
either direction.

The port of the JAX package's ``kernels/flash_attention.py``. For ``q
[B, H, Tq, d]`` and ``k, v [B, H, Tk, d]`` (float32 or bfloat16):

- the forward returns ``out`` in q's dtype and the logsumexp ``lse
  [B, H, Tq]`` in fp32; a row that sees no key gets ``out = 0`` and
  ``lse = NEG_INF``;
- the backward takes ``delta = rowsum(do * out)`` in fp32 (computed
  before the kernels, as JAX does) and the saved ``lse``, recomputes
  ``p = exp(s - lse)``, and gives ``dq`` (one pass over the keys per q
  tile) and ``dk, dv`` (one pass over the queries per key tile).

The causal mask is position-based and top-left aligned (``kpos <=
qpos``), also when ``Tq != Tk``. Scores, softmax statistics and every
accumulator are fp32.

``flash_attention`` is differentiable through a ``torch.autograd
.Function`` that saves ``(q, k, v, out, lse)``. On CUDA tensors each of
``flash_attention_fwd``, ``flash_attention_dq`` and
``flash_attention_dkv`` launches its hand-written sm_90a kernel
(``csrc/flash_attention.cu``, on the tensor cores: fp32 as 3xTF32 on
``mma.sync``, bf16 on ``wgmma``; each instantiated for head_dim <= 64
and <= 128) and raises on anything it does not take;
on CPU tensors it runs its plain version, which follows the Pallas
kernel body's math over one tile spanning the whole sequence. The
TPU wrapper's ``block_q``/``block_k``/``interpret`` are tile hints for
the TPU; the CUDA kernels choose their own tiles, so they are not
arguments here.
"""
from __future__ import annotations

import ctypes
import math
import numbers

import torch

from paddle_tpu_torch import kernels as _kernels

__all__ = ["MAX_HEAD_DIM", "NEG_INF", "flash_attention",
           "flash_attention_dkv", "flash_attention_dkv_reference",
           "flash_attention_dq", "flash_attention_dq_reference",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "flash_attention_reference"]

NEG_INF = -1e30  # finite stand-in for -inf: keeps exp() NaN-free
MAX_HEAD_DIM = 128  # the CUDA kernels' widest head_dim capacity
_LANES = {torch.float32: 0, torch.bfloat16: 1}
# C entry -> (pointer arguments, int arguments): each takes the lane, the
# pointers, the ints (BH, Tq, Tk, d, causal), the scale and the stream
_ENTRIES = {"flash_attention_fwd": (5, 5), "flash_attention_dq": (7, 5),
            "flash_attention_dkv": (8, 5)}
_entries = {}


def _cuda_entry(name):
    """A kernel's C entry, built and bound on first use."""
    fn = _entries.get(name)
    if fn is None:
        from paddle_tpu_torch.kernels import _build
        n_ptr, n_int = _ENTRIES[name]
        fn = getattr(_build.load("flash_attention"), name)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be [B, H, Tq, d] and k, v [B, H, Tk, d]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (q.shape[0], q.shape[1], q.shape[3]) != (k.shape[0], k.shape[1],
                                                k.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head_dim")


def _check_cuda(q, tensors, stats=()):
    """What the CUDA kernels take: every tensor on q's card and
    contiguous; q/k/v (and do) all float32 or all bfloat16; fp32
    ``lse``/``delta``; head_dim <= 128, and for bfloat16 a multiple of 8
    with 16-byte aligned tensors. Returns the lane id. The widths the
    reference takes beyond these are ROADMAP C4."""
    lane = _LANES.get(q.dtype)
    for name, x in tuple(tensors) + tuple(stats):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in tensors:
        if x.dtype != q.dtype or lane is None:
            raise TypeError(f"no CUDA kernel lane for {name} {x.dtype} with "
                            f"q {q.dtype}: it takes all float32 or all "
                            "bfloat16 (ROADMAP C4)")
    for name, x in stats:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_HEAD_DIM} is not "
                         "supported by the CUDA kernels (ROADMAP C4)")
    if q.dtype == torch.bfloat16:
        # the tensor-core lane moves 8 bf16 (16 bytes) per load
        if q.shape[-1] % 8:
            raise ValueError(f"head_dim {q.shape[-1]} is not a multiple of 8, "
                             "which the bfloat16 kernels need (ROADMAP C4)")
        for name, x in tensors:
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    return lane


def _launch(entry, q, k, pointers, causal, sm_scale):
    """Launch ``entry`` on q's current stream; raise on a CUDA error and
    count the launch."""
    B, H, Tq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _cuda_entry(entry)(
            _LANES[q.dtype], *[x.data_ptr() for x in pointers], B * H, Tq,
            k.shape[2], d, int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    _kernels.LAUNCHES[entry] += 1


def _device_kind(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    return q.device.type


def _scores(q, k, causal, sm_scale):
    """fp32 ``q k^T * sm_scale`` and the mask (``kpos < Tk`` holds by
    construction; top-left causal ``kpos <= qpos``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    Tq, Tk = q.shape[2], k.shape[2]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    return s, mask


def flash_attention_fwd_reference(q, k, v, causal, sm_scale):
    """Plain version of the forward kernel (``_fwd_kernel``) over one tile
    spanning all keys: ``(out in q's dtype, lse fp32 [B, H, Tq])``."""
    B, H, Tq, d = q.shape
    if k.shape[2] == 0:               # no key tile: the l == 0 rule
        return (torch.zeros_like(q),
                torch.full((B, H, Tq), NEG_INF, dtype=torch.float32,
                           device=q.device))
    s, mask = _scores(q, k, causal, sm_scale)
    s = torch.where(mask, s, NEG_INF)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v.float())
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = (acc / safe_l).to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(safe_l))
    return out, lse[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale):
    """The backward kernels' shared recomputation: ``p = exp(s - lse)``
    and ``ds = p * (dp - delta) * sm_scale``, fp32."""
    s, mask = _scores(q, k, causal, sm_scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, ds


def flash_attention_dq_reference(q, k, v, do, lse, delta, causal,
                                 sm_scale):
    """Plain version of ``_dq_kernel``: ``dq = ds @ k`` in q's dtype."""
    _p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, causal,
                                  sm_scale):
    """Plain version of ``_dkv_kernel``: ``(dk = ds^T @ q, dv = p^T @
    do)`` in k's and v's dtypes."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd(q, k, v, causal, sm_scale):
    """The forward: ``(out, lse)``. CUDA tensors launch the kernel
    (adding one to ``kernels.LAUNCHES["flash_attention_fwd"]``) or
    raise; CPU tensors take the plain version."""
    _check_shapes(q, k, v)
    if _device_kind(q) == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, sm_scale)
    _check_cuda(q, (("q", q), ("k", k), ("v", v)))
    B, H, Tq, _d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if out.numel():
        _launch("flash_attention_fwd", q, k, (q, k, v, out, lse), causal,
                sm_scale)
    return out, lse


def flash_attention_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """dq from the saved ``lse`` and ``delta = rowsum(do * out)``. CUDA
    tensors launch the kernel (``LAUNCHES["flash_attention_dq"]``) or
    raise; CPU tensors take the plain version."""
    _check_shapes(q, k, v)
    if _device_kind(q) == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta,
                                            causal, sm_scale)
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("do", do)),
                (("lse", lse), ("delta", delta)))
    dq = torch.empty_like(q)
    if dq.numel():
        _launch("flash_attention_dq", q, k,
                (q, k, v, do, lse, delta, dq), causal, sm_scale)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    """``(dk, dv)`` from the saved ``lse`` and ``delta``. CUDA tensors
    launch the kernel (``LAUNCHES["flash_attention_dkv"]``) or raise;
    CPU tensors take the plain version."""
    _check_shapes(q, k, v)
    if _device_kind(q) == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                             causal, sm_scale)
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("do", do)),
                (("lse", lse), ("delta", delta)))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel():
        _launch("flash_attention_dkv", q, k,
                (q, k, v, do, lse, delta, dk, dv), causal, sm_scale)
    return dk, dv


# (forward, dq, dk/dv): the wrappers, or the plain versions on any device
_KERNELS = (flash_attention_fwd, flash_attention_dq, flash_attention_dkv)
_PLAIN = (flash_attention_fwd_reference, flash_attention_dq_reference,
          flash_attention_dkv_reference)


class _FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves ``(q, k, v, out, lse)``;
    the backward computes delta, then dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, plain):
        fwd, _dq, _dkv = _PLAIN if plain else _KERNELS
        out, lse = fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.plain = causal, sm_scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        _fwd, dq_fn, dkv_fn = _PLAIN if ctx.plain else _KERNELS
        do = do.contiguous()      # autograd may hand a strided gradient
        delta = torch.sum(do.float() * out.float(), dim=-1)
        dq = dq_fn(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def _apply(q, k, v, causal, sm_scale, plain):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                 plain)


def flash_attention_reference(q, k, v, *, causal=False, sm_scale=None):
    """``flash_attention`` through the plain versions on any device,
    forward and backward: what the kernels are held against on the
    card."""
    return _apply(q, k, v, causal, sm_scale, True)


def flash_attention(q, k, v, *, causal=False, sm_scale=None,
                    block_q=128, block_k=128, interpret=None):
    """Tiled online-softmax attention.

    Args:
      q: ``[B, H, Tq, d]``; k, v: ``[B, H, Tk, d]``, float32 or bfloat16
        (on the card: all one dtype, contiguous, d <= 128; bfloat16 needs
        d a multiple of 8).
      causal: the autoregressive mask, position-based and top-left
        aligned (query i sees keys 0..i, also when Tq != Tk).
      sm_scale: logit scale; default ``1/sqrt(d)``.
      block_q, block_k: the Pallas kernel's tile sizes; positive ints,
        with no effect here (the Hopper kernels pick their own tiles,
        and a tile size never changes the function).
      interpret: the JAX wrapper's Pallas-interpreter switch: True on
        CPU tensors is the plain versions (as without it), on CUDA
        tensors a ``ValueError``.

    Returns ``[B, H, Tq, d]`` in q's dtype, differentiable in q, k and v
    through the flash backward. CUDA tensors run the kernels, CPU
    tensors their plain versions.
    """
    for name, tile in (("block_q", block_q), ("block_k", block_k)):
        if isinstance(tile, bool) \
                or not isinstance(tile, numbers.Integral) or tile < 1:
            raise ValueError(f"{name} must be a positive int, got "
                             f"{tile!r}")
    _kernels.check_interpret(interpret, q, "flash_attention")
    return _apply(q, k, v, causal, sm_scale, False)
