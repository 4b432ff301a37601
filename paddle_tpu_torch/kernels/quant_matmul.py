"""Quantized matmul: int8 / fp8-e4m3 weights with per-output-channel
scales, dynamic per-row activation quantization, and the dequantization
fused into the epilogue.

The port of the JAX package's ``kernels/quant_matmul.py``. For ``x
[M, K]`` fp32 and ``wq [K, N]`` with ``w_scale [N]``:

- ``sx = max(absmax(x_row), 1e-8) / qmax`` per row (qmax 127 or 448);
- int8: ``xq = clip(rint(x / sx), ±127)``, an exact integer dot;
  fp8-e4m3: ``xq = e4m3(x / sx)``, a float32 dot of the e4m3 values;
- ``out = float(acc) * sx * w_scale[n]``, in that order.

On CUDA tensors the wrapper launches the hand-written sm_90a kernel in
``csrc/quant_matmul.cu`` and raises on anything it does not take. On
CPU tensors it runs the plain version, ``quant_matmul_reference``. The
plain int8 lane sums in float64, which is exact for these products
(127 * 127 * K stays far below 2^53), so it agrees with an int32
accumulator on either device; the fp8 lane upcasts the e4m3 values to
float32 (exact) and sums in float32.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch import kernels as _kernels

__all__ = ["FP8_E4M3_MAX", "QUANT_DTYPES", "quantize_weight",
           "quant_matmul", "quant_matmul_reference",
           "quant_matmul_error_bound"]

FP8_E4M3_MAX = 448.0
QUANT_DTYPES = {"int8": torch.int8, "fp8-e4m3": torch.float8_e4m3fn}
_QMAX = {"int8": 127.0, "fp8-e4m3": FP8_E4M3_MAX}
_TINY = 1e-8

_entry = None


def _cuda_entry():
    """The kernel's C entry, built and bound on first use."""
    global _entry
    if _entry is None:
        from paddle_tpu_torch.kernels import _build
        fn = _build.load("quant_matmul").quant_matmul
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _lane(dtype: torch.dtype) -> str:
    for name, dt in QUANT_DTYPES.items():
        if dt == dtype:
            return name
    raise TypeError(f"wq must be int8 or float8_e4m3fn, got {dtype}")


def _per_qmax(t, qmax: float):
    """``t / qmax`` as a true division. PyTorch on CUDA divides by a
    Python scalar by multiplying with its reciprocal, which can round
    one ulp away from the quotient the JAX package and the kernel
    compute; a tensor divisor keeps the IEEE division."""
    return t / torch.full_like(t, qmax)


def quantize_weight(w, dtype: str = "int8"):
    """Per-output-channel weight quantization: ``w [K, N]`` fp32 ->
    ``(wq [K, N] int8|float8_e4m3fn, w_scale [N] fp32)`` with ``w ≈ wq
    * w_scale[None, :]`` (the JAX package's ``quantize_weight``)."""
    if dtype not in _QMAX:
        raise ValueError(f"unknown quant dtype {dtype!r}; "
                         f"known: {sorted(_QMAX)}")
    w = w.float()
    if w.dim() != 2:
        raise ValueError(f"w must be [K, N], got shape {tuple(w.shape)}")
    scale = _per_qmax(w.abs().amax(dim=0).clamp_min(_TINY), _QMAX[dtype])
    scaled = w / scale[None, :]
    if dtype == "int8":
        return torch.round(scaled).clamp(-127, 127).to(torch.int8), scale
    return scaled.to(torch.float8_e4m3fn), scale


def _check_args(x, wq, w_scale):
    if wq.dim() != 2 or tuple(w_scale.shape) != (wq.shape[1],):
        raise ValueError(f"wq must be [K, N] with w_scale [N]; got "
                         f"{tuple(wq.shape)} / {tuple(w_scale.shape)}")
    if x.shape[-1] != wq.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs "
                         f"wq {tuple(wq.shape)}")
    _lane(wq.dtype)


def _check_cuda(x, wq, w_scale):
    """What the CUDA kernel takes: every tensor on x's card, fp32 x and
    w_scale, contiguous, K and N multiples of 4 (the kernel moves four
    1-byte values per 32-bit word), 16-byte aligned x and wq."""
    for name, t in (("wq", wq), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w_scale", w_scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                            f"got {t.dtype}")
    for name, t in (("x", x), ("wq", wq), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    K, N = wq.shape
    if K % 4 or N % 4:
        raise ValueError(f"the CUDA kernel needs K and N divisible by 4, "
                         f"got K={K}, N={N}")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("x and wq must be 16-byte aligned")


def quant_matmul(x, wq, w_scale):
    """``x @ dequant(wq)`` with the dequantization fused into the
    epilogue.

    Args:
      x: ``[..., K]`` fp32 activations (leading dims flattened into the
        row axis; each row is quantized with its own dynamic scale).
      wq: ``[K, N]`` int8 or float8_e4m3fn weights from
        ``quantize_weight``.
      w_scale: ``[N]`` fp32 per-output-channel scales.

    Returns ``[..., N]`` fp32. CUDA tensors launch the kernel (adding
    one to ``kernels.LAUNCHES["quant_matmul"]``) or raise; CPU tensors
    take the plain version.
    """
    _check_args(x, wq, w_scale)
    lead = tuple(x.shape[:-1])
    K, N = wq.shape
    x2 = x.reshape(-1, K)
    if x.device.type == "cpu":
        return quant_matmul_reference(x2, wq, w_scale).reshape(*lead, N)
    if x.device.type != "cuda":
        raise ValueError(f"no quant_matmul for device {x.device}")
    _check_cuda(x2, wq, w_scale)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M:
        lane = 0 if wq.dtype == torch.int8 else 1
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _cuda_entry()(lane, x2.data_ptr(), wq.data_ptr(),
                                w_scale.data_ptr(), out.data_ptr(), M, K,
                                N, stream)
        if err != 0:
            raise RuntimeError(f"quant_matmul kernel launch failed: CUDA "
                               f"error {err}")
        _kernels.LAUNCHES["quant_matmul"] += 1
    return out.reshape(*lead, N)


def quant_matmul_reference(x, wq, w_scale):
    """Plain version: the kernel's quantization, dot and epilogue in
    the same order, on any device."""
    lane = _lane(wq.dtype)
    x = x.float()
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    sx = _per_qmax(x2.abs().amax(dim=1, keepdim=True).clamp_min(_TINY),
                   _QMAX[lane])
    scaled = x2 / sx
    if lane == "int8":
        xq = torch.round(scaled).clamp(-127, 127)
        acc = (xq.double() @ wq.double()).float()
    else:
        xq = scaled.to(torch.float8_e4m3fn).float()
        acc = xq @ wq.float()
    out = acc * sx * w_scale[None, :]
    return out.reshape(*lead, wq.shape[1])


def quant_matmul_error_bound(x, w, dtype: str = "int8"):
    """A-priori per-output bound of ``quant_matmul`` against the exact
    fp32 product (the JAX package's ``quant_matmul_error_bound``). With
    round-to-nearest, int8 gives

      |err[m, n]| <= K * (|x[m]|max * sw[n]/2 + |w[:, n]|max * sx[m]/2
                          + sx[m] * sw[n] / 4)

    and fp8-e4m3 (relative half-ulp eps = 2^-4)
    ``K * |x[m]|max * |w[:, n]|max * (2 eps + eps^2) + K sx sw / 4``.
    Returns ``[..., N]``."""
    qmax = _QMAX[dtype]
    x = x.float()
    w = w.float()
    K = w.shape[0]
    xmax = x.abs().amax(dim=-1, keepdim=True).clamp_min(_TINY)
    wmax = w.abs().amax(dim=0).clamp_min(_TINY)
    sx = xmax / qmax
    sw = wmax / qmax
    if dtype == "fp8-e4m3":
        eps = 2.0 ** -4
        return K * xmax * wmax * (2.0 * eps + eps * eps) \
            + K * sx * sw / 4.0
    return K * (xmax * sw / 2.0 + wmax * sx / 2.0 + sx * sw / 4.0)
