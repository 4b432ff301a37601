"""Quantized matmul: int8 / fp8-e4m3 weights with per-output-channel
scales, dynamic per-row activation quantization, and the dequantization
fused into the epilogue.

The port of the JAX package's ``kernels/quant_matmul.py``. For ``x
[M, K]`` fp32 and ``wq [K, N]`` with ``w_scale [N]``:

- ``sx = max(absmax(x_row), 1e-8) / qmax`` per row (qmax 127 or 448);
- int8: ``xq = clip(rint(x / sx), ±127)``, an exact integer dot;
  fp8-e4m3: ``xq = e4m3(x / sx)``, a float32 dot of the e4m3 values;
- ``out = float(acc) * sx * w_scale[n]``, in that order.

On CUDA tensors the wrapper launches the hand-written sm_90a kernels in
``csrc/quant_matmul.cu`` (a row-quantize pass, then the product on the
tensor cores, split over K by ``qmm_plan``) and raises on anything they
do not take. On CPU tensors it runs the plain version,
``quant_matmul_reference``. The
plain int8 lane sums in float64, which is exact for these products
(127 * 127 * K stays far below 2^53), so it agrees with an int32
accumulator on either device; the fp8 lane upcasts the e4m3 values to
float32 (exact) and sums in float32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from paddle_tpu_torch import kernels as _kernels

__all__ = ["FP8_E4M3_MAX", "QUANT_DTYPES", "QMM_BM", "QMM_BN",
           "QMM_CHUNK_MAX", "QMM_MAX_CLUSTER", "QmmPlan", "qmm_plan", "quantize_weight", "quant_matmul",
           "quant_matmul_reference", "quant_matmul_error_bound"]

FP8_E4M3_MAX = 448.0
QUANT_DTYPES = {"int8": torch.int8, "fp8-e4m3": torch.float8_e4m3fn}
_QMAX = {"int8": 127.0, "fp8-e4m3": FP8_E4M3_MAX}
_TINY = 1e-8
QMM_BN = 64           # output channels a block of the CUDA kernel
QMM_BM = 128          # rows a pass of a block
QMM_CHUNK_MAX = 384   # k one split covers, at most (shared memory)
QMM_MAX_CLUSTER = 8   # splits summed in a cluster's shared memory

_entry = None


def _cuda_entry():
    """The kernel's C entry, built and bound on first use."""
    global _entry
    if _entry is None:
        from paddle_tpu_torch.kernels import _build
        fn = _build.load("quant_matmul").quant_matmul
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


class QmmPlan(NamedTuple):
    """How the CUDA kernel splits ``x [M, K] @ wq [K, N]`` (``qmm_plan``)."""
    splits: int       # fixed ranges of k, gridDim.y
    chunk: int        # k a split covers (a multiple of 32)
    k_pad: int        # K rounded up to 32: the row pitch of xq
    col_tiles: int    # blocks of QMM_BN output channels, gridDim.x
    cluster: int      # blocks a cluster (the splits), or 1
    scratch: tuple    # byte offsets (xq, sx, counters, part, end) after
                      # the output


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=256)
def qmm_plan(M: int, K: int, N: int, n_sm: int = 132) -> QmmPlan:
    """The launch plan of the CUDA kernel: ``col_tiles`` blocks of 64
    output channels, and the 32-deep k steps of ``K`` (rounded up to 32)
    split into ``splits`` ranges of ``chunk`` (at most
    ``QMM_CHUNK_MAX``, none empty), as many as keep about one block on
    each of ``n_sm`` SMs, at most ``QMM_MAX_CLUSTER`` where M <= 128 and
    K allows: at the decoder's M = 80, wqkv and w1 give 144 blocks
    (4 / 3 splits), wo and w2 96 (8 splits). Every block covers all M
    rows (a loop of 128-row tiles), so each weight byte is read from
    device memory once. Up to 8 splits with M <= 128 are one thread
    block cluster (``cluster``) that sums its partials in shared
    memory, in split order. Otherwise the scratch holds a counter a
    column tile and the fp32 (int32 for int8) partials ``[splits, M,
    N]``, which each column tile's last block sums in split order. The
    wrapper allocates one byte buffer: the output ``[M, N]`` fp32, then
    ``xq [M, k_pad]`` bytes and ``sx [M]`` fp32 (``scratch``: their
    offsets, the end)."""
    k_pad = -(-K // 32) * 32
    col_tiles = -(-N // QMM_BN)
    steps = k_pad // 32
    least = -(-k_pad // QMM_CHUNK_MAX)
    want = max(least, min(steps, -(-n_sm // col_tiles)))
    if M <= QMM_BM and least <= QMM_MAX_CLUSTER:
        want = min(want, QMM_MAX_CLUSTER)
    chunk = 32 * -(-steps // want)
    splits = -(-k_pad // chunk)
    cluster = (splits if 1 < splits <= QMM_MAX_CLUSTER and M <= QMM_BM
               else 1)
    glob = splits > 1 and cluster == 1
    xq = _align16(4 * M * N)             # after the output [M, N] fp32
    sx = _align16(xq + M * k_pad)
    counters = _align16(sx + 4 * M)
    part = _align16(counters + (4 * col_tiles if glob else 0))
    end = part + (4 * splits * M * N if glob else 0)
    return QmmPlan(splits, chunk, k_pad, col_tiles, cluster,
                   (xq, sx, counters, part, end))


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
    1-byte values per 32-bit word), 16-byte aligned x, wq and w_scale."""
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
    if x.data_ptr() % 16 or wq.data_ptr() % 16 or w_scale.data_ptr() % 16:
        raise ValueError("x, wq and w_scale must be 16-byte aligned")


_sm_counts = {}


def _raw_stream(index):
    """The current stream of card ``index`` as a pointer (what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    building the stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _n_sm(dev):
    n = _sm_counts.get(dev)
    if n is None:
        n = _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def quant_matmul(x, wq, w_scale, *, interpret=None):
    """``x @ dequant(wq)`` with the dequantization fused into the
    epilogue.

    Args:
      x: ``[..., K]`` fp32 activations (leading dims flattened into the
        row axis; each row is quantized with its own dynamic scale).
      wq: ``[K, N]`` int8 or float8_e4m3fn weights from
        ``quantize_weight``.
      w_scale: ``[N]`` fp32 per-output-channel scales.
      interpret: the JAX wrapper's Pallas-interpreter switch: True on a
        CPU tensor is the plain version (as without it), on a CUDA
        tensor a ``ValueError``.

    Returns ``[..., N]`` fp32. CUDA tensors launch the kernel (adding
    one to ``kernels.LAUNCHES["quant_matmul"]``) or raise; CPU tensors
    take the plain version.
    """
    _check_args(x, wq, w_scale)
    _kernels.check_interpret(interpret, x, "quant_matmul")
    K, N = wq.shape
    x2 = x if x.dim() == 2 else x.reshape(-1, K)
    if x.device.type == "cpu":
        return quant_matmul_reference(x2, wq, w_scale).reshape(
            *x.shape[:-1], N)
    if x.device.type != "cuda":
        raise ValueError(f"no quant_matmul for device {x.device}")
    _check_cuda(x2, wq, w_scale)
    M = x2.shape[0]
    # the serving decoder calls this 4 times a layer and step: one buffer
    # holds the output and the kernel's scratch, and the launch skips the
    # device switch where x's card is current (both measured host costs)
    plan = qmm_plan(M, K, N, _n_sm(x.device))
    buf = torch.empty(plan.scratch[-1], dtype=torch.uint8, device=x.device)
    out = buf[:4 * M * N].view(torch.float32).view(M, N)
    if M:
        base = buf.data_ptr()
        xq, sx, counters, part = (base + off for off in plan.scratch[:4])
        if plan.splits == 1 or plan.cluster > 1:
            counters = part = None
        args = (0 if wq.dtype == torch.int8 else 1, x2.data_ptr(),
                wq.data_ptr(), w_scale.data_ptr(), out.data_ptr(), xq, sx,
                counters, part, M, K, N, plan.splits, plan.chunk)
        index = x.device.index
        if index == torch.cuda.current_device():
            err = _cuda_entry()(*args, _raw_stream(index))
        else:
            with torch.cuda.device(x.device):
                err = _cuda_entry()(*args, _raw_stream(index))
        if err != 0:
            raise RuntimeError(f"quant_matmul kernel launch failed: CUDA "
                               f"error {err}")
        _kernels.LAUNCHES["quant_matmul"] += 1
    return out if x.dim() == 2 else out.reshape(*x.shape[:-1], N)


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
