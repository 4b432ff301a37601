"""Fused GRU recurrence, forward and backward: the whole time loop in one
kernel launch per direction.

The port of the GRU half of the JAX package's ``kernels/fused_rnn.py``
(``_gru_fwd_call``, ``_gru_bwd_call``, ``gru_scan`` with its custom
VJP). Layouts are the JAX ones, time-major:

- ``x [T, B, 3D]``: pre-projected input gates u | r | c~ (+ bias);
- ``w [D, 3D]``: recurrent weights, ``[:, :2D]`` u/r, ``[:, 2D:]`` c~;
- ``lens [B, 1]`` fp32: valid lengths (step t of row b is live iff
  ``t < lens[b]``; a masked step keeps h, so the final state is
  ``hs[-1]``);
- ``h0 [B, D]``.

x, w and h0 share one dtype, float32 or bfloat16 (the seq2seq model
casts w to x's dtype and makes h0 in it). The carry is fp32; every
product rounds its operands to w's dtype and sums in fp32, as the Pallas
bodies do. The forward saves the post-activation gates (in x's dtype);
the backward walks time in reverse from them and ``hprev = [h0;
hs[:-1]]``, and gives ``dx`` (pre-activation gate gradients, in the
gates' dtype), ``dw`` (an fp32 sum cast to w's dtype) and ``dh0``.

``gru_scan`` is differentiable through a ``torch.autograd.Function``. On
CUDA tensors ``gru_fwd`` launches the hand-written sm_90a forward
kernel (B12) and ``gru_bwd`` the backward recurrence and then the dW
reduction (B13), all in ``csrc/fused_rnn.cu``, each counted in
``kernels.LAUNCHES`` (``"gru_fwd"``, ``"gru_bwd"``, ``"gru_dw"``); they
raise on what the kernels do not take. On CPU tensors each runs its
plain version, which follows the Pallas body step by step in torch ops.
Inside ``plain_versions()`` ``gru_scan`` runs the plain versions on any
device: what the kernels are held against on the card.

The LSTM kernels of the JAX file (B10, B11, B14, B15) are not ported
yet (ROADMAP A4). ``gru_scan_dp`` is a ``shard_map`` wrapper, not a
kernel; it raises, naming ROADMAP A9.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from paddle_tpu_torch import kernels as _kernels

__all__ = ["gru_bwd", "gru_bwd_data", "gru_bwd_data_reference",
           "gru_bwd_reference", "gru_dw", "gru_dw_reference", "gru_fwd",
           "gru_fwd_reference", "gru_scan", "gru_scan_dp",
           "plain_versions"]

_LANES = {torch.float32: 0, torch.bfloat16: 1}
# C entry -> (pointer arguments, int arguments after the pointers); each
# takes the lane first and the stream last
_ENTRIES = {"gru_fwd": (6, 4), "gru_bwd": (8, 4), "gru_dw": (6, 4)}
_entries = {}
SMEM_LIMIT = 232448        # bytes of shared memory a block may opt in to
# fp32 [bb, D] arrays each recurrence kernel keeps in shared memory
_SMEM_ARRAYS = {"gru_fwd": 4, "gru_bwd": 10}
_DW_TILES_PER_SM = 4       # dW: aim for this many blocks per SM
_plain = [False]           # inside plain_versions()


def _cuda_entry(name):
    """A kernel's C entry, built and bound on first use."""
    fn = _entries.get(name)
    if fn is None:
        from paddle_tpu_torch.kernels import _build
        n_ptr, n_int = _ENTRIES[name]
        fn = getattr(_build.load("fused_rnn"), name)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check_shapes(x, w, lens, h0):
    """x [T, B, 3D] (or the gates), w [D, 3D], lens [B, 1], h0 [B, D]; x,
    w and h0 of one dtype."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != 3 * w.shape[0]:
        raise ValueError(f"x must be [T, B, 3D] and w [D, 3D]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    T, B, G = x.shape
    D = w.shape[0]
    if G != 3 * D or tuple(h0.shape) != (B, D) or tuple(lens.shape) != (B, 1):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, lens "
                         f"{tuple(lens.shape)} and h0 {tuple(h0.shape)} do "
                         "not agree (want [T, B, 3D], [D, 3D], [B, 1], "
                         "[B, D])")
    if not (x.dtype == w.dtype == h0.dtype):
        raise TypeError(f"x {x.dtype}, w {w.dtype} and h0 {h0.dtype} must "
                        "share one dtype")
    return T, B, D


def _device_kind(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused GRU for device {x.device}")
    return x.device.type


def _check_cuda(tensors, lens=None):
    """What the CUDA kernels take: every tensor on one card, contiguous
    and 16-byte aligned; float32 or bfloat16 (one dtype, checked by the
    callers); fp32 lens. Returns the lane."""
    first = tensors[0][1]
    lane = _LANES.get(first.dtype)
    if lane is None:
        raise TypeError(f"no CUDA kernel lane for {first.dtype}: the fused "
                        "GRU takes float32 or bfloat16")
    if lens is not None:
        tensors = tuple(tensors) + (("lens", lens),)
        if lens.dtype != torch.float32:
            raise TypeError(f"lens must be float32, got {lens.dtype}")
    for name, t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, "
                             f"{tensors[0][0]} on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return lane


def _check_like(gates, hs, h0, other):
    """hs ``[T, B, D]`` for gates ``[T, B, 3D]``, and ``other`` = (name,
    tensor, shape) of that shape; all in the gates' dtype (the kernels'
    one lane)."""
    T, B, G = gates.shape
    name, t, shape = other
    if tuple(hs.shape) != (T, B, G // 3) or tuple(t.shape) != tuple(shape):
        raise ValueError(f"hs {tuple(hs.shape)} / {name} {tuple(t.shape)} "
                         f"do not fit gates {tuple(gates.shape)}")
    for n, x in (("hs", hs), ("h0", h0), (name, t)):
        if x.dtype != gates.dtype:
            raise TypeError(f"{n} {x.dtype} must have the gates' dtype "
                            f"{gates.dtype}")


def _check_d(D):
    if D % 64:
        raise ValueError(f"D={D} is not a multiple of 64, which the CUDA "
                         "kernels need")


def _n_sm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _pick_bb(name, B, D, dev):
    """Batch rows per block: the fewest (1, 2, 4, 8) whose tiles fit on
    the card's SMs in one wave, then halved while the block's shared
    memory would not fit."""
    n_sm = _n_sm(dev)
    bb = next((b for b in (1, 2, 4) if -(-B // b) <= n_sm), 8)
    while bb > 1 and _SMEM_ARRAYS[name] * bb * D * 4 > SMEM_LIMIT:
        bb //= 2
    if _SMEM_ARRAYS[name] * bb * D * 4 > SMEM_LIMIT:
        raise ValueError(f"D={D} is too large for the {name} kernel: "
                         f"{_SMEM_ARRAYS[name] * D * 4} bytes of shared "
                         f"memory per batch row, {SMEM_LIMIT} per block")
    return bb


def _launch(name, lane, pointers, ints, dev):
    """Launch ``name`` on the current stream of ``dev``; raise on a CUDA
    error and count the launch."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _cuda_entry(name)(
            lane, *[p if p is None else p.data_ptr() for p in pointers],
            *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _kernels.LAUNCHES[name] += 1


def _hprev(hs, h0):
    """``[h0; hs[:-1]]`` in hs's dtype (the JAX ``_gru_bwd_call``)."""
    return torch.cat([h0[None].to(hs.dtype), hs[:-1]], dim=0)


# ------------------------------------------------------------ plain versions

def gru_fwd_reference(x, w, lens, h0):
    """Plain version of the forward kernel (``_gru_fwd_kernel``), one
    step at a time: ``(hs [T, B, D], gates [T, B, 3D])`` in x's dtype."""
    T, B, D = _check_shapes(x, w, lens, h0)
    wf = w.float()
    h = h0.float()
    hs = x.new_empty((T, B, D))
    gates = torch.empty_like(x)
    for t in range(T):
        xt = x[t].float()
        h_lp = h.to(w.dtype).float()
        g_ur = xt[:, :2 * D] + h_lp @ wf[:, :2 * D]
        u = torch.sigmoid(g_ur[:, :D])
        r = torch.sigmoid(g_ur[:, D:])
        rh = r * h
        c = torch.tanh(xt[:, 2 * D:] + rh.to(w.dtype).float() @ wf[:, 2 * D:])
        h_t = u * h + (1.0 - u) * c
        m = (t < lens).float()
        h = m * h_t + (1.0 - m) * h
        hs[t] = h.to(x.dtype)
        gates[t] = torch.cat([u, r, c], dim=-1).to(x.dtype)
    return hs, gates


def gru_bwd_data_reference(gates, hs, w, lens, h0, dhs):
    """Plain version of the backward recurrence (``_gru_bwd_kernel``
    without its dW): ``(dx [T, B, 3D] in the gates' dtype, dh0 in
    h0's)``."""
    T, B, D = _check_shapes(gates, w, lens, h0)
    wf = w.float()
    hprev = _hprev(hs, h0)
    dh = torch.zeros((B, D), dtype=torch.float32, device=gates.device)
    dx = torch.empty_like(gates)
    for t in range(T - 1, -1, -1):
        g3 = gates[t].float()
        u, r, c = g3[:, :D], g3[:, D:2 * D], g3[:, 2 * D:]
        h_prev = hprev[t].float()
        m = (t < lens).float()
        dH = dhs[t].float() + dh
        dh_t = m * dH
        du = dh_t * (h_prev - c)
        du_pre = du * u * (1.0 - u)
        dc = dh_t * (1.0 - u)
        dc_pre = dc * (1.0 - c * c)
        dc_lp = dc_pre.to(w.dtype).float()
        drh = dc_lp @ wf[:, 2 * D:].T
        dr = drh * h_prev
        dr_pre = dr * r * (1.0 - r)
        dur_pre = torch.cat([du_pre, dr_pre], dim=-1)
        dur_lp = dur_pre.to(w.dtype).float()
        dh = (dh_t * u + drh * r + dur_lp @ wf[:, :2 * D].T
              + (1.0 - m) * dH)
        dx[t] = torch.cat([dur_pre, dc_pre], dim=-1).to(dx.dtype)
    return dx, dh.to(h0.dtype)


def gru_dw_reference(gates, hs, h0, dx):
    """Plain version of the dW reduction: ``sum_t hprev_lp^T dur_lp``
    (u/r columns) and ``sum_t (r*hprev)_lp^T dc_lp`` (c~ columns) in
    fp32, cast to dx's dtype (which is w's: ``dx`` holds ``dur_pre |
    dc_pre`` already rounded to it)."""
    T, B, G = gates.shape
    D = G // 3
    hprev = _hprev(hs, h0).float().reshape(T * B, D)
    r = gates[..., D:2 * D].float().reshape(T * B, D)
    h_lp = hprev.to(dx.dtype).float()
    rh_lp = (r * hprev).to(dx.dtype).float()
    d = dx.float().reshape(T * B, G)
    return torch.cat([h_lp.T @ d[:, :2 * D], rh_lp.T @ d[:, 2 * D:]],
                     dim=1).to(dx.dtype)


def gru_bwd_reference(gates, hs, w, lens, h0, dhs):
    """Plain version of the whole backward: ``(dx, dw, dh0)``."""
    dx, dh0 = gru_bwd_data_reference(gates, hs, w, lens, h0, dhs)
    return dx, gru_dw_reference(gates, hs, h0, dx), dh0


# ------------------------------------------------------------------ kernels

def gru_fwd(x, w, lens, h0):
    """The forward: ``(hs, gates)``. CUDA tensors launch the kernel
    (``kernels.LAUNCHES["gru_fwd"]``) or raise; CPU tensors take the
    plain version."""
    T, B, D = _check_shapes(x, w, lens, h0)
    if _device_kind(x) == "cpu":
        return gru_fwd_reference(x, w, lens, h0)
    lane = _check_cuda((("x", x), ("w", w), ("h0", h0)), lens)
    _check_d(D)
    hs = x.new_empty((T, B, D))
    gates = torch.empty_like(x)
    if B:
        _launch("gru_fwd", lane, (x, w, lens, h0, hs, gates),
                (T, B, D, _pick_bb("gru_fwd", B, D, x.device)), x.device)
    return hs, gates


def gru_bwd_data(gates, hs, w, lens, h0, dhs):
    """The backward recurrence: ``(dx, dh0)``. CUDA tensors launch the
    kernel (``LAUNCHES["gru_bwd"]``) or raise; CPU tensors take the
    plain version."""
    T, B, D = _check_shapes(gates, w, lens, h0)
    if _device_kind(gates) == "cpu":
        return gru_bwd_data_reference(gates, hs, w, lens, h0, dhs)
    _check_like(gates, hs, h0, ("dhs", dhs, hs.shape))
    lane = _check_cuda((("gates", gates), ("hs", hs), ("w", w), ("h0", h0),
                        ("dhs", dhs)), lens)
    _check_d(D)
    dx = torch.empty_like(gates)
    dh0 = torch.empty_like(h0)
    if B:
        # the kernel reads W^T [3D, D]: both of its products then walk
        # neighbouring columns, as the forward's do
        wt = w.t().contiguous()
        _launch("gru_bwd", lane, (gates, hs, wt, lens, h0, dhs, dx, dh0),
                (T, B, D, _pick_bb("gru_bwd", B, D, gates.device)),
                gates.device)
    return dx, dh0


def gru_dw(gates, hs, h0, dx):
    """The dW reduction over the T*B rows. CUDA tensors launch the
    kernel (``LAUNCHES["gru_dw"]``) or raise; CPU tensors take the
    plain version."""
    T, B, G = gates.shape
    D = G // 3
    if _device_kind(gates) == "cpu":
        return gru_dw_reference(gates, hs, h0, dx)
    dev = gates.device
    _check_like(gates, hs, h0, ("dx", dx, gates.shape))
    lane = _check_cuda((("gates", gates), ("hs", hs), ("h0", h0),
                        ("dx", dx)))
    _check_d(D)
    dw = gates.new_empty((D, G))
    tiles = (G // 64) * (D // 64)
    splits = max(1, min(-(-_DW_TILES_PER_SM * _n_sm(dev) // tiles),
                        -(-T * B // 256)))
    part = (torch.empty((splits, D, G), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    if B:
        _launch("gru_dw", lane, (gates, hs, h0, dx, part, dw),
                (T, B, D, splits), dev)
    else:
        dw.zero_()
    return dw


def gru_bwd(gates, hs, w, lens, h0, dhs):
    """The backward: ``(dx, dw, dh0)``, the recurrence then the dW
    reduction (on the card, one launch each)."""
    dx, dh0 = gru_bwd_data(gates, hs, w, lens, h0, dhs)
    return dx, gru_dw(gates, hs, h0, dx), dh0


# ----------------------------------------------------------------- autograd

@contextlib.contextmanager
def plain_versions():
    """Run ``gru_scan`` through the plain versions on any device, forward
    and backward, while inside (the card-side oracle)."""
    prev = _plain[0]
    _plain[0] = True
    try:
        yield
    finally:
        _plain[0] = prev


class _GruScan(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves ``(gates, hs, w, lens,
    h0)``; the backward gives dx, dw and dh0 (none for lens)."""

    @staticmethod
    def forward(ctx, x, w, lens, h0, plain):
        hs, gates = (gru_fwd_reference if plain else gru_fwd)(x, w, lens, h0)
        ctx.save_for_backward(gates, hs, w, lens, h0)
        ctx.plain = plain
        return hs

    @staticmethod
    def backward(ctx, dhs):
        gates, hs, w, lens, h0 = ctx.saved_tensors
        bwd = gru_bwd_reference if ctx.plain else gru_bwd
        dx, dw, dh0 = bwd(gates, hs, w, lens, h0, dhs.contiguous())
        return dx, dw, None, dh0, None


def gru_scan(x, w, lens, h0):
    """Fused GRU over time. x ``[T, B, 3D]`` pre-projected (u|r|c~ +
    bias), w ``[D, 3D]`` (``[:, :2D]`` u/r recurrent, ``[:, 2D:]``
    candidate recurrent), lens ``[B, 1]`` fp32, h0 ``[B, D]``. Returns
    hs ``[T, B, D]``, differentiable in x, w and h0. CUDA tensors run the
    kernels, CPU tensors (or any inside ``plain_versions()``) the plain
    versions."""
    return _GruScan.apply(x, w, lens, h0, _plain[0])


def gru_scan_dp(x, w, lens, h0, mesh, data_axis, interpret=None):
    raise NotImplementedError(
        "gru_scan_dp (gru_scan under shard_map over the data axis) needs "
        "the port's parallel/ package (ROADMAP A9)")
