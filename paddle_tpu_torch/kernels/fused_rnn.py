"""Fused LSTM and GRU recurrences, forward and backward: the whole time
loop in one kernel launch per direction.

The port of the JAX package's ``kernels/fused_rnn.py``: the LSTM
(``_lstm_fwd_call`` B10, ``_lstm_bwd_call`` B11, ``lstm_scan``; with the
input projection in the loop, ``_lstm_proj_fwd_call`` B14,
``_lstm_proj_bwd_call`` B15, ``lstm_scan_proj``) and the GRU
(``_gru_fwd_call`` B12, ``_gru_bwd_call`` B13, ``gru_scan``), each scan
with its custom VJP. Layouts are the JAX ones, time-major:

- ``x [T, B, G]``: pre-projected input gates (+ bias): LSTM ``G = 4D``,
  i | f | c~ | o; GRU ``G = 3D``, u | r | c~;
- ``w [D, G]``: recurrent weights (GRU: ``[:, :2D]`` u/r, ``[:, 2D:]``
  c~);
- B14/B15: ``xe [T, B, E]`` the raw layer input, ``wx [E, 4D]`` the
  input projection and ``b [4D]`` its bias, applied inside the step;
- ``lens [B, 1]`` fp32: valid lengths (step t of row b is live iff
  ``t < lens[b]``; a masked step keeps h (and c), so the final state is
  ``hs[-1]``);
- ``h0`` (LSTM also ``c0``) ``[B, D]``.

The inputs share one dtype, float32 or bfloat16 (the ops cast w to x's
dtype and make h0 in it). The carries are fp32; every product rounds its
operands to w's dtype and sums in fp32, as the Pallas bodies do. The
forwards save the post-activation gates (in x's dtype); the backwards
walk time in reverse from them and ``hprev = [h0; hs[:-1]]`` (LSTM also
``cprev = [c0; cs[:-1]]``, as stored in cs's dtype), and give ``dx``
(pre-activation gate gradients, in the gates' dtype), the weight
gradients (fp32 sums cast to w's dtype; B15's ``db`` an fp32 sum of the
unrounded gate gradients) and ``dh0`` (``dc0``).

On CUDA tensors each wrapper launches its hand-written sm_90a kernel in
``csrc/fused_rnn.cu``, counted in ``kernels.LAUNCHES`` under its own
name: ``lstm_fwd`` (B10); ``lstm_bwd`` and ``lstm_dw`` (B11's recurrence
and dW reduction); ``lstm_proj_fwd`` (B14); ``lstm_proj_bwd`` and
``lstm_proj_dw`` (B15's recurrence, with dxe and db, and its dWx/dW
reduction); ``gru_fwd`` (B12); ``gru_bwd`` and ``gru_dw`` (B13). They
raise on what the kernels do not take. ``lstm_fwd``, ``lstm_bwd``,
``lstm_proj_fwd``, ``lstm_proj_bwd``, ``gru_fwd`` and ``gru_bwd`` note the
FLOPs of the JAX function each replaces into the cost plane's ledger
(``lstm_fwd_flops`` ... ``gru_bwd_flops``: JAX's formulas) on CUDA
tensors.

The LSTM recurrences (B10, B11's, B14, B15's) take one of three routes,
chosen by the call's dtype and shape before any launch
(``lstm_cluster_plan``; every tensor of a call shares one dtype). The
resident route (bf16, D a multiple of 32 up to 512): the recurrence
``lstm_cluster_fwd`` / ``lstm_cluster_bwd`` with W split over one
thread-block cluster's shared memory. The grid route (bf16 at D 768, 1024
and 1280; fp32 at D 256, 512 and 768, its product exact to fp32 on the
tensor cores as 3xTF32): the same functions on kernels that keep W
resident across a group of D / 256 (fp32: D / 128) clusters of 16 CTAs,
all resident at once, the step's exchange crossing clusters through L2
behind one group barrier a step. On both, B14 first runs the pre-pass
``lstm_proj_xg`` (xg = xe @ Wx + b for every step, fp32) and B15 after it
the post-pass ``lstm_proj_dxe`` (dxe = dx @ Wx^T), while B10 reads its x
as the step's first term and B11's recurrence skips db. The streaming
route (everything else): one kernel per direction that reads W (and Wx)
from L2 every step. Each
recurrence launch counts under its wrapper's name (``lstm_fwd``,
``lstm_bwd``, ``lstm_proj_fwd``, ``lstm_proj_bwd``) and under its
route's (``..._cluster``, ``..._grid``, ``..._stream``); the passes under
``lstm_proj_xg`` / ``lstm_proj_dxe``. The GRU recurrences (B12, B13's)
take the three routes of the same plan with three gates
(``lstm_cluster_plan(..., ng=3)``; the forward's reset before the
candidate's product makes two exchanges a step): resident in bf16 up to
D 512 (the reverse reads W transposed from its resident slices, with no
transposed copy), grid in fp32 at D 256, 512 and 768 (the forward's W
split by K over the group's clusters, their partials summed in cluster
order; the reverse's rows of W resident as the LSTM's, read as they
lie; 3xTF32), else streaming; each launch counts under ``gru_fwd`` /
``gru_bwd`` and ``gru_{fwd,bwd}_{cluster,grid,stream}``. On CPU tensors
each runs its plain version, which follows the Pallas body step by step
in torch ops.
Inside ``plain_versions()`` the scans run the plain versions on any
device: what the kernels are held against on the card.

``lstm_scan_dp`` / ``gru_scan_dp`` are ``shard_map`` wrappers, not
kernels; they raise, naming ROADMAP A9. ``lstm_scan``'s batch-major
``layout="bt"`` (which no JAX op calls) raises too.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch import kernels as _kernels

__all__ = ["ClusterPlan", "DwPlan", "dw_plan", "gru_bwd", "gru_bwd_data",
           "gru_bwd_flops", "gru_fwd_flops", "lstm_bwd_flops",
           "lstm_fwd_flops", "lstm_proj_bwd_flops", "lstm_proj_fwd_flops",
           "gru_bwd_data_reference",
           "gru_bwd_reference", "gru_dw", "gru_dw_reference", "gru_fwd",
           "gru_fwd_reference", "gru_scan", "gru_scan_dp", "lstm_bwd",
           "lstm_bwd_data", "lstm_bwd_data_reference", "lstm_bwd_reference",
           "lstm_cluster_bwd", "lstm_cluster_bwd_reference",
           "lstm_cluster_fwd", "lstm_cluster_fwd_reference",
           "lstm_cluster_plan", "lstm_cluster_probe",
           "lstm_dw", "lstm_dw_reference", "lstm_fwd", "lstm_fwd_reference",
           "lstm_proj_bwd", "lstm_proj_bwd_data",
           "lstm_proj_bwd_data_reference", "lstm_proj_bwd_reference",
           "lstm_proj_dw", "lstm_proj_dw_reference", "lstm_proj_dxe",
           "lstm_proj_dxe_reference", "lstm_proj_fwd",
           "lstm_proj_fwd_reference", "lstm_proj_xg",
           "lstm_proj_xg_reference", "lstm_scan", "lstm_scan_dp",
           "lstm_scan_proj", "plain_versions"]

_LANES = {torch.float32: 0, torch.bfloat16: 1}
# C entry -> (pointer arguments, int arguments after the pointers); each
# takes the lane first and the stream last
_ENTRIES = {"gru_fwd": (6, 4), "gru_bwd": (8, 4), "gru_dw": (6, 4),
            "lstm_fwd": (8, 4), "lstm_bwd": (10, 4), "lstm_dw": (6, 5),
            "lstm_proj_fwd": (10, 5), "lstm_proj_bwd": (14, 5),
            "proj_gemm": (4, 4), "cluster_lstm_fwd": (8, 4),
            "cluster_lstm_fwd_x": (8, 4),
            "cluster_lstm_bwd": (12, 4), "cluster_occupancy": (1, 3),
            "cluster_lstm_probe": (1, 5), "grid_lstm_fwd": (10, 3),
            "grid_lstm_fwd_x": (10, 3), "grid_lstm_bwd": (14, 3),
            "grid_gru_fwd": (9, 3), "grid_gru_bwd": (12, 3),
            "grid_occupancy": (1, 2)}
_entries = {}
SMEM_LIMIT = 232448        # bytes of shared memory a block may opt in to
# shared memory of each recurrence kernel for bb batch rows, hidden D and
# input width E (the C launchers compute the same): fp32 [bb, D] arrays,
# [bb, E] arrays (B14's staged xe, double-buffered) and [4D] vectors
# (B15's db)
_SMEM_FLOATS = {"gru_fwd": lambda bb, D, E: 4 * bb * D,
                "gru_bwd": lambda bb, D, E: 10 * bb * D,
                "lstm_fwd": lambda bb, D, E: 4 * bb * D,
                "lstm_proj_fwd": lambda bb, D, E: 4 * bb * D + 2 * bb * E,
                "lstm_bwd": lambda bb, D, E: 6 * bb * D,
                "lstm_proj_bwd": lambda bb, D, E: 6 * bb * D + 4 * D}
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


def _check_shapes(x, w, lens, h0, ng=3):
    """x [T, B, ng*D] (or the gates), w [D, ng*D], lens [B, 1], h0 [B, D];
    x, w and h0 of one dtype (ng = 3 for the GRU, 4 for the LSTM)."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != ng * w.shape[0]:
        raise ValueError(f"x must be [T, B, {ng}D] and w [D, {ng}D]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    T, B, G = x.shape
    D = w.shape[0]
    if (G != ng * D or tuple(h0.shape) != (B, D)
            or tuple(lens.shape) != (B, 1)):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, lens "
                         f"{tuple(lens.shape)} and h0 {tuple(h0.shape)} do "
                         f"not agree (want [T, B, {ng}D], [D, {ng}D], "
                         "[B, 1], [B, D])")
    if not (x.dtype == w.dtype == h0.dtype):
        raise TypeError(f"x {x.dtype}, w {w.dtype} and h0 {h0.dtype} must "
                        "share one dtype")
    return T, B, D


def _device_kind(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused recurrence kernel for device "
                         f"{x.device}")
    return x.device.type


def _check_cuda(tensors, lens=None):
    """What the CUDA kernels take: every tensor on one card, contiguous
    and 16-byte aligned; float32 or bfloat16 (one dtype, checked by the
    callers); fp32 lens. Returns the lane."""
    first = tensors[0][1]
    lane = _LANES.get(first.dtype)
    if lane is None:
        raise TypeError(f"no CUDA kernel lane for {first.dtype}: the fused "
                        "recurrence kernels take float32 or bfloat16")
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


def _check_like(gates, hs, h0, *others, ng=3):
    """hs ``[T, B, D]`` for gates ``[T, B, ng*D]``, and each of
    ``others`` = (name, tensor, shape) of that shape; all in the gates'
    dtype (the kernels' one lane)."""
    T, B, G = gates.shape
    if tuple(hs.shape) != (T, B, G // ng):
        raise ValueError(f"hs {tuple(hs.shape)} does not fit gates "
                         f"{tuple(gates.shape)}")
    for name, t, shape in others:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"hs {tuple(hs.shape)} / {name} "
                             f"{tuple(t.shape)} do not fit gates "
                             f"{tuple(gates.shape)}")
    for n, x in (("hs", hs), ("h0", h0)) + tuple(o[:2] for o in others):
        if x.dtype != gates.dtype:
            raise TypeError(f"{n} {x.dtype} must have the gates' dtype "
                            f"{gates.dtype}")


def _check_d(D, what="D"):
    if D % 64 or D < 64:
        raise ValueError(f"{what}={D} is not a multiple of 64, which the "
                         "CUDA kernels need")


def _n_sm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _pick_bb(name, B, D, dev, E=0):
    """Batch rows per block: the fewest (1, 2, 4, 8) whose tiles fit on
    the card's SMs in one wave, then halved while the block's shared
    memory would not fit."""
    n_sm = _n_sm(dev)
    smem = _SMEM_FLOATS[name]
    bb = next((b for b in (1, 2, 4) if -(-B // b) <= n_sm), 8)
    while bb > 1 and smem(bb, D, E) * 4 > SMEM_LIMIT:
        bb //= 2
    if smem(bb, D, E) * 4 > SMEM_LIMIT:
        raise ValueError(f"D={D} is too large for the {name} kernel: "
                         f"{smem(1, D, E) * 4} bytes of shared memory for "
                         f"one batch row, {SMEM_LIMIT} per block")
    return bb


def _launch(name, lane, pointers, ints, dev, entry=None, also=()):
    """Launch the C entry ``entry`` (default ``name``) on the current
    stream of ``dev``; raise on a CUDA error and count the launch under
    ``name`` and each name in ``also``."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _cuda_entry(entry or name)(
            lane, *[p if p is None else p.data_ptr() for p in pointers],
            *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    for n in (name, *also):
        _kernels.LAUNCHES[n] += 1


# The analytic FLOPs each JAX function notes into its cost plane
# (``paddle_tpu/kernels/fused_rnn.py``'s ``_note_kernel_flops`` calls);
# the CUDA branch of the wrapper that replaces it notes the same.

def lstm_fwd_flops(T, B, D):
    """B10, ``_lstm_fwd_call`` (fused_rnn.py:235): h @ w every step."""
    return 2.0 * T * B * D * (4 * D)


def lstm_bwd_flops(T, B, D):
    """B11, ``_lstm_bwd_call`` (:296): dgates @ w^T and dW."""
    return 4.0 * T * B * D * (4 * D)


def gru_fwd_flops(T, B, D):
    """B12, ``_gru_fwd_call`` (:456)."""
    return 2.0 * T * B * D * (3 * D)


def gru_bwd_flops(T, B, D):
    """B13, ``_gru_bwd_call`` (:488)."""
    return 4.0 * T * B * D * (3 * D)


def lstm_proj_fwd_flops(T, B, E, D):
    """B14, ``_lstm_proj_fwd_call`` (:671): xe @ wx + h @ w every step
    (the pre-pass and the recurrence, one note)."""
    return 2.0 * T * B * (E + D) * (4 * D)


def lstm_proj_bwd_flops(T, B, E, D):
    """B15, ``_lstm_proj_bwd_call`` (:711): the recurrence, the
    post-pass and dWx + dW, one note."""
    return 4.0 * T * B * (E + D) * (4 * D)


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
    """The forward: ``(hs, gates)``. CUDA tensors take the route of
    ``lstm_cluster_plan(..., ng=3)`` for x's dtype: resident (bf16: W
    split over one thread-block cluster's shared memory,
    ``kernels.LAUNCHES["gru_fwd"]`` and ``["gru_fwd_cluster"]``), grid
    (fp32 at ``GRID_F32_D``: W split over a group of clusters,
    ``["gru_fwd"]`` and ``["gru_fwd_grid"]``) or streaming (one kernel
    reading W from L2 every step, ``["gru_fwd"]`` and
    ``["gru_fwd_stream"]``), or raise; CPU tensors take the plain
    version."""
    T, B, D = _check_shapes(x, w, lens, h0)
    if _device_kind(x) == "cpu":
        return gru_fwd_reference(x, w, lens, h0)
    lane = _check_cuda((("x", x), ("w", w), ("h0", h0)), lens)
    _kernels.note_flops(gru_fwd_flops(T, B, D))
    plan = _cluster_plan(x.dtype, B, D, x.device, ng=3)
    if plan.route == "grid":
        hs = x.new_empty((T, B, D))
        gates = torch.empty_like(x)
        if B:
            # W split by K over the clusters; scratch: fp32 copies of h
            # and r * h in cluster order (rows padded to whole row tiles),
            # the partial slots [clusters, B, 3D], the step counter
            f32, dev = torch.float32, x.device
            _launch("gru_fwd", lane,
                    (x, w, lens, h0, hs, gates,
                     torch.empty((2, plan.tiles * plan.bb, D), dtype=f32,
                                 device=dev),
                     torch.empty((plan.group, B, 3 * D), dtype=f32,
                                 device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev)),
                    (T, B, D), dev, entry="grid_gru_fwd",
                    also=("gru_fwd_grid",))
        return hs, gates
    if plan.route == "resident":
        bb, route = plan.bb, "gru_fwd_cluster"
    else:
        _check_d(D)
        bb, route = _pick_bb("gru_fwd", B, D, x.device), "gru_fwd_stream"
    hs = x.new_empty((T, B, D))
    gates = torch.empty_like(x)
    if B:
        _launch("gru_fwd", lane, (x, w, lens, h0, hs, gates), (T, B, D, bb),
                x.device, also=(route,))
    return hs, gates


def gru_bwd_data(gates, hs, w, lens, h0, dhs):
    """The backward recurrence: ``(dx, dh0)``. CUDA tensors take the
    route of ``lstm_cluster_plan(..., ng=3)`` for the gates' dtype:
    resident (W read transposed from its resident slices,
    ``LAUNCHES["gru_bwd"]`` and ``["gru_bwd_cluster"]``), grid (fp32 at
    ``GRID_F32_D``: W's rows resident across a group of clusters, read as
    they lie, ``["gru_bwd"]`` and ``["gru_bwd_grid"]``) or streaming (one
    kernel over a transposed copy of W, ``["gru_bwd"]`` and
    ``["gru_bwd_stream"]``), or raise; CPU tensors take the plain
    version."""
    T, B, D = _check_shapes(gates, w, lens, h0)
    if _device_kind(gates) == "cpu":
        return gru_bwd_data_reference(gates, hs, w, lens, h0, dhs)
    _check_like(gates, hs, h0, ("dhs", dhs, hs.shape))
    lane = _check_cuda((("gates", gates), ("hs", hs), ("w", w), ("h0", h0),
                        ("dhs", dhs)), lens)
    plan = _cluster_plan(gates.dtype, B, D, gates.device, ng=3)
    if plan.route == "grid":
        dx = torch.empty_like(gates)
        dh0 = torch.empty_like(h0)
        if B:
            # scratch: the carries, the partial slots, the dgates in
            # cluster order [clusters, rows padded to whole row tiles,
            # 384], the step counter
            carry, slots, counter = _grid_scratch(B, D, gates.device,
                                                  plan.group)
            dg = torch.empty((plan.group, plan.tiles * plan.bb,
                              GRU_GRID_F32_BWD_K), dtype=torch.float32,
                             device=gates.device)
            _launch("gru_bwd", lane, (gates, hs, w, lens, h0, dhs, dx, dh0,
                                      carry, slots, dg, counter), (T, B, D),
                    gates.device, entry="grid_gru_bwd",
                    also=("gru_bwd_grid",))
        return dx, dh0
    if plan.route == "resident":
        bb, route = plan.bb, "gru_bwd_cluster"
    else:
        _check_d(D)
        bb, route = _pick_bb("gru_bwd", B, D, gates.device), "gru_bwd_stream"
    dx = torch.empty_like(gates)
    dh0 = torch.empty_like(h0)
    if B:
        # the streaming kernel reads W^T [3D, D]: both of its products
        # then walk neighbouring columns, as the forward's do
        wt = w if plan.route == "resident" else _wt(w)
        _launch("gru_bwd", lane, (gates, hs, wt, lens, h0, dhs, dx, dh0),
                (T, B, D, bb), gates.device, also=(route,))
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
    plan = dw_plan("gru", gates.dtype, T, B, D, 0, _n_sm(dev))
    if B and T:
        _launch("gru_dw", lane,
                (gates, hs, h0, dx, _dw_partials(plan, dev), dw),
                (T, B, D, plan.splits), dev)
    else:
        dw.zero_()
    return dw


def gru_bwd(gates, hs, w, lens, h0, dhs):
    """The backward: ``(dx, dw, dh0)``, the recurrence then the dW
    reduction (on the card, one launch each, noted as one:
    ``gru_bwd_flops``)."""
    dx, dh0 = gru_bwd_data(gates, hs, w, lens, h0, dhs)
    dw = gru_dw(gates, hs, h0, dx)
    if _device_kind(gates) == "cuda":
        _kernels.note_flops(gru_bwd_flops(*hs.shape[:2], w.shape[0]))
    return dx, dw, dh0


# ----------------------------------------------------------------- autograd

@contextlib.contextmanager
def plain_versions():
    """Run ``gru_scan``, ``lstm_scan`` and ``lstm_scan_proj`` through the
    plain versions on any device, forward and backward, while inside (the
    card-side oracle)."""
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
        ctx.plain, ctx.ledger = plain, _kernels.saved_ledger()
        return hs

    @staticmethod
    def backward(ctx, dhs):
        gates, hs, w, lens, h0 = ctx.saved_tensors
        bwd = gru_bwd_reference if ctx.plain else gru_bwd
        with _kernels.ledger_scope(ctx.ledger):
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


# ===================================================================== LSTM
#
# Gate order i | f | c~ | o. The carries h and c are fp32; every product
# rounds its operands to W's dtype and sums in fp32; a masked step keeps h
# and c. The saved gates are post-activation, in x's dtype.

def _cprev(cs, c0):
    """``[c0; cs[:-1]]`` in cs's dtype: the backward's c_prev is the
    stored (in the bf16 lane, rounded) cell, as in ``_lstm_bwd_call``."""
    return torch.cat([c0[None].to(cs.dtype), cs[:-1]], dim=0)


def _lstm_cell(pre, h, c, m, D):
    """One step from the fp32 pre-activations: ``(h, c, gates)``."""
    i = torch.sigmoid(pre[:, :D])
    f = torch.sigmoid(pre[:, D:2 * D])
    g = torch.tanh(pre[:, 2 * D:3 * D])
    o = torch.sigmoid(pre[:, 3 * D:])
    c_t = f * c + i * g
    h_t = o * torch.tanh(c_t)
    h = m * h_t + (1.0 - m) * h
    c = m * c_t + (1.0 - m) * c
    return h, c, torch.cat([i, f, g, o], dim=-1)


def _lstm_loop(T, B, D, like, lens, h0, c0, w, pre_of):
    """The forward recurrence: ``pre_of(t, h_lp)`` gives step t's fp32
    pre-activations from h rounded to W's dtype."""
    h, c = h0.float(), c0.float()
    hs = like.new_empty((T, B, D))
    cs = like.new_empty((T, B, D))
    gates = like.new_empty((T, B, 4 * D))
    for t in range(T):
        m = (t < lens).float()
        h, c, g4 = _lstm_cell(pre_of(t, h.to(w.dtype).float()), h, c, m, D)
        hs[t] = h.to(like.dtype)
        cs[t] = c.to(like.dtype)
        gates[t] = g4.to(like.dtype)
    return hs, cs, gates


def _lstm_bwd_loop(gates, cs, w, lens, c0, dhs, dcs, step=None):
    """The reverse recurrence (``_lstm_bwd_kernel``): ``(dx, dh, dc)``
    with dx the pre-activation gate gradients in the gates' dtype and
    dh, dc the fp32 carries at t = 0. ``step(t, dgates, dgates_lp)`` is
    called at every step (B15's extra outputs)."""
    T, B, G = gates.shape
    D = G // 4
    wf = w.float()
    cprev = _cprev(cs, c0)
    dh = torch.zeros((B, D), dtype=torch.float32, device=gates.device)
    dc = torch.zeros_like(dh)
    dx = torch.empty_like(gates)
    for t in range(T - 1, -1, -1):
        g4 = gates[t].float()
        i, f, g, o = g4[:, :D], g4[:, D:2 * D], g4[:, 2 * D:3 * D], g4[:, 3 * D:]
        c_prev = cprev[t].float()
        tc = torch.tanh(f * c_prev + i * g)      # the pre-mask cell
        m = (t < lens).float()
        dH = dhs[t].float() + dh
        dC = dcs[t].float() + dc
        dh_t = m * dH
        dc_t = m * dC + dh_t * o * (1.0 - tc * tc)
        dgates = torch.cat([dc_t * g * i * (1.0 - i),
                            dc_t * c_prev * f * (1.0 - f),
                            dc_t * i * (1.0 - g * g),
                            dh_t * tc * o * (1.0 - o)], dim=-1)
        dx[t] = dgates.to(dx.dtype)
        dg_lp = dgates.to(w.dtype).float()
        if step is not None:
            step(t, dgates, dg_lp)
        dh = (1.0 - m) * dH + dg_lp @ wf.T
        dc = (1.0 - m) * dC + dc_t * f
    return dx, dh, dc


def lstm_fwd_reference(x, w, lens, h0, c0):
    """Plain version of B10 (``_lstm_fwd_kernel``), one step at a time:
    ``(hs, cs [T, B, D], gates [T, B, 4D])`` in x's dtype."""
    T, B, D = _check_shapes(x, w, lens, h0, ng=4)
    _check_c0(h0, c0)
    wf = w.float()
    return _lstm_loop(T, B, D, x, lens, h0, c0, w,
                      lambda t, h_lp: x[t].float() + h_lp @ wf)


def lstm_bwd_data_reference(gates, cs, w, lens, h0, c0, dhs, dcs):
    """Plain version of B11's recurrence (``_lstm_bwd_kernel`` without
    its dW): ``(dx [T, B, 4D] in the gates' dtype, dh0, dc0)``."""
    _check_shapes(gates, w, lens, h0, ng=4)
    _check_c0(h0, c0)
    dx, dh, dc = _lstm_bwd_loop(gates, cs, w, lens, c0, dhs, dcs)
    return dx, dh.to(h0.dtype), dc.to(c0.dtype)


def lstm_dw_reference(hs, h0, dx):
    """Plain version of B11's dW: ``sum_t hprev_lp^T dx`` in fp32, cast
    to dx's dtype (which is W's: dx holds the dgates rounded to it)."""
    T, B, G = dx.shape
    hprev = _hprev(hs, h0).reshape(T * B, G // 4).to(dx.dtype).float()
    return (hprev.T @ dx.float().reshape(T * B, G)).to(dx.dtype)


def lstm_bwd_reference(gates, hs, cs, w, lens, h0, c0, dhs, dcs):
    """Plain version of B11 (``_lstm_bwd_call``): ``(dx, dw, dh0,
    dc0)``."""
    dx, dh0, dc0 = lstm_bwd_data_reference(gates, cs, w, lens, h0, c0, dhs,
                                           dcs)
    return dx, lstm_dw_reference(hs, h0, dx), dh0, dc0


def lstm_proj_fwd_reference(xe, wx, b, w, lens, h0, c0):
    """Plain version of B14 (``_lstm_proj_fwd_kernel``): per step
    ``(xe_t @ Wx + b) + h_lp @ W`` in fp32; returns ``(hs, cs, gates)`` in
    xe's dtype."""
    T, B, D, _E = _check_proj(xe, wx, b, w, lens, h0, c0)
    wf, wxf, bf = w.float(), wx.float(), b.float()
    return _lstm_loop(T, B, D, xe, lens, h0, c0, w,
                      lambda t, h_lp: (xe[t].float() @ wxf + bf)
                      + h_lp @ wf)


def lstm_proj_bwd_data_reference(gates, cs, wx, w, lens, h0, c0, dhs, dcs):
    """Plain version of B15's recurrence: ``(dxe [T, B, E] in the gates'
    dtype, dx [T, B, 4D] the dgates rounded to W's dtype, db [4D] fp32
    (the sum of the unrounded dgates), dh0, dc0)``."""
    T, B, G = gates.shape
    _check_shapes(gates, w, lens, h0, ng=4)
    _check_c0(h0, c0)
    wxf = wx.float()
    dxe = gates.new_empty((T, B, wx.shape[0]))
    db = torch.zeros((G,), dtype=torch.float32, device=gates.device)

    def step(t, dgates, dg_lp):
        dxe[t] = (dg_lp @ wxf.T).to(dxe.dtype)
        db.add_(dgates.sum(0))

    dx, dh, dc = _lstm_bwd_loop(gates, cs, w, lens, c0, dhs, dcs, step)
    return dxe, dx, db, dh.to(h0.dtype), dc.to(c0.dtype)


def lstm_proj_dw_reference(xe, hs, h0, dx):
    """Plain version of B15's reductions: ``(dWx = sum xe^T dx, dW = sum
    hprev_lp^T dx)``, fp32 sums cast to dx's dtype."""
    T, B, E = xe.shape
    G = dx.shape[-1]
    d = dx.float().reshape(T * B, G)
    return ((xe.reshape(T * B, E).float().T @ d).to(dx.dtype),
            lstm_dw_reference(hs, h0, dx))


def lstm_proj_bwd_reference(xe, gates, hs, cs, wx, w, lens, h0, c0, dhs,
                            dcs):
    """Plain version of B15 (``_lstm_proj_bwd_call``): ``(dxe, dwx, db,
    dw, dh0, dc0)``, db fp32."""
    dxe, dx, db, dh0, dc0 = lstm_proj_bwd_data_reference(
        gates, cs, wx, w, lens, h0, c0, dhs, dcs)
    dwx, dw = lstm_proj_dw_reference(xe, hs, h0, dx)
    return dxe, dwx, db, dw, dh0, dc0


def lstm_proj_xg_reference(xe, wx, b):
    """Plain version of the resident route's pre-pass (``lstm_proj_xg``):
    ``xe @ Wx + b`` for every step at once, the fp32 sums kept in fp32:
    ``xg [T, B, 4D]``, the first term of the Pallas step's sum."""
    T, B, E = xe.shape
    return (xe.reshape(T * B, E).float() @ wx.float()
            + b.float()).reshape(T, B, wx.shape[1])


def lstm_cluster_fwd_reference(xg, w, lens, h0, c0):
    """Plain version of the resident forward recurrence
    (``lstm_cluster_fwd``): per step ``xg_t + h_lp @ W`` in fp32; returns
    ``(hs, cs, gates)`` in h0's dtype."""
    T, B, G = xg.shape
    wf = w.float()
    return _lstm_loop(T, B, G // 4, h0, lens, h0, c0, w,
                      lambda t, h_lp: xg[t].float() + h_lp @ wf)


def lstm_cluster_bwd_reference(gates, cs, w, lens, h0, c0, dhs, dcs):
    """Plain version of the resident reverse recurrence
    (``lstm_cluster_bwd``): ``(dx [T, B, 4D] the dgates in the gates'
    dtype, db [4D] fp32 (the sum of the unrounded dgates), dh0, dc0)``."""
    db = torch.zeros((gates.shape[-1],), dtype=torch.float32,
                     device=gates.device)
    dx, dh, dc = _lstm_bwd_loop(gates, cs, w, lens, c0, dhs, dcs,
                                lambda t, dgates, dg_lp: db.add_(
                                    dgates.sum(0)))
    return dx, db, dh.to(h0.dtype), dc.to(c0.dtype)


def lstm_proj_dxe_reference(dx, wx):
    """Plain version of the resident route's post-pass (``lstm_proj_dxe``):
    ``dx @ Wx^T`` for every step at once, fp32 sums rounded to dx's dtype
    (dx holds the dgates rounded to W's: the Pallas step's operand)."""
    T, B, G = dx.shape
    return (dx.reshape(T * B, G).float() @ wx.float().T).to(
        dx.dtype).reshape(T, B, wx.shape[0])


def _check_c0(h0, c0):
    if tuple(c0.shape) != tuple(h0.shape) or c0.dtype != h0.dtype:
        raise ValueError(f"c0 {tuple(c0.shape)} {c0.dtype} must match h0 "
                         f"{tuple(h0.shape)} {h0.dtype}")


def _check_proj(xe, wx, b, w, lens, h0, c0):
    """xe [T, B, E], wx [E, 4D], b [4D], w [D, 4D], lens [B, 1], h0, c0
    [B, D]; xe, wx, b, w and h0 of one dtype."""
    D = w.shape[0] if w.dim() == 2 else 0
    if (xe.dim() != 3 or wx.dim() != 2 or w.dim() != 2
            or w.shape[1] != 4 * D or tuple(wx.shape) != (xe.shape[2], 4 * D)
            or tuple(b.shape) != (4 * D,)
            or tuple(h0.shape) != (xe.shape[1], D)
            or tuple(lens.shape) != (xe.shape[1], 1)):
        raise ValueError(f"xe {tuple(xe.shape)}, wx {tuple(wx.shape)}, b "
                         f"{tuple(b.shape)}, w {tuple(w.shape)}, lens "
                         f"{tuple(lens.shape)} and h0 {tuple(h0.shape)} do "
                         "not agree (want [T, B, E], [E, 4D], [4D], "
                         "[D, 4D], [B, 1], [B, D])")
    _check_c0(h0, c0)
    if not (xe.dtype == wx.dtype == b.dtype == w.dtype == h0.dtype):
        raise TypeError(f"xe {xe.dtype}, wx {wx.dtype}, b {b.dtype}, w "
                        f"{w.dtype} and h0 {h0.dtype} must share one dtype")
    T, B, E = xe.shape
    return T, B, D, E


# ------------------------------------------------------------ LSTM kernels

def _wt(w):
    """W^T, contiguous: the backward kernels read it with the forward's
    column pattern."""
    return w.t().contiguous()


class DwPlan(NamedTuple):
    """How a dW reduction is launched (``dw_plan``)."""
    tile: Tuple[int, int]             # output rows x columns of a block
    splits: int                       # fixed row ranges, blockIdx.z
    rows_per_split: int               # a multiple of DW_ROWS
    rows: List[Tuple[int, int]]       # each split's [begin, end) rows
    partials: Optional[Tuple[int, int, int]]  # fp32 [splits, E + D, G]


DW_ROWS = 64               # dW row splits are whole multiples of this


def dw_plan(kind, dtype, T, B, D, E=0, n_sm=132):
    """The launch plan of a dW reduction (``kind`` "lstm": ``[E + D,
    4D]``, "gru": ``[D, 3D]``) over the T*B rows; ``csrc/fused_rnn.cu``'s
    ``launch_dw`` follows it. Tiles: bf16 128 x 256 on the tensor cores
    (128 x 128 for a GRU whose 2D is no multiple of 256, so that no tile
    straddles the c~ columns), one block an SM; fp32 128 x 128 on the
    CUDA cores, two an SM. A tile takes its A operand from xe or hprev
    per 64 output rows, so E and D need only be multiples of 64. Splits:
    the most that keep the grid in one wave on ``n_sm`` SMs, at least
    256 rows each, as whole 64-row chunks (the last split shorter, none
    empty); the wrapper allocates ``partials`` (fp32, summed in split
    order) when there is more than one."""
    G = (3 if kind == "gru" else 4) * D
    M = E + D
    if dtype == torch.bfloat16:
        tile = (128, 256 if kind == "lstm" or D % 128 == 0 else 128)
        per_sm = 1
    else:
        tile, per_sm = (128, 128), 2
    tiles = -(-M // tile[0]) * -(-G // tile[1])
    n_rows = T * B
    splits = max(1, min(per_sm * n_sm // tiles, -(-n_rows // 256)))
    per = DW_ROWS * max(1, -(-n_rows // (DW_ROWS * splits)))
    splits = max(1, -(-n_rows // per))
    return DwPlan(tile, splits, per,
                  [(z * per, min(n_rows, (z + 1) * per))
                   for z in range(splits)],
                  (splits, M, G) if splits > 1 else None)


REC_UNITS = 32             # hidden units a CTA of a resident cluster owns
REC_MAX_CLUSTER = 16       # CTAs a cluster may hold (a non-portable size)
# batch rows a cluster, by the recurrence's gate count: one to three mma
# M tiles (the LSTM's 48-row tile is not built: at D 512 it does not fit)
REC_TILES = {4: (16, 32), 3: (16, 32, 48)}


GRID_UNITS = 16            # hidden units a CTA of the grid route owns
GRID_CLUSTER = 16          # CTAs a cluster of the grid route
GRID_ROWS = 128            # batch rows a row tile of the grid route
GRID_K = 1024              # the grid backward's K: a cluster's gate columns
# the grid route's staged K chunks: [3][128 rows][64 + 8] bf16
_GRID_STAGES = 2 * 3 * GRID_ROWS * (64 + 8)
# the grid route's fp32 lane: 8 units a CTA (a group of D / 128
# clusters), the D it takes, the backward's K (its cluster's 512 gate
# columns) and its staged K chunks [3][128 rows][64 + 4] fp32
GRID_F32_UNITS = 8
GRID_F32_D = (256, 512, 768)
GRID_F32_K = 4 * GRID_F32_UNITS * GRID_CLUSTER
_GRID_F32_STAGES = 4 * 3 * GRID_ROWS * (64 + 4)
# the GRU's fp32 grid route: the forward's K (its cluster's 128 units;
# the rows of W a CTA keeps, over the columns u | r | c~ of D / 16 units)
# and the backward's (its cluster's 384 gate columns)
GRU_GRID_F32_K = GRID_F32_UNITS * GRID_CLUSTER
GRU_GRID_F32_BWD_K = 3 * GRU_GRID_F32_K


class ClusterPlan(NamedTuple):
    """How the bf16 LSTM and GRU recurrences run
    (``lstm_cluster_plan``)."""
    route: str                 # "resident", "grid" or "streaming"
    bb: int                    # batch rows a cluster (grid: a row tile;
    #                            0: streaming)
    cluster: int               # CTAs a cluster: D / REC_UNITS (grid: 16)
    tiles: int                 # clusters in the grid: ceil(B / bb) (grid:
    #                            row tiles, looped inside each step)
    max_clusters: int          # clusters the card holds at once
    smem: int                  # bytes of shared memory a CTA
    units: int = 0             # grid: hidden units a CTA, 16 (fp32: 8;
    #                            0 elsewhere)
    group: int = 0             # grid: clusters a group, D / (16 units)
    #                            (0 elsewhere)


def _rec_smem(kind, bb, D, ng=4):
    """Shared memory of a resident recurrence CTA of ``ng`` gates (4: the
    LSTM, 3: the GRU; ``csrc/fused_rnn.cu``'s ``rc::fwd_smem`` /
    ``bwd_smem``): W's slice [32 ng, D + 8] bf16; the forward's two
    [bb, D + 8] bf16 buffers (the LSTM's h twice, the GRU's h and r * h),
    staged slice [bb, 32] bf16 and K-half partials [4, bb/16, ng, 32, 4]
    fp32; the backward's dgates tile [bb, 32 ng + 8] bf16 and slots
    [D / 32, bb, 32] fp32."""
    n = ng * REC_UNITS
    if kind == "fwd":
        return (2 * (n * (D + 8) + 2 * bb * (D + 8) + bb * REC_UNITS)
                + 4 * (4 * (bb // 16) * ng * 32 * 4))
    return 2 * (n * (D + 8) + bb * (n + 8)) + 4 * D * bb


def _grid_smem(D, dtype=torch.bfloat16, ng=4):
    """Shared memory of a grid-route CTA (``csrc/fused_rnn.cu``'s
    ``rc::grid_fwd_smem`` / ``grid_bwd_smem``, the larger): the
    forward's W columns of its 16 units [64, D + 8] or the backward's W
    rows [D / 16, 1024 + 8], bf16, then the staged K chunks; in fp32
    (``grid_fwd_smem_f32`` / ``grid_bwd_smem_f32``) the columns of 8
    units [32, D + 4] or the rows [D / 16, 512 + 4] and the fp32
    chunks. The GRU's (``ng`` 3, fp32: ``grid_gru_fwd_smem_f32`` /
    ``grid_gru_bwd_smem_f32``): the forward's W rows of its cluster's
    128 units over the three gates of D / 16 units [3 D / 16, 128 + 4],
    or the backward's rows [D / 16, 384 + 4], and the fp32 chunks."""
    if ng == 3:
        return 4 * max(3 * (D // GRID_CLUSTER) * (GRU_GRID_F32_K + 4),
                       D // GRID_CLUSTER * (GRU_GRID_F32_BWD_K + 4)) + \
            _GRID_F32_STAGES
    if dtype == torch.float32:
        return 4 * max(4 * GRID_F32_UNITS * (D + 4),
                       D // GRID_CLUSTER * (GRID_F32_K + 4)) + \
            _GRID_F32_STAGES
    return 2 * max(4 * GRID_UNITS * (D + 8),
                   D // GRID_CLUSTER * (GRID_K + 8)) + _GRID_STAGES


def _grid_shape(dtype, D, ng):
    """The shapes the grid route takes: the LSTM's (``ng`` 4) in bf16 at
    D 768, 1024 and 1280 (a multiple of 256 past the resident route's
    512, with 3 to 5 clusters of 16 CTAs and both recurrences' CTAs
    within ``SMEM_LIMIT``; D 1536 would need 253,440 bytes); the LSTM's
    and the GRU's (``ng`` 3) in fp32 at D 256, 512 and 768
    (``GRID_F32_D``: 2, 4 and 6 clusters of 16 CTAs of 8 units; the
    LSTM's 137,728 to 203,520 bytes a CTA, the GRU's 129,792 to 180,480;
    D 1024 would need 8 clusters, more than an H100 holds at once, and 16
    units a CTA 264 KB)."""
    if dtype == torch.float32:
        return D in GRID_F32_D and _grid_smem(D, dtype, ng) <= SMEM_LIMIT
    return (ng == 4 and dtype == torch.bfloat16
            and D % (GRID_UNITS * GRID_CLUSTER) == 0
            and 3 <= D // (GRID_UNITS * GRID_CLUSTER) <= 5
            and _grid_smem(D) <= SMEM_LIMIT)


def lstm_cluster_plan(dtype, B, D, n_sm=132, max_clusters=None, ng=4):
    """The recurrences' route and tile, by shape, before any launch: the
    LSTM's (``ng`` 4: B10/B11's and B14/B15's) or the GRU's (``ng`` 3:
    B12/B13's). Three routes:

    - resident: bf16, D a multiple of 32 with at most 16 CTAs a cluster
      (D <= 512), both recurrences' CTAs within ``SMEM_LIMIT`` at the
      smallest tile, and the card able to hold a cluster. Each tile of
      ``bb`` batch rows is one cluster of D / 32 CTAs (CTA j owns hidden
      units 32j..32j+31, its 32 ng columns of W resident). Clusters never
      wait on each other, so more tiles than the card holds at once
      (``max_clusters``: the card's count, queried from the kernels; by
      default ``n_sm // (D / 32)``) run in waves; ``bb`` is the tile of
      ``REC_TILES[ng]`` whose shared memory fits with the fewest waves,
      the smaller of two with as many (the LSTM's: 16 while ``ceil(B /
      16)`` clusters fit at once, else 32).
    - grid: the LSTM's bf16 at D 768, 1024 and 1280, where W no longer
      fits one cluster, and the LSTM's and the GRU's fp32 at D 256, 512
      and 768, where fp32 W does not (``_grid_shape``): W resident across
      a group of
      ``group`` clusters of 16 CTAs (each CTA 16 ``units`` in bf16, 8 in
      fp32: D / 256 or D / 128 clusters), all of which the card must hold
      at once (``max_clusters``: the count of the lane's grid kernels'
      16-CTA clusters of ``ng`` gates, queried from the card; by default
      ``n_sm // 16``). One group does every row: ``tiles`` row tiles of
      ``bb`` = 128 loop inside each step.
    - streaming: everything else (fp32 at any other D, the GRU in bf16
      past D 512, other D, a group the card cannot hold) reads W from L2
      every step."""
    if _grid_shape(dtype, D, ng):
        units = GRID_F32_UNITS if dtype == torch.float32 else GRID_UNITS
        group = D // (units * GRID_CLUSTER)
        mc = (n_sm // GRID_CLUSTER if max_clusters is None
              else int(max_clusters))
        if mc < group:
            return ClusterPlan("streaming", 0, 0, 0, 0, 0)
        return ClusterPlan("grid", GRID_ROWS, GRID_CLUSTER,
                           -(-B // GRID_ROWS), mc, _grid_smem(D, dtype, ng),
                           units, group)
    nc = D // REC_UNITS if D % REC_UNITS == 0 else 0
    fits = [bb for bb in REC_TILES[ng]
            if max(_rec_smem("fwd", bb, D, ng), _rec_smem("bwd", bb, D, ng))
            <= SMEM_LIMIT]
    mc = 0
    if dtype == torch.bfloat16 and 1 <= nc <= REC_MAX_CLUSTER and \
            REC_TILES[ng][0] in fits:
        mc = n_sm // nc if max_clusters is None else int(max_clusters)
    if mc < 1:
        return ClusterPlan("streaming", 0, 0, 0, 0, 0)

    def waves(bb):             # ceil(B / bb) clusters, mc at a time
        return -(-(-(-B // bb)) // mc)

    bb = min(fits, key=lambda b: (waves(b), b))
    return ClusterPlan("resident", bb, nc, -(-B // bb), mc,
                       max(_rec_smem("fwd", bb, D, ng),
                           _rec_smem("bwd", bb, D, ng)))


# (device index, route, lane, D, ng) -> the card's count
_max_clusters_of = {}


def _cluster_plan(dtype, B, D, dev, ng=4):
    """``lstm_cluster_plan`` with the card's SM count and, for a shape
    the resident route can take, the number of its clusters (of the
    recurrences of ``ng`` gates, at the smallest tile) the card holds at
    once, or for a shape the grid route can take, the number of the
    lane's grid kernels' 16-CTA clusters of ``ng`` gates at their own
    shared memory (asked of the CUDA runtime once per device, route,
    lane, D and ng)."""
    grid = _grid_shape(dtype, D, ng)
    if not grid and (dtype != torch.bfloat16 or D % REC_UNITS
                     or not 1 <= D // REC_UNITS <= REC_MAX_CLUSTER):
        return lstm_cluster_plan(dtype, B, D, ng=ng)
    lane = _LANES[dtype]
    key = (torch.cuda.current_device() if dev.index is None else dev.index,
           "grid" if grid else "resident", lane, D, ng)
    mc = _max_clusters_of.get(key)
    if mc is None:
        out = torch.zeros(1, dtype=torch.int32)
        with torch.cuda.device(dev):
            err = (_cuda_entry("grid_occupancy")(lane, out.data_ptr(), D,
                                                 ng, None)
                   if grid else _cuda_entry("cluster_occupancy")(
                       lane, out.data_ptr(), D, REC_TILES[ng][0], ng, None))
        if err != 0:
            raise RuntimeError(f"cluster occupancy query for D={D} failed: "
                               f"CUDA error {err}")
        mc = _max_clusters_of[key] = int(out[0])
    return lstm_cluster_plan(dtype, B, D, _n_sm(dev), mc, ng)


def _dw_partials(plan, dev):
    return (None if plan.partials is None else
            torch.empty(plan.partials, dtype=torch.float32, device=dev))


def lstm_fwd(x, w, lens, h0, c0):
    """B10: ``(hs, cs, gates)`` in x's dtype. CUDA tensors take the route
    of ``lstm_cluster_plan`` for x's dtype: resident or grid
    (``lstm_cluster_fwd``'s kernel of that route with x in bf16 as the
    step's first term, ``kernels.LAUNCHES["lstm_fwd"]`` and
    ``["lstm_fwd_cluster"]`` / ``["lstm_fwd_grid"]``) or streaming (one
    kernel reading W from L2 every step, ``["lstm_fwd"]`` and
    ``["lstm_fwd_stream"]``), or raise (every tensor contiguous and
    16-byte aligned); CPU tensors take the plain version."""
    T, B, D = _check_shapes(x, w, lens, h0, ng=4)
    _check_c0(h0, c0)
    if _device_kind(x) == "cpu":
        return lstm_fwd_reference(x, w, lens, h0, c0)
    lane = _check_cuda((("x", x), ("w", w), ("h0", h0), ("c0", c0)), lens)
    _kernels.note_flops(lstm_fwd_flops(T, B, D))
    plan = _cluster_plan(x.dtype, B, D, x.device)
    if plan.route != "streaming":
        return _cluster_fwd(plan, x, w, lens, h0, c0, "lstm_fwd")
    _check_d(D)
    hs = x.new_empty((T, B, D))
    cs = x.new_empty((T, B, D))
    gates = torch.empty_like(x)
    if B:
        _launch("lstm_fwd", lane, (x, w, lens, h0, c0, hs, cs, gates),
                (T, B, D, _pick_bb("lstm_fwd", B, D, x.device)), x.device,
                also=("lstm_fwd_stream",))
    return hs, cs, gates


def lstm_bwd_data(gates, cs, w, lens, h0, c0, dhs, dcs):
    """B11's recurrence: ``(dx, dh0, dc0)``, dx the dgates in the gates'
    dtype. CUDA tensors take the route of ``lstm_cluster_plan`` for the
    gates' dtype: resident or grid (``lstm_cluster_bwd``'s kernel of that
    route without db, W read from its resident slices,
    ``LAUNCHES["lstm_bwd"]`` and ``["lstm_bwd_cluster"]`` /
    ``["lstm_bwd_grid"]``) or streaming (one kernel over a transposed copy
    of W, ``["lstm_bwd"]`` and ``["lstm_bwd_stream"]``), or raise; CPU
    tensors take the plain version."""
    T, B, D = _check_shapes(gates, w, lens, h0, ng=4)
    _check_c0(h0, c0)
    if _device_kind(gates) == "cpu":
        return lstm_bwd_data_reference(gates, cs, w, lens, h0, c0, dhs, dcs)
    _check_like(gates, cs, h0, ("dhs", dhs, cs.shape),
                ("dcs", dcs, cs.shape), ("c0", c0, h0.shape), ng=4)
    lane = _check_cuda((("gates", gates), ("cs", cs), ("w", w), ("c0", c0),
                        ("dhs", dhs), ("dcs", dcs)), lens)
    plan = _cluster_plan(gates.dtype, B, D, gates.device)
    if plan.route != "streaming":
        dx, _db, dh0, dc0 = _cluster_bwd(plan, gates, cs, w, lens, h0, c0,
                                         dhs, dcs, "lstm_bwd", with_db=False)
        return dx, dh0, dc0
    _check_d(D)
    dx = torch.empty_like(gates)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    if B:
        _launch("lstm_bwd", lane,
                (gates, cs, _wt(w), lens, c0, dhs, dcs, dx, dh0, dc0),
                (T, B, D, _pick_bb("lstm_bwd", B, D, gates.device)),
                gates.device, also=("lstm_bwd_stream",))
    return dx, dh0, dc0


def _lstm_dw(name, xe, hs, h0, dx, E):
    """The dW reduction entry: ``[dWx; dW] [E + D, 4D]`` in dx's
    dtype."""
    T, B, G = dx.shape
    D = G // 4
    dev = dx.device
    tensors = [("hs", hs), ("h0", h0), ("dx", dx)]
    if E:
        tensors.append(("xe", xe))
    _check_like(dx, hs, h0, ng=4)
    lane = _check_cuda(tuple(tensors))
    _check_d(D)
    dw = dx.new_empty((E + D, G))
    plan = dw_plan("lstm", dx.dtype, T, B, D, E, _n_sm(dev))
    if B and T:
        _launch(name, lane, (xe if E else None, hs, h0, dx,
                             _dw_partials(plan, dev), dw),
                (T, B, D, E, plan.splits), dev, entry="lstm_dw")
    else:
        dw.zero_()
    return dw


def lstm_dw(hs, h0, dx):
    """B11's dW reduction over the T*B rows. CUDA tensors launch the
    kernel (``LAUNCHES["lstm_dw"]``) or raise; CPU tensors take the
    plain version."""
    if _device_kind(dx) == "cpu":
        return lstm_dw_reference(hs, h0, dx)
    return _lstm_dw("lstm_dw", None, hs, h0, dx, 0)


def lstm_bwd(gates, hs, cs, w, lens, h0, c0, dhs, dcs):
    """B11: ``(dx, dw, dh0, dc0)``, the recurrence then the dW reduction
    (on the card, one launch each, noted as one: ``lstm_bwd_flops``)."""
    dx, dh0, dc0 = lstm_bwd_data(gates, cs, w, lens, h0, c0, dhs, dcs)
    dw = lstm_dw(hs, h0, dx)
    if _device_kind(gates) == "cuda":
        _kernels.note_flops(lstm_bwd_flops(*hs.shape[:2], w.shape[0]))
    return dx, dw, dh0, dc0


def lstm_proj_xg(xe, wx, b):
    """The W-resident routes' pre-pass: ``xg [T, B, 4D]`` fp32 = ``xe @
    Wx + b`` for every step, one tensor-core GEMM (``LAUNCHES
    ["lstm_proj_xg"]``) on CUDA tensors of one dtype, bf16 (``wgmma``) or
    fp32 (3xTF32), else raise; CPU tensors take the plain version."""
    if xe.dim() != 3 or wx.dim() != 2 or tuple(b.shape) != (wx.shape[1],) \
            or wx.shape[0] != xe.shape[2]:
        raise ValueError(f"xe {tuple(xe.shape)}, wx {tuple(wx.shape)} and b "
                         f"{tuple(b.shape)} do not agree (want [T, B, E], "
                         "[E, 4D], [4D])")
    if _device_kind(xe) == "cpu":
        return lstm_proj_xg_reference(xe, wx, b)
    T, B, E = xe.shape
    _check_one_dtype("lstm_proj_xg", xe, wx, b)
    lane = _check_cuda((("xe", xe), ("wx", wx), ("b", b)))
    _check_d(E, "E")
    xg = torch.empty((T, B, wx.shape[1]), dtype=torch.float32,
                     device=xe.device)
    if T * B:
        _launch("lstm_proj_xg", lane, (xe, wx, b, xg),
                (T * B, E, wx.shape[1], 0), xe.device, entry="proj_gemm")
    return xg


def lstm_proj_dxe(dx, wx):
    """The W-resident routes' post-pass: ``dxe [T, B, E]`` = ``dx @
    Wx^T`` for every step (fp32 sums, out in dx's dtype), the pre-pass's
    GEMM with Wx read transposed (``LAUNCHES["lstm_proj_dxe"]``) on CUDA
    tensors of one dtype, bf16 or fp32, else raise; CPU tensors take the
    plain version."""
    if dx.dim() != 3 or wx.dim() != 2 or wx.shape[1] != dx.shape[2]:
        raise ValueError(f"dx {tuple(dx.shape)} and wx {tuple(wx.shape)} do "
                         "not agree (want [T, B, 4D], [E, 4D])")
    if _device_kind(dx) == "cpu":
        return lstm_proj_dxe_reference(dx, wx)
    T, B, G = dx.shape
    _check_one_dtype("lstm_proj_dxe", dx, wx)
    lane = _check_cuda((("dx", dx), ("wx", wx)))
    _check_d(wx.shape[0], "E")
    dxe = dx.new_empty((T, B, wx.shape[0]))
    if T * B:
        _launch("lstm_proj_dxe", lane, (dx, wx, None, dxe),
                (T * B, G, wx.shape[0], 1), dx.device, entry="proj_gemm")
    return dxe


def _check_one_dtype(name, *tensors):
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{name} takes tensors of one dtype; got "
                        + ", ".join(str(t.dtype) for t in tensors))


def _resident_plan(name, w, B, dev):
    """The plan of a W-resident route (resident or grid), or raise."""
    plan = _cluster_plan(w.dtype, B, w.shape[0], dev)
    if plan.route == "streaming":
        raise ValueError(f"{name}: D={w.shape[0]} in {w.dtype} takes the "
                         "streaming route, not a W-resident one "
                         "(lstm_cluster_plan)")
    return plan


def lstm_cluster_fwd(xg, w, lens, h0, c0):
    """B14's recurrence on a W-resident route: ``(hs, cs, gates)`` in h0's
    dtype from the pre-pass's fp32 ``xg [T, B, 4D]``. CUDA tensors launch
    the kernel of the plan's route (``LAUNCHES["lstm_proj_fwd"]`` and
    ``["lstm_proj_fwd_cluster"]``, or ``["lstm_proj_fwd_grid"]`` on the
    grid route: bf16 past D 512, fp32 at ``GRID_F32_D``) or raise; CPU
    tensors take the plain version."""
    D = w.shape[0] if w.dim() == 2 else 0
    if (xg.dim() != 3 or tuple(w.shape) != (D, 4 * D)
            or xg.shape[2] != 4 * D or tuple(h0.shape) != (xg.shape[1], D)
            or tuple(lens.shape) != (xg.shape[1], 1)):
        raise ValueError(f"xg {tuple(xg.shape)}, w {tuple(w.shape)}, lens "
                         f"{tuple(lens.shape)} and h0 {tuple(h0.shape)} do "
                         "not agree (want [T, B, 4D], [D, 4D], [B, 1], "
                         "[B, D])")
    T, B = xg.shape[:2]
    _check_c0(h0, c0)
    if w.dtype != h0.dtype:
        raise TypeError(f"w {w.dtype} and h0 {h0.dtype} must share one "
                        "dtype")
    if xg.dtype != torch.float32:
        raise TypeError(f"xg must be float32 (the pre-pass's sums), got "
                        f"{xg.dtype}")
    if _device_kind(w) == "cpu":
        return lstm_cluster_fwd_reference(xg, w, lens, h0, c0)
    _check_cuda((("w", w), ("xg", xg), ("h0", h0), ("c0", c0)), lens)
    return _cluster_fwd(_resident_plan("lstm_cluster_fwd", w, B, w.device),
                        xg, w, lens, h0, c0)


def _grid_scratch(B, D, dev, slots=0, carry=True):
    """The grid kernels' scratch: the fp32 carries [2, B, D] (none
    without ``carry``), the backward's fp32 slots [2, slots, B, D]
    (``slots`` clusters; none for 0; the GRU's: drh's partials, then dur
    W_ur^T's) and the step counter, zeroed."""
    f32 = torch.float32
    return (torch.empty((2, B, D), dtype=f32, device=dev) if carry else None,
            torch.empty((2, slots, B, D), dtype=f32, device=dev)
            if slots else None,
            torch.zeros(1, dtype=torch.int32, device=dev))


def _cluster_fwd(plan, xg, w, lens, h0, c0, name="lstm_proj_fwd"):
    """Launch the forward recurrence of ``plan``'s route (resident, at its
    tile, or grid) on checked tensors, counted under ``name`` and ``name +
    "_cluster"`` / ``"_grid"``: B14's (``xg`` the pre-pass's fp32) or
    B10's (``xg`` its x: bf16, or fp32, where it is B14's entry). The
    grid route's fp32 lane keeps its carries in hs and cs: no carry
    scratch."""
    T, B, D = xg.shape[0], xg.shape[1], w.shape[0]
    hs = h0.new_empty((T, B, D))
    cs = h0.new_empty((T, B, D))
    gates = h0.new_empty((T, B, 4 * D))
    x_sfx = "" if xg.dtype == torch.float32 else "_x"
    lane = _LANES[w.dtype]
    if B and plan.route == "grid":
        carry, _slots, counter = _grid_scratch(B, D, w.device, carry=lane == 1)
        _launch(name, lane, (xg, w, lens, h0, c0, hs, cs, gates, carry,
                             counter), (T, B, D),
                w.device, entry="grid_lstm_fwd" + x_sfx,
                also=(name + "_grid",))
    elif B:
        _launch(name, lane, (xg, w, lens, h0, c0, hs, cs, gates),
                (T, B, D, plan.bb), w.device,
                entry="cluster_lstm_fwd" + x_sfx, also=(name + "_cluster",))
    return hs, cs, gates


def lstm_cluster_bwd(gates, cs, w, lens, h0, c0, dhs, dcs):
    """B15's recurrence on a W-resident route: ``(dx, db, dh0, dc0)``, dx
    the dgates in the gates' dtype, db fp32; W read from its resident
    slices (no transposed copy). CUDA tensors launch the kernel of the
    plan's route (``LAUNCHES["lstm_proj_bwd"]`` and
    ``["lstm_proj_bwd_cluster"]``, or ``["lstm_proj_bwd_grid"]`` on the
    grid route: bf16 past D 512, fp32 at ``GRID_F32_D``) or raise; CPU
    tensors take the plain version."""
    T, B, D = _check_shapes(gates, w, lens, h0, ng=4)
    _check_c0(h0, c0)
    if _device_kind(gates) == "cpu":
        return lstm_cluster_bwd_reference(gates, cs, w, lens, h0, c0, dhs,
                                          dcs)
    _check_like(gates, cs, h0, ("dhs", dhs, cs.shape),
                ("dcs", dcs, cs.shape), ("c0", c0, h0.shape), ng=4)
    _check_cuda((("gates", gates), ("cs", cs), ("w", w), ("c0", c0),
                 ("dhs", dhs), ("dcs", dcs)), lens)
    return _cluster_bwd(_resident_plan("lstm_cluster_bwd", w, B,
                                       gates.device),
                        gates, cs, w, lens, h0, c0, dhs, dcs)


def _cluster_bwd(plan, gates, cs, w, lens, h0, c0, dhs, dcs,
                 name="lstm_proj_bwd", with_db=True):
    """Launch the reverse recurrence of ``plan``'s route (resident, at its
    tile, or grid) on checked tensors, counted under ``name`` and ``name +
    "_cluster"`` / ``"_grid"``: B15's, or without db (``with_db`` False:
    B11's, db None)."""
    T, B, D = cs.shape
    dev = gates.device
    dx = torch.empty_like(gates)
    db = db_part = None
    if with_db:
        db = torch.zeros((4 * D,), dtype=torch.float32, device=dev)
        if plan.route == "resident":
            # fp32 per-tile db partials, summed in tile order
            db_part = torch.empty((plan.tiles, 4 * D), dtype=torch.float32,
                                  device=dev)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    lane = _LANES[gates.dtype]
    if B and plan.route == "grid":
        carry, slots, counter = _grid_scratch(B, D, dev, plan.group)
        _launch(name, lane, (gates, cs, w, lens, c0, dhs, dcs, dx, db, dh0,
                             dc0, carry, slots, counter), (T, B, D), dev,
                entry="grid_lstm_bwd", also=(name + "_grid",))
    elif B:
        _launch(name, lane,
                (gates, cs, w, lens, c0, dhs, dcs, dx, db_part, db, dh0,
                 dc0), (T, B, D, plan.bb), dev, entry="cluster_lstm_bwd",
                also=(name + "_cluster",))
    return dx, db, dh0, dc0


def lstm_cluster_probe(D, bb, tiles, n_steps, mode, dev):
    """The resident recurrences' cluster exchange alone (no product, no
    cell): ``tiles`` clusters of D / 32 CTAs run ``n_steps`` steps of
    mode 0, the forward's (the h slice to every CTA by DSMEM, one cluster
    barrier), or mode 1, the backward's (partials to their owners' slots,
    barrier, the owners' sums, a second barrier). What one step of the
    barrier and exchange costs on the card; no launch count."""
    out = torch.empty(tiles * (D // REC_UNITS), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _cuda_entry("cluster_lstm_probe")(
            1, out.data_ptr(), n_steps, tiles, D, bb, mode,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cluster probe launch failed: CUDA error {err}")
    return out


def lstm_proj_fwd(xe, wx, b, w, lens, h0, c0):
    """B14: ``(hs, cs, gates)``. CUDA tensors take the route of
    ``lstm_cluster_plan``: resident or grid (the pre-pass
    ``lstm_proj_xg``, then ``lstm_cluster_fwd``'s kernel of the route) or
    streaming (one kernel reading W and Wx from L2 every step,
    ``LAUNCHES["lstm_proj_fwd"]`` and ``["lstm_proj_fwd_stream"]``), or
    raise; CPU tensors take the plain version."""
    T, B, D, E = _check_proj(xe, wx, b, w, lens, h0, c0)
    if _device_kind(xe) == "cpu":
        return lstm_proj_fwd_reference(xe, wx, b, w, lens, h0, c0)
    lane = _check_cuda((("xe", xe), ("wx", wx), ("b", b), ("w", w),
                        ("h0", h0), ("c0", c0)), lens)
    _check_d(E, "E")
    _kernels.note_flops(lstm_proj_fwd_flops(T, B, E, D))
    plan = _cluster_plan(xe.dtype, B, D, xe.device)
    if plan.route != "streaming":
        return _cluster_fwd(plan, lstm_proj_xg(xe, wx, b), w, lens, h0, c0)
    _check_d(D)
    hs = xe.new_empty((T, B, D))
    cs = xe.new_empty((T, B, D))
    gates = xe.new_empty((T, B, 4 * D))
    if B:
        _launch("lstm_proj_fwd", lane,
                (xe, wx, b, w, lens, h0, c0, hs, cs, gates),
                (T, B, D, E, _pick_bb("lstm_proj_fwd", B, D, xe.device, E)),
                xe.device, also=("lstm_proj_fwd_stream",))
    return hs, cs, gates


def lstm_proj_bwd_data(gates, cs, wx, w, lens, h0, c0, dhs, dcs):
    """B15's recurrence: ``(dxe, dx, db, dh0, dc0)``, dx the dgates
    rounded to W's dtype (the reductions' operand), db fp32. CUDA tensors
    take the route of ``lstm_cluster_plan``: resident or grid
    (``lstm_cluster_bwd``'s kernel of the route, then the post-pass
    ``lstm_proj_dxe``) or streaming (one kernel over transposed copies of
    W and Wx, ``LAUNCHES["lstm_proj_bwd"]`` and
    ``["lstm_proj_bwd_stream"]``), or raise; CPU tensors take the plain
    version."""
    T, B, D = _check_shapes(gates, w, lens, h0, ng=4)
    _check_c0(h0, c0)
    if _device_kind(gates) == "cpu":
        return lstm_proj_bwd_data_reference(gates, cs, wx, w, lens, h0, c0,
                                            dhs, dcs)
    E = wx.shape[0]
    if tuple(wx.shape) != (E, 4 * D):
        raise ValueError(f"wx {tuple(wx.shape)} does not fit w "
                         f"{tuple(w.shape)}")
    _check_like(gates, cs, h0, ("dhs", dhs, cs.shape),
                ("dcs", dcs, cs.shape), ("c0", c0, h0.shape),
                ("wx", wx, wx.shape), ng=4)
    lane = _check_cuda((("gates", gates), ("cs", cs), ("wx", wx), ("w", w),
                        ("c0", c0), ("dhs", dhs), ("dcs", dcs)), lens)
    _check_d(E, "E")
    dev = gates.device
    plan = _cluster_plan(gates.dtype, B, D, dev)
    if plan.route != "streaming":
        dx, db, dh0, dc0 = _cluster_bwd(plan, gates, cs, w, lens, h0, c0,
                                        dhs, dcs)
        return lstm_proj_dxe(dx, wx), dx, db, dh0, dc0
    _check_d(D)
    dx = torch.empty_like(gates)
    dxe = gates.new_empty((T, B, E))
    db = torch.zeros((4 * D,), dtype=torch.float32, device=dev)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    if B:
        bb = _pick_bb("lstm_proj_bwd", B, D, dev, E)
        # fp32 per-tile db partials: db sums the unrounded dgates
        db_part = torch.empty((-(-B // bb), 4 * D), dtype=torch.float32,
                              device=dev)
        _launch("lstm_proj_bwd", lane,
                (gates, cs, _wt(w), _wt(wx), lens, c0, dhs, dcs, dx, dxe,
                 db_part, db, dh0, dc0), (T, B, D, E, bb), dev,
                also=("lstm_proj_bwd_stream",))
    return dxe, dx, db, dh0, dc0


def lstm_proj_dw(xe, hs, h0, dx):
    """B15's reductions: ``(dWx, dW)``, one launch
    (``LAUNCHES["lstm_proj_dw"]``) on the card; CPU tensors take the
    plain version."""
    if _device_kind(dx) == "cpu":
        return lstm_proj_dw_reference(xe, hs, h0, dx)
    T, B, E = xe.shape
    if tuple(xe.shape[:2]) != tuple(dx.shape[:2]) or xe.dtype != dx.dtype:
        raise ValueError(f"xe {tuple(xe.shape)} {xe.dtype} does not fit dx "
                         f"{tuple(dx.shape)} {dx.dtype}")
    _check_d(E, "E")
    dw = _lstm_dw("lstm_proj_dw", xe, hs, h0, dx, E)
    return dw[:E], dw[E:]


def lstm_proj_bwd(xe, gates, hs, cs, wx, w, lens, h0, c0, dhs, dcs):
    """B15: ``(dxe, dwx, db, dw, dh0, dc0)`` as ``_lstm_proj_bwd_call``
    returns them (db fp32): the recurrence, then the reductions (on the
    card noted as one: ``lstm_proj_bwd_flops``)."""
    dxe, dx, db, dh0, dc0 = lstm_proj_bwd_data(gates, cs, wx, w, lens, h0,
                                               c0, dhs, dcs)
    dwx, dw = lstm_proj_dw(xe, hs, h0, dx)
    if _device_kind(gates) == "cuda":
        T, B, E = xe.shape
        _kernels.note_flops(lstm_proj_bwd_flops(T, B, E, w.shape[0]))
    return dxe, dwx, db, dw, dh0, dc0


# ---------------------------------------------------------- LSTM autograd

class _LstmScan(torch.autograd.Function):
    """The JAX ``lstm_scan`` custom VJP: the forward saves ``(gates, hs,
    cs, w, lens, h0, c0)``; the backward gives dx, dw, dh0 and dc0 (none
    for lens)."""

    @staticmethod
    def forward(ctx, x, w, lens, h0, c0, plain):
        hs, cs, gates = (lstm_fwd_reference if plain else lstm_fwd)(
            x, w, lens, h0, c0)
        ctx.save_for_backward(gates, hs, cs, w, lens, h0, c0)
        ctx.plain, ctx.ledger = plain, _kernels.saved_ledger()
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        gates, hs, cs, w, lens, h0, c0 = ctx.saved_tensors
        bwd = lstm_bwd_reference if ctx.plain else lstm_bwd
        with _kernels.ledger_scope(ctx.ledger):
            dx, dw, dh0, dc0 = bwd(gates, hs, cs, w, lens, h0, c0,
                                   dhs.to(hs.dtype).contiguous(),
                                   dcs.to(cs.dtype).contiguous())
        return dx, dw, None, dh0, dc0, None


def lstm_scan(x, w, lens, h0, c0, layout="tb"):
    """Fused LSTM over time (B10/B11). x ``[T, B, 4D]`` pre-projected
    gates (+ bias), i | f | c~ | o; w ``[D, 4D]``; lens ``[B, 1]`` fp32;
    h0, c0 ``[B, D]``. Returns ``(hs, cs)`` ``[T, B, D]``, differentiable
    in x, w, h0 and c0. CUDA tensors run the kernels, CPU tensors (or any
    inside ``plain_versions()``) the plain versions. The JAX batch-major
    ``layout="bt"`` (kept there as the record of an experiment; no op
    calls it) is not ported."""
    if layout != "tb":
        raise NotImplementedError(
            f"lstm_scan layout={layout!r}: only the time-major 'tb' layout "
            "of B10/B11 (_lstm_fwd_call / _lstm_bwd_call) is ported; no op "
            "calls the batch-major one")
    return _LstmScan.apply(x, w, lens, h0, c0, _plain[0])


class _LstmScanProj(torch.autograd.Function):
    """The JAX ``lstm_scan_proj`` custom VJP: saves ``(xe, gates, hs, cs,
    wx, b, w, lens, h0, c0)``; gives dxe, dwx, db (in b's dtype), dw, dh0
    and dc0."""

    @staticmethod
    def forward(ctx, xe, wx, b, w, lens, h0, c0, plain):
        hs, cs, gates = (lstm_proj_fwd_reference if plain else
                         lstm_proj_fwd)(xe, wx, b, w, lens, h0, c0)
        ctx.save_for_backward(xe, gates, hs, cs, wx, b, w, lens, h0, c0)
        ctx.plain, ctx.ledger = plain, _kernels.saved_ledger()
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        xe, gates, hs, cs, wx, b, w, lens, h0, c0 = ctx.saved_tensors
        bwd = lstm_proj_bwd_reference if ctx.plain else lstm_proj_bwd
        with _kernels.ledger_scope(ctx.ledger):
            dxe, dwx, db, dw, dh0, dc0 = bwd(
                xe, gates, hs, cs, wx, w, lens, h0, c0,
                dhs.to(hs.dtype).contiguous(),
                dcs.to(cs.dtype).contiguous())
        return dxe, dwx, db.to(b.dtype), dw, None, dh0, dc0, None


def lstm_scan_proj(xe, wx, b, w, lens, h0, c0):
    """Fused LSTM with the input projection inside the recurrence
    (B14/B15): per step ``gates = xe_t @ wx + b + h_prev @ w``. xe ``[T,
    B, E]``, wx ``[E, 4D]``, b ``[4D]``, w ``[D, 4D]``, lens ``[B, 1]``
    fp32, h0, c0 ``[B, D]``. Returns ``(hs, cs)``, differentiable in xe,
    wx, b, w, h0 and c0."""
    return _LstmScanProj.apply(xe, wx, b, w, lens, h0, c0, _plain[0])


def lstm_scan_dp(x, w, lens, h0, c0, mesh, data_axis, interpret=None,
                 layout="tb"):
    raise NotImplementedError(
        "lstm_scan_dp (lstm_scan under shard_map over the data axis) needs "
        "the port's parallel/ package (ROADMAP A9)")
