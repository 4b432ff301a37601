#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``).

Drives the port's main path on one NVIDIA card and checks it:

  python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. builds every kernel of the path from ``paddle_tpu_torch/kernels/
   csrc`` with ``nvcc`` for sm_90a (timed);
3. each kernel against its plain PyTorch version at the shapes the
   main path gives it (max_abs_err <= 1e-5), then timed beside its
   plain version, one PyTorch library call and its bound;
4. two full-width mixed steps with the kernel (under CUDA sync-debug
   "error": the step must not sync the host) against the same steps
   with the plain attention (logits and pools);
5. the main path: a chunked-prefill ``DecodeEngine`` at GPT-2-small
   width (the repo's ``bench.py`` decoder widths, 12 layers, random
   weights from a seed) serving 48 seeded requests, half of them
   sharing a 128-token prefix. The launch counts are zeroed just
   before the requests go in and read just after they all return;
   one request served solo must give the same greedy tokens.

The quantized slice adds, in the same run:

3b. the paged-attention kernel's bfloat16 lane and its quantized lane
   (int8 and fp8-e4m3 pools with random nonzero per-block scales), and
   the quantized matmul (int8 and fp8-e4m3) at the decoder's four
   projection shapes with M=80, each against its plain version, the
   a-priori error bound, and a library yardstick the port never calls;
4b. a full-width int8 KV + int8 weight mixed step with the kernels
   (under sync-debug "error") against the same step with the plain
   versions, from the same zero pools;
5b. the slice's main path: the same engine with an int8 KV pool and
   int8 projection weights (``quant_plan="int8"``) serving the same 48
   requests, with exact launch counts of both kernels, a leak-free
   pool and solo == batched; then the first 16 requests on fp8-e4m3
   KV + fp8 weights and on bfloat16 KV with fp32 weights.

The whole-prompt slice adds, in the same run:

3c. the decode-step kernel (``paged_attention``, B3/B4) at the decode
   shape (16 slots, ragged contexts 0-512) and the row-tiled chunk
   kernel (``paged_attention_chunk``, B5/B6) at two whole-mode prefill
   shapes (rung 384 from position 0; rung 256 after a 128-token prefix
   hit; both with rung padding rows), every lane (float32, bfloat16,
   int8, fp8-e4m3) against its plain version, timed beside it, an SDPA
   yardstick on gathered K/V and its bound; and the chunk kernel at one
   row per slot against the decode kernel;
4c. a full-width ``decode_step`` (16 ragged slots) and the two
   full-width ``prefill`` calls with the kernels (under sync-debug
   "error") against the same calls with the plain versions, in fp32 and
   with int8 KV + int8 weights (phase 4b's quantized gates);
5c. the slice's main paths: ``prefill_mode="whole"`` engines with the
   rungs (16, 32, 64, 128, 256, 384) serving the same 48 requests with
   continuous admission (fp32, and int8 KV + int8 weights) and with
   static admission (fp32), and the first 16 requests on fp8 and bf16
   KV. Launch counts are exact (B3/B4: layers x decode steps, B5/B6:
   layers x prefills, B7: 4 x layers x both, B1/B2: none); every request
   without the shared prefix gives the same greedy tokens continuous,
   static and served solo. Agreement with the chunked runs is reported;
   then ``profile_whole``: a decode step and a rung-384 prefill under
   ``torch.profiler``.

The training slice adds, in the same run:

3d. the flash-attention forward (B8) and its dq and dk/dv backward
   kernels (B9), fp32 and bf16 lanes, against their plain versions at
   the training shape [16, 12, 512, 64] causal, at a ragged T = 500 and
   at a non-causal cross shape (Tq 200, Tk 512); fp32 to 1e-5 (out,
   lse) and 1e-4 (dq, dk, dv), bf16 no further from the fp32 plain
   result than 1.5x the bf16 plain version + 1e-3; a query with no key
   gives zeros and lse NEG_INF; each kernel timed beside its plain
   version, its bound and an SDPA yardstick (forward; backward) that the
   port never calls;
4d. one full-width training step (the transformer LM at bench.py's
   GPT-2-small widths, batch 16 x 512, 12 layers) in fp32 and in bf16
   with the kernels (under sync-debug "error") against the same step
   through the plain flash versions: the loss and every gradient leaf
   within relative L2 1e-4 (fp32) / 2e-2 (bf16);
5d. the slice's main path: ``make_train_step(cfg, lr=0.01)`` in bf16
   with ``attn_impl="flash"`` (``train_transformer``), 3 warm-up + 20
   timed steps (tokens/s, step ms p50, peak memory, every loss finite),
   each flash kernel launched exactly 12 x steps, then
   ``make_kstep_train_step`` with K = 8; then the same steps with
   ``attn_impl="xla"`` (``train_xla``: plain attention, tokens/s and
   loss agreement reported) and a short fp32 run; then
   ``profile_train``: two steps under ``torch.profiler``, with B8 and
   B9's device time per step.

Then it prints the ``profile`` lines, the ``kernels`` JSON line (every
lane of every kernel), the ``serve`` and ``train`` lines and, last,
``{"ok": true, "device": {...}}``. Float32 matmuls run in full float32
(TF32 off). With no CUDA card it exits non-zero at once.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
H100_INT8_OPS = 1979e12         # dense int8 tensor-core TOP/s (and fp8)
ATTN_TOL = 1e-5                 # fp32, kernel vs plain: sum order only
LOGIT_TOL = 1e-4                # through 12 layers of fp32 matmuls
# quant_matmul, kernel vs plain, relative to max|out|: the int8 sums are
# exact on both sides and the fp32 epilogue is the same ops in the same
# order; the e4m3 products are exact in fp32 and only the order of the
# K <= 3072 fp32 sums differs (kernel: sequential per thread; plain: a
# cuBLAS fp32 GEMM)
QMM_TOL = {"int8": 1e-6, "fp8-e4m3": 1e-5}
# the quantized mixed step, kernels vs plain: the attention kernel's
# fp32 sums differ from the plain version's in the last bit, which moves
# a later int8 activation or K/V value across a rounding midpoint now and
# then, and each flip perturbs every later layer by a quantum, so from
# the second layer on the two paths drift apart at the level of the
# model's own quantization noise. What is held: layer 0's K/V (nothing
# upstream differs) equal byte for byte, every scale equal, and the
# kernel path no worse an approximation of the fp32 step than the plain
# path: max|logits - fp32| <= QUANT_ERR_RATIO * the plain path's + 1e-3
QUANT_ERR_RATIO = 1.5


def _check(ok, what):
    """A failed check ends the run (not ``assert``: it must hold under
    ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def _say(*parts):
    print(*parts, flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def _time_ms(fn, flush, reps=20):
    """Median device ms of ``fn()`` over ``reps`` runs, each timed with
    CUDA events after the L2 cache is flushed (a serving step meets
    every layer's pool cold)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _attention_case(dev, T, H, d, B, P, S, N, seed=0):
    """Random pools and a mixed step's row layout: rows 0..S-1 are
    decode rows (ctx 0, 1, block edges, the full table, random), the
    rest are two prefill chunks that share a slot each; every table
    entry is a valid block id, so pages past a row's count are stale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    q = torch.randn((T, H, d), generator=g, device=dev)
    k = torch.randn((N, H, B, d), generator=g, device=dev)
    v = torch.randn((N, H, B, d), generator=g, device=dev)
    tables = rng.integers(0, N, (S, P)).astype(np.int32)
    slots = np.arange(T, dtype=np.int32) % S
    ctx = rng.integers(1, P * B + 1, T).astype(np.int32)
    ctx[:6] = [0, 1, B, B + 1, P * B, 0]
    half = (T - S) // 2
    slots[S:S + half], slots[S + half:] = 3, 7
    ctx[S:S + half] = np.arange(100, 100 + half) + 1
    ctx[S + half:] = np.arange(300, 300 + T - S - half) + 1
    return q, k, v, tables, slots, ctx


def _quant_pools(dev, dtype, N, H, B, d, seed=0):
    """Pools of a bfloat16 or 1-byte payload at the main path's shapes;
    1-byte payloads get random nonzero per-block scales [N, H] that
    dequantize to magnitudes of at most about 2, as calibrated K/V."""
    g = torch.Generator(device=dev).manual_seed(100 + seed)
    shape = (N, H, B, d)
    if dtype == "bfloat16":
        return [torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2)] + [None, None]
    if dtype == "int8":
        pools = [torch.randint(-127, 128, shape, generator=g, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        qmax = 127.0
    else:
        pools = [((torch.rand(shape, generator=g, device=dev) * 2 - 1)
                  * 448.0).to(torch.float8_e4m3fn) for _ in range(2)]
        qmax = 448.0
    scales = [(0.5 + 1.5 * torch.rand((N, H), generator=g, device=dev))
              / qmax for _ in range(2)]
    return pools + scales


def _attention_bound(tables, slots, ctx, H, d, B, P, elem_bytes=4,
                     scaled=False, n_index=2):
    """Least bytes/ops of this call: each K/V position that some row
    needs is read once per slot however many rows read it
    (``elem_bytes`` per element), q/out once, the table entries needed
    once, ``n_index`` int32 arrays of one entry per row (row slots,
    contexts), and for a quantized pool the K and V scales of each
    needed block once. ``slots``/``ctx`` are per row."""
    keys, pages = [], []
    for t in range(len(ctx)):
        n = min(int(ctx[t]), P * B)
        pos = np.arange(n)
        keys.append(tables[slots[t], pos // B].astype(np.int64) * B
                    + pos % B)
        pages.append(slots[t] * P + np.arange(-(-n // B)))
    n_keys = np.unique(np.concatenate(keys)).size
    page_ids = np.unique(np.concatenate(pages))
    n_pages = page_ids.size
    n_blocks = np.unique(tables.reshape(-1)[page_ids]).size
    T = len(ctx)
    nbytes = (n_keys * H * d * elem_bytes * 2 + 2 * T * H * d * 4
              + n_pages * 4 + n_index * T * 4
              + (n_blocks * H * 4 * 2 if scaled else 0))
    flops = 4.0 * np.minimum(ctx, P * B).sum() * H * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# pool dtype -> (kernels-line name, TPU kernel body it replaces)
ATTN_LANES = {
    "float32": ("paged_attention_mixed",
                "paddle_tpu/kernels/paged_attention.py:314"),
    "bfloat16": ("paged_attention_mixed_bf16",
                 "paddle_tpu/kernels/paged_attention.py:314"),
    "int8": ("paged_attention_mixed_quant_int8",
             "paddle_tpu/kernels/paged_attention.py:332"),
    "fp8-e4m3": ("paged_attention_mixed_quant_fp8",
                 "paddle_tpu/kernels/paged_attention.py:332"),
}


def check_attention(pa, dev, flush, shape, dtype="float32"):
    """Phase 3: kernel vs plain at the main path's shapes, and times,
    for one pool dtype (float32: B1; bfloat16: B1's bf16 lane; int8 and
    fp8-e4m3 with per-block scales: B2)."""
    from paddle_tpu_torch import kernels
    T, H, d, B, P, S, N = (shape[k] for k in "THdBPSN")
    q, k, v, tables_np, slots_np, ctx_np = _attention_case(
        dev, T, H, d, B, P, S, N)
    ks = vs = None
    if dtype != "float32":
        del k, v
        k, v, ks, vs = _quant_pools(dev, dtype, N, H, B, d)
    tables, slots, ctx = (torch.from_numpy(a).to(dev)
                          for a in (tables_np, slots_np, ctx_np))
    args = (q, k, v, tables, slots, ctx)
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    got = pa.paged_attention_mixed(*args, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_mixed_reference(*args, **kw)
    err = float((got - want).abs().max())
    _check(err <= ATTN_TOL, f"paged_attention_mixed {dtype} max_abs_err "
           f"{err}")
    _check(not got[ctx == 0].any(), "ctx 0 rows must be exact zeros")
    kernel_ms = _time_ms(lambda: pa.paged_attention_mixed(*args, **kw),
                         flush)
    plain_ms = _time_ms(
        lambda: pa.paged_attention_mixed_reference(*args, **kw), flush)
    # library yardstick: SDPA over the pre-gathered (and dequantized)
    # dense K/V with the length mask (rows with ctx 0 are let see key 0
    # to stay finite)
    kd, vd = _dense_kv(k, v, ks, vs, tables[slots.long()])
    mask = (torch.arange(P * B, device=dev)[None, :]
            < ctx.clamp(min=1)[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(lambda: sdpa(q[:, :, None], kd, vd,
                                       attn_mask=mask), flush)
    bound_ms, bound_by = _attention_bound(
        tables_np, slots_np, ctx_np, H, d, B, P,
        elem_bytes=k.element_size(), scaled=ks is not None)
    kernels.reset_launches()
    name, replaces = ATTN_LANES[dtype]
    return {"name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": replaces,
            "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": dict(shape, dtype=dtype)}


# pool dtype -> (kernels-line name, TPU kernel function it replaces), for
# the decode-step kernel (B3/B4) and the chunk kernel (B5/B6)
DECODE_LANES = {
    "float32": ("paged_attention",
                "paddle_tpu/kernels/paged_attention.py:173"),
    "bfloat16": ("paged_attention_bf16",
                 "paddle_tpu/kernels/paged_attention.py:173"),
    "int8": ("paged_attention_quant_int8",
             "paddle_tpu/kernels/paged_attention.py:213"),
    "fp8-e4m3": ("paged_attention_quant_fp8",
                 "paddle_tpu/kernels/paged_attention.py:213"),
}
CHUNK_LANES = {
    "float32": ("paged_attention_chunk",
                "paddle_tpu/kernels/paged_attention.py:564"),
    "bfloat16": ("paged_attention_chunk_bf16",
                 "paddle_tpu/kernels/paged_attention.py:564"),
    "int8": ("paged_attention_chunk_quant_int8",
             "paddle_tpu/kernels/paged_attention.py:603"),
    "fp8-e4m3": ("paged_attention_chunk_quant_fp8",
                 "paddle_tpu/kernels/paged_attention.py:603"),
}
# the whole-mode prefill shapes: (rung G, prefix-hit start, true length)
CHUNK_SHAPES = ((384, 0, 370), (256, 128, 250))


def _pools_for(dev, dtype, N, H, B, d, seed=0):
    """float32 pools (randn) or ``_quant_pools``: ``(k, v, ks, vs)``."""
    if dtype == "float32":
        g = torch.Generator(device=dev).manual_seed(200 + seed)
        return [torch.randn((N, H, B, d), generator=g, device=dev)
                for _ in range(2)] + [None, None]
    return _quant_pools(dev, dtype, N, H, B, d, seed)


def _dense_kv(k, v, ks, vs, tables):
    """The library yardstick's input: every row's table gathered into a
    dense [rows, H, P*B, d] K and V (dequantized), outside the timing."""
    gather = tables.long()
    kd, vd = k[gather].float(), v[gather].float()
    if ks is not None:
        kd = kd * ks[gather][:, :, :, None, None]
        vd = vd * vs[gather][:, :, :, None, None]
    R, P, H, B, d = kd.shape
    return (kd.permute(0, 2, 1, 3, 4).reshape(R, H, P * B, d),
            vd.permute(0, 2, 1, 3, 4).reshape(R, H, P * B, d))


def _lane_record(name, replaces, source, err, kernel_ms, plain_ms,
                 library_ms, bound, extra):
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "max_abs_err": err, "ms": kernel_ms,
                 "plain_ms": plain_ms, "bound_ms": bound[0],
                 "bound_by": bound[1], "library_ms": library_ms}, **extra)


def check_decode_attention(pa, dev, flush, shape, dtype):
    """Phase 3c: the decode-step kernel (B3, B4 on 1-byte pools) against
    its plain version at the decode shape: 16 slots, ragged contexts
    including 0, 1, block edges and the full 512-key table."""
    S, H, d, B, P, N = (shape[k] for k in "SHdBPN")
    g = torch.Generator(device=dev).manual_seed(4)
    rng = np.random.default_rng(4)
    q = torch.randn((S, H, d), generator=g, device=dev)
    k, v, ks, vs = _pools_for(dev, dtype, N, H, B, d, seed=4)
    tables_np = rng.integers(0, N, (S, P)).astype(np.int32)
    lens_np = rng.integers(1, P * B + 1, S).astype(np.int32)
    lens_np[:7] = [0, 1, B - 1, B, B + 1, 2 * B, P * B]
    tables, lens = (torch.from_numpy(a).to(dev)
                    for a in (tables_np, lens_np))
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    args = (q, k, v, tables, lens)
    got = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(*args, **kw)
    err = float((got - want).abs().max())
    name, replaces = DECODE_LANES[dtype]
    _check(err <= ATTN_TOL, f"{name} max_abs_err {err}")
    _check(not got[lens == 0].any(), "ctx 0 slots must be exact zeros")
    kernel_ms = _time_ms(lambda: pa.paged_attention(*args, **kw), flush)
    plain_ms = _time_ms(lambda: pa.paged_attention_reference(*args, **kw),
                        flush)
    kd, vd = _dense_kv(k, v, ks, vs, tables)
    mask = (torch.arange(P * B, device=dev)[None, :]
            < lens.clamp(min=1)[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(lambda: sdpa(q[:, :, None], kd, vd,
                                       attn_mask=mask), flush)
    bound = _attention_bound(tables_np, np.arange(S), lens_np, H, d, B, P,
                             elem_bytes=k.element_size(),
                             scaled=ks is not None, n_index=1)
    # the chunk kernel at one row per slot against this kernel
    one = pa.paged_attention_chunk(q[:, None].contiguous(), k, v, tables,
                                   lens[:, None].contiguous(), **kw)
    torch.cuda.synchronize()
    g1_err = float((one[:, 0] - got).abs().max())
    _check(g1_err <= ATTN_TOL, f"chunk kernel at G=1 vs {name}: {g1_err}")
    return _lane_record(
        name, replaces, "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        err, kernel_ms, plain_ms, library_ms, bound,
        {"chunk_g1_vs_decode_max_abs_err": g1_err,
         "shape": dict(S=S, H=H, d=d, B=B, P=P, N=N, dtype=dtype)})


def check_chunk_attention(pa, dev, flush, shape, dtype):
    """Phase 3c: the chunk kernel (B5, B6 on 1-byte pools) against its
    plain version at the whole-mode prefill shapes of ``CHUNK_SHAPES``
    (one slot, rung G rows, the last G - true_len of them padding with
    context 0). The record's times are the rung-384 shape's; the
    rung-256 prefix-hit shape's are under ``at_prefix_hit``."""
    H, d, B, P, N = (shape[k] for k in "HdBPN")
    name, replaces = CHUNK_LANES[dtype]
    k, v, ks, vs = _pools_for(dev, dtype, N, H, B, d, seed=5)
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs = []
    for G, start, true_len in CHUNK_SHAPES:
        g = torch.Generator(device=dev).manual_seed(G)
        rng = np.random.default_rng(G)
        q = torch.randn((1, G, H, d), generator=g, device=dev)
        tables_np = rng.permutation(N)[:P].astype(np.int32)[None]
        ctx_np = np.zeros((1, G), np.int32)
        ctx_np[0, :true_len] = start + np.arange(true_len) + 1
        tables, ctx = (torch.from_numpy(a).to(dev)
                       for a in (tables_np, ctx_np))
        args = (q, k, v, tables, ctx)
        got = pa.paged_attention_chunk(*args, **kw)
        torch.cuda.synchronize()
        want = pa.paged_attention_chunk_reference(*args, **kw)
        err = float((got - want).abs().max())
        _check(err <= ATTN_TOL, f"{name} G={G} max_abs_err {err}")
        _check(not got[ctx == 0].any(), "padding rows must be exact zeros")
        kernel_ms = _time_ms(lambda: pa.paged_attention_chunk(*args, **kw),
                             flush)
        plain_ms = _time_ms(
            lambda: pa.paged_attention_chunk_reference(*args, **kw), flush,
            reps=5)
        kd, vd = _dense_kv(k, v, ks, vs, tables)
        # the causal offset mask: row g sees keys < ctx[g] (padding rows
        # are let see key 0 to stay finite)
        mask = (torch.arange(P * B, device=dev)[None, None, :]
                < ctx.clamp(min=1)[:, :, None])[:, None]
        qh = q.permute(0, 2, 1, 3)                     # [1, H, G, d]
        library_ms = _time_ms(lambda: sdpa(qh, kd, vd, attn_mask=mask),
                              flush)
        bound = _attention_bound(tables_np, np.zeros(G, np.int64),
                                 ctx_np[0], H, d, B, P,
                                 elem_bytes=k.element_size(),
                                 scaled=ks is not None, n_index=1)
        recs.append(_lane_record(
            name, replaces,
            "paddle_tpu_torch/kernels/csrc/paged_attention_chunk.cu", err,
            kernel_ms, plain_ms, library_ms, bound,
            {"shape": dict(S=1, G=G, start=start, true_len=true_len, H=H,
                           d=d, B=B, P=P, N=N, dtype=dtype)}))
    rec = recs[0]
    rec["max_abs_err"] = max(r["max_abs_err"] for r in recs)
    rec["at_prefix_hit"] = {k_: recs[1][k_] for k_ in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "shape")}
    return rec


def _qmm_library(lane, x, wq, ws, sx):
    """One PyTorch call computing the same product from PRE-quantized
    activations (so it skips the activation quantization the kernel
    does): ``torch._int_mm`` + the epilogue for int8, ``torch._scaled_mm``
    with row-wise scales for fp8 (which writes bf16: row-wise scaling
    refuses an fp32 output). Returns the callable and a note."""
    if lane == "int8":
        xq = torch.round(x / sx).clamp(-127, 127).to(torch.int8)
        return (lambda: torch._int_mm(xq, wq).float() * sx * ws,
                "torch._int_mm on pre-quantized int8 x, then the epilogue")
    xq = (x / sx).to(torch.float8_e4m3fn)
    wt = wq.t().contiguous().t()                   # column-major operand
    sb = ws.reshape(1, -1)
    return (lambda: torch._scaled_mm(xq, wt, scale_a=sx, scale_b=sb,
                                     out_dtype=torch.bfloat16),
            "torch._scaled_mm, row-wise scales, bf16 out, on "
            "pre-quantized e4m3 x")


def check_quant_matmul(qm, dev, flush, cfg, lane, M=80):
    """Phase 3b: the quantized matmul against its plain version and the
    a-priori bound at the decoder's four projection shapes (one call
    each per layer), with times. ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are means over the four shapes: per launch on the
    main path, where each shape is launched once per layer."""
    hd = cfg.n_heads * cfg.head_dim
    shapes = [("wqkv", cfg.d_model, 3 * hd), ("wo", hd, cfg.d_model),
              ("w1", cfg.d_model, cfg.d_ff), ("w2", cfg.d_ff, cfg.d_model)]
    g = torch.Generator(device=dev).manual_seed(3)
    per, notes = [], set()
    for name, K, N in shapes:
        x = torch.randn((M, K), generator=g, device=dev)
        w = 0.02 * torch.randn((K, N), generator=g, device=dev)
        wq, ws = qm.quantize_weight(w, lane)
        got = qm.quant_matmul(x, wq, ws)
        torch.cuda.synchronize()
        want = qm.quant_matmul_reference(x, wq, ws)
        err = float((got - want).abs().max())
        tol = QMM_TOL[lane] * float(want.abs().max())
        _check(err <= tol, f"quant_matmul {lane} {name} max_abs_err {err} "
               f"> {tol}")
        exact = (x.double() @ w.double())
        bound = qm.quant_matmul_error_bound(x, w, lane).double()
        _check(bool(((got.double() - exact).abs() <= bound).all()),
               f"quant_matmul {lane} {name} outside its error bound")
        kernel_ms = _time_ms(lambda: qm.quant_matmul(x, wq, ws), flush)
        plain_ms = _time_ms(lambda: qm.quant_matmul_reference(x, wq, ws),
                            flush)
        sx = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / (
            127.0 if lane == "int8" else 448.0)
        try:
            fn, note = _qmm_library(lane, x, wq, ws, sx)
            library_ms = _time_ms(fn, flush)
            notes.add(note)
        except (RuntimeError, ValueError) as exc:   # yardstick only
            library_ms = None
            notes.add(f"library call refused: {str(exc)[:120]}")
        nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = 2.0 * M * K * N / H100_INT8_OPS * 1e3
        per.append({"proj": name, "K": K, "N": N, "max_abs_err": err,
                    "tol": tol, "ms": kernel_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations"})
    from paddle_tpu_torch import kernels
    kernels.reset_launches()

    def mean(key):
        vals = [p[key] for p in per]
        return None if None in vals else float(np.mean(vals))

    by = {p["bound_by"] for p in per}
    return {"name": f"quant_matmul_{'int8' if lane == 'int8' else 'fp8'}",
            "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
            "replaces": "paddle_tpu/kernels/quant_matmul.py:"
            + ("84" if lane == "int8" else "94"),
            "max_abs_err": max(p["max_abs_err"] for p in per),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": by.pop() if len(by) == 1 else "bytes",
            "library_ms": mean("library_ms"),
            "library_note": "; ".join(sorted(notes)), "M": M,
            "per_shape": per}


def _mixed_script(cfg, kv, rows, slots_n, dev):
    """Two full-width mixed steps: a 128-token prompt in two chunks,
    then a decode row of another slot joins."""
    T = rows
    rng = np.random.default_rng(1)
    tables = np.zeros((slots_n, kv.blocks_for(cfg.max_seq_len)), np.int32)
    tables[0, :9] = np.arange(10, 19)
    tables[1, :1] = [40]
    prompt = rng.integers(1, cfg.vocab_size, 129).astype(np.int32)
    steps = []
    for i in range(2):
        toks = np.zeros(T, np.int32)
        row_slots = np.zeros(T, np.int32)
        pos = np.zeros(T, np.int32)
        valid = np.zeros(T, bool)
        toks[slots_n:] = prompt[64 * i:64 * (i + 1)]
        pos[slots_n:] = np.arange(64 * i, 64 * (i + 1))
        valid[slots_n:] = True
        if i == 1:
            toks[1], row_slots[1], valid[1] = prompt[128], 1, True
        steps.append((toks, row_slots, pos, valid))
    steps = [[torch.from_numpy(a).to(dev) for a in step] for step in steps]
    return steps, torch.from_numpy(tables).to(dev)


def _run_mixed(dm, make_pools, cfg, params, kv, steps, tables, cal):
    """The script with the kernels (under sync-debug "error") and with
    the plain versions, each from fresh zero pools."""
    results = []
    for impl in (None, "reference"):
        k_pool, v_pool = make_pools(kv, None, *cal)
        for toks, row_slots, pos, valid in steps:
            # the kernel path must not sync the host: the engine's one
            # fence per step is reading the argmax back, after the step
            torch.cuda.set_sync_debug_mode("error" if impl is None else 0)
            try:
                logits, _, _ = dm.mixed_step(cfg, params, k_pool, v_pool,
                                             toks, row_slots, pos, valid,
                                             tables, attn_impl=impl)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        results.append((logits[valid], k_pool, v_pool))
    return results


def check_mixed_step(dm, make_pools, cfg, params, kv, rows, slots_n):
    """Phase 4: two full-width mixed steps with the kernel, and again
    with the plain attention, from the same zero pools."""
    steps, tables = _mixed_script(cfg, kv, rows, slots_n,
                                  params["embed"].device)
    (lk, kk, vk), (lr, kr, vr) = _run_mixed(dm, make_pools, cfg, params,
                                            kv, steps, tables, (None, None))
    _check(bool(torch.isfinite(lk).all()), "non-finite logits")
    err = float((lk - lr).abs().max())
    pool_err = max(float((kk - kr).abs().max()),
                   float((vk - vr).abs().max()))
    _check(err <= LOGIT_TOL, f"mixed_step logits differ by {err}")
    _check(pool_err <= LOGIT_TOL, f"mixed_step pools differ by {pool_err}")
    same = float((lk.argmax(-1) == lr.argmax(-1)).float().mean())
    return {"logits_max_abs_err": err, "pool_max_abs_err": pool_err,
            "argmax_agreement": same, "rows": int(lk.shape[0])}, lr


def check_quant_mixed_step(dm, make_pools, cfg, qparams, kv, cal, rows,
                           slots_n, fp32_logits):
    """Phase 4b: the same two steps with int8 KV and int8 weights, the
    kernels (quant_matmul and the quantized attention lane, under
    sync-debug "error") against their plain versions, from the same
    zero pools under the same calibration; ``fp32_logits`` are the
    plain fp32 step's (see QUANT_ERR_RATIO)."""
    steps, tables = _mixed_script(cfg, kv, rows, slots_n,
                                  qparams["embed"].device)
    (lk, kk, vk), (lr, kr, vr) = _run_mixed(dm, make_pools, cfg, qparams,
                                            kv, steps, tables, cal)
    _check(bool(torch.isfinite(lk).all()), "non-finite quantized logits")
    err = float((lk - lr).abs().max())
    err_k = float((lk - fp32_logits).abs().max())
    err_r = float((lr - fp32_logits).abs().max())
    rec = {"logits_max_abs_err": err, "kernel_err_vs_fp32": err_k,
           "plain_err_vs_fp32": err_r, "err_ratio_limit": QUANT_ERR_RATIO,
           "argmax_agreement": float(
               (lk.argmax(-1) == lr.argmax(-1)).float().mean()),
           "argmax_agreement_vs_fp32": float(
               (lk.argmax(-1) == fp32_logits.argmax(-1)).float().mean()),
           "rows": int(lk.shape[0])}
    for name, a, b in (("k", kk, kr), ("v", vk, vr)):
        diff = (a[0].int() - b[0].int()).abs().reshape(cfg.n_layers, -1)
        rec[f"{name}_quanta_apart_max_per_layer"] = \
            diff.amax(1).tolist()
        rec[f"{name}_elems_apart_per_layer"] = (diff != 0).sum(1).tolist()
        _check(not diff[0].any(), f"layer 0 {name} payloads differ")
        _check(torch.equal(a[1], b[1]), f"per-block {name} scales differ")
    rec["written_block_layers"] = int((kk[1] != 0).any(-1).sum())
    _check(err_k <= QUANT_ERR_RATIO * err_r + 1e-3,
           f"quantized mixed_step: kernel path error vs fp32 {err_k} > "
           f"{QUANT_ERR_RATIO} x the plain path's {err_r}")
    return rec


def _whole_script(cfg, kv, slots_n, dev, seed=3):
    """The whole-mode calls at full width: request A's rung-384 prefill
    (370 real tokens) into slot 0, request B's rung-256 prefill (250
    tail tokens) into slot 1 after a 128-token prefix hit on A's first
    eight blocks, then one decode step over 16 slots with ragged
    contexts 1-512 (slot 2 inactive) whose earlier pages read A's
    blocks. Every array is on the card before any call."""
    rng = np.random.default_rng(seed)
    P = kv.blocks_for(cfg.max_seq_len)
    tables = rng.integers(1200, kv.num_blocks, (slots_n, P)).astype(
        np.int32)                                 # stale past each need
    tables[0, :24] = np.arange(10, 34)
    tables[1, :8] = tables[0, :8]                 # the prefix hit
    tables[1, 8:24] = np.arange(100, 116)
    lens = np.array([370, 378, 0, 1, 15, 16, 17, 100, 200, 255, 256, 300,
                     383, 400, 480, 511], np.int32)[:slots_n]
    for s in range(2, slots_n):
        own = int(lens[s]) // kv.block_size       # the page it writes
        tables[s, :own] = np.resize(np.arange(10, 34), own)
        tables[s, own] = 300 + s
    active = lens > 0
    prompt = rng.integers(1, cfg.vocab_size, 400).astype(np.int32)
    pa_ = np.zeros(384, np.int32)
    pa_[:370] = prompt[:370]
    pb = np.zeros(256, np.int32)
    pb[:250] = prompt[128:378]
    toks = rng.integers(1, cfg.vocab_size, slots_n).astype(np.int32)

    def dev_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {"prefills": [(dev_(pa_), 370, 0, dev_(tables[0])),
                         (dev_(pb), 250, 128, dev_(tables[1]))],
            "decode": (dev_(toks), dev_(tables), dev_(lens),
                       dev_(active)),
            "active": active}


def _run_whole(dm, make_pools, cfg, params, kv, script, cal):
    """The script with the kernels (under sync-debug "error") and with
    the plain versions, each from fresh zero pools. Returns, per run,
    the logits of every real row ([2 + active slots, vocab]) and the
    pools."""
    results = []
    for impl in (None, "reference"):
        k_pool, v_pool = make_pools(kv, None, *cal)
        rows = []
        torch.cuda.set_sync_debug_mode("error" if impl is None else 0)
        try:
            for toks, true_len, start, row in script["prefills"]:
                lg, _, _ = dm.prefill(cfg, params, k_pool, v_pool, toks,
                                      true_len, start, row, attn_impl=impl,
                                      write_limit=cfg.max_seq_len)
                rows.append(lg[None])
            toks, tables, lens, active = script["decode"]
            lg, _, _ = dm.decode_step(cfg, params, k_pool, v_pool, toks,
                                      tables, lens, active, attn_impl=impl)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rows.append(lg[active])        # a mask select reads back: after
        results.append((torch.cat(rows), k_pool, v_pool))
    return results


def check_whole_steps(dm, make_pools, cfg, params, kv, slots_n):
    """Phase 4c: the full-width whole-mode calls with the kernels (B3,
    B5) against the plain versions, from the same zero pools: fp32
    logits within LOGIT_TOL and the pools within ATTN_TOL."""
    script = _whole_script(cfg, kv, slots_n, params["embed"].device)
    (lk, kk, vk), (lr, kr, vr) = _run_whole(dm, make_pools, cfg, params,
                                            kv, script, (None, None))
    _check(bool(torch.isfinite(lk).all()), "non-finite whole-mode logits")
    err = float((lk - lr).abs().max())
    pool_err = max(float((kk - kr).abs().max()),
                   float((vk - vr).abs().max()))
    _check(err <= LOGIT_TOL, f"whole-mode logits differ by {err}")
    _check(pool_err <= ATTN_TOL, f"whole-mode pools differ by {pool_err}")
    return {"logits_max_abs_err": err, "pool_max_abs_err": pool_err,
            "argmax_agreement": float(
                (lk.argmax(-1) == lr.argmax(-1)).float().mean()),
            "rows": int(lk.shape[0])}, lr, script


def check_quant_whole_steps(dm, make_pools, cfg, qparams, kv, cal, script,
                            fp32_logits):
    """Phase 4c: the same calls with int8 KV and int8 weights (B4, B6,
    B7) against their plain versions from the same zero pools under one
    calibration, with phase 4b's gates: layer 0's payloads equal byte for
    byte, every scale equal, and the kernel path's error against the
    fp32 calls at most QUANT_ERR_RATIO x the plain path's (+ 1e-3)."""
    (lk, kk, vk), (lr, kr, vr) = _run_whole(dm, make_pools, cfg, qparams,
                                            kv, script, cal)
    _check(bool(torch.isfinite(lk).all()), "non-finite quantized logits")
    err_k = float((lk - fp32_logits).abs().max())
    err_r = float((lr - fp32_logits).abs().max())
    rec = {"logits_max_abs_err": float((lk - lr).abs().max()),
           "kernel_err_vs_fp32": err_k, "plain_err_vs_fp32": err_r,
           "err_ratio_limit": QUANT_ERR_RATIO,
           "argmax_agreement": float(
               (lk.argmax(-1) == lr.argmax(-1)).float().mean()),
           "rows": int(lk.shape[0])}
    for name, a, b in (("k", kk, kr), ("v", vk, vr)):
        diff = (a[0].int() - b[0].int()).abs().reshape(cfg.n_layers, -1)
        rec[f"{name}_quanta_apart_max_per_layer"] = diff.amax(1).tolist()
        _check(not diff[0].any(), f"whole: layer 0 {name} payloads differ")
        _check(torch.equal(a[1], b[1]), f"whole: {name} scales differ")
    _check(err_k <= QUANT_ERR_RATIO * err_r + 1e-3,
           f"quantized whole calls: kernel path error vs fp32 {err_k} > "
           f"{QUANT_ERR_RATIO} x the plain path's {err_r}")
    return rec


def profile_steps(dm, make_pools, cfg, params, kv, rows, slots_n,
                  n_steps=8, cal=(None, None), key="profile"):
    """Phase 6: where a full-width mixed step's time goes. Runs
    ``n_steps`` steps of 16 decode rows + 64 prefill rows under
    ``torch.profiler`` and returns host wall ms per step, device-busy
    ms per step (the sum of the card's kernel and copy times), the
    idle share, and the costliest device ops."""
    rng = np.random.default_rng(2)
    pages = kv.blocks_for(cfg.max_seq_len)
    tables = np.arange(slots_n * pages, dtype=np.int32).reshape(
        slots_n, pages)
    k_pool, v_pool = make_pools(kv, None, *cal)
    plans = []
    for i in range(n_steps + 2):
        toks = rng.integers(1, cfg.vocab_size, rows).astype(np.int32)
        row_slots = np.zeros(rows, np.int32)
        row_slots[:slots_n] = np.arange(slots_n)
        pos = np.zeros(rows, np.int32)
        pos[:slots_n] = 200 + i                  # decode rows
        pos[0] = 480 + i                         # clear of the chunk
        pos[slots_n:] = (64 * i) % 448 + np.arange(rows - slots_n)
        plans.append((toks, row_slots, pos, np.ones(rows, bool)))

    def step(plan):
        logits, _, _ = dm.mixed_step(cfg, params, k_pool, v_pool, *plan,
                                     tables)
        return torch.argmax(logits, dim=-1).cpu()

    return {key: dict({"rows": rows}, **_profile(
        [lambda plan=plan: step(plan) for plan in plans]))}


def _profile(calls, named=()):
    """Run ``calls[:2]`` to warm up, then the rest under
    ``torch.profiler``: host wall ms per call, device-busy ms per call
    (the sum of the card's kernel and copy times), the idle share, the
    device ops and device-to-host copies per call, the costliest device
    ops and, for each substring in ``named``, the device ms per call of
    the ops whose names hold it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    n_steps = len(calls) - 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls[2:]:
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values()) / n_steps
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
    return {
        "steps": n_steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms or None,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms
        else None,
        "device_kernels_per_step": sum(
            1 for e in prof.events()
            if e.device_type == DeviceType.CUDA) / n_steps,
        "dtoh_copies_per_step": sum(
            1 for e in prof.events() if e.device_type == DeviceType.CUDA
            and "DtoH" in e.name) / n_steps,
        "top_device_ms_per_step": [[n[:60], ms / n_steps]
                                   for n, ms in top],
        **({"named_device_ms_per_step": {
            sub: sum(ms for n, ms in by_name.items() if sub in n) / n_steps
            for sub in named}} if named else {})}


def profile_whole(dm, make_pools, cfg, params, kv, slots_n, n_steps=8):
    """Where the whole-mode time goes: ``n_steps`` decode steps over 16
    active slots (contexts 200+), then ``n_steps`` rung-384 prefills
    (370 real tokens, each into its own blocks), each call ending in the
    engine's small read-back."""
    rng = np.random.default_rng(6)
    dev = params["embed"].device
    pages = kv.blocks_for(cfg.max_seq_len)
    tables = torch.from_numpy(np.arange(slots_n * pages, dtype=np.int32)
                              .reshape(slots_n, pages)).to(dev)
    k_pool, v_pool = make_pools(kv, None)
    active = torch.ones(slots_n, dtype=torch.bool, device=dev)
    dec = [(torch.from_numpy(rng.integers(1, cfg.vocab_size, slots_n)
                             .astype(np.int32)).to(dev),
            torch.full((slots_n,), 200 + i, dtype=torch.int32, device=dev))
           for i in range(n_steps + 2)]
    pre = []
    for i in range(n_steps + 2):
        toks = np.zeros(384, np.int32)
        toks[:370] = rng.integers(1, cfg.vocab_size, 370)
        row = (slots_n * pages + 24 * i + np.arange(pages)).astype(
            np.int32) % kv.num_blocks
        pre.append((torch.from_numpy(toks).to(dev),
                    torch.from_numpy(row).to(dev)))

    def decode(toks, lens):
        lg, _, _ = dm.decode_step(cfg, params, k_pool, v_pool, toks,
                                  tables, lens, active)
        return torch.argmax(lg, dim=-1).cpu()

    def prefill(toks, row):
        lg, _, _ = dm.prefill(cfg, params, k_pool, v_pool, toks, 370, 0,
                              row)
        return torch.argmax(lg).cpu()

    return {"profile_whole": {
        "decode_step": dict({"slots": slots_n}, **_profile(
            [lambda a=a: decode(*a) for a in dec])),
        "prefill_384": dict({"rung": 384, "true_len": 370}, **_profile(
            [lambda a=a: prefill(*a) for a in pre]))}}


def _requests(cfg, n_requests=48, seed=0):
    """The seeded burst: prompts of 16-384 tokens, every other one
    behind a shared 128-token prefix, and 16-48 new tokens each."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, 128).astype(np.int32)
    prompts, max_new = [], []
    for i in range(n_requests):
        n = int(rng.integers(16, 385))
        p = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        if i % 2:                                  # shared prefix
            p = np.concatenate([prefix, p[:max(n - 128, 1)]])
        prompts.append(p)
        max_new.append(int(rng.integers(16, 49)))
    return prompts, max_new


def serve(DecodeEngine, kernels, cfg, params, n_requests=48, seed=0,
          key="serve", engine_kw=None, n_serve=None, reference=None,
          solo_index=1):
    """Phase 5 (and 5b, 5c): a main path. ``engine_kw`` adds the
    engine's KV dtype / quant plan / prefill mode / admission;
    ``n_serve`` serves only the first requests of the burst;
    ``reference`` (token lists of other runs, by name) is compared, not
    gated; request ``solo_index`` (None: none) served solo on a fresh
    engine must give the same tokens. Returns the serve record, the
    launch counts of the run and the generated tokens."""
    prompts, max_new = _requests(cfg, n_requests, seed)
    prompts, max_new = prompts[:n_serve], max_new[:n_serve]
    kw = dict(block_size=16, num_blocks=2048, max_slots=16, eos_id=0,
              **(engine_kw or {}))
    eng = DecodeEngine(cfg, params, **kw)
    eng.warmup()
    torch.cuda.synchronize()
    kernels.reset_launches()                       # the main path: go
    t0 = time.perf_counter()
    futs = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)              # read just after
    st = eng.stats()
    for r, m in zip(results, max_new):
        _check(1 <= len(r.tokens) <= m, f"{len(r.tokens)} tokens, max {m}")
    steps = int(st["steps_total"])
    prefills = int(st["prefills_total"])
    L = cfg.n_layers
    quant_kv = eng.kv.quantized
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    if eng.prefill_mode == "chunked":     # one mixed step per turn
        want["paged_attention_mixed_quant" if quant_kv
             else "paged_attention_mixed"] = L * steps
        dense_calls = steps
    else:             # decode steps, plus one prefill per admission
        want["paged_attention_quant" if quant_kv
             else "paged_attention"] = L * steps
        want["paged_attention_chunk_quant" if quant_kv
             else "paged_attention_chunk"] = L * prefills
        dense_calls = steps + prefills
    if eng.quant_plan:
        want["quant_matmul"] = 4 * L * dense_calls
    _check(launches == want, f"{key}: launches {launches} over {steps} "
           f"steps and {prefills} prefills, want {want}")
    if len(prompts) > kw["max_slots"]:   # some wait while the prefix lands
        _check(st["prefix"]["hit_tokens"] > 0, "the shared prefix never hit")
    eng.pool.assert_consistent()
    eng.close()
    _check(eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0,
           f"leaked blocks: {eng.pool.check_leaks()}")
    hbm_bytes = eng.kv.hbm_bytes
    del eng
    if solo_index is not None:
        # one request served solo, on a fresh engine: the same tokens
        j = solo_index
        solo_eng = DecodeEngine(cfg, params, **kw)
        solo = solo_eng.generate(prompts[j], max_new[j], timeout=600)
        solo_eng.close()
        del solo_eng
        _check(solo.tokens.tolist() == results[j].tokens.tolist(),
               f"{key}: solo and batched greedy tokens differ")
    tokens = [r.tokens.tolist() for r in results]
    n_tok = int(sum(len(t) for t in tokens))
    rec = {
        "requests": len(prompts), "generated_tokens": n_tok,
        "prompt_tokens": int(sum(p.size for p in prompts)),
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_ms_p50": st["ttft_ms_p50"], "ttft_ms_p99": st["ttft_ms_p99"],
        "tpot_ms_p50": st["tpot_ms_p50"],
        "steps": steps, "prefills": prefills,
        "step_ms_p50": st["step_ms_p50"],
        "prefill_mode": st["prefill_mode"], "admission": st["admission"],
        "prefix_hit_rate": st["prefix"]["hit_rate"],
        "preempted": st["preempted_total"],
        "kv_high_water_blocks": st["kv"]["high_water"],
        "solo_equals_batched": solo_index is not None or None,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if st["prefill_mode"] == "chunked":
        rec["mixed_rows"] = st["chunked_prefill"]["mixed_rows"]
    else:
        rec["prompt_rungs"] = st["prompt_rungs"]
    if engine_kw:
        rec.update({"kv_dtype": st["quant"]["kv_dtype"],
                    "weights_quantized": st["quant"]["weights_quantized"],
                    "kv_hbm_bytes": hbm_bytes, "launches": launches})
    for name, ref in (reference or {}).items():
        rec[f"greedy_equal_share_vs_{name}"] = float(np.mean(
            [a == b for a, b in zip(tokens, ref)]))
    return {key: rec}, launches, tokens


def solo_tokens(DecodeEngine, cfg, params, indices, engine_kw,
                n_requests=48, seed=0):
    """The burst's requests ``indices`` served one at a time on one
    fresh engine (each alone in the engine while it runs)."""
    prompts, max_new = _requests(cfg, n_requests, seed)
    eng = DecodeEngine(cfg, params, block_size=16, num_blocks=2048,
                       max_slots=16, eos_id=0, **engine_kw)
    out = {j: eng.generate(prompts[j], max_new[j],
                           timeout=600).tokens.tolist() for j in indices}
    eng.close()
    return out


# ---------------------------------------------------------------- training

H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
FLASH_FWD_TOL = 1e-5            # fp32 out and lse, kernel vs plain
FLASH_GRAD_TOL = 1e-4           # fp32 dq/dk/dv: sums over up to 512 rows
# bf16 lanes: the kernel's error against the fp32 plain result, at most
# this ratio of the bf16 plain version's error + 1e-3 (both round the
# same fp32 math to bf16 once; the sums run in another order)
FLASH_BF16_RATIO = 1.5
# one full-width training step, kernels vs plain flash versions: the
# loss and every gradient leaf by relative L2 (fp32: sum order through
# 12 layers; bf16: every eager op rounds to bf16, and the flash outputs
# differ by an ulp now and then, which later bf16 ops amplify)
TRAIN_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bench.py:800-806: the flagship LM at GPT-2-small widths, batch 16 x 512
TRAIN_CFG = dict(vocab_size=32000, d_model=768, n_heads=12, n_layers=12,
                 d_ff=3072, max_len=512)
TRAIN_B, TRAIN_T, TRAIN_LR = 16, 512, 0.01
# 3d's shapes: (B, H, Tq, Tk, causal); "main" is what training gives B8/B9
FLASH_SHAPES = {"main": (16, 12, 512, 512, True),
                "ragged": (4, 12, 500, 500, True),
                "cross": (4, 12, 200, 512, False)}
FLASH_KERNELS = {
    "flash_attention_fwd": "paddle_tpu/kernels/flash_attention.py:44",
    "flash_attention_dq": "paddle_tpu/kernels/flash_attention.py:93",
    "flash_attention_dkv": "paddle_tpu/kernels/flash_attention.py:133",
}


def _flash_case(dev, dtype, B, H, Tq, Tk, d=64, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(T):
        return torch.randn((B, H, T, d), generator=g, device=dev).to(dtype)

    return randn(Tq), randn(Tk), randn(Tk), randn(Tq)


def _flash_bound(name, dtype, B, H, Tq, Tk, d, causal):
    """Least time of one call: its inputs read once and outputs written
    once (q/k/v/do at the payload's width, lse/delta fp32) over the HBM
    rate, against the products its visible (query, key) pairs need (fwd:
    q.k and p.v; dq: q.k, do.v, ds.k; dk/dv: those two and p^T.do,
    ds^T.q; 2 FLOPs each per element of d) over the dtype's peak (fp32
    CUDA cores, bf16 tensor cores)."""
    e = 2 if dtype == torch.bfloat16 else 4
    rows = np.arange(Tq)
    pairs = B * H * float(np.minimum(rows + 1, Tk).sum() if causal
                          else Tq * Tk)
    bh = B * H
    if name == "flash_attention_fwd":
        nbytes = bh * ((2 * Tq + 2 * Tk) * d * e + Tq * 4)
        flops = 4.0 * d * pairs
    elif name == "flash_attention_dq":
        nbytes = bh * ((3 * Tq + 2 * Tk) * d * e + 2 * Tq * 4)
        flops = 6.0 * d * pairs
    else:
        nbytes = bh * ((2 * Tq + 4 * Tk) * d * e + 2 * Tq * 4)
        flops = 8.0 * d * pairs
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _flash_calls(fa, q, k, v, do, causal, plain=False):
    """Forward, then dq and dk/dv from the forward's lse and delta:
    the kernels, or (``plain``) the plain versions on the same inputs."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    if plain:
        fwd, dq_fn, dkv_fn = (fa.flash_attention_fwd_reference,
                              fa.flash_attention_dq_reference,
                              fa.flash_attention_dkv_reference)
    else:
        fwd, dq_fn, dkv_fn = (fa.flash_attention_fwd, fa.flash_attention_dq,
                              fa.flash_attention_dkv)
    out, lse = fwd(q, k, v, causal, scale)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    dq = dq_fn(q, k, v, do, lse, delta, causal, scale)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, causal, scale)
    return {"out": out, "lse": lse, "delta": delta, "dq": dq, "dk": dk,
            "dv": dv}


def _flash_errors(fa, q, k, v, do, causal):
    """max |kernel - plain| per output (the plain backward from the
    kernel's lse and delta, so each kernel is held on its own inputs);
    for bf16, also each output's error against the fp32 plain result
    and the bf16 plain version's error against it."""
    got = _flash_calls(fa, q, k, v, do, causal)
    torch.cuda.synchronize()
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = dict(zip(("out", "lse"), fa.flash_attention_fwd_reference(
        q, k, v, causal, scale)))
    args = (q, k, v, do, got["lse"], got["delta"], causal, scale)
    ref["dq"] = fa.flash_attention_dq_reference(*args)
    ref["dk"], ref["dv"] = fa.flash_attention_dkv_reference(*args)
    errs = {n: float((got[n].float() - ref[n].float()).abs().max())
            for n in ("out", "lse", "dq", "dk", "dv")}
    if q.dtype != torch.bfloat16:
        return errs, None
    f = [t.float() for t in (q, k, v, do)]
    exact = dict(zip(("out", "lse"), fa.flash_attention_fwd_reference(
        *f[:3], causal, scale)))
    fargs = (*f, got["lse"], got["delta"], causal, scale)
    exact["dq"] = fa.flash_attention_dq_reference(*fargs)
    exact["dk"], exact["dv"] = fa.flash_attention_dkv_reference(*fargs)
    vs_fp32 = {n: (float((got[n].float() - exact[n]).abs().max()),
                   float((ref[n].float() - exact[n]).abs().max()))
               for n in ("out", "dq", "dk", "dv")}
    return errs, vs_fp32


def check_flash(fa, kernels, dev, flush, dtype):
    """Phase 3d: B8 (forward) and B9 (dq, dk/dv), one lane, against
    their plain versions at the training shape [16, 12, 512, 64] causal,
    a ragged T = 500 and a non-causal cross shape Tq 200 / Tk 512; a
    query with no key gives zeros and lse NEG_INF; then each kernel
    timed at the training shape beside its plain version, its bound and
    an SDPA yardstick the port never calls. Returns one kernels-line
    record per kernel."""
    lane = "bf16" if dtype == torch.bfloat16 else "fp32"
    worst = {n: 0.0 for n in ("out", "lse", "dq", "dk", "dv")}
    worst_vs = {}
    for key, (B, H, Tq, Tk, causal) in FLASH_SHAPES.items():
        q, k, v, do = _flash_case(dev, dtype, B, H, Tq, Tk)
        errs, vs_fp32 = _flash_errors(fa, q, k, v, do, causal)
        for n, e in errs.items():
            worst[n] = max(worst[n], e)
        _check(errs["lse"] <= FLASH_FWD_TOL,
               f"flash {lane} {key}: lse differs by {errs['lse']}")
        if vs_fp32 is None:
            _check(errs["out"] <= FLASH_FWD_TOL,
                   f"flash fp32 {key}: out differs by {errs['out']}")
            for n in ("dq", "dk", "dv"):
                _check(errs[n] <= FLASH_GRAD_TOL,
                       f"flash fp32 {key}: {n} differs by {errs[n]}")
        else:
            for n, (err, plain_err) in vs_fp32.items():
                _check(err <= FLASH_BF16_RATIO * plain_err + 1e-3,
                       f"flash bf16 {key}: {n} is {err} from fp32, the "
                       f"plain version {plain_err}")
                w = worst_vs.get(n, (0.0, 0.0))
                worst_vs[n] = (max(w[0], err), max(w[1], plain_err))
        del q, k, v, do
    q, k, v, _do = _flash_case(dev, dtype, 1, 2, 70, 0)
    out, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
    torch.cuda.synchronize()
    _check(not out.any() and bool((lse == fa.NEG_INF).all()),
           f"flash {lane}: a query with no key must give 0 and NEG_INF")

    B, H, Tq, Tk, causal = FLASH_SHAPES["main"]
    q, k, v, do = _flash_case(dev, dtype, B, H, Tq, Tk)
    saved = _flash_calls(fa, q, k, v, do, causal)
    scale = 1.0 / np.sqrt(q.shape[-1])
    bwd_args = (q, k, v, do, saved["lse"], saved["delta"], causal, scale)
    timed = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal, scale),
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal,
                                                     scale)),
        "flash_attention_dq": (
            lambda: fa.flash_attention_dq(*bwd_args),
            lambda: fa.flash_attention_dq_reference(*bwd_args)),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(*bwd_args),
            lambda: fa.flash_attention_dkv_reference(*bwd_args)),
    }
    # yardsticks: SDPA forward (is_causal: top-left, Tq == Tk), and its
    # backward, which gives dq, dk and dv in one call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_lib_ms = _time_ms(lambda: sdpa(q, k, v, is_causal=True), flush)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o = sdpa(qs, ks, vs, is_causal=True)
    bwd_lib_ms = _time_ms(lambda: torch.autograd.grad(
        o, (qs, ks, vs), do, retain_graph=True), flush)
    del o, qs, ks, vs
    err_of = {"flash_attention_fwd": max(worst["out"], worst["lse"]),
              "flash_attention_dq": worst["dq"],
              "flash_attention_dkv": max(worst["dk"], worst["dv"])}
    recs = {}
    for name, (kernel_fn, plain_fn) in timed.items():
        bound = _flash_bound(name, dtype, B, H, Tq, Tk, q.shape[-1], causal)
        rec = _lane_record(
            name if lane == "fp32" else f"{name}_bf16",
            FLASH_KERNELS[name],
            "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            err_of[name], _time_ms(kernel_fn, flush),
            _time_ms(plain_fn, flush, reps=5),
            fwd_lib_ms if name == "flash_attention_fwd" else bwd_lib_ms,
            bound, {"shape": [B, H, Tq, Tk, q.shape[-1]], "causal": causal,
                    "dtype": str(dtype).replace("torch.", "")})
        if name != "flash_attention_fwd":
            rec["library_note"] = ("SDPA backward: dq, dk and dv in one "
                                   "call")
        if worst_vs:
            rec["err_vs_fp32_and_plain_bf16_err"] = {
                n: worst_vs[n] for n in (("out",) if name.endswith("fwd")
                                         else ("dq",) if
                                         name.endswith("dq")
                                         else ("dk", "dv"))}
        recs[name] = rec
    recs["flash_attention_dq"]["sdpa_fwd_bwd_ms"] = fwd_lib_ms + bwd_lib_ms
    kernels.reset_launches()
    return recs


def _param_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in _param_paths(tree[key], f"{prefix}{key}/")]
    if isinstance(tree, list):
        return [p for i, item in enumerate(tree)
                for p in _param_paths(item, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def _loss_and_grads(tt, params, tok, tgt, cfg):
    live = [p.detach().requires_grad_() for p in tt._leaves(params)]
    loss = tt.loss_fn(tt._rebuild(params, live), tok, tgt, cfg)
    return loss.detach(), torch.autograd.grad(loss, live)


def _train_batches(dev, n=4, seed=0):
    """``n`` seeded batches of random tokens and random targets, on the
    card (bench.py's LM feed)."""
    rng = np.random.default_rng(seed)

    def batch():
        return torch.from_numpy(rng.integers(
            0, TRAIN_CFG["vocab_size"], (TRAIN_B, TRAIN_T)).astype(
                np.int32)).to(dev)

    return [batch() for _ in range(n)], [batch() for _ in range(n)]


def check_train_step(tt, kernels, dev, dtype):
    """Phase 4d: one full-width training step's loss and gradients with
    the flash kernels (under sync-debug "error": the step must not sync
    the host) against the same step through their plain versions
    (``attn_impl="flash_reference"``), from the same params and batch."""
    cfg = tt.TransformerConfig(**TRAIN_CFG, dtype=dtype, attn_impl="flash")
    plain_cfg = tt.TransformerConfig(**TRAIN_CFG, dtype=dtype,
                                     attn_impl="flash_reference")
    params = tt.init_params(cfg, seed=0, device=dev)
    toks, tgts = _train_batches(dev, n=1, seed=1)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, grads = _loss_and_grads(tt, params, toks[0], tgts[0], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    L = cfg.n_layers
    for name in FLASH_KERNELS:
        _check(kernels.LAUNCHES[name] == L,
               f"4d: {name} launched {kernels.LAUNCHES[name]}, want {L}")
    p_loss, p_grads = _loss_and_grads(tt, params, toks[0], tgts[0],
                                      plain_cfg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    _check(bool(torch.isfinite(loss)), f"4d: loss {float(loss)}")
    tol = TRAIN_REL_TOL[dtype]
    loss_rel = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
    _check(loss_rel <= tol, f"4d {dtype}: loss {float(loss)} vs plain "
           f"{float(p_loss)}")
    worst, worst_path = 0.0, None
    for path, g, pg in zip(_param_paths(params), grads, p_grads):
        _check(bool(torch.isfinite(g).all()), f"4d: non-finite grad {path}")
        rel = float(torch.linalg.vector_norm((g - pg).float())
                    / torch.linalg.vector_norm(pg.float()).clamp_min(1e-30))
        if rel > worst:
            worst, worst_path = rel, path
    _check(worst <= tol, f"4d {dtype}: grad {worst_path} relative L2 "
           f"{worst} > {tol}")
    return {"dtype": str(dtype).replace("torch.", ""), "loss": float(loss),
            "plain_loss": float(p_loss), "loss_rel_err": loss_rel,
            "grad_max_rel_l2": worst, "grad_worst_leaf": worst_path,
            "grad_leaves": len(grads), "tol": tol,
            "sync_debug": "error"}


def _train_flops(cfg):
    """Model FLOPs of one step: 6 per matmul weight per token (forward
    and backward), plus attention: q.k and p.v over the causal pairs,
    three times over (forward, backward)."""
    D, Fd, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    n_mm = L * (4 * D * D + 2 * D * Fd) + V * D
    pairs = TRAIN_T * (TRAIN_T + 1) / 2
    attn = L * 3 * 4 * TRAIN_B * cfg.n_heads * pairs * cfg.head_dim
    return 6.0 * n_mm * TRAIN_B * TRAIN_T + attn


def train(tt, kernels, dev, key="train_transformer", dtype=torch.bfloat16,
          attn_impl="flash", warmup=3, steps=20, kstep=8, kstep_calls=2,
          reference=None):
    """Phase 5d: a training run. ``make_train_step(cfg, lr=0.01)`` at
    bench.py's shape: ``warmup`` steps, then ``steps`` timed in one
    window (tokens/s; step ms p50 from CUDA events between steps, no
    host syncs), every loss read back once at the end and held finite.
    The launch counts are zeroed just before the first step and read
    just after the last: each flash kernel runs once per layer and step
    (none for ``attn_impl="xla"``). With ``kstep``, then
    ``make_kstep_train_step`` with that K, ``kstep_calls`` timed calls
    after one warm-up call, its launches exact too. ``reference``: the
    per-step losses of another run, compared (reported, not gated)."""
    cfg = tt.TransformerConfig(**TRAIN_CFG, dtype=dtype, attn_impl=attn_impl)
    params = tt.init_params(cfg, seed=0, device=dev)
    velocity = tt._rebuild(params, [torch.zeros_like(p)
                                    for p in tt._leaves(params)])
    toks, tgts = _train_batches(dev)
    step = tt.make_train_step(cfg, lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.n_layers
    per_step = L if attn_impl == "flash" else 0
    kernels.reset_launches()                       # the main path: go
    losses = []
    for i in range(warmup):
        params, velocity, loss = step(params, velocity, toks[i % 4],
                                      tgts[i % 4])
        losses.append(loss)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + 1)]
    t0 = time.perf_counter()
    for i in range(steps):
        events[i].record()
        j = (warmup + i) % 4
        params, velocity, loss = step(params, velocity, toks[j], tgts[j])
        losses.append(loss)
    events[steps].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)              # read just after
    n = warmup + steps
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for name in FLASH_KERNELS:
        want[name] = per_step * n
    _check(launches == want, f"{key}: launches {launches} over {n} steps, "
           f"want {want}")
    loss_list = torch.stack(losses).cpu().tolist()
    _check(all(np.isfinite(loss_list)), f"{key}: non-finite loss "
           f"{loss_list}")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    tokens = TRAIN_B * TRAIN_T
    flops = _train_flops(cfg)
    rec = {"dtype": str(dtype).replace("torch.", ""),
           "attn_impl": attn_impl, "batch": [TRAIN_B, TRAIN_T],
           "layers": L, "lr": TRAIN_LR, "warmup_steps": warmup,
           "timed_steps": steps, "wall_s": wall,
           "tokens_per_s": tokens * steps / wall,
           "step_ms_p50": float(np.median(step_ms)),
           "step_ms_min": float(np.min(step_ms)),
           "model_tflop_per_step": flops / 1e12,
           "model_tflops_per_s": flops * steps / wall / 1e12,
           "mfu_vs_bf16_peak": flops * steps / wall / H100_BF16_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_first": loss_list[0], "loss_last": loss_list[-1],
           "losses_finite": len(loss_list), "launches": launches}
    if reference is not None:
        m = min(len(reference), len(loss_list))
        rec["loss_max_abs_diff_vs_flash"] = float(np.max(np.abs(
            np.asarray(loss_list[:m]) - np.asarray(reference[:m]))))
    if kstep:
        fn = tt.make_kstep_train_step(cfg, lr=TRAIN_LR)
        tk_ = torch.stack([toks[i % 4] for i in range(kstep)])
        gk_ = torch.stack([tgts[i % 4] for i in range(kstep)])
        kernels.reset_launches()                   # the K-step path: go
        params, velocity, kl = fn(params, velocity, tk_, gk_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        klosses = [kl]
        for _ in range(kstep_calls):
            params, velocity, kl = fn(params, velocity, tk_, gk_)
            klosses.append(kl)
        torch.cuda.synchronize()
        kwall = time.perf_counter() - t0
        klaunch = dict(kernels.LAUNCHES)           # read just after
        kn = kstep * (kstep_calls + 1)
        kwant = dict.fromkeys(kernels.LAUNCHES, 0)
        for name in FLASH_KERNELS:
            kwant[name] = per_step * kn
        _check(klaunch == kwant, f"{key} kstep: launches {klaunch}, want "
               f"{kwant}")
        kvals = torch.cat(klosses).cpu().tolist()
        _check(all(np.isfinite(kvals)), f"{key} kstep: non-finite loss")
        rec.update({"kstep_k": kstep, "kstep_timed_calls": kstep_calls,
                    "kstep_tokens_per_s": tokens * kstep * kstep_calls
                    / kwall, "kstep_loss_last": kvals[-1],
                    "kstep_launches": klaunch})
    del params, velocity
    kernels.reset_launches()
    return {key: rec}, launches, loss_list


def profile_train(tt, dev, n_steps=2):
    """Where a full-width bf16 training step's time goes: ``n_steps``
    steps under ``torch.profiler`` after two warm-up steps, with B8 and
    B9's device ms per step."""
    cfg = tt.TransformerConfig(**TRAIN_CFG, attn_impl="flash")
    params = tt.init_params(cfg, seed=0, device=dev)
    velocity = tt._rebuild(params, [torch.zeros_like(p)
                                    for p in tt._leaves(params)])
    toks, tgts = _train_batches(dev)
    step = tt.make_train_step(cfg, lr=TRAIN_LR)

    def call(i):
        loss = step(params, velocity, toks[i % 4], tgts[i % 4])[2]
        return loss.cpu()

    return {"profile_train": dict(
        {"batch": [TRAIN_B, TRAIN_T], "dtype": "bfloat16"},
        **_profile([lambda i=i: call(i) for i in range(n_steps + 2)],
                   named=("tc::fwd_kernel", "tc::dq_kernel",
                          "tc::dkv_kernel")))}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the "
              "card", file=sys.stderr)
        return 1
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                          init_params, make_pools)
    from paddle_tpu_torch.serving import decode_model as dm
    from paddle_tpu_torch.serving.decode_engine import _probe_kv_absmax
    from paddle_tpu_torch.models import transformer as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = _card_line()
    _say(card)

    t0 = time.perf_counter()
    built = _build.build()
    _say(f"build: {time.perf_counter() - t0:.3f} s, nvcc ran for "
         f"{built or 'none (cached)'}")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                _say(f"ptxas {name}: {line.strip()}")

    cfg = DecoderConfig(vocab_size=32000, d_model=768, n_heads=12,
                        head_dim=64, n_layers=12, d_ff=3072,
                        max_seq_len=512)
    kv = cfg.kv_config(block_size=16, num_blocks=2048)
    max_slots, budget = 16, 64
    shape = {"T": max_slots + budget, "H": cfg.n_heads,
             "d": cfg.head_dim, "B": kv.block_size,
             "P": kv.blocks_for(cfg.max_seq_len), "S": max_slots,
             "N": kv.num_blocks}
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    krec = check_attention(pa, dev, flush, shape)
    _say(f"kernel check: paged_attention_mixed max_abs_err "
         f"{krec['max_abs_err']:.3e} <= {ATTN_TOL}")
    lanes = {"float32": krec}
    for dtype in ("bfloat16", "int8", "fp8-e4m3"):
        lanes[dtype] = check_attention(pa, dev, flush, shape, dtype)
        _say(f"kernel check: {lanes[dtype]['name']} max_abs_err "
             f"{lanes[dtype]['max_abs_err']:.3e} <= {ATTN_TOL}")
    qrecs = {}
    for lane in ("int8", "fp8-e4m3"):
        qrecs[lane] = check_quant_matmul(qm, dev, flush, cfg, lane,
                                         M=shape["T"])
        _say(f"kernel check: {qrecs[lane]['name']} max_abs_err "
             f"{qrecs[lane]['max_abs_err']:.3e} (<= {QMM_TOL[lane]} of "
             f"max|out| per shape, and within quant_matmul_error_bound); "
             f"library: {qrecs[lane]['library_note']}")
    # 3c: the decode-step kernel (B3/B4) and the chunk kernel (B5/B6)
    dlanes, clanes = {}, {}
    for dtype in ("float32", "bfloat16", "int8", "fp8-e4m3"):
        dlanes[dtype] = check_decode_attention(pa, dev, flush, shape, dtype)
        clanes[dtype] = check_chunk_attention(pa, dev, flush, shape, dtype)
        for rec in (dlanes[dtype], clanes[dtype]):
            _say(f"kernel check: {rec['name']} max_abs_err "
                 f"{rec['max_abs_err']:.3e} <= {ATTN_TOL}")
    # 3d: the flash-attention forward (B8) and backward (B9), both lanes
    flanes = {}
    for dtype in (torch.float32, torch.bfloat16):
        flanes[dtype] = check_flash(fa, kernels, dev, flush, dtype)
        for rec in flanes[dtype].values():
            _say(f"kernel check: {rec['name']} max_abs_err "
                 f"{rec['max_abs_err']:.3e}")
    kernels.reset_launches()
    del flush
    _say(f"kernel phases done at {time.perf_counter() - t0:.1f} s")

    params = init_params(cfg, seed=0)
    mrec, fp32_logits = check_mixed_step(dm, make_pools, cfg, params, kv,
                                         shape["T"], max_slots)
    _say("mixed_step check: " + json.dumps(mrec))
    kv8 = cfg.kv_config(block_size=16, num_blocks=2048, dtype="int8")
    qparams = dm.quantize_decoder_params(cfg, params, "int8")
    cal = _probe_kv_absmax(cfg, qparams)
    mqrec = check_quant_mixed_step(dm, make_pools, cfg, qparams, kv8, cal,
                                   shape["T"], max_slots, fp32_logits)
    _say("quant mixed_step check: " + json.dumps(mqrec))
    # 4c: the whole-mode calls, fp32 and int8 KV + int8 weights
    wrec, fp32_whole, script = check_whole_steps(dm, make_pools, cfg,
                                                 params, kv, max_slots)
    _say("whole-mode steps check: " + json.dumps(wrec))
    wqrec = check_quant_whole_steps(dm, make_pools, cfg, qparams, kv8, cal,
                                    script, fp32_whole)
    _say("quant whole-mode steps check: " + json.dumps(wqrec))
    # 4d: one full-width training step, kernels vs plain flash versions
    for dtype in (torch.float32, torch.bfloat16):
        torch.cuda.empty_cache()
        _say("train step check: " + json.dumps(
            check_train_step(tt, kernels, dev, dtype)))
    del qparams, fp32_logits, fp32_whole, script
    _say(f"step phases done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    srec, launches, fp32_tokens = serve(DecodeEngine, kernels, cfg, params)
    krec["launches"] = launches["paged_attention_mixed"]
    torch.cuda.synchronize()
    prec = profile_steps(dm, make_pools, cfg, params, kv, shape["T"],
                         max_slots)

    # the slice's main path: int8 KV + int8 weights, the same 48 requests
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sqrec, qlaunch, q_tokens = serve(
        DecodeEngine, kernels, cfg, params, key="serve_quant",
        engine_kw=dict(kv_config=kv8, quant_plan="int8"),
        reference={"fp32": fp32_tokens})
    lanes["int8"]["launches"] = qlaunch["paged_attention_mixed_quant"]
    qrecs["int8"]["launches"] = qlaunch["quant_matmul"]
    # short runs: fp8 KV + fp8 weights, and bf16 KV with fp32 weights
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s8rec, f8launch, f8_tokens = serve(
        DecodeEngine, kernels, cfg, params, key="serve_fp8", n_serve=16,
        engine_kw=dict(kv_config=cfg.kv_config(16, 2048, "fp8-e4m3"),
                       quant_plan="fp8-e4m3"))
    lanes["fp8-e4m3"]["launches"] = f8launch["paged_attention_mixed_quant"]
    qrecs["fp8-e4m3"]["launches"] = f8launch["quant_matmul"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sbrec, bflaunch, bf_tokens = serve(
        DecodeEngine, kernels, cfg, params, key="serve_bf16", n_serve=16,
        engine_kw=dict(kv_config=cfg.kv_config(16, 2048, "bfloat16")))
    lanes["bfloat16"]["launches"] = bflaunch["paged_attention_mixed"]
    torch.cuda.synchronize()
    qparams = dm.quantize_decoder_params(cfg, params, "int8")
    pqrec = profile_steps(dm, make_pools, cfg, qparams, kv8, shape["T"],
                          max_slots, cal=cal, key="profile_quant")
    del qparams
    _say(f"chunked serving phases done at {time.perf_counter() - t0:.1f} s")

    # 5c: the slice's main paths, whole-prompt prefill
    rungs = (16, 32, 64, 128, 256, 384)
    whole = dict(prefill_mode="whole", prompt_rungs=rungs)
    whole_runs = {}
    # (key, engine options, requests, the chunked run of the same pool
    # and weights)
    for key, kw, n_serve, chunked in (
            ("serve_whole", {}, None, fp32_tokens),
            ("serve_whole_static", dict(admission="static"), None,
             fp32_tokens),
            ("serve_whole_quant", dict(kv_config=kv8, quant_plan="int8"),
             None, q_tokens),
            ("serve_whole_fp8",
             dict(kv_config=cfg.kv_config(16, 2048, "fp8-e4m3"),
                  quant_plan="fp8-e4m3"), 16, f8_tokens),
            ("serve_whole_bf16",
             dict(kv_config=cfg.kv_config(16, 2048, "bfloat16")), 16,
             bf_tokens)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        refs = {"chunked": chunked}
        if "serve_whole" in whole_runs:
            refs["whole_fp32"] = whole_runs["serve_whole"][2]
        whole_runs[key] = serve(DecodeEngine, kernels, cfg, params,
                                key=key, engine_kw=dict(whole, **kw),
                                n_serve=n_serve, reference=refs,
                                solo_index=None)
    # requests without the shared prefix (even index): the same greedy
    # tokens continuous, static and served solo
    even = list(range(0, 48, 2))
    solo = solo_tokens(DecodeEngine, cfg, params, even, whole)
    cont = whole_runs["serve_whole"][2]
    stat = whole_runs["serve_whole_static"][2]
    for j in even:
        _check(cont[j] == stat[j] == solo[j],
               f"request {j}: whole continuous / static / solo tokens "
               "differ")
    for key in ("serve_whole", "serve_whole_static"):
        whole_runs[key][0][key]["no_prefix_equal_solo_and_across"] = \
            len(even)
    for dtype, key in (("float32", "serve_whole"),
                       ("int8", "serve_whole_quant"),
                       ("fp8-e4m3", "serve_whole_fp8"),
                       ("bfloat16", "serve_whole_bf16")):
        launch = whole_runs[key][1]
        sfx = "_quant" if dtype in ("int8", "fp8-e4m3") else ""
        dlanes[dtype]["launches"] = launch["paged_attention" + sfx]
        clanes[dtype]["launches"] = launch["paged_attention_chunk" + sfx]
    torch.cuda.synchronize()
    pwrec = profile_whole(dm, make_pools, cfg, params, kv, max_slots)
    _say(f"whole serving phases done at {time.perf_counter() - t0:.1f} s")

    # 5d: the training slice's main path: bf16 with the flash kernels,
    # then the same steps with the plain attention ("xla") and a short
    # fp32 run (the fp32 lanes' launches)
    del params
    train_runs = {}
    for key, kw in (("train_transformer", {}),
                    ("train_xla", dict(attn_impl="xla", kstep=None)),
                    ("train_fp32", dict(dtype=torch.float32, warmup=2,
                                        steps=5, kstep=None))):
        torch.cuda.empty_cache()
        ref = (train_runs["train_transformer"][2] if key == "train_xla"
               else None)
        train_runs[key] = train(tt, kernels, dev, key=key, reference=ref,
                                **kw)
    for dtype, key in ((torch.float32, "train_fp32"),
                       (torch.bfloat16, "train_transformer")):
        for name, rec in flanes[dtype].items():
            rec["launches"] = train_runs[key][1][name]
    torch.cuda.empty_cache()
    ptrec = profile_train(tt, dev)
    _say(f"training phases done at {time.perf_counter() - t0:.1f} s")

    _say(json.dumps(prec))
    _say(json.dumps(pqrec))
    _say(json.dumps(pwrec))
    _say(json.dumps(ptrec))
    _say(json.dumps({"kernels": [
        krec, lanes["bfloat16"], lanes["int8"], lanes["fp8-e4m3"],
        *(dlanes[d] for d in ("float32", "bfloat16", "int8", "fp8-e4m3")),
        *(clanes[d] for d in ("float32", "bfloat16", "int8", "fp8-e4m3")),
        qrecs["int8"], qrecs["fp8-e4m3"],
        *(flanes[d][n] for d in (torch.float32, torch.bfloat16)
          for n in FLASH_KERNELS)]}))
    _say(json.dumps(srec))
    for rec in (sqrec, s8rec, sbrec):
        _say(json.dumps(rec))
    for key in whole_runs:
        _say(json.dumps(whole_runs[key][0]))
    for key in train_runs:
        _say(json.dumps(train_runs[key][0]))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
