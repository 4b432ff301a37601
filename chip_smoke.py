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

Then it prints the ``kernels`` JSON line, the ``serve`` JSON line and,
last, ``{"ok": true, "device": {...}}``. Float32 matmuls run in full
float32 (TF32 off). With no CUDA card it exits non-zero at once.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
ATTN_TOL = 1e-5                 # fp32, kernel vs plain: sum order only
LOGIT_TOL = 1e-4                # through 12 layers of fp32 matmuls


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


def _attention_bound(tables, slots, ctx, H, d, B, P):
    """Least bytes/ops of this call: each K/V position that some row
    needs is read once, q/out once, the table entries needed once."""
    keys, pages = [], []
    for t in range(len(ctx)):
        n = min(int(ctx[t]), P * B)
        pos = np.arange(n)
        keys.append(tables[slots[t], pos // B].astype(np.int64) * B
                    + pos % B)
        pages.append(slots[t] * P + np.arange(-(-n // B)))
    n_keys = np.unique(np.concatenate(keys)).size
    n_pages = np.unique(np.concatenate(pages)).size
    T = len(ctx)
    nbytes = (n_keys * H * d * 4 * 2 + 2 * T * H * d * 4
              + n_pages * 4 + 2 * T * 4)
    flops = 4.0 * np.minimum(ctx, P * B).sum() * H * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_attention(pa, dev, flush, shape):
    """Phase 3: kernel vs plain at the main path's shapes, and times."""
    from paddle_tpu_torch import kernels
    T, H, d, B, P, S, N = (shape[k] for k in "THdBPSN")
    q, k, v, tables_np, slots_np, ctx_np = _attention_case(
        dev, T, H, d, B, P, S, N)
    tables, slots, ctx = (torch.from_numpy(a).to(dev)
                          for a in (tables_np, slots_np, ctx_np))
    args = (q, k, v, tables, slots, ctx)
    got = pa.paged_attention_mixed(*args)
    torch.cuda.synchronize()
    want = pa.paged_attention_mixed_reference(*args)
    err = float((got - want).abs().max())
    _check(err <= ATTN_TOL, f"paged_attention_mixed max_abs_err {err}")
    _check(not got[ctx == 0].any(), "ctx 0 rows must be exact zeros")
    kernel_ms = _time_ms(lambda: pa.paged_attention_mixed(*args), flush)
    plain_ms = _time_ms(
        lambda: pa.paged_attention_mixed_reference(*args), flush)
    # library yardstick: SDPA over the pre-gathered dense K/V with the
    # length mask (rows with ctx 0 are let see key 0 to stay finite)
    kd = k[tables[slots.long()].long()].permute(0, 2, 1, 3, 4).reshape(
        T, H, P * B, d)
    vd = v[tables[slots.long()].long()].permute(0, 2, 1, 3, 4).reshape(
        T, H, P * B, d)
    mask = (torch.arange(P * B, device=dev)[None, :]
            < ctx.clamp(min=1)[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(lambda: sdpa(q[:, :, None], kd, vd,
                                       attn_mask=mask), flush)
    bound_ms, bound_by = _attention_bound(tables_np, slots_np, ctx_np,
                                          H, d, B, P)
    kernels.reset_launches()
    return {"name": "paged_attention_mixed", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:314",
            "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": dict(shape)}


def check_mixed_step(dm, make_pools, cfg, params, kv, rows, slots_n):
    """Phase 4: two full-width mixed steps (a 128-token prompt in two
    chunks, then a decode row of another slot joins) with the kernel,
    and again with the plain attention, from the same zero pools."""
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
    dev = params["embed"].device
    steps = [[torch.from_numpy(a).to(dev) for a in step] for step in steps]
    tables = torch.from_numpy(tables).to(dev)
    results = []
    for impl in (None, "reference"):
        k_pool, v_pool = make_pools(kv)
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
    (lk, kk, vk), (lr, kr, vr) = results
    _check(bool(torch.isfinite(lk).all()), "non-finite logits")
    err = float((lk - lr).abs().max())
    pool_err = max(float((kk - kr).abs().max()),
                   float((vk - vr).abs().max()))
    _check(err <= LOGIT_TOL, f"mixed_step logits differ by {err}")
    _check(pool_err <= LOGIT_TOL, f"mixed_step pools differ by {pool_err}")
    same = float((lk.argmax(-1) == lr.argmax(-1)).float().mean())
    return {"logits_max_abs_err": err, "pool_max_abs_err": pool_err,
            "argmax_agreement": same, "rows": int(lk.shape[0])}


def profile_steps(dm, make_pools, cfg, params, kv, rows, slots_n,
                  n_steps=8):
    """Phase 6: where a full-width mixed step's time goes. Runs
    ``n_steps`` steps of 16 decode rows + 64 prefill rows under
    ``torch.profiler`` and returns host wall ms per step, device-busy
    ms per step (the sum of the card's kernel and copy times), the
    idle share, and the costliest device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    pages = kv.blocks_for(cfg.max_seq_len)
    tables = np.arange(slots_n * pages, dtype=np.int32).reshape(
        slots_n, pages)
    k_pool, v_pool = make_pools(kv)
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

    for plan in plans[:2]:
        step(plan)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for plan in plans[2:]:
            step(plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values()) / n_steps
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
    return {"profile": {
        "rows": rows, "steps": n_steps, "wall_ms_per_step": wall_ms,
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
                                   for n, ms in top]}}


def serve(DecodeEngine, kernels, cfg, params, n_requests=48, seed=0):
    """Phase 5: the main path. Returns the serve record and results."""
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
    kw = dict(block_size=16, num_blocks=2048, max_slots=16, eos_id=0)
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
    _check(launches["paged_attention_mixed"] == cfg.n_layers * steps,
           f"launches {launches} over {steps} mixed steps")
    _check(st["prefix"]["hit_tokens"] > 0, "the shared prefix never hit")
    eng.pool.assert_consistent()
    eng.close()
    _check(eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0,
           f"leaked blocks: {eng.pool.check_leaks()}")
    # one request served solo, on a fresh engine, gives the same tokens
    j = 1
    solo_eng = DecodeEngine(cfg, params, **kw)
    solo = solo_eng.generate(prompts[j], max_new[j], timeout=600)
    solo_eng.close()
    _check(solo.tokens.tolist() == results[j].tokens.tolist(),
           "solo and batched greedy tokens differ")
    n_tok = int(sum(len(r.tokens) for r in results))
    rec = {"serve": {
        "requests": n_requests, "generated_tokens": n_tok,
        "prompt_tokens": int(sum(p.size for p in prompts)),
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_ms_p50": st["ttft_ms_p50"], "ttft_ms_p99": st["ttft_ms_p99"],
        "tpot_ms_p50": st["tpot_ms_p50"],
        "mixed_steps": steps, "step_ms_p50": st["step_ms_p50"],
        "mixed_rows": st["chunked_prefill"]["mixed_rows"],
        "prefix_hit_rate": st["prefix"]["hit_rate"],
        "preempted": st["preempted_total"],
        "kv_high_water_blocks": st["kv"]["high_water"],
        "solo_equals_batched": True,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}
    return rec, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the "
              "card", file=sys.stderr)
        return 1
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                          init_params, make_pools)
    from paddle_tpu_torch.serving import decode_model as dm
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
    del flush
    _say(f"kernel check: paged_attention_mixed max_abs_err "
         f"{krec['max_abs_err']:.3e} <= {ATTN_TOL}")

    params = init_params(cfg, seed=0)
    mrec = check_mixed_step(dm, make_pools, cfg, params, kv,
                            shape["T"], max_slots)
    _say("mixed_step check: " + json.dumps(mrec))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    srec, launches = serve(DecodeEngine, kernels, cfg, params)
    krec["launches"] = launches["paged_attention_mixed"]
    torch.cuda.synchronize()
    prec = profile_steps(dm, make_pools, cfg, params, kv, shape["T"],
                         max_slots)

    _say(json.dumps(prec))
    _say(json.dumps({"kernels": [krec]}))
    _say(json.dumps(srec))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
