"""The LSTM and GRU recurrences' resident route (bf16) on the card:

    python -m paddle_tpu_torch.kernels.lstm_probe [--out FILE]
    python -m paddle_tpu_torch.kernels.lstm_probe --time [--root DIR]
        [--fused-only STEPS | --gru | --wide | --fp32]
    python -m paddle_tpu_torch.kernels.lstm_probe --gru-tiles
    python -m paddle_tpu_torch.kernels.lstm_probe --grid-ablation

The first form measures the cluster exchange alone
(``chip_smoke.lstm_exchange``: 100 empty steps at the flagship's tile,
B 128, D 512; µs a step of the forward's exchange, the backward's and
the barrier alone), one JSON line.

The second times, on the tree at DIR (default this one, imported as
``parity_dump.use_checkout`` does), B10's and B11's bf16 wrappers
(``lstm_fwd``, ``lstm_bwd_data``) at T 100, B 128, D 512 and B14's and
B15's (``lstm_proj_fwd``, ``lstm_proj_bwd_data``, and their passes
``lstm_proj_xg`` and ``lstm_proj_dxe`` alone, the latter beside
``torch.matmul``) at the flagship's two layers (E 128 / 512), then the
classifier's AMP training step on its three routes (``train_lstm``:
fused_lstm; ``train_lstm_composed``: fc + dynamic_lstm;
``train_lstm_ragged``: fused_lstm on ragged LoD, which falls back to
the composed route) through ``chip_smoke.timed_steps``,
the loop ``chip_smoke.train_text`` times, without its launch checks (a
parent tree may count under other names): ms per batch p50 over 20
steps after 3; and the fused step's host wall and device busy ms under
``torch.profiler``; then B12's and B13's bf16 wrappers (``gru_fwd``,
``gru_bwd_data`` and ``gru_dw``) at the seq2seq training shape T 30, B
512, D 512, and the bf16 seq2seq training step (``chip_smoke.train_s2s``'s
loop, without its launch checks: ms per step p50 over 20 steps after
3, tokens/s) with its host wall, device busy and B12/B13 recurrence ms
a step under ``torch.profiler`` (``chip_smoke.profile_s2s``). Run it
for a parent tree and this one in turns, each side first as often as
the other. ``--fused-only STEPS`` times the fused route's step alone
(STEPS steps, then the profile), with no kernel timed before it in the
process; ``--gru`` the GRU rows and the seq2seq step alone; ``--wide``
the LSTM's bf16 lane past D 512 alone (``wide_timing``): the four
wrappers at T 100, B 128, D 1024 (E 128) and D 1280 (E 128 and 1280),
each recurrence alone too where the tree's plan keeps W resident (the
grid route), and the AMP step of the classifier at hidden 1024
(``train_lstm_wide``) and 1280 (``train_lstm_1280``), fused_lstm,
uniform lengths, ms per batch p50 over 10 steps after 3; ``--fp32`` the
LSTM's fp32 lane alone (``fp32_timing``): the four wrappers at T 100, B
128, D 512 (B14/B15 at E 128 and 512), each recurrence and pass alone
where the tree's plan keeps W resident (the grid route), and the fp32
steps of the classifier on both routes (``train_lstm_fp32``: fused_lstm;
``train_lstm_composed_fp32``: fc + dynamic_lstm), ms per batch p50 over
10 steps after 3.

The third times the GRU's resident recurrences of this tree at T 30, B
512, D 512 at each tile the kernels take (16, 32 and 48 rows a
cluster: 32, 16 and 11 clusters), launched through the C entries with
the tile given, every tile's outputs held bit-equal to the plan's, and
prints the plan's tile beside the ranking.

The fourth builds variants of this tree's ``fused_rnn.cu`` (under
``kernels/build/ablation/``) in which parts of the grid route's two
kernels are switched off by preprocessor flags inserted into a copy of
the source (``ABLATIONS``: the group barrier, the operand's cp.async
loads, the products), and times each variant's forward (B10's C entry)
and reverse (B11's) at T 100, B 128, D 1024 and 1280 beside the intact
build (whose outputs are held bit-equal to the wrappers'): where a
step's time goes, as differences between variants; the outputs of a
variant with a part switched off are wrong, and only its time is read.
Kernel timings are
``chip_smoke._time_ms``'s with the card's queue kept ahead of the host
(device ms, L2 flushed), on this checkout's seeded inputs. Both need
one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from paddle_tpu_torch.kernels import parity_dump

_HERE = Path(__file__).resolve().parents[2]
LAYERS = {"layer1": 128, "layer2": 512}      # E of the flagship's layers
T_, B_, D_ = 100, 128, 512


def gru_timing(cs, fr, dev, flush, T=30, B=512, D=512):
    """Device ms of B12's and B13's bf16 wrappers at the seq2seq
    training shape."""
    x, w, lens, h0, dhs = (t.to(torch.bfloat16) if t.shape[-1] != 1 else t
                           for t in cs._gru_case(dev, T, B, D, False))
    hs, gates = fr.gru_fwd(x, w, lens, h0)
    dx, _dh0 = fr.gru_bwd_data(gates, hs, w, lens, h0, dhs)
    return {
        "gru_fwd_bf16_device_ms": cs._time_ms(
            lambda: fr.gru_fwd(x, w, lens, h0), flush, reps=10,
            queue_ahead=True),
        "gru_bwd_bf16_device_ms": cs._time_ms(
            lambda: fr.gru_bwd_data(gates, hs, w, lens, h0, dhs), flush,
            reps=10, queue_ahead=True),
        "gru_dw_bf16_device_ms": cs._time_ms(
            lambda: fr.gru_dw(gates, hs, h0, dx), flush, reps=10,
            queue_ahead=True)}


# --time --gru --fp32: (T, B, D) of B12 fp32's two main paths (beam
# search's encoder, the fp32 training step) and B13's recurrence (the
# training step)
GRU_F32_SHAPES = {"beam": (30, 128, 512), "train": (30, 512, 512)}


def gru_fp32_timing(cs, fr, dev, flush):
    """Device ms of B12's fp32 wrapper (``gru_fwd``) at the generation
    and training shapes and of B13's recurrence (``gru_bwd_data``) at the
    training shape, beside the route the tree's plan gives and µs a
    step."""
    out = {}
    f32 = torch.float32
    for key, (T, B, D) in GRU_F32_SHAPES.items():
        x, w, lens, h0, dhs = cs._gru_case(dev, T, B, D, False)
        plan = fr._cluster_plan(f32, B, D, dev, ng=3)
        out[f"{key}_route"] = plan.route
        hs, gates = fr.gru_fwd(x, w, lens, h0)
        calls = {"gru_fwd": lambda: fr.gru_fwd(x, w, lens, h0)}
        if key == "train":
            calls["gru_bwd"] = lambda: fr.gru_bwd_data(gates, hs, w, lens,
                                                       h0, dhs)
        for name, fn in calls.items():
            ms = cs._time_ms(fn, flush, reps=10, queue_ahead=True)
            out[f"{key}_{name}_fp32_device_ms"] = ms
            out[f"{key}_{name}_fp32_us_per_step"] = ms / T * 1e3
        del x, w, lens, h0, dhs, hs, gates, calls
        torch.cuda.empty_cache()
    return out


def s2s_step_timing(cs, dev, steps=20, dtype=torch.bfloat16):
    """The seq2seq training step (bf16, or fp32: keys with ``_fp32``):
    ``chip_smoke.train_s2s``'s loop (3 warm-up steps, ``steps`` timed)
    without its launch checks, every loss finite; then
    ``chip_smoke.profile_s2s``'s profile."""
    from paddle_tpu_torch.models import seq2seq as s2s
    sfx = "" if dtype == torch.bfloat16 else "_fp32"
    cfg = s2s.Seq2SeqConfig(**cs.S2S_CFG, dtype=dtype)
    params = s2s.init_params(cfg, seed=0, device=dev)
    opt, step = s2s.make_train_step(cfg, lr=cs.S2S_LR)
    _p, _s, losses, step_ms, wall = cs.timed_steps(
        lambda p, st, b: (*step(p, st, b), None), params, opt.init(params),
        cs._s2s_batches(dev), steps=steps)
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError("seq2seq: a non-finite loss")
    del params, opt, step, _p, _s, losses
    torch.cuda.empty_cache()
    prof = cs.profile_s2s(s2s, dev, dtype)["profile_seq2seq"]
    torch.cuda.empty_cache()
    return {f"train_seq2seq{sfx}_ms_per_step_p50": statistics.median(step_ms),
            f"train_seq2seq{sfx}_tokens_per_s":
                cs.S2S_B * cs.S2S_T * steps / wall,
            f"profile_seq2seq{sfx}": {
                "wall_ms_per_step": prof["wall_ms_per_step"],
                "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                "device_idle_share": prof["device_idle_share"],
                "gru_recurrences_device_ms_per_step":
                    prof["gru_recurrences_device_ms_per_step"],
                "named_device_ms_per_step": prof["named_device_ms_per_step"]}}


def gru_tiles(cs, fr, dev, flush, T=30, B=512, D=512):
    """Device ms of the resident GRU recurrences at each tile, through
    the C entries (the wrappers take the plan's tile); each tile's
    outputs bit-equal to the plan's (a row's bits do not depend on its
    tile)."""
    x, w, lens, h0, dhs = (t.to(torch.bfloat16) if t.shape[-1] != 1 else t
                           for t in cs._gru_case(dev, T, B, D, False))
    plan = fr._cluster_plan(torch.bfloat16, B, D, dev, ng=3)
    hs, gates = fr.gru_fwd(x, w, lens, h0)
    dx, dh0 = fr.gru_bwd_data(gates, hs, w, lens, h0, dhs)
    out = {"plan": plan._asdict(), "tiles": {}}
    for bb in fr.REC_TILES[3]:
        ohs, og = torch.empty_like(hs), torch.empty_like(gates)
        odx, odh0 = torch.empty_like(dx), torch.empty_like(dh0)

        def fwd():
            fr._launch("gru_fwd", 1, (x, w, lens, h0, ohs, og),
                       (T, B, D, bb), dev)

        def bwd():
            fr._launch("gru_bwd", 1, (gates, hs, w, lens, h0, dhs, odx,
                                      odh0), (T, B, D, bb), dev)

        fwd()
        bwd()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in ((ohs, hs), (og, gates),
                                                   (odx, dx), (odh0, dh0)))
        tiles = -(-B // bb)
        out["tiles"][bb] = {
            "clusters": tiles, "waves": -(-tiles // plan.max_clusters),
            "bit_equal_to_plan": same,
            "fwd_device_ms": cs._time_ms(fwd, flush, reps=10,
                                         queue_ahead=True),
            "bwd_device_ms": cs._time_ms(bwd, flush, reps=10,
                                         queue_ahead=True)}
    out["ranking"] = sorted(
        out["tiles"], key=lambda b: out["tiles"][b]["fwd_device_ms"]
        + out["tiles"][b]["bwd_device_ms"])
    return out


def timing(cs, fr, dev, flush):
    """Device ms of B10's and B11's bf16 wrappers at T 100, B 128, D 512
    and of B14's and B15's, and their passes, at the flagship's two
    layers."""
    out = {}
    c = {k: (v if k == "lens" else v.to(torch.bfloat16))
         for k, v in cs._lstm_case(dev, T_, B_, D_, 128, False).items()}
    args = (c["w"], c["lens"], c["h0"], c["c0"])
    hs, cs_, gates = fr.lstm_fwd(c["x"], *args)
    out["lstm_fwd_device_ms"] = cs._time_ms(
        lambda: fr.lstm_fwd(c["x"], *args), flush, reps=10, queue_ahead=True)
    out["lstm_bwd_device_ms"] = cs._time_ms(
        lambda: fr.lstm_bwd_data(gates, cs_, *args, c["dhs"], c["dcs"]),
        flush, reps=10, queue_ahead=True)
    del c, hs, cs_, gates
    for key, E in LAYERS.items():
        c = {k: (v if k == "lens" else v.to(torch.bfloat16))
             for k, v in cs._lstm_case(dev, T_, B_, D_, E, False).items()}
        args = (c["w"], c["lens"], c["h0"], c["c0"])
        hs, cs_, gates = fr.lstm_proj_fwd(c["xe"], c["wx"], c["b"], *args)
        out[f"lstm_proj_fwd_{key}_device_ms"] = cs._time_ms(
            lambda: fr.lstm_proj_fwd(c["xe"], c["wx"], c["b"], *args), flush,
            reps=10, queue_ahead=True)
        out[f"lstm_proj_bwd_{key}_device_ms"] = cs._time_ms(
            lambda: fr.lstm_proj_bwd_data(gates, cs_, c["wx"], c["w"],
                                          c["lens"], c["h0"], c["c0"],
                                          c["dhs"], c["dcs"]),
            flush, reps=10, queue_ahead=True)
        out[f"lstm_proj_xg_{key}_device_ms"] = cs._time_ms(
            lambda: fr.lstm_proj_xg(c["xe"], c["wx"], c["b"]), flush,
            queue_ahead=True)
        # the post-pass on the gates, a [T, B, 4D] bf16 of dx's shape
        out[f"lstm_proj_dxe_{key}_device_ms"] = cs._time_ms(
            lambda: fr.lstm_proj_dxe(gates, c["wx"]), flush,
            queue_ahead=True)
        # its same-function library call, as chip_smoke.py times it
        mm = torch.backends.cuda.matmul
        prev = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            g2 = gates.reshape(T_ * B_, 4 * D_)
            out[f"lstm_proj_dxe_{key}_library_device_ms"] = cs._time_ms(
                lambda: torch.matmul(g2, c["wx"].t()), flush,
                queue_ahead=True)
        finally:
            mm.allow_bf16_reduced_precision_reduction = prev
    return out


WIDE = ((1024, 128), (1280, 128), (1280, 1280))   # (D, E) of --wide
# --grid-ablation: variant -> the parts of a grid-route step switched off
ABLATIONS = {"intact": (), "no_barrier": ("NO_SYNC",),
             "no_product": ("NO_MMA",), "no_load": ("NO_LOAD",),
             "no_load_no_product": ("NO_LOAD", "NO_MMA"),
             "cells_only": ("NO_LOAD", "NO_MMA", "NO_SYNC")}
# (the text each switch guards in csrc/fused_rnn.cu, what it becomes)
_SWITCHES = (
    ("      cp16(dst + kE * (r * kLd + kV * p),\n"
     "           src + static_cast<size_t>(b < B ? b : 0) * ld_src "
     "+ col(kc, p),\n           b < B);",
     "#ifndef NO_LOAD\n{}\n#endif"),
    ("          if (r0 + m0 >= B) continue;  // no live row in this m-tile",
     "{}\n#ifdef NO_MMA\n          continue;\n#endif"),
    ("          if (r0 + m0 >= B) continue;\n          uint32_t a[4];",
     "          if (r0 + m0 >= B) continue;\n#ifdef NO_MMA\n"
     "          continue;\n#endif\n          uint32_t a[4];"),
    ("void group_sync(unsigned* counter,\n"
     "                                           unsigned target) {\n",
     "{}#ifdef NO_SYNC\n  return;\n#endif\n"),
    ("  if (tid == 0) tc::mbar_expect_tx(pp.full0 + 8 * s, kGRows * kGK * 4, "
     "false);",
     "#ifdef NO_LOAD\n  if (tid == 0) tc::mbar_expect_tx(pp.full0 + 8 * s, "
     "0, false);\n  return;\n#endif\n{}"),
    ("    mc_wait(pp.full0 + 8 * s, (seq / NS) & 1);\n"
     "    if (m0 < B) {  // a live row in the warp's m-tile",
     "    mc_wait(pp.full0 + 8 * s, (seq / NS) & 1);\n#ifdef NO_MMA\n"
     "    if (false) {\n#else\n"
     "    if (m0 < B) {  // a live row in the warp's m-tile\n#endif"))


def _ablation_builds():
    """Each ABLATIONS variant of csrc/fused_rnn.cu built with nvcc (one
    process each, all at once): {variant: ctypes library}."""
    import ctypes
    import subprocess
    from paddle_tpu_torch.kernels import _build
    src = (_build.CSRC_DIR / "fused_rnn.cu").read_text()
    for old, new in _SWITCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation switch not found once: {old!r}")
        src = src.replace(old, new.format(old) if "{}" in new else new)
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC_DIR.glob("*.cuh"):
        (out / h.name).write_bytes(h.read_bytes())
    (out / "fused_rnn.cu").write_text(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {v: subprocess.Popen(
        [_build.find_nvcc(), *flags, *(f"-D{d}" for d in defs), "-o",
         str(out / f"{v}.so"), str(out / "fused_rnn.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, defs in ABLATIONS.items()}
    for v, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"ablation {v}: nvcc failed\n{log}")
    return {v: ctypes.CDLL(str(out / f"{v}.so")) for v in ABLATIONS}


def grid_ablation(cs, fr, dev, flush, T=100, B=128):
    """Device ms of the grid route's forward (``grid_lstm_fwd_x``, B10)
    and reverse (``grid_lstm_bwd`` without db, B11) in each ABLATIONS
    variant at D 1024 and 1280; the intact variant's forward bit-equal to
    ``lstm_fwd``'s."""
    import ctypes
    libs = _ablation_builds()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    out = {}
    for D in (1024, 1280):
        c = {k: (v if k == "lens" else v.to(torch.bfloat16))
             for k, v in cs._lstm_case(dev, T, B, D, 128, False).items()}
        hs, cs_, g = fr.lstm_fwd(c["x"], c["w"], c["lens"], c["h0"], c["c0"])
        o = [torch.empty_like(t) for t in (hs, cs_, g, g, c["h0"], c["c0"])]
        carry = torch.empty((2, B, D), dtype=torch.float32, device=dev)
        slots = torch.empty((2, D // 256, B, D), dtype=torch.float32,
                            device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        st = torch.cuda.current_stream(dev).cuda_stream
        rec = {}
        for v, lib in libs.items():
            fwd_e, bwd_e = lib.grid_lstm_fwd_x, lib.grid_lstm_bwd
            fwd_e.argtypes = [i32] + [ptr] * 10 + [i32] * 3 + [ptr]
            bwd_e.argtypes = [i32] + [ptr] * 14 + [i32] * 3 + [ptr]
            fwd_e.restype = bwd_e.restype = i32

            def fwd(e=fwd_e):
                counter.zero_()
                err = e(1, *(t.data_ptr() for t in (
                    c["x"], c["w"], c["lens"], c["h0"], c["c0"], *o[:3],
                    carry, counter)), T, B, D, st)
                if err:
                    raise RuntimeError(f"ablation fwd: CUDA error {err}")

            def bwd(e=bwd_e):
                counter.zero_()
                ps = [t.data_ptr() for t in (g, cs_, c["w"], c["lens"],
                                             c["c0"], c["dhs"], c["dcs"],
                                             o[3])]
                err = e(1, *ps, None, *(t.data_ptr() for t in (
                    o[4], o[5], carry, slots, counter)), T, B, D, st)
                if err:
                    raise RuntimeError(f"ablation bwd: CUDA error {err}")

            if v == "intact":
                fwd()
                torch.cuda.synchronize()
                rec["intact_fwd_bit_equal"] = all(
                    torch.equal(a, b) for a, b in zip(o[:3], (hs, cs_, g)))
            rec[v] = {d: cs._time_ms(fn, flush, reps=10, queue_ahead=True)
                      for d, fn in (("fwd_device_ms", fwd),
                                    ("bwd_device_ms", bwd))}
        out[f"d{D}"] = rec
        del c, o, carry, slots, hs, cs_, g
        torch.cuda.empty_cache()
    return out


def gru_grid_ablation(cs, fr, dev, flush, T=30):
    """Device ms of the GRU's fp32 grid route in each ABLATIONS variant:
    the forward (``grid_gru_fwd``) and the reverse (``grid_gru_bwd``) at
    D 512, B 128 and 512; the intact variant's forward and reverse
    bit-equal to the wrappers' where the tree's plan takes the grid
    route. With the products switched off no partial is written (the
    products' epilogues go with them)."""
    import ctypes
    libs = _ablation_builds()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    out = {}
    D = 512
    for B in (128, 512):
        x, w, lens, h0, dhs = cs._gru_case(dev, T, B, D, False)
        hs, g = fr.gru_fwd_reference(x, w, lens, h0)
        f32 = dict(dtype=torch.float32, device=dev)
        o_hs, o_g, o_dx = (torch.empty_like(t) for t in (hs, g, g))
        bp = -(-B // 128) * 128            # rows in whole 128-row tiles
        o_dh0, hr = torch.empty_like(h0), torch.empty((2, bp, D), **f32)
        fslots = torch.empty((D // 128, B, 3 * D), **f32)
        carry = torch.empty((2, B, D), **f32)
        bslots = torch.empty((2, D // 128, B, D), **f32)
        dg = torch.empty((D // 128, bp, 384), **f32)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        st = torch.cuda.current_stream(dev).cuda_stream
        rec = {}
        for v, lib in libs.items():
            fwd_e, bwd_e = lib.grid_gru_fwd, lib.grid_gru_bwd
            fwd_e.argtypes = [i32] + [ptr] * 9 + [i32] * 3 + [ptr]
            bwd_e.argtypes = [i32] + [ptr] * 12 + [i32] * 3 + [ptr]
            fwd_e.restype = bwd_e.restype = i32

            def fwd(e=fwd_e):
                counter.zero_()
                err = e(0, *(t.data_ptr() for t in (x, w, lens, h0, o_hs,
                                                    o_g, hr, fslots,
                                                    counter)),
                        T, B, D, st)
                if err:
                    raise RuntimeError(f"ablation gru fwd: CUDA error {err}")

            def bwd(e=bwd_e):
                counter.zero_()
                err = e(0, *(t.data_ptr() for t in (g, hs, w, lens, h0, dhs,
                                                    o_dx, o_dh0, carry,
                                                    bslots, dg, counter)),
                        T, B, D, st)
                if err:
                    raise RuntimeError(f"ablation gru bwd: CUDA error {err}")

            if v == "intact" and fr._cluster_plan(
                    torch.float32, B, D, dev, ng=3).route == "grid":
                fwd()
                bwd()
                k_hs, k_g = fr.gru_fwd(x, w, lens, h0)
                k_dx, k_dh0 = fr.gru_bwd_data(g, hs, w, lens, h0, dhs)
                torch.cuda.synchronize()
                rec["intact_bit_equal_to_wrappers"] = all(
                    torch.equal(a, b) for a, b in ((o_hs, k_hs), (o_g, k_g),
                                                   (o_dx, k_dx),
                                                   (o_dh0, k_dh0)))
            rec[v] = {d: cs._time_ms(fn, flush, reps=10, queue_ahead=True)
                      for d, fn in (("fwd_device_ms", fwd),
                                    ("bwd_device_ms", bwd))}
        out[f"b{B}_d{D}"] = rec
        del x, w, lens, h0, dhs, hs, g, o_hs, o_g, o_dx, hr, fslots, carry
        torch.cuda.empty_cache()
    return out


def wide_timing(cs, fr, dev, flush):
    """Device ms of the bf16 LSTM wrappers past D 512 (B10 and B11 at E
    128 only: they do not depend on E) and, where the plan keeps W
    resident, of B14's and B15's recurrences alone (``lstm_cluster_fwd``
    on the pre-pass's xg, ``lstm_cluster_bwd``); each key starts with
    ``d{D}_e{E}_``, beside the route the tree's plan gives."""
    out = {}
    bf = torch.bfloat16
    for D, E in WIDE:
        key = f"d{D}_e{E}"
        c = {k: (v if k == "lens" else v.to(bf))
             for k, v in cs._lstm_case(dev, T_, B_, D, E, False).items()}
        args = (c["w"], c["lens"], c["h0"], c["c0"])
        route = fr._cluster_plan(bf, B_, D, dev).route
        out[f"{key}_route"] = route
        _hs, pcs, pg = fr.lstm_proj_fwd(c["xe"], c["wx"], c["b"], *args)
        bargs = (pg, pcs, *args, c["dhs"], c["dcs"])
        calls = {"lstm_proj_fwd": lambda: fr.lstm_proj_fwd(
                     c["xe"], c["wx"], c["b"], *args),
                 "lstm_proj_bwd": lambda: fr.lstm_proj_bwd_data(
                     pg, pcs, c["wx"], *bargs[2:])}
        if E == 128:
            calls.update({"lstm_fwd": lambda: fr.lstm_fwd(c["x"], *args),
                          "lstm_bwd": lambda: fr.lstm_bwd_data(*bargs)})
        if route != "streaming":
            xg = fr.lstm_proj_xg(c["xe"], c["wx"], c["b"])
            calls.update({
                "recurrence_fwd": lambda: fr.lstm_cluster_fwd(xg, *args),
                "recurrence_bwd": lambda: fr.lstm_cluster_bwd(*bargs)})
        for name, fn in calls.items():
            out[f"{key}_{name}_device_ms"] = cs._time_ms(
                fn, flush, reps=10, queue_ahead=True)
        del c, calls, bargs, _hs, pcs, pg
        torch.cuda.empty_cache()
    return out


def fp32_timing(cs, fr, dev, flush):
    """Device ms of the fp32 LSTM wrappers at T 100, B 128, D 512 (B10
    and B11 at E 128 only) and, where the tree's plan keeps W resident,
    of B14's and B15's recurrences and passes alone; each key starts
    with ``e{E}_``, beside the route the tree's plan gives."""
    out = {}
    f32 = torch.float32
    out["route"] = fr._cluster_plan(f32, B_, D_, dev).route
    for key, E in LAYERS.items():
        c = cs._lstm_case(dev, T_, B_, D_, E, False)
        args = (c["w"], c["lens"], c["h0"], c["c0"])
        _hs, pcs, pg = fr.lstm_proj_fwd(c["xe"], c["wx"], c["b"], *args)
        bargs = (pg, pcs, *args, c["dhs"], c["dcs"])
        calls = {"lstm_proj_fwd": lambda: fr.lstm_proj_fwd(
                     c["xe"], c["wx"], c["b"], *args),
                 "lstm_proj_bwd": lambda: fr.lstm_proj_bwd_data(
                     pg, pcs, c["wx"], *bargs[2:])}
        if E == 128:
            calls.update({"lstm_fwd": lambda: fr.lstm_fwd(c["x"], *args),
                          "lstm_bwd": lambda: fr.lstm_bwd_data(*bargs)})
        if out["route"] != "streaming":
            xg = fr.lstm_proj_xg(c["xe"], c["wx"], c["b"])
            calls.update({
                "recurrence_fwd": lambda: fr.lstm_cluster_fwd(xg, *args),
                "recurrence_bwd": lambda: fr.lstm_cluster_bwd(*bargs),
                "lstm_proj_xg": lambda: fr.lstm_proj_xg(c["xe"], c["wx"],
                                                        c["b"]),
                "lstm_proj_dxe": lambda: fr.lstm_proj_dxe(pg, c["wx"])})
        for name, fn in calls.items():
            out[f"{key}_{name}_device_ms"] = cs._time_ms(
                fn, flush, reps=10, queue_ahead=True)
        del c, calls, bargs, _hs, pcs, pg
        torch.cuda.empty_cache()
    return out


ROUTES = (("train_lstm", True, False),       # (key, fused_proj, ragged)
          ("train_lstm_composed", False, False),
          ("train_lstm_ragged", True, True))


def step_timing(cs, dev, routes=ROUTES, steps=20, widths=None,
                profiled=True, amp=True):
    """ms per batch p50 of the classifier's step (AMP, or fp32 without
    ``amp``) on ``routes``, timed by ``chip_smoke.timed_steps`` (3 +
    ``steps`` steps; 5f's ``train_text`` times 20), every loss finite, at
    ``widths`` (default the flagship's); then, with ``profiled``, the
    fused route's step under ``torch.profiler``
    (``chip_smoke.profile_text``): host wall ms, device busy ms and their
    difference, a step."""
    from paddle_tpu_torch.models import text as tx
    out = {}
    for key, fused_proj, ragged in routes:
        cfg = tx.TextConfig(**(widths or cs.TEXT_CFG), fused_proj=fused_proj,
                            amp=amp)
        params = tx.init_params(cfg, seed=0, device=dev)
        opt, step = tx.make_train_step(cfg, "adam", cs.TEXT_LR)
        _p, _s, losses, step_ms, _wall = cs.timed_steps(
            step, params, opt.init(params), cs._text_feeds(dev, ragged=ragged),
            steps=steps)
        if not bool(torch.isfinite(torch.stack(losses)).all()):
            raise RuntimeError(f"{key}: a non-finite loss")
        out[f"{key}_ms_per_batch_p50"] = statistics.median(step_ms)
        del params, opt, step, _p, _s, losses
        torch.cuda.empty_cache()
    if not profiled:
        return out
    prof = cs.profile_text(tx, dev)["profile_lstm"]
    out["profile_lstm"] = {
        "wall_ms_per_step": prof["wall_ms_per_step"],
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "host_only_ms_per_step": (prof["wall_ms_per_step"]
                                  - prof["device_busy_ms_per_step"]),
        "device_idle_share": prof["device_idle_share"]}
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--root", type=Path, default=_HERE)
    ap.add_argument("--fused-only", type=int, metavar="STEPS",
                    help="with --time: only the fused route's step, "
                    "STEPS timed steps, no kernel timings")
    ap.add_argument("--gru", action="store_true",
                    help="with --time: only the GRU rows and the seq2seq "
                    "step")
    ap.add_argument("--wide", action="store_true",
                    help="with --time: only the LSTM's bf16 lane past D "
                    "512 (D 1024, 1280) and the hidden-1024 / 1280 steps")
    ap.add_argument("--fp32", action="store_true",
                    help="with --time: only the LSTM's fp32 lane at D 512 "
                    "and the classifier's fp32 steps; with --gru too, "
                    "the GRU's fp32 recurrences, the fp32 seq2seq step "
                    "and beam search")
    ap.add_argument("--gru-tiles", action="store_true")
    ap.add_argument("--grid-ablation", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cs = parity_dump.chip_smoke()
    if args.time:
        parity_dump.use_checkout(args.root)
    from paddle_tpu_torch.kernels import fused_rnn as fr
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    card = cs._card_line()
    if args.time:
        rec = {"root": str(args.root), "card": card}
        if args.fused_only:
            rec.update(step_timing(cs, dev, ROUTES[:1], args.fused_only))
        elif args.gru and args.fp32:
            from paddle_tpu_torch import kernels
            from paddle_tpu_torch.models import seq2seq as s2s
            rec.update(gru_fp32_timing(cs, fr, dev, flush))
            rec.update(s2s_step_timing(cs, dev, 10, torch.float32))
            beam = cs.generate_beam(s2s, fr, kernels, dev,
                                    hold_route=False)[0]
            rec["generate_beam_ms_per_batch"] = \
                beam["generate_beam"]["ms_per_batch"]
        elif args.gru:
            rec.update(gru_timing(cs, fr, dev, flush), **s2s_step_timing(
                cs, dev))
        elif args.fp32:
            rec.update(fp32_timing(cs, fr, dev, flush))
            rec.update(step_timing(
                cs, dev, (("train_lstm_fp32", True, False),
                          ("train_lstm_composed_fp32", False, False)), 10,
                profiled=False, amp=False))
        elif args.wide:
            rec.update(wide_timing(cs, fr, dev, flush))
            for key, widths in (("train_lstm_wide", cs.TEXT_WIDE_CFG),
                                ("train_lstm_1280", cs.TEXT_1280_CFG)):
                rec.update(step_timing(cs, dev, ((key, True, False),), 10,
                                       widths, profiled=False))
        else:
            rec.update(timing(cs, fr, dev, flush), **step_timing(cs, dev),
                       **gru_timing(cs, fr, dev, flush),
                       **s2s_step_timing(cs, dev))
        print(json.dumps(rec), flush=True)
        return 0
    if args.grid_ablation:
        fn = gru_grid_ablation if args.gru else grid_ablation
        print(json.dumps({"card": card, "grid_ablation": fn(
            cs, fr, dev, flush)}), flush=True)
        return 0
    if args.gru_tiles:
        print(json.dumps({"card": card, "gru_tiles": gru_tiles(
            cs, fr, dev, flush)}), flush=True)
        return 0
    plan = fr._cluster_plan(torch.bfloat16, B_, D_, dev)
    rec = {"card": card, "exchange": dict(
        cs.lstm_exchange(fr, dev, flush, plan, D_, T_), plan=plan._asdict())}
    print(json.dumps(rec), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
