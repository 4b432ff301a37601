"""The LSTM and GRU recurrences' resident route (bf16) on the card:

    python -m paddle_tpu_torch.kernels.lstm_probe [--out FILE]
    python -m paddle_tpu_torch.kernels.lstm_probe --time [--root DIR]
        [--fused-only STEPS | --gru]
    python -m paddle_tpu_torch.kernels.lstm_probe --gru-tiles

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
process; ``--gru`` the GRU rows and the seq2seq step alone.

The third times the GRU's resident recurrences of this tree at T 30, B
512, D 512 at each tile the kernels take (16, 32 and 48 rows a
cluster: 32, 16 and 11 clusters), launched through the C entries with
the tile given, every tile's outputs held bit-equal to the plan's, and
prints the plan's tile beside the ranking. Kernel timings are
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


def s2s_step_timing(cs, dev, steps=20):
    """The bf16 seq2seq training step: ``chip_smoke.train_s2s``'s loop
    (3 warm-up steps, ``steps`` timed) without its launch checks, every
    loss finite; then ``chip_smoke.profile_s2s``'s profile."""
    from paddle_tpu_torch.models import seq2seq as s2s
    cfg = s2s.Seq2SeqConfig(**cs.S2S_CFG, dtype=torch.bfloat16)
    params = s2s.init_params(cfg, seed=0, device=dev)
    opt, step = s2s.make_train_step(cfg, lr=cs.S2S_LR)
    _p, _s, losses, step_ms, wall = cs.timed_steps(
        lambda p, st, b: (*step(p, st, b), None), params, opt.init(params),
        cs._s2s_batches(dev), steps=steps)
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError("seq2seq: a non-finite loss")
    del params, opt, step, _p, _s, losses
    torch.cuda.empty_cache()
    prof = cs.profile_s2s(s2s, dev)["profile_seq2seq"]
    torch.cuda.empty_cache()
    return {"train_seq2seq_ms_per_step_p50": statistics.median(step_ms),
            "train_seq2seq_tokens_per_s":
                cs.S2S_B * cs.S2S_T * steps / wall,
            "profile_seq2seq": {
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


ROUTES = (("train_lstm", True, False),       # (key, fused_proj, ragged)
          ("train_lstm_composed", False, False),
          ("train_lstm_ragged", True, True))


def step_timing(cs, dev, routes=ROUTES, steps=20):
    """ms per batch p50 of the classifier's AMP step on ``routes``, timed
    by ``chip_smoke.timed_steps`` (3 + ``steps`` steps; 5f's
    ``train_text`` times 20), every loss finite; then the fused route's
    step under ``torch.profiler`` (``chip_smoke.profile_text``): host
    wall ms, device busy ms and their difference, a step."""
    from paddle_tpu_torch.models import text as tx
    out = {}
    for key, fused_proj, ragged in routes:
        cfg = tx.TextConfig(**cs.TEXT_CFG, fused_proj=fused_proj)
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
    ap.add_argument("--gru-tiles", action="store_true")
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
        elif args.gru:
            rec.update(gru_timing(cs, fr, dev, flush), **s2s_step_timing(
                cs, dev))
        else:
            rec.update(timing(cs, fr, dev, flush), **step_timing(cs, dev),
                       **gru_timing(cs, fr, dev, flush),
                       **s2s_step_timing(cs, dev))
        print(json.dumps(rec), flush=True)
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
