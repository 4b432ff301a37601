"""B14/B15's resident route (bf16) on the card:

    python -m paddle_tpu_torch.kernels.lstm_probe [--out FILE]
    python -m paddle_tpu_torch.kernels.lstm_probe --time [--root DIR]

The first form measures the cluster exchange alone
(``chip_smoke.lstm_exchange``: 100 empty steps at the flagship's tile,
B 128, D 512; µs a step of the forward's exchange, the backward's and
the barrier alone), one JSON line.

The second times B14's and B15's bf16 wrappers (``lstm_proj_fwd``,
``lstm_proj_bwd_data``) at the flagship's two layers (T 100, B 128,
D 512, E 128 / 512) on the tree at DIR (default this one, imported as
``parity_dump.use_checkout`` does): run it for a parent tree and this
one in turns. Timings are ``chip_smoke._time_ms``'s with the card's
queue kept ahead of the host (device ms, L2 flushed), on this
checkout's seeded inputs. Both need one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from paddle_tpu_torch.kernels import parity_dump

_HERE = Path(__file__).resolve().parents[2]
LAYERS = {"layer1": 128, "layer2": 512}      # E of the flagship's layers
T_, B_, D_ = 100, 128, 512


def timing(cs, fr, dev, flush):
    """Device ms of B14's and B15's bf16 wrappers at the flagship's two
    layers."""
    out = {}
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
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--root", type=Path, default=_HERE)
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
        print(json.dumps(dict({"root": str(args.root), "card": card},
                              **timing(cs, fr, dev, flush))), flush=True)
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
