"""B1-B4's device times and the serving steps' paged-attention device ms
of one source tree, on the card:

    python -m paddle_tpu_torch.kernels.paged_probe [--root DIR] [--out FILE]

Imports ``paddle_tpu_torch`` from the checkout at ``DIR`` (default: this
one), which builds its kernels from its own sources, and runs this
checkout's ``chip_smoke.py`` phases on it: the kernel rows of
``paged_attention_mixed`` (B1/B2) and ``paged_attention`` (B3/B4), every
pool lane, at the smoke's shapes (each against its plain version, then
``device_ms`` and SDPA's ``library_device_ms`` with the card's queue
kept ahead of the host, and the bound); then the full-width fp32 and
int8 mixed steps (``profile``, ``profile_quant``) and the whole-mode
decode step (``profile_whole``) under ``torch.profiler``, with the
device ms a step of every kernel whose name holds ``paged_attention``.
Prints one JSON line (and writes it to ``FILE``). Run it once per tree,
each in its own process, parent and change in turns in one call: two
calls may land on two cards. Needs one card.

    python -m paddle_tpu_torch.kernels.paged_probe --root DIR --serve FILE

instead serves the smoke's ``serve*`` runs (the same seeded requests
and engine options, without the solo runs) on the package of ``DIR``
and writes their greedy tokens, ``{line: [tokens of each request]}``,
to ``FILE``: ``chip_smoke.py --ref-tokens FILE`` then reports each
line's ``greedy_equal_share_vs_parent`` against them.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from paddle_tpu_torch.kernels import parity_dump

_KEYS = ("max_abs_err", "ms", "device_ms", "library_ms",
         "library_device_ms", "bound_ms", "bound_by")
_PROFILE_KEYS = ("wall_ms_per_step", "device_busy_ms_per_step",
                 "device_idle_share", "named_device_ms_per_step")


def probe(root: Path) -> dict:
    parity_dump.use_checkout(root)
    cs = parity_dump.chip_smoke()
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import (DecoderConfig, init_params,
                                          make_pools)
    from paddle_tpu_torch.serving import decode_model as dm
    from paddle_tpu_torch.serving.decode_engine import _probe_kv_absmax
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = DecoderConfig(vocab_size=32000, d_model=768, n_heads=12,
                        head_dim=64, n_layers=12, d_ff=3072,
                        max_seq_len=512)
    kv = cfg.kv_config(block_size=16, num_blocks=2048)
    S = 16
    shape = {"T": S + 64, "H": cfg.n_heads, "d": cfg.head_dim,
             "B": kv.block_size, "P": kv.blocks_for(cfg.max_seq_len),
             "S": S, "N": kv.num_blocks}
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows = {}
    for dtype in ("float32", "bfloat16", "int8", "fp8-e4m3"):
        for rec in (cs.check_attention(pa, dev, flush, shape, dtype),
                    cs.check_decode_attention(pa, dev, flush, shape, dtype,
                                              identity_bits=False)):
            rows[rec["name"]] = {k: rec[k] for k in _KEYS}
    del flush
    named = ("paged_attention",)
    params = init_params(cfg, seed=0)
    prof = cs.profile_steps(dm, make_pools, cfg, params, kv, shape["T"], S,
                            named=named)
    kv8 = cfg.kv_config(block_size=16, num_blocks=2048, dtype="int8")
    qparams = dm.quantize_decoder_params(cfg, params, "int8")
    prof.update(cs.profile_steps(
        dm, make_pools, cfg, qparams, kv8, shape["T"], S,
        cal=_probe_kv_absmax(cfg, qparams), key="profile_quant",
        named=named))
    whole = cs.profile_whole(dm, make_pools, cfg, params, kv, S,
                             named=named)["profile_whole"]
    prof["profile_whole_decode"] = whole["decode_step"]
    return {"card": cs._card_line(), "root": str(root), "rows": rows,
            "profiles": {k: {f: p[f] for f in _PROFILE_KEYS}
                         for k, p in prof.items()}}


def serve_tokens(root: Path) -> dict:
    """The greedy tokens of chip_smoke.py's serve lines on the package of
    ``root``, by line."""
    parity_dump.use_checkout(root)
    cs = parity_dump.chip_smoke()
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                          init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DecoderConfig(vocab_size=32000, d_model=768, n_heads=12,
                        head_dim=64, n_layers=12, d_ff=3072,
                        max_seq_len=512)
    params = init_params(cfg, seed=0)
    kv = {dt: dict(kv_config=cfg.kv_config(16, 2048, dt))
          for dt in ("int8", "fp8-e4m3", "bfloat16")}
    quant = {dt: dict(kv[dt], quant_plan=dt) for dt in ("int8", "fp8-e4m3")}
    whole = dict(prefill_mode="whole",
                 prompt_rungs=(16, 32, 64, 128, 256, 384))
    runs = (("serve", None, None), ("serve_quant", quant["int8"], None),
            ("serve_fp8", quant["fp8-e4m3"], 16),
            ("serve_bf16", kv["bfloat16"], 16), ("serve_whole", whole, None),
            ("serve_whole_static", dict(whole, admission="static"), None),
            ("serve_whole_quant", dict(whole, **quant["int8"]), None),
            ("serve_whole_fp8", dict(whole, **quant["fp8-e4m3"]), 16),
            ("serve_whole_bf16", dict(whole, **kv["bfloat16"]), 16))
    out = {}
    for key, engine_kw, n_serve in runs:
        torch.cuda.empty_cache()
        out[key] = cs.serve(DecodeEngine, kernels, cfg, params, key=key,
                            engine_kw=engine_kw, n_serve=n_serve,
                            solo_index=None)[2]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=parity_dump._HERE)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--serve", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.serve is not None:
        args.serve.parent.mkdir(parents=True, exist_ok=True)
        args.serve.write_text(json.dumps(serve_tokens(args.root)))
        return 0
    line = json.dumps(probe(args.root))
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
