"""Parity probe of the flash-attention kernels against variants of their
source, on the card:

    python -m paddle_tpu_torch.kernels.flash_probe \\
        [--parent-src OLD_flash_attention.cu] [--out FILE]

Builds with ``nvcc`` (the flags of ``_build``, all variants together):

- ``current``: ``csrc/flash_attention.cu`` as it is;
- ``plain_tf32``: the same source with the fp32 backward's 3xTF32
  product cut to its hi * hi term (``mma3`` keeps one ``mma`` of three),
  i.e. plain TF32 with round-to-nearest operands;
- ``parent``: an earlier version of the file, when ``--parent-src``
  names one.

At each shape of ``chip_smoke.py``'s ``FLASH_SHAPES`` it runs every
variant's fp32 dq and dk/dv on the same inputs, lse and delta (those of
the current forward) and prints each output's max |kernel - plain|
against ``FLASH_GRAD_TOL``, and each variant's median ms at the main
shape. Against ``parent`` it also says whether both lanes' forward
outputs (out, lse) are bit-equal. One JSON object per line; the last line
sums it up. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

# chip_smoke.py's FLASH_SHAPES and FLASH_GRAD_TOL: (B, H, Tq, Tk, causal)
SHAPES = {"main": (16, 12, 512, 512, True),
          "ragged": (4, 12, 500, 500, True),
          "cross": (4, 12, 200, 512, False)}
GRAD_TOL = 1e-4
# the two lo terms of mma3 (a_lo b_hi, a_hi b_lo), emptied for plain TF32
_LO_TERMS = ("mma(acc[nt], alo, b[nt][0], b[nt][1]);",
             "mma(acc[nt], ahi, b[nt][2], b[nt][3]);")


def plain_tf32_source(src: str) -> str:
    """``src`` with ``mma3``'s two lo terms removed (each must occur
    once), leaving the hi * hi product."""
    for term in _LO_TERMS:
        if src.count(term) != 1:
            raise ValueError(f"expected one {term!r} in the source")
        src = src.replace(term, "{}")
    return src


def _build_variants(sources, out_dir: Path):
    """Compile ``{name: source text}`` into ``out_dir``, one nvcc each,
    started together; returns ``{name: CDLL}``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _use(lib):
    """Point the wrappers' C entries at ``lib``."""
    for name, (n_ptr, n_int) in fa._ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fa._entries[name] = fn


def _case(dtype, B, H, Tq, Tk, d=64, seed=0):
    """chip_smoke.py's ``_flash_case``: q, k, v, do from one seed."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [torch.randn((B, H, T, d), generator=g, device="cuda").to(dtype)
            for T in (Tq, Tk, Tk, Tq)]


def _median_ms(fn, reps=20):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=_build.BUILD_DIR / "flash_probe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    sources = {"current": src, "plain_tf32": plain_tf32_source(src)}
    if args.parent_src is not None:
        sources["parent"] = args.parent_src.read_text()
    libs = _build_variants(sources, args.out)

    worst = {n: 0.0 for n in libs}
    for key, (B, H, Tq, Tk, causal) in SHAPES.items():
        q, k, v, do = _case(torch.float32, B, H, Tq, Tk)
        scale = 1.0 / np.sqrt(q.shape[-1])
        _use(libs["current"])
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        delta = torch.sum(do * out, dim=-1)
        bwd = (q, k, v, do, lse, delta, causal, scale)
        ref = {"dq": fa.flash_attention_dq_reference(*bwd)}
        ref["dk"], ref["dv"] = fa.flash_attention_dkv_reference(*bwd)
        for name, lib in libs.items():
            _use(lib)
            got = {"dq": fa.flash_attention_dq(*bwd)}
            got["dk"], got["dv"] = fa.flash_attention_dkv(*bwd)
            torch.cuda.synchronize()
            errs = {n: float((got[n] - ref[n]).abs().max()) for n in got}
            worst[name] = max(worst[name], *errs.values())
            rec = {"variant": name, "shape": key, "max_abs_err": errs,
                   "within_grad_tol": max(errs.values()) <= GRAD_TOL}
            if key == "main":
                rec["dq_ms"] = _median_ms(
                    lambda: fa.flash_attention_dq(*bwd))
                rec["dkv_ms"] = _median_ms(
                    lambda: fa.flash_attention_dkv(*bwd))
            print(json.dumps(rec), flush=True)
        del q, k, v, do, out, lse, delta, bwd, ref

    fwd_bit_equal = {}
    if "parent" in libs:
        for dtype in (torch.float32, torch.bfloat16):
            for key, (B, H, Tq, Tk, causal) in SHAPES.items():
                q, k, v, _do = _case(dtype, B, H, Tq, Tk)
                outs = {}
                for name in ("current", "parent"):
                    _use(libs[name])
                    outs[name] = fa.flash_attention_fwd(q, k, v, causal,
                                                        0.125)
                torch.cuda.synchronize()
                lane = "bf16" if dtype == torch.bfloat16 else "fp32"
                fwd_bit_equal[f"{lane}_{key}"] = all(
                    torch.equal(a, b) for a, b in zip(outs["current"],
                                                      outs["parent"]))
    print(json.dumps({"grad_tol": GRAD_TOL, "worst_max_abs_err": worst,
                      "fwd_bit_equal_to_parent": fwd_bit_equal or None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
