"""Parity probe of the flash-attention kernels against variants of their
source, on the card:

    python -m paddle_tpu_torch.kernels.flash_probe \\
        [--parent-src OLD_flash_attention.cu] [--out FILE]

Builds with ``nvcc`` (the flags of ``_build``, all variants together):

- ``current``: ``csrc/flash_attention.cu`` as it is;
- ``plain_tf32``: the same source with the fp32 lane's 3xTF32 product cut
  to its hi * hi term (``mma3`` keeps one ``mma`` of three), i.e. plain
  TF32 with round-to-nearest operands, in the forward and the backward;
- ``fwd_unroll2``: the same source with the fp32 forward's S product
  unrolled two k-steps at a time, as the backward's (the forward unrolls
  all of them);
- ``parent``: an earlier version of the file, when ``--parent-src``
  names one.

At each shape of ``chip_smoke.py``'s ``FLASH_SHAPES`` it runs every
variant's fp32 forward, dq and dk/dv on the same inputs (the backward
from the current forward's lse and delta) and prints each output's max
|kernel - plain| against ``FWD_TOL`` / ``GRAD_TOL``, and each variant's
``device_ms`` at the main shape. Against ``parent`` it also says, for each
kernel, lane and shape, whether the outputs are bit-equal (the backward
from the plain forward's lse and delta), and times each kernel of both
at the main shape in the order parent, current, current, parent, with
the card's queue kept ahead of the host (``device_ms``). One JSON object
per line; the last line sums it up. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

# chip_smoke.py's FLASH_SHAPES, FLASH_FWD_TOL and FLASH_GRAD_TOL:
# (B, H, Tq, Tk, causal)
SHAPES = {"main": (16, 12, 512, 512, True),
          "ragged": (4, 12, 500, 500, True),
          "cross": (4, 12, 200, 512, False)}
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# the two lo terms of mma3 (a_lo b_hi, a_hi b_lo), emptied for plain TF32
_LO_TERMS = ("mma(acc[nt], alo, b[nt][0], b[nt][1]);",
             "mma(acc[nt], ahi, b[nt][2], b[nt][3]);")
# the fp32 forward's S product, unrolled whole; and as the backward's
_FWD_S = ("prod_rows<kD, kD / 8>(sQ, sK, warp * 16, s);",
          "prod_rows<kD>(sQ, sK, warp * 16, s);")
# cycles the card sleeps ahead of a timed window (chip_smoke.py's
# QUEUE_AHEAD_CYCLES)
_QUEUE_AHEAD_CYCLES = 2_000_000


def plain_tf32_source(src: str) -> str:
    """``src`` with ``mma3``'s two lo terms removed (each must occur
    once), leaving the hi * hi product."""
    for term in _LO_TERMS:
        if src.count(term) != 1:
            raise ValueError(f"expected one {term!r} in the source")
        src = src.replace(term, "{}")
    return src


def fwd_unroll2_source(src: str) -> str:
    """``src`` with the fp32 forward's S product unrolled two k-steps at
    a time (the call must occur once)."""
    if src.count(_FWD_S[0]) != 1:
        raise ValueError(f"expected one {_FWD_S[0]!r} in the source")
    return src.replace(*_FWD_S)


def ptxas_summary(log: str):
    """``{kernel: [registers, spill store bytes]}`` from an nvcc log
    with ``-Xptxas -v``, each kernel named namespace::name<args> from
    its mangled entry."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(simt|tf32|tc)\d+(\w+?_kernel)(I\w*?EE)?",
                          m.group(1))
            name = (f"{k.group(1)}::{k.group(2)}{k.group(3) or ''}"
                    if k else m.group(1))
            out[name] = [None, None]
        elif name and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers",
                                         line).group(1))
        elif name and "spill stores" in line:
            out[name][1] = int(re.search(r"(\d+) bytes spill stores",
                                         line).group(1))
    return out


def _build_variants(sources, out_dir: Path):
    """Compile ``{name: source text}`` into ``out_dir``, one nvcc each,
    started together; returns ``{name: CDLL}`` and prints each variant's
    ``ptxas_summary``."""
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
        print(json.dumps({"variant": name, "registers_spill_bytes":
                          ptxas_summary(log)}), flush=True)
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


def _device_ms(fn, flush, reps=20):
    """chip_smoke.py's ``_time_ms(queue_ahead=True)``: median ms of one
    call after an L2 flush, the window enqueued behind a sleep on the
    card so that it holds device time alone."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(_QUEUE_AHEAD_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _calls(q, k, v, do, lse, delta, causal, scale):
    """Each kernel's call at fixed inputs: the backward from the given
    lse and delta."""
    bwd = (q, k, v, do, lse, delta, causal, scale)
    return {"fwd": lambda: fa.flash_attention_fwd(q, k, v, causal, scale),
            "dq": lambda: (fa.flash_attention_dq(*bwd),),
            "dkv": lambda: fa.flash_attention_dkv(*bwd)}


def _against_parent(libs, flush):
    """Bit-equality of every kernel and lane, current vs parent, at each
    shape; device ms of both at the main shape (parent, current,
    current, parent). Prints a line per lane and shape; returns
    ``{lane_shape: {kernel: bool}}`` and ``{lane: {kernel: ms}}``."""
    bit_equal, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        lane = "bf16" if dtype == torch.bfloat16 else "fp32"
        for key, (B, H, Tq, Tk, causal) in SHAPES.items():
            q, k, v, do = _case(dtype, B, H, Tq, Tk)
            scale = 1.0 / np.sqrt(q.shape[-1])
            out, lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                        scale)
            delta = torch.sum(do.float() * out.float(), dim=-1)
            calls = _calls(q, k, v, do, lse, delta, causal, scale)
            outs = {}
            for name in ("current", "parent"):
                _use(libs[name])
                outs[name] = {n: fn() for n, fn in calls.items()}
            torch.cuda.synchronize()
            same = {n: all(torch.equal(a, b) for a, b in zip(
                outs["current"][n], outs["parent"][n])) for n in calls}
            bit_equal[f"{lane}_{key}"] = same
            rec = {"lane": lane, "shape": key, "bit_equal_to_parent": same}
            if key == "main":
                ms = {n: {"parent": [], "current": []} for n in calls}
                for name in ("parent", "current", "current", "parent"):
                    _use(libs[name])
                    for n, fn in calls.items():
                        ms[n][name].append(_device_ms(fn, flush))
                rec["device_ms"] = ms
                times[lane] = ms
            print(json.dumps(rec), flush=True)
            del q, k, v, do, out, lse, delta, calls, outs
    _use(libs["current"])
    return bit_equal, times


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
    sources = {"current": src, "plain_tf32": plain_tf32_source(src),
               "fwd_unroll2": fwd_unroll2_source(src)}
    if args.parent_src is not None:
        sources["parent"] = args.parent_src.read_text()
    libs = _build_variants(sources, args.out)

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    worst = {n: 0.0 for n in libs}
    worst_fwd = {n: 0.0 for n in libs}
    for key, (B, H, Tq, Tk, causal) in SHAPES.items():
        q, k, v, do = _case(torch.float32, B, H, Tq, Tk)
        scale = 1.0 / np.sqrt(q.shape[-1])
        r_out, r_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                        scale)
        _use(libs["current"])
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        delta = torch.sum(do * out, dim=-1)
        bwd = (q, k, v, do, lse, delta, causal, scale)
        ref = {"dq": fa.flash_attention_dq_reference(*bwd)}
        ref["dk"], ref["dv"] = fa.flash_attention_dkv_reference(*bwd)
        for name, lib in libs.items():
            _use(lib)
            f_out, f_lse = fa.flash_attention_fwd(q, k, v, causal, scale)
            got = {"dq": fa.flash_attention_dq(*bwd)}
            got["dk"], got["dv"] = fa.flash_attention_dkv(*bwd)
            torch.cuda.synchronize()
            errs = {n: float((got[n] - ref[n]).abs().max()) for n in got}
            fwd_errs = {"out": float((f_out - r_out).abs().max()),
                        "lse": float((f_lse - r_lse).abs().max())}
            worst[name] = max(worst[name], *errs.values())
            worst_fwd[name] = max(worst_fwd[name], *fwd_errs.values())
            rec = {"variant": name, "shape": key, "max_abs_err": errs,
                   "fwd_max_abs_err": fwd_errs,
                   "within_grad_tol": max(errs.values()) <= GRAD_TOL,
                   "within_fwd_tol": max(fwd_errs.values()) <= FWD_TOL}
            if key == "main":
                rec["fwd_ms"] = _device_ms(
                    lambda: fa.flash_attention_fwd(q, k, v, causal, scale),
                    flush)
                rec["dq_ms"] = _device_ms(
                    lambda: fa.flash_attention_dq(*bwd), flush)
                rec["dkv_ms"] = _device_ms(
                    lambda: fa.flash_attention_dkv(*bwd), flush)
            print(json.dumps(rec), flush=True)
        del q, k, v, do, out, lse, delta, bwd, ref

    bit_equal = times = None
    if "parent" in libs:
        bit_equal, times = _against_parent(libs, flush)
    print(json.dumps({"fwd_tol": FWD_TOL, "grad_tol": GRAD_TOL,
                      "worst_max_abs_err": worst,
                      "worst_fwd_max_abs_err": worst_fwd,
                      "bit_equal_to_parent": bit_equal,
                      "parent_current_device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
