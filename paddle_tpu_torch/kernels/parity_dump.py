"""Bit-equality of the port's other kernels between two source trees, on
the card:

    python -m paddle_tpu_torch.kernels.parity_dump --root DIR --out FILE
    python -m paddle_tpu_torch.kernels.parity_dump --compare A B

The first form imports ``paddle_tpu_torch`` from the checkout at ``DIR``
(default: this one), which builds its kernels from its own sources, and
runs each kernel wrapper but the flash ones (``flash_probe`` holds those)
once on seeded inputs at ``chip_smoke.py``'s shapes, saving every output
to ``FILE``:

- B1/B2 ``paged_attention_mixed`` and B3/B4 ``paged_attention``, every
  pool lane, at the smoke's mixed step (80 rows) and decode step (16
  slots);
- B5/B6 ``paged_attention_chunk``, every pool lane, at the rung-384 and
  the prefix-hit rung-256 prefill;
- B7 ``quant_matmul``, int8 and fp8-e4m3, at the decoder's four
  projections with M 80;
- B12/B13 (``gru_fwd``, ``gru_bwd_data``, ``gru_dw``) and B10/B11/B14/
  B15 (every LSTM wrapper), fp32 and bf16, at ``GRU_SHAPES`` /
  ``LSTM_SHAPES`` and past D 512 at ``GRU_WIDE_SHAPES`` (T 20, a ragged
  B 130, D 640: the streaming route in both lanes) / ``WIDE_SHAPES`` (D
  1024, the LSTM's grid route in bf16, and D 640, the streaming route);
  ``lstm_proj_dw`` also on B10/B11's hs and dx (D 512); ``gru_dw`` also
  on inputs that no kernel made (hs and gates from the forward's plain
  version, dx from the reverse's), so that it is held to the other
  tree's bits whatever the recurrences give.

The outputs of kernels a PR redesigns are saved under a name that starts
with ``REDESIGNED`` (B1-B4's, since their row-tile kernel; the fp32 GRU
recurrences' hs, gates, dx and dh0 at the D of ``_REDESIGNED_GRU_D_FP32``,
since their grid route, and the dW computed from them (the bf16 GRU's,
tagged since its resident route, are held again); the LSTM outputs named in
``_REDESIGNED_OUTPUTS``, bf16 lane, none now; every bf16 LSTM output at
the D of ``_REDESIGNED_D``, none now (the grid route's bf16 lane at D
1024 is held since its redesign landed); every fp32 LSTM output at the
D of ``_REDESIGNED_D_FP32``, none now (the grid route's fp32 lane at
``LSTM_SHAPES``' D 512 is held since its redesign landed)): the
comparison reports
them apart and does not fail on them. The seeded inputs come
from this checkout's ``chip_smoke.py``. Run the first form once per
tree, each in its own process. The second prints, for each output,
whether the two files hold the same bits, and exits non-zero if any
other output differs or is missing. Needs one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parents[2]
REDESIGNED = "redesigned:"
# the bf16 LSTM outputs of a redesign that changes their bits, or of
# what is computed from them (``_lstm_run``'s names)
_REDESIGNED_OUTPUTS: tuple = ()
# past D 512 (T, B, D, E, ragged), and the D whose bf16 LSTM outputs a
# redesign changes (none now)
WIDE_SHAPES = {"d1024": (20, 130, 1024, 128, True),
               "d640": (20, 130, 640, 128, True)}
_REDESIGNED_D: tuple = ()
# the D whose fp32 LSTM outputs a redesign changes (the grid route's
# fp32 lane at LSTM_SHAPES)
_REDESIGNED_D_FP32 = ()
# the GRU past D 512 (T, B, D, ragged), and the D whose fp32 GRU outputs
# a redesign changes (the grid route's fp32 lane at GRU_SHAPES)
GRU_WIDE_SHAPES = {"d640": (20, 130, 640, True)}
_REDESIGNED_GRU_D_FP32 = (512,)


def chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module: its seeded inputs
    and timed runs, the same whichever tree's kernels they drive."""
    spec = importlib.util.spec_from_file_location(
        "_parity_chip_smoke", _HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def use_checkout(root: Path):
    """Make ``import paddle_tpu_torch`` find the package of the checkout
    at ``root``: the one ``-m`` loaded (this checkout's) is dropped first.
    Call before importing any kernel module."""
    for name in [m for m in sys.modules if m == "paddle_tpu_torch"
                 or m.startswith("paddle_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    import paddle_tpu_torch
    if Path(paddle_tpu_torch.__file__).resolve().parents[1] != \
            root.resolve():
        raise RuntimeError(f"paddle_tpu_torch came from "
                           f"{paddle_tpu_torch.__file__}, not {root}")


def _outputs(cs, pa, qm, fr, dev):
    """{name: tensor} of every covered wrapper's outputs."""
    out = {}
    shape = {"H": 12, "d": 64, "B": 16, "P": 32, "N": 2048}
    H, d, B, P, N = (shape[k] for k in "HdBPN")
    S = 16
    q, k32, v32, tables, slots, ctx = cs._attention_case(
        dev, S + 64, H, d, B, P, S, N)
    tables, slots, ctx = (torch.from_numpy(a).to(dev)
                          for a in (tables, slots, ctx))
    qd = q[:S].contiguous()
    lens = ctx[:S].contiguous()
    for dtype in cs.ATTN_LANES:
        k, v, ks, vs = ((k32, v32, None, None) if dtype == "float32" else
                        cs._quant_pools(dev, dtype, N, H, B, d))
        kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
        out[f"{REDESIGNED}mixed_{dtype}"] = pa.paged_attention_mixed(
            q, k, v, tables, slots, ctx, **kw)
        out[f"{REDESIGNED}decode_{dtype}"] = pa.paged_attention(
            qd, k, v, tables, lens, **kw)
    del q, k32, v32, k, v, ks, vs
    for dtype in cs.CHUNK_LANES:
        k, v, ks, vs = cs._pools_for(dev, dtype, N, H, B, d, seed=5)
        kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
        for G, start, true_len in cs.CHUNK_SHAPES:
            g = torch.Generator(device=dev).manual_seed(G)
            rng = cs.np.random.default_rng(G)
            q = torch.randn((1, G, H, d), generator=g, device=dev)
            tables = torch.from_numpy(
                rng.permutation(N)[:P].astype(cs.np.int32)[None]).to(dev)
            ctx_np = cs.np.zeros((1, G), cs.np.int32)
            ctx_np[0, :true_len] = start + cs.np.arange(true_len) + 1
            ctx = torch.from_numpy(ctx_np).to(dev)
            out[f"chunk_{dtype}_G{G}"] = pa.paged_attention_chunk(
                q, k, v, tables, ctx, **kw)
        del k, v, ks, vs
    g = torch.Generator(device=dev).manual_seed(3)
    for name, K, Nn in (("wqkv", 768, 2304), ("wo", 768, 768),
                        ("w1", 768, 3072), ("w2", 3072, 768)):
        x = torch.randn((80, K), generator=g, device=dev)
        w = 0.02 * torch.randn((K, Nn), generator=g, device=dev)
        for lane in ("int8", "fp8-e4m3"):
            wq, ws = qm.quantize_weight(w, lane)
            out[f"qmm_{lane}_{name}"] = qm.quant_matmul(x, wq, ws)
    for dtype in (torch.float32, torch.bfloat16):
        lane = "bf16" if dtype == torch.bfloat16 else "fp32"
        for key, (T, Bb, D, ragged) in (*cs.GRU_SHAPES.items(),
                                        *GRU_WIDE_SHAPES.items()):
            x, w, lens, h0, dhs = cs._gru_case(dev, T, Bb, D, ragged)
            xs, ws, h0s, dhss = (t.to(dtype) for t in (x, w, h0, dhs))
            hs, gates = fr.gru_fwd(xs, ws, lens, h0s)
            dx, dh0 = fr.gru_bwd_data(gates, hs, ws, lens, h0s, dhss)
            dw = fr.gru_dw(gates, hs, h0s, dx)
            tag = (REDESIGNED if lane == "fp32"
                   and D in _REDESIGNED_GRU_D_FP32 else "")
            for n, t in (("hs", hs), ("gates", gates), ("dx", dx),
                         ("dh0", dh0), ("dw", dw)):
                out[f"{tag}gru_{lane}_{key}_{n}"] = t
            p_hs, p_gates = fr.gru_fwd_reference(xs, ws, lens, h0s)
            p_dx, _p_dh0 = fr.gru_bwd_data_reference(
                p_gates, p_hs, ws, lens, h0s, dhss)
            out[f"gru_{lane}_{key}_dw_on_plain"] = fr.gru_dw(
                p_gates, p_hs, h0s, p_dx)
        for key, (T, Bb, D, E, ragged) in cs.LSTM_SHAPES.items():
            c = cs._lstm_case(dev, T, Bb, D, E, ragged)
            lc = {n: (t.to(dtype) if n != "lens" else t)
                  for n, t in c.items()}
            o = cs._lstm_run(fr, lc)
            fp32_grid = lane == "fp32" and D in _REDESIGNED_D_FP32
            tag = REDESIGNED if lane == "bf16" or fp32_grid else ""
            for n, t in o.items():
                out[f"{tag if n in _REDESIGNED_OUTPUTS or fp32_grid else ''}"
                    f"lstm_{lane}_{key}_{n}"] = t
            dwx, dw = fr.lstm_proj_dw(lc["xe"], o["hs"], lc["h0"], o["dx"])
            tag = REDESIGNED if fp32_grid else ""
            out[f"{tag}lstm_{lane}_{key}_proj_dw_on_b11_dwx"] = dwx
            out[f"{tag}lstm_{lane}_{key}_proj_dw_on_b11_dw"] = dw
        for key, (T, Bb, D, E, ragged) in WIDE_SHAPES.items():
            c = cs._lstm_case(dev, T, Bb, D, E, ragged)
            o = cs._lstm_run(fr, {n: (t.to(dtype) if n != "lens" else t)
                                  for n, t in c.items()})
            tag = (REDESIGNED if lane == "bf16" and D in _REDESIGNED_D
                   else "")
            for n, t in o.items():
                out[f"{tag}lstm_{lane}_{key}_{n}"] = t
            del c, o
    torch.cuda.synchronize()
    return {n: t.detach().cpu() for n, t in out.items()}


def dump(root: Path, path: Path) -> int:
    use_checkout(root)
    from paddle_tpu_torch.kernels import fused_rnn as fr
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = _outputs(chip_smoke(), pa, qm, fr, torch.device("cuda", 0))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(outs, path)
    print(json.dumps({"root": str(root), "outputs": len(outs),
                      "saved": str(path)}))
    return 0


def compare(a: Path, b: Path) -> int:
    x, y = torch.load(a), torch.load(b)
    same = {n: n in y and x[n].dtype == y[n].dtype
            and torch.equal(x[n], y[n]) for n in x}
    for n in sorted(set(y) - set(x)):
        same[n] = False
    held = {n: ok for n, ok in same.items() if not n.startswith(REDESIGNED)}
    new = {n: ok for n, ok in same.items() if n.startswith(REDESIGNED)}
    differ = sorted(n for n, ok in held.items() if not ok)
    print(json.dumps({"outputs": len(held), "bit_equal": len(held)
                      - len(differ), "differ": differ,
                      "redesigned": {"outputs": len(new),
                                     "bit_equal": sum(new.values())}}))
    return 1 if differ else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=_HERE)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("parity_dump: no CUDA device", file=sys.stderr)
        return 1
    if args.out is None:
        ap.error("--out is needed to dump")
    return dump(args.root, args.out)


if __name__ == "__main__":
    sys.exit(main())
