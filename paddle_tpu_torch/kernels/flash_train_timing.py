"""Step time of ``chip_smoke.py``'s fp32 training run on the kernels of a
given checkout, on the card:

    python -m paddle_tpu_torch.kernels.flash_train_timing --root DIR \\
        [--steps N] [--profile]

Imports ``paddle_tpu_torch`` from the checkout at ``DIR`` (default: this
one), which builds its kernels from its own sources, and runs this
checkout's ``chip_smoke.py`` ``train_fp32`` path on it (``train(...,
key="train_fp32", dtype=float32, warmup=2, kstep=None)``: the GPT-2-small
LM, batch 16 x 512, ``attn_impl="flash"``, so B8 and B9 in their fp32
lane 12 times a step each) with ``--steps`` timed steps, and prints its
record (``step_ms_p50``, tokens/s, launches). With ``--profile``, two
more steps run under ``torch.profiler`` and the line gains the device ms
a step of the flash kernels (names holding ``fwd_kernel``,
``dq_kernel``, ``dkv_kernel``) and of the whole step. Run it once per
checkout in its own process, in turns (the parent, the change, the
change, the parent) to compare two trees on one card. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from paddle_tpu_torch.kernels import parity_dump


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=parity_dump._HERE)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_train_timing: no CUDA device", file=sys.stderr)
        return 1
    cs = parity_dump.chip_smoke()
    parity_dump.use_checkout(args.root)
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import transformer as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rec, _launches, _losses = cs.train(
        tt, kernels, dev, key="train_fp32", dtype=torch.float32, warmup=2,
        steps=args.steps, kstep=None)
    out = {"root": str(args.root.resolve()), **rec["train_fp32"]}
    if args.profile:
        cfg = tt.TransformerConfig(**cs.TRAIN_CFG, dtype=torch.float32,
                                   attn_impl="flash")
        params = tt.init_params(cfg, seed=0, device=dev)
        velocity = tt._rebuild(params, [torch.zeros_like(p)
                                        for p in tt._leaves(params)])
        toks, tgts = cs._train_batches(dev)
        step = tt.make_train_step(cfg, lr=cs.TRAIN_LR)

        def call(i):
            return step(params, velocity, toks[i % 4],
                        tgts[i % 4])[2].cpu()

        out["profile"] = cs._profile(
            [lambda i=i: call(i) for i in range(4)],
            named=("fwd_kernel", "dq_kernel", "dkv_kernel"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
