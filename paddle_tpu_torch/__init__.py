"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for Hopper.

The port is built slice by slice beside the JAX package, which stays
the reference it is held against. The slices so far are generative
serving: ``serving.DecodeEngine`` with chunked or whole-prompt prefill
and continuous or static admission over a block-paged KV cache
(float32, bfloat16, or int8 / fp8-e4m3 with per-block scales), with
fp32 or quantized projection weights; and training the transformer LM
(``models.transformer``: bf16 compute over fp32 master weights, SGD
with momentum). Their kernels (the mixed-step, decode-step and chunk
forms of paged attention in ``kernels.paged_attention``,
``kernels.quant_matmul``, and the flash-attention forward and backward
in ``kernels.flash_attention``) are written by hand in CUDA C++ for
sm_90a.

Entry points run on the CUDA card by default; ``device="cpu"`` is the
explicit opt-in the tests use, where every kernel wrapper takes its
plain PyTorch version. Nothing here imports JAX or ``paddle_tpu``.
"""
from paddle_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
