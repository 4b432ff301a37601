"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches by wrapper name (incremented where the kernel is launched and
nowhere else), so a run can show that its main path went through the
kernels; ``reset_launches`` zeroes it.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"paged_attention_mixed": 0,
                            "paged_attention_mixed_quant": 0,
                            "paged_attention": 0,
                            "paged_attention_quant": 0,
                            "paged_attention_chunk": 0,
                            "paged_attention_chunk_quant": 0,
                            "quant_matmul": 0,
                            "flash_attention_fwd": 0,
                            "flash_attention_dq": 0,
                            "flash_attention_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


from paddle_tpu_torch.kernels.paged_attention import (  # noqa: E402
    NEG_INF, paged_attention_chunk, paged_attention_chunk_reference,
    paged_attention_mixed, paged_attention_mixed_reference,
    paged_attention_reference)
# ``kernels.paged_attention``, ``kernels.quant_matmul`` and
# ``kernels.flash_attention`` are the modules (each has a function of the
# same name, so those functions are not re-exported here)
from paddle_tpu_torch.kernels import flash_attention  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention  # noqa: E402
from paddle_tpu_torch.kernels import quant_matmul  # noqa: E402

__all__ = ["LAUNCHES", "NEG_INF", "flash_attention", "paged_attention",
           "paged_attention_chunk", "paged_attention_chunk_reference",
           "paged_attention_mixed", "paged_attention_mixed_reference",
           "paged_attention_reference", "quant_matmul", "reset_launches"]
