"""The card's peak rate and model-flops utilisation.

The part of the JAX package's ``obs/costreport.py`` that
``Telemetry``'s ``device_mfu`` gauge reads (``device_peak_flops`` and
``mfu``). The peak is the dense bf16 tensor-core rate of the card
``torch.cuda.get_device_name`` names; an unknown card, or no card,
gives None, as the JAX table does for an unknown device kind.

The rest of the module (the ``CostReport`` harvest, the analytic-flops
ledger, the cost table) is ROADMAP A item 2.
"""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["PEAK_BF16_FLOPS", "device_peak_flops", "mfu"]

# dense bf16 tensor-core FLOP/s by a substring of the card's name
# (NVIDIA's H100 SXM datasheet: 989.4 TFLOP/s without sparsity)
PEAK_BF16_FLOPS = {
    "H100": 989e12,
}


def device_peak_flops() -> Tuple[str, Optional[float]]:
    """(device kind, peak dense bf16 FLOP/s or None if unknown/CPU)."""
    import torch

    if not torch.cuda.is_available():
        return "cpu", None
    kind = torch.cuda.get_device_name(torch.cuda.current_device())
    for key, peak in PEAK_BF16_FLOPS.items():
        if key in kind:
            return kind, peak
    return kind, None


def mfu(flops_per_step: float, step_ms: float,
        peak_flops: Optional[float]) -> Optional[float]:
    """Model-flops-utilisation for one step: flops / seconds / peak."""
    if not peak_flops or not step_ms or step_ms <= 0 or not flops_per_step:
        return None
    return flops_per_step / (step_ms / 1e3) / peak_flops
