"""Device resolution for the port's entry points.

Every entry point (``DecodeEngine``, ``init_params``, ``make_pools``)
runs on the CUDA card unless the caller asks for the CPU by name. There
is no quiet fallback: with no card present and no explicit
``device="cpu"``, resolution raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` or a ``cuda`` spec -> that CUDA device (raises when no
    card is present); ``"cpu"`` -> the CPU, only when asked for."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: expected "
                         "'cuda' (the default) or an explicit 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
