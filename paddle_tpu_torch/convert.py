"""Parameter transfer from the JAX package's decoder to the port's.

The port keeps the JAX layout (``x @ W``: ``wqkv`` is ``[D, 3*H*hd]``,
``wo`` is ``[H*hd, D]``, the LM head is tied to ``embed``), so the
transfer is a dtype-preserving copy of every array, no transposition.
Pass the JAX ``init_params`` dict as numpy arrays
(``{k: np.asarray(v) for k, v in params.items()}``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(params: Mapping[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """The JAX decoder's param dict (as numpy) -> the port's, on
    ``device`` (the card by default; ``"cpu"`` when asked for)."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        arr = np.ascontiguousarray(np.asarray(value))
        if arr.dtype.kind != "f":
            raise TypeError(f"param {name!r} has dtype {arr.dtype}; the "
                            "port's decoder takes float params only")
        out[name] = torch.from_numpy(arr.copy()).to(dev)
    return out
