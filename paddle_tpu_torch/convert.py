"""Parameter transfer from the JAX package's decoder to the port's.

The port keeps the JAX layout (``x @ W``: ``wqkv`` is ``[D, 3*H*hd]``,
``wo`` is ``[H*hd, D]``, the LM head is tied to ``embed``), so the
transfer is a dtype-preserving copy of every array, no transposition.
Pass the JAX ``init_params`` dict as numpy arrays
(``{k: np.asarray(v) for k, v in params.items()}``). A quantized dict
(``quantize_decoder_params``) carries int8 and float8_e4m3fn payloads;
numpy knows the latter only through ``ml_dtypes``, which the port does
not import, so it is recognised by name and moved as its bytes.
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
    ``device`` (the card by default; ``"cpu"`` when asked for). Float,
    int8 and float8_e4m3fn arrays are carried; any other dtype
    raises."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        arr = np.ascontiguousarray(np.asarray(value))
        if arr.dtype.name == "float8_e4m3fn":
            t = torch.from_numpy(arr.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        elif arr.dtype.kind == "f" or arr.dtype == np.int8:
            t = torch.from_numpy(arr.copy())
        else:
            raise TypeError(f"param {name!r} has dtype {arr.dtype}; the "
                            "port's decoder takes float, int8 and "
                            "float8_e4m3fn params only")
        out[name] = t.to(dev)
    return out
