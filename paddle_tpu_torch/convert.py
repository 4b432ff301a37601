"""Parameter transfer from the JAX package's models to the port's.

The port keeps the JAX layout (``x @ W``: ``wqkv`` is ``[D, 3*H*hd]``,
``wo`` is ``[H*hd, D]``, the LM head is tied to ``embed``), so the
transfer is a dtype-preserving copy of every array, no transposition.
Pass the JAX ``init_params`` dict as numpy arrays
(``{k: np.asarray(v) for k, v in params.items()}``). A quantized dict
(``quantize_decoder_params``) carries int8 and float8_e4m3fn payloads;
numpy knows the latter only through ``ml_dtypes``, which the port does
not import, so it is recognised by name and moved as its bytes.

The transformer's nested tree (``{"embed", "pos_embed",
"out_ln_scale", "layers": [dict, ...]}``) goes through the same copy:
dicts and lists are walked, every leaf converted as above.

``scope_from_jax`` carries a JAX ``Scope``'s persistables (a Program's
parameters, learning rate and optimizer accumulators, keyed by variable
name) into the port's ``Scope``: a JAX PRNG stream is not a torch one,
so parity runs the JAX startup program and carries its values over
rather than comparing random initializers value for value.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["params_from_jax", "scope_from_jax"]


def _leaf(name, value, dev) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(value))
    if arr.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    elif arr.dtype.kind == "f" or arr.dtype == np.int8:
        t = torch.from_numpy(arr.copy())
    else:
        raise TypeError(f"param {name!r} has dtype {arr.dtype}; the port "
                        "takes float, int8 and float8_e4m3fn params only")
    return t.to(dev)


def _walk(name, value, dev):
    if isinstance(value, Mapping):
        return {k: _walk(f"{name}/{k}" if name else k, v, dev)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_walk(f"{name}/{i}", v, dev) for i, v in enumerate(value)]
    return _leaf(name, value, dev)


def params_from_jax(params: Mapping[str, Any], device=None):
    """The JAX params (as numpy; a flat dict or a tree of dicts and
    lists) -> the port's, the same structure, on ``device`` (the card by
    default; ``"cpu"`` when asked for). Float, int8 and float8_e4m3fn
    arrays are carried with their dtypes; any other dtype raises."""
    return _walk("", params, resolve_device(device))


def scope_from_jax(arrays: Mapping[str, Any], scope=None, device=None):
    """Write a JAX Scope's persistables (as numpy, keyed by variable
    name: ``{n: np.asarray(jax_scope.find_var(n).array)}``) into the
    port's ``scope`` (the global one by default) on ``device`` (the card
    by default; ``"cpu"`` when asked for), with ``params_from_jax``'s
    dtypes; returns the scope."""
    from paddle_tpu_torch.core.scope import global_scope
    scope = global_scope() if scope is None else scope
    for name, value in params_from_jax(dict(arrays), device).items():
        scope.set_tensor(name, value)
    return scope
