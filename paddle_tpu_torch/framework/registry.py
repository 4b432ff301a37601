"""Operator registry: the port of the JAX package's
``framework/registry.py`` (``OpContext``, ``OpInfo``, ``register_op``,
``get_op_info``).

An op is a function ``fn(ins, attrs, ctx) -> {out_slot: tensor}`` over
torch tensors, ``ins`` mapping each input slot to a list of tensors.
Registration records the I/O slots, attribute defaults, which inputs
are optional, whether outputs keep the first input's LoD, and whether
the op is ``amp_compute`` (under AMP its float32 inputs are cast to
bfloat16 and its bfloat16 outputs back to float32). Gradients come from
autograd, so there is no grad-op registry (the reference's
grad_op_desc_maker.h collapses away, as in the JAX package). The
shape/sharding/range rules of the JAX registry belong to its static
analysis, which the port does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["OpContext", "OpInfo", "register_op", "get_op_info", "has_op",
           "registered_ops", "run_op"]


@dataclasses.dataclass
class OpContext:
    """Per-invocation context handed to op compute functions.

    ``in_lods`` maps input slot name -> list of LoD (host metadata).
    Compute fns may fill ``out_lods`` for ragged outputs; by default the
    caller propagates the first input's LoD. ``rng`` is a
    ``torch.Generator`` for sampling ops (the JAX PRNG key's role);
    ``device`` is where an op with no tensor input (``fill_constant``)
    makes its output."""

    attrs: Dict[str, Any]
    in_lods: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    out_lods: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    rng: Optional[torch.Generator] = None
    is_test: bool = False
    device: Optional[torch.device] = None

    def lod(self, slot: str, idx: int = 0):
        lods = self.in_lods.get(slot)
        return lods[idx] if lods and idx < len(lods) else None

    def set_lod(self, slot: str, lod, idx: int = 0):
        self.out_lods.setdefault(slot, [None])
        while len(self.out_lods[slot]) <= idx:
            self.out_lods[slot].append(None)
        self.out_lods[slot][idx] = lod


@dataclasses.dataclass
class OpInfo:
    type: str
    compute: Callable
    inputs: Sequence[str]
    outputs: Sequence[str]
    attrs: Dict[str, Any]
    needs_rng: bool = False
    # names of input slots that are optional (may be absent)
    optional_inputs: Sequence[str] = ()
    # whether outputs keep the LoD of the first input by default
    propagate_lod: bool = True
    # matmul-bound op: under AMP it gets bf16 inputs over the fp32
    # masters and its bf16 outputs are cast back to fp32
    amp_compute: bool = False


_REGISTRY: Dict[str, OpInfo] = {}


def register_op(type: str, inputs: Sequence[str], outputs: Sequence[str],
                attrs: Optional[Dict[str, Any]] = None,
                needs_rng: bool = False,
                optional_inputs: Sequence[str] = (),
                propagate_lod: bool = True, amp_compute: bool = False):
    """Decorator registering a compute function under an op type name."""

    def deco(fn):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} registered twice")
        _REGISTRY[type] = OpInfo(
            type=type, compute=fn, inputs=tuple(inputs),
            outputs=tuple(outputs), attrs=dict(attrs or {}),
            needs_rng=needs_rng, optional_inputs=tuple(optional_inputs),
            propagate_lod=propagate_lod, amp_compute=amp_compute)
        return fn

    return deco


def get_op_info(type: str) -> OpInfo:
    if type not in _REGISTRY:
        _ensure_ops()    # the op modules register on import
    if type not in _REGISTRY:
        raise KeyError(f"unknown op type {type!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[type]


def _ensure_ops():
    import paddle_tpu_torch.ops  # noqa: F401


def has_op(type: str) -> bool:
    _ensure_ops()
    return type in _REGISTRY


def registered_ops() -> List[str]:
    """Every registered op type, sorted (the JAX registry's list)."""
    _ensure_ops()
    return sorted(_REGISTRY)


def _amp_cast(vals, src, dst):
    return [v.to(dst) if torch.is_tensor(v) and v.dtype == src else v
            for v in vals]


def run_op(type: str, ins: Dict[str, List[Any]], attrs=None, in_lods=None,
           amp: bool = False, rng=None, is_test: bool = False,
           device=None):
    """Run one op as the JAX ``Executor`` runs it in its op loop
    (``framework/executor.py``, the body of ``_run_block``): the
    registered defaults under ``attrs``; under ``amp`` an
    ``amp_compute`` op gets its float32 inputs cast to bfloat16 and its
    bfloat16 outputs cast back to float32; each output slot gets the LoD
    the op set, else (``propagate_lod``) the first input slot's.
    ``device``: where an op with no tensor input makes its output.

    ``ins``: slot -> list of tensors; ``in_lods``: slot -> list of LoD
    (or None). Returns ``(outs, out_lods)``: slot -> list of tensors and
    slot -> list of LoD (None where an output has none)."""
    info = get_op_info(type)
    full = dict(info.attrs)
    full.update(attrs or {})
    if is_test and "is_test" in info.attrs:
        full["is_test"] = True
    in_lods = in_lods or {}
    ctx = OpContext(attrs=full, in_lods=in_lods,
                    rng=rng if info.needs_rng else None,
                    is_test=bool(full.get("is_test", is_test)),
                    device=device)
    if amp and info.amp_compute:
        ins = {slot: _amp_cast(vals, torch.float32, torch.bfloat16)
               for slot, vals in ins.items()}
    outs = info.compute(ins, full, ctx) or {}
    outs = {slot: list(v) if isinstance(v, (list, tuple)) else [v]
            for slot, v in outs.items()}
    if amp and info.amp_compute:
        outs = {slot: _amp_cast(vals, torch.bfloat16, torch.float32)
                for slot, vals in outs.items()}
    default_lod = None
    if info.propagate_lod:
        for slot in info.inputs:
            lods = in_lods.get(slot)
            if lods and lods[0]:
                default_lod = lods[0]
                break
    out_lods = {}
    for slot, vals in outs.items():
        set_ = ctx.out_lods.get(slot)
        out_lods[slot] = [
            (set_[i] if set_ and i < len(set_) else default_lod) or None
            for i in range(len(vals))]
    return outs, out_lods
