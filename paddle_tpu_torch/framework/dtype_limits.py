"""Numeric envelopes for every dtype the precision machinery reasons
about: a copy of the JAX package's ``framework/dtype_limits.py``, one
shared table so the in-graph observatory (``tensor_stats``), the static
value-range rules and the QuantPlan builder (ROADMAP A5, A10) can never
disagree on where "near max" or "near tiny" sits for a given dtype.

Two families live here:

  * hardware dtypes numpy/ml_dtypes know (float64/32/16, bfloat16,
    int8) — the table mirrors ``finfo``/``iinfo`` so no runtime
    dependency on the array library is needed from pure-analysis code;
  * planned low-precision dtypes the quantizer assigns before any
    kernel exists ("fp8-e4m3", "fp8-e5m2") — OCP 8-bit floating point
    per the MX spec (e4m3's max is 448 because its top exponent is
    reserved for NaN; e5m2 keeps the IEEE-style inf/NaN codes).

``mantissa_bits`` excludes the implicit leading bit; for int8 it is the
value-bit count (7), which is what accumulation-precision math wants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["DtypeLimits", "DTYPE_LIMITS", "limits_for", "headroom_edges"]


@dataclass(frozen=True)
class DtypeLimits:
    """Envelope of one dtype: largest finite magnitude, smallest
    positive normal, and precision bits."""

    name: str
    max: float                 # largest finite magnitude
    tiny: float                # smallest positive normal
    mantissa_bits: int         # explicit mantissa (value bits for ints)
    exponent_bits: int
    is_float: bool = True


DTYPE_LIMITS: Dict[str, DtypeLimits] = {
    "float64": DtypeLimits("float64", 1.7976931348623157e308,
                           2.2250738585072014e-308, 52, 11),
    "float32": DtypeLimits("float32", 3.4028234663852886e38,
                           1.1754943508222875e-38, 23, 8),
    "bfloat16": DtypeLimits("bfloat16", 3.3895313892515355e38,
                            1.1754943508222875e-38, 7, 8),
    "float16": DtypeLimits("float16", 65504.0, 6.103515625e-05, 10, 5),
    "fp8-e4m3": DtypeLimits("fp8-e4m3", 448.0, 2.0 ** -6, 3, 4),
    "fp8-e5m2": DtypeLimits("fp8-e5m2", 57344.0, 2.0 ** -14, 2, 5),
    "int8": DtypeLimits("int8", 127.0, 1.0, 7, 0, is_float=False),
}


def limits_for(dtype) -> DtypeLimits:
    """Resolve a dtype (string / numpy dtype / torch dtype) to its
    envelope.  Integer and unknown dtypes resolve to the float32
    envelope — the ``tensor_stats`` convention: exponent buckets over
    an int tensor are meaningless but stay well-defined."""
    name = getattr(dtype, "name", None) or str(dtype).replace("torch.", "")
    lim = DTYPE_LIMITS.get(name)
    if lim is not None and lim.is_float:
        return lim
    return DTYPE_LIMITS["float32"]


def headroom_edges(dtype, headroom_bits: float) -> Tuple[float, float]:
    """The (hi_edge, lo_edge) magnitude thresholds ``tensor_stats``'s
    exponent-occupancy lanes and the static range rules share: a finite
    value within ``headroom_bits`` powers of two of the dtype's max is
    overflow-risky (>= hi_edge); a nonzero one within the same distance
    of its smallest normal is underflow-risky (<= lo_edge)."""
    lim = limits_for(dtype)
    headroom = float(2.0 ** float(headroom_bits))
    return lim.max / headroom, lim.tiny * headroom
