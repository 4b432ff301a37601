"""Program instrumentation: fuse per-tensor numeric statistics into a
step as ONE extra fetch.

The port's own pass, written after the JAX package's
``analysis/instrument.py`` (which imports jax to read dtypes): the same
selection, the same ops and the same names, so the instrumented program
(and its fingerprint) is the JAX one's.

The rewrite appends a ``tensor_stats`` op ([N_STATS] f32 summary —
ops/math.py) per selected tensor plus one ``stack``, producing a single
``[n_tensors, N_STATS]`` variable that rides the step's existing fetch
group exactly like the health monitor's ``[3]`` vector (obs/health.py):
no extra dispatch, no extra host sync. Selection is by op kind and/or
variable-name regex with a hard tensor cap, so the instrumented step's
cost stays proportional to what the caller asked to watch.

The JAX Executor keys its compiled entries on the fetch set and XLA
dead-code-eliminates the stat ops from the entry that never fetches
them. The port's eager Executor does the same by a liveness prune keyed
on (program version, fetch set) (``framework/executor.py``): a step
that does not fetch the stats runs none of the stat ops, which is what
makes every-Nth-step sampling (obs/numerics.py) nearly free on the
non-sampled steps.

The in-graph tensor summary surface follows TensorFlow's production
debugging story (Abadi et al., 2016, arXiv:1605.08695); the
exponent-occupancy lanes feed quantization calibration (EQuARX,
arXiv:2506.17615).
"""
from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Sequence

from paddle_tpu_torch.framework.program import Block, unique_name

__all__ = ["SelectedTensor", "select_tensors", "install_numerics"]

# instrumentation-owned variable name prefixes — never re-instrumented
_OWN_PREFIXES = ("numerics_", "health_")

# op kinds whose outputs are bookkeeping, not numerics anyone watches
_SKIP_OPS = frozenset({
    "tensor_stats", "fill_constant", "fill_zeros_like", "increment",
    "assign", "shape", "print", "is_empty",
})


class SelectedTensor(NamedTuple):
    """One instrumentation target: the producing op's index and kind
    plus the output variable to summarize."""
    var: str
    op_index: int
    op_type: str


def _is_float_var(var) -> bool:
    return (var is not None and var.dtype is not None
            and var.dtype.is_floating_point)


def select_tensors(program, op_types: Optional[Sequence[str]] = None,
                   name_regex: Optional[str] = None,
                   max_tensors: int = 32,
                   include_backward: bool = False,
                   log=None) -> List[SelectedTensor]:
    """Pick the float output tensors of the program's global block that
    match ``op_types`` (op-kind set) and/or ``name_regex`` (variable
    name). With neither given, every float op output qualifies (the
    fully-instrumented mode the NaN-origin bisector uses). First match
    wins per variable; the list is capped at ``max_tensors`` in program
    order (dropped candidates are reported through ``log`` so a silent
    cap never reads as full coverage).

    ``include_backward``: also walk ops after the ``backward`` pseudo-op
    (gradient/optimizer territory) — off by default because gradient
    health already has a dedicated monitor."""
    pat = re.compile(name_regex) if name_regex else None
    kinds = set(op_types) if op_types else None
    block = program.global_block()
    picked: List[SelectedTensor] = []
    seen = set()
    dropped = 0
    for i, op in enumerate(block.ops):
        if op.type == "backward" and not include_backward:
            break
        if op.type in Block.PSEUDO_OPS or op.type in _SKIP_OPS:
            continue
        for name in op.output_names():
            if name in seen or name.startswith(_OWN_PREFIXES):
                continue
            var = block.vars.get(name)
            if not _is_float_var(var):
                continue
            if kinds is not None or pat is not None:
                kind_ok = kinds is not None and op.type in kinds
                name_ok = pat is not None and pat.search(name)
                if not (kind_ok or name_ok):
                    continue
            seen.add(name)
            if len(picked) >= int(max_tensors):
                dropped += 1
                continue
            picked.append(SelectedTensor(name, i, op.type))
    if dropped and log is not None:
        log(f"numerics: tensor cap {max_tensors} dropped {dropped} "
            "matching tensors (raise max_tensors to widen coverage)")
    return picked


def install_numerics(block, var_names: Sequence[str],
                     headroom_bits: float = 8.0):
    """Append one ``tensor_stats`` op per named variable plus a single
    ``stack``, returning the fused ``[len(var_names), N_STATS]`` f32
    variable. Call AFTER optimizer/health installation so the program
    pointer sits past every op that might produce the watched values;
    appending bumps ``program._version``, so install exactly once per
    program, never per step."""
    from paddle_tpu_torch.ops.math import N_STATS
    if not var_names:
        raise ValueError("install_numerics needs at least one variable")
    lanes = []
    for name in var_names:
        if name not in block.vars:
            raise KeyError(f"numerics target {name!r} not in block "
                           f"{block.idx}")
        lane = block.create_var(name=unique_name("numerics_stat"),
                                shape=[N_STATS], dtype="float32")
        block.append_op("tensor_stats", inputs={"X": name},
                        outputs={"Out": lane},
                        attrs={"headroom_bits": float(headroom_bits)})
        lanes.append(lane)
    out = block.create_var(name=unique_name("numerics_vec"),
                           shape=[len(lanes), N_STATS], dtype="float32")
    block.append_op("stack", inputs={"X": lanes}, outputs={"Out": out},
                    attrs={"axis": 0})
    return out
