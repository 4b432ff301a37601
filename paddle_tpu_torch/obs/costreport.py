"""The cost plane: what a step costs, beside what it measured.

The port of the JAX package's ``obs/costreport.py``. The telemetry plane
(telemetry.py) records what a run *did*; a ``CostReport`` records what
one step of a program *costs* in FLOPs and bytes, so a fenced step time
becomes a utilisation (``Telemetry``'s ``device_mfu`` gauge,
``profiler.measured_vs_modeled``).

The JAX harvest reads a compiled executable (XLA's ``cost_analysis`` /
``memory_analysis`` and a walk over its HLO). The port compiles nothing:
its Executor runs each op eagerly, so the harvest counts one real step
as it runs, from two sources:

1. ``torch.utils.flop_counter.FlopCounterMode`` over the step: the
   FLOPs of every stock product (``mm`` / ``bmm`` / ``addmm`` /
   ``baddbmm``, the convolutions and their backward, PyTorch's own
   attention), forward and backward. Elementwise work is not counted
   (XLA's count includes it, hence JAX's ``flops_xla`` runs a few
   percent above this one on a straight-line program).
2. the kernel FLOPs ledger: the hand-written kernels launch through
   ``ctypes``, invisible to the counter, so each wrapper's CUDA branch
   ``note_flops`` the analytic FLOPs of the JAX function it replaces
   (the formulas JAX's Pallas wrappers note: ``kernels/fused_rnn.py``,
   ``flash_attention.py``, ``paged_attention.py``). On CPU tensors a
   wrapper takes its plain version, whose products the counter sees,
   so it notes nothing (JAX's interpret-mode skip). The ledger is a
   thread-local armed only while a step is counted, so a launch pays
   one attribute read; a kernel's autograd backward, which the engine
   may run on its device thread, re-arms the box its forward saw
   (``current_ledger`` / ``flops_ledger(box)``).

The ``CostReport`` keeps the JAX field set and ``to_dict`` keys:

- ``flops_hlo`` holds the counted stock-op FLOPs, "the op walk";
- ``flops_xla`` stays 0 (there is no compiler estimate);
- ``flops_kernel`` holds the ledger's FLOPs;
- ``flops = max(flops_xla, flops_hlo) + flops_kernel``, as in JAX;
- ``op_kinds`` buckets the counter's per-op totals: ``dot`` (``mm`` /
  ``bmm`` / ``addmm`` / ``baddbmm`` / attention), ``conv`` (the
  convolutions and their backward), ``other``, and ``custom`` for the
  ledger; the flop shares sum to 1;
- ``argument_bytes`` / ``output_bytes`` are the step's input tensors
  (feeds and state) and outputs (fetches and written state);
  ``temp_bytes`` is the card's peak allocation during the counted step
  (``torch.cuda.max_memory_allocated``, whose peak the count resets)
  above what was allocated before it and the outputs, 0 on the CPU;
  ``peak_hbm_bytes`` is their sum, as JAX sums its three;
- ``bytes_accessed`` and the kinds' ``bytes`` stay 0: the counter
  counts no traffic; ``generated_code_bytes`` stays 0.

``attribute_hlo`` (the JAX HLO walk) is not ported: an eager program
has no HLO to read.

``device_peak_flops`` is the dense bf16 tensor-core rate of the card
``torch.cuda.get_device_name`` names (an unknown card, or none, gives
None, as the JAX table does for an unknown device kind); ``mfu`` divides
by it.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = [
    "CostReport", "harvest_cost_report", "device_peak_flops",
    "flops_ledger", "note_flops", "current_ledger", "count_step", "mfu",
    "format_cost_table", "PEAK_BF16_FLOPS",
]

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


# --------------------------------------------------------------- ledger
_LEDGER = threading.local()


def note_flops(flops: float):
    """Record analytic FLOPs of a kernel launch the counter cannot see.
    No-op unless a ledger is armed on this thread."""
    box = getattr(_LEDGER, "box", None)
    if box is not None:
        box["flops"] += float(flops)
        box["notes"] += 1


def current_ledger() -> Optional[dict]:
    """The box armed on this thread, or None: what a kernel's autograd
    forward saves so its backward can re-arm it."""
    return getattr(_LEDGER, "box", None)


@contextlib.contextmanager
def flops_ledger(box: Optional[dict] = None):
    """Arm the kernel-flops ledger on this thread for the block. Yields
    a dict whose ``"flops"`` (and ``"notes"``, the count of notes) hold
    the totals; pass an armed ``box`` to re-arm it (another thread)."""
    prev = getattr(_LEDGER, "box", None)
    if box is None:
        box = {"flops": 0.0, "notes": 0}
    _LEDGER.box = box
    try:
        yield box
    finally:
        _LEDGER.box = prev


@contextlib.contextmanager
def count_step(device=None):
    """Count the block's work: ``FlopCounterMode`` over its stock ops and
    the kernel ledger, and on a CUDA ``device`` the peak allocation
    (the card's peak statistic is reset first). Yields a dict that holds
    ``op_flops`` ({aten op: FLOPs}), ``kernel_flops``, ``kernel_notes``,
    ``alloc_before`` and ``peak_alloc`` once the block exits."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cuda = device is not None and torch.device(device).type == "cuda"
    out = {"alloc_before": 0, "peak_alloc": 0}
    if cuda:
        torch.cuda.synchronize(device)
        out["alloc_before"] = int(torch.cuda.memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
    counter = FlopCounterMode(display=False)
    with flops_ledger() as box, counter:
        yield out
    if cuda:
        torch.cuda.synchronize(device)
        out["peak_alloc"] = int(torch.cuda.max_memory_allocated(device))
    out["op_flops"] = {str(op): float(v) for op, v in
                       counter.get_flop_counts().get("Global", {}).items()}
    out["kernel_flops"] = box["flops"]
    out["kernel_notes"] = box["notes"]


# ---------------------------------------------------------- op kinds
_DOT_OPS = ("mm", "bmm", "addmm", "baddbmm")


def _kind_of(op: str) -> str:
    """The kind of a counted aten op (``"aten.mm"``): its products are a
    ``dot`` (attention among them), a ``conv`` or ``other``."""
    base = op.split(".")[-1]
    if "conv" in base:
        return "conv"
    if base in _DOT_OPS or "attention" in base:
        return "dot"
    return "other"


# -------------------------------------------------------------- report
@dataclass
class CostReport:
    """Cost and memory of ONE dispatch of a program entry (the module
    docstring says which field holds what).

    ``flops`` is per dispatch (= ``steps`` train steps for a K-step
    ``run_multi``); ``flops_per_step`` divides it out.
    """

    program: str = ""
    steps: int = 1
    n_devices: int = 1
    flops_xla: float = 0.0        # no compiler estimate: 0
    flops_hlo: float = 0.0        # the op walk: FlopCounterMode's total
    flops_kernel: float = 0.0     # the hand-written kernels' ledger
    flops: float = 0.0            # best estimate per dispatch
    bytes_accessed: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    generated_code_bytes: int = 0
    peak_hbm_bytes: int = 0
    op_kinds: Dict[str, dict] = field(default_factory=dict)

    @property
    def flops_per_step(self) -> float:
        return self.flops / max(1, self.steps)

    def to_dict(self) -> dict:
        return {
            "program": self.program,
            "steps": self.steps,
            "n_devices": self.n_devices,
            "flops": self.flops,
            "flops_per_step": self.flops_per_step,
            "flops_xla": self.flops_xla,
            "flops_hlo": self.flops_hlo,
            "flops_kernel": self.flops_kernel,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "op_kinds": {k: dict(v) for k, v in
                         sorted(self.op_kinds.items())},
        }


def harvest_cost_report(op_flops: Optional[Dict[str, float]] = None,
                        program: str = "", steps: int = 1,
                        n_devices: int = 1, kernel_flops: float = 0.0,
                        kernel_notes: int = 0, argument_bytes: int = 0,
                        output_bytes: int = 0,
                        temp_bytes: int = 0) -> CostReport:
    """Build a CostReport from one counted dispatch: ``op_flops`` the
    counter's {aten op: FLOPs} (``count_step``'s), ``kernel_flops`` /
    ``kernel_notes`` the ledger's totals over the same dispatch (every
    launch noted, so no ``× steps`` as the JAX per-trace ledger needs),
    and the dispatch's memory."""
    rep = CostReport(program=program, steps=max(1, int(steps)),
                     n_devices=max(1, int(n_devices)))
    kinds: Dict[str, dict] = {}
    for op, f in sorted((op_flops or {}).items()):
        d = kinds.setdefault(_kind_of(op),
                             {"flops": 0.0, "bytes": 0.0, "count": 0})
        d["flops"] += float(f)
        d["count"] += 1
    if kernel_flops:
        kinds["custom"] = {"flops": float(kernel_flops), "bytes": 0.0,
                           "count": int(kernel_notes)}
    rep.flops_hlo = sum(d["flops"] for k, d in kinds.items()
                        if k != "custom")
    rep.flops_kernel = float(kernel_flops or 0.0)
    rep.flops = max(rep.flops_xla, rep.flops_hlo) + rep.flops_kernel
    total = rep.flops_hlo + rep.flops_kernel
    for d in kinds.values():
        d["flops_share"] = d["flops"] / total if total else 0.0
        d["bytes_share"] = 0.0
    rep.op_kinds = kinds
    rep.argument_bytes = int(argument_bytes)
    rep.output_bytes = int(output_bytes)
    rep.temp_bytes = int(temp_bytes)
    rep.peak_hbm_bytes = (rep.argument_bytes + rep.output_bytes
                          + rep.temp_bytes)
    return rep


# ------------------------------------------------------------- display
def _fmt(v: float) -> str:
    for div, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(v) >= div:
            return f"{v / div:.2f}{suf}"
    return f"{v:.0f}"


def format_cost_table(report: CostReport) -> str:
    """Human-readable per-op-kind attribution table (the JAX layout; the
    "hlo-walk" column is the port's op walk)."""
    lines = [
        f"program={report.program or '?'}  steps={report.steps}  "
        f"devices={report.n_devices}",
        f"flops/step {_fmt(report.flops_per_step)}  "
        f"(xla={_fmt(report.flops_xla)}  hlo-walk={_fmt(report.flops_hlo)}  "
        f"kernels={_fmt(report.flops_kernel)})",
        f"bytes accessed {_fmt(report.bytes_accessed)}  "
        f"hbm peak~{_fmt(report.peak_hbm_bytes)} "
        f"(arg {_fmt(report.argument_bytes)} + out "
        f"{_fmt(report.output_bytes)} + temp {_fmt(report.temp_bytes)})",
        "",
        f"{'kind':<12}{'flops':>10}{'flops%':>9}{'bytes':>10}"
        f"{'bytes%':>9}{'ops':>6}",
    ]
    rows = sorted(report.op_kinds.items(),
                  key=lambda kv: -kv[1].get("flops", 0.0))
    for kind, d in rows:
        lines.append(
            f"{kind:<12}{_fmt(d.get('flops', 0.0)):>10}"
            f"{100.0 * d.get('flops_share', 0.0):>8.1f}%"
            f"{_fmt(d.get('bytes', 0.0)):>10}"
            f"{100.0 * d.get('bytes_share', 0.0):>8.1f}%"
            f"{d.get('count', 0):>6}")
    if not rows:
        lines.append("(no attributable ops)")
    return "\n".join(lines)
