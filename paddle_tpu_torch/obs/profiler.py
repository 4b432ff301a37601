"""Measured-time profiler — device-trace capture + measured-vs-modeled join.

The port of the JAX package's ``obs/profiler.py``, on ``torch.profiler``:

  * ``Profiler`` wraps programmatic ``torch.profiler`` capture sessions
    (start/stop, blocking ``capture(duration_ms)``, zip artifact
    packing) with introspectable state for ``Telemetry.status``; each
    capture exports its Chrome trace as ``capture.trace.json`` into the
    capture dir.
  * ``step_annotation``/``trace_annotation`` are the hot-path markers
    (trainer steps, serving turns): ``torch.profiler.record_function``
    regions, a few microseconds when no capture is active.
  * ``parse_device_trace`` reads the Chrome trace a capture writes and
    sums *measured* device time per op kind (the GPU's kernel, memcpy
    and memset events, classified by name as the JAX parser classifies
    its device lanes) plus the device-idle fraction, and counts the
    device events by name (``event_counts``: one per kernel launch).
    Without a card there are no device events, so
    ``parse_tracer_records`` is the deterministic fallback: it replays
    the JSONL tracer's fenced ``device_step``/``jit_compile`` spans and
    measures the intra-step dispatch gap (device-idle between dispatches
    sharing one ``trainer_step`` parent — exactly 0 on a
    single-dispatch step).
  * ``measured_vs_modeled`` joins a profile against the program's
    modeled cost. The port has no ``CostReport`` yet (ROADMAP A item 2),
    so ``report=None`` is the only form that runs: the measured per-kind
    table, with no modeled shares.
"""
from __future__ import annotations

import glob
import gzip
import io
import json
import os
import tempfile
import threading
import time
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Profiler", "MeasuredProfile", "parse_device_trace",
    "parse_tracer_records", "measured_vs_modeled",
    "format_measured_table", "profiler_state_from_trace",
    "step_annotation", "trace_annotation",
]


# ---------------------------------------------------------- annotations
def step_annotation(name: str, step_num: int = 0):
    """A ``torch.profiler.record_function`` region for one device
    dispatch, named ``name`` so ``parse_device_trace(program=name)``
    counts it as a step (``step_num`` is accepted for the JAX helper's
    signature; the region's name carries no number)."""
    import torch
    return torch.profiler.record_function(name)


def trace_annotation(name: str):
    """``torch.profiler.record_function`` — host-side named region that
    shows up on the capture timeline (trainer steps, serving turns)."""
    import torch
    return torch.profiler.record_function(name)


# -------------------------------------------------------------- capture
class Profiler:
    """One programmatic capture session manager.

    State is introspectable (``status()``) so ``Telemetry.status`` can
    tell an operator a capture is running; start/stop transitions are
    also emitted as ``profiler`` events on the telemetry tracer, which
    is how a recorded trace.jsonl carries the state offline
    (``profiler_state_from_trace``). Durations are measured on the
    monotonic clock; wall timestamps appear only in exported records.
    The capture records every thread's host ops and, with a card, every
    kernel and copy the process runs on it.
    """

    def __init__(self, telemetry=None, log_dir: Optional[str] = None):
        self.telemetry = telemetry
        self._default_dir = log_dir
        self._session = None
        self._lock = threading.Lock()
        self._capturing = False
        self._log_dir: Optional[str] = None
        self._window: Optional[Tuple[int, int]] = None
        self._t0 = 0.0
        self._started_wall: Optional[str] = None
        self.artifact: Optional[str] = None
        self.captured_ms: Optional[float] = None

    @property
    def capturing(self) -> bool:
        return self._capturing

    def start(self, log_dir: Optional[str] = None,
              window: Optional[Tuple[int, int]] = None) -> str:
        """Begin a device trace. Raises RuntimeError if one is already
        running (captures cannot nest). Returns the capture dir."""
        with self._lock:
            if self._capturing:
                raise RuntimeError(
                    f"profiler already capturing to {self._log_dir}; "
                    "captures cannot nest")
            d = log_dir or self._default_dir or tempfile.mkdtemp(
                prefix="pt_profile_")
            os.makedirs(d, exist_ok=True)
            self._session = _start_session()
            self._capturing = True
            self._log_dir = d
            self._window = tuple(window) if window else None
            self._t0 = time.monotonic()
            self._started_wall = time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        self._emit_state("capturing", log_dir=d,
                         window=list(self._window) if self._window
                         else None)
        return d

    def stop(self) -> Optional[str]:
        """End the capture, pack the log dir into a zip artifact, and
        return its path. No-op (returns None) when not capturing."""
        with self._lock:
            if not self._capturing:
                return None
            try:
                self._session.stop()
                self._session.export_chrome_trace(
                    os.path.join(self._log_dir, "capture.trace.json"))
            finally:
                self._session = None
                self._capturing = False
            self.captured_ms = round(
                (time.monotonic() - self._t0) * 1e3, 1)
            try:
                self.artifact = self._pack(self._log_dir)
            except Exception:
                self.artifact = self._log_dir  # unpacked, still useful
        self._emit_state("idle", artifact=self.artifact,
                         captured_ms=self.captured_ms)
        return self.artifact

    def capture(self, duration_ms: float,
                log_dir: Optional[str] = None) -> Tuple[str, bytes]:
        """Blocking timed capture. Returns
        ``(artifact_path, artifact_bytes)``."""
        self.start(log_dir)
        time.sleep(max(0.0, float(duration_ms)) / 1e3)
        path = self.stop()
        with open(path, "rb") as f:
            return path, f.read()

    def status(self) -> dict:
        """The status block: capturing yes/no, window, artifact."""
        out: dict = {"capturing": self._capturing}
        if self._capturing:
            out["log_dir"] = self._log_dir
            out["window"] = list(self._window) if self._window else None
            out["started"] = self._started_wall
            out["elapsed_ms"] = round(
                (time.monotonic() - self._t0) * 1e3, 1)
        if self.artifact is not None:
            out["artifact"] = self.artifact
            out["captured_ms"] = self.captured_ms
        return out

    def _emit_state(self, state: str, **args):
        tel = self.telemetry
        if tel is not None:
            tel.tracer.event("profiler", state=state, **args)

    @staticmethod
    def _pack(d: str) -> str:
        out = d.rstrip("/\\") + ".zip"
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
            wrote = False
            for root, _dirs, files in os.walk(d):
                for fn in sorted(files):
                    p = os.path.join(root, fn)
                    z.write(p, os.path.relpath(p, d))
                    wrote = True
            if not wrote:  # keep the artifact a valid, non-empty zip
                z.writestr("EMPTY_CAPTURE.txt",
                           "capture produced no files\n")
        return out


# --------------------------------------------------------------- parsing
@dataclass
class MeasuredProfile:
    """Measured device time for ONE program kind, from either parser."""

    source: str = "jsonl-fallback"   # or "device-trace"
    program: str = ""
    steps: int = 0                   # train steps covered (K counted)
    spans: int = 0                   # device dispatches observed
    device_ms_total: float = 0.0
    compile_ms: float = 0.0
    # measured ms per op kind over the whole capture; empty for the
    # fallback parser (the join apportions by modeled share instead)
    op_kind_ms: Dict[str, float] = field(default_factory=dict)
    attribution: str = ""            # "measured" | "modeled-shares"
    # device-idle between dispatches sharing one trainer_step parent,
    # mean ms per step window; exactly 0 on a single-dispatch step
    dispatch_gap_ms: float = 0.0
    gap_windows: int = 0
    idle_frac: Optional[float] = None  # device-trace only
    # device events by name (one per kernel launch); device-trace only,
    # and kept out of ``to_dict`` (the JAX profile's keys)
    event_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def device_ms_per_step(self) -> float:
        return self.device_ms_total / max(1, self.steps)

    def to_dict(self) -> dict:
        return {
            "source": self.source, "program": self.program,
            "steps": self.steps, "spans": self.spans,
            "device_ms_total": round(self.device_ms_total, 4),
            "device_ms_per_step": round(self.device_ms_per_step, 4),
            "compile_ms": round(self.compile_ms, 3),
            "op_kind_ms": {k: round(v, 4)
                           for k, v in sorted(self.op_kind_ms.items())},
            "attribution": self.attribution,
            "dispatch_gap_ms": round(self.dispatch_gap_ms, 4),
            "gap_windows": self.gap_windows,
            "idle_frac": self.idle_frac,
        }


def parse_tracer_records(records,
                         program: Optional[str] = None
                         ) -> Dict[str, MeasuredProfile]:
    """Deterministic fallback parser over the JSONL tracer.

    Replays ``device_step`` spans (fenced wall ms per dispatch, from
    ``Telemetry.step_span``) and ``jit_compile`` spans into one
    ``MeasuredProfile`` per program kind.  The dispatch gap is computed
    from span geometry: inside each ``trainer_step`` parent, the idle
    ns between the end of one child ``device_step`` and the start of
    the next — a step the planner proved single-dispatch has no such
    pair, so its gap is exactly zero.  ``records`` is a path or the
    in-memory record list (``Telemetry.tracer.records``).
    """
    from paddle_tpu_torch.obs.trace import read_trace

    recs = read_trace(records)
    out: Dict[str, MeasuredProfile] = {}

    def prof(kind: str) -> MeasuredProfile:
        if kind not in out:
            out[kind] = MeasuredProfile(program=kind)
        return out[kind]

    trainer_sids = set()
    windows: Dict[object, List[dict]] = {}
    for r in recs:
        if r.get("type") != "span":
            continue
        name = r.get("name")
        args = r.get("args") or {}
        if name == "trainer_step":
            trainer_sids.add(r.get("sid"))
        elif name == "device_step":
            kind = args.get("kind") or ""
            if program is not None and kind != program:
                continue
            p = prof(kind)
            p.spans += 1
            p.steps += int(args.get("steps", 1) or 1)
            p.device_ms_total += float(args.get("device_ms", 0.0) or 0.0)
            windows.setdefault(r.get("parent"), []).append(r)
        elif name == "jit_compile":
            kind = args.get("program") or ""
            if program is not None and kind != program:
                continue
            prof(kind).compile_ms += float(
                args.get("compile_ms", 0.0) or 0.0)
    # intra-step gaps: only windows parented by a trainer_step span
    gap_ns: Dict[str, float] = {}
    gap_n: Dict[str, int] = {}
    for parent, spans in windows.items():
        if parent not in trainer_sids:
            continue
        spans.sort(key=lambda s: s.get("ts_ns", 0))
        kind = (spans[0].get("args") or {}).get("kind") or ""
        total = 0.0
        for a, b in zip(spans, spans[1:]):
            end_a = (a.get("ts_ns", 0) or 0) + (a.get("dur_ns", 0) or 0)
            total += max(0.0, (b.get("ts_ns", 0) or 0) - end_a)
        gap_ns[kind] = gap_ns.get(kind, 0.0) + total
        gap_n[kind] = gap_n.get(kind, 0) + 1
    for kind, p in out.items():
        n = gap_n.get(kind, 0)
        p.gap_windows = n
        p.dispatch_gap_ms = (gap_ns.get(kind, 0.0) / n / 1e6) if n else 0.0
    return out


# Event-name → op-kind classifier for device events: the JAX parser's
# buckets (costreport._kind_of's, on XLA's thunk names), applied to the
# names of the card's kernels (cuBLAS GEMMs land in "dot", the port's
# hand-written kernels and PyTorch's elementwise kernels in "other")
_EVENT_KINDS = (
    ("fusion", ("fusion", "loop_fusion", "input_fusion")),
    ("dot", ("dot", "gemm", "matmul", "convert.dot", "cublas")),
    ("conv", ("conv", "convolution")),
    ("collective", ("all-reduce", "all-gather", "all-to-all",
                    "reduce-scatter", "collective", "allreduce")),
    ("custom", ("custom-call", "custom_call", "mosaic", "tpu_custom")),
    ("copy", ("copy", "memcpy", "transpose", "bitcast", "reshape")),
)

# torch.profiler's Chrome-trace categories of work the card ran
# ("gpu_user_annotation" mirrors a host region onto the GPU timeline and
# is not work)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _classify_event(name: str) -> str:
    low = name.lower()
    for kind, pats in _EVENT_KINDS:
        if any(p in low for p in pats):
            return kind
    return "other"


def _start_session():
    """A started ``torch.profiler`` session recording the host's ops
    and, with a card, the card's kernels and copies."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    session = torch.profiler.profile(activities=acts)
    session.start()
    return session


def parse_device_trace(log_dir: str,
                       program: str = "run"
                       ) -> Optional[MeasuredProfile]:
    """Parser for the Chrome trace a ``torch.profiler`` capture writes
    (``*.trace.json`` or ``*.trace.json.gz`` under ``log_dir``): sums
    measured device time per op kind, derives the device-idle fraction
    over each stream's first-to-last event, and counts device events by
    name (``event_counts``). ``program``'s host regions
    (``step_annotation``) count the steps. Returns None when no trace
    file or no device event exists — the caller then falls back to
    ``parse_tracer_records``.
    """
    paths = sorted(glob.glob(
        os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True))
    paths += sorted(glob.glob(
        os.path.join(log_dir, "**", "*.trace.json"), recursive=True))
    if not paths:
        return None
    events: List[dict] = []
    for p in paths:
        if p.endswith(".gz"):
            with gzip.open(p, "rb") as f:
                data = json.load(io.TextIOWrapper(f))
        else:
            with open(p) as f:
                data = json.load(f)
        events.extend(data.get("traceEvents", data)
                      if isinstance(data, dict) else data)
    p = MeasuredProfile(source="device-trace", program=program,
                        attribution="measured")
    lanes: Dict[tuple, List[Tuple[float, float]]] = {}
    steps = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        cat = str(e.get("cat", "")).lower()
        if cat not in _DEVICE_CATS:
            if (name == program or name.startswith(f"{program} ")) \
                    and cat != "gpu_user_annotation":
                steps += 1  # step_annotation regions
            continue
        dur_us = float(e.get("dur", 0.0) or 0.0)
        ts_us = float(e.get("ts", 0.0) or 0.0)
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(
            (ts_us, ts_us + dur_us))
        kind = _classify_event(name)
        p.op_kind_ms[kind] = p.op_kind_ms.get(kind, 0.0) + dur_us / 1e3
        p.event_counts[name] = p.event_counts.get(name, 0) + 1
        p.spans += 1
    if not lanes:
        return None
    # busy/idle from merged per-lane intervals (nested events union out)
    busy_us = span_us = 0.0
    for ivals in lanes.values():
        ivals.sort()
        span_us += ivals[-1][1] - ivals[0][0]
        cur_a, cur_b = ivals[0]
        for a, b in ivals[1:]:
            if a > cur_b:
                busy_us += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy_us += cur_b - cur_a
    p.device_ms_total = busy_us / 1e3
    p.steps = max(1, steps)
    p.idle_frac = round(1.0 - busy_us / span_us, 4) if span_us > 0 else None
    return p


# ------------------------------------------------------------------ join
def measured_vs_modeled(profile: MeasuredProfile, report=None,
                        peak_flops: Optional[float] = None) -> dict:
    """Join measured device time against the program's modeled cost:
    the JAX join's dict with ``report=None`` (per-kind measured ms and
    shares, modeled shares 0, ``measured_mfu`` and
    ``model_agreement_ratio`` None). ``peak_flops`` is accepted for the
    JAX signature. A ``CostReport`` join raises: the port's cost report
    is ROADMAP A item 2.
    """
    if report is not None:
        raise NotImplementedError(
            "measured_vs_modeled(report=...): the port has no CostReport "
            "yet (obs/costreport.py's harvest): ROADMAP A item 2")
    per_step_ms = profile.device_ms_per_step
    steps = max(1, profile.steps)
    op_ms = {k: v / steps for k, v in profile.op_kind_ms.items()}
    total_op = sum(op_ms.values())
    rows = []
    for k in sorted(op_ms, key=lambda k: -op_ms[k]):
        rows.append({
            "kind": k,
            "measured_ms": round(op_ms[k], 4),
            "measured_share": round(op_ms[k] / total_op
                                    if total_op > 0 else 0.0, 4),
            "modeled_share": 0.0,
            "modeled_flops": 0.0,
        })
    return {
        "program": profile.program,
        "source": profile.source,
        "attribution": profile.attribution or "measured",
        "steps": profile.steps,
        "device_ms_per_step": round(per_step_ms, 4),
        "compile_ms": round(profile.compile_ms, 3),
        "dispatch_gap_ms": round(profile.dispatch_gap_ms, 4),
        "gap_windows": profile.gap_windows,
        "idle_frac": profile.idle_frac,
        "measured_mfu": None,
        "model_agreement_ratio": None,
        "kinds": rows,
    }


def format_measured_table(join: dict) -> str:
    """Human-readable measured-vs-modeled table: op kinds ranked by
    measured time, modeled share alongside."""
    mfu_s = ("n/a" if join.get("measured_mfu") is None
             else f"{join['measured_mfu']:.4f}")
    agr = join.get("model_agreement_ratio")
    agr_s = "n/a" if agr is None else f"{agr:.3f}"
    idle = join.get("idle_frac")
    lines = [
        f"program={join.get('program') or '?'}  "
        f"source={join.get('source')}  steps={join.get('steps')}",
        f"device {join.get('device_ms_per_step', 0.0):.3f} ms/step  "
        f"dispatch gap {join.get('dispatch_gap_ms', 0.0):.3f} ms/step "
        f"({join.get('gap_windows', 0)} windows)"
        + (f"  idle {100.0 * idle:.1f}%" if idle is not None else "")
        + f"  compile {join.get('compile_ms', 0.0):.0f} ms",
        f"measured_mfu {mfu_s}  model_agreement_ratio {agr_s}  "
        f"(attribution: {join.get('attribution')})",
        "",
        f"{'kind':<12}{'meas ms':>10}{'meas%':>9}{'model%':>9}",
    ]
    for row in join.get("kinds", []):
        lines.append(
            f"{row['kind']:<12}{row['measured_ms']:>10.4f}"
            f"{100.0 * row['measured_share']:>8.1f}%"
            f"{100.0 * row['modeled_share']:>8.1f}%")
    if not join.get("kinds"):
        lines.append("(no attributable kinds)")
    return "\n".join(lines)


def profiler_state_from_trace(records) -> Optional[dict]:
    """The last ``profiler`` state event in a trace — how an offline
    reader of a trace shows whether a capture is running."""
    from paddle_tpu_torch.obs.trace import read_trace

    last = None
    for r in read_trace(records):
        if r.get("type") == "event" and r.get("name") == "profiler":
            last = r.get("args") or {}
    return last
