"""Serving goodput — decode-loop wall-time decomposition + tail
attribution from the per-request lifecycle ledger.

The serving-side twin of obs/goodput.py (the trainer decomposition):
where that module answers "where did the STEP's wall time go?", this
one answers it for the continuous-batching decode loop
(serving/decode_engine.py), whose wall clock is spent very differently
— prompt prefills stall the shared decode step, speculation burns
draft+verify time beyond the tokens it lands, CoW copies serve the
beam lane, and an empty engine just waits.

Two views, both fed by cheap host-side accounting (no tracer span per
event):

1. **Loop decomposition** — the engine accumulates fenced per-phase
   wall ms into named components (``prefill_stall`` /
   ``decode_compute`` / ``host_batching`` / ``spec_overhead`` /
   ``cow_copy`` / ``idle``); ``decompose_serving`` reconciles the sum
   against the independently measured loop wall, reports the remainder
   as ``residual_ms`` so the accounting is falsifiable
   (the engine's tests hold coverage within 10%), computes
   ``decode_goodput`` = fenced decode compute / non-idle wall, and
   names the bottleneck verdict.

2. **Tail attribution** — each retired request's ledger decomposes its
   OWN TTFT into ``queue`` / ``prefill_stall_behind`` (other requests'
   prefills running while it queued) / ``own_prefill`` /
   ``preempt_redo``; ``ttft_attribution`` aggregates per-component
   p50/p99 and, over the p99 tail set, names which component dominates
   — the measured number chunked prefill exists to beat.

The ledger itself is a bounded ring of retired-request dicts (engine
``ledger_ring=``); ``render_timeline`` turns one into the
human-readable event list ``requestz`` prints.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = ["COMPONENTS", "VERDICTS", "TTFT_COMPONENTS",
           "decompose_serving", "ttft_attribution",
           "format_serving_table", "render_timeline"]

# loop-decomposition components, in reporting order.
# ``prefill_stall`` is the whole-prompt mode's unbounded admission
# stall; in chunked mode it stays zero and the (budget-bounded)
# prefill share of each mixed step lands in ``chunked_prefill``.
COMPONENTS = ("prefill_stall", "chunked_prefill", "decode_compute",
              "host_batching", "spec_overhead", "cow_copy", "idle")
VERDICTS = {
    "prefill_stall": "prefill-bound",
    "chunked_prefill": "chunked-prefill-bound",
    "decode_compute": "compute-bound",
    "host_batching": "host-bound",
    "spec_overhead": "speculation-bound",
    "cow_copy": "cow-bound",
    "idle": "idle",
}

# per-request TTFT decomposition, in reporting order
TTFT_COMPONENTS = ("queue", "prefill_stall_behind", "own_prefill",
                   "preempt_redo")


def _pctl(sorted_vals: List[float], p: float) -> float:
    """Linear-interpolated percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    rank = (p / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def decompose_serving(snapshot: dict,
                      ledgers: Optional[List[dict]] = None) -> dict:
    """Reconcile the engine's component accumulators against its
    measured loop wall.

    ``snapshot`` is ``DecodeEngine.goodput_snapshot()``:
    ``{"loop_wall_ms", "turns", "steps", "components": {name: ms}}``.
    Returns wall/coverage/residual, per-component ms + share,
    ``decode_goodput`` (fenced decode compute over non-idle wall — the
    fraction of busy loop time that advanced resident requests), the
    bottleneck ``verdict`` (largest non-idle component; ``idle`` when
    the loop mostly waited), and — when ``ledgers`` is given — the
    ``ttft`` attribution block.
    """
    turns = int(snapshot.get("turns") or 0)
    wall = float(snapshot.get("loop_wall_ms") or 0.0)
    comps = {k: float((snapshot.get("components") or {}).get(k, 0.0))
             for k in COMPONENTS}
    if not turns or wall <= 0.0:
        out = {"turns": 0, "steps": 0, "loop_wall_ms": 0.0,
               "components": {k: 0.0 for k in COMPONENTS},
               "shares": {k: 0.0 for k in COMPONENTS},
               "residual_ms": 0.0, "coverage": 0.0,
               "decode_goodput": 0.0, "verdict": "unknown"}
        if ledgers is not None:
            out["ttft"] = ttft_attribution(ledgers)
        return out

    total = sum(comps.values())
    idle = comps["idle"]
    busy = max(wall - idle, 0.0)
    goodput = comps["decode_compute"] / busy if busy > 0 else 0.0

    busy_total = total - idle
    if busy_total > 0 and busy > 0:
        verdict_key = max((k for k in COMPONENTS if k != "idle"),
                          key=lambda k: comps[k])
        # a loop that overwhelmingly waited is idle whatever the busy
        # split says (an unloaded engine has no bottleneck to name)
        if idle > 0.9 * wall:
            verdict_key = "idle"
    else:
        verdict_key = "idle"

    out = {
        "turns": turns,
        "steps": int(snapshot.get("steps") or 0),
        "loop_wall_ms": round(wall, 4),
        "components": {k: round(v, 4) for k, v in comps.items()},
        "shares": {k: round(v / wall, 4) for k, v in comps.items()},
        "residual_ms": round(wall - total, 4),
        "coverage": round(total / wall, 4),
        "decode_goodput": round(goodput, 4),
        "verdict": VERDICTS[verdict_key],
    }
    if ledgers is not None:
        out["ttft"] = ttft_attribution(ledgers)
    return out


def ttft_attribution(ledgers: List[dict]) -> dict:
    """Aggregate per-request TTFT decompositions (from retired-request
    ledgers) into per-component p50/p99 and the tail verdict.

    The tail set is the requests whose TTFT reaches its own p99; over
    that set, the dominant component and each component's share of the
    tail's total TTFT are reported — ``prefill_stall_share_p99`` is
    the bench's before-number for chunked prefill.
    """
    parts = [led.get("ttft_parts") for led in ledgers
             if led.get("ttft_parts")]
    if not parts:
        return {"requests": 0, "ttft_ms_p50": 0.0, "ttft_ms_p99": 0.0,
                "p50": {k: 0.0 for k in TTFT_COMPONENTS},
                "p99": {k: 0.0 for k in TTFT_COMPONENTS},
                "dominant_p99": "unknown",
                "prefill_stall_share_p99": 0.0}
    ttfts = sorted(float(led["ttft_ms"]) for led in ledgers
                   if led.get("ttft_parts"))
    p99_cut = _pctl(ttfts, 99.0)
    tail = [led for led in ledgers if led.get("ttft_parts")
            and float(led["ttft_ms"]) >= p99_cut]
    tail_sums = {k: sum(float(led["ttft_parts"].get(k, 0.0))
                        for led in tail) for k in TTFT_COMPONENTS}
    tail_ttft = sum(float(led["ttft_ms"]) for led in tail) or 1.0
    dominant = max(TTFT_COMPONENTS, key=lambda k: tail_sums[k])
    out = {"requests": len(parts),
           "ttft_ms_p50": round(_pctl(ttfts, 50.0), 4),
           "ttft_ms_p99": round(p99_cut, 4),
           "p50": {}, "p99": {},
           "dominant_p99": dominant,
           "prefill_stall_share_p99": round(
               tail_sums["prefill_stall_behind"] / tail_ttft, 4)}
    for k in TTFT_COMPONENTS:
        vals = sorted(float(p.get(k, 0.0)) for p in parts)
        out["p50"][k] = round(_pctl(vals, 50.0), 4)
        out["p99"][k] = round(_pctl(vals, 99.0), 4)
    return out


def format_serving_table(d: dict) -> str:
    """Render one serving decomposition as a component table (+ the
    TTFT attribution block when the decomposition carries one)."""
    if not d.get("turns"):
        return "serving goodput: no loop turns recorded"
    lines = [
        f"loop turns {d['turns']}  steps {d['steps']}  wall "
        f"{d['loop_wall_ms']:.1f} ms  goodput {d['decode_goodput']:.3f}"
        f"  verdict {d['verdict']}",
        f"{'component':<16}{'ms':>12}{'share':>9}",
    ]
    wall = d["loop_wall_ms"] or 1.0
    for k in COMPONENTS:
        v = d["components"][k]
        lines.append(f"{k.replace('_', ' '):<16}{v:>12.2f}"
                     f"{100.0 * v / wall:>8.1f}%")
    lines.append(f"{'residual':<16}{d['residual_ms']:>12.2f}"
                 f"{100.0 * d['residual_ms'] / wall:>8.1f}%")
    t = d.get("ttft")
    if t and t.get("requests"):
        lines.append(
            f"ttft p50 {t['ttft_ms_p50']:.2f} ms  p99 "
            f"{t['ttft_ms_p99']:.2f} ms over {t['requests']} requests"
            f"  tail dominated by {t['dominant_p99']} "
            f"(prefill-stall share "
            f"{100.0 * t['prefill_stall_share_p99']:.1f}%)")
        lines.append(f"{'ttft component':<22}{'p50 ms':>10}{'p99 ms':>10}")
        for k in TTFT_COMPONENTS:
            lines.append(f"{k.replace('_', ' '):<22}"
                         f"{t['p50'][k]:>10.2f}{t['p99'][k]:>10.2f}")
    return "\n".join(lines)


# event kind -> how to render its extra fields
_EVENT_FMT = {
    "submit": lambda e: "",
    "admit": lambda e: f"prefix_hit={e[2]} tail={e[3]}",
    "prefill": lambda e: f"rung={e[3]} dur={e[2]:.2f}ms",
    "chunk": lambda e: f"tokens={e[2]} dur={e[3]:.2f}ms",
    "step": lambda e: f"step={e[2]} occupancy={e[3]}",
    "spec": lambda e: f"proposed={e[2]} accepted={e[3]}",
    "cow": lambda e: f"copies={e[2]}",
    "execute": lambda e: f"dur={e[2]:.2f}ms bucket={e[3]}",
    "preempt": lambda e: "",
    "first_token": lambda e: "",
    "finish": lambda e: "",
}


def render_timeline(ledger: dict, max_events: int = 64) -> List[str]:
    """One retired-request ledger as human-readable event lines
    (``requestz``, the flight recorder's slow-request ledgers).
    Consecutive ``step`` events are run-length collapsed so a long
    decode reads as one line, and the tail past ``max_events`` is
    elided with a count."""
    events = ledger.get("events") or []
    rows: List[tuple] = []        # (t_ms, text)
    step_run = None               # (t0, t1, first_idx, last_idx, occ)
    for e in events:
        kind, t = e[0], float(e[1])
        if kind == "step":
            if step_run is None:
                step_run = [t, t, e[2], e[2], e[3]]
            else:
                step_run[1], step_run[3], step_run[4] = t, e[2], e[3]
            continue
        if step_run is not None:
            n = step_run[3] - step_run[2] + 1
            rows.append((step_run[0],
                         f"steps x{n} (engine steps "
                         f"{step_run[2]}..{step_run[3]}, last "
                         f"occupancy {step_run[4]})"))
            step_run = None
        fmt = _EVENT_FMT.get(kind)
        detail = fmt(e) if fmt else " ".join(str(x) for x in e[2:])
        rows.append((t, f"{kind}" + (f" {detail}" if detail else "")))
    if step_run is not None:
        n = step_run[3] - step_run[2] + 1
        rows.append((step_run[0],
                     f"steps x{n} (engine steps {step_run[2]}.."
                     f"{step_run[3]}, last occupancy {step_run[4]})"))
    lines = [f"+{t:9.2f}ms  {text}" for t, text in rows[:max_events]]
    if len(rows) > max_events:
        lines.append(f"  ... {len(rows) - max_events} more events")
    return lines
