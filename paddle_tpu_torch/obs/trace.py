"""Structured span/event tracer — JSONL records + Perfetto export.

Each record is one JSON object per line (``trace.jsonl``):

  {"type": "span",   "name": ..., "sid": 3, "parent": 2,
   "ts_ns": <monotonic start>, "dur_ns": ..., "args": {...}}
  {"type": "event",  "name": ..., "sid": null, "parent": 2,
   "ts_ns": ..., "args": {...}}
  {"type": "metric", "name": ..., "metric": <Metric.snapshot()>}
  {"type": "counter", "name": ..., "ts_ns": ..., "values": {...}}

Timestamps are ``time.monotonic_ns()`` — orderable within a process,
immune to wall-clock steps. Span ids are process-unique and nest via a
thread-local stack, so host-side structure (pass > step > dispatch)
survives into the file the way the reference's layer-stack timers
(utils/Stat.h + CustomStackTrace) only survived into stdout.

``to_perfetto`` converts a trace into the Chrome/Perfetto trace-event
JSON format (phase "X" complete events, microsecond timestamps) so
``chrome://tracing`` / ui.perfetto.dev open it directly next to a
``torch.profiler`` device trace (obs/profiler.py).

``summarize_trace`` is the stats engine: per-span-name
count/total/mean/p50/max plus the final metric snapshots.

Cross-process tracing (the fleet observatory): a tracer
constructed with ``span_prefix="r0"`` mints span ids like ``"r0:3"``
instead of bare ints — the same per-replica namespacing
``aggregate.py`` gives ``host_step_ms{host}`` — so N replicas' ids can
never alias when their traces are merged. ``wire_context(sid)`` packs
a root span into the small dict ``{"trace_id", "span_id"}`` that rides
a request over the wire; the receiving process passes it back as
``ctx=`` to ``span``/``start_span`` and its local span records carry
``trace_id`` + ``remote_parent``. ``stitch_traces`` merges N replicas'
trace JSONLs into ONE Perfetto export: one pid track per replica,
timestamps rebased onto a shared wall clock through each tracer's
``meta`` anchor record, and cross-process parentage rendered as flow
arrows from the remote parent to its children.
"""
from __future__ import annotations

import atexit
import contextlib
import io
import itertools
import json
import os
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Tracer", "read_trace", "summarize_trace", "to_perfetto",
           "format_summary", "new_trace_id", "stitch_traces"]


# Streamed tracers register here so an interpreter exit that never
# reached Telemetry.close() still flushes the buffered tail — without
# this, a trace.jsonl could silently lose up to ``flush_every`` records
# whenever a script ends mid-span (the durability regression covered by
# tests/test_telemetry_plane.py).
_LIVE_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()
_ATEXIT_REGISTERED = False


def _flush_live_tracers():
    for t in list(_LIVE_TRACERS):
        try:
            t.flush()
        except Exception:
            pass


class Tracer:
    """Append-only span/event recorder.

    ``path=None`` keeps records in memory only (``records``);
    otherwise lines are buffered and flushed on ``flush``/``close`` (and
    opportunistically every ``flush_every`` records, so a crash loses at
    most one buffer).
    """

    def __init__(self, path: Optional[str] = None, flush_every: int = 256,
                 recent_cap: int = 512,
                 span_prefix: Optional[str] = None):
        self.path = path
        self.records: List[dict] = []
        # bounded ring of the most recent span/event records — what the
        # ``/tracez`` endpoint and the flight recorder read; stays O(1)
        # memory on long-running jobs even though ``records`` grows
        self.recent: "deque[dict]" = deque(maxlen=int(recent_cap))
        self._counter = itertools.count(1)
        # collision-safe ids across processes: a prefixed tracer mints
        # "r0:17"-style string ids, so stitched multi-replica exports
        # never alias two processes' span 17
        self.span_prefix = span_prefix
        self._stack = threading.local()
        self._lock = threading.Lock()
        self._pending: List[str] = []
        self._flush_every = int(flush_every)
        self._listeners: List[Callable[[dict], None]] = []
        self._open: Dict[object, dict] = {}   # start_span handles
        self._file = None
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._file = open(path, "w", buffering=1 << 16)
            global _ATEXIT_REGISTERED
            _LIVE_TRACERS.add(self)
            if not _ATEXIT_REGISTERED:
                _ATEXIT_REGISTERED = True
                atexit.register(_flush_live_tracers)
        # clock-anchor meta record: wall + monotonic stamps taken at
        # the same instant, so ``stitch_traces`` can rebase every
        # process's monotonic span times onto one shared wall timeline
        self._emit({"type": "meta", "name": "tracer",
                    "prefix": span_prefix, "pid": os.getpid(),
                    "wall_ns": time.time_ns(),
                    "mono_ns": time.monotonic_ns()})

    # ------------------------------------------------------------- core
    def _next_id(self):
        n = next(self._counter)
        return f"{self.span_prefix}:{n}" if self.span_prefix else n

    def _parent(self):
        stack = getattr(self._stack, "ids", None)
        return stack[-1] if stack else None

    # ----------------------------------------------- cross-process wire
    def wire_context(self, sid, trace_id: Optional[str] = None) -> dict:
        """Pack a span into the injectable wire context another process
        extracts: ``{"trace_id": ..., "span_id": ...}``. The trace_id
        groups every process's spans for one logical request; a fresh
        one is minted when the caller doesn't supply one."""
        return {"trace_id": trace_id or new_trace_id(),
                "span_id": sid}

    def add_listener(self, fn: Callable[[dict], None]):
        """Call ``fn(record)`` for every emitted record. Listeners must
        be cheap and must not call back into the tracer (they run under
        its lock); the flight recorder's ring append is the model."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[dict], None]):
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _emit(self, rec: dict):
        with self._lock:
            self._emit_locked(rec)

    def _emit_locked(self, rec: dict):
        self.records.append(rec)
        if rec.get("type") in ("span", "event"):
            self.recent.append(rec)
        if self._file is not None:
            self._pending.append(json.dumps(rec, default=str))
            if len(self._pending) >= self._flush_every:
                self._flush_locked()
        for fn in self._listeners:
            try:
                fn(rec)
            except Exception:
                pass

    def _flush_locked(self):
        if self._file is not None and self._pending:
            self._file.write("\n".join(self._pending) + "\n")
            self._pending.clear()

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[int] = None,
             ctx: Optional[dict] = None, **args: Any):
        """Timed nested region; ``args`` may be extended DURING the span
        via the yielded dict (e.g. device ms measured at the end).
        ``parent`` forces an explicit parent span id — the cross-thread
        case (a serving flush parented under a request span started on
        the client thread); default is the calling thread's span stack.
        ``ctx`` is an extracted wire context (``wire_context``'s dict):
        the record gains ``trace_id`` + ``remote_parent`` so a stitcher
        can re-attach it under a span from another process."""
        sid = self._next_id()
        if parent is None:
            parent = self._parent()
        stack = getattr(self._stack, "ids", None)
        if stack is None:
            stack = self._stack.ids = []
        stack.append(sid)
        t0 = time.monotonic_ns()
        try:
            yield args
        finally:
            dur = time.monotonic_ns() - t0
            stack.pop()
            rec = {"type": "span", "name": name, "sid": sid,
                   "parent": parent, "ts_ns": t0, "dur_ns": dur,
                   "args": args}
            if ctx:
                rec["trace_id"] = ctx.get("trace_id")
                rec["remote_parent"] = ctx.get("span_id")
            self._emit(rec)

    # ------------------------------------------- cross-thread span API
    def start_span(self, name: str, parent: Optional[int] = None,
                   ctx: Optional[dict] = None, **args: Any):
        """Open a span that another thread will close (``end_span``) —
        the serving request lifecycle, where ``submit`` happens on the
        client thread and completion on the dispatch worker. Returns the
        span id; the record is emitted only at ``end_span``. Does NOT
        join the calling thread's span stack (the whole point is that
        its children live on other threads, parented explicitly).
        ``ctx`` is an extracted wire context — see ``span``."""
        sid = self._next_id()
        # plain dict assignment/pop on _open is GIL-atomic, so the
        # submit hot path never touches the tracer lock; the record is
        # built and emitted (under the lock) only at end_span time
        self._open[sid] = {"name": name, "parent": parent,
                           "ts_ns": time.monotonic_ns(),
                           "args": args, "ctx": ctx}
        return sid

    def end_span(self, sid, **more_args: Any):
        """Close a ``start_span`` handle, emitting its record. Unknown
        or already-closed ids are ignored (a request whose span got
        dropped must not take the worker down)."""
        open_rec = self._open.pop(sid, None)
        if open_rec is None:
            return
        open_rec["args"].update(more_args)
        rec = {"type": "span", "name": open_rec["name"], "sid": sid,
               "parent": open_rec["parent"],
               "ts_ns": open_rec["ts_ns"],
               "dur_ns": time.monotonic_ns() - open_rec["ts_ns"],
               "args": open_rec["args"]}
        ctx = open_rec.get("ctx")
        if ctx:
            rec["trace_id"] = ctx.get("trace_id")
            rec["remote_parent"] = ctx.get("span_id")
        self._emit(rec)

    def emit_span(self, name: str, ts_ns: int, dur_ns: int,
                  parent: Optional[int] = None, **args: Any):
        """Emit a span with caller-measured timestamps — for phases
        reconstructed after the fact (per-request queue-wait intervals,
        measured as two monotonic_ns stamps on different threads)."""
        sid = self._next_id()
        self._emit({"type": "span", "name": name, "sid": sid,
                    "parent": parent, "ts_ns": int(ts_ns),
                    "dur_ns": max(0, int(dur_ns)), "args": args})
        return sid

    def emit_spans(self, spans) -> None:
        """Batch ``emit_span``: one lock round-trip for a whole flush's
        worth of per-request child spans. ``spans`` is an iterable of
        ``(name, ts_ns, dur_ns, parent, args)`` tuples; the tracer
        takes ownership of each ``args`` dict (pass fresh dicts). The
        serving path emits 2 reconstructed spans per request per flush;
        at high concurrency the per-span lock acquisition — not the
        record build — is the telemetry plane's dominant cost."""
        recs = [{"type": "span", "name": name, "sid": self._next_id(),
                 "parent": parent, "ts_ns": int(ts_ns),
                 "dur_ns": max(0, int(dur_ns)), "args": args}
                for name, ts_ns, dur_ns, parent, args in spans]
        if not recs:
            return
        with self._lock:
            for rec in recs:
                self._emit_locked(rec)

    def end_spans(self, closures) -> None:
        """Batch ``end_span``: ``closures`` is an iterable of
        ``(sid, more_args)`` pairs, all closed at one ``monotonic_ns``
        stamp under one lock acquisition; unknown ids are skipped."""
        t = time.monotonic_ns()
        recs = []
        for sid, more in closures:
            open_rec = self._open.pop(sid, None)
            if open_rec is None:
                continue
            open_rec["args"].update(more)
            recs.append({"type": "span", "name": open_rec["name"],
                         "sid": sid, "parent": open_rec["parent"],
                         "ts_ns": open_rec["ts_ns"],
                         "dur_ns": t - open_rec["ts_ns"],
                         "args": open_rec["args"]})
        if not recs:
            return
        with self._lock:
            for rec in recs:
                self._emit_locked(rec)

    def recent_spans(self, n: int = 100) -> List[dict]:
        """The last ``n`` span records (the ``/tracez`` payload)."""
        with self._lock:
            recs = list(self.recent)
        spans = [r for r in recs if r.get("type") == "span"]
        return spans[-int(n):]

    def event(self, name: str, **args: Any):
        """Instant (zero-duration) marker under the current span."""
        self._emit({"type": "event", "name": name, "sid": None,
                    "parent": self._parent(),
                    "ts_ns": time.monotonic_ns(), "args": args})

    def counter(self, name: str, values: Dict[str, Any]):
        """A counter-track sample: named numeric series sampled at this
        instant (Perfetto renders one stacked track per name — used for
        the per-op-kind flop/byte attribution tracks)."""
        self._emit({"type": "counter", "name": name, "sid": None,
                    "parent": self._parent(),
                    "ts_ns": time.monotonic_ns(), "values": dict(values)})

    def metric(self, name: str, snapshot: dict):
        """A final metric snapshot row (written by Telemetry.close)."""
        self._emit({"type": "metric", "name": name, "metric": snapshot})

    # ------------------------------------------------------------ sinks
    def flush(self):
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.flush()

    def close(self):
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------- readers
def read_trace(path_or_records) -> List[dict]:
    """Load a trace.jsonl (path, file object, or an in-memory record
    list, which passes through)."""
    if isinstance(path_or_records, list):
        return path_or_records
    if hasattr(path_or_records, "read"):
        lines = path_or_records.read().splitlines()
    else:
        with open(path_or_records) as f:
            lines = f.read().splitlines()
    out = []
    for ln in lines:
        ln = ln.strip()
        if ln:
            out.append(json.loads(ln))
    return out


def summarize_trace(path_or_records) -> dict:
    """Aggregate a trace into {"spans": {name: row}, "events": {...},
    "metrics": {...}}. Span rows: count, total_ms, mean_ms, p50_ms,
    max_ms, plus the mean of any numeric span arg (device_ms,
    examples_per_sec, ...) as ``arg_means``."""
    records = read_trace(path_or_records)
    by_name: Dict[str, List[dict]] = {}
    events: Dict[str, int] = {}
    metrics: Dict[str, dict] = {}
    for r in records:
        t = r.get("type")
        if t == "span":
            by_name.setdefault(r["name"], []).append(r)
        elif t == "event":
            events[r["name"]] = events.get(r["name"], 0) + 1
        elif t == "metric":
            metrics[r["name"]] = r.get("metric", {})
    spans = {}
    for name, rs in by_name.items():
        durs = sorted(r["dur_ns"] / 1e6 for r in rs)
        n = len(durs)
        arg_sums: Dict[str, float] = {}
        arg_counts: Dict[str, int] = {}
        for r in rs:
            for k, v in (r.get("args") or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    arg_sums[k] = arg_sums.get(k, 0.0) + v
                    arg_counts[k] = arg_counts.get(k, 0) + 1
        spans[name] = {
            "count": n,
            "total_ms": round(sum(durs), 3),
            "mean_ms": round(sum(durs) / n, 3),
            "p50_ms": round(durs[n // 2], 3),
            "max_ms": round(durs[-1], 3),
            "arg_means": {k: round(arg_sums[k] / arg_counts[k], 4)
                          for k in sorted(arg_sums)},
        }
    return {"spans": spans, "events": events, "metrics": metrics}


def format_summary(summary: dict) -> str:
    """Human-readable per-span table + metric rollup (``stats`` output)."""
    out = io.StringIO()
    spans = summary.get("spans", {})
    if spans:
        rows = sorted(spans.items(), key=lambda kv: -kv[1]["total_ms"])
        name_w = max(len("span"), *(len(n) for n, _ in rows))
        hdr = (f"{'span':<{name_w}}  {'count':>7}  {'total_ms':>10}  "
               f"{'mean_ms':>9}  {'p50_ms':>9}  {'max_ms':>9}")
        out.write(hdr + "\n" + "-" * len(hdr) + "\n")
        for name, r in rows:
            out.write(f"{name:<{name_w}}  {r['count']:>7}  "
                      f"{r['total_ms']:>10.3f}  {r['mean_ms']:>9.3f}  "
                      f"{r['p50_ms']:>9.3f}  {r['max_ms']:>9.3f}\n")
            for k, v in r["arg_means"].items():
                out.write(f"{'':<{name_w}}    {k} (mean) = {v}\n")
    if summary.get("events"):
        out.write("\nevents:\n")
        for name, n in sorted(summary["events"].items()):
            out.write(f"  {name} x{n}\n")
    if summary.get("metrics"):
        out.write("\nmetrics:\n")
        for name, snap in sorted(summary["metrics"].items()):
            for key, vd in (snap.get("series") or {}).items():
                lbl = f"{{{key}}}" if key else ""
                if snap.get("kind") == "histogram":
                    out.write(
                        f"  {name}{lbl}: count={vd.get('count')} "
                        f"mean={_r(vd.get('mean'))} p50={_r(vd.get('p50'))} "
                        f"p99={_r(vd.get('p99'))}\n")
                else:
                    out.write(f"  {name}{lbl} = {_r(vd.get('value'))}\n")
    return out.getvalue()


def _r(v, nd=4):
    return round(v, nd) if isinstance(v, float) else v


def to_perfetto(path_or_records, out_path: str) -> str:
    """Write the Chrome/Perfetto trace-event JSON for a trace.jsonl.

    Spans become phase-"X" complete events on one process track;
    instant events become phase-"i". Perfetto only needs relative
    microsecond timestamps, so the monotonic origin is rebased to 0.
    """
    records = read_trace(path_or_records)
    ts0 = min((r["ts_ns"] for r in records if "ts_ns" in r), default=0)
    events: List[dict] = []
    for r in records:
        if r.get("type") == "span":
            events.append({
                "name": r["name"], "ph": "X", "pid": 1, "tid": 1,
                "ts": (r["ts_ns"] - ts0) / 1e3,
                "dur": r["dur_ns"] / 1e3,
                "args": r.get("args") or {},
            })
        elif r.get("type") == "event":
            events.append({
                "name": r["name"], "ph": "i", "s": "t", "pid": 1,
                "tid": 1, "ts": (r["ts_ns"] - ts0) / 1e3,
                "args": r.get("args") or {},
            })
        elif r.get("type") == "counter":
            events.append({
                "name": r["name"], "ph": "C", "pid": 1,
                "ts": (r["ts_ns"] - ts0) / 1e3,
                "args": r.get("values") or {},
            })
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return out_path


# ------------------------------------------------------- fleet stitching
def new_trace_id() -> str:
    """A fresh 16-hex-char trace id grouping one logical request's spans
    across every process that touches it (W3C-traceparent-sized)."""
    return uuid.uuid4().hex[:16]


def _trace_anchor(records):
    """(wall_ns, mono_ns) pair from the tracer's meta record, or None
    for pre-fleet traces (they rebase to their own origin instead)."""
    for r in records:
        if r.get("type") == "meta" and "wall_ns" in r and "mono_ns" in r:
            return int(r["wall_ns"]), int(r["mono_ns"])
    return None


def stitch_traces(traces, out_path: str, labels=None) -> dict:
    """Merge N replicas' trace JSONLs into ONE Perfetto export.

    ``traces`` is a list of paths/record-lists (one per replica);
    ``labels`` optionally names each track (defaults to ``replica<i>``).
    Each replica becomes its own pid track (process_name metadata), and
    every replica's monotonic timestamps are rebased onto the shared
    wall clock through its tracer's meta anchor record — so two
    processes' spans line up in real time, not each at its own zero.
    Cross-process parentage (``remote_parent`` from an injected wire
    context) is rendered as Perfetto flow arrows ("s" on the remote
    parent, "f" on the child), keyed per trace_id.

    Returns a summary: per-replica span counts, the number of
    cross-process links drawn, and the distinct trace_ids seen.
    """
    labels = list(labels) if labels else [f"replica{i}"
                                          for i in range(len(traces))]
    per_replica = [read_trace(t) for t in traces]
    anchors = [_trace_anchor(recs) for recs in per_replica]
    # Shared origin: earliest wall-clock anchor (or 0 when no trace has
    # one — then each replica falls back to its own monotonic origin).
    wall0 = min((a[0] - a[1] for a in anchors if a), default=None)

    def _rebase(i):
        a = anchors[i]
        if a is not None and wall0 is not None:
            off = (a[0] - a[1]) - wall0     # wall-minus-mono, shifted
            return lambda ts: (ts + off) / 1e3
        recs = per_replica[i]
        t0 = min((r["ts_ns"] for r in recs if "ts_ns" in r), default=0)
        return lambda ts: (ts - t0) / 1e3

    events: List[dict] = []
    # sid -> (pid, ts_us) of every span, so remote_parent links can
    # anchor the flow start on the parent's own track
    span_at: Dict[object, tuple] = {}
    cross_links = 0
    trace_ids = set()
    for i, recs in enumerate(per_replica):
        pid = i + 1
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": labels[i]}})
        rb = _rebase(i)
        for r in recs:
            t = r.get("type")
            if t == "span":
                ts = rb(r["ts_ns"])
                events.append({
                    "name": r["name"], "ph": "X", "pid": pid, "tid": 1,
                    "ts": ts, "dur": r["dur_ns"] / 1e3,
                    "args": r.get("args") or {},
                })
                span_at[r["sid"]] = (pid, ts)
            elif t == "event":
                events.append({
                    "name": r["name"], "ph": "i", "s": "t", "pid": pid,
                    "tid": 1, "ts": rb(r["ts_ns"]),
                    "args": r.get("args") or {},
                })
            elif t == "counter":
                events.append({
                    "name": r["name"], "ph": "C", "pid": pid,
                    "ts": rb(r["ts_ns"]),
                    "args": r.get("values") or {},
                })
    # Second pass: flow arrows from each remote parent to its children.
    for i, recs in enumerate(per_replica):
        pid = i + 1
        rb = _rebase(i)
        for r in recs:
            if r.get("type") != "span" or not r.get("remote_parent"):
                continue
            tid_ = r.get("trace_id")
            if tid_:
                trace_ids.add(tid_)
            parent_loc = span_at.get(r["remote_parent"])
            if parent_loc is None:
                continue
            ppid, pts = parent_loc
            child_ts = rb(r["ts_ns"])
            flow_id = f"{tid_ or 'flow'}:{r['sid']}"
            events.append({"name": "request", "ph": "s", "id": flow_id,
                           "pid": ppid, "tid": 1, "ts": pts,
                           "cat": "fleet"})
            events.append({"name": "request", "ph": "f", "bp": "e",
                           "id": flow_id, "pid": pid, "tid": 1,
                           "ts": child_ts, "cat": "fleet"})
            cross_links += 1
    # Normalize so the merged timeline starts at 0 (relative alignment
    # between replicas is what matters, not hours-of-uptime offsets).
    ts_min = min((e["ts"] for e in events if "ts" in e), default=0.0)
    for e in events:
        if "ts" in e:
            e["ts"] -= ts_min
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return {
        "out_path": out_path,
        "replicas": {labels[i]: sum(1 for r in per_replica[i]
                                    if r.get("type") == "span")
                     for i in range(len(per_replica))},
        "cross_links": cross_links,
        "trace_ids": sorted(trace_ids),
    }
