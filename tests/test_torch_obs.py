"""The port's observability modules held against the JAX package's.

The same operations go through ``paddle_tpu.obs`` and
``paddle_tpu_torch.obs``: registry snapshots, Prometheus text and JSON,
bucket quantiles, merges and snapshot round trips; tracer records (ids
and times aside), summaries, Perfetto exports and stitched traces; the
trainer and serving goodput decompositions, the TTFT attribution and
the rendered timelines; alert firings over one registry history with
the clock injected (the decode burn-rate SLOs included); the profiler's
tracer-record parser and its join without a cost report. Then what is
the port's own: the device-trace parser on ``torch.profiler``'s Chrome
trace, the capture session on the CPU, the Telemetry hooks and its
deferred options (A9, A10, A item 2), the flight recorder's bundles and
SIGTERM chain, the reader sink, the card's peak table, and the metric
contract (every name the port registers is in a docs metric table).
"""
import json
import os
import signal
import sys
import time
import types
import zipfile

import numpy as np
import pytest
import torch

from paddle_tpu.obs import alerts as jalerts
from paddle_tpu.obs import goodput as jgoodput
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import profiler as jprofiler
from paddle_tpu.obs import servegoodput as jsg
from paddle_tpu.obs import trace as jtrace
from paddle_tpu.obs.costreport import mfu as jmfu
from paddle_tpu.obs.flightrecorder import FlightRecorder as JFlight
from paddle_tpu.obs.telemetry import Telemetry as JTelemetry
from paddle_tpu_torch.obs import alerts as talerts
from paddle_tpu_torch.obs import costreport as tcost
from paddle_tpu_torch.obs import goodput as tgoodput
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import profiler as tprofiler
from paddle_tpu_torch.obs import servegoodput as tsg
from paddle_tpu_torch.obs import trace as ttrace
from paddle_tpu_torch.obs.flightrecorder import FlightRecorder as TFlight
from paddle_tpu_torch.obs.telemetry import Telemetry as TTelemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from check_metric_contract import (code_metric_names,  # noqa: E402
                                   doc_metric_names)

PKGS = {"jax": types.SimpleNamespace(metrics=jmetrics, trace=jtrace,
                                     goodput=jgoodput, sg=jsg,
                                     alerts=jalerts, profiler=jprofiler,
                                     Telemetry=JTelemetry, Flight=JFlight),
        "torch": types.SimpleNamespace(metrics=tmetrics, trace=ttrace,
                                       goodput=tgoodput, sg=tsg,
                                       alerts=talerts, profiler=tprofiler,
                                       Telemetry=TTelemetry,
                                       Flight=TFlight)}


def _both(fn):
    """``fn(pkg)`` for the JAX package and the port."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


# ------------------------------------------------------------- registry
def _registry_script(m):
    """One fixed sequence of registry operations; returns the registry."""
    reg = m.MetricsRegistry("parity")
    c = reg.counter("t_requests_total", "requests", ("kind",))
    c.inc(3, kind="a")
    c.inc(kind="b")
    g = reg.gauge("t_depth", "queue depth")
    g.set(4.0)
    g.inc(2.5)
    g.dec(1.0)
    h = reg.histogram("t_latency_ms", "latency",
                      buckets=m.LATENCY_BUCKETS_MS)
    rng = np.random.default_rng(3)
    for v in rng.gamma(2.0, 20.0, 700):     # past the reservoir's 512
        h.observe(float(v))
    lh = reg.histogram("t_step_ms", "labeled", ("program",))
    for i, v in enumerate(rng.uniform(0.1, 900.0, 60)):
        lh.observe(float(v), program="run" if i % 3 else "run_multi")
    return reg


def test_registry_snapshot_prometheus_json_match_jax():
    jreg, treg = _both(lambda p: _registry_script(p.metrics))
    assert treg.snapshot() == jreg.snapshot()
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.to_json() == jreg.to_json()
    assert [m.name for m in treg.metrics()] == \
        [m.name for m in jreg.metrics()]


@pytest.mark.parametrize("p", [1.0, 25.0, 50.0, 90.0, 99.0, 100.0])
def test_histogram_quantiles_match_jax(p):
    jreg, treg = _both(lambda pk: _registry_script(pk.metrics))
    for name, labels in (("t_latency_ms", {}),
                         ("t_step_ms", {"program": "run"}),
                         ("t_step_ms", {"program": "run_multi"})):
        jh, th = jreg.find(name), treg.find(name)
        assert th.quantile_from_buckets(p, **labels) == \
            jh.quantile_from_buckets(p, **labels)
        assert th.percentile(p, **labels) == jh.percentile(p, **labels)
    assert treg.find("t_latency_ms").iqr() == jreg.find("t_latency_ms").iqr()
    # a never-observed label set reads None and materializes nothing
    assert treg.find("t_step_ms").quantile_from_buckets(
        50.0, program="absent") is None
    assert "absent" not in treg.prometheus_text()


def test_registry_from_snapshot_round_trips_like_jax():
    jsrc, tsrc = _both(lambda p: _registry_script(p.metrics))
    jr = jmetrics.registry_from_snapshot(jsrc.snapshot())
    tr = tmetrics.registry_from_snapshot(tsrc.snapshot())
    assert tr.prometheus_text() == jr.prometheus_text()
    assert tr.prometheus_text() == tsrc.prometheus_text()
    for p in (50.0, 99.0):
        assert tr.find("t_latency_ms").quantile_from_buckets(p) == \
            tsrc.find("t_latency_ms").quantile_from_buckets(p)
    # the port reads the JAX package's snapshot too (one wire format)
    assert tmetrics.registry_from_snapshot(
        jsrc.snapshot()).prometheus_text() == tsrc.prometheus_text()


def test_histogram_merge_find_reset_match_jax():
    def run(m):
        a = _registry_script(m)
        b = _registry_script(m)
        a.find("t_latency_ms").merge(b.find("t_latency_ms"))
        a.find("t_step_ms").merge(b.find("t_step_ms"))
        bad = m.MetricsRegistry("x").histogram("t_latency_ms", "x",
                                               buckets=(1.0, 2.0))
        bad.observe(1.5)
        with pytest.raises(ValueError, match="mismatched bucket"):
            a.find("t_latency_ms").merge(bad)
        snap = a.snapshot()
        assert a.find("never") is None and "never" not in a.snapshot()
        a.reset()
        assert a.snapshot() == {}
        return snap
    jsnap, tsnap = _both(lambda p: run(p.metrics))
    assert tsnap == jsnap
    assert tmetrics.default_registry.name == "paddle_tpu_torch"


# --------------------------------------------------------------- tracer
def _trace_script(tr):
    """Spans (nested, explicit, emitted, wire contexts), events,
    counters and a metric on one tracer."""
    with tr.span("pass", pass_id=0):
        with tr.span("step", n=1) as args:
            args["loss"] = 0.5
            tr.event("feed", rows=8)
        sid = tr.start_span("serving_request", request_id=7)
        ctx = tr.wire_context(sid, trace_id="t" * 32)
        child = tr.start_span("remote", ctx=ctx)
        tr.end_span(child, ok=True)
        tr.emit_spans([("decode_prefill", 1000, 2000, sid,
                        {"rung": 16}),
                       ("decode_stream", 3000, 5000, sid, {})])
        tr.end_span(sid, tokens=4)
    tr.counter("occupancy", {"slots": 3, "blocks": 12})
    reg = jmetrics.MetricsRegistry("m")
    reg.counter("x_total", "x").inc(2)
    tr.metric("x_total", reg.snapshot()["x_total"])


_TIME_KEYS = ("ts_ns", "dur_ns", "wall_ns", "wall_s", "pid", "t_wall",
              "mono_ns", "host")


def _normalize(records):
    """Records with times dropped and span ids renumbered in order of
    first appearance (ids are process-unique counters)."""
    ids = {}

    def rid(v):
        if v is None:
            return None
        return ids.setdefault(v, len(ids))

    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in _TIME_KEYS}
        for k in ("sid", "parent", "remote_parent"):
            if k in r:
                r[k] = rid(r[k])
        if isinstance(r.get("args"), dict):
            r["args"] = {k: (rid(v) if k in ("span_id", "remote_parent")
                             else v) for k, v in r["args"].items()
                         if k not in _TIME_KEYS}
        out.append(r)
    return out


def test_tracer_records_match_jax_ids_and_times_aside():
    def run(t):
        tr = t.Tracer(None)
        _trace_script(tr)
        return tr.records
    jrec, trec = _both(lambda p: run(p.trace))
    assert len(trec) == len(jrec) > 8
    assert _normalize(trec) == _normalize(jrec)
    spans = [r for r in trec if r["type"] == "span"]
    remote = next(r for r in spans if r["name"] == "remote")
    assert remote.get("trace_id", remote.get("args", {}).get(
        "trace_id")) == "t" * 32


def test_summarize_perfetto_and_stitch_match_jax(tmp_path):
    def run(t, tag):
        paths = []
        for i in range(2):
            path = str(tmp_path / f"{tag}_r{i}.jsonl")
            tr = t.Tracer(path, span_prefix=f"r{i}")
            _trace_script(tr)
            tr.close()
            paths.append(path)
        summ = t.summarize_trace(paths[0])
        pf = json.load(open(t.to_perfetto(paths[0],
                                          str(tmp_path / f"{tag}.json"))))
        st = t.stitch_traces(paths, str(tmp_path / f"{tag}_st.json"),
                             labels=["a", "b"])
        stitched = json.load(open(str(tmp_path / f"{tag}_st.json")))
        return summ, pf, st, stitched, t.format_summary(summ)

    def shape(summ):
        return {k: (sorted(v) if isinstance(v, dict) else v)
                for k, v in summ.items()}

    def events(doc):
        evs = doc["traceEvents"] if isinstance(doc, dict) else doc
        return sorted((e.get("ph"), e.get("name"), e.get("cat"))
                      for e in evs)

    (js, jp, jst, jstitched, jfmt), (ts, tp, tst, tstitched, tfmt) = \
        run(jtrace, "j"), run(ttrace, "t")
    assert shape(ts) == shape(js)
    assert {k: v["count"] for k, v in ts["spans"].items()} == \
        {k: v["count"] for k, v in js["spans"].items()}
    assert events(tp) == events(jp)
    assert sorted(tst) == sorted(jst)
    assert events(tstitched) == events(jstitched)
    # the same rows (their order follows measured durations)
    assert sorted(ln.split()[0] for ln in tfmt.splitlines() if ln.strip()) \
        == sorted(ln.split()[0] for ln in jfmt.splitlines() if ln.strip())
    assert len(ttrace.new_trace_id()) == len(jtrace.new_trace_id())


# ------------------------------------------------------------- goodput
def _trainer_registry(m):
    reg = m.MetricsRegistry("g")
    rng = np.random.default_rng(5)
    for name in ("step_wall_ms", "trainer_step_ms", "device_step_ms",
                 "feed_wait_ms", "staging_wait_ms", "reader_wait_ms"):
        h = reg.histogram(name, name)
        scale = {"step_wall_ms": 40.0, "trainer_step_ms": 35.0,
                 "device_step_ms": 30.0}.get(name, 2.0)
        for v in rng.uniform(0.5, 1.5, 12) * scale:
            h.observe(float(v))
    reg.gauge("collective_ms", "c", ("program",)).set(3.0, program="run")
    reg.gauge("dispatch_gap_ms", "d", ("program",)).set(0.2,
                                                        program="run")
    return reg


@pytest.mark.parametrize("empty", [False, True])
def test_trainer_goodput_decompose_matches_jax(empty):
    def run(p):
        reg = (p.metrics.MetricsRegistry("e") if empty
               else _trainer_registry(p.metrics))
        d = p.goodput.decompose(reg)
        return d, p.goodput.format_goodput_table(d)
    (jd, jt), (td, tt) = _both(run)
    assert td == jd and tt == jt


def _ledgers():
    """Retired-request ledgers of the shapes the engine writes: chunked,
    whole, preempted, speculative, and a beam mini-ledger."""
    def led(rid, ttft, parts, events, **kw):
        return dict({"request_id": rid, "prompt_tokens": 20, "tokens": 6,
                     "preempts": 0, "ttft_ms": ttft, "tpot_ms": 2.5,
                     "total_ms": ttft + 15.0, "ttft_parts": parts,
                     "events": events}, **kw)
    steps = [("step", 10.0 + i, 5 + i, 3) for i in range(8)]
    return [
        led(1, 12.0, {"queue": 1.0, "prefill_stall_behind": 2.0,
                      "own_prefill": 9.0, "preempt_redo": 0.0},
            [("submit", 0.0), ("admit", 3.0, 16, 4),
             ("chunk", 3.5, 4, 1.2), ("first_token", 12.0)] + steps
            + [("finish", 27.0)]),
        led(2, 40.0, {"queue": 10.0, "prefill_stall_behind": 5.0,
                      "own_prefill": 5.0, "preempt_redo": 20.0},
            [("submit", 0.0), ("admit", 1.0, 0, 20),
             ("prefill", 1.0, 4.0, 32), ("preempt", 9.0),
             ("admit", 20.0, 0, 20), ("prefill", 20.0, 5.0, 32),
             ("first_token", 40.0), ("spec", 41.0, 3, 2),
             ("finish", 55.0)], preempts=1),
        led(3, 25.0, {"queue": 20.0, "prefill_stall_behind": 0.0,
                      "own_prefill": 5.0, "preempt_redo": 0.0},
            [("submit", 0.0), ("first_token", 25.0), ("finish", 40.0)]),
        {"request_id": 4, "kind": "beam", "prompt_tokens": 9,
         "tokens": 8, "preempts": 0, "ttft_ms": None, "tpot_ms": None,
         "total_ms": 33.0, "events": [("submit", 0.0), ("cow", 2.0, 3),
                                      ("cow", 4.0, 1), ("finish", 33.0)]},
    ]


_SNAPSHOT = {"loop_wall_ms": 1000.0, "turns": 40, "steps": 37,
             "components": {"prefill_stall": 120.0,
                            "chunked_prefill": 80.0,
                            "decode_compute": 500.0,
                            "host_batching": 90.0, "spec_overhead": 60.0,
                            "cow_copy": 5.0, "idle": 100.0},
             "occ_steps": 200, "tot_steps": 296}


@pytest.mark.parametrize("case", ["busy", "idle", "empty", "no_ledgers"])
def test_serving_goodput_matches_jax(case):
    snap = {"busy": _SNAPSHOT,
            "idle": dict(_SNAPSHOT, components=dict(
                _SNAPSHOT["components"], idle=950.0)),
            "empty": {"loop_wall_ms": 0.0, "turns": 0},
            "no_ledgers": _SNAPSHOT}[case]
    leds = None if case == "no_ledgers" else _ledgers()

    def run(p):
        d = p.sg.decompose_serving(snap, ledgers=leds)
        return d, p.sg.format_serving_table(d)
    (jd, jt), (td, tt) = _both(run)
    assert td == jd and tt == jt
    assert tsg.COMPONENTS == jsg.COMPONENTS
    assert tsg.VERDICTS == jsg.VERDICTS


def test_ttft_attribution_and_timelines_match_jax():
    leds = _ledgers()
    assert tsg.ttft_attribution(leds) == jsg.ttft_attribution(leds)
    assert tsg.ttft_attribution([]) == jsg.ttft_attribution([])
    for led in leds:
        for n in (64, 4):
            assert tsg.render_timeline(led, max_events=n) == \
                jsg.render_timeline(led, max_events=n)


# --------------------------------------------------------------- alerts
class _Clock:
    """Stand-in for the ``time`` module inside an alerts module."""

    def __init__(self, t=1000.0):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def _alert_history(p, clock, rules):
    """Drive one registry history through an AlertEngine of ``rules``
    (None: the shipped defaults), the clock advanced between
    evaluations; returns the firing names per evaluation and the final
    status."""
    reg = p.metrics.MetricsRegistry("a")
    ttft = reg.histogram("decode_ttft_ms", "t",
                         buckets=p.metrics.LATENCY_BUCKETS_MS)
    tpot = reg.histogram("decode_tpot_ms", "t",
                         buckets=p.metrics.LATENCY_BUCKETS_MS)
    req = reg.counter("decode_requests_total", "t")
    rej = reg.counter("decode_rejected_total", "t")
    good = reg.gauge("train_goodput", "t")
    bad = reg.counter("nonfinite_grads_total", "t")
    eng = p.alerts.AlertEngine(reg, rules=rules)
    seen = []
    for i in range(30):
        burst = 8 <= i < 16
        for _ in range(40):
            ttft.observe(2000.0 if burst else 40.0)
            tpot.observe(300.0 if burst else 20.0)
        req.inc(40)
        rej.inc(20 if burst else 0)
        good.set(0.05 if 10 <= i < 20 else 0.9)
        if i == 12:
            bad.inc()
        seen.append(sorted(a["alertname"] for a in eng.evaluate()))
        clock.t += 5.0
    st = eng.status()
    return seen, {k: v for k, v in st.items() if k != "state"}


@pytest.mark.parametrize("rules", ["default", "burn_windows"])
def test_alert_firings_match_jax(monkeypatch, rules):
    def run(p):
        clock = _Clock()
        monkeypatch.setattr(p.alerts, "time", clock)
        rs = None
        if rules == "burn_windows":
            rs = tuple(p.alerts.Rule(**{
                **{f: getattr(r, f) for f in r.__dataclass_fields__},
                "fast_window_s": 10.0, "slow_window_s": 40.0})
                for r in p.alerts.DEFAULT_RULES if r.kind == "burn_rate")
        return _alert_history(p, clock, rs)
    (jseen, jst), (tseen, tst) = _both(run)
    assert tseen == jseen
    assert tst == jst
    fired = {n for names in tseen for n in names}
    if rules == "burn_windows":
        assert {"decode_ttft_slo_burn", "decode_tpot_slo_burn",
                "decode_reject_slo_burn"} <= fired
    else:
        assert "nonfinite_grads" in fired


def test_alert_rules_and_validation_match_jax():
    def fields(rules):
        return [{f: getattr(r, f) for f in r.__dataclass_fields__}
                for r in rules]
    assert fields(talerts.DEFAULT_RULES) == fields(jalerts.DEFAULT_RULES)
    assert fields(talerts.FLEET_RULES) == fields(jalerts.FLEET_RULES)
    talerts.validate_rules(talerts.DEFAULT_RULES)
    for kw in (dict(kind="burn_rate", metric="m", q=30.0),
               dict(kind="burn_rate", metric=""),
               dict(kind="nope", metric="m"),
               dict(kind="ratio", metric="m")):
        errs = []
        for p in PKGS.values():
            with pytest.raises(ValueError) as e:
                p.alerts.validate_rules((p.alerts.Rule(name="b", **kw),))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# ------------------------------------------------------------- profiler
def _profile_records():
    """Tracer records of three trainer steps: one single-dispatch, two
    with two dispatches and a gap between them, plus compiles."""
    recs, sid = [], 0
    t = 1_000_000
    for step, n_disp in enumerate((1, 2, 2)):
        sid += 1
        parent = sid
        recs.append({"type": "span", "name": "trainer_step", "sid": parent,
                     "parent": None, "ts_ns": t, "dur_ns": 9_000_000,
                     "args": {"steps": 1}})
        for d in range(n_disp):
            sid += 1
            recs.append({"type": "span", "name": "device_step",
                         "sid": sid, "parent": parent,
                         "ts_ns": t + d * 4_000_000, "dur_ns": 3_000_000,
                         "args": {"kind": "run" if d == 0 else "aux",
                                  "steps": 1, "device_ms": 3.0}})
        t += 10_000_000
    recs.append({"type": "span", "name": "jit_compile", "sid": sid + 1,
                 "parent": None, "ts_ns": 0, "dur_ns": 1,
                 "args": {"program": "run", "compile_ms": 120.5}})
    return recs


@pytest.mark.parametrize("program", [None, "run", "aux", "absent"])
def test_parse_tracer_records_and_join_match_jax(program):
    recs = _profile_records()

    def run(p):
        profs = p.profiler.parse_tracer_records(recs, program=program)
        out = {k: v.to_dict() for k, v in profs.items()}
        joins = {k: p.profiler.measured_vs_modeled(v)
                 for k, v in profs.items()}
        tables = {k: p.profiler.format_measured_table(j)
                  for k, j in joins.items()}
        return out, joins, tables
    assert run(PKGS["torch"]) == run(PKGS["jax"])


def _write_trace(path, events, gz=False):
    data = json.dumps({"traceEvents": events})
    if gz:
        import gzip
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        with open(path, "w") as f:
            f.write(data)


def test_parse_device_trace_matches_jax_on_one_trace(tmp_path):
    """A trace both parsers read as the same device lanes: the JAX
    parser by its device process's name, the port's by the kernel
    category torch.profiler writes."""
    d = tmp_path / "cap"
    d.mkdir()
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "cat": "kernel", "pid": 1, "tid": 1, "ts": 0,
         "dur": 100, "name": "loop_fusion.1"},
        {"ph": "X", "cat": "kernel", "pid": 1, "tid": 1, "ts": 200,
         "dur": 300, "name": "sm90_gemm_bf16"},
        {"ph": "X", "cat": "kernel", "pid": 1, "tid": 2, "ts": 50,
         "dur": 20, "name": "paged_attention_rows_kernel"},
        {"ph": "X", "cat": "user_annotation", "pid": 2, "tid": 9, "ts": 0,
         "dur": 10, "name": "run"},
        {"ph": "X", "cat": "user_annotation", "pid": 2, "tid": 9,
         "ts": 300, "dur": 10, "name": "run 2"},
    ]
    _write_trace(d / "t.trace.json.gz", events, gz=True)
    jp = jprofiler.parse_device_trace(str(d), program="run")
    tp = tprofiler.parse_device_trace(str(d), program="run")
    assert tp.to_dict() == jp.to_dict()
    assert tp.event_counts == {"loop_fusion.1": 1, "sm90_gemm_bf16": 1,
                               "paged_attention_rows_kernel": 1}
    assert tprofiler.measured_vs_modeled(tp) == \
        jprofiler.measured_vs_modeled(jp)
    assert tprofiler.parse_device_trace(str(tmp_path / "none")) is None


def test_parse_device_trace_reads_torch_profiler_categories(tmp_path):
    """torch.profiler's Chrome trace: device work is the kernel /
    memcpy / memset categories; a host region mirrored onto the GPU
    (gpu_user_annotation) is neither work nor a second step."""
    d = tmp_path / "cap"
    d.mkdir()
    k = "paged_attention_rows_kernel"
    events = [
        {"ph": "X", "cat": "user_annotation", "pid": 100, "tid": 1,
         "ts": 0, "dur": 900, "name": "decode_step"},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 0, "dur": 900, "name": "decode_step"},
        {"ph": "X", "cat": "cpu_op", "pid": 100, "tid": 1, "ts": 5,
         "dur": 50, "name": "aten::mm"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 100,
         "dur": 100, "name": k},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 300,
         "dur": 100, "name": k},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 400,
         "dur": 200, "name": "ampere_sgemm_64x64_tn"},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 700,
         "dur": 100, "name": "Memcpy DtoH (Device -> Pinned)"},
    ]
    _write_trace(d / "capture.trace.json", events)
    p = tprofiler.parse_device_trace(str(d), program="decode_step")
    assert p.steps == 1 and p.spans == 4
    assert p.event_counts[k] == 2
    assert p.op_kind_ms == pytest.approx(
        {"other": 0.2, "dot": 0.2, "copy": 0.1})
    # busy 500 us of the 700 us from the first kernel to the last copy
    assert p.device_ms_total == pytest.approx(0.5)
    assert p.idle_frac == pytest.approx(round(1 - 500 / 700, 4))
    _write_trace(d / "capture.trace.json", events[:3])
    assert tprofiler.parse_device_trace(str(d)) is None   # no device work


def test_profiler_session_on_the_cpu(tmp_path):
    tel = TTelemetry(trace_path=None)
    try:
        prof = tel.profiler
        assert tel.profiler is prof and prof.status() == {
            "capturing": False}
        d = prof.start(str(tmp_path / "cap"), window=(1, 3))
        with pytest.raises(RuntimeError, match="cannot nest"):
            prof.start(str(tmp_path / "other"))
        with tprofiler.step_annotation("run", 1):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with tprofiler.trace_annotation("decode_turn"):
            torch.ones(8).sum()
        assert prof.status()["window"] == [1, 3]
        art = prof.stop()
        assert art.endswith(".zip") and zipfile.is_zipfile(art)
        assert "capture.trace.json" in zipfile.ZipFile(art).namelist()
        names = {e.get("name") for e in json.load(open(os.path.join(
            d, "capture.trace.json")))["traceEvents"]}
        assert {"run", "decode_turn"} <= names
        # no card: no device events, so the caller falls back
        assert tprofiler.parse_device_trace(d, program="run") is None
        assert prof.stop() is None
        states = [r["args"]["state"] for r in tel.tracer.records
                  if r.get("type") == "event" and r["name"] == "profiler"]
        assert states == ["capturing", "idle"]
        assert tprofiler.profiler_state_from_trace(
            tel.tracer.records)["artifact"] == art
        path, data = tprofiler.Profiler().capture(10, str(tmp_path / "c2"))
        assert data[:2] == b"PK"
    finally:
        tel.close()


def test_measured_vs_modeled_with_a_report_names_its_item():
    prof = tprofiler.MeasuredProfile(op_kind_ms={"dot": 1.0}, steps=1,
                                     device_ms_total=1.0)
    with pytest.raises(NotImplementedError, match="A item 2"):
        tprofiler.measured_vs_modeled(prof, report=object())


# ------------------------------------------------------------ telemetry
def test_telemetry_metric_names_and_hooks_match_jax(tmp_path):
    def run(p):
        tel = p.Telemetry(trace_path=None, collect_hlo=False)
        tel.record_dispatch("run", steps=2)
        tel.record_cache(hit=False)
        tel.record_cache(hit=True)
        tel.record_compile_cache(hit=True)
        tel.record_megastep(4)
        tel.record_donation(1024, program="run")
        with tel.trainer_step(examples=8, steps=1):
            pass
        tel.observe_feed_wait(1.5)
        tel.observe_staging(0.5, depth=2)
        tel.observe_step_wall(12.0, steps=2)
        tel.record_health(1.25, 0.001, n_bad=0)
        tel.set_examples_per_sec(100.0)
        names = sorted(m.name for m in tel.registry.metrics())
        vals = {n: tel.registry.find(n).snapshot()["series"]
                for n in ("executor_dispatches_total",
                          "executor_steps_total", "jit_compiles_total",
                          "jit_cache_hits_total", "megastep_k",
                          "compile_cache_hits_total", "donated_bytes",
                          "grad_global_norm", "trainer_examples_total")}
        ens = [p.Telemetry.ensure(None), p.Telemetry.ensure(False)]
        with pytest.raises(TypeError):
            p.Telemetry.ensure("yes")
        d = tel.update_goodput()
        tel.close()
        tel.close()                      # idempotent
        return names, vals, ens, sorted(d)
    assert run(PKGS["torch"]) == run(PKGS["jax"])


def test_telemetry_close_status_and_sinks(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tel = TTelemetry(trace_path=path)
    assert TTelemetry.ensure(tel) is tel
    tel.register_status("x", lambda: {"ok": 1})
    tel.register_status("bad", lambda: 1 / 0)
    st = tel.status()
    assert st["x"] == {"ok": 1} and "error" in st["bad"]
    assert st["profiler"] == {"capturing": False}
    assert st["alerts"] == {"firing": []}
    assert tel.health_status()["status"] == "unknown"
    assert "executor_dispatches_total" in tel.prometheus_text()
    assert tel.snapshot() == tel.registry.snapshot()
    tel.close()
    recs = ttrace.read_trace(path)
    assert {r["name"] for r in recs if r["type"] == "metric"} == \
        {m.name for m in tel.registry.metrics()}


@pytest.mark.parametrize("call,item", [
    (lambda tel: TTelemetry(trace_path=None, serve_port=0), "A10"),
    (lambda tel: tel.serve(0), "A10"),
    (lambda tel: tel.record_collectives(""), "A9"),
])
def test_telemetry_deferred_parts_name_their_item(call, item):
    from paddle_tpu_torch.reader import decorator as rdec
    tel = TTelemetry(trace_path=None)
    sink = rdec._OBS_SINK
    try:
        with pytest.raises(NotImplementedError, match=item):
            call(tel)
        assert rdec._OBS_SINK is sink    # a refused session attaches none
    finally:
        tel.close()


def test_step_span_fences_and_sample_memory_on_the_cpu(monkeypatch):
    tel = TTelemetry(trace_path=None, collect_hlo=True)
    with tel.step_span("run", steps=2) as h:
        h["block_on"] = {"out": [torch.ones(3)]}
    (rec,) = [r for r in tel.tracer.records if r["name"] == "device_step"]
    assert rec["args"]["kind"] == "run" and rec["args"]["steps"] == 2
    assert tel.registry.find("device_step_ms").count == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tel.sample_memory() == (None, None)
    tel.close()


def test_device_mfu_from_the_peak_table(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcost.device_peak_flops() == ("cpu", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0, name=name: name)
        assert tcost.device_peak_flops() == (name, peak)
    for args in ((1e12, 10.0, 989e12), (0.0, 10.0, 1e12),
                 (1e12, 0.0, 1e12), (1e12, 10.0, None)):
        assert tcost.mfu(*args) == jmfu(*args)
    tel = TTelemetry(trace_path=None, device_peak_flops=1e12)
    tel.cost_reports["run"] = types.SimpleNamespace(flops_per_step=5e9)
    with tel.step_span("run"):
        pass
    assert 0.0 < tel.registry.find("device_mfu").get(program="run")
    tel.close()


# -------------------------------------------------------- flight recorder
def test_flight_bundles_match_jax(tmp_path):
    def run(p, tag):
        fr = p.Flight(out_dir=str(tmp_path / tag), cooldown_s=0.0,
                      install_signal=False)
        tel = p.Telemetry(trace_path=None, collect_hlo=False, flight=fr)
        with tel.tracer.span("step"):
            pass
        tel.record_health(float("nan"), 0.0, n_bad=2)  # dumps a bundle
        with pytest.raises(ZeroDivisionError):
            with fr.guard("worker"):
                1 / 0
        files = [sorted(os.listdir(b)) for b in fr.dumps]
        reasons = [json.load(open(os.path.join(b, "manifest.json")))
                   ["reason"] for b in fr.dumps]
        st = {k: v for k, v in fr.status().items()
              if k not in ("out_dir", "last_dump", "dumps")}
        st["dumps"] = [os.path.basename(b).split("_", 3)[-1]
                       for b in fr.status()["dumps"]]
        tel.close()
        return files, reasons, st
    assert run(PKGS["torch"], "t") == run(PKGS["jax"], "j")


def test_flight_recorder_chains_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    tel = TTelemetry(trace_path=None)
    fr = TFlight(out_dir="unused", install_signal=True).attach(tel)
    try:
        assert signal.getsignal(signal.SIGTERM) is not prev
    finally:
        fr.detach()
        tel.close()
    assert signal.getsignal(signal.SIGTERM) == prev


# ----------------------------------------------------------- reader sink
def test_reader_sink_observes_buffered_queues_first_session_wins():
    from paddle_tpu_torch.reader import decorator as rdec

    def reader():
        for i in range(20):
            yield np.full((2,), i)

    tel = TTelemetry(trace_path=None)
    other = TTelemetry(trace_path=None)
    try:
        assert tel._owns_reader_sink and not other._owns_reader_sink
        got = [int(x[0]) for x in rdec.buffered(reader, 4)()]
        got2 = [int(x[0]) for x in rdec.shuffle(reader, 5, seed=1)()]
        assert got == list(range(20)) and sorted(got2) == got
        h = tel.registry.find("reader_wait_ms")
        # buffered: 20 items + the end; shuffle: one per refill of 5
        assert h.count == 21 + 4
        depth = tel.registry.find("reader_queue_depth")
        assert {k[0] for k, _ in depth._items()} == {"buffered",
                                                     "shuffle"}
        assert other.registry.find("reader_wait_ms").count == 0
    finally:
        tel.close()
        other.close()
    assert rdec._OBS_SINK is None
    assert rdec.set_obs_sink(lambda *a: None) is True
    assert rdec.set_obs_sink(lambda *a: None) is False
    rdec.set_obs_sink(None)


# -------------------------------------------------------- metric contract
def test_every_port_metric_is_in_a_docs_metric_table():
    code = code_metric_names(os.path.join(REPO, "paddle_tpu_torch"))
    docs = doc_metric_names(os.path.join(REPO, "docs"))
    assert len(code) > 60
    assert sorted(set(code) - set(docs)) == []
    # the decode engine's and the session's names are all there
    for name in ("decode_goodput", "decode_component_ms",
                 "decode_preempted_redo_ms", "alert_evaluations_total",
                 "flight_recorder_dumps_total", "reader_wait_ms"):
        assert name in code
