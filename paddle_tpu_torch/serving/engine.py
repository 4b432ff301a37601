"""ServingEngine — the fixed-shape inference front end: the port of the
JAX package's ``serving/engine.py``.

Wraps a loaded inference program with the three serving mechanisms the
synchronous ``Inferencer`` lacks:

1. **Micro-batching** (batcher.py): concurrent client requests queue
   and flush at ``max_batch`` rows or ``max_wait_ms``, padded up a
   fixed ``BucketLadder`` (bucketing.py), so the set of feed shapes is
   closed and ``warmup()`` runs every rung before traffic.
2. **Pinned weights + frozen fetch** (framework/executor.py
   ``InferSession``): parameters gathered onto the device once at load;
   the session's entries key on the feed signature only.
3. **Overlapped dispatch**: a pad worker assembles flush N+1 on the host
   (numpy) while the dispatch worker's flush N runs on the card. The
   dispatch worker reads each fetch back once per flush (the result
   fence, bfloat16 read as float32 as ``Executor.run`` does) and slices
   the rows of each request from the host arrays.

Observability rides the ``obs`` plane with the JAX engine's metric
names (the contract of the JAX package's ``docs/serving.md``) and spans:
each request gets a root ``serving_request`` span (opened at
``submit``, closed when its rows resolve) with ``serving_queue`` and
``serving_execute`` children parented to it across the worker threads,
and each flush a ``serving_flush`` span, so ``serving_request_ms``
p50/p99 measure submit -> result latency including queue wait.
``serve_port=`` (the live HTTP plane, ``obs/server.py``) is ROADMAP
A10's and raises before any thread starts.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.core.place import Place
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.framework.executor import Executor, _to_numpy
from paddle_tpu_torch.obs.profiler import trace_annotation
from paddle_tpu_torch.serving.batcher import (MicroBatcher, Request,
                                              ServingOverloadError)
from paddle_tpu_torch.serving.bucketing import (BucketLadder,
                                                assemble_batch,
                                                request_rows)

__all__ = ["ServingEngine", "ServingOverloadError"]

_CLOSE = object()          # handoff-queue sentinel


class ServingEngine:
    """Serve one loaded inference program to many concurrent clients.

    Load either from a ``save_inference_model`` directory::

        eng = ServingEngine(model_dir="...", ladder=BucketLadder(8))

    or from an in-memory program (the bench/test path)::

        eng = ServingEngine(program=infer_prog, feed_names=[...],
                            fetch_names=[...], executor=exe)

    ``ladder``: the closed shape set (default: powers of two up to 8;
    LoD feeds REQUIRE declared ``seq_buckets``). ``lens_feeds``:
    {lens_feed_name: lod_feed_name} — true sequence lengths derived from
    each request's LoD ride this feed, so programs built with runtime
    ``SeqLens`` masking stay exact under uniform padding (a request's
    rows equal its rows run alone up to the sum order of the batch's
    shapes).
    ``max_queue``: pending-request bound; past it ``submit`` raises
    ``ServingOverloadError`` (explicit backpressure, never a stall).
    """

    def __init__(self, program=None, feed_names: Optional[Sequence[str]] = None,
                 fetch_names: Optional[Sequence[str]] = None,
                 model_dir: Optional[str] = None,
                 executor: Optional[Executor] = None,
                 scope: Optional[Scope] = None,
                 place: Optional[Place] = None,
                 ladder: Optional[BucketLadder] = None,
                 max_wait_ms: float = 2.0,
                 max_queue: int = 256,
                 lens_feeds: Optional[Dict[str, str]] = None,
                 telemetry=None,
                 serve_port: Optional[int] = None,
                 profile=None,
                 numerics=None,
                 autostart: bool = True):
        if (program is None) == (model_dir is None):
            raise ValueError(
                "pass exactly one of program=(with feed_names/"
                "fetch_names) or model_dir=")
        if serve_port is not None:
            raise NotImplementedError(
                "ServingEngine(serve_port=...) needs the HTTP server "
                "(obs/server.py), not ported yet (ROADMAP A10)")
        from paddle_tpu_torch.obs.metrics import (LATENCY_BUCKETS_MS,
                                                  MetricsRegistry)
        from paddle_tpu_torch.obs.telemetry import Telemetry
        self.telemetry = Telemetry.ensure(telemetry)
        self.executor = executor or Executor(place,
                                             telemetry=self.telemetry)
        self.scope = scope
        if model_dir is not None:
            from paddle_tpu_torch import io
            program, feed_names, fetch_names = io.load_inference_model(
                model_dir, self.executor, scope)
        if not feed_names or not fetch_names:
            raise ValueError("feed_names and fetch_names are required")
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.ladder = ladder or BucketLadder(max_batch=8)
        block_vars = program.global_block().vars
        self.lod_feeds = tuple(
            n for n in self.feed_names
            if getattr(block_vars.get(n), "lod_level", 0))
        missing = [n for n in self.lod_feeds
                   if n not in self.ladder.seq_buckets]
        if missing:
            raise ValueError(
                f"LoD feed(s) {missing} need seq_buckets in the ladder "
                "— without a sequence rung their token axis churns "
                "compile signatures unboundedly")
        self.lens_feeds = dict(lens_feeds or {})
        for lens_name, lod_name in self.lens_feeds.items():
            if lod_name not in self.lod_feeds:
                raise ValueError(
                    f"lens feed {lens_name!r} derives from {lod_name!r} "
                    f"which is not a LoD feed ({list(self.lod_feeds)})")
        # clients feed the data slots; lens feeds are engine-derived
        self.client_feeds = [n for n in self.feed_names
                             if n not in self.lens_feeds]
        # declare the closed shape set on the program, as the JAX engine
        # does for its feed-churn lint
        program.bucket_ladder = self.ladder.describe()
        # ``numerics=``: instrument the serving program with the fused
        # per-tensor stats vec (obs/numerics.py) BEFORE the session
        # pins its fetch set. Unlike training there is one fetch set
        # per rung, so the stat ops run on every flush; the host only
        # FOLDS every ``sample_every``-th flush into the EMA/gauges.
        # The stats fetch rides last and is popped before row-slicing —
        # it is [n_tensors, N_STATS], never batch-major.
        from paddle_tpu_torch.obs.numerics import NumericsMonitor
        self.numerics = NumericsMonitor.ensure(numerics)
        self._numerics_by_rung: Dict[int, Dict[str, float]] = {}
        self._flush_ctr = 0
        session_fetches = list(self.fetch_names)
        if self.numerics is not None:
            v = self.numerics.install(program)
            if v is not None:
                session_fetches.append(v.name)
            if self.telemetry is not None:
                self.telemetry.numerics = self.numerics
        self.session = self.executor.prepare_infer(
            program, fetch_list=session_fetches, scope=scope)

        self.batcher = MicroBatcher(self.ladder.max_batch,
                                    max_wait_ms=max_wait_ms,
                                    max_queue=max_queue)
        # depth 2: pad/stack of flush N+1 proceeds while flush N is on
        # device; a deeper pipeline would only grow tail latency
        self._handoff: "queue.Queue" = queue.Queue(maxsize=2)
        self._threads: List[threading.Thread] = []
        self._started = False
        self._closed = False
        self._warmed = False

        # ---- obs wiring (names are the docs/serving.md contract)
        reg = (self.telemetry.registry if self.telemetry is not None
               else MetricsRegistry("serving"))
        self.registry = reg
        self._requests = reg.counter(
            "serving_requests_total", "requests accepted by submit()")
        self._rejected = reg.counter(
            "serving_rejected_total",
            "requests rejected with ServingOverloadError (backpressure)")
        self._batches = reg.counter(
            "serving_batches_total", "flushes dispatched", ("bucket",))
        self._rows = reg.counter(
            "serving_rows_total", "real rows served")
        self._padded_rows = reg.counter(
            "serving_padded_rows_total",
            "padded rows dispatched (bucket sizes summed)")
        # latency-scaled Prometheus buckets: /metrics dumps _bucket
        # lines a scraper can run histogram_quantile over
        self._request_ms = reg.histogram(
            "serving_request_ms",
            "request latency, submit() to result rows ready",
            buckets=LATENCY_BUCKETS_MS)
        self._batch_ms = reg.histogram(
            "serving_batch_ms", "per-flush dispatch+fence wall ms",
            buckets=LATENCY_BUCKETS_MS)
        # queue wait per request, observed when its flush pops — the
        # admission-latency lane the decode engine ALSO feeds (at slot
        # admission), so continuous batching and the fixed-shape path
        # are compared on the same histogram
        self._queue_age_ms = reg.histogram(
            "serving_queue_age_ms",
            "queue wait per request at flush/admission (shared with "
            "the decode path for honest comparison)",
            buckets=LATENCY_BUCKETS_MS)
        self._queue_depth = reg.gauge(
            "serving_queue_depth", "pending requests in the micro-batch "
            "queue")
        self._occupancy = reg.gauge(
            "serving_batch_occupancy",
            "last flush's real rows / bucket rows")
        # flush-loop lifecycle ledger: a bounded ring of retired
        # request records (submit -> execute -> finish) the /requestz
        # endpoint serves alongside the decode engine's richer ledgers
        from collections import deque as _deque
        self._retired: "_deque" = _deque(maxlen=256)
        self._retire_seq = 0
        if self.telemetry is not None:
            self.telemetry.register_status("serving", self.stats)
            reg_req = getattr(self.telemetry, "register_requests", None)
            if reg_req is not None:
                reg_req("serving", self.requestz)
        # profile=: capture a device trace over the engine's lifetime —
        # True = temp dir, str = capture dir; starts with the workers,
        # stops (and packs the zip artifact) on close()
        self._profiler = None
        self._profile_dir = None
        if profile:
            if self.telemetry is not None:
                self._profiler = self.telemetry.profiler
            else:
                from paddle_tpu_torch.obs.profiler import Profiler
                self._profiler = Profiler()
            self._profile_dir = profile if isinstance(profile, str) \
                else None
        if autostart:
            self.start()

    # ------------------------------------------------------------ warmup
    def warmup(self) -> int:
        """Run every ladder rung once with dummy traffic (zeros, lens
        at the rung), so every signature, and every kernel plan of its
        shapes, exists before the first client request. Returns the
        session's signature count (== ladder.size on a fresh engine).
        Raises if a fetch is not batch-major."""
        from paddle_tpu_torch.core.lod import LoD, LoDTensor
        block_vars = self.program.global_block().vars
        for bucket, seq_rungs in self.ladder.signatures():
            feed: Dict[str, object] = {}
            for name in self.feed_names:
                var = block_vars.get(name)
                if var is None or var.shape is None:
                    raise ValueError(
                        f"warmup: feed {name!r} has no static shape in "
                        "the program; cannot synthesize a dummy batch")
                dtype = (np.dtype(dtype_name(var.dtype)) if var.dtype
                         else np.float32)
                feat = tuple(int(d) for d in var.shape[1:])
                if any(d < 0 for d in feat):
                    raise ValueError(
                        f"warmup: feed {name!r} has dynamic non-batch "
                        f"dims {var.shape}; declare them statically")
                if name in self.lod_feeds:
                    rung = seq_rungs[name]
                    arr = np.zeros((bucket * rung,) + feat, dtype)
                    feed[name] = LoDTensor(
                        arr, LoD.from_lengths([[rung] * bucket]))
                elif name in self.lens_feeds:
                    feed[name] = np.full((bucket,),
                                         seq_rungs[self.lens_feeds[name]],
                                         np.int32)
                else:
                    feed[name] = np.zeros((bucket,) + feat, dtype)
            outs = self.session.run(feed)
            for n, o in zip(self.fetch_names, outs):
                lead = o.shape[0] if o.dim() else 0
                if lead != bucket:
                    raise NotImplementedError(
                        f"fetch {n!r} is not batch-major (leading dim "
                        f"{lead} != bucket {bucket}); the serving path "
                        "cannot split its rows per request")
        self._warmed = True
        return self.session.compiles

    @property
    def compile_count(self) -> int:
        return self.session.compiles

    # ----------------------------------------------------------- serving
    def start(self):
        if self._started:
            return
        self._started = True
        if self._profiler is not None and not self._profiler.capturing:
            try:
                self._profiler.start(self._profile_dir)
            except RuntimeError:
                pass   # another capture owns the device trace
        pad = threading.Thread(target=self._pad_worker,
                               name="serving-pad", daemon=True)
        disp = threading.Thread(target=self._dispatch_worker,
                                name="serving-dispatch", daemon=True)
        self._threads = [pad, disp]
        pad.start()
        disp.start()

    def submit(self, feed: Dict[str, object],
               trace_context: Optional[dict] = None):
        """Queue one request (rows = its leading batch axis); returns a
        ``concurrent.futures.Future`` resolving to this request's own
        output rows (one np array per fetch). Raises
        ``ServingOverloadError`` past ``max_queue`` pending requests.
        ``trace_context`` is an inherited cross-process wire context —
        see ``DecodeEngine.submit``."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if not self._started:
            self.start()
        missing = [n for n in self.client_feeds if n not in feed]
        if missing:
            raise KeyError(f"missing feed slot(s) {missing}; "
                           f"model expects {self.client_feeds}")
        feed = {n: feed[n] for n in self.client_feeds}
        rows = request_rows(feed, self.lod_feeds)
        req = Request(feed, rows)
        tel = self.telemetry
        if tel is not None:
            # root of this request's trace: closed by the dispatch
            # worker when the rows resolve, so its duration IS the
            # submit→result latency serving_request_ms records
            req.span_sid = tel.tracer.start_span(
                "serving_request", request_id=req.request_id, rows=rows,
                ctx=trace_context)
        try:
            self.batcher.submit(req)
        except ServingOverloadError:
            self._rejected.inc()
            if tel is not None:
                tel.tracer.end_span(req.span_sid, rejected=True)
            raise
        self._requests.inc()
        self._queue_depth.set(self.batcher.depth)
        return req.future

    def infer(self, feed: Dict[str, object],
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous convenience wrapper: submit + wait."""
        return self.submit(feed).result(timeout=timeout)

    # ----------------------------------------------------------- workers
    def _pad_worker(self):
        fl = self.telemetry.flight if self.telemetry is not None else None
        if fl is not None:
            # an unhandled pad-worker death is exactly the postmortem
            # the flight recorder exists for
            with fl.guard("serving_pad"):
                self._pad_loop()
        else:
            self._pad_loop()

    def _pad_loop(self):
        import time as _time
        tel = self.telemetry
        while True:
            reqs = self.batcher.next_batch()
            if reqs is None:
                self._handoff.put(_CLOSE)
                return
            self._queue_depth.set(self.batcher.depth)
            t_pop = _time.monotonic_ns()
            for r in reqs:
                self._queue_age_ms.observe((t_pop - r.t_ns) / 1e6)
            if tel is not None:
                # queue-wait child spans: enqueue stamp → this pop,
                # parented under each request's root span (batched —
                # one tracer lock round-trip per flush, not per request)
                tel.tracer.emit_spans(
                    ("serving_queue", r.t_ns, t_pop - r.t_ns,
                     r.span_sid, {"request_id": r.request_id})
                    for r in reqs)
            try:
                padded = assemble_batch(reqs, self.ladder,
                                        self.lod_feeds, self.lens_feeds)
            except Exception as exc:    # bad request(s): fail the flush
                for r in reqs:
                    if tel is not None:
                        tel.tracer.end_span(r.span_sid,
                                            error=repr(exc))
                    if not r.future.done():
                        r.future.set_exception(exc)
                continue
            self._handoff.put((reqs, padded))

    def _dispatch_worker(self):
        fl = self.telemetry.flight if self.telemetry is not None else None
        if fl is not None:
            with fl.guard("serving_dispatch"):
                self._dispatch_loop()
        else:
            self._dispatch_loop()

    def _dispatch_loop(self):
        import time as _time
        tel = self.telemetry
        device = self.executor._device
        if device.type == "cuda":
            # the current device is per thread
            torch.cuda.set_device(device)
        while True:
            item = self._handoff.get()
            if item is _CLOSE:
                return
            reqs, padded = item
            t0 = _time.perf_counter()
            t0_ns = _time.monotonic_ns()
            try:
                if tel is not None:
                    with tel.tracer.span(
                            "serving_flush", bucket=padded.bucket,
                            rows=padded.rows, requests=len(reqs),
                            request_ids=[r.request_id
                                         for r in reqs]) as args, \
                            trace_annotation("serving_flush"):
                        outs = self.session.run(padded.feed)
                        outs = [_to_numpy(o) for o in outs]   # fence
                        args["occupancy"] = round(padded.occupancy, 3)
                else:
                    outs = [_to_numpy(o)
                            for o in self.session.run(padded.feed)]
            except Exception as exc:
                for r in reqs:
                    if tel is not None:
                        tel.tracer.end_span(r.span_sid, error=repr(exc))
                    if not r.future.done():
                        r.future.set_exception(exc)
                continue
            if (self.numerics is not None
                    and len(outs) > len(self.fetch_names)):
                stats_vec, outs = outs[-1], outs[:-1]
                self._flush_ctr += 1
                n = max(1, int(self.numerics.spec.sample_every))
                if self._flush_ctr % n == 1 or n == 1:
                    try:
                        self.numerics.update(stats_vec, telemetry=tel,
                                             step=self._flush_ctr)
                        # per-rung absmax snapshot: a padded rung that
                        # saturates shows up HERE, keyed by its bucket
                        self._numerics_by_rung[padded.bucket] = {
                            v: float(lanes.get("absmax", 0.0))
                            for v, lanes in self.numerics.last.items()}
                    except Exception:
                        pass
            ms = (_time.perf_counter() - t0) * 1e3
            dur_ns = _time.monotonic_ns() - t0_ns
            self._batch_ms.observe(ms)
            self._batches.inc(1, bucket=str(padded.bucket))
            self._rows.inc(padded.rows)
            self._padded_rows.inc(padded.bucket)
            self._occupancy.set(round(padded.occupancy, 4))
            now = _time.perf_counter()
            if tel is not None:
                # device-execute children (shared flush window) then
                # the root span closes = submit→result latency; both
                # batched so the whole flush costs two tracer lock
                # round-trips, independent of batch size
                tel.tracer.emit_spans(
                    ("serving_execute", t0_ns, dur_ns, r.span_sid,
                     {"request_id": r.request_id,
                      "bucket": padded.bucket})
                    for r in reqs)
                tel.tracer.end_spans(
                    (r.span_sid,
                     {"bucket": padded.bucket,
                      "request_ms": round(
                          (now - r.t_enqueue) * 1e3, 3)})
                    for r in reqs)
            for r, (lo, hi) in zip(reqs, padded.row_slices):
                req_ms = (now - r.t_enqueue) * 1e3
                self._request_ms.observe(req_ms)
                if not r.future.done():
                    r.future.set_result([o[lo:hi] for o in outs])
                exec_rel = (t0 - r.t_enqueue) * 1e3
                self._retired.append({
                    "request_id": r.request_id, "kind": "flush",
                    "rows": r.rows, "bucket": padded.bucket,
                    "total_ms": round(req_ms, 4),
                    "events": [
                        ("submit", 0.0),
                        ("execute", round(exec_rel, 3), round(ms, 3),
                         padded.bucket),
                        ("finish", round(req_ms, 3)),
                    ],
                })
                self._retire_seq += 1
            if tel is not None:
                # detector tick per flush: the serving p99 rule must
                # evaluate even when no trainer loop is stepping
                try:
                    tel.alerts.evaluate()
                except Exception:
                    pass

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Point-in-time serving summary (the bench row's raw source).
        ``queue_depth_by_rung`` maps each ladder batch rung to the
        pending requests that would pad up to it — the same schema the
        decode engine's ``stats()`` reports for its prompt rungs, so
        one dashboard reads both."""
        served = self._rows.value
        padded = self._padded_rows.value
        by_rung: Dict[str, int] = {}
        for rows in self.batcher.pending_rows_snapshot():
            rung = str(self.ladder.bucket_batch(rows))
            by_rung[rung] = by_rung.get(rung, 0) + 1
        return {
            "requests_total": self._requests.value,
            "rejected_total": self._rejected.value,
            "rows_total": served,
            "batches_total": self._batches.value,
            "mean_batch_occupancy": (round(served / padded, 4)
                                     if padded else None),
            "request_ms_p50": self._request_ms.percentile(50),
            "request_ms_p99": self._request_ms.percentile(99),
            "batch_ms_p50": self._batch_ms.percentile(50),
            "queue_depth": self.batcher.depth,
            "queue_depth_by_rung": by_rung,
            "compile_count": self.session.compiles,
            "fresh_compiles": self.session.fresh_compiles,
            "compile_cache_loads": self.session.cache_loads,
            "bucket_ladder": self.ladder.describe(),
            "warmed": self._warmed,
            "profiler": (self._profiler.status()
                         if self._profiler is not None else None),
            "numerics": (dict(self.numerics.status(),
                              rungs={str(b): snap for b, snap in
                                     self._numerics_by_rung.items()})
                         if self.numerics is not None else None),
        }

    def requestz(self, n: int = 20, order: str = "slowest",
                 preempts: bool = False) -> dict:
        """The fixed-shape path's ``/requestz`` rows: last-N retired
        flush requests with rendered timelines. The fixed-shape path
        never preempts, so ``preempts=True`` filters to nothing."""
        from paddle_tpu_torch.obs.servegoodput import render_timeline
        leds = [] if preempts else list(self._retired)
        if order == "slowest":
            leds.sort(key=lambda led: led.get("total_ms") or 0.0,
                      reverse=True)
        else:
            leds = leds[::-1]
        leds = leds[:max(0, int(n))]
        return {
            "retired_total": self._retire_seq,
            "ring": len(self._retired),
            "ring_capacity": self._retired.maxlen,
            "order": order,
            "preempts_only": bool(preempts),
            "requests": [dict(led, timeline=render_timeline(led))
                         for led in leds],
        }

    # ------------------------------------------------------------- close
    def close(self, timeout: float = 10.0):
        """Drain pending requests, stop the workers. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.batcher.close()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []
        if self._profiler is not None and self._profiler.capturing:
            self._profiler.stop()
        if self.numerics is not None:
            try:
                self.numerics.save_calibration()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
