"""Telemetry session — the object the hot paths consult.

The port of the JAX package's ``obs/telemetry.py``. One ``Telemetry``
owns a ``MetricsRegistry`` and a ``Tracer`` and exposes the handful of
hooks the engines call. Every hook site in the hot path is guarded by a
single ``if tel is not None``, which is how the plane stays zero-cost
off. The decode engine takes one (``DecodeEngine(telemetry=)``), as do
the Executor (``Executor(telemetry=)``: dispatches, the entry cache,
compile and fenced step spans, the cost report) and the Trainer
(``Trainer.train(telemetry=)``: trainer steps, feed waits, passes,
health, the numerics observatory).

What the wiring records (names are the registry contract, see
docs/observability.md):

  executor_dispatches_total{kind=run|run_multi}   device dispatches
  executor_steps_total                            train steps (K counted)
  jit_cache_hits_total / jit_compiles_total       entry-cache behavior
  jit_compile_ms                                  histogram, per compile
  device_step_ms                                  histogram, fenced on
                                                  the card's stream
  trainer_step_ms / trainer_examples_total        Trainer loop
  trainer_examples_per_sec                        gauge, rolling per pass
  collective_bytes_total{kind=...}                per-device payload bytes
  collective_ops_total{kind=...}                  per compiled program
  live_buffer_bytes / live_buffer_count           CUDA caching-allocator
                                                  gauges
  feed_wait_ms / staging_wait_ms / step_wall_ms   goodput attribution
  collective_ms{program} / train_goodput          (obs/goodput.py)
  goodput_component_ms{component}
  ALERTS{alertname} / alert_evaluations_total     alert engine
                                                  (obs/alerts.py)
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.obs.profiler import trace_annotation
from paddle_tpu_torch.obs.trace import Tracer

__all__ = ["Telemetry"]


class Telemetry:
    """Metrics + trace session. ``trace_path=None`` keeps the trace in
    memory (``tracer.records``); pass a path to stream trace.jsonl.

    ``collect_hlo`` is accepted for the JAX signature and has no
    effect: the port compiles no HLO to harvest collectives from.
    ``serve_port`` (the HTTP introspection server, ``obs/server.py``)
    raises, naming ROADMAP A10; ``flight`` is a ``FlightRecorder``, True
    for a default one, or None.
    """

    def __init__(self, trace_path: Optional[str] = "trace.jsonl",
                 registry: Optional[MetricsRegistry] = None,
                 collect_hlo: bool = True,
                 device_peak_flops: Optional[float] = None,
                 serve_port: Optional[int] = None,
                 flight=None,
                 span_prefix: Optional[str] = None):
        if serve_port is not None:
            raise _not_ported("Telemetry(serve_port=) (the HTTP server, "
                              "obs/server.py)", "A10")
        self.registry = registry or MetricsRegistry()
        # span_prefix namespaces this session's span ids ("r0:17") so
        # a fleet stitcher can merge N replicas' traces without aliasing
        self.tracer = Tracer(trace_path, span_prefix=span_prefix)
        # fleet federation provider (FleetFederation.status) — serves
        # /fleetz when a front end registers one
        self.fleet = None
        self.collect_hlo = bool(collect_hlo)
        self._closed = False
        # live-plane state: /statusz providers, the last health verdict
        # (/healthz), compiled-program fingerprints (flight bundles)
        self._status_providers: dict = {}
        # /requestz providers: name -> requestz(n=, order=, preempts=)
        # callable (DecodeEngine, ServingEngine lifecycle ledgers)
        self._request_providers: dict = {}
        self.last_health: Optional[dict] = None
        self.program_fingerprints: dict = {}
        self.server = None
        # chip peak dense bf16 FLOP/s for device_mfu; None = detect
        # lazily from obs.costreport on first cost-reported step
        self._peak_flops = device_peak_flops
        self._peak_probed = device_peak_flops is not None
        self.cost_reports: dict = {}   # program kind -> CostReport
        r = self.registry
        self._dispatches = r.counter(
            "executor_dispatches_total", "device dispatches", ("kind",))
        self._steps = r.counter(
            "executor_steps_total", "train steps executed (K-step counted)")
        self._cache_hits = r.counter(
            "jit_cache_hits_total", "executor entry-cache hits")
        self._compiles = r.counter(
            "jit_compiles_total", "executor entry compiles (trace+XLA)")
        self._cc_hits = r.counter(
            "compile_cache_hits_total",
            "persistent compile-cache loads (an entry deserialized "
            "instead of built fresh)")
        self._cc_misses = r.counter(
            "compile_cache_misses_total",
            "persistent compile-cache consultations that fell through "
            "to a fresh trace (store enabled, entry absent)")
        self._megastep_k = r.gauge(
            "megastep_k",
            "K of the last fused K-step dispatch (run_multi)")
        self._compile_ms = r.histogram(
            "jit_compile_ms", "trace+compile+first-dispatch wall ms")
        self._device_ms = r.histogram(
            "device_step_ms", "fenced per-step device+dispatch ms")
        self._trainer_ms = r.histogram(
            "trainer_step_ms", "Trainer per-step wall ms (host incl.)")
        self._examples = r.counter(
            "trainer_examples_total", "examples consumed by Trainer.train")
        self._eps = r.gauge(
            "trainer_examples_per_sec", "rolling examples/sec per pass")
        self._coll_bytes = r.counter(
            "collective_bytes_total",
            "per-device collective payload bytes per compiled program",
            ("kind",))
        self._coll_ops = r.counter(
            "collective_ops_total", "collective ops per compiled program",
            ("kind",))
        self._mem_bytes = r.gauge(
            "live_buffer_bytes",
            "bytes the CUDA caching allocator holds for live tensors")
        self._mem_count = r.gauge(
            "live_buffer_count",
            "live allocations of the CUDA caching allocator")
        self._analysis_warnings = r.counter(
            "analysis_warnings_total",
            "program-verifier warnings by defect class "
            "(Executor validate=True)", ("code",))
        # ---- execution-plan plane (analysis/plan.py)
        self._dispatches_per_step = r.gauge(
            "dispatches_per_step",
            "device dispatches issued per trainer step (1 = fully "
            "planned/fused step)")
        self._donated_bytes = r.gauge(
            "donated_bytes",
            "state bytes aliased input->output per dispatch "
            "(buffer donation)", ("program",))
        # ---- cost plane (obs/costreport.py; per device, per step)
        self._prog_flops = r.gauge(
            "program_flops", "best-estimate FLOPs per train step",
            ("program",))
        self._prog_flops_xla = r.gauge(
            "program_xla_flops",
            "raw XLA cost_analysis FLOPs per compiled entry (while "
            "bodies counted once, custom calls zero)", ("program",))
        self._prog_bytes = r.gauge(
            "program_bytes_accessed", "XLA cost_analysis bytes accessed",
            ("program",))
        self._prog_peak_hbm = r.gauge(
            "program_peak_hbm_bytes",
            "argument+output+temp HBM bytes of the compiled entry",
            ("program",))
        self._prog_arg_hbm = r.gauge(
            "program_argument_hbm_bytes", "argument HBM bytes",
            ("program",))
        self._prog_out_hbm = r.gauge(
            "program_output_hbm_bytes", "output HBM bytes", ("program",))
        self._prog_temp_hbm = r.gauge(
            "program_temp_hbm_bytes", "temp (scratch) HBM bytes",
            ("program",))
        self._device_mfu = r.gauge(
            "device_mfu",
            "cost-report flops/step / fenced device_step_ms / chip peak",
            ("program",))
        # ---- measured-profile plane (obs/profiler.py join)
        self._profiler = None
        self._measured_mfu = r.gauge(
            "measured_mfu",
            "cost-report flops/step over *measured* device ms/step "
            "over chip peak (profiler measured-vs-modeled join)",
            ("program",))
        self._model_agreement = r.gauge(
            "model_agreement_ratio",
            "overlap of measured per-op-kind time shares and modeled "
            "flop shares (1.0 = model and silicon agree)", ("program",))
        self._dispatch_gap = r.gauge(
            "dispatch_gap_ms",
            "mean device-idle ms between dispatches inside one trainer "
            "step (0 = single fused dispatch)", ("program",))
        # ---- health plane (obs/health.py)
        self._grad_norm = r.gauge(
            "grad_global_norm", "global gradient norm, last step")
        self._update_ratio = r.gauge(
            "update_ratio", "lr*grad_norm/param_norm, last step")
        self._nonfinite = r.counter(
            "nonfinite_grads_total", "steps with non-finite gradients")
        # ---- goodput plane (obs/goodput.py attribution inputs)
        self._feed_wait = r.histogram(
            "feed_wait_ms",
            "trainer loop blocking on the next feed (input wait)")
        self._staging_wait = r.histogram(
            "staging_wait_ms",
            "megastep consumer blocking on the staging queue")
        self._staging_depth = r.gauge(
            "staging_queue_depth",
            "megastep staging-queue occupancy sampled at each get")
        self._step_wall = r.histogram(
            "step_wall_ms",
            "full trainer-loop iteration wall ms per step (feed pull + "
            "step body) — the independent clock the goodput "
            "decomposition reconciles against")
        self._collective_ms_g = r.gauge(
            "collective_ms",
            "modeled per-step collective time: the ring cost model "
            "(parallel/scaling.py) over the program's collectives",
            ("program",))
        self._coll_wire_g = r.gauge(
            "collective_bytes_wire",
            "per-device per-step ring-model wire bytes at the "
            "collectives' payload dtypes (compressed collectives bill "
            "1 B/elem)",
            ("program",))
        self._coll_raw_g = r.gauge(
            "collective_bytes_raw",
            "the same collectives re-billed at fp32 width — wire/raw "
            "is the measured compression of the collective plane",
            ("program",))
        self._goodput = r.gauge(
            "train_goodput",
            "productive device compute ms / step wall ms")
        self._goodput_component = r.gauge(
            "goodput_component_ms",
            "per-step ms attributed to each step-time component "
            "(input_wait/staging_wait/dispatch/collective/compute)",
            ("component",))
        # reader-pipeline detail metrics land through the decorator
        # sink (obs/goodput.py attach_reader_sink); first session wins
        from paddle_tpu_torch.obs import goodput as _goodput_mod
        self._owns_reader_sink = _goodput_mod.attach_reader_sink(self)
        # the flight recorder attaches LAST so the recorder's
        # listener and counter see a fully built registry
        from paddle_tpu_torch.obs.flightrecorder import FlightRecorder
        self.flight = FlightRecorder.ensure(flight, self)
        # alert engine AFTER the recorder: firing rules dump bundles,
        # and the recorder embeds the firing set in every bundle
        from paddle_tpu_torch.obs.alerts import AlertEngine
        self.alerts = AlertEngine(r, telemetry=self)
        if self.flight is not None:
            self.flight.alerts_provider = self.alerts.active
            self.flight.ledgers_provider = self._slowest_ledgers
        # numerics observatory (obs/numerics.py) — installed by the
        # component that instruments its program (the Trainer), so
        # uninstrumented sessions pay nothing
        self.numerics = None

    # ----------------------------------------------------- live plane
    def serve(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """The HTTP introspection server (``/metrics``, ``/statusz``, ...)
        is ``obs/server.py``, not ported yet: raises naming ROADMAP
        A10."""
        raise _not_ported("Telemetry.serve (the HTTP server, "
                          "obs/server.py)", "A10")

    @property
    def profiler(self):
        """The session's capture manager (obs/profiler.py), created on
        first use so sessions that never profile pay nothing."""
        if self._profiler is None:
            from paddle_tpu_torch.obs.profiler import Profiler
            self._profiler = Profiler(telemetry=self)
        return self._profiler

    def register_status(self, name: str, provider):
        """Register a ``() -> dict`` callable whose result appears
        under ``name`` in ``/statusz`` (Trainer, ServingEngine, plan
        summaries). Re-registering a name replaces it."""
        self._status_providers[name] = provider

    def register_fleet(self, federation):
        """Attach a ``FleetFederation`` so ``/fleetz`` serves its view
        (each request is also a federation refresh tick)."""
        self.fleet = federation

    def register_requests(self, name: str, provider):
        """Register a lifecycle-ledger provider — a ``requestz(n=,
        order=, preempts=)`` callable (DecodeEngine / ServingEngine) —
        served under ``name`` at ``/requestz`` and tapped for the
        slowest-request ledgers embedded in flight bundles.
        Re-registering a name replaces it."""
        self._request_providers[name] = provider

    def _slowest_ledgers(self, n: int = 8) -> list:
        """The slowest retired-request ledgers across every registered
        provider (flight-bundle ``ledgers.json``); each entry is the
        ledger dict plus the provider name under ``source``."""
        out = []
        for name, provider in list(self._request_providers.items()):
            try:
                payload = provider(n=n, order="slowest")
            except Exception:
                continue
            for led in payload.get("requests", []):
                entry = dict(led)
                entry["source"] = name
                out.append(entry)
        out.sort(key=lambda d: float(d.get("ttft_ms")
                                     or d.get("total_ms") or 0.0),
                 reverse=True)
        return out[:n]

    def health_status(self) -> dict:
        """The ``/healthz`` payload: last in-graph health verdict plus
        staleness. ``unknown`` until the first health fetch; ``tripped``
        while the most recent step saw nonfinite grads."""
        lh = self.last_health
        if lh is None:
            return {"status": "unknown",
                    "nonfinite_total": self._nonfinite.value}
        return {
            "status": "tripped" if lh["n_bad"] else "ok",
            "grad_norm": lh["grad_norm"],
            "update_ratio": lh["update_ratio"],
            "n_bad": lh["n_bad"],
            "nonfinite_total": self._nonfinite.value,
            "age_s": round(time.monotonic() - lh["t_mono"], 3),
        }

    def status(self) -> dict:
        """The ``/statusz`` payload: health, the executor's cache and
        dispatch gauges, program fingerprints, then every registered
        component provider (errors surface as rows, never raise)."""
        out = {
            "health": self.health_status(),
            "executor": {
                "dispatches": {",".join(k) if k else "": c.value
                               for k, c in self._dispatches._items()},
                "steps": self._steps.value,
                "jit_cache_hits": self._cache_hits.value,
                "jit_compiles": self._compiles.value,
                "compile_cache_hits": self._cc_hits.value,
                "dispatches_per_step": self._dispatches_per_step.get()
                if self._dispatches_per_step._items() else None,
            },
            "program_fingerprints": dict(self.program_fingerprints),
            "profiler": (self._profiler.status()
                         if self._profiler is not None
                         else {"capturing": False}),
        }
        if self.flight is not None:
            out["flight_recorder"] = self.flight.status()
        # attribution + failure-detector rows: the decomposition with
        # its verdict, and whatever rules are currently firing
        try:
            d = self.update_goodput()
            if d["steps"]:
                out["goodput"] = d
        except Exception as e:
            out["goodput"] = {"error": repr(e)}
        out["alerts"] = {"firing": [a["alertname"]
                                    for a in self.alerts.active()]}
        for name, provider in list(self._status_providers.items()):
            try:
                out[name] = provider()
            except Exception as e:
                out[name] = {"error": repr(e)}
        return out

    def record_program_fingerprint(self, program: str, fingerprint):
        """Compiled-program identity for the flight bundle/statusz —
        which graph was actually running when the job died."""
        self.program_fingerprints[program or "run"] = fingerprint

    # --------------------------------------------------------- factory
    @staticmethod
    def ensure(value) -> Optional["Telemetry"]:
        """Normalise a user-facing ``telemetry=`` argument: None/False →
        off, True → a fresh default session (trace.jsonl in cwd), a
        Telemetry instance passes through."""
        if value is None or value is False:
            return None
        if value is True:
            return Telemetry()
        if isinstance(value, Telemetry):
            return value
        raise TypeError(
            f"telemetry= expects bool/None/Telemetry, got {type(value)!r}")

    # -------------------------------------------------- executor hooks
    def record_dispatch(self, kind: str, steps: int = 1):
        self._dispatches.inc(1, kind=kind)
        self._steps.inc(steps)

    def record_cache(self, hit: bool):
        (self._cache_hits if hit else self._compiles).inc()

    def record_compile_cache(self, hit: bool):
        """Persistent-store consultation outcome: a hit is a
        deserialized entry (no trace, no jit_compiles_total tick), a
        miss fell through to the fresh-compile path."""
        (self._cc_hits if hit else self._cc_misses).inc()

    def record_megastep(self, k: int):
        self._megastep_k.set(float(k))

    def record_donation(self, nbytes: int, program: str = ""):
        self._donated_bytes.set(float(nbytes), program=program)

    def record_analysis(self, report):
        """Count a DiagnosticReport's warnings by defect class — the
        route verifier warnings take when the Executor validates."""
        for d in report.warnings():
            self._analysis_warnings.inc(1, code=d.code)

    @contextlib.contextmanager
    def compile_span(self, key: str):
        """Wraps a fresh entry's FIRST dispatch — where its build
        happens, so its wall time is the honest compile cost (the
        steady-state dispatch is separately visible in
        device_step_ms)."""
        t0 = time.perf_counter()
        with self.tracer.span("jit_compile", program=key) as args:
            yield
            ms = (time.perf_counter() - t0) * 1e3
            args["compile_ms"] = round(ms, 3)
        self._compile_ms.observe(ms)

    @contextlib.contextmanager
    def step_span(self, kind: str, steps: int = 1):
        """Fenced dispatch timing: the caller assigns the result tensors
        to ``holder["block_on"]`` before the span exits; where one lies
        on a card, we synchronize that card's current stream so the
        measured time covers device execution, not just the enqueue."""
        holder = {}
        t0 = time.perf_counter()
        with self.tracer.span("device_step", kind=kind,
                              steps=steps) as args:
            yield holder
            _fence(holder.get("block_on"))
            ms = (time.perf_counter() - t0) * 1e3
            args["device_ms"] = round(ms, 3)
        step_ms = ms / max(1, steps)
        self._device_ms.observe(step_ms)
        self._update_device_mfu(kind, step_ms)

    def _update_device_mfu(self, kind: str, step_ms: float):
        """device_mfu{program}: the cost report's per-step flops over
        this fenced step time and the chip's peak — the framework-owned
        cross-check for bench.py's hand-derived MFU."""
        rep = self.cost_reports.get(kind)
        if rep is None:
            return
        from paddle_tpu_torch.obs.costreport import device_peak_flops, mfu
        if not self._peak_probed:
            self._peak_probed = True
            _, self._peak_flops = device_peak_flops()
        v = mfu(rep.flops_per_step, step_ms, self._peak_flops)
        if v is not None:
            self._device_mfu.set(round(v, 4), program=kind)

    def record_cost_report(self, report):
        """Publish one compiled entry's CostReport: labeled gauges, a
        trace event, and per-op-kind Perfetto counter tracks."""
        p = report.program or ""
        self.cost_reports[p] = report
        self._prog_flops.set(report.flops_per_step, program=p)
        self._prog_flops_xla.set(report.flops_xla, program=p)
        self._prog_bytes.set(report.bytes_accessed, program=p)
        self._prog_peak_hbm.set(report.peak_hbm_bytes, program=p)
        self._prog_arg_hbm.set(report.argument_bytes, program=p)
        self._prog_out_hbm.set(report.output_bytes, program=p)
        self._prog_temp_hbm.set(report.temp_bytes, program=p)
        self.tracer.event("cost_report", program=p,
                          flops_per_step=report.flops_per_step,
                          flops_xla=report.flops_xla,
                          flops_hlo=report.flops_hlo,
                          flops_kernel=report.flops_kernel,
                          bytes_accessed=report.bytes_accessed,
                          peak_hbm_bytes=report.peak_hbm_bytes)
        if report.op_kinds:
            self.tracer.counter(
                f"op_kind_flops/{p or 'run'}",
                {k: round(v.get("flops", 0.0), 1)
                 for k, v in report.op_kinds.items()})
            self.tracer.counter(
                f"op_kind_bytes/{p or 'run'}",
                {k: round(v.get("bytes", 0.0), 1)
                 for k, v in report.op_kinds.items()})

    def record_measured_profile(self, join: dict):
        """Publish one measured-vs-modeled join (obs/profiler.py):
        the three measured gauges plus a trace event carrying the
        compact join so offline ``cli stats`` sees it too."""
        p = join.get("program") or ""
        if join.get("measured_mfu") is not None:
            self._measured_mfu.set(join["measured_mfu"], program=p)
        if join.get("model_agreement_ratio") is not None:
            self._model_agreement.set(
                join["model_agreement_ratio"], program=p)
        self._dispatch_gap.set(
            float(join.get("dispatch_gap_ms", 0.0)), program=p)
        self.tracer.event(
            "measured_profile", program=p, source=join.get("source"),
            device_ms_per_step=join.get("device_ms_per_step"),
            dispatch_gap_ms=join.get("dispatch_gap_ms"),
            measured_mfu=join.get("measured_mfu"),
            model_agreement_ratio=join.get("model_agreement_ratio"))

    def record_health(self, grad_norm: float, update_ratio: float,
                      n_bad: int = 0):
        """Per-step health scalars from the in-graph monitor
        (obs/health.py applies warn/raise policy; this just records)."""
        import math
        if math.isfinite(grad_norm):
            self._grad_norm.set(round(grad_norm, 6))
        if math.isfinite(update_ratio):
            self._update_ratio.set(round(update_ratio, 8))
        if n_bad:
            self._nonfinite.inc(n_bad)
        self.last_health = {
            "grad_norm": grad_norm if math.isfinite(grad_norm) else None,
            "update_ratio": update_ratio
            if math.isfinite(update_ratio) else None,
            "n_bad": int(n_bad),
            "step": self._steps.value,
            "t_mono": time.monotonic(),
        }
        if self.flight is not None:
            self.flight.record_health(self.last_health)
            if n_bad:
                self.flight.dump("nonfinite_health")

    def record_collectives(self, hlo_text: str, program: str = ""):
        """Collective traffic from a compiled program's collectives: the
        parser and cost model are ``parallel/scaling.py``'s, not ported
        yet: raises naming ROADMAP A9."""
        raise _not_ported("Telemetry.record_collectives "
                          "(parallel/scaling.py)", "A9")

    # --------------------------------------------------- trainer hooks
    @contextlib.contextmanager
    def trainer_step(self, examples: int = 0, steps: int = 1):
        """Wraps one Trainer step (or one K-step grouped dispatch):
        emits a ``trainer_step`` span and observes the per-step wall
        time. ``examples`` is counted only if the step completes."""
        t0 = time.perf_counter()
        d0 = self._dispatches.value
        with self.tracer.span("trainer_step", examples=examples,
                              steps=steps) as args, \
                trace_annotation("trainer_step"):
            yield args
            wall_ms = (time.perf_counter() - t0) * 1e3
            args["step_ms"] = round(wall_ms / max(1, steps), 3)
        self._trainer_ms.observe(wall_ms / max(1, steps))
        # the execution-plan acceptance gauge: a fully planned/fused
        # trainer step issues exactly ONE device dispatch
        self._dispatches_per_step.set(
            (self._dispatches.value - d0) / max(1, steps))
        if examples:
            self._examples.inc(examples)
        # per-step attribution + failure-detector tick: refresh the
        # goodput gauges from the registry, then run the alert rules
        # (µs-scale — covered by the <2% obs budget tests)
        self.update_goodput()
        self.alerts.evaluate()

    # -------------------------------------------------- goodput hooks
    def observe_feed_wait(self, ms: float):
        """Trainer-loop blocking time on the next feed (K=1 path and
        ``cli profile --goodput``'s loop)."""
        self._feed_wait.observe(ms)

    def observe_staging(self, ms: float, depth: int = 0):
        """Megastep consumer blocking time on the staging queue, plus
        the queue occupancy sampled after the get."""
        self._staging_wait.observe(ms)
        self._staging_depth.set(float(depth))

    def observe_step_wall(self, ms: float, steps: int = 1):
        """One full trainer-loop iteration's wall time — the
        independent per-step clock ``obs/goodput.decompose`` reconciles
        the attributed components against. For a K-step grouped
        iteration pass ``steps=K``; the histogram records per-step."""
        per = ms / max(1, steps)
        for _ in range(max(1, steps)):
            self._step_wall.observe(per)

    def update_goodput(self) -> dict:
        """Recompute the decomposition and refresh ``train_goodput`` +
        ``goodput_component_ms{component}``. Returns the decomposition
        dict (steps=0 before any step)."""
        from paddle_tpu_torch.obs import goodput
        d = goodput.decompose(self)
        if d["steps"]:
            self._goodput.set(d["train_goodput"])
            for comp, ms in d["components"].items():
                self._goodput_component.set(ms, component=comp)
        return d

    def record_step(self, wall_s: float, examples: int, cost=None):
        self._trainer_ms.observe(wall_s * 1e3)
        if examples:
            self._examples.inc(examples)

    def set_examples_per_sec(self, eps: float):
        self._eps.set(eps)

    def sample_memory(self):
        """Gauge the card's live tensors: the bytes the CUDA caching
        allocator holds for them and its count of live allocations.
        ``(None, None)`` without a card."""
        import torch
        if not torch.cuda.is_available():
            return None, None
        nbytes = int(torch.cuda.memory_allocated())
        count = int(torch.cuda.memory_stats().get(
            "allocation.all.current", 0))
        self._mem_bytes.set(nbytes)
        self._mem_count.set(count)
        self.tracer.event("memory_sample", live_buffer_bytes=nbytes,
                          live_buffer_count=count)
        return nbytes, count

    def pass_rollup(self, pass_id: int, steps: int, examples: int,
                    wall_s: float) -> dict:
        """Per-pass summary attached to the EndPass event."""
        eps = examples / wall_s if wall_s > 0 else 0.0
        self.set_examples_per_sec(eps)
        rollup = {
            "pass_id": pass_id,
            "steps": steps,
            "examples": examples,
            "wall_s": round(wall_s, 4),
            "examples_per_sec": round(eps, 2),
            "step_ms_p50": _r(self._trainer_ms.median()),
            "step_ms_iqr": _r(self._trainer_ms.iqr()),
            "device_step_ms_p50": _r(self._device_ms.median()),
            "jit_compiles": self._compiles.value,
            "jit_cache_hits": self._cache_hits.value,
            "live_buffer_bytes": self._mem_bytes.get()
            if self._mem_bytes._items() else None,
        }
        self.tracer.event("pass_rollup", **rollup)
        return rollup

    # ----------------------------------------------------------- sinks
    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    def close(self):
        """Append the final metric snapshots to the trace and flush.
        Idempotent — Trainer closes sessions it created; callers who
        passed their own Telemetry may close later themselves."""
        if self._closed:
            return
        self._closed = True
        if self._owns_reader_sink:
            from paddle_tpu_torch.obs import goodput as _goodput_mod
            _goodput_mod.detach_reader_sink(self)
            self._owns_reader_sink = False
        if self.flight is not None:
            self.flight.detach()
        for name, snap in self.registry.snapshot().items():
            self.tracer.metric(name, snap)
        self.tracer.close()

    def flush(self):
        self.tracer.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _r(v, nd=4):
    return round(v, nd) if isinstance(v, float) else v


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet: ROADMAP item "
        f"{item}")


def _fence(block_on):
    """Wait for the card's current stream on the device of the first
    CUDA tensor in ``block_on`` (a tensor, or a list / tuple / dict of
    them); nothing for CPU tensors or None."""
    import torch
    todo = [block_on]
    while todo:
        x = todo.pop()
        if torch.is_tensor(x):
            if x.is_cuda:
                torch.cuda.current_stream(x.device).synchronize()
                return
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
