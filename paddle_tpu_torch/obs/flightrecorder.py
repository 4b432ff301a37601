"""Crash flight recorder — bounded rings + postmortem JSONL bundles.

A ``FlightRecorder`` rides a ``Telemetry`` session keeping three bounded
rings: the most recent spans/events (fed by a tracer listener), the most
recent metric/counter samples, and the per-step health records from the
in-graph ``HealthMonitor``. When something goes wrong it dumps a
self-contained bundle directory:

  <out_dir>/<stamp>_<reason>/
    manifest.json   reason, wall time, record counts, program
                    fingerprints, last health record
    spans.jsonl     the span/event ring, oldest first
    samples.jsonl   the metric/counter sample ring
    health.jsonl    the per-step health ring
    metrics.json    full registry snapshot at dump time
    alerts.json     alert-rule firings active at dump time; an
                    alert-triggered bundle also names its rule in the
                    manifest (``alert_rule``)

Dump triggers:

  * nonfinite-health trip — ``Telemetry.record_health`` with bad grads
  * unhandled exception in a guarded worker (``guard()`` context
    manager, used by Trainer.train and the ServingEngine workers)
  * SIGTERM — the preemption signal a scheduler sends a job; the
    previous handler is chained, not replaced
  * alert-rule firing edge — the AlertEngine (obs/alerts.py) dumps
    under reason ``alert_<rule>``, cooldown-scoped like any other

Each dump bumps ``flight_recorder_dumps_total{reason}``. Repeated trips
of the SAME reason are rate-limited by ``cooldown_s`` (a job NaN-ing
every step must not write a bundle per step); the first trip always
dumps.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded forensic rings + bundle dumps for one Telemetry session.

    Construct via ``Telemetry(flight=True)`` (which calls ``attach``) or
    standalone with ``FlightRecorder(out_dir=...).attach(tel)``.
    """

    def __init__(self, out_dir: str = "flight",
                 capacity: int = 512,
                 cooldown_s: float = 30.0,
                 install_signal: bool = True):
        self.out_dir = out_dir
        self.capacity = int(capacity)
        self.cooldown_s = float(cooldown_s)
        self.install_signal = bool(install_signal)
        self.spans: "deque[dict]" = deque(maxlen=self.capacity)
        self.samples: "deque[dict]" = deque(maxlen=self.capacity)
        self.health: "deque[dict]" = deque(maxlen=self.capacity)
        self.dumps: list = []          # bundle dirs written, in order
        self._lock = threading.Lock()
        self._last_dump: dict = {}     # reason -> monotonic ts
        self._seq = 0
        self._tel = None
        self._dumps_total = None
        self._prev_sigterm = None
        # ``() -> list`` of firing alerts at dump time (set by the
        # Telemetry session's AlertEngine): every bundle carries the
        # alert state that was active when the job died
        self.alerts_provider = None
        # ``() -> list`` of the slowest retired-request ledgers (set by
        # Telemetry from its registered request providers): an
        # SLO-breach bundle shows WHICH requests burned the budget
        self.ledgers_provider = None

    # ---------------------------------------------------------- wiring
    @staticmethod
    def ensure(value, telemetry=None) -> Optional["FlightRecorder"]:
        """Normalise a ``flight=`` argument: None/False → off, True → a
        default recorder, an instance passes through; either way the
        recorder is attached to ``telemetry`` when given."""
        if value is None or value is False:
            return None
        fr = FlightRecorder() if value is True else value
        if not isinstance(fr, FlightRecorder):
            raise TypeError(
                f"flight= expects bool/None/FlightRecorder, "
                f"got {type(value)!r}")
        if telemetry is not None:
            fr.attach(telemetry)
        return fr

    def attach(self, telemetry) -> "FlightRecorder":
        """Hook the telemetry session: tracer listener feeds the rings,
        the dump counter lands on its registry, SIGTERM gets chained."""
        self._tel = telemetry
        self._dumps_total = telemetry.registry.counter(
            "flight_recorder_dumps_total",
            "postmortem bundles written, by trigger", ("reason",))
        telemetry.tracer.add_listener(self._on_record)
        if self.install_signal:
            self._install_sigterm()
        return self

    def detach(self):
        if self._tel is not None:
            try:
                self._tel.tracer.remove_listener(self._on_record)
            except Exception:
                pass
        self._restore_sigterm()
        self._tel = None

    def _on_record(self, rec: dict):
        # runs under the tracer's lock — append-only, never calls back
        t = rec.get("type")
        if t in ("span", "event"):
            self.spans.append(rec)
        elif t in ("metric", "counter"):
            self.samples.append(rec)

    def record_health(self, rec: dict):
        """Per-step health record from ``Telemetry.record_health``."""
        self.health.append(dict(rec))

    # --------------------------------------------------------- signals
    def _install_sigterm(self):
        if threading.current_thread() is not threading.main_thread():
            return

        def _handler(signum, frame):
            try:
                self.dump("sigterm")
            except Exception:
                pass
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError):
            self._prev_sigterm = None

    def _restore_sigterm(self):
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None

    # ----------------------------------------------------------- guard
    def guard(self, component: str):
        """Context manager for worker loops: an unhandled exception
        dumps a ``exception_<component>`` bundle, then re-raises."""
        return _Guard(self, component)

    # ------------------------------------------------------------ dump
    def dump(self, reason: str, extra: Optional[dict] = None
             ) -> Optional[str]:
        """Write a bundle; returns its directory, or None when the
        per-reason cooldown suppressed it."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_dump[reason] = now
            self._seq += 1
            seq = self._seq
            spans = list(self.spans)
            samples = list(self.samples)
            health = list(self.health)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)
        path = os.path.join(self.out_dir, f"{stamp}_{seq:03d}_{safe}")
        os.makedirs(path, exist_ok=True)
        snapshot = {}
        fingerprints = {}
        if self._tel is not None:
            try:
                snapshot = self._tel.registry.snapshot()
            except Exception:
                pass
            fingerprints = dict(
                getattr(self._tel, "program_fingerprints", {}) or {})
        firing = []
        if self.alerts_provider is not None:
            try:
                firing = list(self.alerts_provider())
            except Exception:
                pass
        ledgers = []
        if self.ledgers_provider is not None:
            try:
                ledgers = list(self.ledgers_provider())
            except Exception:
                pass
        manifest = {
            "reason": reason,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "pid": os.getpid(),
            "n_spans": len(spans),
            "n_samples": len(samples),
            "n_health": len(health),
            "program_fingerprints": fingerprints,
            "last_health": health[-1] if health else None,
            "alerts_firing": [a.get("alertname") for a in firing],
            "n_ledgers": len(ledgers),
        }
        if extra:
            manifest["extra"] = extra
            # an alert-triggered dump names its rule at the top level
            # so bundle triage never needs to open alerts.json
            if "rule" in extra:
                manifest["alert_rule"] = extra["rule"]
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        with open(os.path.join(path, "alerts.json"), "w") as f:
            json.dump({"firing": firing}, f, indent=1, default=str)
        if ledgers:
            # slowest retired-request ledgers at dump time: an SLO
            # bundle names the requests that burned the budget
            with open(os.path.join(path, "ledgers.json"), "w") as f:
                json.dump({"slowest": ledgers}, f, indent=1,
                          default=str)
        for fname, recs in (("spans.jsonl", spans),
                            ("samples.jsonl", samples),
                            ("health.jsonl", health)):
            with open(os.path.join(path, fname), "w") as f:
                for r in recs:
                    f.write(json.dumps(r, default=str) + "\n")
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump(snapshot, f, indent=1, default=str)
        self.dumps.append(path)
        if self._dumps_total is not None:
            self._dumps_total.inc(1, reason=reason)
        if self._tel is not None:
            try:
                self._tel.tracer.event("flight_recorder_dump",
                                       reason=reason, path=path)
            except Exception:
                pass
        return path

    def annotate_last(self, updates: dict) -> Optional[str]:
        """Merge keys into the most recent bundle's manifest.json — the
        post-hoc enrichment hook for results that only exist AFTER the
        dump fired (the NaN-origin bisection runs once the health trip
        has already written its bundle). Returns the bundle path, or
        None when there is no bundle / the manifest can't be rewritten
        (annotation is forensic garnish, never a failure)."""
        if not self.dumps:
            return None
        path = self.dumps[-1]
        mpath = os.path.join(path, "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            manifest.update(updates)
            tmp = mpath + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, default=str)
            os.replace(tmp, mpath)
        except Exception:
            return None
        return path

    def status(self) -> dict:
        """``/statusz`` row for the recorder itself."""
        return {
            "out_dir": self.out_dir,
            "ring": {"spans": len(self.spans),
                     "samples": len(self.samples),
                     "health": len(self.health),
                     "capacity": self.capacity},
            "dumps": list(self.dumps),
        }


class _Guard:
    def __init__(self, fr: FlightRecorder, component: str):
        self._fr = fr
        self._component = component

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and not issubclass(
                exc_type, (KeyboardInterrupt, SystemExit, GeneratorExit)):
            try:
                self._fr.dump(f"exception_{self._component}",
                              extra={"exception": repr(exc)})
            except Exception:
                pass
        return False
