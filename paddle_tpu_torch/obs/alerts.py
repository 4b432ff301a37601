"""Declarative alert rules over the live metrics registry.

The port's copy of the JAX package's ``obs/alerts.py`` (pure Python):
a small rule engine evaluated in-process on the registry the hot paths
already write, no scrape round-trip. A ``Rule`` is a predicate over ONE
contract metric name (the names of ``docs/observability.md``'s and
``docs/serving.md``'s metric tables, so a rule never references a
metric the code doesn't emit):

  threshold   compare the metric's current value against ``value``
              with ``op``; ``for_n`` consecutive breaching evaluations
              before firing ("sustained-for-N-steps")
  increase    fire when a counter grew since the previous evaluation
              (nonfinite grads, worker crashes); stays firing for
              ``hold_s`` seconds after the last growth so the edge is
              observable at ``/alertz`` (which itself re-evaluates)
  ratio       metric / ``denominator`` compared against ``value``
  quantile    a histogram's reservoir p{q} against ``value`` (serving
              SLO breaches)
  fleet       read the named key from the leader's fleet view (passed
              as ``context=`` by obs/aggregate.py) — cross-host skew
  fleet_absent  fire while ``n_hosts - n_present > value`` in the
              fleet view — the dead-host detector
  burn_rate   multi-window SLO burn (the SRE fast/slow-window policy):
              the violation fraction — histogram observations above
              ``value``, or ``metric``/``denominator`` counter events
              when a denominator is set — divided by the error budget
              ``1 - q/100``, must exceed ``burn_threshold`` over BOTH
              the fast and the slow window to fire. The fast window
              makes a real breach fire (and resolve) quickly; the slow
              window keeps a short blip from paging. Each evaluation
              appends one (time, violations, total) sample to the
              rule's window ring; no traffic in a window reads as
              no-data, never as a breach.

Firing state transitions drive the side effects: the
``ALERTS{alertname=...}`` gauge flips 1/0 (UPPERCASE by Prometheus
convention for the synthetic alerts series — deliberately outside the
lowercase metric-name contract), a tracer event records the edge, and
a flight-recorder bundle dumps under reason ``alert_<name>`` riding
the recorder's existing per-reason cooldown. ``/alertz``
(obs/server.py) serves ``status()``; the flight recorder embeds
``active()`` in every bundle as alerts.json.

Evaluation cadence: every ``Telemetry.trainer_step`` exit, every
serving flush, every ``/alertz`` request, and — with the fleet view as
context — every leader ``MetricAggregator.publish``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

__all__ = ["Rule", "AlertEngine", "DEFAULT_RULES", "FLEET_RULES",
           "validate_rules"]

_KINDS = ("threshold", "increase", "ratio", "quantile", "fleet",
          "fleet_absent", "burn_rate")
_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative predicate over a contract metric name."""

    name: str
    kind: str
    metric: str               # contract metric name ("" only for
    #                           fleet_absent, which reads membership)
    op: str = ">"
    value: float = 0.0
    for_n: int = 1            # consecutive breaching evals to fire
    denominator: str = ""     # ratio rules: metric / denominator
    q: float = 99.0           # quantile rules: percentile
    hold_s: float = 0.0       # increase rules: stay firing this many
    #                           seconds after the last observed growth
    #                           (0 = resolve on the next flat eval)
    scope: str = "host"       # "host" | "fleet"
    severity: str = "warning"
    summary: str = ""
    # burn_rate rules: the SLO objective is "fraction of events over
    # ``value`` stays within the 1 - q/100 error budget"; fire when the
    # budget burns faster than ``burn_threshold``x in BOTH windows
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_threshold: float = 6.0

    def metrics_referenced(self) -> List[str]:
        """Every contract metric name this rule reads (the CI gate's
        input)."""
        out = [m for m in (self.metric, self.denominator) if m]
        return out


def validate_rules(rules: Sequence[Rule]) -> None:
    """Structural validation: unique names, known kinds/ops, fleet
    scoping consistent. Raises ValueError on the first defect."""
    seen = set()
    for r in rules:
        if r.name in seen:
            raise ValueError(f"duplicate rule name {r.name!r}")
        seen.add(r.name)
        if r.kind not in _KINDS:
            raise ValueError(f"rule {r.name!r}: unknown kind {r.kind!r}")
        if r.op not in _OPS:
            raise ValueError(f"rule {r.name!r}: unknown op {r.op!r}")
        if r.kind == "ratio" and not r.denominator:
            raise ValueError(f"rule {r.name!r}: ratio needs denominator")
        if r.kind in ("fleet", "fleet_absent") and r.scope != "fleet":
            raise ValueError(f"rule {r.name!r}: {r.kind} rules must be "
                             "scope='fleet'")
        if r.kind != "fleet_absent" and not r.metric:
            raise ValueError(f"rule {r.name!r}: metric name required")
        if r.for_n < 1:
            raise ValueError(f"rule {r.name!r}: for_n must be >= 1")
        if r.hold_s < 0:
            raise ValueError(f"rule {r.name!r}: hold_s must be >= 0")
        if r.kind == "burn_rate":
            if not (50.0 < r.q < 100.0):
                raise ValueError(f"rule {r.name!r}: burn_rate needs "
                                 "50 < q < 100 (a real error budget)")
            if not (0.0 < r.fast_window_s < r.slow_window_s):
                raise ValueError(f"rule {r.name!r}: burn_rate needs "
                                 "0 < fast_window_s < slow_window_s")
            if r.burn_threshold <= 0:
                raise ValueError(f"rule {r.name!r}: burn_threshold "
                                 "must be > 0")


# The shipped default ruleset: sustained goodput collapse,
# nonfinite gradients, straggler skew, serving p99 breach.
DEFAULT_RULES: Tuple[Rule, ...] = (
    Rule(name="low_goodput", kind="threshold", metric="train_goodput",
         op="<", value=0.6, for_n=5,
         summary="train_goodput sustained below 0.6 for 5 steps — most "
                 "of the step wall clock is not device compute"),
    Rule(name="nonfinite_grads", kind="increase",
         metric="nonfinite_grads_total", severity="critical",
         hold_s=600.0,
         summary="nonfinite_grads_total increased — a step saw NaN/Inf "
                 "gradients"),
    Rule(name="straggler_skew", kind="threshold",
         metric="host_step_skew_ms", op=">", value=1000.0, for_n=2,
         summary="cross-host step-time skew above 1s — one host is "
                 "pinning the synchronous fleet"),
    Rule(name="serving_p99_high", kind="quantile",
         metric="serving_request_ms", q=99.0, op=">", value=500.0,
         for_n=3,
         summary="serving p99 request latency above 500 ms for 3 "
                 "consecutive flushes"),
    # Decode SLOs as multi-window burn rates: objective =
    # "99% of requests under the latency target"; fire when the 1%
    # error budget burns >6x in both the fast and the slow window.
    Rule(name="decode_ttft_slo_burn", kind="burn_rate",
         metric="decode_ttft_ms", q=99.0, value=500.0,
         severity="critical",
         summary="TTFT SLO (99% of requests under 500 ms) error budget "
                 "burning >6x in both fast and slow windows"),
    Rule(name="decode_tpot_slo_burn", kind="burn_rate",
         metric="decode_tpot_ms", q=99.0, value=250.0,
         summary="TPOT SLO (99% of requests under 250 ms/token) error "
                 "budget burning >6x in both fast and slow windows"),
    Rule(name="decode_reject_slo_burn", kind="burn_rate",
         metric="decode_rejected_total",
         denominator="decode_requests_total", q=99.0,
         summary="admission-reject SLO (99% of submits admitted) error "
                 "budget burning >6x in both fast and slow windows"),
)

# Fleet-scope rules the aggregation leader evaluates against the fleet
# view (obs/aggregate.py publish): the failure-detector inputs.
FLEET_RULES: Tuple[Rule, ...] = (
    Rule(name="fleet_straggler", kind="fleet",
         metric="host_step_skew_ms", op=">", value=1000.0, scope="fleet",
         summary="fleet view shows >1s step-time skew across hosts"),
    Rule(name="fleet_host_absent", kind="fleet_absent", metric="",
         op=">", value=0.0, scope="fleet", severity="critical",
         summary="one or more hosts stopped pushing snapshots — dead "
                 "or partitioned"),
)

validate_rules(DEFAULT_RULES + FLEET_RULES)


class AlertEngine:
    """Evaluate a ruleset against one registry; track firing state.

    Host-scope rules read the registry; fleet-scope rules additionally
    need the leader's fleet view passed as ``context=`` and are
    skipped without one (non-leaders never evaluate them).
    """

    def __init__(self, registry, rules: Optional[Sequence[Rule]] = None,
                 telemetry=None):
        self.registry = registry
        self.rules: Tuple[Rule, ...] = tuple(
            DEFAULT_RULES + FLEET_RULES if rules is None else rules)
        validate_rules(self.rules)
        self.telemetry = telemetry
        # UPPERCASE by convention: the synthetic alerts series, not a
        # measurement — kept outside the lowercase metric contract
        self._gauge = registry.gauge(
            "ALERTS", "firing alert rules (1 while firing)",
            ("alertname",))
        self._evals = registry.counter(
            "alert_evaluations_total", "alert rule-set evaluations")
        self._state: dict = {}      # rule name -> mutable state
        self._annotations: dict = {}   # rule name -> enrichment dict
        self._lock = threading.Lock()

    def rebind(self, registry):
        """Point the engine at a different registry while preserving
        all firing/breach/burn-window state — the fleet federation
        swaps in a freshly merged registry every refresh, but a
        sustained breach must keep counting across swaps. Re-registers
        the ALERTS gauge on the new registry and re-flips currently
        firing rules so the synthetic series survives the swap."""
        with self._lock:
            self.registry = registry
            self._gauge = registry.gauge(
                "ALERTS", "firing alert rules (1 while firing)",
                ("alertname",))
            self._evals = registry.counter(
                "alert_evaluations_total", "alert rule-set evaluations")
            for rule in self.rules:
                st = self._state.get(rule.name) or {}
                if st.get("firing"):
                    self._gauge.set(1.0, alertname=rule.name)

    # ------------------------------------------------------ observation
    def _metric_value(self, rule: Rule, name: str) -> Optional[float]:
        m = self.registry.find(name)
        if m is None:
            return None
        kind = getattr(m, "kind", "")
        if kind == "histogram":
            if rule.kind == "quantile":
                try:
                    return m.percentile(rule.q)
                except ValueError:
                    return None
            # threshold/ratio over a histogram read its mean
            s, c = 0.0, 0
            for _k, ch in m._items():
                s += ch.sum
                c += ch.count
            return s / c if c else None
        if kind == "counter":
            return float(m.value)
        # gauge: single series reads directly; labeled series take the
        # max (worst case across programs/hosts)
        vals = [ch.value for _k, ch in m._items()]
        return float(max(vals)) if vals else None

    def _observe(self, rule: Rule,
                 context: Optional[dict]) -> Optional[Tuple[float, bool]]:
        """(observed value, breaching?) or None when there is no data."""
        cmp = _OPS[rule.op]
        if rule.kind == "fleet_absent":
            if not context:
                return None
            absent = (float(context.get("n_hosts", 0))
                      - float(context.get("n_present", 0)))
            return absent, cmp(absent, rule.value)
        if rule.kind == "fleet":
            if not context or rule.metric not in context:
                return None
            v = float(context[rule.metric])
            return v, cmp(v, rule.value)
        if rule.kind == "burn_rate":
            return self._observe_burn(rule)
        v = self._metric_value(rule, rule.metric)
        if v is None:
            return None
        if rule.kind == "ratio":
            d = self._metric_value(rule, rule.denominator)
            if not d:
                return None
            v = v / d
        if rule.kind == "increase":
            st = self._state.setdefault(rule.name, {})
            prev = st.get("last_seen")
            st["last_seen"] = v
            if prev is None:           # first look: baseline, no edge
                return v, False
            if v > prev:
                st["last_grow_t"] = time.time()
                return v - prev, True
            grow_t = st.get("last_grow_t")
            if grow_t is not None and time.time() - grow_t < rule.hold_s:
                return 0.0, True       # inside the hold window
            return v - prev, False
        return v, cmp(v, rule.value)

    def _burn_counts(self, rule: Rule) -> Optional[Tuple[float, float]]:
        """Cumulative (violations, total events) for one burn_rate
        rule. Histogram mode counts observations above ``value`` from
        the per-bucket counts (the edge at or below ``value`` bounds
        the in-budget set — pick SLO thresholds on bucket edges);
        counter-ratio mode (``denominator`` set) reads both counters."""
        if rule.denominator:
            over = self._metric_value(rule, rule.metric)
            total = self._metric_value(rule, rule.denominator)
            if over is None or total is None:
                return None
            return float(over), float(total)
        m = self.registry.find(rule.metric)
        if m is None or getattr(m, "kind", "") != "histogram":
            return None
        over = total = 0.0
        for _k, ch in m._items():
            total += ch.count
            within = sum(c for edge, c in zip(ch.buckets,
                                              ch.bucket_counts)
                         if edge <= rule.value)
            over += ch.count - within
        return over, total

    def _observe_burn(self, rule: Rule) -> Optional[Tuple[float, bool]]:
        """Multi-window burn rate. Each evaluation appends one
        (now, violations, total) sample to the rule's ring; a window's
        burn is the violation fraction of the events that arrived
        inside it, over the error budget ``1 - q/100``. The newest
        sample at least window-old anchors the delta (fallback: the
        oldest sample — a partial window, so a sustained breach fires
        before a full slow window of history exists). Fires only when
        BOTH windows burn past ``burn_threshold``; the reported value
        is the fast burn. No traffic in a window reads as no-data."""
        counts = self._burn_counts(rule)
        if counts is None:
            return None
        over, total = counts
        now = time.time()
        st = self._state.setdefault(rule.name, {})
        ring = st.get("burn_ring")
        if ring is None:
            ring = st["burn_ring"] = collections.deque()
        ring.append((now, over, total))
        # prune, always keeping one sample outside the slow window as
        # the baseline the slow delta anchors to
        while len(ring) > 1 and now - ring[1][0] >= rule.slow_window_s:
            ring.popleft()
        if len(ring) < 2:
            return None          # first look: baseline only, no rate
        budget = max(1.0 - rule.q / 100.0, 1e-9)

        def window_burn(window_s: float) -> Optional[float]:
            base = None
            for t, o, tt in ring:
                if now - t >= window_s:
                    base = (o, tt)
                else:
                    break
            if base is None:
                base = (ring[0][1], ring[0][2])
            d_total = total - base[1]
            if d_total <= 0:
                return None      # no traffic inside the window
            return ((over - base[0]) / d_total) / budget

        fast = window_burn(rule.fast_window_s)
        slow = window_burn(rule.slow_window_s)
        if fast is None or slow is None:
            return None
        cmp = _OPS[rule.op]
        return fast, (cmp(fast, rule.burn_threshold)
                      and cmp(slow, rule.burn_threshold))

    # ------------------------------------------------------- evaluation
    def evaluate(self, context: Optional[dict] = None) -> List[dict]:
        """Run every rule once; returns the currently firing list.
        Fleet-scope rules only run when ``context`` (a fleet view dict)
        is given. Never raises — a broken rule reads as no-data."""
        newly_firing = []
        resolved = []
        with self._lock:
            for rule in self.rules:
                if rule.scope == "fleet" and context is None:
                    continue
                try:
                    obs = self._observe(rule, context)
                except Exception:
                    obs = None
                st = self._state.setdefault(rule.name, {})
                if obs is None:
                    continue
                value, breach = obs
                st["value"] = value
                if breach:
                    st["breaches"] = st.get("breaches", 0) + 1
                    if (not st.get("firing")
                            and st["breaches"] >= rule.for_n):
                        st["firing"] = True
                        st["since"] = time.time()
                        newly_firing.append((rule, value))
                else:
                    st["breaches"] = 0
                    if st.get("firing"):
                        st["firing"] = False
                        resolved.append((rule, value))
            self._evals.inc()
            active = self._active_locked()
        # side effects outside the lock: gauge flips, tracer edges, and
        # the flight-recorder postmortem (its own per-reason cooldown)
        tel = self.telemetry
        for rule, value in newly_firing:
            self._gauge.set(1.0, alertname=rule.name)
            if tel is not None:
                try:
                    tel.tracer.event("alert_firing", alertname=rule.name,
                                     severity=rule.severity,
                                     value=round(value, 6),
                                     threshold=rule.value,
                                     summary=rule.summary)
                except Exception:
                    pass
                fl = getattr(tel, "flight", None)
                if fl is not None:
                    try:
                        fl.dump(f"alert_{rule.name}",
                                extra={"rule": rule.name,
                                       "severity": rule.severity,
                                       "value": value,
                                       "threshold": rule.value,
                                       "summary": rule.summary})
                    except Exception:
                        pass
        for rule, value in resolved:
            self._gauge.set(0.0, alertname=rule.name)
            if tel is not None:
                try:
                    tel.tracer.event("alert_resolved",
                                     alertname=rule.name,
                                     value=round(value, 6))
                except Exception:
                    pass
        return active

    def _active_locked(self) -> List[dict]:
        out = []
        for rule in self.rules:
            st = self._state.get(rule.name) or {}
            if st.get("firing"):
                entry = {
                    "alertname": rule.name,
                    "severity": rule.severity,
                    "scope": rule.scope,
                    "value": st.get("value"),
                    "threshold": rule.value,
                    "since": st.get("since"),
                    "summary": rule.summary,
                }
                notes = self._annotations.get(rule.name)
                if notes:
                    entry["annotations"] = dict(notes)
                out.append(entry)
        return out

    def active(self) -> List[dict]:
        """The currently firing alerts (no re-evaluation)."""
        with self._lock:
            return self._active_locked()

    def annotate(self, alertname: str, **kv):
        """Attach enrichment key/values to one rule's firing entries —
        e.g. the NaN-origin bisector naming the culprit op on
        ``nonfinite_grads`` so ``/alertz`` answers *which op*, not just
        *that it happened*. Annotations persist until overwritten and
        render under ``annotations`` in ``active()``/``status()``;
        unknown rule names are accepted (the rule set is caller-
        configurable)."""
        with self._lock:
            self._annotations.setdefault(alertname, {}).update(kv)

    def status(self) -> dict:
        """The ``/alertz`` payload: firing alerts plus the ruleset."""
        with self._lock:
            firing = self._active_locked()
            state = {n: {"breaches": st.get("breaches", 0),
                         "value": st.get("value")}
                     for n, st in self._state.items()}
        return {
            "firing": firing,
            "evaluations": self._evals.value,
            "rules": [{
                "name": r.name, "kind": r.kind, "metric": r.metric,
                "op": r.op, "value": r.value, "for_n": r.for_n,
                "scope": r.scope, "severity": r.severity,
            } for r in self.rules],
            "state": state,
        }
