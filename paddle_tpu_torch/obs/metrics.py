"""Metrics registry: Counter / Gauge / Histogram with labels.

The port's copy of the JAX package's ``obs/metrics.py`` (pure Python;
the port keeps its own so it never imports that package). A metric
carries a type, a help string and label dimensions, snapshots to plain
dicts/JSON, and dumps in the Prometheus text exposition format so any
scrape-based collector can ingest the counters unchanged.

Histograms keep both fixed buckets (for the Prometheus dump) and a
bounded reservoir of raw observations, so quantile summaries (median,
IQR) stay exact up to the reservoir size and degrade gracefully past
it. The engines register the metric names of ``docs/observability.md``
and ``docs/serving.md``, so both packages expose the same names.
"""
from __future__ import annotations

import json
import random
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "LATENCY_BUCKETS_MS",
           "registry_from_snapshot"]

# Latency-shaped default buckets (ms-friendly decades).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   50.0, 100.0, 500.0, 1000.0, 5000.0, float("inf"))

# Finer request-latency grid for serving SLO histograms: a scraper
# deriving p50/p99 purely from ``_bucket`` lines (histogram_quantile)
# needs boundaries dense around the operating point, and serving
# latencies live in the 0.5–500 ms band where the decade grid above has
# only four edges.
LATENCY_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 7.5, 10.0, 25.0, 50.0, 75.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0,
                      float("inf"))


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> Tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"metric labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_labels(labelnames: Sequence[str], key: Tuple) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, key))
    return "{" + inner + "}"


class _Metric:
    """Shared base: name, help, label plumbing, per-labelset children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        """The child metric for one label combination (created lazily)."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} declares labels {self.labelnames}; "
                "use .labels(...)")
        return self.labels()

    def _items(self):
        with self._lock:
            return list(self._children.items())

    def snapshot(self) -> dict:
        series = {}
        for key, child in self._items():
            series[",".join(key) if key else ""] = child.value_dict()
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames), "series": series}


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def value_dict(self):
        return {"value": self._value}


class Counter(_Metric):
    """Monotonically increasing count (dispatches, recompiles, bytes)."""

    kind = "counter"
    _new_child = _CounterChild

    def inc(self, amount: float = 1.0, **labels):
        (self.labels(**labels) if labels else self._default_child()).inc(
            amount)

    @property
    def value(self) -> float:
        return sum(c.value for _, c in self._items())

    def get(self, **labels) -> float:
        return self.labels(**labels).value if labels else self.value


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def value_dict(self):
        return {"value": self._value}


class Gauge(_Metric):
    """Point-in-time value (live bytes, examples/sec, cache size)."""

    kind = "gauge"
    _new_child = _GaugeChild

    def set(self, value: float, **labels):
        (self.labels(**labels) if labels else self._default_child()).set(
            value)

    def inc(self, amount: float = 1.0, **labels):
        (self.labels(**labels) if labels else self._default_child()).inc(
            amount)

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    @property
    def value(self) -> float:
        items = self._items()
        if len(items) != 1:
            raise ValueError(
                f"gauge {self.name!r} has {len(items)} series; "
                "read .labels(...).value")
        return items[0][1].value

    def get(self, **labels) -> float:
        return self.labels(**labels).value if labels else self.value


class _HistogramChild:
    __slots__ = ("buckets", "bucket_counts", "count", "sum",
                 "_reservoir", "_reservoir_size", "_rng", "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 reservoir_size: int = 4096):
        self.buckets = tuple(sorted(buckets))
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self._reservoir: List[float] = []
        self._reservoir_size = reservoir_size
        self._rng = random.Random(0)   # deterministic downsampling
        self._lock = threading.Lock()

    def observe(self, value: float):
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.bucket_counts[i] += 1
                    break
            # Vitter's algorithm R: uniform reservoir past the cap
            if len(self._reservoir) < self._reservoir_size:
                self._reservoir.append(value)
            else:
                j = self._rng.randrange(self.count)
                if j < self._reservoir_size:
                    self._reservoir[j] = value

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100], linear interpolation over the reservoir."""
        with self._lock:
            data = sorted(self._reservoir)
        if not data:
            return None
        if len(data) == 1:
            return data[0]
        rank = (p / 100.0) * (len(data) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(data) - 1)
        frac = rank - lo
        return data[lo] * (1 - frac) + data[hi] * frac

    def median(self) -> Optional[float]:
        return self.percentile(50)

    def iqr(self) -> Optional[float]:
        if not self._reservoir:
            return None
        return self.percentile(75) - self.percentile(25)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile_from_buckets(self, p: float) -> Optional[float]:
        """The quantile a Prometheus scraper would derive from the
        ``_bucket`` lines alone (histogram_quantile semantics: linear
        interpolation inside the owning bucket, lower edge 0 for the
        first). Bucket-resolution-bounded, unlike the exact reservoir
        ``percentile`` — the cross-check that the exported boundaries
        are usable is that the two agree within one bucket width."""
        with self._lock:
            total = self.count
            counts = list(self.bucket_counts)
        # never-observed (or restored with empty buckets): there is no
        # owning bucket, and interpolating against a zero cumulative
        # count would divide by zero — the answer is "no data", not 0.0
        if not total or not any(counts):
            return None
        rank = (p / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank:
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                if hi == float("inf"):
                    return lo   # open-ended top bucket: its lower edge
                if c == 0:
                    return hi
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self.buckets[-2] if len(self.buckets) > 1 else None

    def merge(self, other: "_HistogramChild"):
        """Fold another child's observations into this one, bucket-wise.

        Requires IDENTICAL bucket boundaries — merged cumulative counts
        are only meaningful (and fleet ``quantile_from_buckets`` only
        exact) when every replica binned against the same edges; a
        silent union of mismatched grids would fabricate quantiles, so
        mismatches are a hard error, not a best-effort resample."""
        if self.buckets != other.buckets:
            raise ValueError(
                "cannot merge histograms with mismatched bucket "
                f"boundaries: {list(self.buckets)} != "
                f"{list(other.buckets)}")
        with self._lock:
            self.count += other.count
            self.sum += other.sum
            for i, c in enumerate(other.bucket_counts):
                self.bucket_counts[i] += c
            # reservoirs pool then downsample (deterministic rng), so
            # exact-percentile reads stay usable on merged live
            # registries; snapshot-restored children have no reservoir
            # and merged quantiles come from the buckets instead
            pooled = self._reservoir + other._reservoir
            if len(pooled) > self._reservoir_size:
                pooled = self._rng.sample(pooled, self._reservoir_size)
            self._reservoir = pooled

    def value_dict(self):
        d = {"count": self.count, "sum": self.sum, "mean": self.mean}
        if self.count:
            d.update(min=min(self._reservoir) if self._reservoir else None,
                     max=max(self._reservoir) if self._reservoir else None,
                     p50=self.percentile(50), p25=self.percentile(25),
                     p75=self.percentile(75), p99=self.percentile(99))
            # per-bucket (non-cumulative) counts ride the snapshot so a
            # registry can be reconstructed from it (multi-host pushes,
            # a recorded trace) with scraper-derivable quantiles
            d["buckets"] = [
                ["+Inf" if b == float("inf") else b, c]
                for b, c in zip(self.buckets, self.bucket_counts)]
        return d


class Histogram(_Metric):
    """Distribution (step latency, compile time). ``observe`` values in
    whatever unit the name declares (the wiring uses milliseconds)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self._buckets = tuple(buckets)

    def _new_child(self):
        return _HistogramChild(self._buckets)

    def observe(self, value: float, **labels):
        (self.labels(**labels) if labels else self._default_child()).observe(
            value)

    def _only(self) -> _HistogramChild:
        return self._default_child()

    @property
    def count(self) -> int:
        return sum(c.count for _, c in self._items())

    def median(self, **labels):
        return (self.labels(**labels) if labels else self._only()).median()

    def iqr(self, **labels):
        return (self.labels(**labels) if labels else self._only()).iqr()

    def percentile(self, p: float, **labels):
        return (self.labels(**labels)
                if labels else self._only()).percentile(p)

    def merge(self, other: "Histogram"):
        """Fold another Histogram in, per label set (fleet federation).
        Bucket boundaries must match exactly — see child ``merge``."""
        if tuple(other.labelnames) != self.labelnames:
            raise ValueError(
                f"cannot merge histogram {self.name!r}: labelnames "
                f"{other.labelnames} != {self.labelnames}")
        for key, ochild in other._items():
            labels = (dict(zip(self.labelnames, key))
                      if self.labelnames else {})
            self.labels(**labels).merge(ochild)

    def quantile_from_buckets(self, p: float, **labels):
        if labels:
            # read-only probe: a never-observed label set reads as None
            # WITHOUT materializing an empty child (labels() would leak
            # a phantom series into every subsequent /metrics scrape)
            key = _label_key(self.labelnames, labels)
            with self._lock:
                child = self._children.get(key)
            return (None if child is None
                    else child.quantile_from_buckets(p))
        return self._only().quantile_from_buckets(p)


class MetricsRegistry:
    """Named metric registry — get-or-create, snapshot, JSON, Prometheus.

    One registry per Telemetry session; a module-level default exists for
    ad-hoc instrumentation the way ``global_stat`` does for timers.
    """

    def __init__(self, name: str = "paddle_tpu_torch"):
        self.name = name
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labelnames, **kw):  # noqa: A002
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
                return m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}")
        if tuple(labelnames) != m.labelnames:
            raise ValueError(
                f"metric {name!r} labelnames {m.labelnames} != "
                f"{tuple(labelnames)}")
        return m

    def counter(self, name: str, help: str = "",  # noqa: A002
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",  # noqa: A002
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def find(self, name: str) -> Optional[_Metric]:
        """Look up a metric WITHOUT creating it — the read-side twin of
        the get-or-create accessors, for consumers (goodput decomposer,
        alert rules) that must treat an absent metric as 'no data', not
        materialise an empty one."""
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> dict:
        return {m.name: m.snapshot() for m in self.metrics()}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, default=str)

    def reset(self):
        with self._lock:
            self._metrics.clear()

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one scrape page)."""
        lines: List[str] = []
        for m in self.metrics():
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, child in m._items():
                lbl = _fmt_labels(m.labelnames, key)
                if isinstance(child, _HistogramChild):
                    cum = 0
                    for b, c in zip(child.buckets, child.bucket_counts):
                        cum += c
                        le = "+Inf" if b == float("inf") else repr(b)
                        extra = (m.labelnames + ("le",),
                                 key + (le,))
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(*extra)} {cum}")
                    lines.append(f"{m.name}_sum{lbl} {child.sum}")
                    lines.append(f"{m.name}_count{lbl} {child.count}")
                else:
                    lines.append(f"{m.name}{lbl} {child.value}")
        return "\n".join(lines) + "\n"


def registry_from_snapshot(snapshot: dict,
                           name: str = "restored") -> MetricsRegistry:
    """Rebuild a MetricsRegistry from a ``MetricsRegistry.snapshot()``
    dict — the receive side of the snapshot wire format (multi-host
    pushes, a recorded trace's final snapshots). Counters/gauges restore exactly; histograms restore count,
    sum and per-bucket counts (so ``prometheus_text`` and
    ``quantile_from_buckets`` work) but not the raw reservoir — exact
    ``percentile`` reads are only available at the source."""
    reg = MetricsRegistry(name)
    for mname, snap in (snapshot or {}).items():
        kind = snap.get("kind")
        labelnames = tuple(snap.get("labelnames") or ())
        help_ = snap.get("help", "")
        series = snap.get("series") or {}
        if kind == "histogram":
            bounds = None
            for vd in series.values():
                raw = vd.get("buckets")
                if raw:
                    bounds = tuple(float("inf") if b == "+Inf" else float(b)
                                   for b, _ in raw)
                    break
            m = reg.histogram(mname, help_, labelnames,
                              buckets=bounds or DEFAULT_BUCKETS)
        elif kind == "gauge":
            m = reg.gauge(mname, help_, labelnames)
        else:
            m = reg.counter(mname, help_, labelnames)
        for key, vd in series.items():
            labels = (dict(zip(labelnames, key.split(",")))
                      if labelnames else {})
            child = m.labels(**labels)
            if kind == "histogram":
                child.count = int(vd.get("count") or 0)
                child.sum = float(vd.get("sum") or 0.0)
                for i, (_, c) in enumerate(vd.get("buckets") or []):
                    if i < len(child.bucket_counts):
                        child.bucket_counts[i] = int(c)
            elif kind == "gauge":
                child.set(float(vd.get("value") or 0.0))
            else:
                child.inc(float(vd.get("value") or 0.0))
    return reg


# ad-hoc default registry (the global_stat analog)
default_registry = MetricsRegistry()
