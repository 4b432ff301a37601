"""Metrics registry: Counter / Gauge / Histogram with labels.

A copy of the JAX package's ``obs/metrics.py`` core (pure Python; the
port keeps its own so it never imports that package). A metric carries
a type, a help string and label dimensions, snapshots to plain dicts,
and dumps in the Prometheus text exposition format. Histograms keep
fixed buckets (for the dump) and a bounded reservoir of raw
observations, so percentile reads stay exact up to the reservoir size.

The decode engine registers the metric names of ``docs/serving.md``'s
decode contract here, so both packages expose the same names.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "LATENCY_BUCKETS_MS"]

# Latency-shaped default buckets (ms-friendly decades).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   50.0, 100.0, 500.0, 1000.0, 5000.0, float("inf"))

# Finer request-latency grid for serving SLO histograms: dense around
# the 0.5-500 ms band where serving latencies live.
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
    """Monotonically increasing count (dispatches, tokens, bytes)."""

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
    """Point-in-time value (live blocks, occupancy, queue depth)."""

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

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def value_dict(self):
        d = {"count": self.count, "sum": self.sum, "mean": self.mean}
        if self.count:
            d.update(min=min(self._reservoir), max=max(self._reservoir),
                     p50=self.percentile(50), p25=self.percentile(25),
                     p75=self.percentile(75), p99=self.percentile(99))
            d["buckets"] = [
                ["+Inf" if b == float("inf") else b, c]
                for b, c in zip(self.buckets, self.bucket_counts)]
        return d


class Histogram(_Metric):
    """Distribution (step latency, TTFT). ``observe`` values in
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

    def percentile(self, p: float, **labels):
        return (self.labels(**labels)
                if labels else self._only()).percentile(p)


class MetricsRegistry:
    """Named metric registry — get-or-create, snapshot, Prometheus."""

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

    def snapshot(self) -> dict:
        return {m.name: m.snapshot() for m in self.metrics()}

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
                        extra = (m.labelnames + ("le",), key + (le,))
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(*extra)} {cum}")
                    lines.append(f"{m.name}_sum{lbl} {child.sum}")
                    lines.append(f"{m.name}_count{lbl} {child.count}")
                else:
                    lines.append(f"{m.name}{lbl} {child.value}")
        return "\n".join(lines) + "\n"
