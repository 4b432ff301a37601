"""Observability for the port: the metrics registry the engines use."""
from paddle_tpu_torch.obs.metrics import (LATENCY_BUCKETS_MS, Counter,
                                          Gauge, Histogram,
                                          MetricsRegistry)

__all__ = ["Counter", "Gauge", "Histogram", "LATENCY_BUCKETS_MS",
           "MetricsRegistry"]
