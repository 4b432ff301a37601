"""Runtime telemetry for the port: metrics registry, structured tracer,
the ``Telemetry`` session, flight recorder, alert rules, the measured
profiler on ``torch.profiler``, and the trainer and serving goodput
decompositions.

The port of the JAX package's ``obs/`` core (ROADMAP A item 1); the
server, federation, aggregation, perfdb, health and numerics planes and
the ``CostReport`` harvest are later items (A item 2, A10). See the JAX
package's ``docs/observability.md`` for the trace schema and the metric
contract, which both packages share.
"""
from paddle_tpu_torch.obs.metrics import (  # noqa: F401
    LATENCY_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from paddle_tpu_torch.obs.trace import (  # noqa: F401
    Tracer,
    read_trace,
    summarize_trace,
    to_perfetto,
)
from paddle_tpu_torch.obs.telemetry import Telemetry  # noqa: F401
from paddle_tpu_torch.obs.flightrecorder import FlightRecorder  # noqa: F401
from paddle_tpu_torch.obs.profiler import (  # noqa: F401
    MeasuredProfile,
    Profiler,
    format_measured_table,
    measured_vs_modeled,
    parse_device_trace,
    parse_tracer_records,
)
from paddle_tpu_torch.obs.goodput import (  # noqa: F401
    decompose,
    format_goodput_table,
)
from paddle_tpu_torch.obs.alerts import (  # noqa: F401
    AlertEngine,
    DEFAULT_RULES,
    FLEET_RULES,
    Rule,
    validate_rules,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS_MS",
    "Tracer", "read_trace", "summarize_trace", "to_perfetto",
    "Telemetry", "FlightRecorder",
    "Profiler", "MeasuredProfile", "parse_device_trace",
    "parse_tracer_records", "measured_vs_modeled",
    "format_measured_table",
    "decompose", "format_goodput_table",
    "AlertEngine", "DEFAULT_RULES", "FLEET_RULES", "Rule",
    "validate_rules",
]
