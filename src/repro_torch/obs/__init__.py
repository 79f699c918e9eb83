"""Serving observability (port of ``repro.obs``; DESIGN.md §12): telemetry
+ metrics.

Everything in this package is **host-side observation** — no module here
may dispatch device computation, insert a device sync the engine did not
already perform, or feed a value back into scheduling.  That is what makes
the load-bearing contract checkable: serving with telemetry enabled is
token-bit-identical to serving with it disabled
(tests/test_torch_telemetry.py), so operators never trade correctness
evidence for visibility.
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .telemetry import (BoundedLog, EVENT_SCHEMA, EventTrace, PhaseTimers,
                        Percentiles, RequestRecord, SCHEMA_VERSION,
                        Telemetry, TickProfiler)

__all__ = [
    "BoundedLog", "Counter", "EVENT_SCHEMA", "EventTrace", "Gauge",
    "Histogram", "MetricsRegistry", "Percentiles", "PhaseTimers",
    "RequestRecord", "SCHEMA_VERSION", "Telemetry", "TickProfiler",
]
