"""geomesa_tpu_torch.telemetry — per-query span tracing and the flight
recorder for the serve path.

Copies of the reference package's `trace.py` (the span core: a shared
no-op when tracing is off) and `recorder.py` (`RECORDER`, the last N
completed traces plus fault events, dumpable on demand or on an un-typed
dispatcher error). The continuous profiler, the exporters, the gap
report, SLOs and the regression sentinel come with ROADMAP A8.
"""

from geomesa_tpu_torch.telemetry.recorder import RECORDER, FlightRecorder
from geomesa_tpu_torch.telemetry.trace import (
    NOOP_SPAN, Span, Trace, Tracer, TRACER)

__all__ = [
    "FlightRecorder", "NOOP_SPAN", "RECORDER", "Span", "TRACER", "Trace",
    "Tracer",
]
