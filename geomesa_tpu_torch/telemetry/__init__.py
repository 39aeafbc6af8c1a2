"""geomesa_tpu_torch.telemetry — per-query span tracing, flight recorder
and live metrics export for the serve path.

Copies of the reference package's telemetry modules:

- `trace.py`: the span core. `TRACER.span("phase")` context managers at
  every serve/plan/engine seam; a shared no-op when tracing is off or
  the thread has no scoped trace.
- `recorder.py`: `RECORDER`, a bounded ring buffer of the last N
  completed query traces plus breaker/quarantine/fault events, dumpable
  on demand or automatically on un-typed dispatcher errors.
- `export.py`: Chrome/Perfetto trace JSON, JSON-lines, and the
  `MetricsServer` (`/metrics`, `/healthz`, `/debug/traces`,
  `/debug/stats`, `/debug/gap`, `/debug/slo`, `/debug/approx`,
  `/debug/prof`).
- `gap.py`: the dispatch-gap report: host gap vs device-facing time,
  aggregated from spans.
- `slo.py`: declared objectives + sliding-window error-budget burn
  (`/debug/slo`, `slo.burn_rate`/`slo.budget_remaining` gauges, the
  degradation ladder's burn-rate input).
- `prof.py`: the continuous profiler (`/debug/prof`): reservoir-sampled
  per-phase/per-kernel/per-shard distributions folded from every
  recorded trace at bounded cost.
- `sentinel.py`: the perf-regression sentinel: noise-tolerant baseline
  comparison with typed per-metric verdicts and a nonzero exit on
  regression.

`utils/profiling.py` is the device-level counterpart: a torch.profiler
trace of each `execute` under `geomesa.profile.dir`.
"""

from geomesa_tpu_torch.telemetry.export import (MetricsServer, from_perfetto,
                                                to_perfetto, write_jsonl)
from geomesa_tpu_torch.telemetry.gap import gap_report, render_gap
from geomesa_tpu_torch.telemetry.prof import (PROFILER, ContinuousProfiler,
                                              render_prof)
from geomesa_tpu_torch.telemetry.recorder import RECORDER, FlightRecorder
from geomesa_tpu_torch.telemetry.slo import SloEngine, SloSpec, render_slo
from geomesa_tpu_torch.telemetry.trace import (NOOP_SPAN, Span, Trace, Tracer,
                                               TRACER)

__all__ = [
    "TRACER", "Tracer", "Trace", "Span", "NOOP_SPAN",
    "RECORDER", "FlightRecorder",
    "MetricsServer", "to_perfetto", "from_perfetto", "write_jsonl",
    "gap_report", "render_gap",
    "SloEngine", "SloSpec", "render_slo",
    "PROFILER", "ContinuousProfiler", "render_prof",
]
