"""Flight recorder: a bounded ring buffer of recent query traces and
fault-fabric events, dumpable on demand or on crash.

A copy of the reference package's `telemetry/recorder.py`, kept in the
port so that it imports nothing of the reference. Every recorded trace
also folds into the continuous profiler (`telemetry/prof.py`) while it
is enabled. Each process of a group dumps to its own path
(`parallel.distributed.process_suffix`).

The postmortem story for the recovery fabric: when
a dispatch dies with an un-typed error, the question is never "what was
THIS request" — the audit log has that — but "what were the last N
requests doing, and what was the breaker/quarantine fabric seeing while
they ran". The recorder keeps exactly that window in memory at a fixed
cost (two deques), independent of whether tracing is enabled: fault
events (breaker transitions, quarantine strikes/trips, injected faults,
crash notes) always record; completed query traces record when the
serve layer traces them.

Memory bound: `capacity` traces (stored as plain JSON dicts, so a
recorded trace keeps no live references into the serve layer) and
`event_capacity` events. Overwrites are counted, never silent
(`dropped_traces` / `dropped_events` in every snapshot).

Crash dumps: `crash_dump(reason)` writes the full snapshot as JSON to
`auto_dump_path` (or `GEOMESA_TPU_FLIGHT_DUMP`, or a pid-qualified file
in the system temp dir) and returns the path. The serve dispatch loop
calls it on un-typed dispatcher errors; `ServeConfig.flight_dump` sets
the path.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import List, Optional

from geomesa_tpu_torch.telemetry.prof import PROFILER
from geomesa_tpu_torch.telemetry.trace import Trace

__all__ = ["FlightRecorder", "RECORDER"]


class FlightRecorder:
    def __init__(self, capacity: int = 256, event_capacity: int = 2048):
        if capacity < 1 or event_capacity < 1:
            raise ValueError("flight recorder capacities must be >= 1")
        self.capacity = capacity
        self.event_capacity = event_capacity
        self._lock = threading.Lock()
        self._traces: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=event_capacity)
        self._trace_count = 0
        self._event_count = 0
        self.auto_dump_path: Optional[str] = None

    # -- recording ---------------------------------------------------------

    def record(self, trace: "Trace | dict | None") -> None:
        """Store one completed query trace. Accepts a Trace (snapshotted
        to JSON immediately — the ring must not pin live serve objects)
        or an already-serialized dict; None no-ops so callers can pass
        `req.trace` straight through."""
        if trace is None:
            return
        doc = trace.to_json() if isinstance(trace, Trace) else trace
        with self._lock:
            self._traces.append(doc)
            self._trace_count += 1
        # continuous profiler (telemetry/prof.py): every recorded trace
        # folds into the lifetime distributions when the profiler is on
        # — one attribute read when off. Outside the ring lock: the
        # fold takes the profiler's own lock and must not couple scrape
        # readers of the ring to fold latency.
        PROFILER.maybe_fold(doc)

    def note_event(self, kind: str, **detail) -> None:
        """Record one fault-fabric event (breaker transition, quarantine
        strike/trip, injected fault, crash). Always-on and cheap: one
        dict + a lock-guarded deque append; wall-clock `ts` is an event
        timestamp, never a duration operand."""
        evt = {"ts": time.time(), "kind": kind}
        if detail:
            evt.update(detail)
        with self._lock:
            self._events.append(evt)
            self._event_count += 1

    # -- reading -----------------------------------------------------------

    def traces(self) -> List[dict]:
        with self._lock:
            return list(self._traces)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "traces": list(self._traces),
                "events": list(self._events),
                "trace_count": self._trace_count,
                "event_count": self._event_count,
                "dropped_traces": max(
                    0, self._trace_count - len(self._traces)),
                "dropped_events": max(
                    0, self._event_count - len(self._events)),
            }

    def stats(self) -> dict:
        with self._lock:
            return {
                "traces_held": len(self._traces),
                "events_held": len(self._events),
                "trace_count": self._trace_count,
                "event_count": self._event_count,
            }

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._events.clear()
            self._trace_count = 0
            self._event_count = 0

    # -- dumping -----------------------------------------------------------

    def dump(self, path: Optional[str] = None, reason: str = "") -> str:
        """Write the snapshot as JSON; returns the path written. The
        write is tmp+rename so a dump raced by another dumper (or a
        dying process) never leaves a half-written file."""
        doc = self.snapshot()
        if reason:
            doc["reason"] = reason
        doc["pid"] = os.getpid()
        doc["dumped_at"] = time.time()
        from geomesa_tpu_torch.parallel.distributed import process_suffix

        path = path or self._default_dump_path()
        root, ext = os.path.splitext(path)
        # a flight dump is per-process forensics: a coordinator gate would
        # throw away every other process's evidence, so instead each
        # process of a group writes its own file (one process: no-op)
        path = f"{root}{process_suffix()}{ext}"
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def _default_dump_path(self) -> str:
        if self.auto_dump_path:
            return self.auto_dump_path
        env = os.environ.get("GEOMESA_TPU_FLIGHT_DUMP")
        if env:
            return env
        return os.path.join(tempfile.gettempdir(),
                            f"gmtpu-flight-{os.getpid()}.json")

    def crash_dump(self, reason: str,
                   exc: Optional[BaseException] = None) -> Optional[str]:
        """The automatic postmortem path: note the crash as an event,
        then dump. Never raises — a failing dump must not re-kill the
        dispatcher that is trying to report its own crash."""
        try:
            detail = {"reason": reason}
            if exc is not None:
                detail["error"] = f"{type(exc).__name__}: {exc}"
            self.note_event("crash", **detail)
            return self.dump(reason=reason)
        except Exception:
            return None


# process-wide recorder: the serve layer records completed traces and
# notes its OOM ladder's steps, quarantine notes strikes and trips
RECORDER = FlightRecorder()
